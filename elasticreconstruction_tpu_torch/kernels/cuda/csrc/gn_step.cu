// gn_step: one Gauss-Newton step of frame-to-model odometry, one launch.
//
// Replaces no TPU kernel: the reference's step
// (elasticreconstruction_tpu/odometry/kinfu.py::_gn_level) is plain jnp, and
// so is the port's plain version (odometry/kinfu.py::_gn_level_plain). That
// version is about 320 small launches a step (the image pass's transform,
// projection, gathers, masks, residual, cross product, J^T W J and sums; then
// the 6x6 tail's se3 log and inverse, a batched 3x3 eigh, block_diag,
// solve_ex, clip, se3 exp and compose), and eigh reads its error flag back
// to the host once a step: 19 steps a frame kept the host busy for 82 ms and
// the card for 11.
//
// Reduction phase, every block: a fixed grid of threads walks the level's
// pixels with a grid-stride loop. Per pixel, as the plain image pass does:
// unproject the depth (depth > 0 is valid); p_w = R v + t from the pose T,
// read on the device; p_m = R_m^T (p_w - t_m); project into the model
// camera (whose intrinsics may differ from the level's) with the plain
// version's rounding (core/camera.py: the division, then o + a b as one
// float64 product and add rounded once; in the image when z > 1e-6 and
// 0 <= u <= W - 1, 0 <= v <= H - 1; the nearest pixel by rint); gather the
// model's valid flag, vertex and normal; keep the pixel when |p_w - q|^2 <
// dist_threshold^2. A rejected pixel adds nothing: it is skipped before any
// arithmetic on the model's vertex or normal, which can be NaN where the
// model is invalid. An accepted pixel adds r = n . (p_w - q) and
// J = [n, p_w x n] to 29 float32 sums: the 21 upper-triangle entries of
// H = J^T J, g = J^T r (6), the support n_ok and sum r^2. Each block adds its
// threads' sums in a fixed tree (warp shuffles, then the warps in order) and
// writes one partial row to scratch.
//
// Update phase, the last block to arrive (a ticket counter, reset by that
// block for the next launch): it adds the partial rows in block order, so the
// result repeats bit for bit from run to run, with no float atomics. Then one
// thread does the step's 6x6 tail in registers, restating the plain version:
// - the eigendecompositions of H_tt = H[:3, :3] and H_rr = H[3:, 3:] by cyclic
//   Jacobi (repeated and zero eigenvalues included; no error flag), the two
//   blocks on two warps at once; with prior_beta <= 0 only H_tt's eigenvalues;
// - eps = log(T T_prior^-1) (core/se3.py, with its small-angle and near-pi
//   branches); the spectral-floor fill P = V diag(max(beta ev_max - ev, 0))
//   V^T of each block; H + P and g + P eps;
// - mu = damping (1 + trace(H) / 6); delta = -(H + mu I)^-1 g by LU with
//   partial pivoting, as solve_ex factors (H + mu I is SPD, so Cholesky would
//   do too; the LU keeps the plain version's algorithm where the damped
//   system is badly conditioned, as with prior_beta = 0 on a bare wall);
// - the +-max_step clip and the min_support gate; T <- exp(delta) T;
// - n_ok, rmse = sqrt(sum r^2 / max(n_ok, 1)) and obs = ev_t[0] / max(ev_t[2],
//   1e-12) of the data term's H_tt, all written to the level's state tensor,
//   with the 29 sums beside them.
//
// Bound: bytes. A step reads each pixel's depth (4 B) and, for each pixel
// that projects into the model image, the model's valid flag and, where it
// is valid, its vertex and normal (25 B): 8.9 MB at 640x480, 2.7 us at
// 3.35 TB/s. The design meets it with one pass over the image, coalesced depth
// reads, model reads that follow the image (neighbouring pixels land on
// neighbouring model pixels), and no intermediate in device memory; what is
// left above it is the launch, the last block's tail and a grid too small to
// hide the gathers' latency at the coarse levels.
//
// Built with -fmad=false: every multiply and add of the image pass rounds on
// its own, as the plain version's elementwise PyTorch ops do.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;  // two blocks per SM of an H100; a grid fixed by the shape alone
constexpr int kSums = 29;        // 21 upper-triangle H, 6 g, n_ok, sum r^2
constexpr int kNok = 16, kRmse = 17, kObs = 18, kSumsAt = 19;  // state: T (16), then these, then the sums
constexpr float kSmallAngle = 1e-3f;  // core/se3.py::_SMALL_ANGLE
constexpr float kNearPi = 3.131592653589793f;  // pi - 1e-2, rounded to float32 as torch compares it

// Sum k of H's upper triangle, row-major: H[i][j], i <= j.
__host__ __device__ constexpr int upper(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

struct Level {
  const float* depth;  // (h, w)
  int h, w;
  float cx, cy;        // as float32, as unproject subtracts them
  float rfx, rfy;      // float32 reciprocals of fx, fy
};

struct Model {
  const float* vertices;  // (h, w, 3)
  const float* normals;   // (h, w, 3)
  const uint8_t* valid;   // (h, w)
  int h, w;
  double fx, fy, cx, cy;  // as Python holds them: the projection's fma takes them in float64
};

struct Params {
  float thr2;         // f32(dist_threshold ** 2)
  float prior_beta;
  float damping;
  float min_support;
  float max_step;
  float sixth;        // f32(1 / 6)
};

// a * b + c with a float32 and b, c float64, rounded once to float32: core/types.py::fma.
__device__ __forceinline__ float fma64(float a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), b), c));
}

// ---- The 6x6 tail, on one thread. ----

// Cyclic Jacobi on a symmetric 3x3 matrix: eigenvalues ascending in ev, unit
// eigenvectors in V's columns. The rotation of each (p, q) zeroes a[p][q];
// after three sweeps an off-diagonal entry too small to move its diagonal
// entries is set to zero without a rotation, so the sweeps end.
__device__ void jacobi3(const float (&m)[3][3], float (&ev)[3], float (&V)[3][3]) {
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = m[i][j];
      V[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
  for (int sweep = 0; sweep < 32; ++sweep) {
    if (a[0][1] == 0.0f && a[0][2] == 0.0f && a[1][2] == 0.0f) break;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      const int o = 3 - p - q;
      const float apq = a[p][q];
      if (apq == 0.0f) continue;
      const float tiny = 100.0f * fabsf(apq);
      if (sweep > 3 && fabsf(a[p][p]) + tiny == fabsf(a[p][p]) && fabsf(a[q][q]) + tiny == fabsf(a[q][q])) {
        a[p][q] = a[q][p] = 0.0f;
        continue;
      }
      const float h = a[q][q] - a[p][p];
      float t;
      if (fabsf(h) + tiny == fabsf(h)) {
        t = apq / h;
      } else {
        const float theta = 0.5f * h / apq;
        t = 1.0f / (fabsf(theta) + sqrtf(1.0f + theta * theta));
        if (theta < 0.0f) t = -t;
      }
      const float c = 1.0f / sqrtf(1.0f + t * t);
      const float s = t * c;
      const float tau = s / (1.0f + c);
      const float th = t * apq;
      a[p][p] -= th;
      a[q][q] += th;
      a[p][q] = a[q][p] = 0.0f;
      const float gp = a[o][p], gq = a[o][q];
      a[o][p] = a[p][o] = gp - s * (gq + gp * tau);
      a[o][q] = a[q][o] = gq + s * (gp - gq * tau);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float vp = V[r][p], vq = V[r][q];
        V[r][p] = vp - s * (vq + vp * tau);
        V[r][q] = vq + s * (vp - vq * tau);
      }
    }
  }
  // Ascending, by a three-step network; each swap moves an eigenvector along.
  auto order = [&](int x, int y) {
    if (a[y][y] < a[x][x]) {
      const float s = a[x][x]; a[x][x] = a[y][y]; a[y][y] = s;
#pragma unroll
      for (int r = 0; r < 3; ++r) { const float v = V[r][x]; V[r][x] = V[r][y]; V[r][y] = v; }
    }
  };
  order(0, 1);
  order(1, 2);
  order(0, 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) ev[k] = a[k][k];
}

// K = hat(phi) and K @ K.
__device__ void hat2(const float (&phi)[3], float (&K)[3][3], float (&K2)[3][3]) {
  K[0][0] = 0.0f;    K[0][1] = -phi[2]; K[0][2] = phi[1];
  K[1][0] = phi[2];  K[1][1] = 0.0f;    K[1][2] = -phi[0];
  K[2][0] = -phi[1]; K[2][1] = phi[0];  K[2][2] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) K2[i][j] = (K[i][0] * K[0][j] + K[i][1] * K[1][j]) + K[i][2] * K[2][j];
  }
}

// core/se3.py::log of the rigid transform (R, t): the twist [rho, phi].
__device__ void se3_log(const float (&R)[3][3], const float (&t)[3], float (&xi)[6]) {
  const float tr = (R[0][0] + R[1][1]) + R[2][2];
  const float cos_theta = fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float w[3] = {(R[2][1] - R[1][2]) * 0.5f, (R[0][2] - R[2][0]) * 0.5f, (R[1][0] - R[0][1]) * 0.5f};
  const float sin_est = sqrtf(((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]) + 1e-12f);
  const float theta = atan2f(sin_est, cos_theta);
  const bool small = theta < kSmallAngle;
  const bool near_pi = theta > kNearPi;
  float phi[3];
  if (near_pi) {
    // |axis_i| from the diagonal, signs from the off-diagonal sums, anchored
    // on the largest component (the first of equal ones, as argmax).
    float ax[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ax[k] = sqrtf(fmaxf((R[k][k] - cos_theta) / ((1.0f - cos_theta) + 1e-12f), 1e-12f));
    const float s01 = R[0][1] + R[1][0] >= 0.0f ? 1.0f : -1.0f;
    const float s02 = R[0][2] + R[2][0] >= 0.0f ? 1.0f : -1.0f;
    const float s12 = R[1][2] + R[2][1] >= 0.0f ? 1.0f : -1.0f;
    int i = 0;
    if (ax[1] > ax[i]) i = 1;
    if (ax[2] > ax[i]) i = 2;
    float axis[3];
    if (i == 0) { axis[0] = ax[0]; axis[1] = s01 * ax[1]; axis[2] = s02 * ax[2]; }
    else if (i == 1) { axis[0] = s01 * ax[0]; axis[1] = ax[1]; axis[2] = s12 * ax[2]; }
    else { axis[0] = s02 * ax[0]; axis[1] = s12 * ax[1]; axis[2] = ax[2]; }
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = axis[k] * theta;
  } else if (small) {
    const float f = 1.0f + theta * theta / 6.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = w[k] * f;
  } else {
    const float f = theta / sinf(theta);
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = w[k] * f;
  }
  // rho = J_l(phi)^-1 t.
  const float th2 = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  const float th = sqrtf(th2);
  float cot_term;
  if (th < kSmallAngle) {
    cot_term = 1.0f / 12.0f + th2 / 720.0f;
  } else {
    const float half = th * 0.5f;
    cot_term = (1.0f - half * cosf(half) / sinf(half)) / (th * th);
  }
  float K[3][3], K2[3][3];
  hat2(phi, K, K2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) row[j] = ((i == j ? 1.0f : 0.0f) - 0.5f * K[i][j]) + cot_term * K2[i][j];
    xi[i] = (row[0] * t[0] + row[1] * t[1]) + row[2] * t[2];
    xi[3 + i] = phi[i];
  }
}

// core/se3.py::exp of the twist [rho, phi]: rotation R and translation t.
__device__ void se3_exp(const float (&xi)[6], float (&R)[3][3], float (&t)[3]) {
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float th2 = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  const float th = sqrtf(th2);
  float a, b, c;
  if (th < kSmallAngle) {
    a = 1.0f - th2 / 6.0f;
    b = 0.5f - th2 / 24.0f;
    c = 1.0f / 6.0f - th2 / 120.0f;
  } else {
    const float s = sinf(th), co = cosf(th);
    a = s / th;
    b = (1.0f - co) / (th * th);
    c = (th - s) / (th * th * th);
  }
  float K[3][3], K2[3][3];
  hat2(phi, K, K2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float jl[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      R[i][j] = (e + a * K[i][j]) + b * K2[i][j];
      jl[j] = (e + b * K[i][j]) + c * K2[i][j];
    }
    t[i] = (jl[0] * xi[0] + jl[1] * xi[1]) + jl[2] * xi[2];
  }
}

// x = A^-1 b by LU with partial pivoting (the first largest pivot), in place.
__device__ void lu_solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {  // a swap at fixed indices keeps A in registers
#pragma unroll
        for (int j = 0; j < 6; ++j) { const float s = A[k][j]; A[k][j] = A[i][j]; A[i][j] = s; }
        const float s = b[k]; b[k] = b[i]; b[i] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
gn_step_kernel(Level lv, Model md, const float* __restrict__ model_pose, const float* T_in,
               const float* __restrict__ T_prior, float* state, float* partials, int* counter, Params prm) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float total[kSums];
  __shared__ float eig[2][12];  // per block of H: ev (3), V row-major (9)
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // T_in may be the state this launch writes: the last block writes it only
  // after every block, itself included, has read it.
  float R[3][3], t[3], mR[3][3], mt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = T_in[i * 4 + j];
      mR[i][j] = model_pose[i * 4 + j];
    }
    t[i] = T_in[i * 4 + 3];
    mt[i] = model_pose[i * 4 + 3];
  }

  float acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
  const int n = lv.h * lv.w;
  const float wmax = static_cast<float>(md.w - 1), hmax = static_cast<float>(md.h - 1);
  for (int i = blockIdx.x * kThreads + tid; i < n; i += gridDim.x * kThreads) {
    const float d = __ldg(lv.depth + i);
    if (!(d > 0.0f)) continue;
    const int row = i / lv.w;
    const int col = i - row * lv.w;
    // cam.unproject: ((u - cx) * (1 / fx)) * d.
    const float v[3] = {__fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(col), lv.cx), lv.rfx), d),
                        __fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(row), lv.cy), lv.rfy), d), d};
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = __fadd_rn(__fmaf_rn(v[2], R[k][2], __fmaf_rn(v[1], R[k][1], __fmul_rn(v[0], R[k][0]))), t[k]);
    const float e[3] = {__fsub_rn(p[0], mt[0]), __fsub_rn(p[1], mt[1]), __fsub_rn(p[2], mt[2])};
    float pm[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pm[k] = __fmaf_rn(e[2], mR[2][k], __fmaf_rn(e[1], mR[1][k], __fmul_rn(e[0], mR[0][k])));
    // cam.project_uv and cam.pixel_index; a point outside the image is rejected,
    // so the index of one inside needs no clip.
    if (!(pm[2] > 1e-6f)) continue;
    const float u = fma64(__fdiv_rn(pm[0], pm[2]), md.fx, md.cx);
    const float w = fma64(__fdiv_rn(pm[1], pm[2]), md.fy, md.cy);
    if (!(u >= 0.0f && u <= wmax && w >= 0.0f && w <= hmax)) continue;
    const int pix = static_cast<int>(rintf(w)) * md.w + static_cast<int>(rintf(u));
    if (!__ldg(md.valid + pix)) continue;
    const float* qv = md.vertices + static_cast<size_t>(pix) * 3;
    const float diff[3] = {__fsub_rn(p[0], __ldg(qv)), __fsub_rn(p[1], __ldg(qv + 1)),
                          __fsub_rn(p[2], __ldg(qv + 2))};
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(diff[0], diff[0]), __fmul_rn(diff[1], diff[1])),
                               __fmul_rn(diff[2], diff[2]));
    if (!(d2 < prm.thr2)) continue;
    const float* nv = md.normals + static_cast<size_t>(pix) * 3;
    const float nx = __ldg(nv), ny = __ldg(nv + 1), nz = __ldg(nv + 2);
    const float r = __fadd_rn(__fadd_rn(__fmul_rn(nx, diff[0]), __fmul_rn(ny, diff[1])), __fmul_rn(nz, diff[2]));
    const float J[6] = {nx, ny, nz, __fsub_rn(__fmul_rn(p[1], nz), __fmul_rn(p[2], ny)),
                        __fsub_rn(__fmul_rn(p[2], nx), __fmul_rn(p[0], nz)),
                        __fsub_rn(__fmul_rn(p[0], ny), __fmul_rn(p[1], nx))};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) acc[k++] += J[a] * J[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += J[a] * r;
    acc[27] += 1.0f;
    acc[28] += r * r;
  }

  // The block's sums: a shuffle tree in each warp, then the warps in order.
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    float x = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][s] = x;
  }
  __syncthreads();
  const int blocks = gridDim.x;
  if (tid < kSums) {
    float x = warp_sums[0][tid];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) x += warp_sums[k][tid];
    partials[tid * blocks + blockIdx.x] = x;
  }

  // The last block to arrive adds the rows and updates the pose.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(counter, 1) == blocks - 1;
    if (last_block) *counter = 0;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int s = warp; s < kSums; s += kWarps) {
    float x = 0.0f;
    for (int b = lane; b < blocks; b += 32) x += __ldcg(partials + s * blocks + b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) total[s] = x;
  }
  __syncthreads();

  if (tid < kSums) state[kSumsAt + tid] = total[tid];
  // The eigendecompositions of H_tt (warp 0) and H_rr (warp 1) at once.
  if (lane == 0 && warp < 2 && (warp == 0 || prm.prior_beta > 0.0f)) {
    const int o = 3 * warp;
    float m[3][3], ev[3], V[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) m[i][j] = total[i <= j ? upper(o + i, o + j) : upper(o + j, o + i)];
    }
    jacobi3(m, ev, V);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      eig[warp][i] = ev[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) eig[warp][3 + 3 * i + j] = V[i][j];
    }
  }
  __syncthreads();
  if (tid != 0) return;
  float H[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = total[upper(i, j)];
  }
  float g[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) g[a] = total[21 + a];
  const float n_support = total[27];
  const float rr = total[28];
  const float ev_t0 = eig[0][0], ev_t2 = eig[0][2];

  if (prm.prior_beta > 0.0f) {
    // eps = log(T T_prior^-1); T_prior^-1 = [Rp^T, -Rp^T tp].
    float Rp[3][3], tp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rp[i][j] = T_prior[i * 4 + j];
      tp[i] = T_prior[i * 4 + 3];
    }
    float ti[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ti[i] = -((Rp[0][i] * tp[0] + Rp[1][i] * tp[1]) + Rp[2][i] * tp[2]);
    float Rd[3][3], td[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rd[i][j] = (R[i][0] * Rp[j][0] + R[i][1] * Rp[j][1]) + R[i][2] * Rp[j][2];
      td[i] = ((R[i][0] * ti[0] + R[i][1] * ti[1]) + R[i][2] * ti[2]) + t[i];
    }
    float eps[6];
    se3_log(Rd, td, eps);
    // P = V diag(fill) V^T per block; H += P, g += P eps.
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      const float* e = eig[blk];
      float fill[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) fill[k] = fmaxf(prm.prior_beta * e[2] - e[k], 0.0f);
      const int o = 3 * blk;
      float P[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          P[i][j] = (e[3 + 3 * i] * fill[0] * e[3 + 3 * j] + e[4 + 3 * i] * fill[1] * e[4 + 3 * j])
                    + e[5 + 3 * i] * fill[2] * e[5 + 3 * j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) H[o + i][o + j] += P[i][j];
        g[o + i] += (P[i][0] * eps[o] + P[i][1] * eps[o + 1]) + P[i][2] * eps[o + 2];
      }
    }
  }
  float tr = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) tr += H[a][a];
  const float mu = prm.damping * (1.0f + tr * prm.sixth);
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] += mu;
  float delta[6];
  lu_solve6(H, g, delta);
  const float gate = n_support >= prm.min_support ? 1.0f : 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float x = -delta[a];
    // torch.clip keeps a NaN.
    delta[a] = (isnan(x) ? x : fminf(fmaxf(x, -prm.max_step), prm.max_step)) * gate;
  }
  float Re[3][3], te[3];
  se3_exp(delta, Re, te);
  // T <- exp(delta) T.
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) state[i * 4 + j] = (Re[i][0] * R[0][j] + Re[i][1] * R[1][j]) + Re[i][2] * R[2][j];
    state[i * 4 + 3] = ((Re[i][0] * t[0] + Re[i][1] * t[1]) + Re[i][2] * t[2]) + te[i];
  }
  state[12] = 0.0f;
  state[13] = 0.0f;
  state[14] = 0.0f;
  state[15] = 1.0f;
  state[kNok] = n_support;
  state[kRmse] = sqrtf(rr / fmaxf(n_support, 1.0f));
  state[kObs] = ev_t0 / fmaxf(ev_t2, 1e-12f);
}

}  // namespace

// The grid of a level of h * w pixels: the wrapper sizes the scratch from it.
extern "C" int er_gn_step_blocks(int h, int w) {
  const long long n = static_cast<long long>(h) * w;
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// depth (h, w) f32 of the level; model vertices, normals (mh, mw, 3) f32 and
// valid (mh, mw) bool as bytes; model_pose, T_in, T_prior (4, 4) f32, read on
// the device; state (48) f32: T_out (16, row-major), n_ok, rmse, obs, then the
// 29 sums (21 upper-triangle H, g, n_ok, sum r^2). T_in may be state itself.
// partials: 29 * blocks f32 of scratch, blocks = min(264, ceil(h * w / 256));
// counter: one int32, zero, left zero. All contiguous, on the device.
// Launches one kernel on `stream`; returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int er_gn_step(const float* depth, int h, int w, float cx, float cy, float rfx, float rfy,
                          const float* vertices, const float* normals, const uint8_t* valid, int mh, int mw,
                          double mfx, double mfy, double mcx, double mcy, const float* model_pose,
                          const float* T_in, const float* T_prior, float* state, float* partials, int* counter,
                          float thr2, float prior_beta, float damping, float min_support, float max_step,
                          float sixth, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || mh <= 0 || mw <= 0 || static_cast<long long>(h) * w > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = er_gn_step_blocks(h, w);
  const Level lv{depth, h, w, cx, cy, rfx, rfy};
  const Model md{vertices, normals, valid, mh, mw, mfx, mfy, mcx, mcy};
  const Params prm{thr2, prior_beta, damping, min_support, max_step, sixth};
  gn_step_kernel<<<blocks, kThreads, 0, stream>>>(lv, md, model_pose, T_in, T_prior, state, partials, counter,
                                                  prm);
  return static_cast<int>(cudaGetLastError());
}

