// raycast: the model view of frame-to-model odometry, one thread a ray, one launch.
//
// Replaces no TPU kernel: the reference's raycast
// (elasticreconstruction_tpu/kernels/raycast.py::raycast) is plain jnp, and so
// is the port's plain version (kernels/raycast.py::raycast_plain). That version
// marches every ray of the image in lockstep for all num_steps steps, about 50
// elementwise launches a step, each moving about a megabyte: 295 steps at
// 640x480 were some 15 500 launches and about a millisecond of host time a
// step, with the card idle between them.
//
// Per ray (pixel): march z = depth_min + (step + 1) * dz, reading the nearest
// voxel of tsdf and weight (a voxel of weight 0 reads the sentinel 2.0), until
// the first step whose value is <= 0 after an observed value > 0; refine that
// bracket [z - dz, z] from half a step early with three bisections and a
// secant on trilinear samples of the sentinel values; take the unit
// central-difference gradient of the raw tsdf (six value-only trilinear
// samples) as the normal, turned toward the camera; write the vertex, the
// normal and valid once, zeros where the march found no crossing.
//
// Bound: the gathers of the marched voxels (8 bytes a voxel, tsdf and weight)
// and the outputs (24 bytes and one valid byte a pixel: 7.7 MB at 640x480),
// with the ray directions read (3.7 MB), against 3.35 TB/s. At the benchmark's
// sizes (512^3, 640x480, 295 steps) the march reads 2.9 million distinct
// voxels, 35 MB in all: 10 us. Each ray's steps are a chain of dependent
// reads (93 on average there), so the kernel runs well above that bound
// (PERF.md). The design: a ray stops at its first crossing (the plain march
// masks every later one, so the output is the same); a block covers a 16x8
// tile of pixels, so neighbouring rays read neighbouring voxels through L1
// and L2; and the sentinel is applied in registers, with no full-volume pass
// that builds the sampling volume (1.5 GB of traffic and 512 MB at 512^3).
//
// Arithmetic: every operation rounds as the plain version's PyTorch ops do,
// so the two agree bit for bit on the card (built with -fmad=false, and every
// float operation named by its intrinsic):
// - ray points o + d z as core/types.py::fma: a float64 product (exact) and
//   add, rounded once to float32;
// - step depths as numpy forms them in float32; the grid (p - o) * inv with
//   inv the float32 reciprocal of the voxel size; rintf (half to even, as
//   torch.round) and floorf, then the saturating float -> int64 conversion
//   that .to(torch.int64) compiles to (a NaN converts to 0);
// - trilinear weights (a * b) * c, summed in the plain version's dx, dy, dz
//   order, the first product not added to zero; IEEE sqrt and division.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 8;
constexpr float kUnobserved = 2.0f;  // kernels/tsdf.py::_UNOBSERVED

struct Volume {
  const float* tsdf;
  const float* weight;
  int64_t nx, ny, nz;
  float ox, oy, oz;  // world position of voxel (0, 0, 0)'s centre
  float h;           // voxel size
  float inv;         // float32 reciprocal of the voxel size
};

struct Sample {
  float value;
  bool valid;
};

// o + d * z, as core/types.py::fma computes it.
__device__ __forceinline__ float at(float d, float z, float o) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(d), static_cast<double>(z)),
                                     static_cast<double>(o)));
}

__device__ __forceinline__ float grid(float p, float o, float inv) {
  return __fmul_rn(__fsub_rn(p, o), inv);
}

__device__ __forceinline__ int64_t clip(int64_t i, int64_t hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// A voxel of the sampling volume: tsdf where observed, else the sentinel.
__device__ __forceinline__ float sentinel_value(const Volume& v, int64_t i) {
  const float w = __ldg(v.weight + i);
  const float t = __ldg(v.tsdf + i);
  return w > 0.0f ? t : kUnobserved;
}

// kernels/tsdf.py::_nearest: the nearest voxel's sentinel value; valid when
// in bounds and observed.
__device__ Sample nearest(const Volume& v, float px, float py, float pz) {
  const int64_t ix = __float2ll_rz(rintf(grid(px, v.ox, v.inv)));
  const int64_t iy = __float2ll_rz(rintf(grid(py, v.oy, v.inv)));
  const int64_t iz = __float2ll_rz(rintf(grid(pz, v.oz, v.inv)));
  const bool in_bounds = ix >= 0 && ix < v.nx && iy >= 0 && iy < v.ny && iz >= 0 && iz < v.nz;
  const int64_t i = (clip(ix, v.nx - 1) * v.ny + clip(iy, v.ny - 1)) * v.nz + clip(iz, v.nz - 1);
  const float c = sentinel_value(v, i);
  return {c, in_bounds && c < 1.5f};
}

// kernels/tsdf.py::_trilinear: with kSentinel, of the sampling volume and with
// its validity (in bounds, all eight corners observed); without, of the raw
// tsdf, value only. Out of bounds the corners are read at the clipped cell
// with the unclipped fractions, as the plain version reads them.
template <bool kSentinel>
__device__ Sample trilinear(const Volume& v, float px, float py, float pz) {
  const float g[3] = {grid(px, v.ox, v.inv), grid(py, v.oy, v.inv), grid(pz, v.oz, v.inv)};
  const int64_t n[3] = {v.nx, v.ny, v.nz};
  float f[3], om[3];
  int64_t ic[3];
  bool in_bounds = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g0 = floorf(g[k]);
    f[k] = __fsub_rn(g[k], g0);
    om[k] = __fsub_rn(1.0f, f[k]);
    const int64_t i0 = __float2ll_rz(g0);
    in_bounds = in_bounds && i0 >= 0 && i0 < n[k] - 1;
    ic[k] = clip(i0, n[k] - 2);
  }
  const int64_t base = (ic[0] * v.ny + ic[1]) * v.nz + ic[2];
  float val = 0.0f;
  bool observed = true;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(__fmul_rn(dx ? f[0] : om[0], dy ? f[1] : om[1]), dz ? f[2] : om[2]);
        const int64_t i = base + dx * v.ny * v.nz + dy * v.nz + dz;
        const float c = kSentinel ? sentinel_value(v, i) : __ldg(v.tsdf + i);
        const float wc = __fmul_rn(w, c);
        val = (dx | dy | dz) ? __fadd_rn(val, wc) : wc;
        observed = observed && c < 1.5f;  // max of the corners < 1.5, NaN included
      }
    }
  }
  return {val, in_bounds && observed};
}

__global__ void __launch_bounds__(kTileX * kTileY)
raycast_kernel(Volume vol, const float* __restrict__ dirs, const float* __restrict__ pose,
               float* __restrict__ vertices, float* __restrict__ normals, uint8_t* __restrict__ valid,
               int h, int w, float depth_min, float dz, int num_steps) {
  const int u = blockIdx.x * kTileX + threadIdx.x;
  const int row = blockIdx.y * kTileY + threadIdx.y;
  if (u >= w || row >= h) return;
  const size_t pix = static_cast<size_t>(row) * w + u;
  const float d[3] = {dirs[pix * 3], dirs[pix * 3 + 1], dirs[pix * 3 + 2]};
  const float o[3] = {pose[3], pose[7], pose[11]};  // camera centre: the pose's translation

  // March to the first bracketed crossing.
  float prev_val = 0.0f;
  bool prev_valid = false;
  bool found = false;
  float bracket = 0.0f;
  for (int step = 0; step < num_steps; ++step) {
    const float z = __fadd_rn(depth_min, __fmul_rn(__fadd_rn(static_cast<float>(step), 1.0f), dz));
    const Sample s = nearest(vol, at(d[0], z, o[0]), at(d[1], z, o[1]), at(d[2], z, o[2]));
    if (prev_valid && s.valid && prev_val > 0.0f && s.value <= 0.0f) {
      bracket = __fsub_rn(z, dz);
      found = true;
      break;
    }
    prev_val = s.value;
    prev_valid = s.valid;
  }
  float* vert = vertices + pix * 3;
  float* nrm = normals + pix * 3;
  valid[pix] = found;
  if (!found) {
#pragma unroll
    for (int k = 0; k < 3; ++k) vert[k] = nrm[k] = 0.0f;
    return;
  }

  // Refine: from half a step early, three bisections, then a secant. The
  // validity of the two ends is that of the first samples, as in the plain
  // version.
  float lo = __fsub_rn(bracket, __fmul_rn(0.5f, dz));  // exact: half a step
  float hi = __fadd_rn(bracket, dz);
  const Sample slo = trilinear<true>(vol, at(d[0], lo, o[0]), at(d[1], lo, o[1]), at(d[2], lo, o[2]));
  const Sample shi = trilinear<true>(vol, at(d[0], hi, o[0]), at(d[1], hi, o[1]), at(d[2], hi, o[2]));
  float vlo = slo.value, vhi = shi.value;
  for (int it = 0; it < 3; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const float vmid = trilinear<true>(vol, at(d[0], mid, o[0]), at(d[1], mid, o[1]), at(d[2], mid, o[2])).value;
    if (vmid > 0.0f) {  // crossing in [mid, hi]
      lo = mid;
      vlo = vmid;
    } else {
      hi = mid;
      vhi = vmid;
    }
  }
  const float denom = __fsub_rn(vlo, vhi);
  const bool big = fabsf(denom) > 1e-9f;
  float alpha = (slo.valid && shi.valid && big) ? __fdiv_rn(vlo, big ? denom : 1.0f) : 0.5f;
  alpha = isnan(alpha) ? alpha : fminf(fmaxf(alpha, 0.0f), 1.0f);  // torch.clip keeps a NaN
  const float hit_z = __fadd_rn(lo, __fmul_rn(alpha, __fsub_rn(hi, lo)));
  const float p[3] = {at(d[0], hit_z, o[0]), at(d[1], hit_z, o[1]), at(d[2], hit_z, o[2])};

  // Normal: central differences one voxel each way on the raw tsdf.
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float a[3] = {p[0], p[1], p[2]};
    float b[3] = {p[0], p[1], p[2]};
    a[k] = __fadd_rn(p[k], vol.h);
    b[k] = __fadd_rn(p[k], -vol.h);
    g[k] = __fsub_rn(trilinear<false>(vol, a[0], a[1], a[2]).value,
                     trilinear<false>(vol, b[0], b[1], b[2]).value);
  }
  float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                                    __fmul_rn(g[2], g[2])));
  norm = norm > 1e-12f ? norm : 1.0f;
  float n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = __fdiv_rn(g[k], norm);
  // Turned toward the camera.
  const float facing = __fadd_rn(__fadd_rn(__fmul_rn(n[0], __fsub_rn(o[0], p[0])),
                                           __fmul_rn(n[1], __fsub_rn(o[1], p[1]))),
                                 __fmul_rn(n[2], __fsub_rn(o[2], p[2])));
  const bool flip = facing < 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vert[k] = p[k];
    nrm[k] = flip ? -n[k] : n[k];
  }
}

}  // namespace

// tsdf, weight (nx, ny, nz) f32; dirs (h, w, 3) f32, the world-frame ray
// directions; pose (4, 4) f32 camera-to-world, read on the device (its
// translation is the rays' origin) -> vertices, normals (h, w, 3) f32 and
// valid (h, w) bool as bytes. All contiguous, on the device. Launches on
// `stream`; returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int er_raycast(const float* tsdf, const float* weight, const float* dirs, const float* pose,
                          float* vertices, float* normals, uint8_t* valid, int h, int w, int nx, int ny,
                          int nz, float ox, float oy, float oz, float voxel, float inv, float depth_min,
                          float dz, int num_steps, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || nx < 2 || ny < 2 || nz < 2 || num_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Volume vol{tsdf, weight, nx, ny, nz, ox, oy, oz, voxel, inv};
  const dim3 block(kTileX, kTileY);
  const dim3 blocks((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  raycast_kernel<<<blocks, block, 0, stream>>>(vol, dirs, pose, vertices, normals, valid, h, w, depth_min,
                                               dz, num_steps);
  return static_cast<int>(cudaGetLastError());
}
