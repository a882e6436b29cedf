// normal_eqs_batch: one fused point-to-plane Gauss-Newton step.
//
// Replaces the TPU kernel elasticreconstruction_tpu/kernels/pallas/icp_step.py
// (_make_kernel, launched by normal_eqs_batch at icp_step.py:168). Per batch,
// for each transformed source point p: nearest dst point (index i), matched
// point q = dst[i] and normal n = nrm[i], weight w = src_w * [d2 < thr2],
// residual r = n.(p - q) and Jacobian J = [n, p x n]. Returns per batch the
// 29 sums: upper-triangular H = sum w J^T J (21, row-major a <= b),
// g = sum w J r (6), n_in = sum w, and sum w r^2.
//
// What differs from the TPU kernel, and why:
// - The matched row is loaded directly. The TPU kernel gathered it with a
//   bf16 hi/lo one-hot matmul only because Mosaic has no cross-lane gather.
// - Exact distance ties take the FIRST index, like the plain version
//   (registration/icp.py's unfused step); the TPU kernel averaged exact ties
//   within a block. Exact f32 ties between distinct refs have measure zero on
//   real point data.
// - No float atomics: each block writes its 29 partial sums to a scratch row
//   and a second small kernel adds the rows in a fixed order, so the result
//   is the same from run to run.
//
// Bound: the nearest-neighbour search dominates (B * N * M distance
// evaluations, ~8 f32 operations each; the per-query epilogue is ~80
// operations), so like nn.cu it is bound by f32 operations. It reuses the NN
// device routine of nn.cu (nn.cuh), whose arithmetic and tie rule it shares.
#include "nn.cuh"

namespace {

constexpr int kSums = 29;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(er::kThreads)
normal_eqs_kernel(const float* __restrict__ p, const float* __restrict__ src_w,
                  const float* __restrict__ dst, const float* __restrict__ nrm,
                  const uint8_t* __restrict__ mask, float* __restrict__ partial, int n, int m,
                  float thr2) {
  __shared__ float warp_part[er::kQueries / 32][kSums];
  const int b = blockIdx.y;
  const int slot = threadIdx.x % er::kQueries;
  const int qi = blockIdx.x * er::kQueries + slot;
  const bool live = qi < n;
  const int64_t row = static_cast<int64_t>(b) * n + (live ? qi : 0);
  const float px = live ? p[row * 3 + 0] : 0.0f;
  const float py = live ? p[row * 3 + 1] : 0.0f;
  const float pz = live ? p[row * 3 + 2] : 0.0f;
  const float* dst_b = dst + static_cast<int64_t>(b) * m * 3;
  float best_d;
  int best_i;
  er::nn_block(dst_b, mask + static_cast<int64_t>(b) * m, m, px, py, pz, best_d, best_i);

  if (threadIdx.x < er::kQueries) {  // warps 0 and 1: the merged results
    float v[kSums];
    const float w = (live && best_d < thr2) ? src_w[row] : 0.0f;
    const float* qrow = dst_b + static_cast<int64_t>(best_i) * 3;
    const float* nrow = nrm + (static_cast<int64_t>(b) * m + best_i) * 3;
    const float nx = nrow[0], ny = nrow[1], nz = nrow[2];
    const float res = (nx * (px - qrow[0]) + ny * (py - qrow[1])) + nz * (pz - qrow[2]);
    const float J[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wa = w * J[a];
#pragma unroll
      for (int c = a; c < 6; ++c) v[k++] = wa * J[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] = (w * J[a]) * res;
    v[27] = w;
    v[28] = (w * res) * res;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      const float t = warp_sum(v[s]);
      if ((threadIdx.x & 31) == 0) warp_part[warp][s] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float t = warp_part[0][threadIdx.x];
#pragma unroll
    for (int wp = 1; wp < er::kQueries / 32; ++wp) t += warp_part[wp][threadIdx.x];
    partial[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kSums + threadIdx.x] = t;
  }
}

// Fixed-order sum of the per-block rows: out[b, s] = sum_k partial[b, k, s].
__global__ void reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                       int num_blocks) {
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  if (s >= kSums) return;
  float t = 0.0f;
  for (int k = 0; k < num_blocks; ++k) t += partial[(static_cast<int64_t>(b) * num_blocks + k) * kSums + s];
  out[b * kSums + s] = t;
}

}  // namespace

// p (B, N, 3) f32, src_w (B, N) f32, dst/nrm (B, M, 3) f32, mask (B, M) bool
// as bytes; partial: scratch (B, ceil(N / 64), 29) f32; out (B, 29) f32.
// All contiguous, on the device. Launches both kernels on `stream`; returns
// cudaGetLastError() after them.
extern "C" int er_normal_eqs_batch(const float* p, const float* src_w, const float* dst,
                                   const float* nrm, const uint8_t* mask, float* partial,
                                   float* out, int b, int n, int m, float thr2,
                                   cudaStream_t stream) {
  const int num_blocks = (n + er::kQueries - 1) / er::kQueries;
  normal_eqs_kernel<<<dim3(num_blocks, b), er::kThreads, 0, stream>>>(p, src_w, dst, nrm, mask,
                                                                      partial, n, m, thr2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  reduce_partials_kernel<<<b, 32, 0, stream>>>(partial, out, num_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int er_normal_eqs_blocks(int n) { return (n + er::kQueries - 1) / er::kQueries; }
