// nearest_batch: per batch and query, the nearest valid reference point.
//
// Replaces the TPU kernel elasticreconstruction_tpu/kernels/pallas/nn.py
// (_nearest_kernel, launched by nearest_batch at nn.py:87). That kernel ran
// the |q|^2+|r|^2-2q.r distance tile on the MXU in f32 and folded it into a
// running (min, argmin) held in VMEM across a sequential grid over ref blocks.
//
// On Hopper the contraction is K=3: far too thin for tensor cores, and TF32
// would break the argmin, so the distances run on the f32 CUDA cores. The
// work is (B * Nq * Nr) distance evaluations of ~8 f32 operations each and a
// few bytes per query, so the kernel is bound by f32 operations, not memory
// (16 x 4096 x 8192 = 5.4e8 pairs per ICP step: ~4.3e9 ops, ~64 us at the
// H100's 67 TFLOP/s, against ~0.8 MB of traffic). The design follows: each
// thread keeps its query and running (min, argmin) in registers, ref tiles
// with their mask folded into a +3e38 offset stream through shared memory and
// are read as warp-wide broadcasts, and each query's refs are split four ways
// inside the block so that even the 1024-query coarse ICP phase fills the
// card. The batch is the grid's y dimension. See nn.cuh for the arithmetic
// contract and the tie rule.
#include "nn.cuh"

namespace {

__global__ void __launch_bounds__(er::kThreads)
nearest_kernel(const float* __restrict__ query, const float* __restrict__ ref,
               const uint8_t* __restrict__ mask, float* __restrict__ d2_out,
               int32_t* __restrict__ idx_out, int nq, int nr) {
  const int b = blockIdx.y;
  const int slot = threadIdx.x % er::kQueries;
  const int q = blockIdx.x * er::kQueries + slot;
  const bool live = q < nq;
  const float* qp = query + (static_cast<int64_t>(b) * nq + (live ? q : 0)) * 3;
  const float qx = live ? qp[0] : 0.0f;
  const float qy = live ? qp[1] : 0.0f;
  const float qz = live ? qp[2] : 0.0f;
  float best_d;
  int best_i;
  er::nn_block(ref + static_cast<int64_t>(b) * nr * 3, mask + static_cast<int64_t>(b) * nr,
               nr, qx, qy, qz, best_d, best_i);
  if (threadIdx.x < er::kQueries && live) {
    d2_out[static_cast<int64_t>(b) * nq + q] = best_d;
    idx_out[static_cast<int64_t>(b) * nq + q] = best_i;
  }
}

}  // namespace

// query (B, Nq, 3) f32, ref (B, Nr, 3) f32, ref_mask (B, Nr) bool as bytes
// -> d2 (B, Nq) f32, idx (B, Nq) int32. All contiguous, on the device.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int er_nearest_batch(const float* query, const float* ref, const uint8_t* ref_mask,
                                float* d2, int32_t* idx, int b, int nq, int nr,
                                cudaStream_t stream) {
  const dim3 grid((nq + er::kQueries - 1) / er::kQueries, b);
  nearest_kernel<<<grid, er::kThreads, 0, stream>>>(query, ref, ref_mask, d2, idx, nq, nr);
  return static_cast<int>(cudaGetLastError());
}
