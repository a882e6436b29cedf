// nearest_batch: per batch and query, the nearest valid reference point.
//
// Replaces the TPU kernel elasticreconstruction_tpu/kernels/pallas/nn.py
// (_nearest_kernel, launched by nearest_batch at nn.py:87). The bound (f32
// operations on the CUDA cores, 8 per pair), what the first CUDA version of
// this kernel lost against it and what this one does about it are set out in
// nn.cuh, whose routines do all the work: this file is one kernel that loads a
// thread's four queries, searches its block's range of refs, merges the ref
// splits in the block that finishes last, and there writes
// d2 = max(|q|^2 + key, 0) and the index. One launch, no atomics on floats,
// the same bits from run to run.
#include "nn.cuh"

namespace {

__global__ void __launch_bounds__(er::kThreads)
nearest_kernel(const float* __restrict__ query, const float* __restrict__ ref,
               const uint8_t* __restrict__ mask, float* __restrict__ d2_out,
               int32_t* __restrict__ idx_out, float* part_key, int* part_idx, int* counters,
               int nq, int nr, int range) {
  extern __shared__ float4 tile[];
  const size_t b = blockIdx.z;
  const er::Queries q = er::load_queries(query + b * nq * 3, nq);
  float best[er::kQ];
  int best_i[er::kQ];
  er::nn_search(ref + b * nr * 3, mask + b * nr, nr, blockIdx.y * range, range, q, tile, best,
                best_i);
  if (!er::nn_merge(part_key, part_idx, counters, best, best_i)) return;
#pragma unroll
  for (int j = 0; j < er::kQ; ++j) {
    if (q.live[j]) {
      d2_out[b * nq + q.index[j]] = er::sqdist(q.x[j], q.y[j], q.z[j], best[j]);
      idx_out[b * nq + q.index[j]] = best_i[j];
    }
  }
}

}  // namespace

// query (B, Nq, 3) f32, ref (B, Nr, 3) f32, ref_mask (B, Nr) bool as bytes
// -> d2 (B, Nq) f32, idx (B, Nq) int32. scratch: 2 * B * splits * tiles * 512
// f32 (tiles = ceil(Nq / 512)); counters: B * tiles int32, all zero, left all
// zero. Each block scans `range` refs (a multiple of 32, at most 2048);
// splits * range covers Nr. All contiguous, on the device. Launches on
// `stream`; returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a geometry the kernel does not take.
extern "C" int er_nearest_batch(const float* query, const float* ref, const uint8_t* ref_mask,
                                float* d2, int32_t* idx, float* scratch, int* counters, int b,
                                int nq, int nr, int splits, int range, cudaStream_t stream) {
  if (range <= 0 || range % er::kChunk != 0 || range > er::kMaxRange || splits <= 0 ||
      static_cast<int64_t>(splits) * range < nr || static_cast<int64_t>(splits - 1) * range >= nr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (nq + er::kQueriesPerBlock - 1) / er::kQueriesPerBlock;
  const size_t partial = static_cast<size_t>(b) * splits * tiles * er::kQueriesPerBlock;
  nearest_kernel<<<dim3(tiles, splits, b), er::kThreads, range * sizeof(float4), stream>>>(
      query, ref, ref_mask, d2, idx, scratch, reinterpret_cast<int*>(scratch + partial), counters,
      nq, nr, range);
  return static_cast<int>(cudaGetLastError());
}
