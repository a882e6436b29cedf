// normal_eqs_batch: one fused point-to-plane Gauss-Newton step, one launch.
//
// Replaces the TPU kernel elasticreconstruction_tpu/kernels/pallas/icp_step.py
// (_make_kernel, launched by normal_eqs_batch at icp_step.py:168). Per batch,
// for each transformed source point p: nearest dst point (index i), matched
// point q = dst[i] and normal n = nrm[i], weight w = src_w * [d2 < thr2],
// residual r = n.(p - q) and Jacobian J = [n, p x n]. Writes per batch, into
// one row of 44 floats, the full symmetric H = sum w J^T J (36, row-major),
// g = sum w J r (6), n_in = sum w and sum w r^2.
//
// Bound: the search dominates (B * N * M pairs of 8 f32 operations; the
// per-query epilogue is ~80), so like nn.cu it is bound by f32 operations on
// the CUDA cores. The search, its tie rule and its arithmetic are nn.cuh's, so
// this kernel and nearest_batch pick the same match.
//
// What the first CUDA version lost beyond its search: the epilogue ran on 64
// of a block's 256 threads, each block shuffled its 29 sums down warp by warp,
// a second kernel added the blocks' rows one dependent add at a time, and the
// wrapper spread the 21 upper-triangle sums into H with two index_put calls
// from an index tensor it copied to the device on every call.
//
// This design: the block that merges the ref splits of a query tile (the last
// to arrive, nn.cuh::nn_merge) still holds the tile's queries in registers and
// runs the epilogue for them on all its threads: 4 queries per thread summed
// in registers, the block's 128 partial sums of each of the 29 values added
// through shared memory in a fixed order, one row per (batch, tile) written to
// scratch. A second ticket per batch finds the tile that finishes last; it
// adds the tiles' rows in ascending order and writes H (mirrored), g, n_in and
// sum w r^2. No float atomics: the same bits from run to run.
//
// What differs from the TPU kernel, and why:
// - The matched row is loaded directly. The TPU kernel gathered it with a
//   bf16 hi/lo one-hot matmul only because Mosaic has no cross-lane gather.
// - Exact distance ties take the FIRST index, like the plain version
//   (registration/icp.py's unfused step); the TPU kernel averaged exact ties
//   within a block.
#include "nn.cuh"

namespace {

constexpr int kSums = 29;   // 21 upper-triangle H, 6 g, n_in, sum w r^2
constexpr int kOut = 44;    // 36 H, 6 g, n_in, sum w r^2
constexpr int kSpan = 32;   // threads whose values one partial sum of the block reduction adds
constexpr int kParts = er::kThreads / kSpan;  // partial sums per value
// Shared memory of the reduction, in floats; it reuses the ref tile.
constexpr int kReduceFloats = kSums * er::kThreads + kSums * kParts;

// Upper triangle, row-major: sum k is H[kRow[k]][kCol[k]].
__constant__ int8_t kRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int8_t kCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__global__ void __launch_bounds__(er::kThreads)
normal_eqs_kernel(const float* __restrict__ p, const float* __restrict__ src_w,
                  const float* __restrict__ dst, const float* __restrict__ nrm,
                  const uint8_t* __restrict__ mask, float* __restrict__ out, float* part_key,
                  int* part_idx, float* rows, int* counters, int n, int m, int range, float thr2) {
  extern __shared__ float4 tile[];
  __shared__ bool last_tile;
  const int tid = threadIdx.x;
  const int tiles = gridDim.x;
  const size_t b = blockIdx.z;
  const float* dst_b = dst + b * m * 3;
  const float* nrm_b = nrm + b * m * 3;
  const er::Queries q = er::load_queries(p + b * n * 3, n);
  float best[er::kQ];
  int best_i[er::kQ];
  er::nn_search(dst_b, mask + b * m, m, blockIdx.y * range, range, q, tile, best, best_i);
  if (!er::nn_merge(part_key, part_idx, counters, best, best_i)) return;

  // Epilogue of this query tile: the thread's kQ queries, summed in slot order.
  float acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
#pragma unroll
  for (int j = 0; j < er::kQ; ++j) {
    const float px = q.x[j], py = q.y[j], pz = q.z[j];
    const float d2 = er::sqdist(px, py, pz, best[j]);
    const float w = (q.live[j] && d2 < thr2) ? src_w[b * n + q.index[j]] : 0.0f;
    const float* qrow = dst_b + static_cast<size_t>(best_i[j]) * 3;
    const float* nrow = nrm_b + static_cast<size_t>(best_i[j]) * 3;
    const float nx = nrow[0], ny = nrow[1], nz = nrow[2];
    const float res = (nx * (px - qrow[0]) + ny * (py - qrow[1])) + nz * (pz - qrow[2]);
    const float J[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wa = w * J[a];
#pragma unroll
      for (int c = a; c < 6; ++c) acc[k++] += wa * J[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += (w * J[a]) * res;
    acc[27] += w;
    acc[28] += (w * res) * res;
  }

  // Block reduction in a fixed order. nn_merge's barriers lie behind every
  // thread's last read of the ref tile, so its memory is free.
  float* red = reinterpret_cast<float*>(tile);   // [kSums][kThreads]
  float* parts = red + kSums * er::kThreads;     // [kSums][kParts]
#pragma unroll
  for (int s = 0; s < kSums; ++s) red[s * er::kThreads + tid] = acc[s];
  __syncthreads();
  if (tid < kSums * kParts) {
    static_assert(kSums * kParts <= er::kThreads, "one thread per partial sum");
    const float* src = red + (tid / kParts) * er::kThreads + (tid % kParts) * kSpan;
    float t = 0.0f;
    // kSpan = 32: each thread starts at its own bank; its order is still fixed.
    for (int i = 0; i < kSpan; ++i) t += src[(i + tid) & (kSpan - 1)];
    parts[tid] = t;
  }
  __syncthreads();
  float* row = rows + (b * tiles + blockIdx.x) * kSums;
  if (tid < kSums) {
    float t = parts[tid * kParts];
#pragma unroll
    for (int i = 1; i < kParts; ++i) t += parts[tid * kParts + i];
    row[tid] = t;
  }

  // The tile that finishes last in its batch adds the tiles' rows.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + gridDim.z * tiles + b;
    last_tile = atomicAdd(counter, 1) == tiles - 1;
    if (last_tile) *counter = 0;
  }
  __syncthreads();
  if (!last_tile || tid >= kSums) return;
  __threadfence();
  float t = 0.0f;
  for (int k = 0; k < tiles; ++k) t += __ldcg(rows + (b * tiles + k) * kSums + tid);
  float* o = out + b * kOut;
  if (tid < 21) {
    o[kRow[tid] * 6 + kCol[tid]] = t;
    o[kCol[tid] * 6 + kRow[tid]] = t;
  } else {
    o[36 + (tid - 21)] = t;  // g at 36..41, n_in at 42, sum w r^2 at 43
  }
}

}  // namespace

// p (B, N, 3) f32, src_w (B, N) f32, dst/nrm (B, M, 3) f32, mask (B, M) bool
// as bytes; out (B, 44) f32, every element written. scratch:
// 2 * B * splits * tiles * 512 + B * tiles * 29 f32 (tiles = ceil(N / 512));
// counters: B * tiles + B int32, all zero, left all zero. Each block scans
// `range` refs (a multiple of 32, at most 2048); splits * range covers M. All
// contiguous, on the device. Launches one kernel on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a geometry
// the kernel does not take.
extern "C" int er_normal_eqs_batch(const float* p, const float* src_w, const float* dst,
                                   const float* nrm, const uint8_t* mask, float* out,
                                   float* scratch, int* counters, int b, int n, int m, int splits,
                                   int range, float thr2, cudaStream_t stream) {
  if (range <= 0 || range % er::kChunk != 0 || range > er::kMaxRange || splits <= 0 ||
      static_cast<int64_t>(splits) * range < m || static_cast<int64_t>(splits - 1) * range >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + er::kQueriesPerBlock - 1) / er::kQueriesPerBlock;
  const size_t partial = static_cast<size_t>(b) * splits * tiles * er::kQueriesPerBlock;
  const size_t tile_bytes = range * sizeof(float4);
  const size_t reduce_bytes = kReduceFloats * sizeof(float);
  normal_eqs_kernel<<<dim3(tiles, splits, b), er::kThreads,
                      tile_bytes > reduce_bytes ? tile_bytes : reduce_bytes, stream>>>(
      p, src_w, dst, nrm, mask, out, scratch, reinterpret_cast<int*>(scratch + partial),
      scratch + 2 * partial, counters, n, m, range, thr2);
  return static_cast<int>(cudaGetLastError());
}
