// Brute-force nearest neighbour for Hopper: the device routines shared by
// nn.cu (nearest_batch) and icp_step.cu (normal_eqs_batch).
//
// Replaces the search of the TPU kernels
// elasticreconstruction_tpu/kernels/pallas/nn.py (_nearest_kernel) and
// kernels/pallas/icp_step.py (_make_kernel), which ran |q|^2 + |r|^2 - 2 q.r
// tiles on the matrix unit and kept a running (min, argmin) in VMEM across a
// sequential grid over ref blocks.
//
// Bound. B * Nq * Nr distance evaluations of 8 f32 operations (3 multiplies
// and 2 adds of the dot product, 2 adds for the norms, 1 min) against a few
// bytes per point: the f32 CUDA cores bound it (16 x 4096 x 8192 pairs are
// 4.3e9 operations, 64 us at 67 TFLOP/s, against under 1 MB of traffic).
// Not the tensor cores: the contraction is K = 3, TF32 would break the argmin,
// and a split-precision mma would still leave one to three CUDA-core
// instructions per pair for the min and argmin of its accumulators, which is
// what the whole CUDA-core loop below costs.
//
// What the earlier design lost. One query per thread, so one shared-memory
// read per pair; 12 lane-instructions per pair (unfused dot product, the
// norms added and the clamp taken per pair, compare + two selects for the
// argmin) where the work needs 4; two block-wide barriers per 128 refs with no
// load in flight meanwhile; a fixed 4-way ref split that left the coarse ICP
// shape (1024 queries) at one or two blocks per SM.
//
// This design.
// - Register tiling: a thread holds kQ = 4 queries and their running minima,
//   so one broadcast shared-memory read of a packed ref serves 4 pairs.
// - 4 lane-instructions per pair, the bound's own count. A ref is packed once
//   as (-2rx, -2ry, -2rz, w), w = |r|^2 + (masked ? 3e38 : 0), and the key
//       fma(qx, -2rx, fma(qy, -2ry, fma(qz, -2rz, w)))  =  |r|^2 + off - 2 q.r
//   is minimised with one FMNMX. |q|^2 is added and the result clamped at 0
//   after the minimum: both maps are monotone, so the minimum stays where it
//   is. The FMAs are asked for by name (__fmaf_rn) and the file is built with
//   -fmad=false, so nothing else contracts; the plain PyTorch version
//   (kernels/cuda/nn.py) mirrors every rounding. Against the earlier unfused
//   arithmetic a result moves by a few ulp of |r|^2, and the index only
//   between refs whose distances differ by that little.
// - The index is not tracked per pair. Refs are scanned in chunks of kChunk;
//   after each chunk one compare per query notes whether the chunk lowered
//   the minimum. At the end the one noted chunk is scanned again for the
//   first ref whose key equals the minimum bit for bit (the same __fmaf_rn
//   sequence gives the same bits). The result is the FIRST index of the
//   minimum, as torch.argmin and the TPU kernel's running min give it.
// - The ref split follows the shape (kernels/cuda/nn.py::plan): the grid is
//   (query tiles, ref splits, batch). A block keeps its whole range of refs
//   (at most kMaxRange, a multiple of kChunk) packed in shared memory, which
//   the second scan needs; it loads them kStep at a time, the next step's
//   rows in flight in registers while this step's chunks are scanned, with
//   one barrier per step.
// - The merge across splits is deterministic and needs no second launch: each
//   block writes its (key, index) per query to scratch and takes a ticket on
//   a counter of its (batch, query tile); the block that arrives last reads
//   all splits in ascending order, keeps the smaller key and on equal keys
//   the earlier split (the lower index), and sets the counter back to 0.
//
// Masked refs get w = 3e38 (finite: inf would break the ties); a query whose
// refs are all masked ends at key 3e38 in chunk 0 of split 0, so (3e38, 0).
// Slots of a range past the last ref hold w = +inf and never win.
//
// What remains (measured on an H100 by tools/nn_probe.py, PERF.md): the
// compiled loop is 4.375 instructions per pair (384 FFMA, 128 FMNMX, 32
// LDS.128 and 16 others per 128 pairs), but it runs at 0.62 to 0.69 of an
// instruction per clock and scheduler from 2 blocks per SM to 16: it is bound
// by its instruction stream, not by latency. Builds with 2 or 8 queries per thread,
// with half the shared-memory reads, or with FFMA in place of FMNMX ran at the
// same rate. The probe's FFMA chains show the likely limit: an FFMA that
// reads one register the operand reuse cache does not hold runs at 0.98 per
// clock and scheduler, one that reads about two at 0.75, three at 0.63. Here
// the packed ref is shared by a thread's queries, but the query and the
// running sum are read afresh by two of the three FFMAs, and FMNMX reads two.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace er {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 128;                      // threads per block
constexpr int kQ = 4;                              // queries per thread
constexpr int kQueriesPerBlock = kThreads * kQ;    // one query tile
constexpr int kChunk = 32;                         // refs per argmin chunk
constexpr int kMaxRange = 2048;                    // refs per block: 32 KB packed

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// The kQ queries of one thread: slot j of thread t is query
// tile * kQueriesPerBlock + j * kThreads + t of its batch (neighbouring
// threads on neighbouring rows). Queries past nq are zeros and not live.
struct Queries {
  float x[kQ], y[kQ], z[kQ];
  int index[kQ];
  bool live[kQ];
};

__device__ __forceinline__ Queries load_queries(const float* __restrict__ query_b, int nq) {
  Queries q;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    q.index[j] = blockIdx.x * kQueriesPerBlock + j * kThreads + threadIdx.x;
    q.live[j] = q.index[j] < nq;
    const float* row = query_b + static_cast<size_t>(q.live[j] ? q.index[j] : 0) * 3;
    q.x[j] = q.live[j] ? row[0] : 0.0f;
    q.y[j] = q.live[j] ? row[1] : 0.0f;
    q.z[j] = q.live[j] ? row[2] : 0.0f;
  }
  return q;
}

// One step of a block's ref loads: kStepRefs rows per thread, kStep per block,
// neighbouring threads on neighbouring rows. Held raw in registers while the
// step before is scanned, then packed into shared memory.
constexpr int kStepRefs = 4;
constexpr int kStep = kStepRefs * kThreads;

struct RawRefs {
  float x[kStepRefs], y[kStepRefs], z[kStepRefs];
  bool valid[kStepRefs];
};

// Refs first + u * kThreads + thread of one batch, u < kStepRefs; rows at or
// past `end` are not read.
__device__ __forceinline__ void load_refs(const float* __restrict__ ref_b,
                                          const uint8_t* __restrict__ mask_b, int first, int end,
                                          RawRefs& raw) {
#pragma unroll
  for (int u = 0; u < kStepRefs; ++u) {
    const int j = first + u * kThreads + threadIdx.x;
    const bool in = j < end;
    const float* row = ref_b + static_cast<size_t>(in ? j : 0) * 3;
    raw.x[u] = in ? row[0] : 0.0f;
    raw.y[u] = in ? row[1] : 0.0f;
    raw.z[u] = in ? row[2] : 0.0f;
    raw.valid[u] = in && mask_b[in ? j : 0];
  }
}

// (-2rx, -2ry, -2rz, |r|^2 + off), each operation rounded alone.
__device__ __forceinline__ float4 pack_ref(float x, float y, float z, bool valid) {
  const float rr = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(-2.0f * x, -2.0f * y, -2.0f * z, __fadd_rn(rr, valid ? 0.0f : kBig));
}

// |r|^2 + off - 2 q.r of one pair, three roundings.
__device__ __forceinline__ float pair_key(float qx, float qy, float qz, const float4 v) {
  return __fmaf_rn(qx, v.x, __fmaf_rn(qy, v.y, __fmaf_rn(qz, v.z, v.w)));
}

// |q|^2 + key, clamped at 0: the squared distance of a minimal key.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float key) {
  const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
  return fmaxf(__fadd_rn(qq, key), 0.0f);
}

// Called by every thread of a kThreads-wide block (it synchronises the block).
// Packs refs [begin, begin + range) of one batch into `tile` (range float4;
// range is a multiple of kChunk; slots past nr are padding) and scans them for
// the thread's kQ queries: kStep refs at a time, the next step's rows in flight
// from device memory while this step's chunks are scanned, one barrier a step.
// The whole range stays in `tile` for the second scan of one chunk per query.
// On return best[j] is the smallest key of query slot j over the range and
// best_i[j] the first ref index that attains it.
__device__ __forceinline__ void nn_search(const float* __restrict__ ref_b,
                                          const uint8_t* __restrict__ mask_b, int nr, int begin,
                                          int range, const Queries& q, float4* tile,
                                          float (&best)[kQ], int (&best_i)[kQ]) {
  static_assert(kStep % kChunk == 0, "a step must hold whole chunks");
  const int end = min(begin + range, nr);
  float seen[kQ];  // the minimum as of the last chunk that lowered it
  int chunk_of[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    best[j] = inf();
    seen[j] = inf();
    chunk_of[j] = 0;
  }
  RawRefs raw;
  load_refs(ref_b, mask_b, begin, end, raw);
  for (int s0 = 0; s0 < range; s0 += kStep) {
#pragma unroll
    for (int u = 0; u < kStepRefs; ++u) {
      const int k = s0 + u * kThreads + threadIdx.x;
      if (k < range) {
        tile[k] = begin + k < end ? pack_ref(raw.x[u], raw.y[u], raw.z[u], raw.valid[u])
                                  : make_float4(0.0f, 0.0f, 0.0f, inf());
      }
    }
    __syncthreads();
    if (s0 + kStep < range) load_refs(ref_b, mask_b, begin + s0 + kStep, end, raw);
    const int chunks_end = min(s0 + kStep, range) / kChunk;
    for (int c = s0 / kChunk; c < chunks_end; ++c) {
      const float4* ch = tile + c * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; k += 2) {
        const float4 v0 = ch[k];
        const float4 v1 = ch[k + 1];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float k0 = pair_key(q.x[j], q.y[j], q.z[j], v0);
          const float k1 = pair_key(q.x[j], q.y[j], q.z[j], v1);
          best[j] = fminf(best[j], fminf(k0, k1));
        }
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (best[j] < seen[j]) {  // strict: the first chunk that reaches the minimum
          seen[j] = best[j];
          chunk_of[j] = c;
        }
      }
    }
  }

  // The noted chunk again, for the first ref whose key is the minimum. The
  // lanes of a warp scan different chunks, which lie a multiple of 512 bytes
  // apart: read in step they would all hit the same banks. Lane l starts at
  // slot l of its chunk instead, so that each quarter-warp reads 8 different
  // 16-byte bank groups, and keeps the lowest slot that matches.
  static_assert((kChunk & (kChunk - 1)) == 0, "kChunk must be a power of two");
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const float4* ch = tile + chunk_of[j] * kChunk;
    int first = kChunk;
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const int slot = (k + threadIdx.x) & (kChunk - 1);
      if (pair_key(q.x[j], q.y[j], q.z[j], ch[slot]) == best[j]) first = min(first, slot);
    }
    // A NaN query matches nothing: stay inside the refs whatever the data.
    if (first == kChunk) first = 0;
    best_i[j] = min(begin + chunk_of[j] * kChunk + first, end - 1);
  }
}

// Called by every thread of the block, after nn_search. Publishes the block's
// results to part_key / part_idx (each B * splits * tiles * kQueriesPerBlock)
// and takes a ticket on counters[batch * tiles + tile] (zero before the
// launch). Returns true in the one block that arrives last for its (batch,
// query tile), with best / best_i merged over all splits and the counter back
// at 0; false in the others, which are done.
__device__ __forceinline__ bool nn_merge(float* part_key, int* part_idx, int* counters,
                                         float (&best)[kQ], int (&best_i)[kQ]) {
  __shared__ bool last;
  const int tiles = gridDim.x, splits = gridDim.y;
  const size_t stride = static_cast<size_t>(tiles) * kQueriesPerBlock;  // one split's queries
  const size_t base = static_cast<size_t>(blockIdx.z) * splits * stride +
                      static_cast<size_t>(blockIdx.x) * kQueriesPerBlock + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const size_t at = base + blockIdx.y * stride + j * kThreads;
    part_key[at] = best[j];
    part_idx[at] = best_i[j];
  }
  __threadfence();  // the results are visible before the ticket is
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = counters + blockIdx.z * tiles + blockIdx.x;
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // every split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    for (int s = 0; s < splits; ++s) {
      const size_t at = base + s * stride + j * kThreads;
      const float key = __ldcg(part_key + at);
      const int idx = __ldcg(part_idx + at);
      if (s == 0 || key < best[j]) {  // strict: the earlier split keeps a tie
        best[j] = key;
        best_i[j] = idx;
      }
    }
  }
  return true;
}

}  // namespace er

// The constants a library was built with, for its wrapper to check (each
// library includes this header once): 0 threads per block, 1 queries per
// thread, 2 chunk, 3 largest range.
extern "C" int er_nn_geometry(int which) {
  const int values[4] = {er::kThreads, er::kQ, er::kChunk, er::kMaxRange};
  return which >= 0 && which < 4 ? values[which] : -1;
}
