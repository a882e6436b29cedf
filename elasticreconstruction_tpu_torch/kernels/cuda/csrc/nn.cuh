// Block-wide brute-force nearest neighbour: the device routine shared by
// nn.cu (nearest_batch) and icp_step.cu (normal_eqs_batch).
//
// Arithmetic contract, mirrored op for op by the plain PyTorch versions
// (kernels/cuda/nn.py::nearest_batch_plain): both files are compiled with
// -fmad=false, so every product and sum below rounds on its own, as the
// separate elementwise torch ops of the plain version do:
//
//   qq  = (qx*qx + qy*qy) + qz*qz
//   rr  = ((rx*rx + ry*ry) + rz*rz) + (mask ? 0 : 3e38)
//   dot = (qx*rx + qy*ry) + qz*rz
//   d2  = max((qq + rr) - 2*dot, 0)
//
// An FMA-contracted expansion rounds differently and can flip near-ties.
// The running (min, argmin) updates on strict <, refs walked in ascending
// order within a split, and the merge across splits prefers the lower index
// on equal d2, so the result is the FIRST index of the minimum — the same
// as torch.argmin and as the TPU kernel's running min over ref blocks.
// Masked refs get +3e38 (finite: inf would break the min/argmin ties); a
// query whose refs are all masked returns (3e38, 0), like the TPU kernel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace er {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;                 // threads per block
constexpr int kSplit = 4;                     // ref splits per query
constexpr int kQueries = kThreads / kSplit;   // 64 queries per block
constexpr int kTile = 128;                    // refs per split per shared-memory tile

// Called by EVERY thread of a kThreads-wide block (it synchronises the
// block). Thread t serves query slot t % kQueries over ref split
// t / kQueries; a warp therefore shares one split and reads each shared ref
// as a broadcast. On return, the threads of split 0 (t < kQueries) hold the
// merged first-min (best_d, best_i) of their query; other threads hold the
// best of their own split only.
__device__ __forceinline__ void nn_block(const float* __restrict__ ref,
                                         const uint8_t* __restrict__ mask, int nr,
                                         float qx, float qy, float qz,
                                         float& best_d, int& best_i) {
  __shared__ float4 tile[kSplit][kTile];
  __shared__ float merge_d[kSplit][kQueries];
  __shared__ int merge_i[kSplit][kQueries];

  const int tid = threadIdx.x;
  const int split = tid / kQueries;
  const int slot = tid % kQueries;
  const int chunk = (nr + kSplit - 1) / kSplit;
  const int num_tiles = (chunk + kTile - 1) / kTile;
  const float qq = (qx * qx + qy * qy) + qz * qz;

  float bd = kBig;
  int bi = 0;
  for (int t = 0; t < num_tiles; ++t) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kSplit * kTile; e += kThreads) {
      const int s = e / kTile;
      const int k = e % kTile;
      const int j = s * chunk + t * kTile + k;
      const int end = min(s * chunk + chunk, nr);
      float4 v;
      if (j < end) {
        v.x = ref[3 * j + 0];
        v.y = ref[3 * j + 1];
        v.z = ref[3 * j + 2];
        const float r2 = (v.x * v.x + v.y * v.y) + v.z * v.z;
        v.w = r2 + (mask[j] ? 0.0f : kBig);
      } else {
        // Past the split's end: an infinite distance never wins a strict <.
        v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
      }
      tile[s][k] = v;
    }
    __syncthreads();
    const int base = split * chunk + t * kTile;
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 v = tile[split][k];
      const float dot = (qx * v.x + qy * v.y) + qz * v.z;
      const float d = fmaxf((qq + v.w) - 2.0f * dot, 0.0f);
      if (d < bd) {
        bd = d;
        bi = base + k;
      }
    }
  }

  merge_d[split][slot] = bd;
  merge_i[split][slot] = bi;
  __syncthreads();
  if (split == 0) {
    for (int s = 1; s < kSplit; ++s) {
      const float d = merge_d[s][slot];
      const int i = merge_i[s][slot];
      if (d < bd || (d == bd && i < bi)) {
        bd = d;
        bi = i;
      }
    }
  }
  best_d = bd;
  best_i = bi;
}

}  // namespace er
