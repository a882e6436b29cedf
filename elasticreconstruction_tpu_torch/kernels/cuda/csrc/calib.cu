// Calibration microkernels: three elementwise kernels whose instruction stream
// is known, so the rate they reach names a peak of the card.
//
// They replace the three Pallas kernels that kernels_bench.py::calibrate builds
// for the TPU's vector unit:
//   er_fma_chain            <- fma_kernel (kernels_bench.py:162-173)
//   er_where_chain          <- cmp_kernel (kernels_bench.py:206-220)
//   er_threshold_sum_chain  <- ts_kernel  (kernels_bench.py:251-267)
//
// Each element carries kChains = 8 independent chains in registers through
// `iters` iterations and writes the sum of its chains, so every chain stays
// live. One thread per element, the input read once and the output written
// once: 8 bytes moved per element against 2 * 8 * 64 = 1024 flop for the FMA
// chain at iters = 64, far above the card's ~20 flop/byte ridge (67 TFLOP/s f32
// over 3.35 TB/s). All three are bound by operations, not bytes; eight
// independent chains per thread and many warps per SM hide the ALU latency.
//
// The iteration loop stays a loop (`#pragma unroll 1`) whose body holds
// kUnroll = 4 iterations, so the loop's own counter, compare and branch are
// spread over 32 chain steps and the SASS of one loop body can be read and
// counted (cuobjdump -sass). `iters` must be a multiple of kUnroll; the
// wrapper checks it.
//
// Build with -fmad=true. The FMA chain asks for the fused multiply-add by name
// (__fmaf_rn); the two thresholds that depend on the loop index are written
// with __fmul_rn/__fadd_rn, which the compiler never contracts, so they round
// like the separate multiply and add of the plain PyTorch versions and the
// where and threshold-sum chains agree with those bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 4;
constexpr int kThreads = 256;

// Chain c starts from x + 1e-5 * c (all three kernels).
__device__ __forceinline__ void init_chains(float x, float (&a)[kChains]) {
#pragma unroll
  for (int c = 0; c < kChains; ++c) a[c] = x + static_cast<float>(1e-5 * c);
}

__device__ __forceinline__ float sum_chains(const float (&a)[kChains]) {
  float s = a[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) s += a[c];
  return s;
}

// a_c <- fma(a_c, 1 + 1e-7 (c + 1), 1e-7): one FFMA per chain per iteration.
__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n, int iters) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  float a[kChains];
  init_chains(x[e], a);
#pragma unroll 1
  for (int k4 = 0; k4 < iters; k4 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        a[c] = __fmaf_rn(a[c], static_cast<float>(1.0 + 1e-7 * (c + 1)), 1e-7f);
    }
  }
  out[e] = sum_chains(a);
}

// a_c <- a_c > t_k ? y : a_c with t_k = 0.5 + 1e-4 k: one compare and one
// select per chain per iteration; the threshold is shared by the 8 chains.
__global__ void __launch_bounds__(kThreads)
where_chain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int64_t n, int iters) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  float a[kChains];
  init_chains(x[e], a);
  const float ye = y[e];
#pragma unroll 1
  for (int k4 = 0; k4 < iters; k4 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float t = __fadd_rn(0.5f, __fmul_rn(1e-4f, static_cast<float>(k4 + u)));
#pragma unroll
      for (int c = 0; c < kChains; ++c) a[c] = a[c] > t ? ye : a[c];
    }
  }
  out[e] = sum_chains(a);
}

// a_c <- a_c + float(m & (x >= t_k + 1e-3 c)) with m = x > 0.2 and
// t_k = 0.4 + 1e-4 k: compare, and, convert, add per chain per iteration.
__global__ void __launch_bounds__(kThreads)
threshold_sum_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                           int iters) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const float xe = x[e];
  float a[kChains];
  init_chains(xe, a);
  const bool m = xe > 0.2f;
#pragma unroll 1
  for (int k4 = 0; k4 < iters; k4 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float t = __fadd_rn(0.4f, __fmul_rn(1e-4f, static_cast<float>(k4 + u)));
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const bool hit = m & (xe >= __fadd_rn(t, static_cast<float>(1e-3 * c)));
        a[c] = __fadd_rn(a[c], hit ? 1.0f : 0.0f);
      }
    }
  }
  out[e] = sum_chains(a);
}

inline unsigned blocks(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// x, out: n contiguous f32 on the device; iters a multiple of 4. Each launches
// on `stream`, allocates nothing, and returns cudaGetLastError() of the launch.
extern "C" int er_fma_chain(const float* x, float* out, int64_t n, int iters,
                            cudaStream_t stream) {
  fma_chain_kernel<<<blocks(n), kThreads, 0, stream>>>(x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int er_where_chain(const float* x, const float* y, float* out, int64_t n, int iters,
                              cudaStream_t stream) {
  where_chain_kernel<<<blocks(n), kThreads, 0, stream>>>(x, y, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int er_threshold_sum_chain(const float* x, float* out, int64_t n, int iters,
                                      cudaStream_t stream) {
  threshold_sum_chain_kernel<<<blocks(n), kThreads, 0, stream>>>(x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}
