// FFMA rate against the registers an FFMA reads afresh.
//
// A probe for tools/nn_probe.py, not a kernel of the pipeline. Each thread
// runs 16 independent accumulators through `iters` bodies of 128 FFMAs
// (built with -fmad=false; the FMAs are asked for by name). The modes differ
// only in which operands consecutive FFMAs share, and so in how many of an
// FFMA's three source registers the operand reuse cache can hold:
//   0  a = fma(a, x0, y0)        both multiplicands shared: one fresh read
//   1  a = fma(xi, y0, a)        the same, accumulator last
//   2  a = fma(xi, yj, a)        an outer product: one multiplicand shared at best
//   3  a = fma(xj, y(i+j), a)    nothing shared: three fresh reads
// The nearest-neighbour scan (csrc/nn.cuh) is of kind 2: the packed ref is
// shared by a thread's queries, the query and the running sum are not.
#include <cuda_runtime.h>

template <int MODE>
__global__ void __launch_bounds__(128) ffma_kernel(const float* in, float* out, int iters) {
  float acc[16], x[4], y[4];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < 16; ++i) acc[i] = in[(t + i) & 1023];
  for (int i = 0; i < 4; ++i) {
    x[i] = in[(t + 16 + i) & 1023];
    y[i] = in[(t + 32 + i) & 1023];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& a = acc[i * 4 + j];
          if (MODE == 0) a = __fmaf_rn(a, x[0], y[0]);
          if (MODE == 1) a = __fmaf_rn(x[i], y[0], a);
          if (MODE == 2) a = __fmaf_rn(x[i], y[j], a);
          if (MODE == 3) a = __fmaf_rn(x[j], y[(i + j) & 3], a);
        }
      }
    }
  }
  float s = 0.0f;
  for (int i = 0; i < 16; ++i) s += acc[i];
  out[t] = s;
}

// in: 1024 f32; out: blocks * 128 f32. 128 FFMAs per thread and iteration.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int er_ffma_operands(int mode, const float* in, float* out, int blocks, int iters,
                                cudaStream_t stream) {
  if (mode == 0) ffma_kernel<0><<<blocks, 128, 0, stream>>>(in, out, iters);
  else if (mode == 1) ffma_kernel<1><<<blocks, 128, 0, stream>>>(in, out, iters);
  else if (mode == 2) ffma_kernel<2><<<blocks, 128, 0, stream>>>(in, out, iters);
  else if (mode == 3) ffma_kernel<3><<<blocks, 128, 0, stream>>>(in, out, iters);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
