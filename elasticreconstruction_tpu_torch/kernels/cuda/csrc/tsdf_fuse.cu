// tsdf_fuse: one depth frame fused into a TSDF volume, one launch a frame,
// in place.
//
// Replaces no TPU kernel: the reference's fuse
// (elasticreconstruction_tpu/kernels/tsdf.py::fuse) is plain jnp, and so is
// the port's plain version (kernels/tsdf.py::fuse_plain). That version is
// some 83 elementwise launches a frame, each writing a full-volume
// temporary: at 512^3 about 22 ms of device time a frame.
//
// Per voxel (i, j, k) of an x-slab whose plane 0 is plane x_offset of the
// volume: its centre, the camera coordinates through the pose's inverse,
// the projection to the nearest pixel, the depth there, the z-difference
// SDF; where the observation is valid (in the image, depth in range, not
// more than the truncation behind the surface) the running weighted average
// of tsdf and one more unit of weight; the weight clamped to max_weight.
//
// Bound: bytes. The plain version's result needs, at the least, every
// voxel's weight read (the clamp), and the observed voxels' tsdf read and
// both written: 4 B a voxel plus 12 B an observed one, with the depth map
// (1.2 MB at 640x480, kept in L2). Read and written whole, tsdf and weight
// are 16 B a voxel, 2.15 GB at 512^3: 0.64 ms at 3.35 TB/s. The design:
// neighbouring threads on neighbouring z, so every load and store
// coalesces; each thread eight voxels along y, so the plane's and the
// column's terms of the camera coordinates (float64 centres among them) are
// formed once for eight; a three-dimensional grid, so no thread divides to
// find its voxel; the pose (16 floats) read on the device; the depth
// map through the read-only cache; nothing of the volume touched but the
// weight where no observation lands, and the weight written there only
// where the clamp (or the plain version's + 0.0) changes its bits; no
// temporaries. On an H100 at 512^3 and 640x480 it runs about 3x above its
// bytes need, held by instructions: the float64 conversions and the IEEE
// divisions that keep it bit-equal (PERF.md).
//
// Arithmetic: every operation rounds as the plain version's PyTorch ops do,
// so the two agree bit for bit on the card (built with -fmad=false, and
// every float operation named by its intrinsic):
// - the centre o + i h as core/types.py::fma: a float64 product and add of
//   the float32 index and the float64 h and o, rounded once to float32;
// - a = c - t, then x_j = (a_x R[0][j] + a_y R[1][j]) + a_z R[2][j], each
//   product and sum rounded to float32;
// - the projection x / safe_z (IEEE division) into the fma of fx and cx
//   (float64, as above); the nearest pixel by rintf (half to even, as
//   torch.round), read only where the point lies in the image, where the
//   plain version's clip and NaN clamp change nothing;
// - every comparison against the scalars' float32 values, as PyTorch casts
//   a Python scalar to the tensor's float32;
// - clip(sdf * (float32 reciprocal of the truncation), -1, 1), then
//   (tsdf w + obs) / max(w + 1, 1) with IEEE division, NaN kept by the
//   clamps as torch.clamp keeps it; the weight min(w + 1, max_weight).
//
// In place: tsdf and weight are read and written by the same thread, so no
// voxel is read after another thread wrote it.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // voxels along z a block
constexpr int kRows = 8;       // rows along y a block: a thread's plane and column terms serve them all

struct Params {
  int ny, nz, x_offset;
  int h, w;
  double ox, oy, oz, voxel;  // world position of voxel (0, 0, 0)'s centre; voxel size
  double fx, fy, cx, cy;     // intrinsics
  float truncation, inv_truncation, depth_min, depth_max, max_weight;
};

// o + i * h, as core/types.py::fma computes it for a float32 index i.
__device__ __forceinline__ float centre(int i, double h, double o) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(static_cast<float>(i)), h), o));
}

// q * f + c, as core/types.py::fma computes it.
__device__ __forceinline__ float pixel(float q, double f, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(q), f), c));
}

// torch.clamp_min / clamp_max: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// One voxel at camera coordinates (x, y, z): core/camera.py::project_uv, the
// observation's validity, the update.
__device__ __forceinline__ void fuse_voxel(float* tsdf, float* weight, const float* depth, const Params& p,
                                           float x, float y, float z) {
  const bool in_front = z > 1e-6f;
  const float safe_z = in_front ? z : 1.0f;
  const float u = pixel(__fdiv_rn(x, safe_z), p.fx, p.cx);
  const float v = pixel(__fdiv_rn(y, safe_z), p.fy, p.cy);
  const bool in_img = in_front && u >= 0.0f && u <= static_cast<float>(p.w - 1) && v >= 0.0f &&
                      v <= static_cast<float>(p.h - 1);
  bool valid = false;
  float sdf = 0.0f;
  if (in_img) {
    const float d = __ldg(depth + static_cast<int>(rintf(v)) * p.w + static_cast<int>(rintf(u)));
    sdf = __fsub_rn(d, z);
    valid = d >= p.depth_min && d <= p.depth_max && sdf >= -p.truncation;
  }
  const float w_old = *weight;
  if (!valid) {
    // The plain version's w + 0.0 and clamp: write only where the bits change.
    const float w_new = clamp_max(__fadd_rn(w_old, 0.0f), p.max_weight);
    if (__float_as_int(w_new) != __float_as_int(w_old)) *weight = w_new;
    return;
  }
  float obs = __fmul_rn(sdf, p.inv_truncation);
  obs = obs < -1.0f ? -1.0f : (obs > 1.0f ? 1.0f : obs);
  const float w_new = __fadd_rn(w_old, 1.0f);
  *tsdf = __fdiv_rn(__fadd_rn(__fmul_rn(*tsdf, w_old), obs), clamp_min(w_new, 1.0f));
  *weight = clamp_max(w_new, p.max_weight);
}

// Block (z chunk, y row group, x plane); thread: one z, kRows rows.
__global__ void __launch_bounds__(kThreads)
tsdf_fuse_kernel(float* __restrict__ tsdf, float* __restrict__ weight, const float* __restrict__ depth,
                 const float* __restrict__ pose, Params p) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= p.nz) return;
  const int i = blockIdx.z;
  const int j0 = blockIdx.y * kRows;
  const int j1 = min(j0 + kRows, p.ny);
  float R[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[r][c] = __ldg(pose + 4 * r + c);
  }
  // Camera coordinate c of voxel (i, j, k): (a_x R[0][c] + a_y R[1][c]) + a_z R[2][c], a = centre - t.
  const float ax = __fsub_rn(centre(i + p.x_offset, p.voxel, p.ox), __ldg(pose + 3));
  const float az = __fsub_rn(centre(k, p.voxel, p.oz), __ldg(pose + 11));
  const float ty = __ldg(pose + 7);
  float xterm[3], zterm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xterm[c] = __fmul_rn(ax, R[0][c]);
    zterm[c] = __fmul_rn(az, R[2][c]);
  }
  for (int j = j0; j < j1; ++j) {
    const float ay = __fsub_rn(centre(j, p.voxel, p.oy), ty);
    float cam[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cam[c] = __fadd_rn(__fadd_rn(xterm[c], __fmul_rn(ay, R[1][c])), zterm[c]);
    const int64_t idx = (static_cast<int64_t>(i) * p.ny + j) * p.nz + k;
    fuse_voxel(tsdf + idx, weight + idx, depth, p, cam[0], cam[1], cam[2]);
  }
}

}  // namespace

// tsdf, weight (nx, ny, nz) f32, updated in place; depth (h, w) f32 metres;
// pose (4, 4) f32 camera-to-world, read on the device. The volume is the
// x-slab from plane x_offset of a volume whose voxel (0, 0, 0) is centred at
// (ox, oy, oz). All contiguous, on the device. Launches on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int er_tsdf_fuse(float* tsdf, float* weight, const float* depth, const float* pose, int nx, int ny,
                            int nz, int x_offset, int h, int w, double ox, double oy, double oz, double voxel,
                            double fx, double fy, double cx, double cy, float truncation, float inv_truncation,
                            float depth_min, float depth_max, float max_weight, cudaStream_t stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || h <= 0 || w <= 0 || x_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((nz + kThreads - 1) / kThreads, (ny + kRows - 1) / kRows, nx);
  if (blocks.y > 65535 || blocks.z > 65535 || static_cast<int64_t>(h) * w > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{ny, nz, x_offset, h, w, ox, oy, oz, voxel, fx, fy, cx, cy,
                 truncation, inv_truncation, depth_min, depth_max, max_weight};
  tsdf_fuse_kernel<<<blocks, kThreads, 0, stream>>>(tsdf, weight, depth, pose, p);
  return static_cast<int>(cudaGetLastError());
}
