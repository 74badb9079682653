// Dilated depthwise K³ conv for Hopper: stride 1, dilation `dil`, padding
// dil·(K/2) (zero outside the volume), plus the bias, in one pass. f32 in,
// out and accumulation; channels-last (B, D, H, W, C); weights (K, K, K, 1,
// C), taps (kd, kh, kw) row-major.
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/dwconv3d_kernel.py
// depthwise_conv3d_pallas (:172) → _dw_forward (:148) → _dense (:98) →
// _dw_kernel (:44). The TPU kernel's halo tiles, tile padding and à-trous
// space-to-batch folding exist to fit a dilated halo into VMEM lanes; none
// of them is carried over. This is the function as a direct stencil.
//
// What bounds it: at most 2·K³ FLOP per voxel-channel against 8 bytes
// moved, but only the taps inside the volume count, 0.17 and 0.30 of them
// at the model's two sites (B=8, 8³×128 K5 d3 and 4³×256 K3 d2), so there
// the card's bound is the bytes (1.3 and 0.3 µs), and at these sizes launch
// and load latency dominate. The design keeps it simple and right:
//  - one thread per (voxel, channel), channels fastest: the 32 lanes of a
//    warp hold 32 neighbouring channels of one voxel, so each tap's read is
//    128 contiguous bytes, and neighbouring voxels' reads meet in L1/L2;
//  - the block's (K³, 32) weights sit in shared memory, loaded once for the
//    kVoxels voxels the block walks;
//  - each thread loops only over the taps inside the volume (a tap outside
//    contributes zero), whose range it computes per axis, so there are no
//    bounds tests in the loop and 4³ with dilation 3, where most taps fall
//    outside, is exact. A first version looped over all K³ taps with a test
//    each (at 8³×128 K5 d3, 0.17 of them are inside): 1.97 device-ms per
//    volume on the size-aware path, against 1.48 now (`main_path.py
//    --trans_block TransformerBlock_Deform_LKA_Spatial_sequential`, H100).
// Grid: (ceil(D·H·W / kVoxels), ceil(C / 32), B); 256 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kCT = 32;       // channels per block: one warp's lanes
constexpr int kRows = 8;      // voxels in flight per block (warps)
constexpr int kVoxels = 32;   // voxels per block

__global__ void __launch_bounds__(kCT * kRows)
dwconv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int D,
                int H, int W, int C, int K, int dil) {
  extern __shared__ float ws[];  // [K³][kCT]
  const int lane = threadIdx.x % kCT, row = threadIdx.x / kCT;
  const int c0 = blockIdx.y * kCT;
  const int taps = K * K * K;
  for (int i = threadIdx.x; i < taps * kCT; i += blockDim.x) {
    const int cc = c0 + i % kCT;
    ws[i] = cc < C ? __ldg(w + (i / kCT) * C + cc) : 0.f;
  }
  __syncthreads();
  const int c = c0 + lane;
  if (c >= C) return;
  const int HW = H * W, V = D * HW;
  const float* xb = x + (size_t)blockIdx.z * V * C + c;
  float* yb = y + (size_t)blockIdx.z * V * C + c;
  const float b = bias != nullptr ? __ldg(bias + c) : 0.f;
  const int m = K / 2;
  const int v_end = min(V, (int)(blockIdx.x + 1) * kVoxels);
  for (int v = blockIdx.x * kVoxels + row; v < v_end; v += kRows) {
    const int z = v / HW, yy = (v / W) % H, xx = v % W;
    // per axis, the taps k whose position p + (k - m)·dil lies in [0, S)
    const int kd_lo = max(0, m - z / dil), kd_hi = min(K, m + (D - 1 - z) / dil + 1);
    const int kh_lo = max(0, m - yy / dil), kh_hi = min(K, m + (H - 1 - yy) / dil + 1);
    const int kw_lo = max(0, m - xx / dil), kw_hi = min(K, m + (W - 1 - xx) / dil + 1);
    float acc = 0.f;
    for (int kd = kd_lo; kd < kd_hi; ++kd) {
      const int zi = z + (kd - m) * dil;
      for (int kh = kh_lo; kh < kh_hi; ++kh) {
        const int yi = yy + (kh - m) * dil;
        const float* xrow = xb + ((zi * H + yi) * W + xx) * C;
        const float* wrow = ws + (kd * K + kh) * K * kCT + lane;
        for (int kw = kw_lo; kw < kw_hi; ++kw) {
          acc = fmaf(wrow[kw * kCT], __ldg(xrow + (kw - m) * dil * C), acc);
        }
      }
    }
    yb[v * C] = acc + b;
  }
}

}  // namespace

extern "C" int dlka_dwconv3d(const void* x, const void* w, const void* bias,
                             void* y, int B, int D, int H, int W, int C, int K,
                             int dil, void* stream) {
  if (K <= 0 || K % 2 == 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * K * K * kCT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dwconv3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int V = D * H * W;
  dim3 grid((V + kVoxels - 1) / kVoxels, (C + kCT - 1) / kCT, B);
  dwconv3d_kernel<<<grid, kCT * kRows, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y, D, H, W,
      C, K, dil);
  return (int)cudaGetLastError();
}
