// Fused 2D LKA chain for Hopper: dw5² (pad 2) + b5, zero outside the image,
// then dw7² dilation 3 (pad 9) + b7, in one launch. f32 in, out and
// accumulation; channels-last (B, H, W, C).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/lka_fused_kernel.py
// dw_chain2d_fused (:261) → _dw_chain2d (:190) → _chain2d_kernel (:117),
// which holds a row of W + 22 ≤ 128 lanes; this kernel has no such limit.
//
// What bounds it: 2·(25 + 49) = 148 FLOP per pixel-channel against 8 bytes
// moved, so operations (f32 on the CUDA cores); the risk is recomputing the
// dw5 plane for the dilated stage's halo of 9. The design removes it: a
// block holds, for a slice of CT channels of one image, the whole input
// plane with a zero halo of 2 and the whole dw5 plane in shared memory, so
// each input value is read from device memory once, each dw5 value is
// computed once, and the dw5 taps need no bounds checks (the dilated
// stage skips taps outside the image, where the dw5 plane is zero).
// Shared memory: ((H+4)·(W+4) + H·W)·CT floats (the wrapper picks CT and
// raises when one channel's planes do not fit). Grid: (C / CT, B); 256
// threads, the channel fastest; weights (25, C) and (49, C).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dw_chain2d_kernel(const float* __restrict__ x, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ w7,
                  const float* __restrict__ b7, float* __restrict__ y,
                  int H, int W, int C, int CT) {
  extern __shared__ float smem[];
  const int Hp = H + 4, Wp = W + 4;
  float* xin = smem;                 // [H+4][W+4][CT]
  float* mid = smem + Hp * Wp * CT;  // [H][W][CT]
  const int c0 = blockIdx.x * CT;
  const size_t img = (size_t)H * W * C;
  const float* xb = x + (size_t)blockIdx.y * img;
  float* yb = y + (size_t)blockIdx.y * img;

  for (int i = threadIdx.x; i < Hp * Wp * CT; i += kThreads) {
    const int c = i % CT;
    const int r = i / CT;
    const int xx = r % Wp - 2, yy = r / Wp - 2;
    xin[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? __ldg(xb + ((size_t)yy * W + xx) * C + c0 + c) : 0.f;
  }
  __syncthreads();
  const int plane = H * W * CT;
  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int c = i % CT;
    const int xy = i / CT;
    const int xx = xy % W, yy = xy / W;
    const float* wc = w5 + c0 + c;
    const float* xc = xin + (yy * Wp + xx) * CT + c;
    float acc = 0.f;
    for (int a = 0; a < 5; ++a) {
      const float* row = xc + a * Wp * CT;
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        acc = fmaf(__ldg(wc + (a * 5 + b) * C), row[b * CT], acc);
      }
    }
    mid[i] = acc + __ldg(b5 + c0 + c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int c = i % CT;
    const int xy = i / CT;
    const int xx = xy % W, yy = xy / W;
    // taps whose dilated position yy + 3k - 9 lies inside [0, H)
    const int ky_lo = max(0, (11 - yy) / 3), ky_hi = min(7, (H + 8 - yy) / 3 + 1);
    const int kx_lo = max(0, (11 - xx) / 3), kx_hi = min(7, (W + 8 - xx) / 3 + 1);
    const float* wc = w7 + c0 + c;
    const float* mc = mid + c;
    float acc = 0.f;
    for (int ky = ky_lo; ky < ky_hi; ++ky) {
      const int yi = yy + 3 * ky - 9;
      for (int kx = kx_lo; kx < kx_hi; ++kx) {
        const int xi = xx + 3 * kx - 9;
        acc = fmaf(__ldg(wc + (ky * 7 + kx) * C), mc[(yi * W + xi) * CT], acc);
      }
    }
    yb[(size_t)xy * C + c0 + c] = acc + __ldg(b7 + c0 + c);
  }
}

}  // namespace

extern "C" int dlka_dw_chain2d(const void* x, const void* w5, const void* b5,
                               const void* w7, const void* b7, void* y, int B,
                               int H, int W, int C, int CT, void* stream) {
  if (CT <= 0 || C % CT != 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(H + 4) * (W + 4) + (size_t)H * W) * CT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dw_chain2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(C / CT, B);
  dw_chain2d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w5, (const float*)b5, (const float*)w7,
      (const float*)b7, (float*)y, H, W, C, CT);
  return (int)cudaGetLastError();
}
