// Fused LKA chain for Hopper: dw5³ (pad 2) + b5, zero outside the volume,
// then dw7³ dilation 3 (pad 9) + b7, in one launch. f32 in, out and
// accumulation; channels-last (B, D, H, W, C).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/lka_fused_kernel.py
// dw_chain3d_fused (:240) → _dw_chain3d (:153) → _chain3d_kernel (:76).
//
// What bounds it: 936 FLOP per voxel-channel against 8 bytes moved, so it is
// bound by operations (f32 on the CUDA cores), and the real risk is
// recomputing dw5 for the 9-voxel halo of the dilated stage. The design
// removes that recompute along z and in-plane:
//  - a dilation-3 stage reads only intermediate planes of the output's own
//    z phase (z mod 3), so one block takes one phase and walks z in steps of
//    3, keeping the 7 planes it needs in a ring in shared memory: each
//    intermediate plane is computed once;
//  - a block holds whole H×W planes for a slice of CT channels, so no in-plane
//    halo is recomputed (outside the volume the intermediate is zero and is
//    skipped, `lka_fused_kernel.py:96-104`);
//  - for each intermediate plane the block stages the 5 input planes it
//    reads, with a zero halo of 2, in shared memory: each input value is
//    read from device memory once per plane instead of 125 times through
//    L1/L2, and the dw5 taps need no bounds checks.
// Shared memory: 7·H·W·CT ring + 5·(H+4)·(W+4)·CT input floats (the wrapper
// picks CT). Grid: (3 z phases, C / CT, B); 256 threads; weights (125, C)
// and (343, C).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 7;

__global__ void __launch_bounds__(kThreads)
dw_chain3d_kernel(const float* __restrict__ x, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ w7,
                  const float* __restrict__ b7, float* __restrict__ y,
                  int D, int H, int W, int C, int CT) {
  extern __shared__ float smem[];
  float* ring = smem;                          // [kRing][H][W][CT]
  float* xin = smem + kRing * H * W * CT;      // [5][H+4][W+4][CT]
  const int rz = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const size_t vol = (size_t)D * H * W * C;
  const float* xb = x + (size_t)blockIdx.z * vol;
  float* yb = y + (size_t)blockIdx.z * vol;
  const int plane = H * W * CT;

  int next_m = 0;  // next intermediate plane z' = rz + 3·m to compute
  for (int n = 0; rz + 3 * n < D; ++n) {
    const int zo = rz + 3 * n;
    // Output n reads planes m = n-3 .. n+3; plane n+3 takes the slot of n-4,
    // which output n-1 read last.
    __syncthreads();
    for (; next_m <= n + 3 && rz + 3 * next_m < D; ++next_m) {
      const int zi = rz + 3 * next_m;
      float* slot = ring + (next_m % kRing) * plane;
      const int Hp = H + 4, Wp = W + 4;
      const int in_plane = Hp * Wp * CT;
      __syncthreads();  // the previous plane's dw5 is done with xin
      for (int i = threadIdx.x; i < 5 * in_plane; i += kThreads) {
        const int c = i % CT;
        const int r = i / CT;
        const int xx = r % Wp - 2, yy = (r / Wp) % Hp - 2, z = zi + r / (Wp * Hp) - 2;
        xin[i] = (z >= 0 && z < D && yy >= 0 && yy < H && xx >= 0 && xx < W)
                     ? __ldg(xb + (((size_t)z * H + yy) * W + xx) * C + c0 + c) : 0.f;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < plane; i += kThreads) {
        const int c = i % CT;
        const int xy = i / CT;
        const int xx = xy % W, yy = xy / W;
        const float* wc = w5 + c0 + c;
        const float* xc = xin + (yy * Wp + xx) * CT + c;
        float acc = 0.f;
        for (int a = 0; a < 5; ++a) {
          for (int b = 0; b < 5; ++b) {
            const float* row = xc + ((a * Hp + b) * Wp) * CT;
#pragma unroll
            for (int e = 0; e < 5; ++e) {
              acc = fmaf(__ldg(wc + ((a * 5 + b) * 5 + e) * C), row[e * CT], acc);
            }
          }
        }
        slot[i] = acc + __ldg(b5 + c0 + c);
      }
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
      float acc = 0.f;
      for (int kz = 0; kz < 7; ++kz) {
        const int m = n + kz - 3;
        if (m < 0 || rz + 3 * m >= D) continue;
        const float* slot = ring + (m % kRing) * plane + c;
        for (int ky = ky_lo; ky < ky_hi; ++ky) {
          const int yi = yy + 3 * ky - 9;
          for (int kx = kx_lo; kx < kx_hi; ++kx) {
            const int xi = xx + 3 * kx - 9;
            acc = fmaf(__ldg(wc + ((kz * 7 + ky) * 7 + kx) * C),
                       slot[(yi * W + xi) * CT], acc);
          }
        }
      }
      yb[((size_t)(zo * H + yy) * W + xx) * C + c0 + c] = acc + __ldg(b7 + c0 + c);
    }
  }
}

}  // namespace

extern "C" int dlka_dw_chain3d(const void* x, const void* w5, const void* b5,
                               const void* w7, const void* b7, void* y, int B,
                               int D, int H, int W, int C, int CT,
                               void* stream) {
  if (CT <= 0 || C % CT != 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kRing * H * W + (size_t)5 * (H + 4) * (W + 4)) * CT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dw_chain3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(3, C / CT, B);
  dw_chain3d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w5, (const float*)b5, (const float*)w7,
      (const float*)b7, (float*)y, D, H, W, C, CT);
  return (int)cudaGetLastError();
}
