// Exact depthwise 2D deformable convolution for Hopper (stride 1, dilation
// dil, padding (k/2)·dil, one offset group, no bias), torchvision
// semantics: every output pixel takes, per tap (i, j), a bilinear sample of
// its own channel at (y − p + i·dil + Δy, x − p + j·dil + Δx), where each of
// the 4 corners is zero outside the image; there is no clip of Δ. f32 in,
// out and accumulation; x (B, H, W, C), offsets (B, H, W, 2k²) with channel
// 2t = Δy and 2t + 1 = Δx of tap t (row-major), w (k², C), y (B, H, W, C).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/deform2d_kernel.py
// deform_dw_conv2d_pallas (:182) → _forward (:109) → _kernel (:44), which
// clips Δ to ±R inside a dense window and sits behind the `hybrid` lax.cond
// on max|Δ| (ops/__init__.py:100-171).
//
// What bounds it: per output value 4 corner loads and ~10 FLOP a tap
// against 4·(2 + 2k²/C) bytes of device memory, so operations at the
// decoder's widths (f32 on the CUDA cores); the corner loads come from
// L1/L2, since neighbouring pixels' taps share corners.
// Design, simple first: a block owns TP pixels × CT channels. The offset
// group is one, so all channels share a (pixel, tap)'s 4 corners: the
// block tabulates each (pixel, tap)'s corner indices and weights once in
// shared memory, with the chunk's k² tap weights beside them. Then each
// thread takes (pixel, channel) outputs with the channel fastest, so a
// warp's 32 corner loads are one 128-byte line, and sums the taps'
// bilinear blends times w[tap, c] in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TP = 16;  // pixels per block
constexpr int CT = 32;  // channels per block

__global__ void __launch_bounds__(kThreads)
deform_dw_conv2d_kernel(const float* __restrict__ x, const float* __restrict__ off,
                        const float* __restrict__ w, float* __restrict__ y,
                        int B, int H, int W, int C, int k, int dil) {
  extern __shared__ __align__(16) float smem[];
  const int K = k * k;
  float* s_w = smem;                                       // [K][CT]
  float4* s_wt = reinterpret_cast<float4*>(smem + K * CT);  // [TP][K]
  int4* s_idx = reinterpret_cast<int4*>(s_wt + TP * K);     // [TP][K]
  const int n_pix = B * H * W;
  const int p0 = blockIdx.x * TP;
  const int c0 = blockIdx.y * CT;
  const int pad = (k / 2) * dil;

  for (int i = threadIdx.x; i < K * CT; i += kThreads) {
    const int c = c0 + i % CT;
    s_w[i] = c < C ? __ldg(w + (i / CT) * C + c) : 0.f;
  }
  for (int i = threadIdx.x; i < TP * K; i += kThreads) {
    const int p = i / K, t = i % K;
    const int pix = p0 + p;
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    int idx[4] = {0, 0, 0, 0};
    if (pix < n_pix) {
      const int xx = pix % W, yy = (pix / W) % H;
      const float* o = off + (size_t)pix * (2 * K) + 2 * t;
      // clamping keeps the int conversion defined; a sample clamped here
      // has all its corners outside the image either way
      const float ys = fminf(fmaxf((float)(yy - pad + (t / k) * dil) + __ldg(o), -2.f),
                             (float)H + 1.f);
      const float xs = fminf(fmaxf((float)(xx - pad + (t % k) * dil) + __ldg(o + 1), -2.f),
                             (float)W + 1.f);
      const float y0f = floorf(ys), x0f = floorf(xs);
      const float dy = ys - y0f, dx = xs - x0f;
      const int y0 = (int)y0f, x0 = (int)x0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oy = j >> 1, ox = j & 1;
        const int yi = y0 + oy, xi = x0 + ox;
        if (yi >= 0 && yi < H && xi >= 0 && xi < W) {
          wt[j] = (oy ? dy : 1.f - dy) * (ox ? dx : 1.f - dx);
          idx[j] = yi * W + xi;
        }
      }
    }
    s_wt[i] = make_float4(wt[0], wt[1], wt[2], wt[3]);
    s_idx[i] = make_int4(idx[0], idx[1], idx[2], idx[3]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TP * CT; i += kThreads) {
    const int p = i / CT, cl = i % CT;
    const int pix = p0 + p, c = c0 + cl;
    if (pix >= n_pix || c >= C) continue;
    const float* xb = x + (size_t)(pix / (H * W)) * H * W * C + c;
    const float4* wt = s_wt + p * K;
    const int4* id = s_idx + p * K;
    float acc = 0.f;
    for (int t = 0; t < K; ++t) {
      const float4 a = wt[t];
      const int4 q = id[t];
      float s = a.x * __ldg(xb + (size_t)q.x * C);
      s = fmaf(a.y, __ldg(xb + (size_t)q.y * C), s);
      s = fmaf(a.z, __ldg(xb + (size_t)q.z * C), s);
      s = fmaf(a.w, __ldg(xb + (size_t)q.w * C), s);
      acc = fmaf(s_w[t * CT + cl], s, acc);
    }
    y[(size_t)pix * C + c] = acc;
  }
}

}  // namespace

extern "C" int dlka_deform_dw_conv2d(const void* x, const void* off, const void* w,
                                     void* y, int B, int H, int W, int C, int k,
                                     int dil, void* stream) {
  if (k <= 0 || k % 2 == 0 || dil < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * k * (CT * sizeof(float) + TP * (sizeof(float4) + sizeof(int4)));
  cudaError_t err = cudaFuncSetAttribute(
      deform_dw_conv2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B * H * W + TP - 1) / TP, (C + CT - 1) / CT);
  deform_dw_conv2d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)off, (const float*)w, (float*)y, B, H, W, C, k, dil);
  return (int)cudaGetLastError();
}
