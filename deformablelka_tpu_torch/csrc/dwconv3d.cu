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
// the card's bound is the bytes (1.3 and 0.3 µs), and at these sizes the
// latency of the loads, the instructions around each tap, and the launch
// dominate. The first version read every tap from L1/L2 in one dependent
// chain per voxel, with per-voxel tap ranges on all three axes and 128
// blocks at 4³ (under one wave on 132 SMs): 24.8 device-µs per launch at
// 8³. This design:
//  - a block takes an output tile (TZ, TY, TX) of CT channels of one
//    volume and first stages the tile's input with its halo h = dil·(K/2)
//    into shared memory, channels-last ([z][y][x][CT]), with 16-byte
//    cp.async copies where C % 4 = 0 (CT·4 contiguous bytes per voxel,
//    coalesced), else 4-byte ones; the (K³, CT) weights go beside it by
//    4-byte cp.async (a synchronous load costs a latency per iteration).
//    The staging loop walks its voxels by carries, not by divisions per
//    voxel. Along z and y the halo is clipped to the volume; along x it is
//    zero-padded to TX rounded up to 4, plus 2h, the row pitch made odd.
//    Both site volumes fit whole per channel tile; the wrapper's plan
//    (ops/kernels.py dwconv3d_plan) cuts the volume into tiles until the
//    grid fills the card and two blocks fit an SM, so volumes of any size
//    stay exact;
//  - then each thread takes one channel and a strip of 4 outputs along x:
//    it loops over the taps inside the volume along z and y (ranges
//    computed once per strip) and over all K taps along x (the zero
//    padding stands in for the outside; unrolled for K = 3, 5, 7), one
//    weight load feeding 4 independent FMA chains. A warp holds 8 channels
//    × 4 neighbouring rows; the odd row pitch keeps its shared loads free
//    of bank conflicts. The compute stays latency-bound at 8³ (about 16
//    warps per SM, 2 strips per thread).
// Grid: (tiles, ceil(C / CT), B); 256 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;  // outputs along x per thread
constexpr int kSmemMax = 232448;

// asynchronous copies global → shared of 16 bytes (L2 only) or 4 bytes:
// no register holds the value, so a thread's loads do not wait on each other
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// staged extents: along z and y the tile and its halo clipped to the
// volume, along x the tile rounded up to the strip plus the halo, odd
__host__ __device__ inline int staged(int S, int T, int h) {
  return T + 2 * h < S ? T + 2 * h : S;
}
__host__ __device__ inline int staged_x(int TX, int h) {
  return ((TX + kStrip - 1) / kStrip * kStrip + 2 * h) | 1;
}

// KC: K as a compile-time constant (3, 5, 7: the x taps fully unrolled), or
// 0 for any odd K at run time
template <int VEC, int KC>
__global__ void __launch_bounds__(kThreads)
dwconv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int D,
                int H, int W, int C, int K_, int dil, int CT, int TZ, int TY,
                int TX) {
  extern __shared__ __align__(16) float smem[];
  const int K = KC > 0 ? KC : K_;
  const int m = K / 2, h = dil * m;
  const int ntx = (W + TX - 1) / TX, nty = (H + TY - 1) / TY;
  const int oz0 = blockIdx.x / (ntx * nty) * TZ;
  const int oy0 = blockIdx.x / ntx % nty * TY, ox0 = blockIdx.x % ntx * TX;
  const int sz0 = max(0, oz0 - h), sy0 = max(0, oy0 - h), sx0 = ox0 - h;
  const int SZ = min(D, oz0 + TZ + h) - sz0, SY = min(H, oy0 + TY + h) - sy0;
  const int SX = staged_x(TX, h);
  const int c0 = blockIdx.y * CT;
  const size_t V = (size_t)D * H * W;
  const float* xb = x + blockIdx.z * V * C;
  float* yb = y + blockIdx.z * V * C;
  float* xs = smem;  // [SZ][SY][SX][CT], x from ox0 - h
  float* ws = smem + CT * staged(D, TZ, h) * staged(H, TY, h) * SX;  // [K³][CT]

  // each thread stages one channel group of every `step`-th voxel, walking
  // (zi, yi, xi) by carries instead of dividing per voxel
  const int qn = CT / VEC;  // a power of two that divides kThreads
  const int cc = (threadIdx.x % qn) * VEC;
  const int step = kThreads / qn, dx = step % SX, dyz = step / SX;
  const int v0 = threadIdx.x / qn;
  int xi = v0 % SX, yi = v0 / SX % SY, zi = v0 / (SX * SY);
  while (zi < SZ) {
    const int gx = sx0 + xi;
    float* dst = xs + ((zi * SY + yi) * SX + xi) * CT + cc;
    const bool inside = gx >= 0 && gx < W && c0 + cc < C;
    const float* src =
        xb + (((size_t)(sz0 + zi) * H + sy0 + yi) * W + gx) * C + c0 + cc;
    if (!inside) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = 0.f;
    } else if constexpr (VEC == 4) {
      cp_async16(dst, src);
    } else {
      cp_async4(dst, src);
    }
    xi += dx;
    yi += dyz;
    if (xi >= SX) {
      xi -= SX;
      ++yi;
    }
    while (yi >= SY) {
      yi -= SY;
      ++zi;
    }
  }
  for (int i = threadIdx.x; i < K * K * K * CT; i += kThreads) {
    const int ch = c0 + i % CT;
    if (ch < C) {
      cp_async4(ws + i, w + (i / CT) * C + ch);
    } else {
      ws[i] = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int c = threadIdx.x % CT;
  if (c0 + c >= C) return;
  const float b = bias != nullptr ? __ldg(bias + c0 + c) : 0.f;
  const int OZ = min(D, oz0 + TZ) - oz0, OY = min(H, oy0 + TY) - oy0,
            OX = min(W, ox0 + TX) - ox0;
  const int nxs = (OX + kStrip - 1) / kStrip;
  for (int s = threadIdx.x / CT; s < OZ * OY * nxs; s += kThreads / CT) {
    const int yy = oy0 + s % OY, xl = s / OY % nxs * kStrip, z = oz0 + s / (OY * nxs);
    // along z and y, the taps k whose position p + (k - m)·dil lies in [0, S)
    const int kd_lo = max(0, m - z / dil), kd_hi = min(K, m + (D - 1 - z) / dil + 1);
    const int kh_lo = max(0, m - yy / dil), kh_hi = min(K, m + (H - 1 - yy) / dil + 1);
    float acc[kStrip] = {0.f, 0.f, 0.f, 0.f};
    for (int kd = kd_lo; kd < kd_hi; ++kd) {
      const int zi = z + (kd - m) * dil - sz0;
      for (int kh = kh_lo; kh < kh_hi; ++kh) {
        const int yi = yy + (kh - m) * dil - sy0;
        const float* xrow = xs + ((zi * SY + yi) * SX + xl) * CT + c;
        const float* wrow = ws + (kd * K + kh) * K * CT + c;
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float wv = wrow[kw * CT];
          const float* xp = xrow + kw * dil * CT;
#pragma unroll
          for (int j = 0; j < kStrip; ++j) acc[j] = fmaf(wv, xp[j * CT], acc[j]);
        }
      }
    }
    float* out = yb + (((size_t)z * H + yy) * W + ox0 + xl) * C + c0 + c;
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      if (xl + j < OX) out[(size_t)j * C] = acc[j] + b;
    }
  }
}

template <int VEC, int KC>
int launch(const float* x, const float* w, const float* bias, float* y,
           const int* p, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dwconv3d_kernel<VEC, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int B = p[0], D = p[1], H = p[2], W = p[3], C = p[4], K = p[5], dil = p[6],
            CT = p[7], TZ = p[8], TY = p[9], TX = p[10], smem = p[11];
  const int tiles = (D + TZ - 1) / TZ * ((H + TY - 1) / TY) * ((W + TX - 1) / TX);
  const dim3 grid(tiles, (C + CT - 1) / CT, B);
  dwconv3d_kernel<VEC, KC><<<grid, kThreads, smem, stream>>>(x, w, bias, y, D, H, W,
                                                            C, K, dil, CT, TZ, TY, TX);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_k(const float* x, const float* w, const float* bias, float* y,
             const int* p, cudaStream_t stream) {
  switch (p[5]) {
    case 3: return launch<VEC, 3>(x, w, bias, y, p, stream);
    case 5: return launch<VEC, 5>(x, w, bias, y, p, stream);
    case 7: return launch<VEC, 7>(x, w, bias, y, p, stream);
    default: return launch<VEC, 0>(x, w, bias, y, p, stream);
  }
}

}  // namespace

// args: the pointers x, w, bias (0: none), y and the stream handle; plan: B,
// D, H, W, C, K, dil, CT (channels per block, a power of two ≤ 32), TZ, TY,
// TX (the output tile), smem (the bytes the caller's plan computed, which
// must be this layout's); vec: 4 for 16-byte copies along C (CT % 4 = 0,
// C % 4 = 0, x 16-byte aligned), else 1. Two arrays and an int, so that the
// caller's foreign-function call converts three arguments, not eighteen.
extern "C" int dlka_dwconv3d(const unsigned long long* args, const int* plan, int vec) {
  const int D = plan[1], H = plan[2], C = plan[4], K = plan[5], dil = plan[6],
            CT = plan[7], TZ = plan[8], TY = plan[9], TX = plan[10], smem = plan[11];
  const int h = dil * (K / 2);
  if (K <= 0 || K % 2 == 0 || dil <= 0 || CT <= 0 || CT > 32 ||
      (CT & (CT - 1)) != 0 || TZ <= 0 || TY <= 0 || TX <= 0 ||
      (vec != 1 && vec != 4) || (vec == 4 && (CT % 4 != 0 || C % 4 != 0)) ||
      (size_t)smem != sizeof(float) * (size_t)CT *
                          ((size_t)K * K * K + (size_t)staged(D, TZ, h) *
                                                   staged(H, TY, h) * staged_x(TX, h)) ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* w = reinterpret_cast<const float*>(args[1]);
  const auto* bias = reinterpret_cast<const float*>(args[2]);
  auto* y = reinterpret_cast<float*>(args[3]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[4]);
  return vec == 4 ? launch_k<4>(x, w, bias, y, plan, stream)
                  : launch_k<1>(x, w, bias, y, plan, stream);
}
