// Exact 3x3x3 deformable convolution for Hopper (stride 1, pad 1, dilation 1,
// groups 1), D3D semantics: every output voxel takes, per tap, a trilinear
// sample at p + tap - 1 + Δ, where each of the 8 corners is zero outside the
// volume; there is no clip of Δ. f32 in, out and accumulation;
// x (B, D, H, W, Ci), offsets (B, D, H, W, 81) with channel 3k + i = tap k,
// axis i in (d, h, w) order, w (27, Ci, Co), optional bias (Co),
// y (B, D, H, W, Co).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/deform3d_kernel.py
// deform_conv3d_pallas (:1008) → _forward_v3 (:774) and its kernel bodies
// v3…v5xw (:329-771), which clip Δ to ±R and leave larger offsets to a gather.
//
// What bounds it: 2·27·Ci·Co FLOP per voxel for the channel mix plus the
// blend, against (Ci + 81 + Co)·4 bytes, so operations (f32 on the CUDA
// cores). The gather of 8 corners × Ci per tap comes from L2, not from device
// memory: a voxel's corners are read again by its neighbours' taps.
// Design, simple first: a block owns TP output voxels × TCO output channels.
// Per tap it builds a table of the 8 corners (index and weight) of its TP
// samples, then for each chunk of TCI input channels blends the samples into
// shared memory, stages w_k's (TCI × TCO) chunk beside them, and accumulates
// the product in registers (RM × 4 outputs a thread). Tiling Ci and Co keeps
// shared memory at 20 KB for any width (a whole w_k at C = 256 is 256 KB).
// No tensor cores yet (TF32 mma / wgmma and TMA are later work).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TP = 64;    // output voxels per block
constexpr int TCI = 32;   // input channels per chunk
constexpr int kTaps = 27;

template <int TCO>
__global__ void __launch_bounds__(kThreads)
deform_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ y, int B, int D, int H, int W, int Ci,
                     int Co) {
  constexpr int kColThreads = TCO / 4;               // 4 output channels each
  constexpr int kRowThreads = kThreads / kColThreads;
  constexpr int RM = TP / kRowThreads;               // voxels per thread
  static_assert(RM * kRowThreads == TP, "tile");

  __shared__ int s_idx[TP][8];
  __shared__ float s_wt[TP][8];
  __shared__ float s_samp[TCI][TP + 1];
  __shared__ __align__(16) float s_w[TCI][TCO];

  const int n_vox = B * D * H * W;
  const int p0 = blockIdx.x * TP;
  const int co0 = blockIdx.y * TCO;
  const int tr = threadIdx.x / kColThreads;
  const int tc = threadIdx.x % kColThreads;

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    const int kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
    __syncthreads();  // the previous tap's GEMM is done with the tables
    for (int i = threadIdx.x; i < TP * 8; i += kThreads) {
      const int p = i / 8, corner = i % 8;
      const int vox = p0 + p;
      int idx = -1;
      float wt = 0.f;
      if (vox < n_vox) {
        const int xx = vox % W;
        const int yy = (vox / W) % H;
        const int zz = (vox / (W * H)) % D;
        const int b = vox / (W * H * D);
        const float* o = off + (size_t)vox * (3 * kTaps) + 3 * k;
        // clamping keeps the int conversion defined; a sample clamped here
        // has all its corners outside the volume either way
        const float zs = fminf(fmaxf((float)(zz - 1 + kz) + __ldg(o + 0), -2.f), (float)D + 1.f);
        const float ys = fminf(fmaxf((float)(yy - 1 + ky) + __ldg(o + 1), -2.f), (float)H + 1.f);
        const float xs = fminf(fmaxf((float)(xx - 1 + kx) + __ldg(o + 2), -2.f), (float)W + 1.f);
        const float z0 = floorf(zs), y0 = floorf(ys), x0 = floorf(xs);
        const float dz = zs - z0, dy = ys - y0, dx = xs - x0;
        const int oz = corner >> 2, oy = (corner >> 1) & 1, ox = corner & 1;
        const int zi = (int)z0 + oz, yi = (int)y0 + oy, xi = (int)x0 + ox;
        if (zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W) {
          const float wz = oz ? dz : 1.f - dz;
          const float wy = oy ? dy : 1.f - dy;
          const float wx = ox ? dx : 1.f - dx;
          wt = (wz * wy) * wx;
          idx = ((b * D + zi) * H + yi) * W + xi;
        }
      }
      s_idx[p][corner] = idx;
      s_wt[p][corner] = wt;
    }
    const float* wk = w + (size_t)k * Ci * Co;
    for (int ci0 = 0; ci0 < Ci; ci0 += TCI) {
      __syncthreads();  // corner table ready; previous chunk's GEMM done
      for (int i = threadIdx.x; i < TP * TCI; i += kThreads) {
        const int ci = i % TCI, p = i / TCI;
        float v = 0.f;
        if (ci0 + ci < Ci) {
#pragma unroll
          for (int corner = 0; corner < 8; ++corner) {
            const int idx = s_idx[p][corner];
            if (idx >= 0) v = fmaf(s_wt[p][corner], __ldg(x + (size_t)idx * Ci + ci0 + ci), v);
          }
        }
        s_samp[ci][p] = v;
      }
      for (int i = threadIdx.x; i < TCI * TCO; i += kThreads) {
        const int co = i % TCO, ci = i / TCO;
        s_w[ci][co] = (ci0 + ci < Ci && co0 + co < Co)
                          ? __ldg(wk + (size_t)(ci0 + ci) * Co + co0 + co) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int ci = 0; ci < TCI; ++ci) {
        const float4 bv = *reinterpret_cast<const float4*>(&s_w[ci][tc * 4]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = s_samp[ci][tr * RM + r];
          acc[r][0] = fmaf(a, bv.x, acc[r][0]);
          acc[r][1] = fmaf(a, bv.y, acc[r][1]);
          acc[r][2] = fmaf(a, bv.z, acc[r][2]);
          acc[r][3] = fmaf(a, bv.w, acc[r][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int vox = p0 + tr * RM + r;
    if (vox >= n_vox) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = co0 + tc * 4 + c;
      if (co < Co) y[(size_t)vox * Co + co] = acc[r][c] + (bias ? __ldg(bias + co) : 0.f);
    }
  }
}

}  // namespace

extern "C" int dlka_deform_conv3d(const void* x, const void* off, const void* w,
                                  const void* bias, void* y, int B, int D, int H,
                                  int W, int Ci, int Co, void* stream) {
  const int n_vox = B * D * H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Co <= 32) {
    dim3 grid((n_vox + TP - 1) / TP, (Co + 31) / 32);
    deform_conv3d_kernel<32><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)off, (const float*)w, (const float*)bias,
        (float*)y, B, D, H, W, Ci, Co);
  } else {
    dim3 grid((n_vox + TP - 1) / TP, (Co + 63) / 64);
    deform_conv3d_kernel<64><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)off, (const float*)w, (const float*)bias,
        (float*)y, B, D, H, W, Ci, Co);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dlka_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
