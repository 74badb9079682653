// Backward of the exact 3x3x3 deformable convolution of deform3d.cu (stride 1,
// pad 1, dilation 1, groups 1, D3D semantics, no clip of Δ) for Hopper. Given
// the cotangent g (B, D, H, W, Co) it computes
//   dx   (B, D, H, W, Ci) : col2im scatter of the 8 corner weights × dsamp_k,
//                           with f32 atomicAdd over channels-last rows, as the
//                           reference D3D backward does;
//   doff (B, D, H, W, 81) : Σ_c dsamp_k[c] · ∂sample_k[c]/∂Δ, 3 per tap, from
//                           the corner differences;
//   dw   (27, Ci, Co)     : Σ_p samp_k(p)ᵀ g(p), samp_k recomputed as the
//                           forward computes it, per-block partials added
//                           with atomicAdd;
// where dsamp_k = g · w_kᵀ. dx and dw must be zero on entry. The bias
// gradient (Σ g) is left to the caller.
//
// Gradient at integer offsets: the gather/D3D convention. Each sample is
// Σ_corners wt · x with z0 = floor(z) and weight (1 − dz) or dz, and floor
// has zero derivative, so at an integer coordinate the offset gradient is
// x(z0 + 1) − x(z0), the right derivative. The JAX package's window VJP
// gives 0 there instead (deformablelka_tpu/ops/deform3d.py:413-419); away
// from integers the two agree.
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/deform3d_bwd_kernel.py
// deform_conv3d_window_bwd_pallas (:182, pallas_call :221; _bwd_kernel :56,
// _overlap_add_axis :138), which handles |Δ| ≤ 1 and C ≤ 128 only and builds
// dx from per-tile padded canvases.
//
// What bounds it: 4·27·Ci·Co FLOP per voxel for the two channel mixes
// (dsamp and dw) plus the blends, against (Ci + 81 + Co)·4 bytes read and
// (Ci + 81)·4 written, so operations (f32 on the CUDA cores); dx's atomics
// and the corner gathers are served by L2.
// Design, simple first, two launches:
// 1. data: a block owns TP voxels and one tap (grid (tiles, 27)). It
//    tabulates the 8 corners of its samples (index, weight and the three
//    weight derivatives), then per chunk of TC input channels forms
//    dsamp = g · w_kᵀ in registers (g and w_k staged through shared memory a
//    TC-wide chunk of Co at a time), and one warp per voxel scatters the
//    chunk into dx and accumulates the offset gradient, reduced across the
//    warp at the end.
// 2. weight: a block owns one tap, a (TI × TO) tile of w_k and a run of
//    voxel tiles (grid (groups, 27, chunks)); per voxel tile it blends
//    samp_k into shared memory beside g's tile and accumulates the outer
//    products in registers (R × R a thread), then adds its partial to dw.
// No tensor cores yet (TF32 mma / wgmma and TMA are later work).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TP = 64;    // voxels per tile
constexpr int TC = 32;    // channel chunk of the data launch: one warp's lanes
constexpr int kTaps = 27;
constexpr int kWarps = kThreads / 32;

// The 8 corners of voxel `vox`'s sample for tap k, as deform3d.cu computes
// them: linear index (−1 outside the volume), trilinear weight and its
// derivatives along (z, y, x).
struct Corner {
  int idx;
  float wt, gz, gy, gx;
};

__device__ __forceinline__ Corner corner_of(const float* __restrict__ off,
                                            int vox, int n_vox, int k,
                                            int corner, int D, int H, int W) {
  Corner c{-1, 0.f, 0.f, 0.f, 0.f};
  if (vox >= n_vox) return c;
  const int kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
  const int xx = vox % W;
  const int yy = (vox / W) % H;
  const int zz = (vox / (W * H)) % D;
  const int b = vox / (W * H * D);
  const float* o = off + (size_t)vox * (3 * kTaps) + 3 * k;
  // the clamp keeps the int conversion defined; a sample clamped here has
  // all its corners outside the volume either way (value and gradient 0)
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
    c.idx = ((b * D + zi) * H + yi) * W + xi;
    c.wt = (wz * wy) * wx;
    c.gz = (oz ? 1.f : -1.f) * (wy * wx);
    c.gy = (oy ? 1.f : -1.f) * (wz * wx);
    c.gx = (ox ? 1.f : -1.f) * (wz * wy);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
deform_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ off,
                       const float* __restrict__ w, const float* __restrict__ g,
                       float* __restrict__ dx, float* __restrict__ doff, int B,
                       int D, int H, int W, int Ci, int Co) {
  constexpr int kColThreads = TC / 4;                // 4 input channels each
  constexpr int kRowThreads = kThreads / kColThreads;
  constexpr int RM = TP / kRowThreads;               // voxels per thread
  constexpr int kVoxPerWarp = TP / kWarps;           // scatter phase
  static_assert(RM * kRowThreads == TP, "tile");
  static_assert(TC == 32, "one lane per channel of a chunk");

  __shared__ int s_idx[TP][8];
  __shared__ float s_wt[TP][8];
  __shared__ float s_gz[TP][8];
  __shared__ float s_gy[TP][8];
  __shared__ float s_gx[TP][8];
  __shared__ float s_g[TC][TP + 1];                  // g chunk, [co][p]
  __shared__ __align__(16) float s_w[TC][TC + 4];    // w_k chunk, [co][ci]
  __shared__ float s_ds[TP][TC + 1];                 // dsamp chunk, [p][ci]

  const int n_vox = B * D * H * W;
  const int p0 = blockIdx.x * TP;
  const int k = blockIdx.y;
  const int tr = threadIdx.x / kColThreads;
  const int tc = threadIdx.x % kColThreads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < TP * 8; i += kThreads) {
    const int p = i / 8, corner = i % 8;
    const Corner c = corner_of(off, p0 + p, n_vox, k, corner, D, H, W);
    s_idx[p][corner] = c.idx;
    s_wt[p][corner] = c.wt;
    s_gz[p][corner] = c.gz;
    s_gy[p][corner] = c.gy;
    s_gx[p][corner] = c.gx;
  }

  float az[kVoxPerWarp], ay[kVoxPerWarp], ax[kVoxPerWarp];
#pragma unroll
  for (int j = 0; j < kVoxPerWarp; ++j) az[j] = ay[j] = ax[j] = 0.f;

  const float* wk = w + (size_t)k * Ci * Co;
  for (int ci0 = 0; ci0 < Ci; ci0 += TC) {
    // dsamp[p][ci0 + ci] = Σ_co g[p][co] · w_k[ci0 + ci][co]
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int co0 = 0; co0 < Co; co0 += TC) {
      __syncthreads();  // previous chunk's product and scatter are done
      for (int i = threadIdx.x; i < TP * TC; i += kThreads) {
        const int co = i % TC, p = i / TC;
        s_g[co][p] = (p0 + p < n_vox && co0 + co < Co)
                         ? __ldg(g + (size_t)(p0 + p) * Co + co0 + co) : 0.f;
      }
      for (int i = threadIdx.x; i < TC * TC; i += kThreads) {
        const int co = i % TC, ci = i / TC;
        s_w[co][ci] = (ci0 + ci < Ci && co0 + co < Co)
                          ? __ldg(wk + (size_t)(ci0 + ci) * Co + co0 + co) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int co = 0; co < TC; ++co) {
        const float4 bv = *reinterpret_cast<const float4*>(&s_w[co][tc * 4]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = s_g[co][tr * RM + r];
          acc[r][0] = fmaf(a, bv.x, acc[r][0]);
          acc[r][1] = fmaf(a, bv.y, acc[r][1]);
          acc[r][2] = fmaf(a, bv.z, acc[r][2]);
          acc[r][3] = fmaf(a, bv.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s_ds[tr * RM + r][tc * 4 + c] = acc[r][c];
    __syncthreads();

    // one warp per voxel, one lane per channel: dx scatter, offset gradient
    const int ci = ci0 + lane;
    if (ci < Ci) {
#pragma unroll
      for (int j = 0; j < kVoxPerWarp; ++j) {
        const int p = warp + kWarps * j;
        const float ds = s_ds[p][lane];
        float sz = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          const int idx = s_idx[p][corner];
          if (idx < 0) continue;
          const size_t at = (size_t)idx * Ci + ci;
          const float xv = __ldg(x + at);
          sz = fmaf(s_gz[p][corner], xv, sz);
          sy = fmaf(s_gy[p][corner], xv, sy);
          sx = fmaf(s_gx[p][corner], xv, sx);
          atomicAdd(dx + at, s_wt[p][corner] * ds);
        }
        az[j] = fmaf(ds, sz, az[j]);
        ay[j] = fmaf(ds, sy, ay[j]);
        ax[j] = fmaf(ds, sx, ax[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kVoxPerWarp; ++j) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      az[j] += __shfl_xor_sync(0xffffffffu, az[j], s);
      ay[j] += __shfl_xor_sync(0xffffffffu, ay[j], s);
      ax[j] += __shfl_xor_sync(0xffffffffu, ax[j], s);
    }
    const int vox = p0 + warp + kWarps * j;
    if (lane == 0 && vox < n_vox) {
      float* o = doff + (size_t)vox * (3 * kTaps) + 3 * k;
      o[0] = az[j];
      o[1] = ay[j];
      o[2] = ax[j];
    }
  }
}

// dw_k[ci][co] += Σ_p samp_k[p][ci] · g[p][co] over the voxel tiles
// [t0, t1) of this block; the tile of w_k is (16·R) × (16·R), R × R a thread.
template <int R>
__global__ void __launch_bounds__(kThreads)
deform_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ off,
                         const float* __restrict__ g, float* __restrict__ dw,
                         int B, int D, int H, int W, int Ci, int Co,
                         int tiles_per_block) {
  constexpr int TI = 16 * R, TO = 16 * R;

  __shared__ int s_idx[TP][8];
  __shared__ float s_wt[TP][8];
  __shared__ float s_samp[TP][TI];
  __shared__ float s_g[TP][TO];

  const int n_vox = B * D * H * W;
  const int n_tiles = (n_vox + TP - 1) / TP;
  const int k = blockIdx.y;
  const int n_co = (Co + TO - 1) / TO;
  const int ci0 = (blockIdx.z / n_co) * TI;
  const int co0 = (blockIdx.z % n_co) * TO;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  const int ti = threadIdx.x / 16;
  const int to = threadIdx.x % 16;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[a][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int p0 = t * TP;
    __syncthreads();  // the previous tile's product is done
    for (int i = threadIdx.x; i < TP * 8; i += kThreads) {
      const int p = i / 8, corner = i % 8;
      const Corner c = corner_of(off, p0 + p, n_vox, k, corner, D, H, W);
      s_idx[p][corner] = c.idx;
      s_wt[p][corner] = c.wt;
    }
    for (int i = threadIdx.x; i < TP * TO; i += kThreads) {
      const int co = i % TO, p = i / TO;
      s_g[p][co] = (p0 + p < n_vox && co0 + co < Co)
                       ? __ldg(g + (size_t)(p0 + p) * Co + co0 + co) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TP * TI; i += kThreads) {
      const int ci = i % TI, p = i / TI;
      float v = 0.f;
      if (ci0 + ci < Ci) {
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          const int idx = s_idx[p][corner];
          if (idx >= 0) v = fmaf(s_wt[p][corner], __ldg(x + (size_t)idx * Ci + ci0 + ci), v);
        }
      }
      s_samp[p][ci] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < TP; ++p) {
      float sa[R], gb[R];
#pragma unroll
      for (int a = 0; a < R; ++a) sa[a] = s_samp[p][ti * R + a];
#pragma unroll
      for (int c = 0; c < R; ++c) gb[c] = s_g[p][to * R + c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[a][c] = fmaf(sa[a], gb[c], acc[a][c]);
    }
  }

  float* dwk = dw + (size_t)k * Ci * Co;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int ci = ci0 + ti * R + a;
    if (ci >= Ci) continue;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int co = co0 + to * R + c;
      if (co < Co) atomicAdd(dwk + (size_t)ci * Co + co, acc[a][c]);
    }
  }
}

template <int R>
void launch_weight(const float* x, const float* off, const float* g, float* dw,
                   int B, int D, int H, int W, int Ci, int Co, cudaStream_t s) {
  constexpr int T = 16 * R;
  const int n_tiles = (B * D * H * W + TP - 1) / TP;
  const int chunks = ((Ci + T - 1) / T) * ((Co + T - 1) / T);
  // about 2048 blocks: enough to fill 132 SMs, few partials per weight
  const long long work = (long long)n_tiles * kTaps * chunks;
  const int per_block = (int)(work / 2048 > 1 ? work / 2048 : 1);
  dim3 grid((n_tiles + per_block - 1) / per_block, kTaps, chunks);
  deform_bwd_weight_kernel<R><<<grid, kThreads, 0, s>>>(x, off, g, dw, B, D, H, W,
                                                        Ci, Co, per_block);
}

}  // namespace

extern "C" int dlka_deform_conv3d_bwd(const void* x, const void* off, const void* w,
                                      const void* g, void* dx, void* doff, void* dw,
                                      int B, int D, int H, int W, int Ci, int Co,
                                      void* stream) {
  const int n_vox = B * D * H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n_vox + TP - 1) / TP, kTaps);
  deform_bwd_data_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)off, (const float*)w, (const float*)g,
      (float*)dx, (float*)doff, B, D, H, W, Ci, Co);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Ci <= 32 && Co <= 32) {
    launch_weight<2>((const float*)x, (const float*)off, (const float*)g, (float*)dw,
                     B, D, H, W, Ci, Co, s);
  } else {
    launch_weight<4>((const float*)x, (const float*)off, (const float*)g, (float*)dw,
                     B, D, H, W, Ci, Co, s);
  }
  return (int)cudaGetLastError();
}
