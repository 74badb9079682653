// Backward of the exact depthwise 2D deformable convolution of deform2d_dw.cu
// (stride 1, dilation dil, padding (k/2)·dil, one offset group, no bias,
// torchvision semantics, no clip of Δ) for Hopper. Given the cotangent g
// (B, H, W, C) it computes
//   dx   (B, H, W, C)   : each sample's 4 corner weights × g · w_t, scattered;
//   doff (B, H, W, 2k²) : Σ_c g · w_t · ∂sample_t/∂(Δy, Δx), from the
//                         corner differences;
//   dw   (k², C)        : Σ_pixels g · sample_t;
// x (B, H, W, C), offsets (B, H, W, 2k²) with channel 2t = Δy and 2t + 1 =
// Δx of tap t (row-major), w (k², C). dx must be zero on entry, and doff
// too where the channels are cut into several parts.
//
// Gradient at integer offsets: the gather's. A sample is Σ_corners a · x
// with y0 = floor(y) and a row weight (1 − dy) or dy, and floor has zero
// derivative, so at an integer coordinate the offset gradient is x(y0 + 1)
// − x(y0), the right derivative (autograd of ops/deform2d.py, torchvision).
// The JAX package's window VJP gives 0 there
// (deformablelka_tpu/ops/deform2d.py:361-362); away from integers the two
// agree.
//
// Replaces the VJP of the TPU kernel
// deformablelka_tpu/ops/pallas/deform2d_kernel.py deform_dw_conv2d_pallas
// (_bwd :194-209), which delegates to the XLA window VJP _window2d_core_bwd
// (deformablelka_tpu/ops/deform2d.py:336): exact for |Δ| ≤ R only.
//
// What bounds it: per pixel, tap and channel the sample's blend and its two
// derivatives (3 × 7 FLOP), g · w_t (1), the dw product (2), the two offset
// dot products (4) and the 4 dx contributions (4): 32 FLOP against (2 + 2k²
// / C) · 4 bytes read and (1 + 2k² / C) · 4 written per pixel and channel:
// operations, f32 on the CUDA cores; the corner loads come from L1/L2 and
// the dx scatter is L2 atomics.
//
// Design, two kernels in one call, simple before fast:
// 1. data: a block owns a tile of `th` × `tw` = 32 pixels of one image and
//    a run of whole 32-channel chunks (all of C, or a part where the tiles
//    alone leave SMs idle). It builds the tile's corner table once (the
//    forward's 16-byte record per pixel and tap) and, per chunk, stages
//    the chunk's tap weights and the tile's g in shared memory. A thread
//    owns one tap and 4 channels (16-byte accesses where C % 4 = 0, else 1)
//    and walks the tile's pixels in order, so that its dw term is a
//    register sum in a fixed order, written to a per-tile partial; each
//    corner is loaded once and serves the sample, its two derivatives and
//    the dx scatter (16-byte global atomics on sm_90, valid corners only).
//    The offset gradient of a (pixel, tap) is reduced across the tap's
//    channel lanes by shuffles and summed over the chunks in shared
//    memory, then stored (or added with atomics where channel parts
//    share a pixel).
// 2. sum: dw = Σ over the tiles of the partials, in a fixed order, so that
//    dw does not change from run to run (dx and, with channel parts, doff
//    take their atomics in the order the blocks run).
// The corner table's construction is the forward's (deform2d_dw.cu), kept
// in both files so that each builds alone. Making it fast (x tiles around
// a tile's samples in shared memory, fewer atomics) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;   // channels a pass over the tile's pixels
constexpr int kSmemMax = 232448;
constexpr int kSumThreads = 256;
constexpr int kSumLanes = 32;  // dw elements a sum block, one per lane

struct Shape {
  int B, H, W, C, k, dil;
  int th, tw;             // the tile's rows and columns
  int tiles_y, tiles_x;
  int c_per_part;         // channels a block, a multiple of kChunk
  int atomic_doff;        // channel parts add into doff
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
deform_dw_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ off,
                          const float* __restrict__ w, const float* __restrict__ g,
                          float* __restrict__ dx, float* __restrict__ doff,
                          float* __restrict__ dw_part, const Shape S) {
  extern __shared__ __align__(16) float smem[];
  const int H = S.H, W = S.W, C = S.C, k = S.k;
  const int K = k * k;
  const int TP = S.th * S.tw;
  // the corner table, entry p·K + tap, as the forward's: the sample's first
  // corner (y0, x0) clamped into the image as a pixel index, bits 0-1
  // whether its second row and column differ from the first after the
  // clamp, bits 2-5 which of y0, y0 + 1, x0, x0 + 1 lie inside the image,
  // then dy and dx
  int4* s_tab = reinterpret_cast<int4*>(smem);            // [TP][K]
  float* s_w = reinterpret_cast<float*>(s_tab + TP * K);   // [K][32]: the chunk's weights
  float* s_g = s_w + K * kChunk;                           // [TP][32]: the chunk's g
  float* s_doff = s_g + TP * kChunk;                       // [TP][K][2]

  const int tile = blockIdx.x;
  int t = tile;
  const int tx = t % S.tiles_x; t /= S.tiles_x;
  const int ty = t % S.tiles_y;
  const int b = t / S.tiles_y;
  const int y0t = ty * S.th, x0t = tx * S.tw;
  const int pad = (k / 2) * S.dil;

  for (int i = threadIdx.x; i < TP * K; i += kThreads) {
    const int p = i / K, tap = i - p * K;
    const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
    int4 e = make_int4(0, 0, 0, 0);
    if (yy < H && xx < W) {
      const float* o = off + ((size_t)(b * H + yy) * W + xx) * (2 * K) + 2 * tap;
      // clamping keeps the int conversion defined; a sample clamped here
      // has all its corners outside the image either way
      const float ys = fminf(fmaxf((float)(yy - pad + (tap / k) * S.dil) + __ldg(o), -2.f),
                             (float)H + 1.f);
      const float xs = fminf(fmaxf((float)(xx - pad + (tap % k) * S.dil) + __ldg(o + 1), -2.f),
                             (float)W + 1.f);
      const float y0f = floorf(ys), x0f = floorf(xs);
      const int y0 = (int)y0f, x0 = (int)x0f;
      const int r0 = min(max(y0, 0), H - 1), r1 = min(max(y0 + 1, 0), H - 1);
      const int c0 = min(max(x0, 0), W - 1), c1 = min(max(x0 + 1, 0), W - 1);
      const int in = (y0 >= 0 && y0 < H) << 2 | (y0 + 1 >= 0 && y0 + 1 < H) << 3 |
                     (x0 >= 0 && x0 < W) << 4 | (x0 + 1 >= 0 && x0 + 1 < W) << 5;
      e = make_int4(r0 * W + c0, (r1 != r0) | (c1 != c0) << 1 | in,
                    __float_as_int(ys - y0f), __float_as_int(xs - x0f));
    }
    s_tab[i] = e;
  }
  for (int i = threadIdx.x; i < TP * K * 2; i += kThreads) s_doff[i] = 0.f;

  const float* xb = x + (size_t)b * H * W * C;
  float* dxb = dx + (size_t)b * H * W * C;
  const int c_begin = blockIdx.y * S.c_per_part;
  const int c_end = min(C, c_begin + S.c_per_part);
  constexpr int kLanes = kChunk / VEC;      // threads across a chunk's channels
  constexpr int kSlots = kThreads / kLanes; // taps in flight
  const int lane = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const int rounds = (K + kSlots - 1) / kSlots;

  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    __syncthreads();  // the table (first chunk) is built; the last chunk is done with s_w, s_g
    for (int i = threadIdx.x; i < K * kChunk; i += kThreads) {
      const int c = c0 + (i & (kChunk - 1));
      s_w[i] = c < c_end ? __ldg(w + (size_t)(i / kChunk) * C + c) : 0.f;
    }
    for (int i = threadIdx.x; i < TP * kChunk; i += kThreads) {
      const int p = i / kChunk, c = c0 + (i & (kChunk - 1));
      const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
      s_g[i] = (yy < H && xx < W && c < c_end)
                   ? __ldg(g + ((size_t)(b * H + yy) * W + xx) * C + c) : 0.f;
    }
    __syncthreads();
    const int cl = lane * VEC;         // the thread's channels within the chunk
    const int c = c0 + cl;
    const bool c_ok = c < c_end;       // C % 4 = 0 where VEC = 4: all VEC channels or none
    // every thread runs every round and pixel, so that the shuffles see
    // the whole warp; a tap past K (the last round) contributes nothing
    for (int r = 0; r < rounds; ++r) {
      const int tap = slot + r * kSlots;
      const bool active = tap < K;
      const int tp = active ? tap : 0;
      float wv[VEC], acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        wv[j] = active ? s_w[tp * kChunk + cl + j] : 0.f;
        acc[j] = 0.f;
      }
      for (int p = 0; p < TP; ++p) {
        const int4 e = active ? s_tab[p * K + tp] : make_int4(0, 0, 0, 0);
        const float dy = __int_as_float(e.z), dxf = __int_as_float(e.w);
        const float vy0 = (e.y & 4) ? 1.f : 0.f, vy1 = (e.y & 8) ? 1.f : 0.f;
        const float vx0 = (e.y & 16) ? 1.f : 0.f, vx1 = (e.y & 32) ? 1.f : 0.f;
        const int dr = (e.y & 1) ? W : 0, dc = (e.y >> 1) & 1;
        const int q[4] = {e.x, e.x + dc, e.x + dr, e.x + dr + dc};
        // corner weights a and their derivatives by dy and dx, zero for a
        // corner outside the image
        const float a[4] = {vy0 * (1.f - dy) * vx0 * (1.f - dxf), vy0 * (1.f - dy) * vx1 * dxf,
                            vy1 * dy * vx0 * (1.f - dxf), vy1 * dy * vx1 * dxf};
        const float ay[4] = {-vy0 * vx0 * (1.f - dxf), -vy0 * vx1 * dxf,
                             vy1 * vx0 * (1.f - dxf), vy1 * vx1 * dxf};
        const float ax[4] = {-vy0 * (1.f - dy) * vx0, vy0 * (1.f - dy) * vx1,
                             -vy1 * dy * vx0, vy1 * dy * vx1};
        const bool valid[4] = {(e.y & 20) == 20, (e.y & 36) == 36, (e.y & 24) == 24,
                               (e.y & 40) == 40};
        float gv[VEC], gw[VEC], s[VEC], sy[VEC], sx[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          gv[j] = s_g[p * kChunk + cl + j];
          gw[j] = gv[j] * wv[j];
          s[j] = sy[j] = sx[j] = 0.f;
        }
        if (c_ok) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float v[VEC];
            load_vec<VEC>(xb + (size_t)q[n] * C + c, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              s[j] = fmaf(a[n], v[j], s[j]);
              sy[j] = fmaf(ay[n], v[j], sy[j]);
              sx[j] = fmaf(ax[n], v[j], sx[j]);
            }
          }
        }
        float py = 0.f, px = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] = fmaf(gv[j], s[j], acc[j]);
          py = fmaf(gw[j], sy[j], py);
          px = fmaf(gw[j], sx[j], px);
        }
#pragma unroll
        for (int m = kLanes / 2; m > 0; m >>= 1) {  // over the tap's channel lanes
          py += __shfl_xor_sync(0xffffffffu, py, m);
          px += __shfl_xor_sync(0xffffffffu, px, m);
        }
        if (active && lane == 0) {
          s_doff[(p * K + tap) * 2] += py;
          s_doff[(p * K + tap) * 2 + 1] += px;
        }
        if (active && c_ok) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (!valid[n]) continue;
            float u[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) u[j] = a[n] * gw[j];
            add_vec<VEC>(dxb + (size_t)q[n] * C + c, u);
          }
        }
      }
      if (active && c_ok) {
        float* out = dw_part + ((size_t)tile * K + tap) * C + c;
#pragma unroll
        for (int j = 0; j < VEC; ++j) out[j] = acc[j];
      }
    }
  }
  __syncthreads();  // s_doff is complete
  for (int i = threadIdx.x; i < TP * K * 2; i += kThreads) {
    const int p = i / (2 * K), j = i - p * 2 * K;
    const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
    if (yy >= H || xx >= W) continue;
    float* o = doff + ((size_t)(b * H + yy) * W + xx) * (2 * K) + j;
    if (S.atomic_doff) {
      atomicAdd(o, s_doff[i]);
    } else {
      *o = s_doff[i];
    }
  }
}

// dw[e] = Σ_tile part[tile][e] over n_e = K·C elements: a block takes 32
// elements (one a lane) and its 8 warps take every 8th tile each; the
// warps' sums are added in warp order.
__global__ void __launch_bounds__(kSumThreads)
deform_dw_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int n_e,
                         int tiles) {
  __shared__ float s_sum[kSumThreads / kSumLanes][kSumLanes];
  const int lane = threadIdx.x % kSumLanes, warp = threadIdx.x / kSumLanes;
  const int e = blockIdx.x * kSumLanes + lane;
  float s = 0.f;
  if (e < n_e) {
    for (int t = warp; t < tiles; t += kSumThreads / kSumLanes) {
      s += __ldg(part + (size_t)t * n_e + e);
    }
  }
  s_sum[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < n_e) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kSumThreads / kSumLanes; ++i) total += s_sum[i][lane];
    dw[e] = total;
  }
}

template <int VEC>
int launch_data(const float* x, const float* off, const float* w, const float* g, float* dx,
                float* doff, float* part, const Shape& S, dim3 grid, int smem,
                cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_dw_bwd_data_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  deform_dw_bwd_data_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, off, w, g, dx, doff,
                                                                   part, S);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, off, w, g, dx, doff, dw, part (tiles × k² × C floats
// of scratch: each tile's dw terms) and the stream handle; plan: B, H, W, C,
// k, dil, th, tw (th · tw = 32 pixels a tile), the channels a block (a
// multiple of 32), smem (the bytes the caller's plan computed: k² · (th ·
// tw · 24 + 128) + th · tw · 128, the corner table, the chunk's weights,
// the tile's g and its offset gradient); vec: 4 for 16-byte accesses along
// C (C % 4 = 0; x, w, g and dx 16-byte aligned), else 1. Two launches.
extern "C" int dlka_deform_dw_conv2d_bwd(const unsigned long long* args, const int* plan,
                                         int vec) {
  Shape S;
  S.B = plan[0]; S.H = plan[1]; S.W = plan[2]; S.C = plan[3]; S.k = plan[4]; S.dil = plan[5];
  S.th = plan[6]; S.tw = plan[7];
  S.c_per_part = plan[8];
  const int smem = plan[9];
  const long long K = (long long)S.k * S.k, TP = (long long)S.th * S.tw;
  if (S.k <= 0 || S.k % 2 == 0 || S.dil < 1 || S.th < 1 || S.tw < 1 ||
      S.c_per_part < kChunk || S.c_per_part % kChunk != 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && S.C % 4 != 0) ||
      (long long)smem != K * (TP * 24 + kChunk * 4) + TP * kChunk * 4 || smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  S.tiles_y = (S.H + S.th - 1) / S.th;
  S.tiles_x = (S.W + S.tw - 1) / S.tw;
  const int parts = (S.C + S.c_per_part - 1) / S.c_per_part;
  S.atomic_doff = parts > 1;
  const int tiles = S.B * S.tiles_y * S.tiles_x;
  const dim3 grid(tiles, parts);
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* off = reinterpret_cast<const float*>(args[1]);
  const auto* w = reinterpret_cast<const float*>(args[2]);
  const auto* g = reinterpret_cast<const float*>(args[3]);
  auto* dx = reinterpret_cast<float*>(args[4]);
  auto* doff = reinterpret_cast<float*>(args[5]);
  auto* dw = reinterpret_cast<float*>(args[6]);
  auto* part = reinterpret_cast<float*>(args[7]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[8]);
  int err = vec == 4 ? launch_data<4>(x, off, w, g, dx, doff, part, S, grid, smem, stream)
                     : launch_data<1>(x, off, w, g, dx, doff, part, S, grid, smem, stream);
  if (err) return err;
  const int n_e = (int)(K * S.C);
  deform_dw_bwd_sum_kernel<<<(n_e + kSumLanes - 1) / kSumLanes, kSumThreads, 0, stream>>>(
      part, dw, n_e, tiles);
  return (int)cudaGetLastError();
}
