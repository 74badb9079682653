// Backward of the exact depthwise 2D deformable convolution of deform2d_dw.cu
// (stride 1, dilation dil, padding (k/2)·dil, one offset group, no bias,
// torchvision semantics, no clip of Δ) for Hopper. Given the cotangent g
// (B, H, W, C) it computes
//   dx   (B, H, W, C)   : each sample's 4 corner weights × g · w_t, scattered;
//   doff (B, H, W, 2k²) : Σ_c g · w_t · ∂sample_t/∂(Δy, Δx), from the
//                         corner differences;
//   dw   (k², C)        : Σ_pixels g · sample_t;
// x (B, H, W, C), offsets (B, H, W, 2k²) with channel 2t = Δy and 2t + 1 =
// Δx of tap t (row-major), w (k², C). dx and doff must be zero on entry.
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
// What bounds it: per pixel, tap and channel the sample and its two
// derivatives from the 4 corners (8 FLOP in the form below), g · w_t (1),
// the dw product (1), the two offset dot products (2) and the 4 dx
// contributions (6), against (2 + 2k² / C) · 4 bytes read and (1 + 2k² / C)
// · 4 written per pixel and channel: operations, f32 on the CUDA cores. In
// practice the dx scatter sets the pace, up to 4 additions per pixel, tap
// and channel, as 16-byte L2 reductions (red.global.add.v4.f32) of 4
// channels. Measured on the H100 (kernel_ablation.py, atomic_rates.py;
// PERF.md):
//  - without the dx reductions the 56² × 96, k7 dil 3 site at B = 24 runs
//    in 1.03 of 1.37 ms (offsets in ±2.5, a quarter of them integers), and
//    in 1.03 of 1.72 ms at a training step's small, non-integer offsets,
//    where the reductions of neighbouring samples land on the same lines;
//  - a dx window in shared memory, added to dx once per position, ran
//    1.4-4× slower: a shared-memory f32 atomicAdd is a compare-and-swap
//    loop on sm_90a (ATOMS.CAST.SPIN, 0.13 SM-clocks a float at best;
//    64- and 128-bit CAS loops cost the same per float; shared memory has
//    no vector `red`), and its window of the tile ±
//    (pad + margin) holds 15 positions a pixel at k7 dil 3, too many
//    channels' worth to keep two blocks on an SM;
//  - x staged in such a window (cp.async) changed the time by under 2 %,
//    and lost where its shared memory cost occupancy.
// So the kernel keeps neither window: corners come through L1 and dx
// takes one 128-byte L2 reduction per item, corner and 32 channels.
//
// Design (the first design and its ablation are in PERF.md):
//  - A block owns a tile of `th` × `tw` pixels of one image and one chunk of
//    32 · nq channels (nq = 1 … 3 channel quads a lane: C = 96 is one chunk,
//    so each corner-table entry serves up to 96 channels). It stages with
//    asynchronous copies the tile's offsets (all taps), g and the chunk's
//    tap weights.
//  - Warps: `splits` per tap row (k · splits warps, up to 768 threads); a
//    warp takes one tap row and its share of the tile's pixels, its k taps
//    in turn: no idle lanes at any k. Per tap it builds its corner table
//    (a 16-byte entry a pixel, from the staged offsets): corner 0's offset
//    in the image, which corners lie in the image and which add to dx
//    (none of zero weight: an integer Δ), the pixel, dy and dx; an entry
//    with no corner in the image adds nothing anywhere.
//  - An item is (pixel, tap) × the chunk: 8 lanes, each one channel quad of
//    every 32 channels (16-byte loads and reductions: a whole 128-byte line
//    per item and corner), 4 items a warp step. The lane forms the sample
//    and its two derivatives from the 4 corners, adds g · s to its dw
//    registers, sums the offset gradient over its channels (then over the
//    item's 8 lanes by shuffles; stored, or added with red.v2 where several
//    chunks share the pixel) and reduces each corner's share of g · w_t
//    into dx. Exact for any Δ: nothing depends on its size.
//  - dw: a register sum per tap over the warp's pixels in a fixed order,
//    then over its 4 pixel slots by shuffles, the warps' parts added in a
//    fixed order into the block's partial (one per tile, tap and channel);
//    a second kernel sums the partials in a fixed order, so dw does not
//    change from run to run. dx and doff take their additions in the order
//    the blocks run.

#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                   // lanes an item: a channel quad each per 32 channels
constexpr int kSlots = 32 / kLanes;         // items a warp step
constexpr int kMaxQuads = 3;                // channel quads a lane: a block takes 32 … 96 channels
constexpr int kSmemMax = 232448;
constexpr int kMaxThreads = 768;
constexpr int kSumThreads = 256;
constexpr int kSumLanes = 32;               // dw elements a sum block, one per lane
// a corner-table entry's flags: bits 0-3 which corners lie inside the image,
// bits 4-7 which of them add to dx (inside and of nonzero weight), bit 8
// whether the sample has a corner in the image at all; the pixel above them
constexpr int kLive = 1 << 8;
constexpr int kPixelShift = 16;

struct Shape {
  int B, H, W, C, k, dil;
  int th, tw;
  int splits;              // warps a tap row, each over ⌈th · tw / splits⌉ pixels
  int nq;                  // channel quads a lane: the block's chunk is 32 · nq channels
  int tiles_y, tiles_x;
  int atomic_doff;         // channel chunks add into doff
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 channels from device memory, 0 past `n`
template <int VEC>
__device__ __forceinline__ float4 ldg4(const float* src, int n) {
  if constexpr (VEC == 4) {
    return __ldg(reinterpret_cast<const float4*>(src));
  } else {
    return make_float4(n > 0 ? __ldg(src) : 0.f, n > 1 ? __ldg(src + 1) : 0.f,
                       n > 2 ? __ldg(src + 2) : 0.f, n > 3 ? __ldg(src + 3) : 0.f);
  }
}

// dst[0..3] += v in device memory where p: for VEC = 4 one predicated
// 16-byte reduction, else one atomicAdd a channel below `n`
template <int VEC>
__device__ __forceinline__ void red4_if(bool p, float* dst, float4 v, int n) {
  if constexpr (VEC == 4) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
        "@q red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n\t}" ::"l"(dst),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"((int)p)
        : "memory");
  } else if (p) {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) atomicAdd(dst + j, a[j]);
    }
  }
}

// an asynchronous copy of `BYTES` (4 or 16) from device to shared memory,
// zeros where `valid` is false (then nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
deform_dw_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ off,
                          const float* __restrict__ w, const float* __restrict__ g,
                          float* __restrict__ dx, float* __restrict__ doff,
                          float* __restrict__ dw_part, const Shape S) {
  extern __shared__ __align__(16) float smem[];
  const int H = S.H, W = S.W, C = S.C, k = S.k;
  const int K = k * k;
  const int TP = S.th * S.tw;
  const int TPW = (TP + S.splits - 1) / S.splits;            // pixels a warp (the last fewer)
  const int TPS = (TPW + kSlots - 1) / kSlots * kSlots;      // its item slots
  const int NW = k * S.splits;                               // warps
  const int nq = S.nq, CH = 32 * nq, CQ = 8 * nq;            // the chunk's channels, quads
  float* s_w = smem;                                         // [K][CH]: the chunk's weights
  float* s_g = s_w + K * CH;                                 // [TP][CH]: the tile's g
  float* s_dwp = s_g + TP * CH;                              // [splits][K][CH]: dw parts
  int4* s_tab = reinterpret_cast<int4*>(s_dwp + S.splits * K * CH);  // [NW][TPS]: corner tables
  float* s_off = reinterpret_cast<float*>(s_tab + NW * TPS); // [TP][2K]: the tile's offsets
  int* s_pix = reinterpret_cast<int*>(s_off + TP * 2 * K);   // [TP]: the pixel, or -1
  int* s_pyx = s_pix + TP;                                   // [TP]: its row << 16 | column

  const int nthreads = blockDim.x;
  const int tile = blockIdx.x;
  int t_ = tile;
  const int tx = t_ % S.tiles_x; t_ /= S.tiles_x;
  const int ty = t_ % S.tiles_y;
  const int b = t_ / S.tiles_y;
  const int y0t = ty * S.th, x0t = tx * S.tw;
  const int pad = (k / 2) * S.dil;
  const int c0 = blockIdx.y * CH;
  const float* xb = x + (size_t)b * H * W * C + c0;
  float* dxb = dx + (size_t)b * H * W * C + c0;

  // staged with asynchronous copies, zero outside the image and past C:
  // the tile's offsets, the chunk's tap weights and the tile's g (16-byte
  // copies of a channel quad where VEC = 4)
  for (int p = threadIdx.x; p < TP; p += nthreads) {
    const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
    s_pix[p] = (yy < H && xx < W) ? (b * H + yy) * W + xx : -1;
    s_pyx[p] = yy << 16 | xx;
  }
  for (int i = threadIdx.x; i < TP * 2 * K; i += nthreads) {
    const int p = i / (2 * K);
    const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
    const bool ok = yy < H && xx < W;
    cp_async<4>(s_off + i, ok ? off + ((size_t)(b * H + yy) * W + xx) * (2 * K) + (i - p * 2 * K)
                              : off, ok);
  }
  for (int i = threadIdx.x; i < K * CH; i += nthreads) {
    const int c = c0 + i % CH;
    cp_async<4>(s_w + i, c < C ? w + (size_t)(i / CH) * C + c : w, c < C);
  }
  for (int i = threadIdx.x; i < TP * CQ; i += nthreads) {
    const int p = i / CQ, c = (i % CQ) * 4;
    const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
    const bool ok = yy < H && xx < W && c0 + c < C;
    const float* src = ok ? g + ((size_t)(b * H + yy) * W + xx) * C + c0 + c : g;
    if constexpr (VEC == 4) {
      cp_async<16>(s_g + i * 4, src, ok);
    } else {
      *reinterpret_cast<float4*>(s_g + i * 4) =
          ok ? ldg4<VEC>(src, C - c0 - c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp / S.splits, split = warp % S.splits;  // the warp's tap row and pixels
  const int p_begin = split * TPW;
  const int slot = lane / kLanes, quad = lane % kLanes;
  int4* w_tab = s_tab + warp * TPS;
  const int step[4] = {0, C, W * C, (W + 1) * C};  // from corner 0 to corner n, in x and dx
  for (int jj = 0; jj < k; ++jj) {
    const int tap = row * k + jj;
    // the warp's corner table for this tap, an entry an item slot: corner
    // 0's offset in the image ((y0 · W + x0) · C; y0, x0 may be -1), the
    // flags and the pixel in the tile, dy and dx. An entry with no corner
    // in the image is all zero: no flags, pixel 0.
    __syncwarp();  // the last tap's table is read
    for (int i = lane; i < TPS; i += 32) {
      const int p = p_begin + i;
      int4 e = make_int4(0, 0, 0, 0);
      if (i < TPW && p < TP && s_pix[p] >= 0) {
        const float* o = s_off + p * 2 * K + 2 * tap;
        const int yx = s_pyx[p];
        // clamping keeps the int conversion defined; a sample clamped here
        // has all its corners outside the image either way
        const float ys = fminf(fmaxf((float)((yx >> 16) - pad + row * S.dil) + o[0], -2.f),
                               (float)H + 1.f);
        const float xs = fminf(fmaxf((float)((yx & 0xffff) - pad + jj * S.dil) + o[1], -2.f),
                               (float)W + 1.f);
        const float y0f = floorf(ys), x0f = floorf(xs);
        const int y0 = (int)y0f, x0 = (int)x0f;
        if (y0 >= -1 && y0 < H && x0 >= -1 && x0 < W) {
          const float fy = ys - y0f, fx = xs - x0f;
          const bool vy0 = y0 >= 0, vy1 = y0 + 1 < H, vx0 = x0 >= 0, vx1 = x0 + 1 < W;
          const int ok = (vy0 && vx0) | (vy0 && vx1) << 1 | (vy1 && vx0) << 2 | (vy1 && vx1) << 3;
          const int add = ok & (1 | (fx != 0.f ? 2 : 0) | (fy != 0.f ? 4 : 0) |
                                (fx != 0.f && fy != 0.f ? 8 : 0));
          e = make_int4((y0 * W + x0) * C, ok | add << 4 | kLive | p << kPixelShift,
                        __float_as_int(fy), __float_as_int(fx));
        }
      }
      w_tab[i] = e;
    }
    __syncwarp();
    float4 wv[kMaxQuads], acc[kMaxQuads];
#pragma unroll
    for (int h = 0; h < kMaxQuads; ++h) {
      wv[h] = h < nq ? ld4(s_w + tap * CH + h * 32 + quad * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // every lane runs every step (the shuffles take the whole warp); an
    // entry with no corner in the image runs with zero g and adds nothing
    for (int i0 = 0; i0 < TPW; i0 += kSlots) {
      const int4 e = w_tab[i0 + slot];
      const int flags = e.y, p = e.y >> kPixelShift;
      const bool live = flags & kLive;
      const float fy = __int_as_float(e.z), fx = __int_as_float(e.w);
      const float* xq = xb + e.x + quad * 4;   // corner 0 of the lane's first quad
      float* dq = dxb + e.x + quad * 4;
      float py[kMaxQuads] = {0.f, 0.f, 0.f}, px[kMaxQuads] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < kMaxQuads; ++h) {
        if (h >= nq) break;  // the same for the whole block
        const int cl = h * 32 + quad * 4;  // the lane's channels within the chunk
        const int n_c = C - c0 - cl;       // of them, those below C
        float4 v[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          v[n] = (flags >> n & 1) && n_c > 0 ? ldg4<VEC>(xq + step[n] + h * 32, n_c)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4 gv = ld4(s_g + p * CH + cl);
        if (!live) gv = make_float4(0.f, 0.f, 0.f, 0.f);
        const float a00[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
        const float a01[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
        const float a10[4] = {v[2].x, v[2].y, v[2].z, v[2].w};
        const float a11[4] = {v[3].x, v[3].y, v[3].z, v[3].w};
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
        const float wa[4] = {wv[h].x, wv[h].y, wv[h].z, wv[h].w};
        float sa[4], d0[4], d1[4], d2[4], d3[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the sample s and its derivatives by dy and dx
          const float e01 = a01[j] - a00[j], e23 = a11[j] - a10[j];
          const float top = fmaf(fx, e01, a00[j]), bot = fmaf(fx, e23, a10[j]);
          const float sy = bot - top;
          sa[j] = fmaf(fy, sy, top);
          const float sx = fmaf(fy, e23 - e01, e01);
          const float gw = ga[j] * wa[j];
          py[h] = fmaf(gw, sy, py[h]);
          px[h] = fmaf(gw, sx, px[h]);
          // the corners' shares of g · w_t
          const float u1 = gw * fy, u0 = gw - u1;
          d1[j] = u0 * fx;
          d0[j] = u0 - d1[j];
          d3[j] = u1 * fx;
          d2[j] = u1 - d3[j];
        }
        acc[h].x = fmaf(ga[0], sa[0], acc[h].x);
        acc[h].y = fmaf(ga[1], sa[1], acc[h].y);
        acc[h].z = fmaf(ga[2], sa[2], acc[h].z);
        acc[h].w = fmaf(ga[3], sa[3], acc[h].w);
        const float4 dv[4] = {make_float4(d0[0], d0[1], d0[2], d0[3]),
                              make_float4(d1[0], d1[1], d1[2], d1[3]),
                              make_float4(d2[0], d2[1], d2[2], d2[3]),
                              make_float4(d3[0], d3[1], d3[2], d3[3])};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          red4_if<VEC>((flags >> (4 + n) & 1) && n_c > 0, dq + step[n] + h * 32, dv[n], n_c);
        }
      }
      float sy = py[0] + (py[1] + py[2]), sx = px[0] + (px[1] + px[2]);
#pragma unroll
      for (int m = kLanes / 2; m > 0; m >>= 1) {  // over the item's lanes
        sy += __shfl_xor_sync(0xffffffffu, sy, m);
        sx += __shfl_xor_sync(0xffffffffu, sx, m);
      }
      if (quad == 0 && live) {
        float2* o = reinterpret_cast<float2*>(doff + (size_t)s_pix[p] * (2 * K) + 2 * tap);
        if (S.atomic_doff) {
          atomicAdd(o, make_float2(sy, sx));
        } else {
          *o = make_float2(sy, sx);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxQuads; ++h) {
      if (h >= nq) break;
#pragma unroll
      for (int m = kLanes; m < 32; m <<= 1) {  // over the warp's pixel slots
        acc[h].x += __shfl_xor_sync(0xffffffffu, acc[h].x, m);
        acc[h].y += __shfl_xor_sync(0xffffffffu, acc[h].y, m);
        acc[h].z += __shfl_xor_sync(0xffffffffu, acc[h].z, m);
        acc[h].w += __shfl_xor_sync(0xffffffffu, acc[h].w, m);
      }
      if (slot == 0) {
        *reinterpret_cast<float4*>(s_dwp + (split * K + tap) * CH + h * 32 + quad * 4) = acc[h];
      }
    }
  }
  __syncthreads();  // the dw parts are complete
  // the block's dw partial: the warps' parts added in split order
  for (int i = threadIdx.x; i < K * CH; i += nthreads) {
    const int cc = c0 + i % CH;
    if (cc >= C) continue;
    float sum = s_dwp[i];
    for (int sp = 1; sp < S.splits; ++sp) sum += s_dwp[sp * K * CH + i];
    dw_part[((size_t)tile * K + i / CH) * C + cc] = sum;
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
  deform_dw_bwd_data_kernel<VEC><<<grid, 32 * S.k * S.splits, smem, stream>>>(
      x, off, w, g, dx, doff, part, S);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, off, w, g, dx, doff (both zero on entry), dw, part
// (tiles × k² × C floats of scratch: each tile's dw terms) and the stream
// handle; plan: B, H, W, C, k, dil, th, tw (th · tw ≤ 64), splits (warps a
// tap row, each over ⌈th · tw / splits⌉ pixels; 32 · k · splits ≤ 768
// threads), nq (channel quads a lane, 1 … 3: a block takes 32 · nq
// channels), smem (the bytes the caller's plan computed: 4 · (32 nq k² (1 +
// splits) + (32 nq + 2k² + 2) th · tw + 4k · splits · s) with s the item
// slots of a warp, ⌈th · tw / splits⌉ rounded up to 4); vec: 4 for 16-byte
// accesses along C (C % 4 = 0; x, g and dx 16-byte aligned), else 1. Two
// launches.
extern "C" int dlka_deform_dw_conv2d_bwd(const unsigned long long* args, const int* plan,
                                         int vec) {
  Shape S;
  S.B = plan[0]; S.H = plan[1]; S.W = plan[2]; S.C = plan[3]; S.k = plan[4]; S.dil = plan[5];
  S.th = plan[6]; S.tw = plan[7];
  S.splits = plan[8];
  S.nq = plan[9];
  const int smem = plan[10];
  const long long K = (long long)S.k * S.k, TP = (long long)S.th * S.tw;
  const long long CH = 32LL * S.nq;
  const long long slots = (TP + 4LL * S.splits - 1) / (4LL * S.splits) * 4;
  const long long need = 4 * (CH * K * (1 + S.splits) + (CH + 2 * K + 2) * TP +
                              4LL * S.k * S.splits * slots);
  const long long threads = 32LL * S.k * S.splits;
  if (S.k <= 0 || S.k % 2 == 0 || S.dil < 1 || S.th < 1 || S.tw < 1 || TP > 64 ||
      S.splits < 1 || S.splits > TP || S.nq < 1 || S.nq > kMaxQuads || threads > kMaxThreads ||
      S.H >= 16384 || S.W >= 16384 || (long long)S.H * S.W * S.C >= (1LL << 31) ||
      (vec != 1 && vec != 4) || (vec == 4 && S.C % 4 != 0) || (long long)smem != need ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  S.tiles_y = (S.H + S.th - 1) / S.th;
  S.tiles_x = (S.W + S.tw - 1) / S.tw;
  const int chunks = (S.C + (int)CH - 1) / (int)CH;
  S.atomic_doff = chunks > 1;
  const int tiles = S.B * S.tiles_y * S.tiles_x;
  const dim3 grid(tiles, chunks);
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* off = reinterpret_cast<const float*>(args[1]);
  const auto* w = reinterpret_cast<const float*>(args[2]);
  const auto* g = reinterpret_cast<const float*>(args[3]);
  auto* dx = reinterpret_cast<float*>(args[4]);
  auto* doff = reinterpret_cast<float*>(args[5]);
  auto* dw = reinterpret_cast<float*>(args[6]);
  auto* part = reinterpret_cast<float*>(args[7]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[8]);
  const int err = vec == 4 ? launch_data<4>(x, off, w, g, dx, doff, part, S, grid, smem, stream)
                           : launch_data<1>(x, off, w, g, dx, doff, part, S, grid, smem, stream);
  if (err) return err;
  const int n_e = (int)(K * S.C);
  deform_dw_bwd_sum_kernel<<<(n_e + kSumLanes - 1) / kSumLanes, kSumThreads, 0, stream>>>(
      part, dw, n_e, tiles);
  return (int)cudaGetLastError();
}
