// Exact 3x3x3 deformable convolution for Hopper (stride 1, pad 1, dilation 1,
// groups 1), D3D semantics: every output voxel takes, per tap, a trilinear
// sample at p + tap - 1 + Δ, where each of the 8 corners is zero outside the
// volume; there is no clip of Δ. f32 in and out; x (B, D, H, W, Ci), offsets
// (B, D, H, W, 81) with channel 3k + i = tap k, axis i in (d, h, w) order,
// w (27, Ci, Co), optional bias (Co), y (B, D, H, W, Co).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/deform3d_kernel.py
// deform_conv3d_pallas (:1008) → _forward_v3 (:774) and its kernel bodies
// v3…v5xw (:329-771), which clip Δ to ±R and leave larger offsets to a gather.
//
// What bounds it. Per voxel: the channel mix, 2·27·Ci·Co FLOP, and the blend,
// 27·8·2·Ci FLOP, against (Ci + 81 + Co)·4 bytes. On the CUDA cores in f32
// (67 TFLOP/s) that is operations-bound: 2.78 ms per forward at batch 8 over
// the four stage shapes of the main path. On the tensor cores, with three
// TF32 products per multiply (below) at 495 TFLOP/s dense and the blend on
// the CUDA cores beside them, the bound is 0.96 ms. Two things keep the
// kernel far above either: mma.sync runs TF32 at about a quarter of the
// dense rate on this card (a chip ablation of an earlier build: removing the
// products saved 0.35 of 1.28 ms at 32³, ~120 TFLOP/s, so ~40 TFLOP/s of f32 work through
// 3xTF32; wgmma is the way to the full rate), and the gather of 8 corners ×
// Ci per (voxel, tap) through L1/L2, whose latency a block's 27 barrier
// steps expose (removing the loads saves 0.39 ms there). The offsets' size
// does not matter: ±2.5 and ±0.05 take the same time.
//
// Design: an implicit GEMM. M = output voxels, N = Co, K = 27·Ci taken in
// (tap, 32-channel chunk) steps.
//  - A block owns 64 voxels (a brick of one volume, 4×4×4 where it fits, so
//    that its samples share corners in L1) × BN = 32 or 64 output channels;
//    4 warps, each a 32-row tile of m16n8k8 products.
//  - The block stages its voxels' offsets once (coalesced). Per tap, one
//    thread per voxel computes the sample's 8 corners (index, weight) once,
//    into a table in shared memory (two buffers: the next tap's table is
//    built while the current one is read).
//  - Per step, each thread blends 4 channels of one voxel with 16-byte loads
//    along Ci (x is channels-last; a scalar path for Ci % 4 ≠ 0) into the A
//    tile, rows padded to 36 floats so that the fragment reads are
//    conflict-free. The B tile (w_k's 32 × BN chunk) is staged by cp.async.
//  - 3xTF32: each operand is split when its fragment is read into a TF32
//    high part (cvt.rna) and a TF32 low part (cvt.rna of x − hi); the
//    products hi·hi and the corrections lo·hi + hi·lo accumulate in f32 in
//    two sets of registers (two shorter chains of dependent mma). That keeps
//    the result within f32 rounding of the plain version; one TF32 product
//    alone (10-bit mantissa) does not, at K = 27·Ci
//    (tests/test_torch_launch_plans.py).
//  - Two buffers of A and B, one barrier per step: a step issues the loads
//    of its first blend item of chunk s + 1, multiplies chunk s, then
//    blends chunk s + 1 and builds the next corner table.
//  - Where the voxel tiles alone give fewer than three blocks per SM (the
//    8³ and 4³ stages), K is split over taps into `parts`: each part writes
//    its partial sums into a scratch buffer, and a second kernel adds the
//    parts in a fixed order and the bias: the output does not change from
//    run to run (no float atomics).
// The brick, BN, the split and the grid come from the caller's launch plan
// (ops/kernels.py deform3d_plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;        // BM: output voxels per block
constexpr int kTaps = 27;
constexpr int BK = 32;           // input channels per K step
constexpr int kAPitch = BK + 4;  // floats per A row
constexpr int kSmemMax = 232448;
constexpr int kPre = 1;          // blend items per thread gathered ahead

__host__ __device__ constexpr int b_pitch(int BN) { return BN + 8; }

// the block's offsets: per row, 3 per tap of its part, the pitch odd so
// that the corner threads' reads hit distinct banks
__host__ __device__ constexpr int off_pitch(int taps) { return (3 * taps) | 1; }

// Shared memory, in 4-byte words: A [2][BM][36], B [2][32][BN+8], the corner
// tables [2][BM][8] (weights) and [2][BM][8] (indices), voxels [BM], offsets
// [BM][off_pitch].
__host__ __device__ constexpr int smem_words(int BM, int BN, int taps) {
  return 2 * BM * kAPitch + 2 * BK * b_pitch(BN) + 2 * 2 * BM * 8 + BM +
         BM * off_pitch(taps);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  const uint32_t h = tf32(v);
  hi = __uint_as_float(h);
  lo = __uint_as_float(tf32(v - hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

struct Shape {
  int B, D, H, W, Ci, Co;
  int lz, ly, lx;          // log2 of the brick's sides
  int tiles_z, tiles_y, tiles_x;
  int taps_per_part;
};

template <int BN, int VEC>
__global__ void __launch_bounds__(kThreads)
deform_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ y, const Shape S) {
  constexpr int BM = kRows;
  constexpr int kWarpsM = BM / 32;
  constexpr int kWarpsN = kThreads / 32 / kWarpsM;
  constexpr int WN = BN / kWarpsN;
  constexpr int NI = WN / 8;      // n8 tiles per warp
  constexpr int kBP = b_pitch(BN);
  static_assert(kWarpsM * kWarpsN * 32 == kThreads && NI >= 1 && NI * 8 * kWarpsN == BN,
                "tile");

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                           // [2][BM][kAPitch]
  float* b_s = a_s + 2 * BM * kAPitch;         // [2][BK][kBP]
  float* c_wt = b_s + 2 * BK * kBP;            // [2][BM][8]
  int* c_idx = reinterpret_cast<int*>(c_wt + 2 * BM * 8);  // [2][BM][8]
  int* s_vox = c_idx + 2 * BM * 8;             // [BM]
  float* s_off = reinterpret_cast<float*>(s_vox + BM);     // [BM][off_pitch]
  const int opitch = off_pitch(S.taps_per_part);

  const int D = S.D, H = S.H, W = S.W, Ci = S.Ci, Co = S.Co;
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * BN;

  // this block's brick: blockIdx.x = ((b·tiles_z + tz)·tiles_y + ty)·tiles_x + tx
  int t = blockIdx.x;
  const int btx = t % S.tiles_x; t /= S.tiles_x;
  const int bty = t % S.tiles_y; t /= S.tiles_y;
  const int btz = t % S.tiles_z;
  const int bb = t / S.tiles_z;

  // row m's voxel in the brick (-1 outside the volume), and its coordinates
  const int lxy = S.lx + S.ly;
  auto row_voxel = [&](int m, int& z, int& yy, int& xx) {
    xx = (btx << S.lx) + (m & ((1 << S.lx) - 1));
    yy = (bty << S.ly) + ((m >> S.lx) & ((1 << S.ly) - 1));
    z = (btz << S.lz) + (m >> lxy);
    return (m >> (lxy + S.lz)) == 0 && z < D && yy < H && xx < W
               ? ((bb * D + z) * H + yy) * W + xx : -1;
  };
  // the corner thread of row m = tid keeps its voxel's coordinates
  int vz = 0, vy = 0, vx = 0, vox = -1;
  if (tid < BM) {
    vox = row_voxel(tid, vz, vy, vx);
    s_vox[tid] = vox;
  }

  const int k_begin = blockIdx.z * S.taps_per_part;
  const int k_end = min(kTaps, k_begin + S.taps_per_part);
  const int chunks = (Ci + BK - 1) / BK;
  const int steps = (k_end - k_begin) * chunks;

  // the offsets of the block's voxels at its taps, once, coalesced
  {
    const int n = 3 * (k_end - k_begin);
    for (int i = tid; i < BM * n; i += kThreads) {
      const int m = i / n, j = i % n;
      int z, yy, xx;
      const int v = row_voxel(m, z, yy, xx);
      s_off[m * opitch + j] = v >= 0 ? __ldg(off + (size_t)v * (3 * kTaps) + 3 * k_begin + j) : 0.f;
    }
  }

  // the 8 corners of row tid's sample at tap k, into table (k - k_begin) & 1
  auto corners = [&](int k) {
    if (tid >= BM) return;
    int idx[8];
    float wt[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) { idx[c] = -1; wt[c] = 0.f; }
    if (vox >= 0) {
      const int kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
      const float* o = s_off + tid * opitch + 3 * (k - k_begin);
      // clamping keeps the int conversion defined; a sample clamped here
      // has all its corners outside the volume either way
      const float zs = fminf(fmaxf((float)(vz - 1 + kz) + o[0], -2.f), (float)D + 1.f);
      const float ys = fminf(fmaxf((float)(vy - 1 + ky) + o[1], -2.f), (float)H + 1.f);
      const float xs = fminf(fmaxf((float)(vx - 1 + kx) + o[2], -2.f), (float)W + 1.f);
      const float z0 = floorf(zs), y0 = floorf(ys), x0 = floorf(xs);
      const float dz = zs - z0, dy = ys - y0, dx = xs - x0;
      const int zi0 = (int)z0, yi0 = (int)y0, xi0 = (int)x0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int oz = c >> 2, oy = (c >> 1) & 1, ox = c & 1;
        const int zi = zi0 + oz, yi = yi0 + oy, xi = xi0 + ox;
        if (zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W) {
          const float wz = oz ? dz : 1.f - dz;
          const float wy = oy ? dy : 1.f - dy;
          const float wx = ox ? dx : 1.f - dx;
          wt[c] = (wz * wy) * wx;
          idx[c] = ((bb * D + zi) * H + yi) * W + xi;
        }
      }
    }
    const int buf = (k - k_begin) & 1;
    float4* wt4 = reinterpret_cast<float4*>(c_wt + (buf * BM + tid) * 8);
    int4* idx4 = reinterpret_cast<int4*>(c_idx + (buf * BM + tid) * 8);
    wt4[0] = make_float4(wt[0], wt[1], wt[2], wt[3]);
    wt4[1] = make_float4(wt[4], wt[5], wt[6], wt[7]);
    idx4[0] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    idx4[1] = make_int4(idx[4], idx[5], idx[6], idx[7]);
  };

  // stage w's chunk of step s into B buffer s & 1 (cp.async, zero-filled
  // outside Ci × Co)
  auto stage_b = [&](int s) {
    const int k = k_begin + s / chunks;
    const int ci0 = (s % chunks) * BK;
    const float* wk = w + ((size_t)k * Ci + ci0) * Co + co0;
    float* bs = b_s + (s & 1) * BK * kBP;
    if constexpr (VEC == 4) {
      for (int i = tid; i < BK * (BN / 4); i += kThreads) {
        const int r = i / (BN / 4), n = (i % (BN / 4)) * 4;
        const bool ok = ci0 + r < Ci && co0 + n < Co;
        cp_async16(bs + r * kBP + n, ok ? wk + (size_t)r * Co + n : w, ok);
      }
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int r = i / BN, n = i % BN;
        const bool ok = ci0 + r < Ci && co0 + n < Co;
        cp_async4(bs + r * kBP + n, ok ? wk + (size_t)r * Co + n : w, ok);
      }
    }
  };

  // the blend of step s: item i is VEC channels of row m; its 8 corners'
  // values are gathered first (`gather`), blended into A buffer s & 1 later
  // (`blend`), so that a thread's first kPre items' loads are in flight
  // while the warp multiplies the previous chunk
  constexpr int kPerRow = BK / VEC;
  constexpr int kItems = BM * kPerRow;
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  auto gather = [&](int s, int i, Vec (&g)[8]) {
    const int k = k_begin + s / chunks;
    const int c = (s % chunks) * BK + (i % kPerRow) * VEC;
    const int m = i / kPerRow;
    const int4* idx4 = reinterpret_cast<const int4*>(c_idx + (((k - k_begin) & 1) * BM + m) * 8);
    const int4 ia = idx4[0], ib = idx4[1];
    const int cv[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (VEC == 4) {
        g[j] = cv[j] >= 0 && c < Ci
                   ? __ldg(reinterpret_cast<const float4*>(x + (size_t)cv[j] * Ci + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        g[j] = cv[j] >= 0 && c < Ci ? __ldg(x + (size_t)cv[j] * Ci + c) : 0.f;
      }
    }
  };
  auto blend = [&](int s, int i, const Vec (&g)[8]) {
    const int k = k_begin + s / chunks;
    const int m = i / kPerRow, q = (i % kPerRow) * VEC;
    const float4* wt4 = reinterpret_cast<const float4*>(c_wt + (((k - k_begin) & 1) * BM + m) * 8);
    const float4 wa = wt4[0], wb = wt4[1];
    const float cw[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    float* dst = a_s + ((s & 1) * BM + m) * kAPitch + q;
    if constexpr (VEC == 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v.x = fmaf(cw[j], g[j].x, v.x);
        v.y = fmaf(cw[j], g[j].y, v.y);
        v.z = fmaf(cw[j], g[j].z, v.z);
        v.w = fmaf(cw[j], g[j].w, v.w);
      }
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) v = fmaf(cw[j], g[j], v);
      *dst = v;
    }
  };
  Vec pre[kPre][8];
  auto gather_first = [&](int s) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      if (tid + u * kThreads < kItems) gather(s, tid + u * kThreads, pre[u]);
    }
  };
  auto blend_all = [&](int s) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      if (tid + u * kThreads < kItems) blend(s, tid + u * kThreads, pre[u]);
    }
    for (int i = tid + kPre * kThreads; i < kItems; i += kThreads) {
      Vec g[8];
      gather(s, i, g);
      blend(s, i, g);
    }
  };

  // warp tile: rows wm0 .. wm0 + 31, columns wn0 .. wn0 + WN - 1
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wm0 = (warp / kWarpsN) * 32, wn0 = (warp % kWarpsN) * WN;
  // the products hi·hi and the corrections lo·hi + hi·lo in two sets of
  // accumulators: two shorter chains of dependent mma
  float acc[2][NI][4], cor[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = cor[mi][ni][e] = 0.f;

  auto multiply = [&](int buf) {
    const float* as = a_s + buf * BM * kAPitch;
    const float* bs = b_s + buf * BK * kBP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t fh[2][4], fl[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = (wm0 + mi * 16 + g) * kAPitch + kk + tq;
        const float a[4] = {as[r], as[r + 8 * kAPitch], as[r + 4], as[r + 8 * kAPitch + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, l;
          split(a[e], h, l);
          fh[mi][e] = __float_as_uint(h);
          fl[mi][e] = __float_as_uint(l);
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = (kk + tq) * kBP + wn0 + ni * 8 + g;
        float h0, l0, h1, l1;
        split(bs[c], h0, l0);
        split(bs[c + 4 * kBP], h1, l1);
        const uint32_t bh[2] = {__float_as_uint(h0), __float_as_uint(h1)};
        const uint32_t bl[2] = {__float_as_uint(l0), __float_as_uint(l1)};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(cor[mi][ni], fl[mi], bh);
          mma_tf32(cor[mi][ni], fh[mi], bl);
          mma_tf32(acc[mi][ni], fh[mi], bh);
        }
      }
    }
  };

  // a new corner table is built one step before its tap's first blend
  auto next_table = [&](int s) {
    if (s < steps && s % chunks == 0) corners(k_begin + s / chunks);
  };

  __syncthreads();  // the offsets are staged
  corners(k_begin);
  __syncthreads();
  stage_b(0);
  gather_first(0);
  blend_all(0);
  next_table(1);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {
      stage_b(s + 1);
      gather_first(s + 1);
    }
    multiply(s & 1);
    if (more) {
      blend_all(s + 1);
      next_table(s + 2);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: rows g and g + 8 of each m16 tile, columns 2·tq and 2·tq + 1
  const bool last = gridDim.z == 1;
  float* out = y + (last ? 0 : (size_t)blockIdx.z * S.B * D * H * W * Co);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int v = s_vox[wm0 + mi * 16 + g + 8 * half];
      if (v < 0) continue;
      float* row = out + (size_t)v * Co;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int co = co0 + wn0 + ni * 8 + 2 * tq;
        float v0 = acc[mi][ni][2 * half] + cor[mi][ni][2 * half];
        float v1 = acc[mi][ni][2 * half + 1] + cor[mi][ni][2 * half + 1];
        if (last && bias != nullptr) {
          if (co < Co) v0 += __ldg(bias + co);
          if (co + 1 < Co) v1 += __ldg(bias + co + 1);
        }
        if constexpr (VEC == 4) {
          if (co < Co) *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          if (co < Co) row[co] = v0;
          if (co + 1 < Co) row[co + 1] = v1;
        }
      }
    }
  }
}

// y = bias + Σ_p part[p], the parts in order; n = voxels · Co
__global__ void __launch_bounds__(256)
deform_conv3d_kernel_sum_parts(const float* __restrict__ part, const float* __restrict__ bias,
                               float* __restrict__ y, long long n, int Co, int parts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < parts; ++p) v += part[i + p * n];
    if (bias != nullptr) v += __ldg(bias + (int)(i % Co));
    y[i] = v;
  }
}

template <int BN, int VEC>
int launch(const float* x, const float* off, const float* w, const float* bias, float* y,
           float* scratch, const Shape& S, dim3 grid, int smem, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_conv3d_kernel<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const bool split_k = grid.z > 1;
  deform_conv3d_kernel<BN, VEC><<<grid, kThreads, smem, stream>>>(
      x, off, w, bias, split_k ? scratch : y, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split_k) return (int)err;
  const long long n = (long long)S.B * S.D * S.H * S.W * S.Co;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  deform_conv3d_kernel_sum_parts<<<blocks, 256, 0, stream>>>(scratch, bias, y, n, S.Co,
                                                            (int)grid.z);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_vec(int vec, const float* x, const float* off, const float* w, const float* bias,
               float* y, float* scratch, const Shape& S, dim3 grid, int smem,
               cudaStream_t stream) {
  return vec == 4 ? launch<BN, 4>(x, off, w, bias, y, scratch, S, grid, smem, stream)
                  : launch<BN, 1>(x, off, w, bias, y, scratch, S, grid, smem, stream);
}

}  // namespace

// args: the pointers x, off, w, bias (0: none), y, scratch (parts × voxels ×
// Co floats, used where parts > 1) and the stream handle; plan: B, D, H, W,
// Ci, Co, BN (32 or 64 output channels per block), the brick's log2 sides
// lz, ly, lx of its 64 voxels (lz + ly + lx ≤ 6), parts
// (the K split over taps, 1 … 27), taps per part, smem (the bytes the
// caller's plan computed, which must be this layout's); vec: 4 for 16-byte
// loads along Ci and copies along Co (Ci % 4 = 0, Co % 4 = 0, x and w
// 16-byte aligned), else 1. One launch, or two where parts > 1.
extern "C" int dlka_deform_conv3d(const unsigned long long* args, const int* plan, int vec) {
  Shape S;
  S.B = plan[0]; S.D = plan[1]; S.H = plan[2]; S.W = plan[3]; S.Ci = plan[4]; S.Co = plan[5];
  const int BN = plan[6];
  S.lz = plan[7]; S.ly = plan[8]; S.lx = plan[9];
  const int parts = plan[10];
  S.taps_per_part = plan[11];
  const int smem = plan[12];
  if ((BN != 32 && BN != 64) || S.lz < 0 || S.ly < 0 || S.lx < 0 ||
      (1 << (S.lz + S.ly + S.lx)) > kRows || parts < 1 || parts > kTaps ||
      S.taps_per_part < 1 || (parts - 1) * S.taps_per_part >= kTaps ||
      parts * S.taps_per_part < kTaps || (vec != 1 && vec != 4) ||
      (vec == 4 && (S.Ci % 4 != 0 || S.Co % 4 != 0)) ||
      (size_t)smem != (size_t)smem_words(kRows, BN, S.taps_per_part) * sizeof(float) ||
      smem > kSmemMax ||
      (parts > 1 && args[5] == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  S.tiles_z = (S.D + (1 << S.lz) - 1) >> S.lz;
  S.tiles_y = (S.H + (1 << S.ly) - 1) >> S.ly;
  S.tiles_x = (S.W + (1 << S.lx) - 1) >> S.lx;
  const dim3 grid(S.B * S.tiles_z * S.tiles_y * S.tiles_x, (S.Co + BN - 1) / BN, parts);
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* off = reinterpret_cast<const float*>(args[1]);
  const auto* w = reinterpret_cast<const float*>(args[2]);
  const auto* bias = reinterpret_cast<const float*>(args[3]);
  auto* y = reinterpret_cast<float*>(args[4]);
  auto* scratch = reinterpret_cast<float*>(args[5]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[6]);
  return BN == 32 ? launch_vec<32>(vec, x, off, w, bias, y, scratch, S, grid, smem, stream)
                  : launch_vec<64>(vec, x, off, w, bias, y, scratch, S, grid, smem, stream);
}

extern "C" const char* dlka_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
