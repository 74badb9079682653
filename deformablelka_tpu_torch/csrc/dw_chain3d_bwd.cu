// Backward of the fused LKA chain (csrc/dw_chain3d.cu) for Hopper: with
// a = dw5³(x) + b5 (pad 2) and y = dw7³-dil3(a) + b7 (pad 9), zero outside
// the volume, and the cotangent g of y, it computes in f32, channels-last
// (B, D, H, W, C):
//   db7 = Σ g;   dw7[t] = Σ_v a(v + 3(t − 3)) · g(v);
//   da = dil7ᵀ(g), the dilated correlation with flipped taps;
//   db5 = Σ da;  dw5[t] = Σ_v x(v + t − 2) · da(v);
//   dx = dw5ᵀ(da).
// The transposed convs run in reverse order (dil7ᵀ, then dw5ᵀ), and a is
// recomputed from x, so the forward kernel saves nothing for it.
//
// Replaces no TPU kernel: the JAX package differentiates the plain chain
// (deformablelka_tpu/ops/pallas/lka_fused_kernel.py:252 _c3_bwd), and the
// port did the same on cuDNN, whose grouped weight gradient took two
// thirds of a training step. This kernel takes its place.
//
// What bounds it: depthwise, 2·(125 + 343) FLOP per voxel-channel for
// each of the three data passes and the two weight gradients, against a
// few bytes: the f32 FMA rate and the shared-memory loads that feed it,
// never the tensor cores. Its design:
//  - one kernel, `dw_chain3d_bwd_taps`, run three times: a = dw5(x) + b5;
//    then da and dw7's per-block sums from g and a; then dx and dw5's from
//    da and x. Each pass stages one tensor h with its halo (g, da, or x)
//    and, for the tap sums, one tensor p without (a or x): every output is
//    Σ_k W[k] · h(u + k) and every tap sum Σ_u p(u) · h(u + k) over the
//    same staged offsets k, so both read h as it lies in shared memory;
//  - the dilation-3 pass runs on the 27 phase sub-grids (z, y, x mod 3),
//    on each of which the dilated kernel is a dense 7³ one with a halo of
//    3 sub-grid voxels: a block stages its brick's 3 + 3 halo planes, not
//    the 9 + 9 the dilated reach would ask of a dense brick;
//  - a block is a brick of (sub-grid) voxels × 4 channels, staged once in
//    shared memory, channel-planar, through 16-byte loads along C where
//    C % 4 = 0 (else one float at a time); every tap reads it there;
//  - a thread computes vertical strips of 4 outputs with a column of K
//    weights in registers ((4 + K − 1) shared loads for 4K FMAs), and a
//    tap sum over a column of its channel for K taps at once (K
//    accumulators; the column's p in registers);
//  - the weight gradients use no atomics: each thread sums its part of
//    the brick in a fixed order, the block adds its splits in a fixed
//    order and writes its own partial sums, and `dw_chain3d_bwd_sum` adds
//    the blocks' partials in a fixed order. dx and da are gathers. So the
//    whole backward is bitwise repeatable.
// The bricks (chosen to fill the card at each stage shape) come from the
// caller's launch plan (ops/kernels.py chain3d_bwd_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 4;      // outputs of a thread strip, rows a tap-sum step
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;

// One pass's geometry, in sub-grid voxels (the volume itself where DIL = 1).
struct Geo {
  int B, D, H, W, C, CT;
  int TZ, TY, TX, S;    // brick; the tap sums' column splits
  int TYP;              // TY rounded up to the strip
  int nbz, nby, nbx;    // bricks per axis over the longest phase
  int HZ, HY, HX;       // staged h: the brick (rows to TYP) and its halo
  int h_chan, p_chan;   // channel pitches of staged h and p
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = __ldg(src);
  }
}

// out(u) = Σ_k W[k] · h(u + k − r) (+ bias), W[k] = w[k] or, with FLIP,
// w[K³ − 1 − k]; with TAPS, part[blk][k][c] = Σ_u p(u) · h(u + k − r) over
// the brick and part[blk][K³][c] = Σ_u h(u). Offsets in sub-grid voxels
// (r = K / 2), h and p zero outside the volume.
template <int K, int DIL, int VEC, bool FLIP, bool TAPS>
__global__ void __launch_bounds__(kThreads, 2)
dw_chain3d_bwd_taps(const float* __restrict__ h, const float* __restrict__ p,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    float* __restrict__ out, float* __restrict__ part, const Geo G) {
  extern __shared__ float smem[];
  constexpr int R = K / 2;
  constexpr int KKK = K * K * K;
  const int C = G.C, CT = G.CT;
  float* hs = smem;                      // [CT][HZ][HY][HX]
  float* ps = hs + CT * G.h_chan;        // [CT][TZ][TYP][TX]
  float* red = ps + CT * G.p_chan;       // [S][CT][K³]
  const int nbr = G.nbz * G.nby * G.nbx;
  const int brick = blockIdx.x % nbr;
  const int phase = blockIdx.x / nbr;
  const int c0 = blockIdx.y * CT;
  const int b = blockIdx.z;
  const int pz = phase / (DIL * DIL), py = (phase / DIL) % DIL, px = phase % DIL;
  const int nz = (G.D - pz + DIL - 1) / DIL;  // this phase's sub-grid
  const int ny = (G.H - py + DIL - 1) / DIL;
  const int nx = (G.W - px + DIL - 1) / DIL;
  const int bz0 = brick / (G.nby * G.nbx) * G.TZ;
  const int by0 = brick / G.nbx % G.nby * G.TY;
  const int bx0 = brick % G.nbx * G.TX;
  const size_t base = (size_t)b * G.D * G.H * G.W * C + c0;
  auto at = [&](int jz, int jy, int jx) {  // a sub-grid voxel's channel c0
    return base + (((size_t)(pz + DIL * jz) * G.H + (py + DIL * jy)) * G.W + (px + DIL * jx)) * C;
  };
  const int qn = CT / VEC;
  const int nt = blockDim.x, tid = threadIdx.x;

  // ---- staging: h with its halo, p inside the brick only ----
  for (int i = tid; i < G.HZ * G.HY * G.HX * qn; i += nt) {
    const int cc = i % qn * VEC, v = i / qn;
    const int jx = bx0 - R + v % G.HX, jy = by0 - R + v / G.HX % G.HY;
    const int jz = bz0 - R + v / (G.HX * G.HY);
    float val[VEC];
    if (jz >= 0 && jz < nz && jy >= 0 && jy < ny && jx >= 0 && jx < nx && c0 + cc < C) {
      load_vec<VEC>(h + at(jz, jy, jx) + cc, val);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) hs[(cc + j) * G.h_chan + v] = val[j];
  }
  if constexpr (TAPS) {
    for (int i = tid; i < G.TZ * G.TYP * G.TX * qn; i += nt) {
      const int cc = i % qn * VEC, v = i / qn;
      const int lx = v % G.TX, ly = v / G.TX % G.TYP, lz = v / (G.TX * G.TYP);
      const int jz = bz0 + lz, jy = by0 + ly, jx = bx0 + lx;
      float val[VEC];
      if (ly < G.TY && jz < nz && jy < ny && jx < nx && c0 + cc < C) {
        load_vec<VEC>(p + at(jz, jy, jx) + cc, val);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) val[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) ps[(cc + j) * G.p_chan + v] = val[j];
    }
  }
  __syncthreads();

  // ---- out: strips of kStrip rows of one column of one channel ----
  const int nstrip = G.TYP / kStrip;
  for (int it = tid; it < CT * G.TZ * G.TX * nstrip; it += nt) {
    const int lx = it % G.TX, lz = it / G.TX % G.TZ;
    const int s = it / (G.TX * G.TZ) % nstrip, c = it / (G.TX * G.TZ * nstrip);
    if (c0 + c >= C) continue;
    const int y0 = s * kStrip;
    float acc[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = 0.f;
    const float* hc = hs + c * G.h_chan + y0 * G.HX + lx;
    const float* wc = w + c0 + c;
    for (int kz = 0; kz < K; ++kz) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        float wr[K];  // the column of weights (kz, ·, kx)
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const int t = (kz * K + ky) * K + kx;
          wr[ky] = __ldg(wc + (size_t)(FLIP ? KKK - 1 - t : t) * C);
        }
        const float* col = hc + (lz + kz) * G.HY * G.HX + kx;
#pragma unroll
        for (int i = 0; i < kStrip + K - 1; ++i) {
          const float v = col[i * G.HX];
#pragma unroll
          for (int ky = 0; ky < K; ++ky) {
            if (i - ky >= 0 && i - ky < kStrip) acc[i - ky] = fmaf(wr[ky], v, acc[i - ky]);
          }
        }
      }
    }
    const int jz = bz0 + lz, jx = bx0 + lx;
    if (jz < nz && jx < nx) {
      const float bv = bias != nullptr ? __ldg(bias + c0 + c) : 0.f;
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        const int ly = y0 + j;
        if (ly < G.TY && by0 + ly < ny) out[at(jz, by0 + ly, jx) + c] = acc[j] + bv;
      }
    }
  }
  if constexpr (!TAPS) return;

  // ---- tap sums: a task is (kx, kz, channel, split), K accumulators over ky ----
  const int ncol = G.TZ * G.TX;
  const int ntap = K * K * CT * G.S;
  const size_t blk = ((size_t)b * DIL * DIL * DIL + phase) * nbr + brick;
  float* pb = part + blk * (KKK + 1) * C + c0;
  for (int it = tid; it < ntap + CT; it += nt) {
    if (it >= ntap) {  // Σ h over the brick, the bias gradient's part
      const int c = it - ntap;
      if (c0 + c >= C) continue;
      float sum = 0.f;
      for (int lz = 0; lz < G.TZ; ++lz) {
        for (int ly = 0; ly < G.TY; ++ly) {
          const float* row = hs + c * G.h_chan + ((lz + R) * G.HY + ly + R) * G.HX + R;
          for (int lx = 0; lx < G.TX; ++lx) sum += row[lx];
        }
      }
      pb[(size_t)KKK * C + c] = sum;
      continue;
    }
    const int kx = it % K, kz = it / K % K;
    const int c = it / (K * K) % CT, s = it / (K * K * CT);
    float acc[K];
#pragma unroll
    for (int ky = 0; ky < K; ++ky) acc[ky] = 0.f;
    if (c0 + c < C) {
      const int q0 = s * ncol / G.S, q1 = (s + 1) * ncol / G.S;
      for (int q = q0; q < q1; ++q) {
        const int lx = q % G.TX, lz = q / G.TX;
        const float* pc = ps + c * G.p_chan + lz * G.TYP * G.TX + lx;
        const float* hc = hs + c * G.h_chan + (lz + kz) * G.HY * G.HX + lx + kx;
        for (int y0 = 0; y0 < G.TYP; y0 += kStrip) {
          float pv[kStrip];
#pragma unroll
          for (int j = 0; j < kStrip; ++j) pv[j] = pc[(y0 + j) * G.TX];
#pragma unroll
          for (int i = 0; i < kStrip + K - 1; ++i) {
            const float v = hc[(y0 + i) * G.HX];
#pragma unroll
            for (int j = 0; j < kStrip; ++j) {
              if (i - j >= 0 && i - j < K) acc[i - j] = fmaf(pv[j], v, acc[i - j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int ky = 0; ky < K; ++ky) red[(s * CT + c) * KKK + (kz * K + ky) * K + kx] = acc[ky];
  }
  __syncthreads();
  // the block's partial sums: its splits added in order
  for (int i = tid; i < CT * KKK; i += nt) {
    const int c = i % CT, k = i / CT;
    if (c0 + c >= C) continue;
    float sum = red[c * KKK + k];
    for (int s = 1; s < G.S; ++s) sum += red[(s * CT + c) * KKK + k];
    pb[(size_t)k * C + c] = sum;
  }
}

// dw[t][c] = Σ_blk part[blk][K³ − 1 − t][c] (the staged offset k runs
// opposite to the tap t), db[c] = Σ_blk part[blk][K³][c], blocks in order;
// blockIdx.y picks the dilated pass's partials (0) or dw5's (1).
__global__ void __launch_bounds__(kThreads)
dw_chain3d_bwd_sum(const float* __restrict__ part7, const float* __restrict__ part5,
                   float* __restrict__ dw7, float* __restrict__ db7,
                   float* __restrict__ dw5, float* __restrict__ db5,
                   int C, int nblk7, int nblk5) {
  const int five = blockIdx.y;
  const int kkk = five ? 125 : 343;
  const float* part = five ? part5 : part7;
  const int nblk = five ? nblk5 : nblk7;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (kkk + 1) * C) return;
  const int t = i / C, c = i % C;
  const int k = t < kkk ? kkk - 1 - t : kkk;
  float sum = 0.f;
  for (int q = 0; q < nblk; ++q) sum += part[((size_t)q * (kkk + 1) + k) * C + c];
  if (t < kkk) {
    (five ? dw5 : dw7)[i] = sum;
  } else {
    (five ? db5 : db7)[c] = sum;
  }
}

// The pass's geometry from the plan: brick (TZ, TY, TX) and splits S in
// sub-grid voxels; false where the plan does not fit this layout.
bool make_geo(Geo& G, const int* plan, const int* pass, int K, int dil) {
  G.B = plan[0]; G.D = plan[1]; G.H = plan[2]; G.W = plan[3]; G.C = plan[4]; G.CT = plan[5];
  G.TZ = pass[0]; G.TY = pass[1]; G.TX = pass[2]; G.S = pass[3];
  if (G.TZ < 1 || G.TY < 1 || G.TX < 1 || G.S < 1 || G.CT < 1 || G.CT > 32) return false;
  G.TYP = (G.TY + kStrip - 1) / kStrip * kStrip;
  G.nbz = ((G.D + dil - 1) / dil + G.TZ - 1) / G.TZ;
  G.nby = ((G.H + dil - 1) / dil + G.TY - 1) / G.TY;
  G.nbx = ((G.W + dil - 1) / dil + G.TX - 1) / G.TX;
  G.HZ = G.TZ + K - 1; G.HY = G.TYP + K - 1; G.HX = G.TX + K - 1;
  G.h_chan = G.HZ * G.HY * G.HX;
  G.p_chan = G.TZ * G.TYP * G.TX;
  return true;
}

size_t smem_bytes(const Geo& G, int K, bool taps) {
  return ((size_t)G.CT * (G.h_chan + G.p_chan) + (taps ? (size_t)G.S * G.CT * K * K * K : 0)) *
         sizeof(float);
}

template <int K, int DIL, int VEC, bool FLIP, bool TAPS>
int launch(const float* h, const float* p, const float* w, const float* bias, float* out,
           float* part, const Geo& G, size_t smem, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dw_chain3d_bwd_taps<K, DIL, VEC, FLIP, TAPS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(DIL * DIL * DIL * G.nbz * G.nby * G.nbx, (G.C + G.CT - 1) / G.CT, G.B);
  dw_chain3d_bwd_taps<K, DIL, VEC, FLIP, TAPS><<<grid, kThreads, smem, stream>>>(
      h, p, w, bias, out, part, G);
  return (int)cudaGetLastError();
}

template <int VEC>
int run(const float* const* in, float* const* o, const Geo& Gmid, const Geo& G5, const Geo& G7,
        size_t smem_mid, size_t smem5, size_t smem7, cudaStream_t stream) {
  const float *x = in[0], *w5 = in[1], *b5 = in[2], *w7 = in[3], *g = in[4];
  float *a = o[0], *da = o[1], *dx = o[2], *part5 = o[3], *part7 = o[4];
  int err = launch<5, 1, VEC, false, false>(x, nullptr, w5, b5, a, nullptr, Gmid, smem_mid,
                                            stream);
  if (err) return err;
  err = launch<7, 3, VEC, true, true>(g, a, w7, nullptr, da, part7, G7, smem7, stream);
  if (err) return err;
  err = launch<5, 1, VEC, true, true>(da, x, w5, nullptr, dx, part5, G5, smem5, stream);
  if (err) return err;
  const int C = G5.C, nblk5 = G5.B * G5.nbz * G5.nby * G5.nbx;
  const int nblk7 = G7.B * 27 * G7.nbz * G7.nby * G7.nbx;
  const dim3 grid((344 * C + kThreads - 1) / kThreads, 2);
  dw_chain3d_bwd_sum<<<grid, kThreads, 0, stream>>>(part7, part5, o[7], o[8], o[5], o[6], C,
                                                    nblk7, nblk5);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, w5, b5, w7, g (inputs); a, da (scratch, B·D·H·W·C
// each), dx, part5, part7 (the passes' per-block partial sums: blocks ×
// (K³ + 1) × C each), dw5, db5, dw7, db7 (outputs); then the stream handle.
// plan: B, D, H, W, C, CT (channels per block, ≤ 32), then for the dw5
// passes and for the dilated pass each TZ, TY, TX (the brick, in sub-grid
// voxels), S (the tap sums' splits of the brick's columns) and the shared
// memory bytes of its tap-sum pass as the caller computed them (which must
// be this layout's); vec: 4 for 16-byte vectors along C (CT % 4 = 0, C % 4
// = 0, every tensor 16-byte aligned), else 1.
extern "C" int dlka_dw_chain3d_bwd(const unsigned long long* args, const int* plan, int vec) {
  Geo G5, G7;
  bool ok = make_geo(G5, plan, plan + 6, 5, 1) && make_geo(G7, plan, plan + 11, 7, 3) &&
            (vec == 1 || (vec == 4 && G5.CT % 4 == 0 && G5.C % 4 == 0));
  const size_t smem5 = smem_bytes(G5, 5, true), smem7 = smem_bytes(G7, 7, true);
  Geo Gmid = G5;  // the recompute of a stages no p
  Gmid.p_chan = 0;
  const size_t smem_mid = smem_bytes(Gmid, 5, false);
  ok = ok && smem5 == (size_t)plan[10] && smem7 == (size_t)plan[15] && smem5 <= kSmemMax &&
       smem7 <= kSmemMax;
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = reinterpret_cast<const float*>(args[i]);
  float* o[9];
  for (int i = 0; i < 9; ++i) o[i] = reinterpret_cast<float*>(args[5 + i]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[14]);
  return vec == 4 ? run<4>(in, o, Gmid, G5, G7, smem_mid, smem5, smem7, stream)
                  : run<1>(in, o, Gmid, G5, G7, smem_mid, smem5, smem7, stream);
}
