// Fused LKA chain for Hopper: dw5³ (pad 2) + b5, zero outside the volume,
// then dw7³ dilation 3 (pad 9) + b7, in one launch. f32 in, out and
// accumulation; channels-last (B, D, H, W, C).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/lka_fused_kernel.py
// dw_chain3d_fused (:240) → _dw_chain3d (:153) → _chain3d_kernel (:76).
//
// What bounds it: 2·(125 + 343) = 936 FLOP per voxel-channel against 8 bytes
// moved, so the f32 FMA rate of the CUDA cores, as long as each FMA does not
// wait on its own loads. The first version (one output per thread, a weight
// load and a shared load per FMA, one channel per block at 32² with 4-byte
// global accesses 128 bytes apart) was 23× over that bound. This design,
// that of csrc/dw_chain2d.cu in 3D:
//  - the z ring: a dilation-3 stage reads only intermediate planes of the
//    output's own z phase (z mod 3), so a block takes one phase (and, where
//    the plan splits it, a run of its outputs) and walks z in steps of 3,
//    keeping the 7 intermediate planes it needs in a ring in shared memory:
//    each intermediate plane is computed once per block;
//  - row bands: a block takes RB output rows of CT channels; its ring holds
//    the intermediate rows of the band ± 9 that lie inside the volume, so a
//    band recomputes dw5 on its halo rows. The plan takes the tallest band
//    that fits: whole planes at every stage of the main path (at 32³, 4
//    channels of 7 planes with their input are 143 KB, one block of 512
//    threads per SM; a band of 16 rows would recompute 1.56× the dw5 rows);
//  - dw5 runs as 5 passes over the input planes z' − 2 … z' + 2, one staged
//    at a time (with a zero halo of 2), each pass adding its z-slice into
//    the ring; the next pass's plane is loaded into registers while the
//    current one is computed;
//  - each thread keeps one x-column of a z-slice of its channel's weights in
//    registers (5 of dw5, 7 of dw7) and computes vertical strips of 8
//    outputs: dw5 (60 shared loads for 200 FMAs) and dilated (7·26 loads
//    for 392 FMAs); loops unrolled, so the weights stay in registers and
//    the strips' accumulators are independent;
//  - the dilated stage's zero padding costs no predicate: each ring plane
//    has a zero row and a zero column (row pitch W + 1), a strip computes
//    its 26 row offsets once (the zero row's outside the volume) and each
//    x-tap its column (the zero column's outside), so a load is one add (a
//    frame of 9 would cost 1.56× the ring at 32²; with a predicate on each
//    load the kernel took 1.07 ms there, with this layout 0.83, chip runs);
//  - shared memory is channel-planar ([c][row][col]); lanes run along x, and
//    where W < 32 across channels, the channel pitch ≡ W (mod 32) so that a
//    warp's loads hit 32 banks. The input is staged and the output stored
//    through it in 16-byte vectors along C where C % 4 = 0 (CT·4 contiguous
//    bytes per voxel), else one float per access.
// Grid: (bands, C / CT, B · 3 · z-runs); the band, the channel tile, the z
// split and the threads come from the caller's launch plan (ops/kernels.py
// chain3d_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kRing = 7;
constexpr int kR5 = 8;       // dw5 outputs per thread strip
constexpr int R7 = 8;        // dilated outputs per thread strip
constexpr int kPre = 4;      // staged items per thread held in registers
constexpr int kMaxThreads = 512;
constexpr int kSmemMax = 232448;

struct Plan {
  int B, D, H, W, C, CT, RB, nzc, rhp, ring_chan, in_chan, smem, threads;
};

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
dw_chain3d_kernel(const float* __restrict__ x, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ w7,
                  const float* __restrict__ b7, float* __restrict__ y, const Plan P) {
  extern __shared__ float smem[];
  const int D = P.D, H = P.H, W = P.W, C = P.C, CT = P.CT;
  float* ring = smem;                          // [7][CT][ring_chan]: rows from lo, pitch W + 1
  float* xin = smem + kRing * CT * P.ring_chan;  // [CT][in_chan]: rows from lo - 2, cols from -2
  float* out = xin;                            // [CT][in_chan]: RB rows of W, after dw7
  const int slot_pitch = CT * P.ring_chan;
  const int r0 = blockIdx.x * P.RB;
  const int c0 = blockIdx.y * CT;
  const int nzc = P.nzc;
  const int b = blockIdx.z / (3 * nzc);
  const int rz = (blockIdx.z / nzc) % 3;
  const int run = blockIdx.z % nzc;
  const int nz = ((D + 2) / 3 + nzc - 1) / nzc;  // outputs per run
  const int n_len = (D - rz + 2) / 3;            // outputs of this phase
  const int n_begin = run * nz, n_end = min(n_len, n_begin + nz);
  if (n_begin >= n_end) return;
  const int lo = max(0, r0 - 9), hi = min(H, r0 + P.RB + 9);
  const int rows_mid = hi - lo;                  // intermediate rows of the band
  const int rows_calc = max(rows_mid, kR5);      // computed (≤ rhp)
  const int rows_in = rows_calc + 4;
  const int rows_out = min(P.RB, H - r0);
  const int Wp = W + 4;
  const int RP = W + 1;  // ring row pitch: column W is zero, and so is row rhp
  const size_t vol = (size_t)D * H * W * C;
  const float* xb = x + (size_t)b * vol;
  float* yb = y + (size_t)b * vol;
  const int qn = CT / VEC;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;

  // planes m of this run: outputs n read m = n - 3 … n + 3 inside the volume
  const int m_first = max(0, n_begin - 3);
  const int m_last = min(n_end - 1 + 3, n_len - 1);

  // ---- staging of one input plane zi: items (pixel, channel group) ----
  const int n_in = rows_in * Wp * qn;
  float pre[kPre][VEC];
  auto fetch = [&](int i, int zi, float (&v)[VEC]) {
    const int cc = (i % qn) * VEC;
    const int p = i / qn;
    const int gx = p % Wp - 2, gy = lo - 2 + p / Wp;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + cc < C) {
      const float* src = xb + (((size_t)zi * H + gy) * W + gx) * C + c0 + cc;
      if constexpr (VEC == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
        v[0] = __ldg(src);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    }
  };
  auto put = [&](int i, const float (&v)[VEC]) {
    const int cc = (i % qn) * VEC;
    const int p = i / qn;
#pragma unroll
    for (int j = 0; j < VEC; ++j) xin[(cc + j) * P.in_chan + p] = v[j];
  };
  auto prefetch = [&](int zi) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int i = tid + u * nt;
      if (i < n_in) fetch(i, zi, pre[u]);
    }
  };
  auto stage = [&](int zi) {  // the prefetched items, then the rest
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int i = tid + u * nt;
      if (i < n_in) put(i, pre[u]);
    }
    for (int i = tid + kPre * nt; i < n_in; i += nt) {
      float v[VEC];
      fetch(i, zi, v);
      put(i, v);
    }
  };

  // the passes of dw5, in order: plane m, z-slice k (input plane rz + 3m + k - 2)
  auto valid_in = [&](int m, int k) {
    const int zi = rz + 3 * m + k - 2;
    return zi >= 0 && zi < D;
  };
  auto next_pass = [&](int& m, int& k) {  // false when none is left
    for (;;) {
      if (++k == 5) { k = 0; if (++m > m_last) return false; }
      if (valid_in(m, k)) return true;
    }
  };
  // the ring's zero row (rhp) and zero column (W), read wherever a dilated
  // tap falls outside the volume: loads without predicates
  for (int i = tid; i < kRing * CT * (P.rhp + RP); i += nt) {
    const int j = i % (P.rhp + RP), sc = i / (P.rhp + RP);
    ring[sc * P.ring_chan + (j < P.rhp ? j * RP + W : P.rhp * RP + j - P.rhp)] = 0.f;
  }

  int pm = m_first, pk = -1;
  bool have = next_pass(pm, pk);
  if (have) prefetch(rz + 3 * pm + pk - 2);

  // ---- dw5 pass: add z-slice k of plane m into its ring slot ----
  const int s5 = (rows_calc + kR5 - 1) / kR5;
  auto dw5_pass = [&](int m, int k, bool first, bool last) {
    float* slot = ring + (m % kRing) * slot_pitch;
    for (int it = tid; it < CT * s5 * W; it += nt) {
      const int xx = it % W, c = (it / W) % CT, s = it / (W * CT);
      if (c0 + c >= C) continue;
      // the last strip ends at the last row; rows an earlier strip owns are
      // not written twice (the passes add into the ring)
      const int m0 = min(s * kR5, rows_calc - kR5);
      const int own = s * kR5 - m0;
      const float* wk = w5 + (size_t)k * 25 * C + c0 + c;
      const float* xc = xin + c * P.in_chan + m0 * Wp + xx;
      float acc[kR5];
#pragma unroll
      for (int r = 0; r < kR5; ++r) acc[r] = 0.f;
#pragma unroll
      for (int bx = 0; bx < 5; ++bx) {
        float wr[5];  // the slice's column bx
#pragma unroll
        for (int a = 0; a < 5; ++a) wr[a] = __ldg(wk + (a * 5 + bx) * C);
#pragma unroll
        for (int i = 0; i < kR5 + 4; ++i) {
          const float v = xc[i * Wp + bx];
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            if (i - a >= 0 && i - a < kR5) acc[i - a] = fmaf(wr[a], v, acc[i - a]);
          }
        }
      }
      float* mc = slot + c * P.ring_chan + m0 * RP + xx;
      const float bias = last ? __ldg(b5 + c0 + c) : 0.f;
#pragma unroll
      for (int r = 0; r < kR5; ++r) {
        if (r < own) continue;
        const float prev = first ? 0.f : mc[r * RP];
        mc[r * RP] = prev + acc[r] + bias;
      }
    }
  };

  // ---- dw7 of output n into `out` ----
  const int s7 = (rows_out + R7 - 1) / R7;
  auto dw7 = [&](int n) {
    for (int it = tid; it < CT * s7 * W; it += nt) {
      const int xx = it % W, c = (it / W) % CT, s = it / (W * CT);
      if (c0 + c >= C) continue;
      const int o0 = rows_out >= R7 ? min(s * R7, rows_out - R7) : 0;
      const int own = s * R7 - o0;
      // the ring offsets of rows r0 + o0 - 9 + i, the zero row's outside the volume
      int roff[R7 + 18];
#pragma unroll
      for (int i = 0; i < R7 + 18; ++i) {
        const int row = r0 + o0 - 9 + i;
        roff[i] = (row >= 0 && row < H ? row - lo : P.rhp) * RP;
      }
      float acc[R7];
#pragma unroll
      for (int r = 0; r < R7; ++r) acc[r] = 0.f;
      for (int kz = 0; kz < 7; ++kz) {
        const int m = n + kz - 3;
        if (m < 0 || m >= n_len) continue;
        const float* wk = w7 + (size_t)kz * 49 * C + c0 + c;
        const float* sc = ring + (m % kRing) * slot_pitch + c * P.ring_chan;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const int col = xx + 3 * kx - 9;
          const float* mc = sc + (col >= 0 && col < W ? col : W);  // else the zero column
          float wr[7];  // the slice's column kx
#pragma unroll
          for (int ky = 0; ky < 7; ++ky) wr[ky] = __ldg(wk + (ky * 7 + kx) * C);
#pragma unroll
          for (int i = 0; i < R7 + 18; ++i) {
            const float v = mc[roff[i]];
#pragma unroll
            for (int ky = 0; ky < 7; ++ky) {
              if (i - 3 * ky >= 0 && i - 3 * ky < R7) {
                acc[i - 3 * ky] = fmaf(wr[ky], v, acc[i - 3 * ky]);
              }
            }
          }
        }
      }
      const float bias = __ldg(b7 + c0 + c);
      float* oc = out + c * P.in_chan + o0 * W + xx;
#pragma unroll
      for (int r = 0; r < R7; ++r) {
        if (r >= own) oc[r * W] = acc[r] + bias;
      }
    }
  };

  int next_m = m_first;  // next intermediate plane to compute
  for (int n = n_begin; n < n_end; ++n) {
    for (; next_m <= min(n + 3, m_last); ++next_m) {
      int k_first = 0, k_last = 4;
      while (!valid_in(next_m, k_first)) ++k_first;
      while (!valid_in(next_m, k_last)) --k_last;
      for (int k = k_first; k <= k_last; ++k) {
        __syncthreads();  // xin is free (last pass, or the last output's store)
        stage(rz + 3 * next_m + k - 2);
        __syncthreads();
        have = have && next_pass(pm, pk);
        if (have) prefetch(rz + 3 * pm + pk - 2);
        dw5_pass(next_m, k, k == k_first, k == k_last);
      }
    }
    __syncthreads();  // the ring holds planes n - 3 … n + 3
    dw7(n);
    __syncthreads();
    // store the band's rows of output n, channels-last
    const int zo = rz + 3 * n;
    for (int i = tid; i < rows_out * W * qn; i += nt) {
      const int cc = (i % qn) * VEC;
      if (c0 + cc >= C) continue;
      const int p = i / qn;
      const float* src = out + cc * P.in_chan + p;
      float* dst = yb + (((size_t)zo * H + r0) * W + p) * C + c0 + cc;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0], src[P.in_chan], src[2 * P.in_chan], src[3 * P.in_chan]);
      } else {
        *dst = *src;
      }
    }
  }
}

template <int VEC>
int launch(const float* x, const float* w5, const float* b5, const float* w7,
           const float* b7, float* y, const Plan& P, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_chain3d_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((P.H + P.RB - 1) / P.RB, (P.C + P.CT - 1) / P.CT, P.B * 3 * P.nzc);
  dw_chain3d_kernel<VEC><<<grid, P.threads, P.smem, stream>>>(x, w5, b5, w7, b7, y, P);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, w5, b5, w7, b7, y and the stream handle; plan: B, D,
// H, W, C, CT (channels per block, a power of two ≤ 32), RB (output rows per
// band), nzc (runs per z phase),
// rhp (ring rows per channel: at least 8 and every band's rows ± 9 inside
// the volume), ring_chan and in_chan (the channel pitches of the ring and of
// the staged plane, at least (rhp + 1)·(W + 1) and (rhp + 4)·(W + 4)), smem (the bytes
// the caller's plan computed, which must be this layout's), threads (a
// multiple of 32, ≤ 512); vec: 4 for 16-byte vectors along C (CT % 4 = 0,
// C % 4 = 0, x and y 16-byte aligned), else 1.
extern "C" int dlka_dw_chain3d(const unsigned long long* args, const int* plan, int vec) {
  Plan P;
  P.B = plan[0]; P.D = plan[1]; P.H = plan[2]; P.W = plan[3]; P.C = plan[4];
  P.CT = plan[5]; P.RB = plan[6]; P.nzc = plan[7]; P.rhp = plan[8];
  P.ring_chan = plan[9]; P.in_chan = plan[10]; P.smem = plan[11]; P.threads = plan[12];
  bool ok = P.CT > 0 && P.CT <= 32 && (P.CT & (P.CT - 1)) == 0 && P.RB > 0 &&
            P.nzc >= 1 && P.rhp >= kR5 &&
            (size_t)P.ring_chan >= (size_t)(P.rhp + 1) * (P.W + 1) &&
            (size_t)P.in_chan >= (size_t)(P.rhp + 4) * (P.W + 4) &&
            (size_t)P.in_chan >= (size_t)(P.RB > R7 ? P.RB : R7) * P.W &&
            P.threads >= 32 && P.threads <= kMaxThreads && P.threads % 32 == 0 &&
            (vec == 1 || vec == 4) && (vec == 1 || (P.CT % 4 == 0 && P.C % 4 == 0)) &&
            (size_t)P.smem == ((size_t)kRing * P.CT * P.ring_chan + (size_t)P.CT * P.in_chan) *
                                  sizeof(float) &&
            P.smem <= kSmemMax;
  for (int r0 = 0; ok && r0 < P.H; r0 += P.RB) {  // every band's rows fit the ring
    const int lo = r0 - 9 > 0 ? r0 - 9 : 0, hi = r0 + P.RB + 9 < P.H ? r0 + P.RB + 9 : P.H;
    ok = hi - lo <= P.rhp;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = reinterpret_cast<const float*>(args[i]);
  auto* y = reinterpret_cast<float*>(args[5]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[6]);
  return vec == 4 ? launch<4>(in[0], in[1], in[2], in[3], in[4], y, P, stream)
                  : launch<1>(in[0], in[1], in[2], in[3], in[4], y, P, stream);
}
