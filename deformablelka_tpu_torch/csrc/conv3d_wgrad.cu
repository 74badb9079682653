// Weight gradient of a dense 3D convolution (stride 1, dilation 1, groups
// 1, "same" padding k / 2, a cubic kernel of side k ∈ {1, 3}) for Hopper,
// in f32, channels-last. From x (B, D, H, W, Ci) and the cotangent g (B, D,
// H, W, Co) of the conv's output it computes
//   dW[co][ci][t] = Σ_v g(v, co) · x(v + t − k / 2, ci),   x zero outside,
// over the B·D·H·W voxels v and the k³ taps t, in torch's weight layout
// (Co, Ci, k, k, k). The forward, the data gradient and the bias gradient
// stay cuDNN's (ops/convs.py).
//
// Replaces no TPU kernel: the JAX package leaves the conv's gradient to
// XLA, and the port left it to cuDNN, whose f32 channels-last weight
// gradient ran the small-channel shapes at hundreds of times their bound:
// 64.8 device-ms for one 16 → 16 3³ conv at B=2, 64×128×128, whose bound
// is 0.43 ms and which this kernel computes in 1.45 (H100 80GB HBM3,
// 700 W; chip_smoke.py phase 26, where ops/convs.py's hand_wgrad_shape
// comes from).
//
// What bounds it: max(2·N·Ci·Co·k³ / 67 TFLOP/s, (|x| + |g|) / 3.35 TB/s),
// N = B·D·H·W. A GEMM of Co × Ci·k³ outputs over a reduction of N voxels:
// few outputs, a very deep reduction. The 3³ convs are bound by the f32
// FMA rate (16 → 16 at 2.1 M voxels: 29 GFLOP, 0.43 ms), the 1³ ones by
// their bytes. Single-pass TF32 is not an option (the model is trained in
// f32 with TF32 off), and 3xTF32 through mma.sync runs at about 40 TFLOP/s
// of f32 work on this card (csrc/deform3d_bwd.cu), below FFMA's 67; so the
// products are FFMAs. Its design:
//  - a block owns an output tile (`BCO` output channels × `BCI` input
//    channels × all k³ taps) and a part of the voxels: a run of bricks
//    (TZ, TY, TX) of single samples, taken one after another. For each
//    brick it stages x with its halo of k / 2 and g in shared memory,
//    channel-last, through 16-byte loads where the channels allow;
//  - a thread owns 4 output channels × TCI input channels (4, or 1 where
//    Ci % 4 ≠ 0) × one tap row (dz, dy) × the k taps along x: 4·TCI·k
//    accumulators in registers. It walks rows of the brick along x,
//    keeping the k columns of x its taps reach in registers, so each step
//    reads one new column of x and one voxel of g (two 16-byte shared loads
//    where TCI = 4) for 16·k FMAs. Neighbouring threads take neighbouring
//    input-channel groups, then output-channel groups, then tap rows, so
//    a warp's loads are mostly broadcasts;
//  - where a block has more threads than units (a unit: its channel groups
//    and tap row), the `VL` lanes of a unit split the brick's rows and add
//    their sums through shared memory, in a fixed order, at the end of the
//    part;
//  - each block writes its part's sums to scratch, and `conv3d_wgrad_sum`
//    adds the parts in a fixed order (a block writes dW itself where there
//    is one part). No float atomics: the result is bitwise repeatable.
// The tile, the brick and the parts come from the caller's launch plan
// (ops/kernels.py conv3d_wgrad_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kSmemMax = 232448;
constexpr int kSumThreads = 256;
constexpr int kSumGroups = 8;  // parts' groups in the sum: a block sums 32 outputs

struct Geo {
  int B, D, H, W, Ci, Co;
  int BCO, BCI;           // the block's output tile
  int TZ, TY, TX;         // the brick
  int P;                  // parts
  int threads;
  int nbz, nby, nbx;      // bricks per sample along each axis
  int HZ, HY, HX;         // staged x: the brick and its halo
  int units, VL;          // thread units of the tile, lanes a unit
};

template <int K, int TCI, int VX, int VG>
__global__ void __launch_bounds__(256, 2)
conv3d_wgrad_part(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ out, const Geo G) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = K / 2;
  constexpr int KKK = K * K * K;
  constexpr int ACC = 4 * TCI * K;
  const int BCI = G.BCI, BCO = G.BCO;
  float* xs = smem;                                    // [HZ][HY][HX][BCI]
  float* gs = xs + (G.HZ * G.HY * G.HX * BCI + 3) / 4 * 4;  // [TZ][TY][TX][BCO], 16-byte aligned
  const int tid = threadIdx.x, nt = G.threads;
  const int tiles_ci = (G.Ci + BCI - 1) / BCI;
  const int ci0 = blockIdx.y % tiles_ci * BCI, co0 = blockIdx.y / tiles_ci * BCO;
  const int p = blockIdx.x;
  const int per_sample = G.nbz * G.nby * G.nbx;
  const int nb = G.B * per_sample;
  const int brick_lo = (int)((long long)p * nb / G.P);
  const int brick_hi = (int)((long long)(p + 1) * nb / G.P);

  // this thread's unit: input-channel group, output-channel group, tap row
  const int nci = BCI / TCI, nco = BCO / 4;
  const int u = tid % G.units, lv = tid / G.units;
  const bool active = lv < G.VL;
  const int cig = u % nci, cog = u / nci % nco, t2 = u / (nci * nco);
  const int dz = t2 / K, dy = t2 % K;
  float acc[K][4][TCI];
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int i = 0; i < TCI; ++i) acc[a][o][i] = 0.f;

  for (int brick = brick_lo; brick < brick_hi; ++brick) {
    const int b = brick / per_sample, rem = brick % per_sample;
    const int z0 = rem / (G.nby * G.nbx) * G.TZ;
    const int y0 = rem / G.nbx % G.nby * G.TY;
    const int x0 = rem % G.nbx * G.TX;
    const size_t vbase = (size_t)b * G.D * G.H * G.W;
    __syncthreads();  // the previous brick's reads are done
    // ---- staging: x with its halo, g inside the brick, zero outside ----
    {
      const int nq = BCI / VX;
      const int n = G.HZ * G.HY * G.HX * nq;
      for (int i = tid; i < n; i += nt) {
        const int q = i % nq, v = i / nq;
        const int sx = v % G.HX, sy = v / G.HX % G.HY, sz = v / (G.HX * G.HY);
        const int zz = z0 - R + sz, yy = y0 - R + sy, xx = x0 - R + sx;
        const int c = ci0 + q * VX;
        const bool in = zz >= 0 && zz < G.D && yy >= 0 && yy < G.H && xx >= 0 && xx < G.W &&
                        c < G.Ci;
        const size_t at = (vbase + ((size_t)zz * G.H + yy) * G.W + xx) * G.Ci + c;
        float* dst = xs + v * BCI + q * VX;
        if constexpr (VX == 4) {
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) val = __ldg(reinterpret_cast<const float4*>(x + at));
          *reinterpret_cast<float4*>(dst) = val;
        } else {
          dst[0] = in ? __ldg(x + at) : 0.f;
        }
      }
    }
    {
      const int nq = BCO / VG;
      const int n = G.TZ * G.TY * G.TX * nq;
      for (int i = tid; i < n; i += nt) {
        const int q = i % nq, v = i / nq;
        const int lx = v % G.TX, ly = v / G.TX % G.TY, lz = v / (G.TX * G.TY);
        const int zz = z0 + lz, yy = y0 + ly, xx = x0 + lx;
        const int c = co0 + q * VG;
        const bool in = zz < G.D && yy < G.H && xx < G.W && c < G.Co;
        const size_t at = (vbase + ((size_t)zz * G.H + yy) * G.W + xx) * G.Co + c;
        float* dst = gs + v * BCO + q * VG;
        if constexpr (VG == 4) {
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) val = __ldg(reinterpret_cast<const float4*>(g + at));
          *reinterpret_cast<float4*>(dst) = val;
        } else {
          dst[0] = in ? __ldg(g + at) : 0.f;
        }
      }
    }
    __syncthreads();
    if (!active) continue;
    // ---- the tap sums: rows of the brick, lv, lv + VL, ... ----
    for (int r = lv; r < G.TZ * G.TY; r += G.VL) {
      const int lz = r / G.TY, ly = r % G.TY;
      const float* xr = xs + ((lz + dz) * G.HY + ly + dy) * G.HX * BCI + cig * TCI;
      const float* gr = gs + (lz * G.TY + ly) * G.TX * BCO + cog * 4;
      float xw[K][TCI];  // the columns lx … lx + K − 1 of x
#pragma unroll
      for (int a = 0; a < K - 1; ++a) {
        if constexpr (TCI == 4) {
          const float4 f = *reinterpret_cast<const float4*>(xr + a * BCI);
          xw[a][0] = f.x; xw[a][1] = f.y; xw[a][2] = f.z; xw[a][3] = f.w;
        } else {
          xw[a][0] = xr[a * BCI];
        }
      }
#pragma unroll 2
      for (int lx = 0; lx < G.TX; ++lx) {
        if constexpr (TCI == 4) {
          const float4 f = *reinterpret_cast<const float4*>(xr + (lx + K - 1) * BCI);
          xw[K - 1][0] = f.x; xw[K - 1][1] = f.y; xw[K - 1][2] = f.z; xw[K - 1][3] = f.w;
        } else {
          xw[K - 1][0] = xr[(lx + K - 1) * BCI];
        }
        const float4 gf = *reinterpret_cast<const float4*>(gr + lx * BCO);
        const float gv[4] = {gf.x, gf.y, gf.z, gf.w};
#pragma unroll
        for (int a = 0; a < K; ++a)
#pragma unroll
          for (int o = 0; o < 4; ++o)
#pragma unroll
            for (int i = 0; i < TCI; ++i) acc[a][o][i] = fmaf(gv[o], xw[a][i], acc[a][o][i]);
#pragma unroll
        for (int a = 0; a < K - 1; ++a)
#pragma unroll
          for (int i = 0; i < TCI; ++i) xw[a][i] = xw[a + 1][i];
      }
    }
  }

  // ---- the block's sums: its lanes added in order ----
  const size_t n_out = (size_t)G.Co * G.Ci * KKK;
  float* dst = out + (size_t)p * n_out;
  auto write = [&](int unit, int j, float v) {
    const int a = j / (4 * TCI), o = j / TCI % 4, i = j % TCI;
    const int ug = unit % nci, og = unit / nci % nco, row = unit / (nci * nco);
    const int co = co0 + og * 4 + o, ci = ci0 + ug * TCI + i;
    if (co < G.Co && ci < G.Ci) dst[((size_t)co * G.Ci + ci) * KKK + row * K + a] = v;
  };
  if (G.VL == 1) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < ACC; ++j) write(u, j, acc[j / (4 * TCI)][j / TCI % 4][j % TCI]);
    return;
  }
  __syncthreads();  // staging reads done: the buffer now holds the lanes' sums
  float* red = smem;  // [VL][units][ACC]
  if (active) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) red[(size_t)tid * ACC + j] = acc[j / (4 * TCI)][j / TCI % 4][j % TCI];
  }
  __syncthreads();
  for (int i = tid; i < G.units * ACC; i += nt) {
    float sum = red[i];
    for (int l = 1; l < G.VL; ++l) sum += red[(size_t)l * G.units * ACC + i];
    write(i / ACC, i % ACC, sum);
  }
}

// dW[i] = Σ_p part[p][i], in a fixed order: thread (i mod 32, group s)
// adds the parts p ≡ s (mod 8) in turn, then the 8 groups are added in
// order.
__global__ void __launch_bounds__(kSumThreads)
conv3d_wgrad_sum(const float* __restrict__ part, float* __restrict__ dw, long long n, int P) {
  __shared__ float red[kSumGroups][32];
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (i < n) {
    for (int q = s; q < P; q += kSumGroups) sum += part[(size_t)q * n + i];
  }
  red[s][lane] = sum;
  __syncthreads();
  if (s == 0 && i < n) {
    float total = red[0][lane];
#pragma unroll
    for (int q = 1; q < kSumGroups; ++q) total += red[q][lane];
    dw[i] = total;
  }
}

size_t smem_bytes(const Geo& G, int K) {
  const int tci = G.Ci % 4 == 0 ? 4 : 1;
  const size_t staged = ((size_t)G.HZ * G.HY * G.HX * G.BCI + 3) / 4 * 4 +
                        (size_t)G.TZ * G.TY * G.TX * G.BCO;
  const size_t red = G.VL > 1 ? (size_t)G.threads * 4 * tci * K : 0;
  return (staged > red ? staged : red) * sizeof(float);
}

template <int K, int TCI, int VX, int VG>
int launch(const float* x, const float* g, float* out, const Geo& G, size_t smem,
           cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(conv3d_wgrad_part<K, TCI, VX, VG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int tiles = ((G.Ci + G.BCI - 1) / G.BCI) * ((G.Co + G.BCO - 1) / G.BCO);
  conv3d_wgrad_part<K, TCI, VX, VG><<<dim3(G.P, tiles), G.threads, smem, stream>>>(x, g, out, G);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const float* x, const float* g, float* out, const Geo& G, size_t smem, int vec,
             cudaStream_t stream) {
  const bool vx = vec & 1, vg = vec & 2;
  if (G.Ci % 4 != 0) {
    return vg ? launch<K, 1, 1, 4>(x, g, out, G, smem, stream)
              : launch<K, 1, 1, 1>(x, g, out, G, smem, stream);
  }
  if (vx) {
    return vg ? launch<K, 4, 4, 4>(x, g, out, G, smem, stream)
              : launch<K, 4, 4, 1>(x, g, out, G, smem, stream);
  }
  return vg ? launch<K, 4, 1, 4>(x, g, out, G, smem, stream)
            : launch<K, 4, 1, 1>(x, g, out, G, smem, stream);
}

}  // namespace

// args: the pointers x (B, D, H, W, Ci), g (B, D, H, W, Co), part (the
// parts' sums, P × Co × Ci × k³ floats; unused where P = 1), dw (Co, Ci,
// k, k, k), then the stream handle. plan: B, D, H, W, Ci, Co, k, BCO, BCI,
// TZ, TY, TX, P, threads, units, VL and the shared memory bytes as the
// caller computed them (which must be this layout's). vec: bit 0 for
// 16-byte loads of x (Ci % 4 = 0, 16-byte aligned), bit 1 for g (Co % 4 =
// 0, aligned).
extern "C" int dlka_conv3d_wgrad(const unsigned long long* args, const int* plan, int vec) {
  Geo G;
  G.B = plan[0]; G.D = plan[1]; G.H = plan[2]; G.W = plan[3]; G.Ci = plan[4]; G.Co = plan[5];
  const int K = plan[6];
  G.BCO = plan[7]; G.BCI = plan[8]; G.TZ = plan[9]; G.TY = plan[10]; G.TX = plan[11];
  G.P = plan[12]; G.threads = plan[13]; G.units = plan[14]; G.VL = plan[15];
  const int tci = G.Ci % 4 == 0 ? 4 : 1;
  bool ok = (K == 1 || K == 3) && G.BCO % 4 == 0 && G.BCO > 0 && G.BCI % tci == 0 &&
            G.BCI > 0 && G.TZ > 0 && G.TY > 0 && G.TX > 0 && G.P > 0 && G.VL > 0 &&
            G.units == (G.BCO / 4) * (G.BCI / tci) * K * K && G.units * G.VL <= G.threads &&
            G.threads <= 256 && ((vec & 1) == 0 || G.Ci % 4 == 0) &&
            ((vec & 2) == 0 || G.Co % 4 == 0);
  G.nbz = (G.D + G.TZ - 1) / G.TZ; G.nby = (G.H + G.TY - 1) / G.TY;
  G.nbx = (G.W + G.TX - 1) / G.TX;
  G.HZ = G.TZ + K - 1; G.HY = G.TY + K - 1; G.HX = G.TX + K - 1;
  const size_t smem = smem_bytes(G, K);
  ok = ok && smem == (size_t)plan[16] && smem <= kSmemMax && G.P <= G.B * G.nbz * G.nby * G.nbx;
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* g = reinterpret_cast<const float*>(args[1]);
  auto* part = reinterpret_cast<float*>(args[2]);
  auto* dw = reinterpret_cast<float*>(args[3]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[4]);
  float* out = G.P == 1 ? dw : part;
  int err = K == 3 ? launch_k<3>(x, g, out, G, smem, vec, stream)
                   : launch_k<1>(x, g, out, G, smem, vec, stream);
  if (err || G.P == 1) return err;
  const long long n = (long long)G.Co * G.Ci * K * K * K;
  conv3d_wgrad_sum<<<(unsigned)((n + 31) / 32), kSumThreads, 0, stream>>>(part, dw, n, G.P);
  return (int)cudaGetLastError();
}
