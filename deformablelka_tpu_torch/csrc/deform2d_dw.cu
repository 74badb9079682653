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
// What bounds it: per output value and tap, 4 corner loads and 9 FLOP
// against 4·(2 + 2k²/C) bytes of device memory per output value, so
// operations at the decoder's widths (f32 on the CUDA cores); the corner
// loads come from L1/L2. A chip ablation of the first version (a block of
// 16 pixels of a row × 32 channels, scalar loads, the corner table rebuilt
// for every 32-channel slice) found the corner loads 64 % of its time
// (0.50 of 0.78 ms at 56²×96, k7 dil 3, B=24) and the offsets' loads under
// 2 % (H100 80GB HBM3, 700 W): what pays is fewer load instructions and
// more reuse of each corner on chip.
// Design:
//  - A block owns a 2D tile of pixels (`th` rows × `tw` columns of one
//    image, 32 pixels, so that the tile's samples share corners in L1) and
//    a run of its channels (all of them, or a part where the tiles alone
//    leave SMs idle). It builds the tile's corner table once (a 16-byte
//    record per pixel and tap: the first corner's clamped index, which
//    corners lie inside the image, dy and dx; each thread forms the 4
//    indices and weights from it) and walks its channels over it in
//    32-channel chunks, each chunk's k² tap weights staged beside it.
//  - A thread takes one (pixel, 4 channels) output of a chunk (channels
//    fastest, so a warp's corner loads are whole 128-byte lines) and sums
//    the taps' blends in registers with 16-byte loads along C (a scalar
//    path, one channel a thread, for C % 4 ≠ 0 or unaligned tensors).
//  - The corner loads stay the cost (more than half the time at the k7
//    sites, a chip ablation): half the SM's memory is asked for as L1.
// The tile, the channel parts and the grid come from the caller's launch
// plan (ops/kernels.py deform2d_dw_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // channels a pass over the tile's pixels
constexpr int kSmemMax = 232448;

struct Shape {
  int B, H, W, C, k, dil;
  int th, tw;               // the tile's rows and columns
  int tiles_y, tiles_x;
  int c_per_part;           // channels a block, a multiple of kChunk
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
deform_dw_conv2d_kernel(const float* __restrict__ x, const float* __restrict__ off,
                        const float* __restrict__ w, float* __restrict__ y, const Shape S) {
  extern __shared__ __align__(16) float smem[];
  const int H = S.H, W = S.W, C = S.C, k = S.k;
  const int K = k * k;
  const int TP = S.th * S.tw;
  // the corner table, entry p·K + tap: the sample's first corner (y0, x0)
  // clamped into the image as a pixel index, bits 0-1 whether its second
  // row and column differ from the first after the clamp, bits 2-5 which
  // of y0, y0 + 1, x0, x0 + 1 lie inside the image, then dy and dx
  int4* s_tab = reinterpret_cast<int4*>(smem);             // [TP][K]
  float* s_w = reinterpret_cast<float*>(s_tab + TP * K);    // [K][32]: the chunk's weights

  int t = blockIdx.x;
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

  const float* xb = x + (size_t)b * H * W * C;
  const int c_begin = blockIdx.y * S.c_per_part;
  const int c_end = min(C, c_begin + S.c_per_part);
  constexpr int kLanes = kChunk / VEC;  // threads across a chunk's channels
  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    if (c0 > c_begin) __syncthreads();  // the previous chunk is done with s_w
    for (int i = threadIdx.x; i < K * kChunk; i += kThreads) {
      const int c = c0 + (i & (kChunk - 1));
      s_w[i] = c < c_end ? __ldg(w + (size_t)(i / kChunk) * C + c) : 0.f;
    }
    __syncthreads();  // the table (first chunk) and the weights are complete
    for (int i = threadIdx.x; i < TP * kLanes; i += kThreads) {
      const int p = i / kLanes, c = c0 + (i % kLanes) * VEC;
      const int yy = y0t + p / S.tw, xx = x0t + p % S.tw;
      if (yy >= H || xx >= W || c >= c_end) continue;
      const int4* tab = s_tab + p * K;
      // a corner's pixel index and its bilinear weight (zero outside the image)
      auto corners = [&](const int4 e, int (&q)[4], float (&a)[4]) {
        const float dy = __int_as_float(e.z), dx = __int_as_float(e.w);
        const float wy0 = (e.y & 4) ? 1.f - dy : 0.f, wy1 = (e.y & 8) ? dy : 0.f;
        const float wx0 = (e.y & 16) ? 1.f - dx : 0.f, wx1 = (e.y & 32) ? dx : 0.f;
        const int dr = (e.y & 1) ? W : 0, dc = (e.y >> 1) & 1;
        q[0] = e.x;
        q[1] = e.x + dc;
        q[2] = e.x + dr;
        q[3] = e.x + dr + dc;
        a[0] = wy0 * wx0;
        a[1] = wy0 * wx1;
        a[2] = wy1 * wx0;
        a[3] = wy1 * wx1;
      };
      float* out = y + ((size_t)(b * H + yy) * W + xx) * C + c;
      if constexpr (VEC == 4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int tap = 0; tap < K; ++tap) {
          int qv[4];
          float av[4];
          corners(tab[tap], qv, av);
          const int4 q = make_int4(qv[0], qv[1], qv[2], qv[3]);
          const float4 a = make_float4(av[0], av[1], av[2], av[3]);
          const float4 v0 = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q.x * C + c));
          const float4 v1 = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q.y * C + c));
          const float4 v2 = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q.z * C + c));
          const float4 v3 = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q.w * C + c));
          const float4 wv = *reinterpret_cast<const float4*>(s_w + tap * kChunk + c - c0);
          float4 s;
          s.x = fmaf(a.w, v3.x, fmaf(a.z, v2.x, fmaf(a.y, v1.x, a.x * v0.x)));
          s.y = fmaf(a.w, v3.y, fmaf(a.z, v2.y, fmaf(a.y, v1.y, a.x * v0.y)));
          s.z = fmaf(a.w, v3.z, fmaf(a.z, v2.z, fmaf(a.y, v1.z, a.x * v0.z)));
          s.w = fmaf(a.w, v3.w, fmaf(a.z, v2.w, fmaf(a.y, v1.w, a.x * v0.w)));
          acc.x = fmaf(wv.x, s.x, acc.x);
          acc.y = fmaf(wv.y, s.y, acc.y);
          acc.z = fmaf(wv.z, s.z, acc.z);
          acc.w = fmaf(wv.w, s.w, acc.w);
        }
        *reinterpret_cast<float4*>(out) = acc;
      } else {
        float acc = 0.f;
#pragma unroll 4
        for (int tap = 0; tap < K; ++tap) {
          int qv[4];
          float av[4];
          corners(tab[tap], qv, av);
          const int4 q = make_int4(qv[0], qv[1], qv[2], qv[3]);
          const float4 a = make_float4(av[0], av[1], av[2], av[3]);
          float s = a.x * __ldg(xb + (size_t)q.x * C + c);
          s = fmaf(a.y, __ldg(xb + (size_t)q.y * C + c), s);
          s = fmaf(a.z, __ldg(xb + (size_t)q.z * C + c), s);
          s = fmaf(a.w, __ldg(xb + (size_t)q.w * C + c), s);
          acc = fmaf(s_w[tap * kChunk + c - c0], s, acc);
        }
        *out = acc;
      }
    }
  }
}

template <int VEC>
int launch(const float* x, const float* off, const float* w, float* y, const Shape& S,
           dim3 grid, int smem, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        deform_dw_conv2d_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    // half the SM's unified memory as shared memory, the rest L1 for the
    // corners: at k 7 fewer blocks per SM; at B=24 faster at 56²×96 k7 (0.379
    // against 0.390 ms with no preference), slower at 28²×192 k7 (0.242
    // against 0.235), within 2 % at the other sites (kernel_ablation.py,
    // H100 80GB HBM3, 700 W)
    err = cudaFuncSetAttribute(deform_dw_conv2d_kernel<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 50);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  deform_dw_conv2d_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, off, w, y, S);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, off, w, y and the stream handle; plan: B, H, W, C,
// k, dil, th, tw (th · tw pixels a tile), the channels a block (a multiple
// of 32), smem (the bytes the caller's plan computed: k² · (th · tw · 16 +
// 128), the corner table and a chunk's weights);
// vec: 4 for 16-byte accesses along C (C % 4 = 0, x and w 16-byte
// aligned), else 1. One launch.
extern "C" int dlka_deform_dw_conv2d(const unsigned long long* args, const int* plan,
                                     int vec) {
  Shape S;
  S.B = plan[0]; S.H = plan[1]; S.W = plan[2]; S.C = plan[3]; S.k = plan[4]; S.dil = plan[5];
  S.th = plan[6]; S.tw = plan[7];
  S.c_per_part = plan[8];
  const int smem = plan[9];
  if (S.k <= 0 || S.k % 2 == 0 || S.dil < 1 || S.th < 1 || S.tw < 1 ||
      S.c_per_part < kChunk || S.c_per_part % kChunk != 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && S.C % 4 != 0) ||
      (long long)smem != (long long)S.k * S.k * (S.th * S.tw * 16 + kChunk * 4) ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  S.tiles_y = (S.H + S.th - 1) / S.th;
  S.tiles_x = (S.W + S.tw - 1) / S.tw;
  const dim3 grid(S.B * S.tiles_y * S.tiles_x, (S.C + S.c_per_part - 1) / S.c_per_part);
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* off = reinterpret_cast<const float*>(args[1]);
  const auto* w = reinterpret_cast<const float*>(args[2]);
  auto* y = reinterpret_cast<float*>(args[3]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[4]);
  return vec == 4 ? launch<4>(x, off, w, y, S, grid, smem, stream)
                  : launch<1>(x, off, w, y, S, grid, smem, stream);
}
