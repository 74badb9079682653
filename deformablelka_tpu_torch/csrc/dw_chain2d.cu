// Fused 2D LKA chain for Hopper: dw5² (pad 2) + b5, zero outside the image,
// then dw7² dilation 3 (pad 9) + b7, in one launch. f32 in, out and
// accumulation; channels-last (B, H, W, C).
//
// Replaces the TPU kernel deformablelka_tpu/ops/pallas/lka_fused_kernel.py
// dw_chain2d_fused (:261) → _dw_chain2d (:190) → _chain2d_kernel (:117),
// which holds a row of W + 22 ≤ 128 lanes; this kernel has no such limit.
//
// What bounds it: 2·(25 + 49) = 148 FLOP per pixel-channel against 8 bytes
// moved, so the f32 FMA rate of the CUDA cores, as long as each FMA does not
// wait on its own loads. The first version (one output per thread, one
// weight load and one shared load per FMA, 8-byte strided global access at
// 56²) was bound by its load/store units and lost to cuDNN at every shape.
// This design:
//  - a block takes a band of RB output rows (RB a multiple of kR7) of CT
//    channels of one image; shared memory holds, channel-planar
//    ([c][row][col]), the band's input rows with the halo of 9 + 2 and zero
//    padding, and the dw5 plane of the band's rows ± 9 with a zero frame of
//    9, so neither stage tests bounds in its inner loops. Bands recompute
//    the dw5 rows of their halo; the wrapper's plan takes the whole plane
//    where it fits (ops/kernels.py chain2d_plan);
//  - each thread owns one channel, keeps its 25 + 49 weights and both
//    biases in registers, and computes vertical strips of outputs: kR5 = 8
//    dw5 values (each shared load of the 5 × 12 window feeds up to 5 FMAs:
//    60 loads for 200 FMAs) and kR7 = 14 dilated values (7 × 32 loads for
//    686 FMAs); the loops are fully unrolled, so the weights stay in
//    registers and the strips' accumulators are independent;
//  - lanes run along x in a channel plane, so shared loads are
//    conflict-free; dw5 strips wholly outside the image are written as zero
//    without being computed (the dilated stage's zero padding);
//  - the input is staged and the output stored through shared memory in
//    16-byte vectors along C where C % 4 = 0 (coalesced: CT·4 contiguous
//    bytes per pixel), else one float per access. The staging transposes
//    to channel-planar, so it goes through registers: cp.async copies
//    without rearranging and does not pay here.
// Shared memory per channel: (MRp + 4)·(W + 4) input floats (the channel
// pitch padded to 4 mod 8, against bank conflicts in the vector staging)
// and MRp·(W + 18) dw5 floats, MRp = RB + 18 rounded up to kR5; the
// result reuses the input's space. Grid: (ceil(H / RB), ceil(C / CT), B);
// up to 256 threads, as many per channel as give each about two dilated
// strips (the plan's `threads`: 128 at 14² and 28², 256 at 56²).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kR5 = 8;    // dw5 outputs per thread strip
constexpr int kR7 = 14;   // dilated outputs per thread strip
constexpr int kLoads = 4; // staging loads in flight per thread
constexpr int kSmemMax = 232448;

struct Layout {
  int mrp, in_rows, in_pitch, in_chan, mid_pitch, mid_chan;
};

__host__ __device__ inline Layout layout(int W, int RB) {
  Layout L;
  L.mrp = (RB + 18 + kR5 - 1) / kR5 * kR5;
  L.in_rows = L.mrp + 4;
  L.in_pitch = W + 4;
  L.in_chan = (L.in_rows * L.in_pitch + 7) / 8 * 8 + 4;
  L.mid_pitch = W + 18;
  L.mid_chan = L.mrp * L.mid_pitch;
  return L;
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw_chain2d_kernel(const float* __restrict__ x, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ w7,
                  const float* __restrict__ b7, float* __restrict__ y,
                  int H, int W, int C, int CT, int RB) {
  extern __shared__ float smem[];
  const Layout L = layout(W, RB);
  float* xin = smem;                   // [CT][in_rows][W+4], rows from r0-11, cols from -2
  float* mid = smem + CT * L.in_chan;  // [CT][mrp][W+18], rows from r0-9, cols from -9
  float* out = xin;                    // [CT][RB][W], after the dw5 stage
  const int r0 = blockIdx.x * RB;
  const int c0 = blockIdx.y * CT;
  const size_t img = (size_t)H * W * C;
  const float* xb = x + (size_t)blockIdx.z * img;
  float* yb = y + (size_t)blockIdx.z * img;
  const int qn = CT / VEC;
  const int nt = blockDim.x;

  // 1. stage the input rows, channel-planar, zero outside the image; kLoads
  // items per thread at a time, their loads issued before their stores so
  // that they wait on the memory together
  const int n_in = L.in_rows * L.in_pitch * qn;
  for (int i0 = threadIdx.x; i0 < n_in; i0 += kLoads * nt) {
    float v[kLoads][VEC];
    int dst[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * nt;
      const int cc = (i % qn) * VEC;
      const int p = i / qn;
      const int col = p % L.in_pitch, row = p / L.in_pitch;
      const int gy = r0 - 11 + row, gx = col - 2;
      dst[u] = i < n_in ? cc * L.in_chan + row * L.in_pitch + col : -1;
      if (i < n_in && gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + cc < C) {
        const float* src = xb + ((size_t)gy * W + gx) * C + c0 + cc;
        if constexpr (VEC == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src));
          v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
        } else {
          v[u][0] = __ldg(src);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (dst[u] < 0) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) xin[dst[u] + j * L.in_chan] = v[u][j];
    }
  }
  // the dw5 plane's zero frame: 9 columns on each side
  for (int i = threadIdx.x; i < CT * L.mrp * 18; i += nt) {
    const int k = i % 18, r = (i / 18) % L.mrp, c = i / (18 * L.mrp);
    mid[c * L.mid_chan + r * L.mid_pitch + (k < 9 ? k : W + k)] = 0.f;
  }

  // each thread: one channel, its weights in registers
  const int tpc = nt / CT;
  const int c = threadIdx.x / tpc, j0 = threadIdx.x % tpc;
  const bool active = c0 + c < C;
  float w5r[25], w7r[49];
#pragma unroll
  for (int k = 0; k < 25; ++k) w5r[k] = active ? __ldg(w5 + k * C + c0 + c) : 0.f;
#pragma unroll
  for (int k = 0; k < 49; ++k) w7r[k] = active ? __ldg(w7 + k * C + c0 + c) : 0.f;
  const float b5r = active ? __ldg(b5 + c0 + c) : 0.f;
  const float b7r = active ? __ldg(b7 + c0 + c) : 0.f;
  __syncthreads();

  // 2. dw5 on rows r0-9 .. r0-9+mrp-1, strips of kR5 rows
  if (active) {
    for (int it = j0; it < (L.mrp / kR5) * W; it += tpc) {
      const int xx = it % W, m0 = (it / W) * kR5;
      const int g0 = r0 - 9 + m0;
      float* mc = mid + c * L.mid_chan + m0 * L.mid_pitch + xx + 9;
      if (g0 + kR5 <= 0 || g0 >= H) {
#pragma unroll
        for (int r = 0; r < kR5; ++r) mc[r * L.mid_pitch] = 0.f;
        continue;
      }
      const float* xc = xin + c * L.in_chan + m0 * L.in_pitch + xx;
      float acc[kR5];
#pragma unroll
      for (int r = 0; r < kR5; ++r) acc[r] = 0.f;
#pragma unroll
      for (int b = 0; b < 5; ++b) {
#pragma unroll
        for (int i = 0; i < kR5 + 4; ++i) {
          const float v = xc[i * L.in_pitch + b];
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            if (i - a >= 0 && i - a < kR5) acc[i - a] = fmaf(w5r[a * 5 + b], v, acc[i - a]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR5; ++r) {
        mc[r * L.mid_pitch] = (g0 + r >= 0 && g0 + r < H) ? acc[r] + b5r : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. dw7 dilation 3 on rows r0 .. r0+RB-1, strips of kR7 rows, into `out`
  if (active) {
    for (int it = j0; it < (RB / kR7) * W; it += tpc) {
      const int xx = it % W, o0 = (it / W) * kR7;
      if (r0 + o0 >= H) continue;
      const float* mc = mid + c * L.mid_chan + o0 * L.mid_pitch + xx;
      float acc[kR7];
#pragma unroll
      for (int r = 0; r < kR7; ++r) acc[r] = 0.f;
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
        for (int i = 0; i < kR7 + 18; ++i) {
          const float v = mc[i * L.mid_pitch + 3 * kx];
#pragma unroll
          for (int ky = 0; ky < 7; ++ky) {
            if (i - 3 * ky >= 0 && i - 3 * ky < kR7) {
              acc[i - 3 * ky] = fmaf(w7r[ky * 7 + kx], v, acc[i - 3 * ky]);
            }
          }
        }
      }
      float* oc = out + c * L.in_chan + o0 * W + xx;
#pragma unroll
      for (int r = 0; r < kR7; ++r) oc[r * W] = acc[r] + b7r;
    }
  }
  __syncthreads();

  // 4. store the band's rows inside the image, channels-last
  const int rows = min(RB, H - r0);
  for (int i = threadIdx.x; i < rows * W * qn; i += nt) {
    const int cc = (i % qn) * VEC;
    if (c0 + cc >= C) continue;
    const int p = i / qn;
    const float* src = out + cc * L.in_chan + p;
    float* dst = yb + ((size_t)r0 * W + p) * C + c0 + cc;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(src[0], src[L.in_chan], src[2 * L.in_chan], src[3 * L.in_chan]);
    } else {
      *dst = *src;
    }
  }
}

template <int VEC>
int launch(const float* x, const float* w5, const float* b5, const float* w7,
           const float* b7, float* y, const int* p, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute once per instance, not per launch
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_chain2d_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int B = p[0], H = p[1], W = p[2], C = p[3], CT = p[4], RB = p[5], smem = p[6],
            threads = p[7];
  const dim3 grid((H + RB - 1) / RB, (C + CT - 1) / CT, B);
  dw_chain2d_kernel<VEC><<<grid, threads, smem, stream>>>(x, w5, b5, w7, b7, y, H,
                                                         W, C, CT, RB);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, w5, b5, w7, b7, y and the stream handle; plan: B, H,
// W, C, CT (channels per block, a power of two ≤ 32), RB (output rows per
// block, a multiple of 14), smem (the bytes the caller's plan computed,
// which must be this layout's), threads (a power of two, CT ≤ threads ≤
// 256); vec: 4 for 16-byte vectors along C (CT % 4 = 0, C % 4 = 0, x
// 16-byte aligned), else 1. Two arrays and an int, so that the caller's
// foreign-function call converts three arguments, not fifteen.
extern "C" int dlka_dw_chain2d(const unsigned long long* args, const int* plan, int vec) {
  const int W = plan[2], C = plan[3], CT = plan[4], RB = plan[5], smem = plan[6],
            threads = plan[7];
  const Layout L = layout(W, RB);
  if (CT <= 0 || CT > 32 || (CT & (CT - 1)) != 0 || RB <= 0 || RB % kR7 != 0 ||
      threads < CT || threads > kMaxThreads || (threads & (threads - 1)) != 0 ||
      (vec != 1 && vec != 4) || (vec == 4 && (CT % 4 != 0 || C % 4 != 0)) ||
      (size_t)smem != (size_t)CT * (L.in_chan + L.mid_chan) * sizeof(float) ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = reinterpret_cast<const float*>(args[i]);
  auto* y = reinterpret_cast<float*>(args[5]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[6]);
  return vec == 4 ? launch<4>(in[0], in[1], in[2], in[3], in[4], y, plan, stream)
                  : launch<1>(in[0], in[1], in[2], in[3], in[4], y, plan, stream);
}
