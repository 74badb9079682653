// Backward of the exact 3x3x3 deformable convolution of deform3d.cu (stride 1,
// pad 1, dilation 1, groups 1, D3D semantics, no clip of Δ) for Hopper. Given
// the cotangent g (B, D, H, W, Co) it computes
//   dx   (B, D, H, W, Ci) : col2im scatter of the 8 corner weights × dsamp_k;
//   doff (B, D, H, W, 81) : Σ_c dsamp_k[c] · ∂sample_k[c]/∂Δ, 3 per tap, from
//                           the corner differences;
//   dw   (27, Ci, Co)     : Σ_p samp_k(p)ᵀ g(p), samp_k the forward's sample;
// where dsamp_k = g · w_kᵀ. dx must be zero on entry, and doff too where Ci
// is over one 32-channel chunk. The bias gradient (Σ g) is left to the
// caller.
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
// dx on per-tile padded canvases.
//
// What bounds it: 4·27·Ci·Co FLOP per voxel for the two channel mixes
// (dsamp and dw) plus 27·(48·Ci + 48) for the sample's blend, the dx
// scatter and the offset gradient (each corner's dot dsamp·x, scaled by
// the three weight derivatives), against (Ci + 81 + Co)·4 bytes read and
// (Ci + 81)·4 written: operations, f32. A chip ablation of the first
// version (two launches: a data launch of one tap per block with scalar dx
// atomics, a weight launch that gathered the samples again per tile) found
// the dx atomics (0.39 of 1.71 ms at 32³×32, B=2, H100 80GB HBM3, 700 W),
// the corner loads beside them (0.34) and the weight launch's tables and
// barriers (0.32 of its 0.58) ahead of the channel mixes (0.09 and 0.14),
// so the mixes stay on the CUDA cores in f32 (3xTF32 through mma.sync runs
// at about 40 TFLOP/s of f32 work on this card, below the 67 of FFMA) and
// the design goes after the scatter and the second gather.
//
// Design, three kernels in one call:
// 1. data: a block owns a brick of 64 voxels (4×4×4 where the volume
//    allows), 32 input channels and a group of taps (the fewest of 1, 3,
//    9, 27 groups that give eight blocks per SM), all from the caller's
//    plan; two blocks per SM (128 registers: three, at 80 with spills,
//    measured slower). Per tap: the 8 corners of each voxel's sample in a
//    table (built by one thread per voxel, its offsets fetched a tap
//    ahead); dsamp = g · w_kᵀ for the 32 channels (register tiles, g and
//    w_k staged 32 output channels at a time, each chunk fetched into
//    registers one step ahead); then each corner is loaded once and
//    serves three things: the dx scatter, the offset gradient (reduced
//    across the voxel's lanes; atomics into doff where several channel
//    chunks add to it) and the sample, written out as samp_k (27 × voxels
//    × Ci floats of scratch). Where Ci % 4 = 0 a lane takes 4 channels of
//    one voxel (a warp 4 voxels): 16-byte corner loads and 16-byte global
//    atomics into dx (L2 holds dx at these sizes); else one channel, a
//    warp one voxel. No canvas: a dx canvas in shared memory over the
//    brick ± 2 voxels (a block walking all its taps over it, flushed once
//    with 16-byte atomics) lost on the chip wherever it was tried: its
//    scalar shared atomics cost more than the 16-byte global ones they
//    saved (B=2, 8³×128: 0.256 ms with it, 0.133 without; 4³×256: 0.093
//    and 0.078), and at 32³ its 64 KB kept the blocks to two per SM.
// 2. weight: dw_k = samp_kᵀ · g, a plain GEMM over the voxels: tiles of
//    32×32 (Ci, Co ≤ 32) or 64×64 outputs, 4×4 a thread, 32 voxels a step;
//    the voxels cut into `parts` where the tiles alone leave SMs idle.
// 3. sum: dw = Σ_parts in a fixed order (dw does not change from run to run).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;     // data kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;         // voxels per brick
constexpr int kChunk = 32;        // input channels per data block
constexpr int kTaps = 27;
constexpr int kPitch = kChunk + 1;  // odd pitch of the g tile
constexpr int kDPitch = kChunk + 4; // dsamp's rows: 16-byte accesses along ci
constexpr int kWPitch = kChunk + 4; // w_kᵀ's rows: 16-byte reads along ci
constexpr int kBatch = 2;         // voxels a warp loads the corners of at once (scalar path)
constexpr int kStep = 32;         // voxels per step of the weight GEMM

// Shared memory of the data kernel, in 4-byte words: g chunk [64][33], w_kᵀ
// chunk [32][36], dsamp [64][36], the corner table [8][64] × (index, weight,
// pad, pad) and [8][64] × (three weight derivatives, pad), the rows' voxels.
constexpr int kDataSmemWords =
    kRows * kPitch + kChunk * kWPitch + kRows * kDPitch + 2 * kRows * 8 * 4 + kRows;
static_assert(kDataSmemWords * sizeof(float) <= 48 * 1024,
              "the data kernel's static shared memory must fit 48 KB");

struct Shape {
  int B, D, H, W, Ci, Co;
  int lz, ly, lx;                   // log2 of the brick's sides
  int tiles_z, tiles_y, tiles_x;
  int taps_per_group;
};

template <int VEC>
__global__ void __launch_bounds__(kThreads, 2)
deform_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ off,
                       const float* __restrict__ w, const float* __restrict__ g,
                       float* __restrict__ dx, float* __restrict__ doff,
                       float* __restrict__ samp, const Shape S) {
  __shared__ __align__(16) float smem[kDataSmemWords];
  float* s_g = smem;                                  // [64][33]: g[voxel][co chunk]
  float* s_w = s_g + kRows * kPitch;                  // [32][36]: w_k[co chunk][ci]
  float* s_ds = s_w + kChunk * kWPitch;               // [64][36]: dsamp[voxel][ci]
  int4* t_idx = reinterpret_cast<int4*>(s_ds + kRows * kDPitch);  // [8][64]
  float4* t_grad = reinterpret_cast<float4*>(t_idx + kRows * 8);   // [8][64]
  int* s_vox = reinterpret_cast<int*>(t_grad + kRows * 8);        // [64]

  const int D = S.D, H = S.H, W = S.W, Ci = S.Ci, Co = S.Co;
  const int n_vox = S.B * D * H * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this block's brick: blockIdx.x = ((b·tiles_z + tz)·tiles_y + ty)·tiles_x + tx
  int t = blockIdx.x;
  const int btx = t % S.tiles_x; t /= S.tiles_x;
  const int bty = t % S.tiles_y; t /= S.tiles_y;
  const int btz = t % S.tiles_z;
  const int bb = t / S.tiles_z;
  const int oz = btz << S.lz, oy = bty << S.ly, ox = btx << S.lx;
  const int ci0 = blockIdx.y * kChunk;
  const int k_begin = blockIdx.z * S.taps_per_group;
  const int k_end = min(kTaps, k_begin + S.taps_per_group);

  const int lxy = S.lx + S.ly;
  auto row_voxel = [&](int m, int& z, int& yy, int& xx) {
    xx = ox + (m & ((1 << S.lx) - 1));
    yy = oy + ((m >> S.lx) & ((1 << S.ly) - 1));
    z = oz + (m >> lxy);
    return (m >> (lxy + S.lz)) == 0 && z < D && yy < H && xx < W
               ? ((bb * D + z) * H + yy) * W + xx : -1;
  };
  // thread tid < 64 builds row tid's corner tables; its offsets are
  // fetched a tap ahead
  int vz = 0, vy = 0, vx = 0, my_vox = -1;
  float o_next[3] = {0.f, 0.f, 0.f};
  auto fetch_offsets = [&](int k) {
    if (my_vox < 0) return;
    const float* o = off + (size_t)my_vox * (3 * kTaps) + 3 * k;
    o_next[0] = __ldg(o + 0);
    o_next[1] = __ldg(o + 1);
    o_next[2] = __ldg(o + 2);
  };
  if (tid < kRows) {
    my_vox = row_voxel(tid, vz, vy, vx);
    s_vox[tid] = my_vox;
    fetch_offsets(k_begin);
  }

  // the channel mix's operands, fetched into registers one chunk ahead:
  // g[64 voxels][32 co] (8 a thread; only once where Co ≤ 32) and
  // w_k[32 ci][32 co] (4 a thread)
  const int co_chunks = (Co + kChunk - 1) / kChunk;
  float g_pre[kRows * kChunk / kThreads], w_pre[kChunk * kChunk / kThreads];
  auto fetch_mix = [&](int k, int cc) {
    const int co = cc * kChunk + (tid & 31);
    if (co_chunks > 1 || k == k_begin) {
#pragma unroll
      for (int r = 0; r < kRows * kChunk / kThreads; ++r) {
        int z, yy, xx;
        const int vox = row_voxel((tid >> 5) + r * kWarps, z, yy, xx);
        g_pre[r] = vox >= 0 && co < Co ? __ldg(g + (size_t)vox * Co + co) : 0.f;
      }
    }
    const float* wk = w + ((size_t)k * Ci + ci0) * Co;
#pragma unroll
    for (int r = 0; r < kChunk * kChunk / kThreads; ++r) {
      const int ci = (tid >> 5) + r * kWarps;
      w_pre[r] = ci0 + ci < Ci && co < Co ? __ldg(wk + (size_t)ci * Co + co) : 0.f;
    }
  };
  fetch_mix(k_begin, 0);

  // dsamp's register tile: voxels 2·tm and 2·tm + 1, channels 4·tc … 4·tc + 3
  const int tm = tid >> 3, tc = tid & 7;

  for (int k = k_begin; k < k_end; ++k) {
    __syncthreads();  // the previous tap's scatter is done with the tables
    // the corner table of tap k: entry m·8 + c is corner c of row m's sample
    if (tid < kRows) {
      const int kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
      // the clamp keeps the int conversion defined; a sample clamped here
      // has all its corners outside the volume either way
      const float zs = fminf(fmaxf((float)(vz - 1 + kz) + o_next[0], -2.f), (float)D + 1.f);
      const float ys = fminf(fmaxf((float)(vy - 1 + ky) + o_next[1], -2.f), (float)H + 1.f);
      const float xs = fminf(fmaxf((float)(vx - 1 + kx) + o_next[2], -2.f), (float)W + 1.f);
      const float z0 = floorf(zs), y0 = floorf(ys), x0 = floorf(xs);
      const float dz = zs - z0, dy = ys - y0, dxf = xs - x0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int pz = c >> 2, py = (c >> 1) & 1, px = c & 1;
        const int zi = (int)z0 + pz, yi = (int)y0 + py, xi = (int)x0 + px;
        int4 id = make_int4(-1, 0, 0, 0);
        float4 gr = make_float4(0.f, 0.f, 0.f, 0.f);
        if (my_vox >= 0 && zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W) {
          const float wz = pz ? dz : 1.f - dz;
          const float wy = py ? dy : 1.f - dy;
          const float wx = px ? dxf : 1.f - dxf;
          id = make_int4(((bb * D + zi) * H + yi) * W + xi, __float_as_int((wz * wy) * wx), 0,
                         0);
          gr = make_float4((pz ? 1.f : -1.f) * (wy * wx), (py ? 1.f : -1.f) * (wz * wx),
                           (px ? 1.f : -1.f) * (wz * wy), 0.f);
        }
        t_idx[c * kRows + tid] = id;
        t_grad[c * kRows + tid] = gr;
      }
      if (k + 1 < k_end) fetch_offsets(k + 1);
    }

    // dsamp[m][ci] = Σ_co g[m][co] · w_k[ci0 + ci][co], 32 co at a time
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int cc = 0; cc < co_chunks; ++cc) {
      if (cc > 0) __syncthreads();  // the previous chunk's products are done
      if (co_chunks > 1 || k == k_begin) {
#pragma unroll
        for (int r = 0; r < kRows * kChunk / kThreads; ++r) {
          s_g[((tid >> 5) + r * kWarps) * kPitch + (tid & 31)] = g_pre[r];
        }
      }
#pragma unroll
      for (int r = 0; r < kChunk * kChunk / kThreads; ++r) {
        s_w[(tid & 31) * kWPitch + (tid >> 5) + r * kWarps] = w_pre[r];
      }
      __syncthreads();
      if (cc + 1 < co_chunks) {
        fetch_mix(k, cc + 1);
      } else if (k + 1 < k_end) {
        fetch_mix(k + 1, 0);
      }
#pragma unroll 8
      for (int co = 0; co < kChunk; ++co) {
        const float a0 = s_g[(2 * tm) * kPitch + co];
        const float a1 = s_g[(2 * tm + 1) * kPitch + co];
        const float4 b = *reinterpret_cast<const float4*>(s_w + co * kWPitch + 4 * tc);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(a0, bv[j], acc[0][j]);
          acc[1][j] = fmaf(a1, bv[j], acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float4*>(s_ds + (2 * tm + r) * kDPitch + 4 * tc) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();  // the table and dsamp are complete

    float* samp_k = samp + (size_t)k * n_vox * Ci;
    if constexpr (VEC == 4) {
      // a warp takes its 8 voxels 4 at a time, a lane one voxel's 4
      // channels (8 lanes a voxel): each corner loaded once, 16 bytes a
      // lane, for the dx scatter, the offset gradient and the sample
      const int sub = lane >> 3, cq = ci0 + 4 * (lane & 7);
      const bool has_q = cq < Ci;  // Ci % 4 = 0: a quad is whole or absent
#pragma unroll
      for (int grp = 0; grp < kRows / kWarps / 4; ++grp) {
        const int m = warp * (kRows / kWarps) + 4 * grp + sub;
        float4 xv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int gi = t_idx[c * kRows + m].x;
          xv[c] = gi >= 0 && has_q
                      ? __ldg(reinterpret_cast<const float4*>(x + (size_t)gi * Ci + cq))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const int vox = s_vox[m];
        const float4 ds = *reinterpret_cast<const float4*>(s_ds + m * kDPitch + 4 * (lane & 7));
        float4 sp = make_float4(0.f, 0.f, 0.f, 0.f);
        float sz = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int4 id = t_idx[c * kRows + m];
          if (id.x < 0 || !has_q) continue;
          const float4 gr = t_grad[c * kRows + m];
          const float wt = __int_as_float(id.y);
          const float4 v = xv[c];
          sp.x = fmaf(wt, v.x, sp.x);
          sp.y = fmaf(wt, v.y, sp.y);
          sp.z = fmaf(wt, v.z, sp.z);
          sp.w = fmaf(wt, v.w, sp.w);
          const float dot = fmaf(ds.w, v.w, fmaf(ds.z, v.z, fmaf(ds.y, v.y, ds.x * v.x)));
          sz = fmaf(gr.x, dot, sz);
          sy = fmaf(gr.y, dot, sy);
          sx = fmaf(gr.z, dot, sx);
          atomicAdd(reinterpret_cast<float4*>(dx + (size_t)id.x * Ci + cq),
                    make_float4(wt * ds.x, wt * ds.y, wt * ds.z, wt * ds.w));
        }
        if (vox >= 0 && has_q) {
          *reinterpret_cast<float4*>(samp_k + (size_t)vox * Ci + cq) = sp;
        }
#pragma unroll
        for (int s = 4; s > 0; s >>= 1) {  // over the voxel's 8 lanes
          sz += __shfl_xor_sync(0xffffffffu, sz, s);
          sy += __shfl_xor_sync(0xffffffffu, sy, s);
          sx += __shfl_xor_sync(0xffffffffu, sx, s);
        }
        if ((lane & 7) == 0 && vox >= 0) {
          float* o = doff + (size_t)vox * (3 * kTaps) + 3 * k;
          if (gridDim.y == 1) {
            o[0] = sz;
            o[1] = sy;
            o[2] = sx;
          } else {
            atomicAdd(o + 0, sz);
            atomicAdd(o + 1, sy);
            atomicAdd(o + 2, sx);
          }
        }
      }
    } else {
      // one warp per voxel, one lane per channel; the corners of kBatch
      // voxels are loaded before any is used
      const int ci = ci0 + lane;
      const bool has_ci = ci < Ci;
#pragma unroll 1
      for (int j0 = 0; j0 < kRows / kWarps; j0 += kBatch) {
        float xv[kBatch][8];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int m = warp + kWarps * (j0 + u);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int gi = t_idx[c * kRows + m].x;
            xv[u][c] = gi >= 0 && has_ci ? __ldg(x + (size_t)gi * Ci + ci) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int m = warp + kWarps * (j0 + u);
          const int vox = s_vox[m];
          if (vox < 0) continue;
          const float ds = s_ds[m * kDPitch + lane];
          float sp = 0.f, sz = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int4 id = t_idx[c * kRows + m];
            if (id.x < 0) continue;
            const float4 gr = t_grad[c * kRows + m];
            const float wt = __int_as_float(id.y);
            sp = fmaf(wt, xv[u][c], sp);
            sz = fmaf(gr.x, xv[u][c], sz);
            sy = fmaf(gr.y, xv[u][c], sy);
            sx = fmaf(gr.z, xv[u][c], sx);
            if (has_ci) atomicAdd(dx + (size_t)id.x * Ci + ci, wt * ds);
          }
          if (has_ci) samp_k[(size_t)vox * Ci + ci] = sp;
          float pz = ds * sz, py = ds * sy, px = ds * sx;
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) {
            pz += __shfl_xor_sync(0xffffffffu, pz, s);
            py += __shfl_xor_sync(0xffffffffu, py, s);
            px += __shfl_xor_sync(0xffffffffu, px, s);
          }
          if (lane == 0) {
            float* o = doff + (size_t)vox * (3 * kTaps) + 3 * k;
            if (gridDim.y == 1) {
              o[0] = pz;
              o[1] = py;
              o[2] = px;
            } else {
              atomicAdd(o + 0, pz);
              atomicAdd(o + 1, py);
              atomicAdd(o + 2, px);
            }
          }
        }
      }
    }
  }
}

// dw_k[ci][co] (or part p of it) = Σ_v samp_k[v][ci] · g[v][co] over the
// voxels [p·per_part, (p + 1)·per_part): a T × T tile of (ci, co) outputs a
// block, 4 × 4 a thread, kStep voxels a step, the next step's operands
// fetched into registers while this step's are multiplied.
template <int T, int VEC>
__global__ void __launch_bounds__((T / 4) * (T / 4))
deform_bwd_weight_kernel(const float* __restrict__ samp, const float* __restrict__ g,
                         float* __restrict__ out, int n_vox, int Ci, int Co, int per_part) {
  constexpr int kN = (T / 4) * (T / 4);
  constexpr int kSP = T + 4;  // row pitch: 16-byte rows
  constexpr int kPer = kStep * T / VEC / kN;  // vectors of each operand a thread fetches
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  __shared__ __align__(16) float s_a[kStep][kSP];
  __shared__ __align__(16) float s_b[kStep][kSP];

  const int tid = threadIdx.x;
  const int tiles_o = (Co + T - 1) / T;
  const int ci0 = (blockIdx.x / tiles_o) * T, co0 = (blockIdx.x % tiles_o) * T;
  const int k = blockIdx.y;
  const int v_begin = blockIdx.z * per_part;
  const int v_end = min(n_vox, v_begin + per_part);
  const int ti = tid / (T / 4), to = tid % (T / 4);
  const float* a_k = samp + (size_t)k * n_vox * Ci;

  Vec ra[kPer], rb[kPer];
  auto fetch = [&](int v0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kN;
      const int r = i / (T / VEC), c = (i % (T / VEC)) * VEC;
      const int v = v0 + r;
      if constexpr (VEC == 4) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        ra[u] = v < v_end && ci0 + c < Ci
                    ? __ldg(reinterpret_cast<const float4*>(a_k + (size_t)v * Ci + ci0 + c)) : z;
        rb[u] = v < v_end && co0 + c < Co
                    ? __ldg(reinterpret_cast<const float4*>(g + (size_t)v * Co + co0 + c)) : z;
      } else {
        ra[u] = v < v_end && ci0 + c < Ci ? __ldg(a_k + (size_t)v * Ci + ci0 + c) : 0.f;
        rb[u] = v < v_end && co0 + c < Co ? __ldg(g + (size_t)v * Co + co0 + c) : 0.f;
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(v_begin);
  for (int v0 = v_begin; v0 < v_end; v0 += kStep) {
    if (v0 > v_begin) __syncthreads();  // the previous step's products are done
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kN;
      const int r = i / (T / VEC), c = (i % (T / VEC)) * VEC;
      *reinterpret_cast<Vec*>(&s_a[r][c]) = ra[u];
      *reinterpret_cast<Vec*>(&s_b[r][c]) = rb[u];
    }
    __syncthreads();
    if (v0 + kStep < v_end) fetch(v0 + kStep);
#pragma unroll 8
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[kk][4 * ti]);
      const float4 b = *reinterpret_cast<const float4*>(&s_b[kk][4 * to]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* o = out + ((size_t)blockIdx.z * kTaps + k) * Ci * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + 4 * ti + i;
    if (ci >= Ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * to + j;
      if (co < Co) o[(size_t)ci * Co + co] = acc[i][j];
    }
  }
}

// dw = Σ_p part[p], the parts in order; n = 27 · Ci · Co
__global__ void __launch_bounds__(256)
deform_bwd_weight_sum_parts(const float* __restrict__ part, float* __restrict__ dw,
                            long long n, int parts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < parts; ++p) v += part[i + p * n];
    dw[i] = v;
  }
}

template <int VEC>
int launch_data(const float* x, const float* off, const float* w, const float* g, float* dx,
                float* doff, float* samp, const Shape& S, dim3 grid, cudaStream_t stream) {
  deform_bwd_data_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, off, w, g, dx, doff, samp,
                                                              S);
  return (int)cudaGetLastError();
}

template <int T, int VEC>
int launch_weight(const float* samp, const float* g, float* out, int n_vox, int Ci, int Co,
                  int parts, int per_part, cudaStream_t stream) {
  const dim3 grid(((Ci + T - 1) / T) * ((Co + T - 1) / T), kTaps, parts);
  deform_bwd_weight_kernel<T, VEC><<<grid, (T / 4) * (T / 4), 0, stream>>>(
      samp, g, out, n_vox, Ci, Co, per_part);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the pointers x, off, w, g, dx, doff, dw, samp (27 × voxels × Ci
// floats of scratch), part (parts × 27 × Ci × Co floats, used where parts >
// 1) and the stream handle; plan: B, D, H, W, Ci, Co, the brick's log2 sides
// lz, ly, lx (lz + ly + lx ≤ 6), the channel chunks (⌈Ci / 32⌉), the tap
// groups, taps per group, the weight GEMM's tile T (32 or 64), parts,
// voxels per part; vec: 4 for 16-byte accesses (Ci % 4 = 0, Co % 4 = 0,
// every pointer 16-byte aligned), else 1. Two launches, or three where
// parts > 1.
extern "C" int dlka_deform_conv3d_bwd(const unsigned long long* args, const int* plan,
                                      int vec) {
  Shape S;
  S.B = plan[0]; S.D = plan[1]; S.H = plan[2]; S.W = plan[3]; S.Ci = plan[4]; S.Co = plan[5];
  S.lz = plan[6]; S.ly = plan[7]; S.lx = plan[8];
  const int ci_chunks = plan[9], tap_groups = plan[10];
  S.taps_per_group = plan[11];
  const int T = plan[12], parts = plan[13], per_part = plan[14];
  const int n_vox = S.B * S.D * S.H * S.W;
  if (S.lz < 0 || S.ly < 0 || S.lx < 0 || (1 << (S.lz + S.ly + S.lx)) > kRows ||
      ci_chunks != (S.Ci + kChunk - 1) / kChunk || tap_groups < 1 ||
      S.taps_per_group < 1 || (tap_groups - 1) * S.taps_per_group >= kTaps ||
      tap_groups * S.taps_per_group < kTaps || (vec != 1 && vec != 4) ||
      (vec == 4 && (S.Ci % 4 != 0 || S.Co % 4 != 0)) || (T != 32 && T != 64) ||
      parts < 1 || per_part < 1 || (long long)parts * per_part < n_vox ||
      (parts > 1 && args[8] == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  S.tiles_z = (S.D + (1 << S.lz) - 1) >> S.lz;
  S.tiles_y = (S.H + (1 << S.ly) - 1) >> S.ly;
  S.tiles_x = (S.W + (1 << S.lx) - 1) >> S.lx;
  const auto* x = reinterpret_cast<const float*>(args[0]);
  const auto* off = reinterpret_cast<const float*>(args[1]);
  const auto* w = reinterpret_cast<const float*>(args[2]);
  const auto* g = reinterpret_cast<const float*>(args[3]);
  auto* dx = reinterpret_cast<float*>(args[4]);
  auto* doff = reinterpret_cast<float*>(args[5]);
  auto* dw = reinterpret_cast<float*>(args[6]);
  auto* samp = reinterpret_cast<float*>(args[7]);
  auto* part = reinterpret_cast<float*>(args[8]);
  const auto stream = reinterpret_cast<cudaStream_t>(args[9]);

  const dim3 grid(S.B * S.tiles_z * S.tiles_y * S.tiles_x, ci_chunks, tap_groups);
  int err = vec == 4 ? launch_data<4>(x, off, w, g, dx, doff, samp, S, grid, stream)
                     : launch_data<1>(x, off, w, g, dx, doff, samp, S, grid, stream);
  if (err) return err;
  float* out = parts > 1 ? part : dw;
  if (T == 32) {
    err = vec == 4 ? launch_weight<32, 4>(samp, g, out, n_vox, S.Ci, S.Co, parts, per_part, stream)
                   : launch_weight<32, 1>(samp, g, out, n_vox, S.Ci, S.Co, parts, per_part, stream);
  } else {
    err = vec == 4 ? launch_weight<64, 4>(samp, g, out, n_vox, S.Ci, S.Co, parts, per_part, stream)
                   : launch_weight<64, 1>(samp, g, out, n_vox, S.Ci, S.Co, parts, per_part, stream);
  }
  if (err || parts == 1) return err;
  const long long n = (long long)kTaps * S.Ci * S.Co;
  const int blocks = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8);
  deform_bwd_weight_sum_parts<<<blocks, 256, 0, stream>>>(part, dw, n, parts);
  return (int)cudaGetLastError();
}
