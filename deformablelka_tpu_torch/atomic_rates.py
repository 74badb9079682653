"""The rates of the card's additions into memory, for choosing how a kernel
accumulates a scatter (the 2D deform backward's dx, csrc/deform2d_dw_bwd.cu).

    python -m deformablelka_tpu_torch.atomic_rates

Builds one small CUDA source with nvcc for sm_90a and times, in SM clocks
per warp instruction (one SM's share of a full-card run, from CUDA events
at the card's maximum SM clock, `clocks.max.sm`, which it holds under
load), each way of adding floats into memory
that the kernel could take: shared-memory f32 atomicAdd (lanes on
consecutive words, or on random banks), 64- and 128-bit compare-and-swap
loops adding 2 or 4 floats, plain shared loads and read-modify-writes for
scale, and global `red.add` of 4 floats or 1 a lane to 128-byte runs at
random places in 32 MB. Prints the atomic instructions the compiler chose
(cuobjdump) and whether `red.shared.add.v4.f32` assembles. Needs one CUDA
card and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from deformablelka_tpu_torch.ops import kernels

SOURCE = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ void add4_cas128(float* p, float4 v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  float4 old = *reinterpret_cast<float4*>(p);
  while (true) {
    unsigned long long olo = (unsigned long long)__float_as_uint(old.y) << 32 | __float_as_uint(old.x);
    unsigned long long ohi = (unsigned long long)__float_as_uint(old.w) << 32 | __float_as_uint(old.z);
    unsigned long long nlo = (unsigned long long)__float_as_uint(old.y + v.y) << 32 |
                             __float_as_uint(old.x + v.x);
    unsigned long long nhi = (unsigned long long)__float_as_uint(old.w + v.w) << 32 |
                             __float_as_uint(old.z + v.z);
    unsigned long long rlo, rhi;
    asm volatile("{\n .reg .b128 d, c, s;\n mov.b128 c, {%2, %3};\n mov.b128 s, {%4, %5};\n"
                 " atom.shared.cas.b128 d, [%6], c, s;\n mov.b128 {%0, %1}, d;\n}"
                 : "=l"(rlo), "=l"(rhi) : "l"(olo), "l"(ohi), "l"(nlo), "l"(nhi), "r"(a) : "memory");
    if (rlo == olo && rhi == ohi) return;
    old = make_float4(__uint_as_float((unsigned)rlo), __uint_as_float((unsigned)(rlo >> 32)),
                      __uint_as_float((unsigned)rhi), __uint_as_float((unsigned)(rhi >> 32)));
  }
}
__device__ __forceinline__ void add2_cas64(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *q, as;
  do {
    as = old;
    const float x = __uint_as_float((unsigned)as) + a, y = __uint_as_float((unsigned)(as >> 32)) + b;
    old = atomicCAS(q, as, (unsigned long long)__float_as_uint(y) << 32 | __float_as_uint(x));
  } while (old != as);
}
template <int MODE>
__global__ void __launch_bounds__(256) k(float* out, float* gbuf, int iters) {
  extern __shared__ __align__(16) float s[];
  for (int i = threadIdx.x; i < 8192; i += 256) s[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned h = lane * 2654435761u + warp * 40503u + blockIdx.x * 977u;
  unsigned hi = lane / 8 * 2654435761u + warp * 40503u + blockIdx.x * 977u;
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
    if (MODE == 0) {
      atomicAdd(s + ((warp * 32 + lane + it * 256) & 8191), 1.f);
    } else if (MODE == 1) {
      h = h * 1664525u + 1013904223u;
      atomicAdd(s + ((h >> 12) & 8191), 1.f);
    } else if (MODE == 2) {
      add2_cas64(s + ((warp * 64 + lane * 2 + it * 512) & 8191), 1.f, 2.f);
    } else if (MODE == 3) {
      add4_cas128(s + ((warp * 128 + lane * 4 + it * 1024) & 8191), make_float4(1.f, 2.f, 3.f, 4.f));
    } else if (MODE == 4) {
      s[(warp * 32 + lane + it * 256) & 8191] += 1.f;
    } else if (MODE == 5) {
      const float4 v = *reinterpret_cast<float4*>(s + ((warp * 128 + lane * 4 + it * 1024) & 8191));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    } else if (MODE == 6) {
      hi = hi * 1664525u + 1013904223u;
      float* p = gbuf + ((size_t)((hi >> 8) & ((1u << 18) - 1)) * 32 + (lane & 7) * 4);
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(1.f), "f"(1.f),
                   "f"(1.f), "f"(1.f) : "memory");
    } else {
      h = h * 1664525u + 1013904223u;
      const unsigned hh = __shfl_sync(0xffffffffu, h, 0);
      atomicAdd(gbuf + ((size_t)((hh >> 8) & ((1u << 18) - 1)) * 32 + lane), 1.f);
    }
  }
  __syncthreads();
  out[blockIdx.x * 256 + threadIdx.x] = s[threadIdx.x] + acc.x + acc.y + acc.z + acc.w;
}
template <int MODE> void launch(float* out, float* gbuf, int iters, int blocks) {
  k<MODE><<<blocks, 256, 32768>>>(out, gbuf, iters);
}
extern "C" int run(int mode, float* out, float* gbuf, int iters, int blocks) {
  void (*f[8])(float*, float*, int, int) = {launch<0>, launch<1>, launch<2>, launch<3>,
                                           launch<4>, launch<5>, launch<6>, launch<7>};
  f[mode](out, gbuf, iters, blocks);
  return (int)cudaGetLastError();
}
'''

VECTOR_SHARED_RED = r'''
__global__ void v(float* g, float a) {
  __shared__ float s[1024];
  asm volatile("red.shared.add.v4.f32 [%0], {%1, %2, %3, %4};" ::
               "r"((unsigned)__cvta_generic_to_shared(s + 4 * threadIdx.x)),
               "f"(a), "f"(a), "f"(a), "f"(a));
  __syncthreads();
  g[threadIdx.x] = s[threadIdx.x];
}
'''

MODES = ("shared f32 atomicAdd, a warp on 32 consecutive words (1 float a lane)",
         "shared f32 atomicAdd, random banks (1 float a lane)",
         "shared 64-bit CAS loop adding 2 floats (a warp on 256 bytes)",
         "shared 128-bit CAS loop adding 4 floats (a warp on 512 bytes)",
         "shared load, add, store, no atomic (1 float a lane)",
         "shared 16-byte load (4 floats a lane)",
         "global red.add.v4.f32, 4 lanes' 128-byte runs at random in 32 MB (4 floats a lane)",
         "global red.add.f32, a warp's 128-byte run at random in 32 MB (1 float a lane)")
FLOATS = (1, 1, 2, 4, 1, 4, 4, 1)
BLOCKS_PER_SM, ITERS, REPS = 6, 4096, 3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("atomic_rates: needs a CUDA card")
    nvcc = kernels._nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"atomic_rates device: {smi}", flush=True)
    mhz = float(smi.split(",")[-1].split()[0])
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "rates.cu").write_text(SOURCE)
        subprocess.run([nvcc, *flags, "-Xcompiler", "-fPIC", "-shared", str(d / "rates.cu"),
                        "-o", str(d / "rates.so")], check=True)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(d / "rates.so")],
                              capture_output=True, text=True).stdout
        ops = sorted({line.split()[1].rstrip(";") for line in sass.splitlines()
                      if "ATOMS" in line or "REDG" in line or "ATOMG" in line})
        print(f"atomic_rates SASS atomic instructions: {', '.join(ops)}", flush=True)
        (d / "v.cu").write_text(VECTOR_SHARED_RED)
        r = subprocess.run([nvcc, *flags, "-c", str(d / "v.cu"), "-o", str(d / "v.o")],
                           capture_output=True, text=True)
        err = (r.stdout + r.stderr).strip().splitlines()
        print(f"atomic_rates red.shared.add.v4.f32 assembles: {r.returncode == 0}"
              + ("" if r.returncode == 0 else f" ({err[0][-120:]})"), flush=True)
        lib = ctypes.CDLL(str(d / "rates.so"))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = sms * BLOCKS_PER_SM
        out = torch.empty(blocks * 256, device="cuda")
        gbuf = torch.zeros(8 << 20, device="cuda")
        for mode, name in enumerate(MODES):
            times = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = lib.run(mode, ctypes.c_void_p(out.data_ptr()),
                              ctypes.c_void_p(gbuf.data_ptr()), ITERS, blocks)
                end.record()
                torch.cuda.synchronize()
                if err:
                    raise SystemExit(f"atomic_rates: launch failed ({err})")
                times.append(start.elapsed_time(end))
            ms = sorted(times)[REPS // 2]
            clocks = ms * 1e-3 * mhz * 1e6 / (blocks * 8 * ITERS / sms)
            print(f"atomic_rates {name}: {clocks:.2f} SM-clocks a warp instruction, "
                  f"{clocks / (32 * FLOATS[mode]):.3f} a float", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
