"""Where the host's time goes in one call of a small hand kernel, on the card.

    python -m deformablelka_tpu_torch.launch_costs

At the dilated depthwise conv's 4³×256 site (K3 d2, B=8) the kernel's
device time is a few µs, so its wrapper's host path sets the pace of
back-to-back calls. This prints, per call on the host clock (the mean over
20000 calls after 500 warm-up calls, in three rounds): the wrapper with
grad mode on and under `no_grad`, one `F.conv3d(groups=C)` for the same
function (TF32 off), and the wrapper's parts: its checks, the launch plan's
lookup, the output's allocation, the launch arguments, and the launch
alone (`kernels._launch`: the foreign-function call, the kernel launch,
its error check and its count). Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import time

import torch
import torch.nn.functional as F

from deformablelka_tpu_torch.ops import kernels

SHAPE, K, DIL = (8, 4, 4, 4, 256), 3, 2
CALLS, WARMUP, ROUNDS = 20000, 500, 3


def host_us(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def parts(x, w, b) -> dict:
    """The wrapper's steps as separate callables, as `_dwconv3d_forward`
    runs them."""
    dev = x.device
    B, D, H, W, C = x.shape
    plan = kernels.dwconv3d_plan(B, D, H, W, C, K, DIL)
    y = torch.empty_like(x)
    args = kernels._pointers()

    def checks():
        return (x.dtype is torch.float32 and x.is_contiguous()
                and kernels._fits(w, (K, K, K, 1, C), dev) and kernels._fits(b, (C,), dev))

    def arguments():
        args[0], args[1], args[2] = x.data_ptr(), w.data_ptr(), b.data_ptr()
        args[3], args[4] = y.data_ptr(), kernels._stream(dev)

    arguments()
    return {"checks": checks,
            "plan lookup": lambda: kernels.dwconv3d_plan(B, D, H, W, C, K, DIL),
            "output allocation": lambda: torch.empty_like(x),
            "launch arguments": arguments,
            "launch": lambda: kernels._launch("dwconv3d", args, plan.params, plan.vec)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("launch_costs: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, device="cuda", generator=g)
    C = SHAPE[-1]
    w = torch.randn(K, K, K, 1, C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    xn = x.permute(0, 4, 1, 2, 3).contiguous()
    wn = w.permute(4, 3, 0, 1, 2).contiguous()
    calls = {"wrapper": lambda: kernels.dwconv3d(x, w, b, DIL),
             "F.conv3d": lambda: F.conv3d(xn, wn, b, padding=DIL * (K // 2),
                                          dilation=DIL, groups=C),
             **parts(x, w, b)}
    print(f"{smi}; dwconv3d at {SHAPE} K{K} d{DIL}, host µs per call "
          f"(mean of {CALLS}), three rounds:")
    for _ in range(ROUNDS):
        print("  " + " | ".join(f"{name} {host_us(fn):.2f}" for name, fn in calls.items()))
        with torch.no_grad():
            print(f"  under no_grad: wrapper {host_us(calls['wrapper']):.2f} | "
                  f"F.conv3d {host_us(calls['F.conv3d']):.2f}")


if __name__ == "__main__":
    main()
