"""How far two correct runs of one training step differ, tensor by tensor.

    python -m deformablelka_tpu_torch.grad_floor [--small] [--seeds 0 1 2]

`chip_smoke.py` holds step 1 of the training path through the hand kernels
against the same step through the plain versions (phase 7), and the small
step on the card against the same step on the CPU (phase 6), one parameter
tensor at a time. This script reads what such a comparison gives between
runs that are all correct, for each seed:

- the reference: step 1 through the plain versions, on the card at full
  size (`train_path.py`), or on the CPU with `--small` (16×32×32, as
  phase 6);
- the reference with the image scaled by 1 + 1e-7: a real change of
  input, so offset samples next to a floor may cross it;
- the reference with the two samples of the batch swapped: the same
  function, whose sums over the batch run in another order, while each
  sample sees the same offsets;
- the run under test: the hand kernels on the card.

For each run against the reference it prints the largest per-tensor
‖Δg‖/‖g‖ (g the gradient) and ‖Δu‖/‖u‖ (u the step's update) with its
tensor, the whole gradient's and update's, the number of tensors above
1e-3, and the offset samples whose floor differs: over all 21 deform
sites, and at the site of the worst tensor. For every `conv_offset.weight`
of the reference it prints the cancellation of its gradient's sum over
voxels, κ = ‖Σ|x|·|g|‖ / ‖Σ x·g‖: rounding moves a sum in f32 by about κ
times the rounding of its terms.
"""

from __future__ import annotations

import argparse
import contextlib
from collections import defaultdict
from unittest import mock

import torch

from deformablelka_tpu_torch import train_path
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.ops import deform2d, deform3d, dwconv3d, kernels, lka
from deformablelka_tpu_torch.ops.convs import to_ncdhw

SCALE = 1 + 1e-7
SMALL = (16, 32, 32)


def plain_versions():
    """A context in which the kernel wrappers are their plain versions."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(kernels, "deform_conv3d",
                                          deform3d.deform_conv3d))
    stack.enter_context(mock.patch.object(kernels, "dw_chain3d", lka.dw_chain3d))
    stack.enter_context(mock.patch.object(kernels, "deform_dw_conv2d",
                                          deform2d.deform_dw_conv2d))
    stack.enter_context(mock.patch.object(kernels, "dw_chain2d", lka.dw_chain2d))
    stack.enter_context(mock.patch.object(kernels, "dwconv3d",
                                          dwconv3d.depthwise_conv3d_dilated))
    return stack


def _recorder(name, floors, taps):
    def hook(_m, inputs, out):
        if name in floors:  # the remat recompute: the same offsets again
            return
        floors[name] = torch.floor(out.detach()).to(torch.int16).cpu()
        if taps is not None:
            x = inputs[0].detach()
            out.register_hook(lambda g: taps.__setitem__(name, (x, g.detach())))
    return hook


def one_step(seed, img_size, device, plain, scale=1.0, swap=False, kappa=False):
    """Step 1 of the training path: loss, gradients, updates and the offset
    floors at each deform site (all on the CPU), and κ if asked."""
    path = train_path.build(seed, img_size, device)
    if swap:
        path.image = path.image.flip(0).contiguous()
        path.label = path.label.flip(0).contiguous()
    path.image.mul_(scale)
    floors, taps = {}, {} if kappa else None
    hooks = [m.conv_offset.register_forward_hook(_recorder(name, floors, taps))
             for name, m in path.model.named_modules()
             if isinstance(m, DeformConvPack3d)]
    params = dict(path.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    with plain_versions() if plain else contextlib.nullcontext():
        loss = float(train_path.step(path)["loss"])
    for h in hooks:
        h.remove()
    kap = {}
    for name, (x, g) in (taps or {}).items():
        shape = params[name + ".conv_offset.weight"].shape
        wgrad = lambda a, b: torch.nn.grad.conv3d_weight(
            to_ncdhw(a), shape, to_ncdhw(b), padding=1)
        kap[name + ".conv_offset.weight"] = (
            wgrad(x.abs(), g.abs()).norm() / wgrad(x, g).norm()).item()
    return {"loss": loss,
            "grads": {n: p.grad.detach().cpu() for n, p in params.items()},
            "upd": {n: (p.detach() - before[n]).cpu() for n, p in params.items()},
            "floors": {n: f.flip(0) if swap else f for n, f in floors.items()},
            "kappa": kap}


def compare(run, ref) -> dict:
    """Per-tensor and whole relative differences of gradients and updates,
    and floor crossings by deform site."""
    out = {}
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])
    for key in ("grads", "upd"):
        a, r = run[key], ref[key]
        rel = {n: ((a[n] - r[n]).norm() / r[n].norm().clamp_min(1e-30)).item()
               for n in r}
        worst = max(rel, key=rel.get)
        whole = ((flat(a) - flat(r)).norm() / flat(r).norm()).item()
        out[key] = (worst, rel[worst], whole, sum(v > 1e-3 for v in rel.values()))
    out["crossings"] = {n: int((run["floors"][n] != f).sum())
                        for n, f in ref["floors"].items()}
    out["samples"] = sum(f.numel() for f in ref["floors"].values())
    return out


def report(seed, name, c, loss, loss_ref) -> None:
    cross = c["crossings"]
    print(f"seed {seed} {name}: loss {loss:.7f} vs {loss_ref:.7f}; floor "
          f"crossings {sum(cross.values())} of {c['samples']} offset samples")
    for key, what in (("grads", "gradient"), ("upd", "update")):
        worst, rel, whole, over = c[key]
        site = [n for n in cross if worst.startswith(n + ".")]
        at = f"{cross[site[0]]} crossings at its site" if site else "no deform site"
        print(f"  {what}: worst per-tensor {rel:.3e} ({worst}; {at}), whole "
              f"{whole:.3e}, tensors above 1e-3: {over}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="16x32x32 with the CPU as the reference (phase 6)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, ref_dev = (SMALL, "cpu") if args.small else (train_path.PATCH, "cuda")
    ref_name = f"plain ({ref_dev})"
    largest = defaultdict(lambda: [0.0, 0.0])
    for seed in args.seeds:
        ref = one_step(seed, img, ref_dev, plain=True, kappa=True)
        runs = {f"{ref_name}, image x (1 + 1e-7)":
                    one_step(seed, img, ref_dev, True, scale=SCALE),
                f"{ref_name}, batch swapped":
                    one_step(seed, img, ref_dev, True, swap=True),
                "hand kernels (cuda)": one_step(seed, img, "cuda", plain=False)}
        for name, run in runs.items():
            c = compare(run, ref)
            report(seed, f"{name} vs {ref_name}", c, run["loss"], ref["loss"])
            for i, key in enumerate(("grads", "upd")):
                largest[name][i] = max(largest[name][i], c[key][1])
        g = ref["grads"]
        kap = sorted(ref["kappa"].items(), key=lambda kv: -kv[1])
        print(f"seed {seed} κ of the conv_offset.weight gradients, largest first: "
              + "; ".join(f"{n} {k:.3g} (‖g‖ {g[n].norm():.3e})" for n, k in kap[:4])
              + f"; smallest {kap[-1][1]:.3g}")
    for name, (gr, up) in largest.items():
        print(f"over seeds {args.seeds}, {name}: worst per-tensor gradient "
              f"{gr:.3e}, update {up:.3e}")


if __name__ == "__main__":
    main()
