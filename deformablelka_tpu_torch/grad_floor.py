"""How far two correct runs of one training step differ, tensor by tensor.

    python -m deformablelka_tpu_torch.grad_floor [--small | --two_d [--model NAME]]
        [--seeds 0 1 2]

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

With `--two_d` the step is the 2D flagship's: `Trainer2D`'s step on one
synthetic batch at 224², batch 24 (`trainer2d_path.step_trainer`,
`synthetic_batch`; `chip_smoke.py` phase 20), with the card as the
reference and the offsets' floors read at its 12 deform sites; with
`--model` the step is that configuration's instead (a zoo registry name,
as `trainer2d_path.step_trainer` takes it: "dae_lka" has no deform site,
its hand kernel is the LKA chain).

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
import tempfile
from collections import defaultdict
from unittest import mock

import numpy as np
import torch

from deformablelka_tpu_torch import train_path, trainer2d_path
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.nn.lka2d import DeformConv
from deformablelka_tpu_torch.ops import deform2d, kernels
from deformablelka_tpu_torch.ops.convs import to_ncdhw

SCALE = 1 + 1e-7
SMALL = (16, 32, 32)
# a tensor whose update is at most this share of the whole update's norm
# is rounding noise (an exactly zero gradient on a zero parameter, as
# MViT's `norm_k.bias` under the softmax): a relative gate cannot hold it
NOISE_SHARE = 1e-7


def _deform_dw_recomputed(x, offset, w, dil: int = 1):
    """The plain 2D deform conv, its backward the VJP of the plain forward
    recomputed call by call: the same values as autograd of the whole
    forward, which would hold every site's gathers at once (~60 GB for a
    flagship step at batch 24)."""
    plain = lambda *t: deform2d.deform_dw_conv2d(*t, dil)
    if not kernels._grad_needed(x, offset, w):
        return plain(x, offset, w)
    return kernels._PlainVjp.apply(plain, plain, x, offset, w)


def plain_versions():
    """A context in which every kernel wrapper is its plain version (the
    2D deform conv's recomputed, `_deform_dw_recomputed`)."""
    stack = contextlib.ExitStack()
    for k in kernels.HAND_KERNELS.values():
        plain = _deform_dw_recomputed if k.name == "deform_dw_conv2d" else k.plain
        stack.enter_context(mock.patch.object(kernels, k.name, plain))
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


def one_step_2d(seed, device, plain, scale=1.0, swap=False, config="dlka"):
    """Step 1 of the 2D trainer of `config` (the flagship by default; model
    from `seed`, batch from `seed`): loss, gradients, updates and the
    offset floors at each deform site (all on the CPU)."""
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer2d_path.step_trainer(tmp, config, seed=seed, device=device)
    batch = trainer2d_path.synthetic_batch(seed)
    if swap:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
    batch["image"] = batch["image"] * np.float32(scale)
    floors = {}
    hooks = [m.offset_net.register_forward_hook(_recorder(name, floors, None))
             for name, m in trainer.model.named_modules() if isinstance(m, DeformConv)]
    params = dict(trainer.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    with plain_versions() if plain else contextlib.nullcontext():
        loss = float(trainer.train_step(batch))
    for h in hooks:
        h.remove()
    return {"loss": loss,
            "grads": {n: p.grad.detach().cpu() for n, p in params.items()},
            "upd": {n: (p.detach() - before[n]).cpu() for n, p in params.items()},
            "floors": {n: f.flip(0) if swap else f for n, f in floors.items()},
            "kappa": {}}


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
    # the updates' worst over the tensors that are not rounding noise
    norm = flat(ref["upd"]).norm()
    held = {n: v for n, v in ((n, ((run["upd"][n] - u).norm() / u.norm()).item())
                              for n, u in ref["upd"].items()
                              if u.norm() > NOISE_SHARE * norm)}
    out["held"] = (max(held, key=held.get), max(held.values()), len(ref["upd"]) - len(held))
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
    worst, rel, noise = c["held"]
    print(f"  update, {noise} tensors of rounding noise left out (‖u‖ ≤ {NOISE_SHARE} of the "
          f"whole's): worst per-tensor {rel:.3e} ({worst})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="16x32x32 with the CPU as the reference (phase 6)")
    ap.add_argument("--two_d", action="store_true",
                    help="the 2D flagship's Trainer2D step, 224², batch 24 (phase 20)")
    ap.add_argument("--model", default="dlka",
                    help="with --two_d: the configuration whose step (default the flagship)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, ref_dev = (SMALL, "cpu") if args.small else (train_path.PATCH, "cuda")
    if args.two_d:
        step = lambda seed, dev, plain, **kw: one_step_2d(seed, dev, plain, config=args.model,
                                                          **kw)
    else:
        step = lambda seed, dev, plain, **kw: one_step(seed, img, dev, plain, **kw)
    ref_name = f"plain ({ref_dev})"
    largest = defaultdict(lambda: [0.0, 0.0, 0.0, 0.0])
    for seed in args.seeds:
        ref = step(seed, ref_dev, True, **({} if args.two_d else {"kappa": True}))
        runs = {f"{ref_name}, image x (1 + 1e-7)": step(seed, ref_dev, True, scale=SCALE),
                f"{ref_name}, batch swapped": step(seed, ref_dev, True, swap=True),
                "hand kernels (cuda)": step(seed, "cuda", False)}
        for name, run in runs.items():
            c = compare(run, ref)
            report(seed, f"{name} vs {ref_name}", c, run["loss"], ref["loss"])
            for i, key in enumerate(("grads", "upd")):
                largest[name][i] = max(largest[name][i], c[key][1])
            largest[name][2] = max(largest[name][2], c["held"][1])
            largest[name][3] = max(largest[name][3], c["upd"][2])
        g = ref["grads"]
        kap = sorted(ref["kappa"].items(), key=lambda kv: -kv[1])
        if kap:
            print(f"seed {seed} κ of the conv_offset.weight gradients, largest first: "
                  + "; ".join(f"{n} {k:.3g} (‖g‖ {g[n].norm():.3e})" for n, k in kap[:4])
                  + f"; smallest {kap[-1][1]:.3g}")
    for name, (gr, up, held, whole) in largest.items():
        print(f"over seeds {args.seeds}, {name}: worst per-tensor gradient "
              f"{gr:.3e}, update {up:.3e} ({held:.3e} but for rounding noise), whole "
              f"update {whole:.3e}")


if __name__ == "__main__":
    main()
