"""Helpers of the tests/test_torch_bf16_*.py files: a model of the JAX
package and its port, both fed a bfloat16 input.

JAX's bfloat16 run is one jitted forward compiled with XLA's excess
precision off (`xla_allow_excess_precision`), so that every module rounds
to bfloat16 where its code says, as torch's eager ops do; with it on, XLA
keeps some intermediates in float32 and its logits sit between the
bfloat16 and the float32 ones. Two implementations that sum in another
order (XLA's and oneDNN's convolutions, the norms' float32 statistics)
still round a few elements the other way, so the port is held three ways:

- `check_modules`: every module with a bfloat16 input or output (the
  bfloat16 stretch and the modules where it promotes), fed JAX's own
  input, gives JAX's output type, and its values bit for bit but for rare
  one-ulp flips: at most `LEAF_FLIPS` of the elements of a layer,
  `BLOCK_FLIPS` of a module of several layers (a flip inside it spreads),
  differ by more than float32 noise, none by more than `MAX_ULPS`
  bfloat16 ulps of the output's scale. A port in float32 returns float32
  and differs from the rounded values at about half the elements;
- `port_dtypes`: the type at each such module in one whole forward;
- `check_logits`: the logits are float32, RMS(port − JAX) is under
  `NOISE_SHARE` (a tenth) of RMS(JAX bf16 − f32), no element is off by
  JAX's largest bf16 − f32 difference, and the labels agree on at least
  `MIN_LABELS` of the voxels. A port in float32 is as far from JAX's
  bf16 logits as JAX's own float32 logits are (ratio 1). The float32
  logits are the port's: the float32 tests hold them to JAX's within
  1e-4, and one JAX compile less keeps each file near a minute.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from unittest import mock

from deformablelka_tpu_torch.convert.jax_params import _resolve
from deformablelka_tpu_torch.ops import kernels

# measured (this file's four test files): at most 1.2e-3 of a layer's
# elements (the Pancreas model's second instance norm) and 7.1e-2 of a
# module of several layers (MaxViT's first block, whose attention spreads a
# flip over its window, in float32) differ by more than float32 noise
LEAF_FLIPS = 0.005
BLOCK_FLIPS = 0.1
MAX_ULPS = 4
NOISE_SHARE = 0.1
MIN_LABELS = 0.9999
BF16_ULP = 2.0 ** -7  # a bfloat16 ulp relative to the top of its binade


def _arrays(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return leaves if leaves and all(hasattr(a, "dtype") for a in leaves) else None


def jax_bf16_run(jm, variables, x):
    """(logits of the bf16 input, {module path: (args, output)} of every
    module with a bfloat16 input or output and array arguments and
    output), as numpy, from one jitted JAX forward compiled with XLA's
    excess precision off: left on, XLA may keep an intermediate in
    float32 where a module's code rounds it to bfloat16, which no
    module-by-module comparison can follow."""

    def forward(v, xb):
        rec = {}

        def icpt(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            m = context.module
            if context.method_name == "__call__" and m.scope is not None and not kwargs:
                a = _arrays(args)
                if a is not None and hasattr(out, "dtype") and len(a) == len(args) and any(
                        t.dtype == jnp.bfloat16 for t in [*a, out]):
                    rec["/".join(m.scope.path)] = (tuple(args), out)
            return out

        with fnn.intercept_methods(icpt):
            logits = jm.apply(v, xb)
        return logits, rec

    xb = jnp.asarray(x, jnp.bfloat16)
    compiled = jax.jit(forward).lower(variables, xb).compile(
        {"xla_allow_excess_precision": False})
    logits, rec = compiled(variables, xb)
    rec = {k: (tuple(map(np.asarray, a)), np.asarray(o)) for k, (a, o) in rec.items()}
    return np.asarray(logits), rec


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def port_modules(tm, records):
    """{JAX path: port module} for the recorded JAX modules, the model
    itself left out; where several JAX modules map to one port module (a
    BNAct and its `bn`), the outermost."""
    found = {}
    for path in sorted(records, key=lambda p: p.count("/")):
        if not path:
            continue
        _, m, _ = _resolve(tm, tuple(path.split("/")))
        if all(m is not other for other in found.values()):
            found[path] = m
    return found


def check_modules(tm, records) -> dict:
    """Each recorded module of the port against JAX's on JAX's input (see
    the module docstring); returns {path: (dtype, share of flips)}."""
    mods = port_modules(tm, records)
    leaves = {p for p in mods if not any(q.startswith(p + "/") for q in mods)}
    report = {}
    for path, m in mods.items():
        args, ref = records[path]
        with torch.no_grad():
            got = m(*map(_torch, args))
        want = torch.bfloat16 if ref.dtype == jnp.bfloat16 else torch.float32
        assert got.dtype == want, (path, got.dtype, ref.dtype)
        got = got.float().numpy()
        ref = ref.astype(np.float32)
        assert got.shape == ref.shape, (path, got.shape, ref.shape)
        d = np.abs(got - ref)
        flips = float(np.mean(d > 1e-3 * np.abs(ref) + 1e-6))
        allowed = LEAF_FLIPS if path in leaves else BLOCK_FLIPS
        assert flips <= allowed, (path, flips, allowed)
        assert d.max() <= MAX_ULPS * BF16_ULP * max(np.abs(ref).max(), 1e-3), \
            (path, d.max(), np.abs(ref).max())
        report[path] = ("bfloat16" if want is torch.bfloat16 else "float32", flips)
    return report


def port_dtypes(tm, x: torch.Tensor, paths):
    """One whole forward of `x`: ({JAX path: the port's output dtype at
    that module}, {kernel wrapper: the dtypes of the tensors of its
    calls}, the logits)."""
    mods = port_modules(tm, dict.fromkeys(paths))
    seen, at_kernels = {}, {}

    def recording(fn):
        def call(*args, **kwargs):
            at_kernels.setdefault(fn.__name__, set()).update(
                a.dtype for a in args if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return call

    def hook(path):
        def record(_m, _i, out):
            seen.setdefault(path, out.dtype)
        return record

    hooks = [m.register_forward_hook(hook(p)) for p, m in mods.items()]
    patches = [mock.patch.object(kernels, fn.__name__, recording(fn))
               for fn in kernels.WRAPPERS]
    try:
        for patch in patches:
            patch.start()
        with torch.no_grad():
            logits = tm(x)
    finally:
        for patch in patches:
            patch.stop()
        for h in hooks:
            h.remove()
    return seen, at_kernels, logits


def check_logits(got16: np.ndarray, ref16: np.ndarray, ref32: np.ndarray):
    """The port's bf16-input logits against JAX's (module docstring);
    `ref32` the float32 logits. Returns (RMS ratio, max ratio, label
    agreement)."""
    assert got16.dtype == np.float32 and got16.shape == ref16.shape
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))
    ratio = rms(got16 - ref16) / rms(ref16 - ref32)
    max_ratio = float(np.abs(got16 - ref16).max() / np.abs(ref16 - ref32).max())
    agree = float(np.mean(got16.argmax(-1) == ref16.argmax(-1)))
    assert ratio < NOISE_SHARE, ratio
    assert max_ratio < 1.0, max_ratio
    assert agree >= MIN_LABELS, agree
    return ratio, max_ratio, agree


class Run:
    """One model of both packages on one bf16 input: JAX's bf16 logits and
    module records (`jax_bf16_run`), the carried port model `tm`, its
    logits of the bf16 and the f32 input, and `port_dtypes` of its bf16
    forward."""

    def __init__(self, jm, variables, x, tm):
        from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax

        self.ref16, self.records = jax_bf16_run(jm, variables, x)
        tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
        self.tm = tm.eval()
        self.dtypes, self.kernel_dtypes, ours16 = port_dtypes(
            self.tm, torch.from_numpy(x).bfloat16(), self.records)
        assert ours16.dtype == torch.float32
        self.ours16 = ours16.numpy()
        with torch.no_grad():
            self.ours32 = self.tm(torch.from_numpy(x)).numpy()

    def jax_dtype(self, path: str) -> torch.dtype:
        return torch.bfloat16 if self.records[path][1].dtype == jnp.bfloat16 else torch.float32


def check_run(run: Run, points: dict, kernel_names=()):
    """The three checks of the module docstring on `run`: every recorded
    module against JAX's; `points` ({JAX path: "bfloat16" | "float32"})
    among them with those types, in the port's whole forward too; each
    wrapper of `kernel_names` called with float32 tensors only, no other
    wrapper called; the logits."""
    report = check_modules(run.tm, run.records)
    for path, dtype in points.items():
        assert report[path][0] == dtype, (path, report[path])
    for path, dtype in run.dtypes.items():
        assert dtype == run.jax_dtype(path), (path, dtype)
    assert set(points) <= set(run.dtypes)
    assert run.kernel_dtypes == {k: {torch.float32} for k in kernel_names}, run.kernel_dtypes
    measured = check_logits(run.ours16, run.ref16, run.ours32)
    print("flips per module", {p: f for p, (_, f) in report.items() if f},
          "RMS ratio, max ratio, labels", measured)
    return measured
