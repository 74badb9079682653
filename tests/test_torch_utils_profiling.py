"""The port's `utils/profiling.py` against the JAX package's, on the CPU.

- `count_params` of the D-LKA Former at img_size (16, 32, 32) equals JAX's
  `count_params` of the same model's "params" (shapes from
  `jax.eval_shape` of its init), and of a small net equals its tensors';
- `flops_report` of a 'valid' 3³ conv (16 → 32 channels), bias, ReLU and
  a matmul (32 → 64) against JAX's `cost_analysis` FLOPs: within 1 %.
  torch's counter counts the conv and the matmul; XLA counts those the
  same (two per multiply-add) and adds the bias and the ReLU, one per
  element, 0.2 % here. With 'same' padding XLA counts only the taps inside
  the input, torch's counter every tap, so the net is 'valid';
- the hand kernels of the small D-LKA Former on the CPU: 21 calls each of
  `deform_conv3d` and `dw_chain3d` counted, their operations by the
  bounds' formulas at the shapes that forward hooks see, and what torch's
  counter saw of their plain versions taken out of its part;
- `latency_bench`, `latency_bench_scan` and `trace` run (host clock and a
  CPU trace here; CUDA events and the card's kernels on the card).
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.ops.convs import conv3d
from deformablelka_tpu_torch.utils.profiling import (count_params, flops_report,
                                                     latency_bench, latency_bench_scan,
                                                     trace)

torch.set_num_threads(1)
IMG = (16, 32, 32)


@pytest.fixture(scope="module")
def dlka():
    return dlka_former_synapse(num_classes=14, do_ds=False, img_size=IMG, device="cpu")


def test_count_params_matches_jax(dlka):
    import jax
    import jax.numpy as jnp

    from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
    from deformablelka_tpu.utils.profiling import count_params as jax_count_params

    jm = jax_synapse(num_classes=14, do_ds=False, img_size=IMG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *IMG, 1)))
    assert count_params(dlka) == jax_count_params(shapes["params"])
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    assert count_params(net) == 3 * 4 + 4 + 4 + 4   # the running statistics are buffers


def _conv_mm_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 10, 10, 10, 16).astype(np.float32),
            rng.randn(3, 3, 3, 16, 32).astype(np.float32),
            rng.randn(32).astype(np.float32), rng.randn(32, 64).astype(np.float32))


def test_flops_report_matches_jax_cost_analysis(capsys):
    import jax
    from jax import lax

    from deformablelka_tpu.utils.profiling import flops_report as jax_flops_report

    x, w, b, m = _conv_mm_inputs()

    def jfn(x, w, b, m):
        y = lax.conv_general_dilated(x, w, (1, 1, 1), "VALID",
                                     dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b
        return jax.nn.relu(y) @ m

    ref = jax_flops_report(jfn, x, w, b, m, name="jax")
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    got = flops_report(lambda x: torch.relu(conv3d(x, wt, torch.from_numpy(b), padding=0))
                       @ torch.from_numpy(m), torch.from_numpy(x), name="port")
    np.testing.assert_allclose(got["gflops"], ref["gflops"], rtol=1e-2)
    assert got["hand_kernel_gflops"] == 0 and got["hand_kernel_calls"] == {}
    # the floor: x read, y written (w, b, m are closed over, not arguments)
    assert got["gbytes_floor"] == pytest.approx(4 * (x.size + 2 * 8 ** 3 * 64) / 1e9)
    assert "port: " in capsys.readouterr().out


def test_flops_report_counts_the_hand_kernels(dlka):
    shapes = {"deform": [], "chain": []}
    hooks = [m.register_forward_hook(lambda m, i, o: shapes["deform"].append(
        (i[0].shape, m.weight.shape[0]))) for m in dlka.modules()
        if isinstance(m, DeformConvPack3d)]
    x = torch.from_numpy(np.random.RandomState(1).randn(1, *IMG, 1).astype(np.float32))
    with torch.no_grad():
        got = flops_report(dlka, x)
        for h in hooks:
            h.remove()
        raw = FlopCounterMode(display=False)
        with raw:
            dlka(x)
    assert got["hand_kernel_calls"] == {"deform_conv3d": 21, "dw_chain3d": 21}
    deform = sum(int(np.prod(s[:-1])) * 27 * (2 * s[-1] * co + 16 * s[-1])
                 for s, co in shapes["deform"])
    # each block's chain runs on the deform conv's input shape (the gate's proj_1 out)
    chain = sum(int(np.prod(s)) * 2 * (125 + 343) for s, _ in shapes["deform"])
    assert got["hand_kernel_gflops"] * 1e9 == pytest.approx(deform + chain, rel=1e-12)
    # torch's part is the raw count less the chains' plain depthwise convs,
    # which its counter sees on the CPU, and less the plain deform conv's
    torch_part = (got["gflops"] - got["hand_kernel_gflops"]) * 1e9
    assert torch_part <= raw.get_total_flops() - chain + 1


def test_latency_helpers_and_trace(tmp_path):
    a = torch.randn(64, 64)
    fn = lambda a: a @ a
    r = latency_bench(fn, (a,), warmup=2, reps=25, inner=5)
    assert r["reps"] == 25 and r["mean_ms"] > 0 and r["std_ms"] >= 0
    r = latency_bench_scan(fn, (a,), reps=7, rounds=3)
    assert r["reps"] == 21 and r["mean_ms"] > 0
    with trace(tmp_path / "t") as d:
        fn(a)
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
