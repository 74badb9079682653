"""The port's bfloat16-input inference entry points against the JAX
package's, on the CPU, with VNet (which promotes its input to float32 at
its first conv, so both packages agree to float32 rounding whatever XLA
does inside its jitted engine):

- `SlidingWindowInference(input_dtype=torch.bfloat16)` against the JAX
  engine with `input_dtype=jnp.bfloat16` (4 filters, patch 32³, a 40×36×34
  volume, step 0.5, 8 mirror flips): the model gets bfloat16 tiles, the
  probabilities within 1e-5 of JAX's and the labels equal; the float32
  engine's probabilities differ from them by more than 1e-3 (the input's
  rounding shows);
- `test_pancreas --model vnet` (16 filters, the CLI's) on a one-case h5
  fold at patch 32³ against the JAX tester with the JAX CLI's bf16
  `apply_fn` (`cli/test_pancreas.py:54-55`) on the same carried weights:
  the labels equal and the four metrics within 1e-6;
- `run_training -val`: `validate` feeds the model bfloat16 tiles, as the
  JAX CLI's `_validate` casts them (`cli/run_training.py:174-175`).
"""

import json
import pickle
from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.inference import pancreas as jpan
from deformablelka_tpu.inference.sliding_window import SlidingWindowInference as JSW
from deformablelka_tpu.models import pancreas_baselines as jpb
from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.cli import test_pancreas as tcli
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.inference import pancreas as tpan
from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.models import pancreas_baselines as tpb
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

from test_torch_maxvit import jax_variables

torch.set_num_threads(1)
PATCH = (32, 32, 32)


def carried_vnet(n_filters, seed):
    jm = jpb.VNet(n_classes=2, n_filters=n_filters)
    v = jax_variables(jm, np.zeros((1, *PATCH, 1), np.float32), seed=seed)
    tm = tpb.VNet(n_classes=2, n_filters=n_filters)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm.eval()


def recording(fn, store):
    def wrapped(*args):
        out = fn(*args)
        store.append(out)
        return out
    return wrapped


class Recording(torch.nn.Module):
    """The model, recording the dtypes of its inputs."""

    def __init__(self, model):
        super().__init__()
        self.model, self.dtypes = model, set()

    def forward(self, x):
        self.dtypes.add(x.dtype)
        return self.model(x)


def test_sliding_window_input_dtype_matches_jax():
    jm, v, tm = carried_vnet(4, seed=2)
    volume = np.random.RandomState(3).randn(40, 36, 34, 1).astype(np.float32)
    engine = dict(patch_size=PATCH, num_classes=2, step_size=0.5, do_mirroring=True)
    ref = JSW(jm.apply, input_dtype=jnp.bfloat16, **engine).predict(v, volume)
    model = Recording(tm)
    got = SlidingWindowInference(model, device="cpu", input_dtype=torch.bfloat16,
                                 **engine).predict(volume)
    f32 = SlidingWindowInference(tm, device="cpu", **engine).predict(volume)
    assert model.dtypes == {torch.bfloat16}
    assert got.shape == ref.shape == (40, 36, 34, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(f32 - ref).max() > 1e-3


def test_pancreas_cli_in_bf16_matches_the_jax_tester(tmp_path):
    h5py = pytest.importorskip("h5py")
    jm, v, tm = carried_vnet(16, seed=4)
    name, image, label = case_path.pancreas_case(seed=2, shape=(44, 38, 20))
    (tmp_path / "Pancreas" / "Flods").mkdir(parents=True)
    with h5py.File(tmp_path / f"{name}.h5", "w") as f:
        f["image"], f["label"] = image, label.astype(np.uint8)
    (tmp_path / "Pancreas" / "Flods" / "test0.list").write_text(f"{name}.h5\n")
    CheckpointManager(tmp_path / "run", async_save=False).save(
        "d_lka_former_iter_6000", {"model": tm.state_dict(), "iteration": 6000})

    def apply_fn(variables, x):  # the JAX CLI's (cli/test_pancreas.py:54-55)
        return jm.apply(variables, x.astype(jnp.bfloat16))

    jsw = jpan.make_pancreas_sliding_window(apply_fn, patch_size=PATCH)
    jlabels, tlabels = [], []
    with mock.patch.object(jpan, "test_single_case",
                           recording(jpan.test_single_case, jlabels)):
        ref = jpan.test_all_case(jsw, v, [(name, image, label)], verbose=False)
    with mock.patch.object(tpan, "test_single_case",
                           recording(tpan.test_single_case, tlabels)):
        got = tcli.main(["--root_path", str(tmp_path), "--model_dir", str(tmp_path / "run"),
                         "--patch_size", *map(str, PATCH), "--model", "vnet",
                         "--device", "cpu"])
    np.testing.assert_array_equal(tlabels[0][0], jlabels[0][0])
    assert 0.01 < jlabels[0][0].mean() < 0.99  # both classes predicted
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_run_training_val_feeds_bf16(tmp_path):
    """`validate` with a stand-in trainer: one 20×24×24 case, patch 16³."""
    _, _, tm = carried_vnet(4, seed=5)
    model = Recording(tm)
    data = np.random.RandomState(6).randn(2, 20, 24, 24).astype(np.float32)
    data[1] = (data[1] > 0.5).astype(np.float32)
    np.savez(tmp_path / "case_000.npz", data=data)
    with open(tmp_path / "case_000.pkl", "wb") as fh:
        pickle.dump({}, fh)
    logs = []
    trainer = SimpleNamespace(
        initialize=lambda: None, model=model, device=torch.device("cpu"),
        ckpt=SimpleNamespace(exists=lambda name: False),
        print_to_log_file=logs.append)
    dataset = {"case_000": {"data_file": str(tmp_path / "case_000.npz"),
                            "properties_file": str(tmp_path / "case_000.pkl")}}
    summary = run_training.validate(trainer, dataset, (16, 16, 16), 2, tmp_path / "out")
    assert model.dtypes == {torch.bfloat16}
    seg = np.load(tmp_path / "out" / "validation" / "case_000.npz")["data"]
    assert seg.shape == (20, 24, 24) and seg.max() <= 1
    assert len(summary["results"]["all"]) == 1
    assert json.loads((tmp_path / "out" / "validation" / "summary.json").read_text())
