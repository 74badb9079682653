"""The port's training CLIs on the CPU, and its cascade step against the
JAX package's.

- `cli/run_training.py` alone on a synthetic preprocessed folder (3 cases
  of 20×40×36, nnUNet's layout, `trainer_path.write_preprocessed`) at
  `--patch_size 16 32 32` with `--trans_block TransformerBlock_SE` (the
  D-LKA block's CPU step takes seconds): one epoch of 2 training and 1
  validation batches, then `-val` (`summary.json`, `postprocessing.json`,
  the labels), then `-c` from `model_latest`. The augmenter's threads
  decide the order of the batches, so what is checked is what does not
  depend on it: the batches' shapes and dtypes, the files written, the
  bookkeeping, the threads stopped. The JAX CLI's run takes about 8
  minutes here; the parity of its parts is held in
  tests/test_torch_trainer3d.py and tests/test_torch_data_train_copies.py.
- `network 2d`: GenericUNet trains one epoch on 64² slices; `2d` with
  `-val` raises (its parity with the JAX trainer is held in
  tests/test_torch_generic_unet.py).
- `training/cascade.predict_next_stage` against JAX's with the same
  weights (`dlka_former_synapse(do_ds=False)` with the SE block, JAX
  variables from `jax.eval_shape` and seeded numpy): the written
  `<case>_segFromPrevStage.npz` files are equal.
- `cli/train_pancreas.py` from an h5 fold (h5py), then the port's
  `cli/test_pancreas.py` on the checkpoint it wrote: the metrics equal
  those of the tester on the trained model; an unknown `--model` is
  refused.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu.training import cascade as jcascade
from deformablelka_tpu_torch import case_path, trainer_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.cli import test_pancreas as test_cli
from deformablelka_tpu_torch.cli import train_pancreas as train_cli
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.inference import pancreas as tpan
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.training import cascade
from deformablelka_tpu_torch.training.trainer3d import Trainer3D

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
PATCH = (16, 32, 32)
BLOCK = "TransformerBlock_SE"


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    trainer_path.write_preprocessed(d, cases=3, shape=(20, 40, 36))
    return d


def _argv(folder, out, *extra, epochs=1):
    return ["3d_fullres", "d_lka_former_trainer_synapse", "Task002_Synapse", "0",
            "--preprocessed_folder", str(folder), "--output_folder", str(out),
            "--patch_size", *map(str, PATCH), "--trans_block", BLOCK,
            "--batches_per_epoch", "2", "--val_batches_per_epoch", "1",
            "--max_epochs", str(epochs), "--device", "cpu", *extra]


def _stopped(trainer):
    for gen in (trainer.train_gen, trainer.val_gen):
        for t in gen.threads:
            t.join(timeout=120)
    return not any(t.is_alive() for gen in (trainer.train_gen, trainer.val_gen)
                   for t in gen.threads)


def test_cli_trains_validates_and_resumes(folder, tmp_path):
    batches = []
    train_batch = Trainer3D.train_batch

    def recorded(self, batch):
        batches.append((batch["data"].shape, batch["data"].dtype,
                        [(t.shape, t.dtype) for t in batch["target"]]))
        return train_batch(self, batch)

    with mock.patch.object(Trainer3D, "train_batch", recorded):
        trainer = run_training.main(_argv(folder, tmp_path))
    assert batches == [((2, *PATCH, 1), np.float32,
                        [((2, *PATCH), np.int32), ((2, 8, 8, 8), np.int32),
                         ((2, 4, 4, 4), np.int32)])] * 2
    out = tmp_path / "d_lka_former_trainer_synapse" / "fold_0"
    assert trainer.output_folder == out and trainer.epoch == 1 and trainer.step == 2
    assert len(trainer.all_tr_losses) == len(trainer.all_val_losses) == 1
    assert np.isfinite(trainer.all_tr_losses + trainer.all_val_losses).all()
    assert 0 <= trainer.all_val_eval_metrics[0] <= 1
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "model_best", "model_best.json", "model_final_checkpoint",
        "model_final_checkpoint.json"]
    assert (out / "progress.png").exists() and (out / "training_log.txt").exists()
    assert _stopped(trainer)

    validator = run_training.main(_argv(folder, tmp_path, "-val"))
    val_dir = out / "validation"
    summary = json.loads((val_dir / "summary.json").read_text())
    assert summary["name"] == "fold_0" and len(summary["results"]["all"]) == 2
    assert sorted(summary["results"]["mean"], key=int) == [str(c) for c in range(14)]
    post = json.loads((val_dir / "postprocessing.json").read_text())
    assert sorted(post) == ["dice_after", "dice_before", "for_which_classes"]
    for case in ("case_001", "case_002"):  # the validation cases: not case_000
        seg = np.load(val_dir / f"{case}.npz")["data"]
        assert seg.shape == (20, 40, 36) and seg.dtype == np.uint8 and seg.max() < 14
    assert "validating with model_final_checkpoint" in (out / "training_log.txt").read_text()
    for k, t in trainer.model.state_dict().items():
        torch.testing.assert_close(validator.model.state_dict()[k], t, rtol=0, atol=0)
    assert _stopped(validator)

    trainer.save_checkpoint("model_latest")
    trainer.ckpt.wait_until_finished()
    resumed = run_training.main(_argv(folder, tmp_path, "-c", epochs=2))
    assert resumed.epoch == 2 and resumed.step == 4
    assert resumed.all_tr_losses[0] == trainer.all_tr_losses[0]
    assert len(resumed.all_tr_losses) == 2 and _stopped(resumed)


def test_network_2d_trains_and_refuses_validation(folder, tmp_path):
    """`2d`: GenericUNet on random 64² slices, deep supervision at 1, 1/2
    and 1/4; `-val` with `2d` raises (the JAX CLI's fails as well,
    tests/test_torch_generic_unet.py)."""
    batches = []
    train_batch = Trainer3D.train_batch

    def recorded(self, batch):
        batches.append((batch["data"].shape, [t.shape for t in batch["target"]]))
        return train_batch(self, batch)

    argv = ["2d", "d_lka_former_trainer_synapse", "Task002_Synapse", "0",
            "--preprocessed_folder", str(folder), "--output_folder", str(tmp_path),
            "--patch_size", "1", "64", "64", "--batches_per_epoch", "1",
            "--val_batches_per_epoch", "1", "--max_epochs", "1", "--device", "cpu"]
    with mock.patch.object(Trainer3D, "train_batch", recorded):
        trainer = run_training.main(argv)
    assert type(trainer.model).__name__ == "GenericUNet"
    assert batches == [((2, 64, 64, 1), [(2, 64, 64), (2, 32, 32), (2, 16, 16)])]
    assert trainer.step == 1 and np.isfinite(trainer.all_tr_losses + trainer.all_val_losses).all()
    out = tmp_path / "d_lka_former_trainer_synapse" / "fold_0" / "ckpt"
    assert (out / "model_final_checkpoint").is_dir() and _stopped(trainer)
    with pytest.raises(NotImplementedError, match="-val"):
        run_training.main([*argv, "-val"])


def test_predict_next_stage_matches_jax(tmp_path):
    lowres, nextst = tmp_path / "lowres", tmp_path / "next"
    trainer_path.write_preprocessed(lowres, cases=2, shape=(16, 36, 40), seed=3)
    trainer_path.write_preprocessed(nextst, cases=1, shape=(24, 50, 44), seed=5)
    jm = jax_synapse(num_classes=14, do_ds=False, trans_block=BLOCK, deterministic=True,
                     img_size=PATCH)
    v = jax_variables(jm, np.zeros((1, *PATCH, 1), np.float32), seed=6)
    tm = dlka_former_synapse(14, do_ds=False, img_size=PATCH, trans_block=BLOCK,
                             device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    kw = dict(patch_size=PATCH, num_classes=14, do_mirroring=False)
    ref = jcascade.predict_next_stage(jm.apply, v, lowres, nextst, tmp_path / "jax", **kw)
    got = cascade.predict_next_stage(tm, lowres, nextst, tmp_path / "port", device="cpu",
                                     **kw)
    assert [p.name for p in got] == [p.name for p in ref] == [
        "case_000_segFromPrevStage.npz", "case_001_segFromPrevStage.npz"]
    for g, r in zip(got, ref):
        seg = np.load(g)["data"]
        np.testing.assert_array_equal(seg, np.load(r)["data"])
        assert seg.dtype == np.uint8
    # case_000 is resampled to the next stage's shape, case_001 (absent
    # there) stays at its own
    assert np.load(got[0])["data"].shape == (24, 50, 44)
    assert np.load(got[1])["data"].shape == (16, 36, 40)


def test_train_pancreas_cli_from_an_h5_fold_and_the_tester_reads_it(tmp_path):
    h5py = pytest.importorskip("h5py")
    name, image, label = case_path.pancreas_case(seed=2, shape=(40, 36, 24))
    (tmp_path / "Pancreas" / "Flods").mkdir(parents=True)
    with h5py.File(tmp_path / f"{name}.h5", "w") as f:
        f["image"], f["label"] = image, label.astype(np.uint8)
    for fold in ("train0.list", "test0.list"):
        (tmp_path / "Pancreas" / "Flods" / fold).write_text(f"{name}.h5\n")
    common = ["--root_path", str(tmp_path), "--patch_size", "32", "32", "32",
              "--trans_block", BLOCK, "--device", "cpu"]
    trainer = train_cli.main([*common, "--output_dir", str(tmp_path / "model"),
                              "--max_iterations", "2"])
    run_dir = tmp_path / "model" / "pancreas_dlka"
    assert trainer.step == 2 and trainer.labeled_bs == 1
    assert (run_dir / "d_lka_former_iter_2").is_dir()
    avg = test_cli.main([*common, "--model_dir", str(run_dir),
                         "--checkpoint", "d_lka_former_iter_2"])
    # the CLI feeds its model bfloat16, as the JAX CLI does
    sw = tpan.make_pancreas_sliding_window(trainer.model.eval(), patch_size=(32, 32, 32),
                                           device="cpu", input_dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        avg, tpan.test_all_case(sw, [(name, image, label)], verbose=False))
    assert np.all(np.isfinite(avg))
    with pytest.raises(SystemExit):  # argparse refuses a name it does not list
        train_cli.main([*common, "--model", "unet", "--max_iterations", "1"])
