"""The port's 2D CLIs on the CPU at 64² (the full-width flagship, batch 2),
and its MaxViT backbone loader against the JAX package's.

- `train_synapse2d.main` on 4 synthetic npz slices with the eval hook on
  two h5 volumes (h5py), 2 epochs × 2 batches: the hook at epoch 2 with a
  Dice in [0, 1], `best_model` and `epoch_2` written; then
  `test_synapse2d.main` on `best_model`: its labels equal those of the
  trained model's own `Predictor2D` (the same weights, the same CPU ops),
  and its NIfTI predictions read back;
- `train_skin.main --evaluate` on 224²-style npy data at 64²: the
  best-validation checkpoint and finite test metrics;
- an unknown `--model` name raises `ValueError` in the three CLIs (the
  zoo's names run in `test_torch_zoo_transunet.py`);
- `convert.backbone.load_maxvit_backbone` against JAX's
  `load_maxvit_backbone` on a `.pth` written from a port encoder (bare
  timm keys, a `backbone.` or `backbone.backbone.` prefix, a
  "state_dict" wrapper, timm's classifier beside it): every parameter
  equal, exactly, through `convert.jax_params.state_dict_from_jax`. The
  port also loads the file's batch-norm statistics, as upstream's
  `load_state_dict` does; the JAX loader keeps the model's.
"""

import jax
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert import torch_loader as jtl
from deformablelka_tpu.models.maxvit_dlka import MaxViTDeformableLKAFormer as JModel
from deformablelka_tpu_torch import trainer2d_path
from deformablelka_tpu_torch.cli import test_synapse2d, train_skin, train_synapse2d
from deformablelka_tpu_torch.convert.backbone import load_maxvit_backbone
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.inference.predictor2d import Predictor2D
from deformablelka_tpu_torch.models.maxvit import MaxViT4Out
from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer
from deformablelka_tpu_torch.nn.layers import init_parameters

from test_torch_maxvit import carry, jax_variables

torch.set_num_threads(1)
IMG = 64


@pytest.fixture(scope="module")
def synapse_run(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    tmp = tmp_path_factory.mktemp("cli2d")
    trainer2d_path.write_slices(tmp / "npz", tmp / "lists", n=4, size=80)
    cases = trainer2d_path.volumes(2, (3, 80, 80))
    (tmp / "vol").mkdir()
    for image, label, name in cases:
        with h5py.File(tmp / "vol" / f"{name}.npy.h5", "w") as f:
            f["image"] = image
            f["label"] = label.astype(np.uint8)
    (tmp / "lists" / "test_vol.txt").write_text("\n".join(n for _, _, n in cases) + "\n")
    trainer = train_synapse2d.main(trainer2d_path.synapse_argv(
        tmp / "npz", tmp / "lists", tmp / "out", "--volume_path", str(tmp / "vol"),
        img=IMG, batch=2, device="cpu"))
    return tmp, cases, trainer


def test_train_synapse2d_cli(synapse_run):
    tmp, _, trainer = synapse_run
    assert trainer.epoch == 2 and trainer.step == 4 and len(trainer.losses) == 2
    assert np.all(np.isfinite(trainer.losses))
    ((epoch, dice),) = trainer.eval_results
    assert epoch == 2 and 0.0 <= dice <= 1.0
    assert (tmp / "out" / "ckpt" / "best_model").is_dir()
    assert (tmp / "out" / "ckpt" / "epoch_2").is_dir()


def test_test_synapse2d_cli_reads_the_checkpoint(synapse_run):
    tmp, cases, trainer = synapse_run
    per_case = test_synapse2d.main([
        "--volume_path", str(tmp / "vol"), "--list_dir", str(tmp / "lists"),
        "--output_dir", str(tmp / "out"), "--img_size", str(IMG), "--is_savenii",
        "--test_save_dir", str(tmp / "pred"), "--device", "cpu"])
    own = Predictor2D(trainer.model, (IMG, IMG), 9, device="cpu")
    assert [c[0] for c in per_case] == [n for _, _, n in cases]
    for (name, md, mh, labels), (image, label, _) in zip(per_case, cases):
        pred, per_class = own.evaluate_case(image, label)
        np.testing.assert_array_equal(labels, pred)
        assert md == pytest.approx(np.mean([d for d, _ in per_class]))
        assert mh == pytest.approx(np.mean([h for _, h in per_class]))
        saved = nifti.load(tmp / "pred" / f"{name}_pred.nii.gz")
        np.testing.assert_array_equal(np.asarray(saved.data), pred.astype(np.float32))


def test_train_skin_cli_evaluates_the_best_checkpoint(tmp_path):
    root = trainer2d_path.write_skin(tmp_path / "data", (4, 2, 2), size=IMG)
    trainer = train_skin.main(trainer2d_path.skin_argv(root, tmp_path / "out", img=IMG,
                                                       batch=2, device="cpu"))
    assert (tmp_path / "out" / "best_model").is_dir()
    assert np.isfinite(trainer.best_val_loss) and len(trainer.epoch_times) == 2
    best = trainer.test_metrics["best"]
    for k in ("dsc", "accuracy", "specificity", "sensitivity", "jaccard"):
        assert np.isfinite(best[k]) and 0.0 <= best[k] <= 1.0, k
    assert best["tp"] + best["tn"] + best["fp"] + best["fn"] == 2 * IMG * IMG


@pytest.mark.parametrize("main,argv", [
    (train_synapse2d.main, ["--root_path", "x", "--list_dir", "y"]),
    (test_synapse2d.main, ["--volume_path", "x", "--list_dir", "y", "--output_dir", "z"]),
    (train_skin.main, ["--root_path", "x"])], ids=["train_synapse2d", "test_synapse2d",
                                                   "train_skin"])
def test_an_unknown_model_name_raises(main, argv):
    with pytest.raises(ValueError, match="unknown 2D model 'no_such_net'"):
        main(argv + ["--model", "no_such_net", "--device", "cpu"])


@pytest.fixture(scope="module")
def backbone_file(tmp_path_factory):
    """A port encoder's state_dict with random weights and statistics, and
    the JAX flagship's variables at 64² as the loaders' template."""
    enc = MaxViT4Out(img_size=IMG)
    init_parameters(enc, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in enc.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    jm = JModel(num_classes=9, img_size=IMG, deformable=True)
    v = jax_variables(jm, np.zeros((1, IMG, IMG, 1), np.float32), seed=5)
    return tmp_path_factory.mktemp("backbone"), enc.state_dict(), v


@pytest.mark.parametrize("layout", ["bare", "backbone.", "backbone.backbone.", "wrapped"])
def test_backbone_loader_matches_jax(backbone_file, layout):
    tmp, sd, v = backbone_file
    if layout == "wrapped":
        obj = {"state_dict": dict(sd), "epoch": 3}
    else:
        obj = {("" if layout == "bare" else layout) + k: t for k, t in sd.items()}
    obj_sd = obj["state_dict"] if layout == "wrapped" else obj
    obj_sd[("" if layout in ("bare", "wrapped") else layout) + "head.fc.weight"] = torch.zeros(3, 4)
    path = tmp / f"{layout}.pth"
    torch.save(obj, path)

    jparams = jtl.load_maxvit_backbone(str(path), v["params"])
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jparams),
                                "batch_stats": v["batch_stats"]},
                               MaxViTDeformableLKAFormer(9, IMG))
    tm = carry(v, MaxViTDeformableLKAFormer(9, IMG))
    load_maxvit_backbone(tm, path)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    stats = ("running_mean", "running_var")
    for k in want:
        if k.startswith("backbone.backbone.") and k.endswith(stats):
            torch.testing.assert_close(got[k], sd[k[len("backbone.backbone."):]],
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # the encoder's weights did change: the file's, not the template's
    k = "backbone.backbone.stem.conv1.weight"
    torch.testing.assert_close(got[k], sd["stem.conv1.weight"], rtol=0, atol=0)
