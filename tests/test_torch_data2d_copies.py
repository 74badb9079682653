"""The port's copies of the 2D data, skin and loss modules against the JAX
package's, on the CPU.

Exact (the same numpy and scipy calls on both sides): `SliceAugmenter`
from the same `RandomState`, `zoom_to`, `normalize_05`,
`SynapseDataset2D` and `SynapseLoader2D` over a tmp set of npz slices and
h5 volumes, `dataset_normalized`, `boundary_extraction`,
`prepare_skin_dataset`, `ISICLoader`, and the skin metrics
(`postprocess_skin_mask`, `binary_pixel_metrics`,
`evaluate_skin_predictions`, the PNG dump). The skin model loop
`evaluate_skin_model` (torch here, JAX there) on the same thresholding
model: the same metrics. `dice_ce_2d_loss` and `bce_with_logits` against
JAX to 1e-6 (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.data import skin as jskin
from deformablelka_tpu.data import synapse2d as jsyn
from deformablelka_tpu.evaluation import skin_eval as jeval
from deformablelka_tpu.training import losses as jlosses
from deformablelka_tpu.training import trainer2d as jtrainer
from deformablelka_tpu_torch import trainer2d_path
from deformablelka_tpu_torch.data import skin as tskin
from deformablelka_tpu_torch.data import synapse2d as tsyn
from deformablelka_tpu_torch.evaluation import skin_eval as teval
from deformablelka_tpu_torch.training import losses as tlosses
from deformablelka_tpu_torch.training import trainer2d as ttrainer

torch.set_num_threads(1)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slice_augmenter_is_the_jax_copy(seed):
    """Ten draws of SomeOf((0,4)) over the op set from one RandomState:
    the same ops, the same parameters, the same pixels."""
    img, lab = trainer2d_path._organs(np.random.RandomState(seed), (48, 40), 9)
    img = img * 255
    ja = jsyn.SliceAugmenter(np.random.RandomState(seed), 9)
    ta = tsyn.SliceAugmenter(np.random.RandomState(seed), 9)
    for _ in range(10):
        _equal_trees(ja(img, lab), ta(img, lab))


def test_zoom_and_normalize_are_the_jax_copies():
    img, lab = trainer2d_path._organs(np.random.RandomState(4), (50, 36), 9)
    _equal_trees(jsyn.zoom_to(img, lab, (32, 32)), tsyn.zoom_to(img, lab, (32, 32)))
    _equal_trees(jsyn.normalize_05(img), tsyn.normalize_05(img))


@pytest.fixture(scope="module")
def synapse_set(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("synapse2d")
    names = trainer2d_path.write_slices(tmp / "npz", tmp / "lists", n=5, size=40)
    h5py = pytest.importorskip("h5py")
    cases = trainer2d_path.volumes(2, (3, 40, 40))
    for image, label, name in cases:
        with h5py.File(tmp / "npz" / f"{name}.npy.h5", "w") as f:
            f["image"] = image
            f["label"] = label.astype(np.uint8)
    (tmp / "lists" / "test_vol.txt").write_text("\n".join(n for _, _, n in cases) + "\n")
    return tmp, names


@pytest.mark.parametrize("augment", [True, False])
def test_synapse_dataset_and_loader_are_the_jax_copies(synapse_set, augment):
    tmp, names = synapse_set
    kw = dict(img_size=32, seed=7, num_classes=9, augment=augment)
    jd = jsyn.SynapseDataset2D(tmp / "npz", tmp / "lists", "train", **kw)
    td = tsyn.SynapseDataset2D(tmp / "npz", tmp / "lists", "train", **kw)
    assert len(td) == len(jd) == len(names)
    for i in range(len(td)):
        _equal_trees(jd.get(i), td.get(i))
    jl, tl = jsyn.SynapseLoader2D(jd, 2), tsyn.SynapseLoader2D(td, 2)
    assert tl.num_batches == jl.num_batches == 2
    for _ in range(5):  # past the end of an epoch: a new shuffle
        _equal_trees(jl.next(), tl.next())


def test_synapse_test_volumes_are_the_jax_copies(synapse_set):
    tmp, _ = synapse_set
    jd = jsyn.SynapseDataset2D(tmp / "npz", tmp / "lists", "test_vol", img_size=32)
    td = tsyn.SynapseDataset2D(tmp / "npz", tmp / "lists", "test_vol", img_size=32)
    assert len(td) == 2
    for i in range(2):
        _equal_trees(jd.get(i), td.get(i))


def test_skin_normalisation_and_boundary_are_the_jax_copies():
    rng = np.random.RandomState(0)
    imgs = rng.rand(4, 12, 10, 3) * 100
    np.testing.assert_array_equal(jskin.dataset_normalized(imgs.copy()),
                                  tskin.dataset_normalized(imgs.copy()))
    m = (rng.rand(16, 16) > 0.7).astype(np.float64)
    np.testing.assert_array_equal(jskin.boundary_extraction(m), tskin.boundary_extraction(m))


def test_prepare_skin_dataset_is_the_jax_copy(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    imgs, masks = [], []
    for i in range(6):
        ip, mp = tmp_path / f"img{i}.png", tmp_path / f"img{i}_segmentation.png"
        Image.fromarray((rng.rand(30, 26, 3) * 255).astype(np.uint8)).save(ip)
        Image.fromarray(((rng.rand(30, 26) > 0.5) * 255).astype(np.uint8)).save(mp)
        imgs.append(ip)
        masks.append(mp)
    jout = jskin.prepare_skin_dataset(imgs, masks, tmp_path / "jax", height=20, width=20)
    tout = tskin.prepare_skin_dataset(imgs, masks, tmp_path / "port", height=20, width=20)
    for split in ("train", "val", "test"):
        for kind in ("data", "mask"):
            np.testing.assert_array_equal(np.load(jout / f"{kind}_{split}.npy"),
                                          np.load(tout / f"{kind}_{split}.npy"))


@pytest.mark.parametrize("split,boundary", [("train", True), ("val", False), ("test", True)])
def test_isic_loader_is_the_jax_copy(tmp_path, split, boundary):
    root = trainer2d_path.write_skin(tmp_path, (7, 3, 3), size=24)
    jl = jskin.ISICLoader(root, split, batch_size=2, seed=3, with_boundary=boundary)
    tl = tskin.ISICLoader(root, split, batch_size=2, seed=3, with_boundary=boundary)
    for _ in range(2):  # two epochs: the flips and shuffles go on from one RandomState
        _equal_trees(list(jl.epoch()), list(tl.epoch()))


def _skin_cases(seed=1, n=5, hw=20):
    rng = np.random.RandomState(seed)
    gts, preds, items = [], [], []
    for _ in range(n):
        m = np.zeros((hw, hw), np.float32)
        y0, x0 = rng.randint(0, hw // 2, 2)
        m[y0:y0 + hw // 2, x0:x0 + hw // 2] = 1
        p = np.clip(m * 0.8 + rng.rand(hw, hw) * 0.4, 0, 1).astype(np.float32)
        gts.append(m)
        preds.append(p)
        items.append({"image": np.repeat(p[..., None], 3, -1), "mask": m})
    return gts, preds, items


def test_skin_metrics_are_the_jax_copies():
    gts, preds, _ = _skin_cases()
    b = (preds[0] >= 0.5).astype(np.uint8)
    for op, fi in ((6, 6), (0, 3), (3, 0), (0, 0)):
        np.testing.assert_array_equal(jeval.postprocess_skin_mask(b, op, fi),
                                      teval.postprocess_skin_mask(b, op, fi))
    _equal_trees(jeval.binary_pixel_metrics(gts[0], preds[0]),
                 teval.binary_pixel_metrics(gts[0], preds[0]))
    kw = dict(opening_sizes=(0, 2, 6), fill_sizes=(0, 3))
    _equal_trees(jeval.evaluate_skin_predictions(gts, preds, **kw),
                 teval.evaluate_skin_predictions(gts, preds, **kw))


def test_skin_model_evaluation_matches_jax(tmp_path):
    """The torch loop and the JAX one on the same sigmoid model (the
    channel mean, scaled): batches of 2 with the last one padded, the same
    metrics, the same PNG dump."""
    _, _, items = _skin_cases(seed=2)
    ref = jeval.evaluate_skin_model(
        lambda p, x: 1 / (1 + jnp.exp(-p * (x.mean(-1, keepdims=True) - 0.5))), 8.0, items,
        batch_size=2, opening_sizes=(0, 2), fill_sizes=(0,), vis_dir=tmp_path / "jax",
        max_vis=2)
    got = teval.evaluate_skin_model(
        lambda x: torch.sigmoid(8.0 * (x.mean(-1, keepdim=True) - 0.5)), items,
        batch_size=2, opening_sizes=(0, 2), fill_sizes=(0,), vis_dir=tmp_path / "port",
        max_vis=2, device="cpu")
    _equal_trees(ref, got)
    for i in (1, 2):
        for kind in ("img", "gt", "pred"):
            assert (tmp_path / "port" / str(i) / f"{kind}_{i}.png").exists()


@pytest.mark.parametrize("seed", [0, 1])
def test_dice_ce_2d_loss_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(3, 7, 6, 9) * 2).astype(np.float32)
    labels = rng.randint(0, 9, (3, 7, 6))
    got = tlosses.dice_ce_2d_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = jlosses.dice_ce_2d_loss(jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_bce_with_logits_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, 9, 8, 1) * 4).astype(np.float32)
    labels = (rng.rand(2, 9, 8) > 0.5).astype(np.float32)
    got = ttrainer.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = jtrainer.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)


def test_reduce_lr_on_plateau_is_the_jax_copy():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.89999, 0.5, 0.6, 0.6, 0.6, 0.6]
    j, t = jtrainer.ReduceLROnPlateau(patience=2), ttrainer.ReduceLROnPlateau(patience=2)
    assert [j.step(m) for m in metrics] == [t.step(m) for m in metrics]
    assert t.scale == 0.25
