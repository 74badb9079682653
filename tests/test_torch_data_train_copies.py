"""The port's copies of the JAX package's training-data and validation
modules against the originals, on seeded arrays: `native` (the C++
resampler), `data/dataset.py`, `data/augment.py`,
`evaluation/evaluator.py` and `evaluation/postprocessing.py`.

Tolerance: none. Every output must equal the original's exactly (arrays
element for element, dtypes and shapes equal, dicts and JSON files equal).
The port's `largest_cc_only` removes the small objects in one pass rather
than one per object; it must give the original's results all the same.
"""

import json
import pickle

import numpy as np
import pytest

from deformablelka_tpu import native as jnative
from deformablelka_tpu.data import augment as jaug
from deformablelka_tpu.data import dataset as jds
from deformablelka_tpu.evaluation import evaluator as jeval
from deformablelka_tpu.evaluation import postprocessing as jpost
from deformablelka_tpu_torch import native as tnative
from deformablelka_tpu_torch import trainer_path
from deformablelka_tpu_torch.data import augment as taug
from deformablelka_tpu_torch.data import dataset as tds
from deformablelka_tpu_torch.evaluation import evaluator as teval
from deformablelka_tpu_torch.evaluation import postprocessing as tpost

from test_torch_data_copies import assert_same

SHAPE = (20, 40, 36)
PATCH = (16, 32, 32)
DS_SCALES = [[1, 1, 1], [0.5, 0.25, 0.25], [0.25, 0.125, 0.125]]


def _batch_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_same(got[k], ref[k])


# ---------------------------------------------------------------- native

def test_native_builds_in_the_port():
    tnative.num_threads()
    jnative.num_threads()
    assert tnative.HAVE_NATIVE and jnative.HAVE_NATIVE
    assert tnative._LIB.parent.name == "_build"
    assert tnative._LIB.parent.parent.name == "deformablelka_tpu_torch"


@pytest.mark.parametrize("order", [0, 1, 3])
def test_native_affine_transform_matches_jax(order):
    rng = np.random.RandomState(order)
    vol = rng.randn(14, 17, 12).astype(np.float32)
    a = rng.uniform(-0.5, 0.5, 3)
    c, s = np.cos(a), np.sin(a)
    mat = (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
           @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])) * 1.1
    offset = rng.uniform(-3, 3, 3)
    got = tnative.affine_transform(vol, mat, offset, (11, 13, 9), order=order,
                                   cval=-1.0)
    ref = jnative.affine_transform(vol, mat, offset, (11, 13, 9), order=order,
                                   cval=-1.0)
    assert_same(got, ref)


def test_native_spline_filter_matches_jax():
    vol = np.random.RandomState(4).randn(9, 15, 11)
    assert_same(tnative.spline_filter3(vol), jnative.spline_filter3(vol))


# ---------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A synthetic preprocessed folder (trainer_path's writer, 3 small
    cases), unpacked to npy by both packages' `unpack_dataset`."""
    d = tmp_path_factory.mktemp("pre")
    trainer_path.write_preprocessed(d, cases=3, shape=SHAPE)
    tds.unpack_dataset(d)
    jds.unpack_dataset(d)
    return d


def test_dataset_loading_matches_jax(folder, tmp_path):
    assert_same(tds.load_dataset(folder), jds.load_dataset(folder))
    entry = tds.load_dataset(folder)["case_001"]
    (got, gp), (ref, rp) = tds.load_case(entry), jds.load_case(entry)
    assert_same(np.asarray(got), np.asarray(ref))
    assert sorted(gp) == sorted(rp) == ["class_locations"]
    seg = np.asarray(ref[-1]).astype(np.int16)
    assert_same(tds.compute_class_locations(seg, range(1, 14), max_per_class=50),
                jds.compute_class_locations(seg, range(1, 14), max_per_class=50))
    # the npz is read when no npy was unpacked
    np.savez(tmp_path / "solo.npz", data=np.asarray(ref))
    solo = {"data_file": str(tmp_path / "solo.npz"),
            "properties_file": str(tmp_path / "solo.pkl")}
    assert_same(np.asarray(tds.load_case(solo)[0]), np.asarray(jds.load_case(solo)[0]))


def _prev_stage(folder, tmp_path):
    """`<case>_segFromPrevStage.npz` for every case: seeded labels 0-3."""
    rng = np.random.RandomState(7)
    for name in tds.load_dataset(folder):
        np.savez_compressed(tmp_path / f"{name}_segFromPrevStage.npz",
                            data=rng.randint(0, 4, SHAPE).astype(np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("case", ["random", "foreground", "larger_patch", "cascade",
                                  "cascade_classes"])
def test_dataloader3d_matches_jax(folder, tmp_path, case):
    ds = tds.load_dataset(folder)
    kw = {"random": dict(oversample_foreground_percent=0.0),
          "foreground": dict(oversample_foreground_percent=1.0),
          "larger_patch": {},
          "cascade": dict(seg_from_prev_stage_folder=_prev_stage(folder, tmp_path)),
          "cascade_classes": dict(seg_from_prev_stage_folder=_prev_stage(folder, tmp_path),
                                  cascade_classes=[1, 3])}[case]
    patch = (24, 44, 40) if case == "larger_patch" else PATCH
    got = tds.DataLoader3D(ds, patch, 3, rng=np.random.RandomState(5), **kw)
    ref = jds.DataLoader3D(ds, patch, 3, rng=np.random.RandomState(5), **kw)
    for _ in range(3):
        g, r = got.next(), ref.next()
        _batch_equal(g, r)
    assert g["data"].shape == (3, *patch, {"cascade": 4, "cascade_classes": 3}.get(case, 1))
    if case == "larger_patch":  # padded: zeros in the data, -1 in the seg
        assert (g["seg"] == -1).any()
    if case == "foreground":
        assert all((s > 0).any() for s in g["seg"])


@pytest.mark.parametrize("fg", [0.0, 1.0])
def test_dataloader2d_matches_jax(folder, fg):
    ds = tds.load_dataset(folder)
    got = tds.DataLoader2D(ds, (32, 48), 3, oversample_foreground_percent=fg,
                           rng=np.random.RandomState(6))
    ref = jds.DataLoader2D(ds, (32, 48), 3, oversample_foreground_percent=fg,
                           rng=np.random.RandomState(6))
    for _ in range(3):
        _batch_equal(got.next(), ref.next())


# ---------------------------------------------------------------- augment

@pytest.mark.parametrize("patch", [(64, 128, 128), (16, 32, 32), (224, 224)])
def test_get_patch_size_matches_jax(patch):
    rot = (-np.pi / 6, np.pi / 6)
    got = taug.get_patch_size(patch, rot, rot, rot, (0.7, 1.4))
    assert_same(got, jaug.get_patch_size(patch, rot, rot, rot, (0.7, 1.4)))
    if patch == (64, 128, 128):
        assert tuple(got) == (170, 204, 249)


def _augment_input(seed, spatial, channels=2):
    rng = np.random.RandomState(seed)
    data = rng.randn(2, *spatial, channels).astype(np.float32)
    seg = rng.randint(-1, 4, (2, *spatial)).astype(np.float32)
    return {"data": data, "seg": seg}


@pytest.mark.parametrize("variant,kw", [
    ("moreDA", {}),
    ("moreDA", dict(p_rot=1.0, p_scale=1.0)),
    ("insaneDA", {}),
    ("insaneDA", dict(p_elastic=1.0)),
    ("noDA", {}),
    ("moreDA", dict(do_mirror=False, p_rot=0.0, p_scale=0.0, do_elastic=False,
                    do_intensity=False)),
], ids=["moreDA", "moreDA_spatial", "insaneDA", "insaneDA_elastic", "noDA",
        "validation"])
def test_augmentation_variants_match_jax(variant, kw):
    enlarged = (24, 40, 40)
    got = taug.get_augmentation(variant, PATCH, deep_supervision_scales=DS_SCALES,
                                rng=np.random.RandomState(8), **kw)
    ref = jaug.get_augmentation(variant, PATCH, deep_supervision_scales=DS_SCALES,
                                rng=np.random.RandomState(8), **kw)
    for i in range(4):
        # an augmenter may write into its input's views: one copy each
        g, r = got(_augment_input(i, enlarged)), ref(_augment_input(i, enlarged))
        _batch_equal(g, r)
    assert g["data"].shape == (2, *PATCH, 2) and g["data"].dtype == np.float32
    assert [t.shape for t in g["target"]] == [(2, *PATCH), (2, 8, 8, 8), (2, 4, 4, 4)]
    assert all(t.dtype == np.int32 and t.min() >= 0 for t in g["target"])
    with pytest.raises(KeyError):
        taug.get_augmentation("fancyDA", PATCH)


def test_augmentation_2d_mirror_axes_match_jax():
    kw = dict(mirror_axes=(0, 1), p_rot=1.0, p_scale=1.0)
    got = taug.get_augmentation("moreDA", (32, 32), rng=np.random.RandomState(9), **kw)
    ref = jaug.get_augmentation("moreDA", (32, 32), rng=np.random.RandomState(9), **kw)
    for i in range(4):
        g = got(_augment_input(i, (40, 44), channels=3))
        _batch_equal(g, ref(_augment_input(i, (40, 44), channels=3)))
    assert g["data"].shape == (2, 32, 32, 3) and g["target"].shape == (2, 32, 32)


def test_threaded_augmenter_batch(folder):
    """One batch through the threads: shapes and dtypes (the order of the
    batches depends on the scheduler)."""
    ds = tds.load_dataset(folder)
    loader = tds.DataLoader3D(ds, (24, 40, 40), 2, rng=np.random.RandomState(1))
    aug = taug.get_augmentation("moreDA", PATCH, deep_supervision_scales=DS_SCALES,
                                rng=np.random.RandomState(2))
    gen = taug.ThreadedAugmenter(loader, aug, num_workers=2, queue_len=1)
    try:
        b = gen.next()
    finally:
        gen.stop()
        for t in gen.threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in gen.threads)
    assert b["data"].shape == (2, *PATCH, 1) and b["data"].dtype == np.float32
    assert [t.shape for t in b["target"]] == [(2, *PATCH), (2, 8, 8, 8), (2, 4, 4, 4)]
    assert all(t.dtype == np.int32 for t in b["target"])


# ---------------------------------------------------------------- evaluation

def _pairs(n=2, shape=(18, 22, 16)):
    """(pred, gt) pairs: seeded organ labels, the prediction with 3 % of
    its voxels flipped to random labels (many small objects) and one label
    missing from one side."""
    out = []
    for i in range(n):
        _, gt = trainer_path.synapse_case(i, shape, num_classes=6)
        rng = np.random.RandomState(10 + i)
        pred = gt.copy()
        flip = rng.rand(*shape) < 0.03
        pred[flip] = rng.randint(0, 6, flip.sum())
        pred[pred == 5] = 0
        out.append((pred, gt))
    return out


def test_aggregate_scores_matches_jax(tmp_path):
    pairs = _pairs()
    labels = list(range(6))
    got = teval.aggregate_scores(pairs, labels, json_output_file=tmp_path / "t.json",
                                 json_name="fold_0")
    ref = jeval.aggregate_scores(pairs, labels, json_output_file=tmp_path / "j.json",
                                 json_name="fold_0")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert json.dumps(got) == json.dumps(ref)


@pytest.mark.parametrize("kw", [{}, dict(minimum_valid_object_size={1: 3, 2: 1, 4: 50}),
                                dict(for_which_classes=[(1, 2), 3])],
                         ids=["all", "min_size", "groups"])
def test_largest_cc_only_matches_jax(kw):
    pred = _pairs(1, (24, 30, 20))[0][0]
    got, ref = tpost.largest_cc_only(pred, **kw), jpost.largest_cc_only(pred, **kw)
    assert_same(got[0], ref[0])
    assert got[1] == ref[1] and got[2] == ref[2]
    assert any(v is not None for v in ref[1].values())  # objects were removed


def test_determine_postprocessing_matches_jax(tmp_path):
    pairs = _pairs()
    got = tpost.determine_postprocessing(pairs, list(range(1, 6)),
                                         out_json=tmp_path / "t.json")
    ref = jpost.determine_postprocessing(pairs, list(range(1, 6)),
                                         out_json=tmp_path / "j.json")
    assert json.dumps(got) == json.dumps(ref)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_preprocessed_case_layout(folder):
    """trainer_path writes nnUNet's layout: data (2, x, y, z) with the seg
    last, class locations per foreground label."""
    data = np.load(folder / "case_000.npz")["data"]
    assert data.shape == (2, *SHAPE) and data.dtype == np.float32
    with open(folder / "case_000.pkl", "rb") as f:
        props = pickle.load(f)
    locs = props["class_locations"]
    assert sorted(locs) == list(range(1, 14))
    for c, coords in locs.items():
        assert all(data[1][tuple(v)] == c for v in coords[:20])
