"""The port's copies of the JAX package's numpy modules against the
originals, on seeded arrays: `data/nifti.py`, `data/preprocessing.py`,
`data/pancreas.py` and the whole of `evaluation/metrics.py`.

Tolerance: none. Every output must equal the original's exactly (arrays
element for element, NaN where the original has NaN, dtypes and shapes
equal; NIfTI files byte for byte once decompressed).
"""

import gzip
import math
import struct

import numpy as np
import pytest

from deformablelka_tpu.data import nifti as jnifti
from deformablelka_tpu.data import pancreas as jpancreas
from deformablelka_tpu.data import preprocessing as jpre
from deformablelka_tpu.evaluation import metrics as jmetrics
from deformablelka_tpu_torch.data import nifti as tnifti
from deformablelka_tpu_torch.data import pancreas as tpancreas
from deformablelka_tpu_torch.data import preprocessing as tpre
from deformablelka_tpu_torch.evaluation import metrics as tmetrics


def assert_same(got, ref):
    """Equal values, dtypes and structure; NaN matches NaN."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref)
        for k in ref:
            assert_same(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for a, b in zip(got, ref):
            assert_same(a, b)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(got)
    else:
        assert got == ref and type(got) is type(ref), (got, ref)


# ---------------------------------------------------------------- nifti

def _affine(rng):
    a = np.eye(4)
    a[:3, :3] = np.diag(rng.uniform(0.5, 4.0, 3))
    a[:3, 3] = rng.uniform(-100, 100, 3)
    return a


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32,
                                   np.float64, np.uint16, np.int64, np.bool_])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_round_trip_matches_jax(tmp_path, dtype, suffix):
    rng = np.random.RandomState(0)
    data = (rng.randn(7, 5, 4) * 50).astype(dtype)
    affine = _affine(rng)
    pt, pj = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    tnifti.save(data, pt, affine=affine)
    jnifti.save(data, pj, affine=affine)
    raw = lambda p: gzip.decompress(p.read_bytes()) if suffix == ".nii.gz" else p.read_bytes()
    assert raw(pt) == raw(pj)
    for loader in (tnifti.load, jnifti.load):
        got, ref = loader(pt), jnifti.load(pj)
        assert_same(got.data, ref.data)
        assert_same(got.affine, ref.affine)
        assert got.spacing == ref.spacing
        assert got.header.keys() == ref.header.keys()


def test_nifti_image_object_and_4d(tmp_path):
    rng = np.random.RandomState(1)
    img = tnifti.NiftiImage(rng.randn(3, 4, 5, 2).astype(np.float32), _affine(rng))
    tnifti.save(img, tmp_path / "t.nii")
    jnifti.save(jnifti.NiftiImage(img.data, img.affine), tmp_path / "j.nii")
    assert (tmp_path / "t.nii").read_bytes() == (tmp_path / "j.nii").read_bytes()
    assert_same(tnifti.load(tmp_path / "t.nii").data, img.data)


def _patched(path, out, **fields):
    """`path`'s bytes with header fields rewritten (little endian)."""
    raw = bytearray(path.read_bytes())
    offsets = {"scl": (112, "<2f"), "codes": (252, "<2h"), "quatern": (256, "<6f"),
               "pixdim": (76, "<8f")}
    for name, values in fields.items():
        off, fmt = offsets[name]
        struct.pack_into(fmt, raw, off, *values)
    out.write_bytes(bytes(raw))
    return out


@pytest.mark.parametrize("fields", [
    {"scl": (2.5, -3.0)},                                   # slope and intercept
    {"scl": (0.0, 4.0)},                                    # slope 0 means 1
    {"codes": (1, 0), "quatern": (0.1, -0.2, 0.3, 5.0, -6.0, 7.0),
     "pixdim": (-1.0, 1.5, 2.0, 3.0, 1, 1, 1, 1)},          # qform, qfac -1
    {"codes": (0, 0)},                                      # pixdim only
])
def test_nifti_header_paths_match_jax(tmp_path, fields):
    rng = np.random.RandomState(2)
    base = tmp_path / "base.nii"
    jnifti.save((rng.randn(6, 5, 3) * 10).astype(np.int16), base, affine=_affine(rng))
    p = _patched(base, tmp_path / "p.nii", **fields)
    got, ref = tnifti.load(p), jnifti.load(p)
    assert_same(got.data, ref.data)
    assert_same(got.affine, ref.affine)
    assert got.header == ref.header


def test_nifti_big_endian_and_errors(tmp_path):
    data = np.arange(24, dtype=">i4").reshape(2, 3, 4)
    hdr = bytearray(352)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 2, 3, 4, 1, 1, 1, 1)
    struct.pack_into(">2h", hdr, 70, 8, 32)
    struct.pack_into(">8f", hdr, 76, 1, 1, 2, 3, 1, 1, 1, 1)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">f", hdr, 112, 1.0)
    p = tmp_path / "be.nii"
    p.write_bytes(bytes(hdr) + data.tobytes(order="F"))
    got, ref = tnifti.load(p), jnifti.load(p)
    assert_same(got.data, ref.data)
    assert_same(got.affine, ref.affine)
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\0" * 400)
    for loader in (tnifti.load, jnifti.load):
        with pytest.raises(ValueError):
            loader(bad)


# ---------------------------------------------------------- preprocessing

def _volume(rng, shape=(2, 9, 12, 10), hole=True):
    """Two channels, zero outside a box, a hole inside the box."""
    data = np.zeros(shape, np.float32)
    data[:, 2:7, 3:10, 1:8] = rng.randn(shape[0], 5, 7, 7) * 100 + 50
    if hole:
        data[:, 4, 6, 4] = 0
    return data


def test_crop_helpers_match_jax():
    rng = np.random.RandomState(3)
    data = _volume(rng)
    assert_same(tpre.create_nonzero_mask(data), jpre.create_nonzero_mask(data))
    for mask in (data[0] != 0, np.zeros((4, 5, 6), bool)):
        assert_same(tpre.get_nonzero_bbox(mask), jpre.get_nonzero_bbox(mask))
    seg = rng.randint(0, 3, (1, *data.shape[1:])).astype(np.int16)
    assert_same(tpre.crop_to_nonzero(data.copy(), seg.copy()),
                jpre.crop_to_nonzero(data.copy(), seg.copy()))
    assert_same(tpre.crop_to_nonzero(data.copy()), jpre.crop_to_nonzero(data.copy()))


@pytest.mark.parametrize("spacing", [(1, 1, 1), (3.5, 1, 1), (1, 0.2, 1), (2.9, 1, 1)])
def test_spacing_rules_match_jax(spacing):
    assert_same(bool(tpre.get_do_separate_z(spacing)), bool(jpre.get_do_separate_z(spacing)))
    assert tpre.get_lowres_axis(spacing) == jpre.get_lowres_axis(spacing)


@pytest.mark.parametrize("is_seg,order,sep,order_z", [
    (False, 3, False, 0), (False, 1, True, 0), (False, 3, True, 1),
    (True, 1, False, 0), (True, 0, False, 0), (True, 1, True, 0)])
def test_resample_data_or_seg_matches_jax(is_seg, order, sep, order_z):
    rng = np.random.RandomState(4)
    if is_seg:
        data = rng.randint(-1, 4, (2, 6, 9, 8)).astype(np.int16)
    else:
        data = rng.randn(2, 6, 9, 8).astype(np.float32)
    for new_shape in ((9, 7, 8), (6, 9, 8), (4, 12, 5)):
        got = tpre.resample_data_or_seg(data, new_shape, is_seg, 0 if sep else None,
                                        order, order_z, sep)
        ref = jpre.resample_data_or_seg(data, new_shape, is_seg, 0 if sep else None,
                                        order, order_z, sep)
        assert_same(got, ref)


@pytest.mark.parametrize("orig,target,force", [
    ((4.0, 1.0, 1.0), (3.0, 0.8, 0.8), None),     # separate z from the original
    ((1.0, 1.0, 1.0), (3.5, 0.8, 0.8), None),     # separate z from the target
    ((1.2, 1.0, 0.9), (1.0, 1.0, 1.0), None),     # isotropic-ish: no separate z
    ((1.2, 1.0, 0.9), (1.0, 1.0, 1.0), True),
    ((4.0, 1.0, 1.0), (3.0, 0.8, 0.8), False)])
def test_resample_patient_matches_jax(orig, target, force):
    rng = np.random.RandomState(5)
    data = rng.randn(1, 6, 10, 9).astype(np.float32)
    seg = rng.randint(-1, 3, (1, 6, 10, 9)).astype(np.int16)
    assert_same(tpre.resample_patient(data, seg, orig, target, force_separate_z=force),
                jpre.resample_patient(data, seg, orig, target, force_separate_z=force))
    assert_same(tpre.resample_patient(None, seg, orig, target),
                jpre.resample_patient(None, seg, orig, target))


def test_normalisations_match_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(8, 9, 7) * 300).astype(np.float32)
    assert_same(tpre.ct_normalize(x, -200.0, 250.0, 30.0, 80.0),
                jpre.ct_normalize(x, -200.0, 250.0, 30.0, 80.0))
    assert_same(tpre.ct2_normalize(x, -200.0, 250.0), jpre.ct2_normalize(x, -200.0, 250.0))
    data = _volume(rng, (2, 9, 12, 10))
    seg = np.where(data[:1] != 0, 0, -1).astype(np.int16)
    for mask in (False, True):
        assert_same(tpre.nonct_normalize(data, seg, mask), jpre.nonct_normalize(data, seg, mask))


@pytest.mark.parametrize("schemes,nonzero,tf", [
    (["CT"], [False], (0, 1, 2)),
    (["CT2"], [False], (0, 1, 2)),
    (["nonCT", "nonCT"], [False, False], (0, 1, 2)),
    (["nonCT", "nonCT"], [True, True], (2, 0, 1)),
    (["noNorm", "rgb01"], [False, False], (0, 1, 2))])
def test_generic_preprocessor_matches_jax(schemes, nonzero, tf):
    rng = np.random.RandomState(7)
    C = len(schemes)
    data = _volume(rng, (C, 9, 16, 14))
    data[:, 2:7, 3:10, 1:8] = rng.randn(C, 5, 7, 7) * 300 - 200
    seg = rng.randint(0, 3, (1, 9, 16, 14)).astype(np.int16)
    props = {0: {"percentile_00_5": -500, "percentile_99_5": 300, "mean": 20.0,
                 "sd": 90.0}}
    spacing = (3.6, 0.9, 0.8)
    kw = dict(normalization_schemes=schemes, use_nonzero_mask=nonzero,
              target_spacing=[3.0, 0.76, 0.76], intensity_properties=props,
              transpose_forward=tf)
    for s in (None, seg):
        got = tpre.GenericPreprocessor(**kw).preprocess(
            data.copy(), spacing, None if s is None else s.copy())
        ref = jpre.GenericPreprocessor(**kw).preprocess(
            data.copy(), spacing, None if s is None else s.copy())
        assert_same(got, ref)
    assert got[0].shape[1:] != data.shape[1:]  # it resampled


# ---------------------------------------------------------------- pancreas

def test_pancreas_crops_match_jax():
    rng = np.random.RandomState(8)
    image = rng.randn(30, 20, 12).astype(np.float32)
    label = rng.randint(0, 2, (30, 20, 12)).astype(np.int32)
    for size in ((16, 16, 16), (30, 8, 12), (40, 24, 10)):
        assert_same(tpancreas._pad_to_crop(image, label, size),
                    jpancreas._pad_to_crop(image, label, size))
        assert_same(tpancreas.center_crop(image, label, size),
                    jpancreas.center_crop(image, label, size))
        assert_same(tpancreas.random_crop(image, label, size, np.random.RandomState(1)),
                    jpancreas.random_crop(image, label, size, np.random.RandomState(1)))
    for seed in range(4):
        assert_same(tpancreas.random_rot_flip(image, label, np.random.RandomState(seed)),
                    jpancreas.random_rot_flip(image, label, np.random.RandomState(seed)))


def test_read_fold_list_matches_jax(tmp_path):
    flods = tmp_path / "Pancreas" / "Flods"
    flods.mkdir(parents=True)
    (flods / "test0.list").write_text("a.h5\n\nb/c.h5\n")
    (tmp_path / "train0.list").write_text("d.h5\n")
    for name in ("test0.list", "train0.list"):
        assert_same(tpancreas.read_fold_list(tmp_path, name),
                    jpancreas.read_fold_list(tmp_path, name))


def test_h5_cases_and_loader_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(9)
    paths = []
    for i in range(2):
        p = tmp_path / f"case{i}.h5"
        with h5py.File(p, "w") as f:
            f["image"] = rng.randn(20, 18, 10).astype(np.float64)
            f["label"] = rng.randint(0, 2, (20, 18, 10)).astype(np.uint8)
        paths.append(str(p))
        assert_same(tpancreas.load_case_h5(p), jpancreas.load_case_h5(p))
    kw = dict(crop_size=(16, 16, 12), batch_size=2, rot_flip=True, seed=3)
    tl, jl = tpancreas.PancreasDataLoader(paths, **kw), jpancreas.PancreasDataLoader(paths, **kw)
    for _ in range(3):
        assert_same(tl.next_batch(), jl.next_batch())
    assert_same(next(iter(tl)), next(iter(jl)))


# ---------------------------------------------------------------- metrics

def _masks(seed, shape=(14, 12, 10)):
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    a = np.linalg.norm(g - rng.uniform(4, 8, 3), axis=-1) < rng.uniform(3, 5)
    b = np.linalg.norm(g - rng.uniform(4, 8, 3), axis=-1) < rng.uniform(3, 5)
    b ^= rng.rand(*shape) < 0.02
    return a, b


CASES = [_masks(10), _masks(11), (_masks(12)[0], np.zeros((14, 12, 10), bool)),
         (np.zeros((14, 12, 10), bool), np.zeros((14, 12, 10), bool))]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("spacing", [None, (2.0, 0.8, 0.7)])
def test_metrics_match_jax(case, spacing):
    a, b = CASES[case]
    assert_same(tmetrics.dice(a, b), jmetrics.dice(a, b))
    assert_same(tmetrics.dice(a, b, nan_for_nonexisting=False),
                jmetrics.dice(a, b, nan_for_nonexisting=False))
    assert_same(tmetrics.jaccard(a, b), jmetrics.jaccard(a, b))
    for name in ("hd", "hd95", "asd", "assd"):
        assert_same(getattr(tmetrics, name)(a, b, spacing),
                    getattr(jmetrics, name)(a, b, spacing))
    for conn in (1, 3):
        got = tmetrics.surface_distances(a, b, spacing, conn)
        ref = jmetrics.surface_distances(a, b, spacing, conn)
        assert (got is None) == (ref is None)
        if ref is not None:
            assert_same(got, ref)
        assert_same(tmetrics.normalized_surface_dice(a, b, 1.5, spacing, conn),
                    jmetrics.normalized_surface_dice(a, b, 1.5, spacing, conn))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_confusion_matrix_matches_jax(case):
    a, b = CASES[case]
    got, ref = tmetrics.ConfusionMatrix(a, b), jmetrics.ConfusionMatrix(a, b)
    for field in ("tp", "fp", "fn", "tn", "pred_empty", "gt_empty"):
        assert_same(getattr(got, field), getattr(ref, field))
    for method in ("dice", "jaccard", "precision", "recall", "specificity", "accuracy"):
        assert_same(getattr(got, method)(), getattr(ref, method)())


def test_per_class_metrics_match_jax():
    rng = np.random.RandomState(13)
    pred = rng.randint(0, 4, (12, 10, 8))
    gt = np.where(rng.rand(12, 10, 8) < 0.8, pred, rng.randint(0, 4, (12, 10, 8)))
    gt[gt == 3] = 0  # a label the reference lacks
    for surface in (True, False):
        assert_same(tmetrics.per_class_metrics(pred, gt, [1, 2, 3], (1.5, 1, 1), surface),
                    jmetrics.per_class_metrics(pred, gt, [1, 2, 3], (1.5, 1, 1), surface))
