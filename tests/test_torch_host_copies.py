"""The port's copies of the JAX package's nnUNet host modules against the
originals, on seeded data: `data/plans.py`, `data/sanity_checks.py`,
`data/experiment_planning.py` (every planner preset, and
`plan_and_preprocess` on a tiny raw task, whose folder the port's
`run_training` then trains from), `data/convert_tasks.py`,
`evaluation/region_based.py`, `evaluation/model_selection.py`,
`utils/overlay.py`, `utils/paths.py` and `cli/tools.py`.

Tolerance: none. Every result must equal the original's exactly (values,
dtypes, structure, NaN where the original has NaN); every file written
must equal the original's byte for byte (NIfTI and npz once
decompressed, pickles once loaded).
"""

import gzip
import json
import os
import pickle
import sys
from dataclasses import asdict
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from deformablelka_tpu.cli import tools as jtools
from deformablelka_tpu.data import convert_tasks as jconvert
from deformablelka_tpu.data import experiment_planning as jplan
from deformablelka_tpu.data import plans as jplans
from deformablelka_tpu.data import sanity_checks as jsanity
from deformablelka_tpu.evaluation import model_selection as jsel
from deformablelka_tpu.evaluation import region_based as jregion
from deformablelka_tpu.utils import overlay as joverlay
from deformablelka_tpu.utils import paths as jpaths
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.cli import tools as ttools
from deformablelka_tpu_torch.data import convert_tasks as tconvert
from deformablelka_tpu_torch.data import experiment_planning as tplan
from deformablelka_tpu_torch.data import nifti as tnifti
from deformablelka_tpu_torch.data import plans as tplans
from deformablelka_tpu_torch.data import sanity_checks as tsanity
from deformablelka_tpu_torch.evaluation import model_selection as tsel
from deformablelka_tpu_torch.evaluation import region_based as tregion
from deformablelka_tpu_torch.utils import overlay as toverlay
from deformablelka_tpu_torch.utils import paths as tpaths

from test_torch_data_copies import assert_same

torch.set_num_threads(1)
SPACING = (2.5, 1.0, 1.2)


def _raw_task(root, n=3, shape=(18, 30, 26), labels=3, modalities=1, seed=0):
    """A decathlon-style raw task: imagesTr/<case>_000M.nii.gz,
    labelsTr/<case>.nii.gz, dataset.json; CT-like intensities and a few
    labelled boxes per case."""
    root = Path(root)
    (root / "imagesTr").mkdir(parents=True)
    (root / "labelsTr").mkdir(parents=True)
    aff = np.diag([*SPACING, 1.0])
    training = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        s = tuple(d + 2 * i for d in shape)
        lab = np.zeros(s, np.int16)
        for c in range(1, labels):
            lo = rng.randint(2, 8, 3)
            lab[lo[0]:lo[0] + 6, lo[1]:lo[1] + 10, lo[2]:lo[2] + 8] = c
        for m in range(modalities):
            img = (rng.randn(*s) * 40 + 100 * lab - 50).astype(np.float32)
            img[:2] = 0  # a border outside the body
            tnifti.save(img, root / "imagesTr" / f"case_{i:03d}_{m:04d}.nii.gz", affine=aff)
        tnifti.save(lab, root / "labelsTr" / f"case_{i:03d}.nii.gz", affine=aff)
        training.append({"image": f"./imagesTr/case_{i:03d}.nii.gz",
                         "label": f"./labelsTr/case_{i:03d}.nii.gz"})
    (root / "dataset.json").write_text(json.dumps({
        "modality": {str(m): "CT" for m in range(modalities)},
        "labels": {str(c): f"class{c}" for c in range(labels)},
        "training": training}))
    return root


def _raw(path: Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if path.suffix == ".gz" else data


def _same_files(got_dir: Path, ref_dir: Path):
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*") if p.is_file())
    ref = sorted(p.relative_to(ref_dir) for p in ref_dir.rglob("*") if p.is_file())
    assert got == ref
    for rel in ref:
        g, r = got_dir / rel, ref_dir / rel
        if rel.suffix == ".npz":
            a, b = np.load(g), np.load(r)
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert_same(a[k], b[k])
        elif rel.suffix == ".pkl":
            assert_same(pickle.loads(g.read_bytes()), pickle.loads(r.read_bytes()))
        else:
            assert _raw(g) == _raw(r), rel


# ---------------------------------------------------------------- plans

def test_plans_load_and_config_match_jax(tmp_path):
    plans = {"num_classes": 2, "num_modalities": 1, "all_classes": [1, 2],
             "normalization_schemes": {0: "CT"}, "use_mask_for_norm": {0: False},
             "dataset_properties": {"intensityproperties": {0: {"mean": 1.5}}},
             "transpose_forward": [2, 0, 1], "transpose_backward": [1, 2, 0],
             "plans_per_stage": {0: {"patch_size": np.array([48, 160, 160]),
                                     "batch_size": 4, "current_spacing": [3.0, 1.5, 1.5],
                                     "original_spacing": [2.5, 0.8, 0.8],
                                     "pool_op_kernel_sizes": [[1, 2, 2], [2, 2, 2]]},
                                 1: {"patch_size": [32, 96, 96], "batch_size": 2,
                                     "current_spacing": [2.5, 0.8, 0.8],
                                     "original_spacing": [2.5, 0.8, 0.8]}}}
    path = tmp_path / "plans.pkl"
    path.write_bytes(pickle.dumps(plans))
    assert_same(tplans.load_plans(path), jplans.load_plans(path))
    # an instance of a class neither package can import loads as a stub
    fake = type(sys)("nnunet_gone")
    fake.Planner = type("Planner", (), {"__module__": "nnunet_gone"})
    with mock.patch.dict(sys.modules, {"nnunet_gone": fake}):
        (tmp_path / "stub.pkl").write_bytes(pickle.dumps({"planner": fake.Planner()}))
    stubs = [m.load_plans(tmp_path / "stub.pkl")["planner"] for m in (tplans, jplans)]
    assert [(type(o).__name__, type(o).__module__) for o in stubs] == [
        ("Planner", "nnunet_gone")] * 2
    for stage in (None, 0, 1):
        for override in (False, True):
            got = tplans.PlansConfig.from_plans(plans, stage, override)
            ref = jplans.PlansConfig.from_plans(plans, stage, override)
            assert asdict(got) == asdict(ref)


# ---------------------------------------------------------------- sanity checks

def test_sanity_checks_match_jax(tmp_path):
    raw = _raw_task(tmp_path / "ok", modalities=2)
    assert tsanity.verify_dataset_integrity(raw) == jsanity.verify_dataset_integrity(raw)
    a = tnifti.load(raw / "imagesTr" / "case_000_0000.nii.gz")
    b = tnifti.load(raw / "imagesTr" / "case_001_0000.nii.gz")
    for x, y in ((a, a), (a, b)):
        assert tsanity.verify_same_geometry(x, y) == jsanity.verify_same_geometry(x, y)
    lab = raw / "labelsTr" / "case_000.nii.gz"
    for valid in ([0, 1, 2], [0, 1]):
        assert_same(tsanity.verify_contains_only_expected_labels(lab, valid),
                    jsanity.verify_contains_only_expected_labels(lab, valid))
    assert (tsanity.verify_all_same_orientation(raw / "imagesTr")
            == jsanity.verify_all_same_orientation(raw / "imagesTr"))


@pytest.mark.parametrize("fault", ["label", "geometry", "nan", "labels_json", "duplicate"])
def test_sanity_checks_refuse_what_jax_refuses(tmp_path, fault):
    raw = _raw_task(tmp_path / fault)
    lab = raw / "labelsTr" / "case_001.nii.gz"
    img = raw / "imagesTr" / "case_001_0000.nii.gz"
    meta = json.loads((raw / "dataset.json").read_text())
    if fault == "label":
        seg = tnifti.load(lab)
        data = np.asarray(seg.data).copy()
        data[0, 0, 0] = 7
        tnifti.save(data, lab, affine=seg.affine)
    elif fault == "geometry":
        seg = tnifti.load(lab)
        tnifti.save(np.asarray(seg.data), lab, affine=np.diag([1.0, 1.0, 1.0, 1.0]))
    elif fault == "nan":
        im = tnifti.load(img)
        data = np.asarray(im.data).copy()
        data[3, 3, 3] = np.nan
        tnifti.save(data, img, affine=im.affine)
    elif fault == "labels_json":
        meta["labels"] = {"0": "bg", "2": "skip"}
    else:
        meta["training"].append(meta["training"][0])
    (raw / "dataset.json").write_text(json.dumps(meta))
    errors = []
    for check in (jsanity.verify_dataset_integrity, tsanity.verify_dataset_integrity):
        with pytest.raises(BaseException) as err:
            check(raw)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]
    assert tplan.verify_dataset_integrity(raw) == jplan.verify_dataset_integrity(raw)


# ---------------------------------------------------------------- planning

@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The raw task, its fingerprint from both packages, and both
    packages' preprocessed folders."""
    tmp = tmp_path_factory.mktemp("planning")
    raw = _raw_task(tmp / "raw")
    fp = (tplan.DatasetAnalyzer(raw).analyze(), jplan.DatasetAnalyzer(raw).analyze())
    plans = (tplan.plan_and_preprocess(raw, tmp / "port"),
             jplan.plan_and_preprocess(raw, tmp / "jax"))
    return dict(raw=raw, fp=fp, plans=plans, port=tmp / "port", jax=tmp / "jax")


def test_dataset_analyzer_matches_jax(task):
    assert_same(*task["fp"])


@pytest.mark.parametrize("variant", sorted(jplan.PLANNER_VARIANTS))
def test_planner_variant_matches_jax(task, variant):
    fp = task["fp"][1]
    assert_same(tplan.make_planner(fp, variant).plan(), jplan.make_planner(fp, variant).plan())
    assert tplan.PLANNER_VARIANTS[variant] == jplan.PLANNER_VARIANTS[variant]


def test_unknown_planner_raises():
    with pytest.raises(KeyError, match="unknown planner"):
        tplan.make_planner({}, "v99")


def test_plan_and_preprocess_matches_jax(task):
    assert_same(*task["plans"])
    _same_files(task["port"], task["jax"])
    names = sorted(p.name for p in task["port"].iterdir())
    assert names == ["case_000.npz", "case_000.pkl", "case_001.npz", "case_001.pkl",
                     "case_002.npz", "case_002.pkl", "plans_3D.pkl"]


def test_planning_cli_matches_jax(task, tmp_path):
    for main, out in ((tplan.main, "port"), (jplan.main, "jax")):
        main(["-t", str(task["raw"]), "-o", str(tmp_path / out), "-pl", "3convperstage"])
    _same_files(tmp_path / "port", tmp_path / "jax")
    plans = tplans.load_plans(tmp_path / "port" / "plans_3D.pkl")
    assert plans["conv_per_stage"] == 3


def test_run_training_trains_from_the_planned_folder(task, tmp_path):
    trainer = run_training.main([
        "2d", "d_lka_former_trainer_synapse", "Task001_Raw", "0",
        "--preprocessed_folder", str(task["port"]), "--output_folder", str(tmp_path),
        "--patch_size", "1", "32", "32", "--num_classes", "3", "--batches_per_epoch", "1",
        "--val_batches_per_epoch", "1", "--max_epochs", "1", "--device", "cpu"])
    assert trainer.step == 1 and np.isfinite(trainer.all_tr_losses).all()


# ---------------------------------------------------------------- task conversion

def test_split_4d_and_convert_decathlon_task_match_jax(tmp_path):
    for pkg, conv in (("port", tconvert), ("jax", jconvert)):
        task = tmp_path / pkg / "Task05_Prostate"
        (task / "imagesTr").mkdir(parents=True)
        (task / "imagesTs").mkdir()
        (task / "labelsTr").mkdir()
        aff = np.diag([0.6, 0.6, 3.6, 1.0])
        r = np.random.RandomState(3)
        tnifti.save(r.randn(10, 12, 6, 2).astype(np.float32),
                    task / "imagesTr" / "prostate_00.nii.gz", affine=aff)
        tnifti.save(r.randn(10, 12, 6).astype(np.float32),
                    task / "imagesTs" / "prostate_01.nii.gz", affine=aff)
        tnifti.save(r.randint(0, 3, (10, 12, 6)).astype(np.uint8),
                    task / "labelsTr" / "prostate_00.nii.gz", affine=aff)
        (task / "dataset.json").write_text(json.dumps({"name": "Prostate"}))
        out = conv.convert_decathlon_task(task)
        assert out == tmp_path / pkg / "Task005_Prostate"
        written = conv.split_4d_nifti(task / "imagesTs" / "prostate_01.nii.gz",
                                      tmp_path / pkg / "split")
        assert [p.name for p in written] == ["prostate_01_0000.nii.gz"]
    _same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("source", ["array_rgb", "array_seg", "png"])
def test_convert_2d_image_to_nifti_matches_jax(tmp_path, source):
    rng = np.random.RandomState(4)
    arr = rng.randint(0, 255, (9, 11, 3)).astype(np.uint8)
    if source == "png":
        from PIL import Image
        src = tmp_path / "img.png"
        Image.fromarray(arr).save(src)
    else:
        src = arr
    for pkg, conv in (("port", tconvert), ("jax", jconvert)):
        out = conv.convert_2d_image_to_nifti(src, tmp_path / pkg / "case.nii.gz",
                                             is_seg=source == "array_seg")
        assert out.parent == tmp_path / pkg
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_convert_tasks_cli_matches_jax(tmp_path):
    for pkg, conv in (("port", tconvert), ("jax", jconvert)):
        task = tmp_path / pkg / "Task7_Tiny"
        (task / "imagesTr").mkdir(parents=True)
        (task / "labelsTr").mkdir()
        tnifti.save(np.ones((4, 5, 3, 2), np.float32), task / "imagesTr" / "t_0.nii.gz")
        tnifti.save(np.ones((4, 5, 3), np.uint8), task / "labelsTr" / "t_0.nii.gz")
        (task / "dataset.json").write_text("{}")
        conv.main(["-i", str(task), "-id", "12"])
        assert (tmp_path / pkg / "Task012_Tiny" / "imagesTr" / "t_0_0001.nii.gz").exists()
    _same_files(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------- region-based evaluation

def _seg_pair(seed, shape=(8, 9, 7)):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 4, shape).astype(np.uint8), rng.randint(0, 4, shape).astype(np.uint8)


def test_region_based_evaluation_matches_jax(tmp_path):
    assert tregion.get_brats_regions() == jregion.get_brats_regions()
    assert tregion.get_kits_regions() == jregion.get_kits_regions()
    pred, gt = _seg_pair(0)
    gt_empty = np.where(gt == 3, 0, gt)
    for regions in (list(jregion.get_brats_regions().values()), [(3,), (1, 3)]):
        for g in (gt, gt_empty):
            assert_same(tregion.evaluate_case_regions(np.where(pred == 3, 0, pred), g, regions),
                        jregion.evaluate_case_regions(np.where(pred == 3, 0, pred), g, regions))
    assert_same(tregion.create_region_from_mask(pred, (1, 2)),
                jregion.create_region_from_mask(pred, (1, 2)))
    for d in ("pred", "gt"):
        (tmp_path / d).mkdir()
    for i in range(3):
        p, g = _seg_pair(i + 1)
        tnifti.save(p, tmp_path / "pred" / f"c{i}.nii.gz")
        tnifti.save(g, tmp_path / "gt" / f"c{i}.nii.gz")
    got = tregion.evaluate_regions(tmp_path / "pred", tmp_path / "gt",
                                   jregion.get_brats_regions(), tmp_path / "t.csv")
    ref = jregion.evaluate_regions(tmp_path / "pred", tmp_path / "gt",
                                   jregion.get_brats_regions(), tmp_path / "j.csv")
    assert_same(got, ref)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


# ---------------------------------------------------------------- model selection

def _validation_folders(root, folds=(0,), cases=("a", "b"), props=True):
    rng = np.random.RandomState(7)
    for exp in ("exp1", "exp2"):
        for f in folds:
            v = root / exp / f"fold_{f}" / "validation_raw"
            v.mkdir(parents=True)
            for c in cases:
                sm = rng.dirichlet(np.ones(3), (6, 5, 4)).astype(np.float32)
                np.savez(v / f"{c}.npz", softmax=np.moveaxis(sm, -1, 0))
                if props and c == "a":
                    (v / f"{c}.properties.json").write_text(json.dumps({
                        "original_shape": [8, 7, 6], "crop_bbox": [[1, 7], [1, 6], [1, 5]],
                        "original_spacing": [1, 1, 1], "target_spacing": [1, 1, 1]}))
    gt = root / "gt"
    gt.mkdir()
    for c in cases:
        shape = (8, 7, 6) if props and c == "a" else (6, 5, 4)
        tnifti.save(rng.randint(0, 3, shape).astype(np.uint8), gt / f"{c}.nii.gz")
    return root


def test_model_selection_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    sms = [rng.rand(4, 5, 3, 2).astype(np.float32) for _ in range(3)]
    assert_same(tsel.merge_softmax(sms), jsel.merge_softmax(sms))
    summaries = {}
    for pkg, sel in (("port", tsel), ("jax", jsel)):
        root = _validation_folders(tmp_path / pkg)
        summaries[pkg] = sel.ensemble_validation_folders(
            root / "exp1", root / "exp2", root / "ens", root / "gt", labels=[1, 2])
        files = list((root / "exp1" / "fold_0" / "validation_raw").glob("*.npz"))
        sel.merge_npz_case(files, root / "merged.nii.gz")
    assert_same(summaries["port"], summaries["jax"])
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_ranking_and_summaries_match_jax(tmp_path):
    files = []
    for i, dices in enumerate(([0.5, 0.7], [0.9, float("nan")], [0.2, 0.4])):
        d = tmp_path / "results" / f"exp{i}" / "fold_0"
        d.mkdir(parents=True)
        mean = {"0": {"Dice": 1.0}, **{str(k + 1): {"Dice": v} for k, v in enumerate(dices)}}
        s = {"name": f"exp{i}", "results": {"mean": mean, "all": [mean, mean]}}
        (d / "summary.json").write_text(json.dumps(s))
        files.append(d / "summary.json")
    assert_same(tsel.rank_candidates(files, tmp_path / "t.csv"),
                jsel.rank_candidates(files, tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert_same(tsel.summarize_results_in_one_json(files, tmp_path / "t.json"),
                jsel.summarize_results_in_one_json(files, tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    got = [tsel.collect_results_files(tmp_path / "results", tmp_path / "tc"),
           jsel.collect_results_files(tmp_path / "results", tmp_path / "jc")]
    assert [p.name for p in got[0]] == [p.name for p in got[1]]
    means = []
    for sel in (tsel, jsel):
        (tmp_path / "s.json").write_text(files[0].read_text())
        means.append((sel.add_mean_dice_to_json(tmp_path / "s.json"),
                      (tmp_path / "s.json").read_bytes()))
    assert_same(means[0], means[1])


# ---------------------------------------------------------------- overlay, paths

def test_overlay_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    image = rng.randn(5, 12, 10).astype(np.float32) * 100
    seg = np.zeros((5, 12, 10), np.uint8)
    seg[3, 2:8, 3:7] = rng.randint(1, 14, (6, 4))
    assert toverlay.select_slice(seg) == joverlay.select_slice(seg) == 3
    assert toverlay.select_slice(seg * 0) == joverlay.select_slice(seg * 0)
    assert_same(toverlay.overlay_image(image[3], seg[3], 0.4),
                joverlay.overlay_image(image[3], seg[3], 0.4))
    for arrays in ((image, seg), (image[None], seg), (image[1], seg[1])):
        for pkg, mod in (("port", toverlay), ("jax", joverlay)):
            mod.save_overlay(*arrays, tmp_path / pkg / f"o{arrays[0].ndim}.png")
    for d in ("imgs", "segs"):
        (tmp_path / d).mkdir()
    tnifti.save(np.moveaxis(image, 0, -1), tmp_path / "imgs" / "c1_0000.nii.gz")
    tnifti.save(np.moveaxis(seg, 0, -1), tmp_path / "segs" / "c1.nii.gz")
    tnifti.save(np.moveaxis(seg, 0, -1), tmp_path / "segs" / "c2.nii.gz")  # no image
    for pkg, mod in (("port", toverlay), ("jax", joverlay)):
        written = mod.generate_overlays_for_folder(tmp_path / "imgs", tmp_path / "segs",
                                                   tmp_path / pkg / "folder")
        assert [p.name for p in written] == ["c1.png"]
    _same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("env", [{}, {"d_lka_former_raw_data_base": "/data/raw",
                                      "d_lka_former_preprocessed": "/data/pre",
                                      "RESULTS_FOLDER": "/data/res"}])
def test_paths_match_jax(env):
    keys = ("d_lka_former_raw_data_base", "d_lka_former_preprocessed", "RESULTS_FOLDER")
    clean = {k: v for k, v in os.environ.items() if k not in keys}
    with mock.patch.dict(os.environ, {**clean, **env}, clear=True):
        for name in ("raw_data_base", "preprocessed_folder", "results_folder",
                     "raw_cropped", "raw_data"):
            assert getattr(tpaths, name)() == getattr(jpaths, name)()


# ---------------------------------------------------------------- cli/tools.py

def test_tools_match_jax(tmp_path, capsys):
    sd = {"unetr_pp_encoder.layer_lka_1.w": torch.arange(6.0).reshape(2, 3),
          "unetr_pp.head.b": torch.ones(2)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ck.pth")
    plans = {"num_classes": 2, "num_modalities": 1, "normalization_schemes": {0: "CT"},
             "transpose_forward": [0, 1, 2],
             "plans_per_stage": {0: {"batch_size": 2, "patch_size": [32, 64, 64],
                                     "pool_op_kernel_sizes": [[2, 2, 2]]}}}
    (tmp_path / "plans.pkl").write_bytes(pickle.dumps(plans))
    (tmp_path / "plans.json").write_text(json.dumps(plans))
    outs = {}
    for pkg, tools in (("port", ttools), ("jax", jtools)):
        o = tmp_path / pkg
        o.mkdir()
        tools.rename_keys([str(tmp_path / "ck.pth"), str(o / "renamed.pth")])
        tools.copy_decoder_weights([str(tmp_path / "ck.pth"), str(o / "copied.pth")])
        for suffix in ("pkl", "json"):
            tools.change_plans([str(tmp_path / f"plans.{suffix}"), "transpose_forward.1",
                                "5", "--output", str(o / f"changed.{suffix}")])
            tools.change_plans([str(o / f"changed.{suffix}"), "num_classes", "[3, 4]"])
            tools.change_batch_size([str(tmp_path / f"plans.{suffix}"), "7",
                                     "-o", str(o / f"batch.{suffix}")])
        tools.summarize_plans([str(tmp_path / "plans.pkl")])
        outs[pkg] = capsys.readouterr().out.replace(str(o), "OUT")
    assert outs["port"] == outs["jax"]
    for name in ("renamed.pth", "copied.pth"):
        got = torch.load(tmp_path / "port" / name, weights_only=False)
        ref = torch.load(tmp_path / "jax" / name, weights_only=False)
        assert got.keys() == ref.keys()
        ref_sd = ref.get("state_dict", ref)
        for k, t in got.get("state_dict", got).items():
            torch.testing.assert_close(t, ref_sd[k], rtol=0, atol=0)
    for name in ("changed.pkl", "batch.pkl"):
        assert_same(pickle.loads((tmp_path / "port" / name).read_bytes()),
                    pickle.loads((tmp_path / "jax" / name).read_bytes()))
    for name in ("changed.json", "batch.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
