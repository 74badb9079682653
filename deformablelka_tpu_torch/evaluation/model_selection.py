"""Model selection / ensembling (nnUNet heritage).

The port's copy of `deformablelka_tpu/evaluation/model_selection.py`, on
the port's evaluator, postprocessing, `data/nifti.py` and
`inference/predictor3d.restore_softmax_to_original`. Upstream's
behaviour, as the JAX package re-derived it:
  3D/d_lka_former/evaluation/model_selection/ensemble.py
    :26-36 merge: mean of two saved softmax npz files per case, exported
    to NIfTI with the stored geometry; :40-123 ensemble: walk two
    training output folders' validation dirs per fold, merge cases,
    aggregate_scores → summary.json, then determine_postprocessing.
  .../figure_out_what_to_submit.py + rank_candidates.py: read every
    summary.json, rank configurations by mean foreground Dice.
  .../collect_all_fold0_results_and_summarize_in_one_csv.py: tabulate
    per-task mean dice per experiment.
  .../summarize_results_in_one_json.py: collate mean-dice rows.

Softmax ensembling is a numpy mean on the host (the network ran when the
softmaxes were saved).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from deformablelka_tpu_torch.evaluation.evaluator import aggregate_scores
from deformablelka_tpu_torch.evaluation.postprocessing import (
    determine_postprocessing)


def merge_softmax(softmaxes: Sequence[np.ndarray]) -> np.ndarray:
    """Mean of per-model softmax volumes (ensemble.py:33)."""
    return np.mean(np.stack(softmaxes, 0), 0)


def merge_npz_case(files: Sequence[str | Path], out_file: str | Path,
                   properties: Optional[dict] = None, key: str = "softmax"):
    """ensemble.py:26-36: average the saved per-case softmax npz files
    and export the argmax seg (restored to original geometry when
    properties are given) as NIfTI."""
    from deformablelka_tpu_torch.data import nifti
    from deformablelka_tpu_torch.inference.predictor3d import (
        restore_softmax_to_original)

    sm = merge_softmax([np.load(f)[key] for f in files])
    if sm.shape[0] < sm.shape[-1]:  # (C, x, y, z) → channels-last
        sm = np.moveaxis(sm, 0, -1)
    if properties is not None:
        seg = restore_softmax_to_original(sm, properties)
    else:
        seg = np.argmax(sm, axis=-1).astype(np.uint8)
    nifti.save(seg.astype(np.uint8), out_file)
    return seg


def ensemble_validation_folders(folder1: str | Path, folder2: str | Path,
                                output_folder: str | Path,
                                gt_folder: str | Path, labels,
                                folds=(0,), validation_folder="validation_raw",
                                run_postprocessing: bool = True):
    """ensemble.py:40-123 equivalent on this framework's layout:
    per-fold validation dirs hold `<case>.npz` (softmax) [+ optional
    `<case>.properties.json`], gt_folder holds `<case>.nii.gz`."""
    from deformablelka_tpu_torch.data import nifti

    folder1, folder2 = Path(folder1), Path(folder2)
    out_base = Path(output_folder)
    out_raw = out_base / "ensembled_raw"
    out_raw.mkdir(parents=True, exist_ok=True)

    pairs = []
    for f in folds:
        v1 = folder1 / f"fold_{f}" / validation_folder
        v2 = folder2 / f"fold_{f}" / validation_folder
        if not v1.is_dir() or not v2.is_dir():
            raise AssertionError(
                f"Validation directory missing: {v1 if not v1.is_dir() else v2}."
                " Rerun validation with npz saving enabled.")
        ids1 = sorted(p.stem for p in v1.glob("*.npz"))
        ids2 = sorted(p.stem for p in v2.glob("*.npz"))
        assert ids1 == ids2, "npz filenames do not match between folders"
        for case in ids1:
            props = None
            pf = v1 / f"{case}.properties.json"
            if pf.exists():
                props = json.loads(pf.read_text())
                for k in ("crop_bbox", "original_shape"):
                    if k in props:
                        props[k] = [tuple(x) if isinstance(x, list) else x
                                    for x in props[k]]
            out_file = out_raw / f"{case}.nii.gz"
            merge_npz_case([v1 / f"{case}.npz", v2 / f"{case}.npz"],
                           out_file, props)
            pairs.append((out_file, Path(gt_folder) / f"{case}.nii.gz"))

    seg_pairs = [(np.asarray(nifti.load(p).data).astype(np.int32),
                  np.asarray(nifti.load(g).data).astype(np.int32))
                 for p, g in pairs]
    summary = aggregate_scores(
        seg_pairs, labels=labels,
        json_output_file=out_raw / "summary.json", json_name="ensemble")

    if run_postprocessing and seg_pairs:
        pp = determine_postprocessing(seg_pairs, labels,
                                      out_json=out_base /
                                      "postprocessing.json")
        summary["postprocessing"] = pp
    return summary


def rank_candidates(summary_files: Sequence[str | Path],
                    out_csv: Optional[str | Path] = None):
    """figure_out_what_to_submit / rank_candidates essence: order
    experiment summary.jsons by mean foreground Dice (descending)."""
    rows = []
    for f in summary_files:
        f = Path(f)
        s = json.loads(f.read_text())
        mean = s["results"]["mean"]
        dices = [v["Dice"] for k, v in mean.items()
                 if k not in ("0", 0) and v.get("Dice") is not None
                 and not (isinstance(v["Dice"], float)
                          and np.isnan(v["Dice"]))]
        rows.append({"experiment": s.get("name", f.parent.name),
                     "file": str(f),
                     "mean_fg_dice": float(np.mean(dices)) if dices
                     else float("nan")})
    rows.sort(key=lambda r: -r["mean_fg_dice"])
    if out_csv is not None:
        with open(out_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["experiment", "mean_fg_dice",
                                               "file"])
            w.writeheader()
            for r in rows:
                w.writerow(r)
    return rows


def summarize_results_in_one_json(summary_files: Sequence[str | Path],
                                  out_file: str | Path):
    """summarize_results_in_one_json.py essence: one collated json of
    {experiment: mean_fg_dice}."""
    ranked = rank_candidates(summary_files)
    out = {r["experiment"]: r["mean_fg_dice"] for r in ranked}
    Path(out_file).write_text(json.dumps(out, indent=2))
    return out


def add_mean_dice_to_json(summary_file: str | Path) -> float:
    """evaluation/add_mean_dice_to_json.py: append the mean foreground
    Dice over all cases/classes as results["mean_dice"] in place."""
    summary_file = Path(summary_file)
    with open(summary_file) as f:
        summary = json.load(f)
    dices = []
    for case in summary["results"]["all"]:
        for lab, m in case.items():
            if isinstance(m, dict) and str(lab) not in ("0",):
                d = m.get("Dice")
                if d is not None and not (isinstance(d, float)
                                          and np.isnan(d)):
                    dices.append(float(d))
    mean_dice = float(np.mean(dices)) if dices else float("nan")
    summary["results"]["mean_dice"] = mean_dice
    summary_file.write_text(json.dumps(summary, indent=2))
    return mean_dice


def collect_results_files(results_root: str | Path,
                          out_folder: str | Path) -> list:
    """evaluation/collect_results_files.py: copy every fold's
    validation summary.json into one flat folder named
    <experiment>__<fold>__summary.json."""
    import shutil
    results_root = Path(results_root)
    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    copied = []
    for summary in sorted(results_root.rglob("summary.json")):
        rel = summary.relative_to(results_root)
        name = "__".join(rel.parts[:-1]) + "__summary.json"
        dst = out_folder / name
        shutil.copy(summary, dst)
        copied.append(dst)
    return copied
