"""Dataset integrity verification (decathlon/nnUNet raw layout).

The port's copy of `deformablelka_tpu/data/sanity_checks.py`, on the
port's `data/nifti.py`. Upstream's behaviour, as the JAX package
re-derived it:
  3D/d_lka_former/preprocessing/sanity_checks.py:90-234 —
  verify_dataset_integrity: dataset.json + imagesTr/ + labelsTr/ must
  exist; every training identifier needs its label file and all
  `_%04d` modality files; no duplicate identifiers; labels must be
  consecutive ints starting at 0 (background); label files may contain
  only expected labels; all modalities of a case must share geometry
  (shape + affine); NaNs anywhere are fatal; orientation should agree
  across the dataset (:25-43).

Uses the package's own NIfTI reader (data/nifti.py) instead of
SimpleITK.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.data import nifti


def verify_same_geometry(img1, img2, tol=1e-3) -> bool:
    """sanity_checks.py:45-77: same shape + same affine (origin/spacing/
    direction collapse to the affine in our reader)."""
    return (img1.data.shape == img2.data.shape
            and np.allclose(img1.affine, img2.affine, atol=tol))


def verify_contains_only_expected_labels(path, valid_labels):
    seg = np.asarray(nifti.load(path).data)
    found = np.unique(seg)
    invalid = [l for l in found if l not in valid_labels]
    return len(invalid) == 0, invalid


def verify_all_same_orientation(folder) -> bool:
    """sanity_checks.py:25-43: every image shares the rotation part of
    the affine (sign pattern), i.e. the same anatomical orientation."""
    sigs = set()
    for f in sorted(Path(folder).glob("*.nii.gz")):
        aff = nifti.load(f).affine
        sigs.add(tuple(np.sign(np.round(aff[:3, :3], 6)).astype(int)
                       .reshape(-1)))
    return len(sigs) <= 1


def verify_dataset_integrity(folder: str | Path) -> dict:
    """Raise on a broken dataset; return a small report otherwise."""
    folder = Path(folder)
    dsj = folder / "dataset.json"
    assert dsj.is_file(), f"There needs to be a dataset.json in {folder}"
    assert (folder / "imagesTr").is_dir(), f"imagesTr missing in {folder}"
    assert (folder / "labelsTr").is_dir(), f"labelsTr missing in {folder}"
    ds = json.loads(dsj.read_text())

    ids = [Path(e["image"]).name.replace(".nii.gz", "")
           for e in ds["training"]]
    if len(ids) != len(np.unique(ids)):
        raise RuntimeError("found duplicate training cases in dataset.json")

    expected_labels = sorted(int(k) for k in ds["labels"].keys())
    assert expected_labels[0] == 0, \
        "The first label must be 0 and maps to the background"
    diffs = np.diff(expected_labels)
    assert (diffs == 1).all(), \
        f"Labels must be consecutive (0, 1, 2, ...); got {expected_labels}"

    n_mod = len(ds.get("modality", {"0": "CT"}))
    nans, geom_bad, label_bad = [], [], []
    for ident in ids:
        label_file = folder / "labelsTr" / f"{ident}.nii.gz"
        assert label_file.is_file(), \
            f"could not find label file for case {ident}: {label_file}"
        mod_files = [folder / "imagesTr" / f"{ident}_{m:04d}.nii.gz"
                     for m in range(n_mod)]
        assert all(f.is_file() for f in mod_files), \
            f"missing modality files for case {ident}"
        ok, invalid = verify_contains_only_expected_labels(
            label_file, expected_labels)
        if not ok:
            label_bad.append((ident, invalid))
        ref = nifti.load(mod_files[0])
        lab = nifti.load(label_file)
        if not verify_same_geometry(ref, lab):
            geom_bad.append(ident)
        for f in mod_files[1:]:
            if not verify_same_geometry(ref, nifti.load(f)):
                geom_bad.append(ident)
        for f in mod_files:
            if np.isnan(np.asarray(nifti.load(f).data)).any():
                nans.append(str(f))
        if np.isnan(np.asarray(lab.data)).any():
            nans.append(str(label_file))

    if label_bad:
        raise AssertionError(
            f"Unexpected labels found in: {label_bad}")
    if geom_bad:
        raise Warning(
            f"GEOMETRY MISMATCH FOUND for cases {geom_bad}! Check your "
            "data; this breaks training.")
    if nans:
        raise RuntimeError(
            f"Some images have nan values in them: {nans}")
    same_orient = verify_all_same_orientation(folder / "imagesTr")
    return {"n_cases": len(ids), "labels": expected_labels,
            "same_orientation": same_orient}
