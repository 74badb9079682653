"""Task-layout conversion utilities.

The port's copy of `deformablelka_tpu/data/convert_tasks.py`, on the
port's `data/nifti.py` (PIL is imported only to read a 2D image file).
Upstream's behaviour, as the JAX package re-derived it:
  experiment_planning/nnFormer_convert_decathlon_task.py +
  common_utils.split_4d_nifti — MSD decathlon tasks store multi-modality
  images as 4D NIfTIs; the package (like nnUNet) wants one 3D file per
  modality with the `_0000`/`_0001`... suffix.
  utilities/file_conversions.py — 2D image (png/tif) ↔ pseudo-3D NIfTI
  helpers used to shoehorn 2D datasets through the 3D pipeline.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.data import nifti


def split_4d_nifti(in_file: str | Path, out_folder: str | Path) -> list:
    """4D (x,y,z,modality) NIfTI → one 3D file per modality with _000M
    suffix (common_utils.split_4d_nifti semantics). 3D inputs are
    copied with the `_0000` suffix."""
    in_file = Path(in_file)
    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    img = nifti.load(in_file)
    base = in_file.name
    for suf in (".nii.gz", ".nii"):
        if base.endswith(suf):
            base = base[:-len(suf)]
            break
    data = np.asarray(img.data)
    written = []
    if data.ndim == 3:
        out = out_folder / f"{base}_0000.nii.gz"
        nifti.save(data, out, affine=img.affine)
        written.append(out)
    else:
        assert data.ndim == 4, data.shape
        for m in range(data.shape[3]):
            out = out_folder / f"{base}_{m:04d}.nii.gz"
            nifti.save(np.ascontiguousarray(data[..., m]), out,
                       affine=img.affine)
            written.append(out)
    return written


def convert_decathlon_task(task_folder: str | Path,
                           out_folder: str | Path | None = None,
                           task_id: int | None = None) -> Path:
    """Decathlon TaskXX_name folder (imagesTr/labelsTr[/imagesTs],
    dataset.json) → framework raw layout with per-modality 3D files
    (nnFormer_convert_decathlon_task.py:31-76). Returns the output
    folder (TaskXXX_name with a 3-digit id, nnUNet convention)."""
    task_folder = Path(task_folder)
    m = re.match(r"Task(\d+)_(.*)", task_folder.name)
    assert m, f"{task_folder.name} is not a TaskXX_name folder"
    tid = task_id if task_id is not None else int(m.group(1))
    if out_folder is None:
        out_folder = task_folder.parent / f"Task{tid:03d}_{m.group(2)}"
    out_folder = Path(out_folder)
    for sub in ("imagesTr", "labelsTr"):
        assert (task_folder / sub).is_dir(), f"missing {sub}"
    for sub in ("imagesTr", "imagesTs"):
        src = task_folder / sub
        if not src.is_dir():
            continue
        dst = out_folder / sub
        for f in sorted(src.glob("*.nii*")):
            if f.name.startswith("."):
                continue
            split_4d_nifti(f, dst)
    dst_lab = out_folder / "labelsTr"
    dst_lab.mkdir(parents=True, exist_ok=True)
    for f in sorted((task_folder / "labelsTr").glob("*.nii*")):
        if not f.name.startswith("."):
            shutil.copy(f, dst_lab / f.name)
    shutil.copy(task_folder / "dataset.json", out_folder / "dataset.json")
    return out_folder


def convert_2d_image_to_nifti(in_array_or_file, out_file: str | Path,
                              spacing=(999.0, 1.0, 1.0),
                              is_seg: bool = False) -> Path:
    """2D image (H, W[, C] array or png/jpg path) → pseudo-3D NIfTI with
    one z-slice per channel stacked as modalities is the nnUNet trick;
    here: (1, H, W) per channel written as separate files for images,
    single file for segs (utilities/file_conversions.py semantics)."""
    if isinstance(in_array_or_file, (str, Path)):
        from PIL import Image
        arr = np.asarray(Image.open(in_array_or_file))
    else:
        arr = np.asarray(in_array_or_file)
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    aff = np.diag(list(spacing) + [1.0])
    if is_seg:
        if arr.ndim == 3:
            arr = arr[..., 0]
        nifti.save(arr[None].astype(np.int16), out_file, affine=aff)
        return out_file
    if arr.ndim == 2:
        arr = arr[..., None]
    base = str(out_file)
    for suf in (".nii.gz", ".nii"):
        if base.endswith(suf):
            base = base[:-len(suf)]
            break
    outs = []
    for c in range(arr.shape[-1]):
        o = Path(f"{base}_{c:04d}.nii.gz")
        nifti.save(arr[None, ..., c].astype(np.float32), o, affine=aff)
        outs.append(o)
    return outs[0]


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Convert an MSD decathlon task to the framework's "
                    "raw layout (split 4D images per modality)")
    ap.add_argument("-i", "--input", required=True,
                    help="TaskXX_name decathlon folder")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-id", "--task_id", type=int, default=None)
    args = ap.parse_args(argv)
    out = convert_decathlon_task(args.input, args.output, args.task_id)
    print(out)


if __name__ == "__main__":
    main()
