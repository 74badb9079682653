"""Qualitative segmentation overlay plots.

The port's copy of `deformablelka_tpu/utils/overlay.py`, on the port's
`data/nifti.py` (PIL is imported only to write a PNG). Upstream's
utilities/overlay_plots.py — render (image, seg) pairs as color-overlay
PNGs for qualitative figures; one overlay per case, the slice with the
most foreground chosen automatically for 3D volumes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# distinct RGB colors per class (utilities/overlay_plots.py color_cycle)
COLOR_CYCLE = np.array([
    (0, 0, 0), (255, 64, 64), (64, 255, 64), (64, 64, 255),
    (255, 255, 64), (255, 64, 255), (64, 255, 255), (255, 160, 64),
    (160, 64, 255), (64, 160, 128), (200, 200, 200),
], np.float32)


def select_slice(seg: np.ndarray) -> int:
    """Axial slice index with the most foreground voxels."""
    fg = (seg > 0).reshape(seg.shape[0], -1).sum(1)
    return int(np.argmax(fg)) if fg.max() > 0 else seg.shape[0] // 2


def overlay_image(image2d: np.ndarray, seg2d: np.ndarray,
                  alpha: float = 0.6) -> np.ndarray:
    """(H, W) intensity + (H, W) int labels → (H, W, 3) uint8 overlay:
    grayscale image blended with per-class colors on foreground."""
    img = np.asarray(image2d, np.float32)
    lo, hi = np.percentile(img, 0.5), np.percentile(img, 99.5)
    img = np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1) * 255.0
    rgb = np.repeat(img[..., None], 3, axis=-1)
    seg = np.asarray(seg2d).astype(np.int64)
    colors = COLOR_CYCLE[np.clip(seg, 0, len(COLOR_CYCLE) - 1)]
    fg = (seg > 0)[..., None]
    out = np.where(fg, (1 - alpha) * rgb + alpha * colors, rgb)
    return out.astype(np.uint8)


def save_overlay(image, seg, out_file: str | Path, alpha: float = 0.6,
                 slice_index: int | None = None) -> Path:
    """Write one overlay PNG. 3D inputs (D, H, W) pick the
    most-foreground slice (or `slice_index`)."""
    image = np.asarray(image)
    seg = np.asarray(seg)
    if image.ndim == 4:  # (C, D, H, W) → first modality
        image = image[0]
    if image.ndim == 3:
        idx = select_slice(seg) if slice_index is None else slice_index
        image, seg = image[idx], seg[idx]
    rgb = overlay_image(image, seg, alpha)
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    from PIL import Image
    Image.fromarray(rgb).save(out_file)
    return out_file


def generate_overlays_for_folder(image_folder: str | Path,
                                 seg_folder: str | Path,
                                 out_folder: str | Path,
                                 alpha: float = 0.6) -> list:
    """Overlay every (imagesTr *_0000 NIfTI, predicted seg NIfTI) pair
    (overlay_plots.multiprocessing_plot_overlay semantics, serial)."""
    from deformablelka_tpu_torch.data import nifti
    image_folder, seg_folder = Path(image_folder), Path(seg_folder)
    out_folder = Path(out_folder)
    written = []
    for seg_f in sorted(seg_folder.glob("*.nii*")):
        case = seg_f.name.split(".nii")[0]
        img_f = image_folder / f"{case}_0000.nii.gz"
        if not img_f.exists():
            matches = list(image_folder.glob(f"{case}_0000.nii*"))
            if not matches:
                continue
            img_f = matches[0]
        img = nifti.load(img_f).data
        seg = nifti.load(seg_f).data
        written.append(save_overlay(np.transpose(img, (2, 0, 1)),
                                    np.transpose(seg, (2, 0, 1)),
                                    out_folder / f"{case}.png", alpha))
    return written
