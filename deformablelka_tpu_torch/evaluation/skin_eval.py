"""Skin-lesion quantitative evaluation (notebook-equivalent).

The port's copy of `deformablelka_tpu/evaluation/skin_eval.py`: the numpy
part as it is, the batched device loop `evaluate_skin_model` in torch. Parity
target: 2D/skin_code/evaluate_skin.ipynb — threshold the sigmoid
prediction at 0.5, morphological postprocessing (binary opening then
hole filling with square structuring elements, grid-searched), then
pixel-level metrics pooled over the whole test set: F1/DSC (binary
f1_score), accuracy, specificity, sensitivity from the confusion
matrix. The notebook also dumps per-case (image, gt, pred) PNG triples;
`save_case_visualizations` mirrors that.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import binary_fill_holes, binary_opening


def postprocess_skin_mask(mask: np.ndarray, opening_size: int = 6,
                          fill_size: int = 6) -> np.ndarray:
    """binary_opening + binary_fill_holes with square structure elements
    (evaluate_skin.ipynb cell 5). Sizes <= 0 skip the respective step."""
    out = mask.astype(bool)
    if opening_size > 0:
        out = binary_opening(out, structure=np.ones((opening_size,
                                                     opening_size)))
    if fill_size > 0:
        out = binary_fill_holes(out, structure=np.ones((fill_size,
                                                        fill_size)))
    return out.astype(mask.dtype)


def binary_pixel_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """Pixel-level pooled metrics over the full set (notebook semantics:
    predictions/gt flattened together, not averaged per case)."""
    t = np.asarray(y_true).reshape(-1) > 0.5
    p = np.asarray(y_pred).reshape(-1) > 0.5
    tp = float(np.sum(t & p))
    tn = float(np.sum(~t & ~p))
    fp = float(np.sum(~t & p))
    fn = float(np.sum(t & ~p))
    total = tp + tn + fp + fn
    f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    return {
        "f1": f1,
        "dsc": f1,
        "accuracy": (tp + tn) / total if total else 0.0,
        "specificity": tn / (tn + fp) if (tn + fp) else 0.0,
        "sensitivity": tp / (tp + fn) if (tp + fn) else 0.0,
        "jaccard": tp / (tp + fp + fn) if (tp + fp + fn) else 0.0,
        "tp": tp, "tn": tn, "fp": fp, "fn": fn,
    }


def evaluate_skin_predictions(gts, preds, threshold: float = 0.5,
                              opening_sizes=(6,), fill_sizes=(6,)) -> dict:
    """Grid-search morphology sizes, return best-DSC result.

    Args:
      gts, preds: sequences of (H, W) arrays — gt masks and sigmoid
        probabilities (or logits already sigmoided by caller).
      threshold: probability cut (notebook: 0.5).
      opening_sizes, fill_sizes: grid to search (notebook: range(6,7)).
    Returns:
      {"best": {...metrics, opening_size, fill_size}, "grid": [...]}
    """
    gts = [np.asarray(g) for g in gts]
    binarized = [np.asarray(p) >= threshold for p in preds]
    grid = []
    best = None
    for op in opening_sizes:
        for fi in fill_sizes:
            post = [postprocess_skin_mask(b.astype(np.uint8), op, fi)
                    for b in binarized]
            m = binary_pixel_metrics(np.concatenate(
                [g.reshape(-1) for g in gts]),
                np.concatenate([p.reshape(-1) for p in post]))
            m["opening_size"] = op
            m["fill_size"] = fi
            grid.append(m)
            if best is None or m["dsc"] > best["dsc"]:
                best = m
    return {"best": best, "grid": grid}


@torch.no_grad()
def evaluate_skin_model(model, loader, threshold: float = 0.5,
                        opening_sizes=(6,), fill_sizes=(6,),
                        batch_size: int = 8, vis_dir=None,
                        max_vis: int = 0, device="cuda") -> dict:
    """The device loop: run the sigmoid-output `model` ((B, H, W, 3) →
    (B, H, W, 1) probabilities) on `device` over a test loader and
    evaluate (evaluate_skin.ipynb main loop, but batched — the notebook
    runs batch 1; the last chunk padded to `batch_size` with its last
    image).

    `loader` yields dicts {"image": (H, W, 3) float, "mask": (H, W)}
    (data/skin.ISICLoader epoch order with train=False).
    """
    imgs, gts = [], []
    for item in loader:
        imgs.append(np.asarray(item["image"], np.float32))
        gts.append(np.asarray(item["mask"], np.float32))
    preds = []
    for i in range(0, len(imgs), batch_size):
        chunk = imgs[i:i + batch_size]
        pad = batch_size - len(chunk)
        x = torch.from_numpy(np.stack(chunk + [chunk[-1]] * pad)).to(device)
        y = model(x).float().cpu().numpy()
        if y.ndim == 4:  # (B, H, W, 1)
            y = y[..., 0]
        preds.extend(list(y[:len(chunk)]))
    result = evaluate_skin_predictions(gts, preds, threshold,
                                       opening_sizes, fill_sizes)
    if vis_dir is not None and max_vis > 0:
        save_case_visualizations(imgs[:max_vis], gts[:max_vis],
                                 preds[:max_vis], vis_dir,
                                 threshold=threshold)
    return result


def save_case_visualizations(imgs, gts, preds, out_dir,
                             threshold: float = 0.5) -> list:
    """Per-case PNG dump: img_N.png / gt_N.png / pred_N.png in
    out_dir/N/ (notebook save_image calls). Uses PIL; no-op list if
    unavailable."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return []
    out_dir = Path(out_dir)
    written = []
    for i, (img, gt, pr) in enumerate(zip(imgs, gts, preds), start=1):
        d = out_dir / str(i)
        d.mkdir(parents=True, exist_ok=True)
        rgb = np.asarray(img, np.float32)
        rgb = rgb - rgb.min()
        if rgb.max() > 0:
            rgb = rgb / rgb.max()
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            d / f"img_{i}.png")
        Image.fromarray(((np.asarray(gt) > 0.5) * 255).astype(
            np.uint8)).save(d / f"gt_{i}.png")
        Image.fromarray(((np.asarray(pr) >= threshold) * 255).astype(
            np.uint8)).save(d / f"pred_{i}.png")
        written.append(d)
    return written
