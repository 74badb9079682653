"""Skin-lesion (ISIC 2017/2018, PH2) data preparation + loader.

The port's copy of `deformablelka_tpu/data/skin.py` (numpy, scipy; PIL
only where images are prepared). Upstream's behaviour, as the JAX package
re-derived it:
  2D/skin_code/Prepare_ISIC2017.py — read jpg images +
    *_segmentation.png masks, bilinear-resize to 224×224 (float64), fixed
    contiguous train/val/test split (1399/200/400 of 1999), save
    data_{train,val,test}.npy / mask_{train,val,test}.npy.
  2D/skin_code/loader.py:9-16 — dataset_normalized:
    z-score with DATASET-level mean/std, then per-image min-max scaled
    to [0, 255].
  loader.py:37-85 — isic_loader: masks /255, train-time random
    horizontal flip (axis=1, p=0.5), boundary = dilation(mask, 7×7) - mask.

Batches come out channels-last float32, sized for a static batch (the
last partial batch dropped in training, kept for evaluation).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np
from scipy import ndimage


def dataset_normalized(imgs: np.ndarray) -> np.ndarray:
    """loader.py:9-16: global z-score, then per-image min-max → [0,255]."""
    out = (imgs - np.mean(imgs)) / np.std(imgs)
    for i in range(out.shape[0]):
        mn, mx = np.min(out[i]), np.max(out[i])
        out[i] = (out[i] - mn) / (mx - mn) * 255
    return out


def boundary_extraction(mask2d: np.ndarray) -> np.ndarray:
    """loader.py:29-34: 7×7 binary dilation minus the mask."""
    dil = ndimage.binary_dilation(
        mask2d, structure=np.ones((7, 7))).astype(mask2d.dtype)
    return dil - mask2d


def _resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    from PIL import Image
    pil = Image.fromarray(img)
    return np.double(pil.resize((height, width), Image.BILINEAR))


def prepare_skin_dataset(image_paths, mask_paths, out_dir,
                         splits=(0.7, 0.1, 0.2), height=224, width=224):
    """Prepare_ISIC*.py equivalent with parameterized split fractions
    (the reference hardcodes 1399/200/400 ≈ 0.7/0.1/0.2 of ISIC2017).
    Saves data_/mask_{train,val,test}.npy under out_dir."""
    n = len(image_paths)
    assert n == len(mask_paths)
    data = np.zeros([n, height, width, 3])
    masks = np.zeros([n, height, width])
    from PIL import Image
    for i, (ip, mp) in enumerate(zip(image_paths, mask_paths)):
        img = np.asarray(Image.open(ip))
        data[i] = _resize_bilinear(img, height, width)
        m = np.asarray(Image.open(mp))
        if m.ndim == 3:
            m = m[..., 0]
        masks[i] = _resize_bilinear(m, height, width)
    n_train = int(round(splits[0] * n))
    n_val = int(round(splits[1] * n))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "data_train.npy", data[:n_train])
    np.save(out / "data_val.npy", data[n_train:n_train + n_val])
    np.save(out / "data_test.npy", data[n_train + n_val:])
    np.save(out / "mask_train.npy", masks[:n_train])
    np.save(out / "mask_val.npy", masks[n_train:n_train + n_val])
    np.save(out / "mask_test.npy", masks[n_train + n_val:])
    return out


class ISICLoader:
    """isic_loader (loader.py:37-85) as a numpy batch iterator.

    split: "train" | "val" | "test". Yields
    {"image": (B,H,W,3) float32, "mask": (B,H,W,1) float32 in [0,1],
     "boundary": (B,H,W,1)}.
    """

    def __init__(self, path_data: str | Path, split: str = "train",
                 batch_size: int = 16, seed: int = 0,
                 with_boundary: bool = False):
        p = Path(path_data)
        self.data = np.load(p / f"data_{split}.npy")
        self.mask = np.load(p / f"mask_{split}.npy")
        self.train = split == "train"
        self.batch_size = batch_size
        self.with_boundary = with_boundary
        self.rng = np.random.RandomState(seed)
        self.data = dataset_normalized(self.data)
        self.mask = self.mask[..., None] / 255.0

    def __len__(self):
        return len(self.data)

    def _augment(self, img, seg):
        if self.rng.rand() < 0.5:
            img = np.flip(img, axis=1)
            seg = np.flip(seg, axis=1)
        return img, seg

    def epoch(self) -> Iterator[dict]:
        idx = np.arange(len(self.data))
        if self.train:
            self.rng.shuffle(idx)
        B = self.batch_size
        n_full = len(idx) // B
        # keep the ragged tail only at eval (static shapes for the
        # train step; eval pads/handles per batch)
        ends = n_full * B if self.train else len(idx)
        for s in range(0, ends, B):
            take = idx[s:s + B]
            imgs, segs, bnds = [], [], []
            for i in take:
                img, seg = self.data[i], self.mask[i]
                if self.train:
                    img, seg = self._augment(img, seg)
                imgs.append(img)
                segs.append(seg)
                if self.with_boundary:
                    bnds.append(boundary_extraction(seg[..., 0])[..., None])
            batch = {"image": np.stack(imgs).astype(np.float32),
                     "mask": np.stack(segs).astype(np.float32)}
            if self.with_boundary:
                batch["boundary"] = np.stack(bnds).astype(np.float32)
            yield batch
