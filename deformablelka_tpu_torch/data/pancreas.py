"""NIH-Pancreas / LA-heart style dataset: h5 cases + random-crop sampling.

The port's copy of `deformablelka_tpu/data/pancreas.py` (numpy; h5py only
inside `load_case_h5`, which raises without it). Upstream's behaviour, as
the JAX package re-derived it:
  pancreas_code/dataloaders/la_heart.py:9-41 — LAHeart: fold list file
    (one h5 path per line) under `<base>/Pancreas/Flods/<fold>.list`;
    each h5 stores full-volume 'image' and 'label' datasets.
  la_heart.py:45-110 — CenterCrop / RandomCrop: pad each side by
    (needed//2 + 3) when the volume is smaller than the crop, then crop.
  la_heart.py:112-… — RandomRotFlip: random 90° rotations in the first
    two axes + random flips per axis.
  pancreas_code/train_pancreas.py:121-126 — DataLoader(num_workers=4),
    batch from repeated single-sample draws.

The loader yields channels-last (B, W, H, D, 1) float32 image batches and
(B, W, H, D) int32 labels as host numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def _pad_to_crop(image, label, output_size):
    """la_heart.py:52-60 / 90-97: pad (needed//2 + 3) per side when small."""
    pads = []
    for ax in range(3):
        if label.shape[ax] <= output_size[ax]:
            p = max((output_size[ax] - label.shape[ax]) // 2 + 3, 0)
        else:
            p = 0
        pads.append((p, p))
    if any(p[0] for p in pads):
        image = np.pad(image, pads, mode="constant", constant_values=0)
        label = np.pad(label, pads, mode="constant", constant_values=0)
    return image, label


def random_crop(image, label, output_size, rng: np.random.RandomState):
    image, label = _pad_to_crop(image, label, output_size)
    starts = [rng.randint(0, image.shape[ax] - output_size[ax])
              if image.shape[ax] > output_size[ax] else 0 for ax in range(3)]
    sl = tuple(slice(s, s + o) for s, o in zip(starts, output_size))
    return image[sl], label[sl]


def center_crop(image, label, output_size):
    image, label = _pad_to_crop(image, label, output_size)
    starts = [int(round((image.shape[ax] - output_size[ax]) / 2.0))
              for ax in range(3)]
    sl = tuple(slice(s, s + o) for s, o in zip(starts, output_size))
    return image[sl], label[sl]


def random_rot_flip(image, label, rng: np.random.RandomState):
    k = rng.randint(0, 4)
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = rng.randint(0, 2)
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def load_case_h5(path: str | Path):
    """One h5 case → (image (W,H,D) float32, label (W,H,D) int). h5py is
    imported here, so that nothing else of the port needs it."""
    try:
        import h5py
    except ImportError as err:
        raise RuntimeError("h5py unavailable") from err
    with h5py.File(path, "r") as f:
        image = f["image"][:]
        label = f["label"][:]
    return image.astype(np.float32), label.astype(np.int32)


def read_fold_list(base_dir: str | Path, fold_file: str) -> list[str]:
    """Fold list: one relative h5 path per line (la_heart.py:18-20)."""
    p = Path(base_dir) / "Pancreas" / "Flods" / fold_file
    if not p.exists():
        p = Path(base_dir) / fold_file
    with open(p) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return [str(Path(base_dir) / n) for n in names]


class PancreasDataLoader:
    """Infinite random-crop batch sampler over h5 cases.

    Yields dict(data=(B, *crop, 1) float32, target=(B, *crop) int32).
    """

    def __init__(self, case_paths: Sequence[str], crop_size=(96, 96, 96),
                 batch_size: int = 2, rot_flip: bool = False, seed: int = 0,
                 cache: bool = True):
        self.case_paths = list(case_paths)
        self.crop_size = tuple(crop_size)
        self.batch_size = batch_size
        self.rot_flip = rot_flip
        self.rng = np.random.RandomState(seed)
        self._cache = {} if cache else None

    def _load(self, path):
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        case = load_case_h5(path)
        if self._cache is not None:
            self._cache[path] = case
        return case

    def next_batch(self):
        imgs, labs = [], []
        for _ in range(self.batch_size):
            path = self.case_paths[self.rng.randint(len(self.case_paths))]
            image, label = self._load(path)
            image, label = random_crop(image, label, self.crop_size, self.rng)
            if self.rot_flip:
                image, label = random_rot_flip(image, label, self.rng)
            imgs.append(image)
            labs.append(label)
        data = np.stack(imgs)[..., None].astype(np.float32)
        target = np.stack(labs).astype(np.int32)
        return {"data": data, "target": target}

    def __iter__(self):
        while True:
            yield self.next_batch()
