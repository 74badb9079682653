"""2D Synapse slice dataset: per-slice npz training, h5 volume testing.

The port's copy of `deformablelka_tpu/data/synapse2d.py` (numpy and scipy;
h5py only where a test volume is read, which raises without it).
Upstream's behaviour, as the JAX package re-derived it:
  2D/datasets/dataset_synapse.py:75-128 — Synapse_dataset: the train
    split reads `<data_dir>/<slice>.npz` ('image', 'label' 2D arrays)
    listed in `<list_dir>/train.txt`; the test split reads
    `<data_dir>/<case>.npy.h5` volumes from test_vol.txt. Train
    augmentation: imgaug SomeOf((0,4)) drawn from {flipud, fliplr,
    additive gaussian noise σ=0.005·255, gaussian blur σ=1, linear
    contrast 0.5–1.5, affine scale 0.5–2, rotate ±40°, shear ±16°,
    piecewise affine, translate ±20%}, random order; then zoom to
    img_size (image order 3, label order 0 via one-hot argmax).
  Trainer normalisation (trainer_MaxViT_deform_LKA.py:88-92):
    ToTensor + Normalize(0.5, 0.5).

The augmentation is numpy/scipy (no imgaug); batches come out
channels-last float32 with static shapes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage


def _one_hot_argmax_warp(label, warp_fn, num_classes=9):
    """Reference augments the seg as a one-hot map and argmaxes back
    (dataset_synapse.py:27-36) — reproduce so ties resolve identically."""
    oh = np.stack([(label == c).astype(np.float32)
                   for c in range(num_classes)], axis=-1)
    warped = np.stack([warp_fn(oh[..., c]) for c in range(num_classes)],
                      axis=-1)
    return np.argmax(warped, axis=-1).astype(np.float32)


class SliceAugmenter:
    """SomeOf((0,4), random order) over the reference's op set."""

    def __init__(self, rng: Optional[np.random.RandomState] = None,
                 num_classes: int = 9):
        self.rng = rng or np.random.RandomState(0)
        self.num_classes = num_classes

    # each op returns (img, lab)
    def _flipud(self, img, lab):
        return np.flipud(img).copy(), np.flipud(lab).copy()

    def _fliplr(self, img, lab):
        return np.fliplr(img).copy(), np.fliplr(lab).copy()

    def _noise(self, img, lab):
        return img + self.rng.randn(*img.shape).astype(np.float32) * \
            0.005 * 255, lab

    def _blur(self, img, lab):
        return ndimage.gaussian_filter(img, 1.0), lab

    def _contrast(self, img, lab):
        alpha = self.rng.uniform(0.5, 1.5)
        mid = 128 if img.max() > 1.5 else 0.5
        return mid + alpha * (img - mid), lab

    def _affine(self, img, lab, mat, offset):
        warp_i = lambda a: ndimage.affine_transform(a, mat, offset,
                                                    order=1, cval=0)
        img = warp_i(img.astype(np.float32))
        lab = _one_hot_argmax_warp(lab, warp_i, self.num_classes)
        return img, lab

    def _center_affine(self, img, mat):
        c = (np.array(img.shape, float) - 1) / 2
        return c - mat @ c

    def _scale(self, img, lab):
        sx = self.rng.uniform(0.5, 2.0)
        sy = self.rng.uniform(0.5, 2.0)
        mat = np.diag([1 / sx, 1 / sy])
        return self._affine(img, lab, mat, self._center_affine(img, mat))

    def _rotate(self, img, lab):
        a = np.deg2rad(self.rng.uniform(-40, 40))
        mat = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        return self._affine(img, lab, mat, self._center_affine(img, mat))

    def _shear(self, img, lab):
        s = np.tan(np.deg2rad(self.rng.uniform(-16, 16)))
        mat = np.array([[1.0, s], [0.0, 1.0]])
        return self._affine(img, lab, mat, self._center_affine(img, mat))

    def _translate(self, img, lab):
        ty = self.rng.uniform(-0.2, 0.2) * img.shape[0]
        tx = self.rng.uniform(-0.2, 0.2) * img.shape[1]
        return self._affine(img, lab, np.eye(2), np.array([ty, tx]))

    def __call__(self, img, lab):
        ops = [self._flipud, self._fliplr, self._noise, self._blur,
               self._contrast, self._scale, self._rotate, self._shear,
               self._translate]
        n = self.rng.randint(0, 5)
        chosen = self.rng.choice(len(ops), size=min(n, len(ops)),
                                 replace=False)
        for i in chosen:
            img, lab = ops[i](img, lab)
        return img, lab


def zoom_to(image, label, size):
    """dataset_synapse.py:66-68/110-112: image order-3 zoom, label
    order-0."""
    x, y = image.shape
    if (x, y) != tuple(size):
        image = ndimage.zoom(image, (size[0] / x, size[1] / y), order=3)
        label = ndimage.zoom(label, (size[0] / x, size[1] / y), order=0)
    return image, label


def normalize_05(image):
    """ToTensor + Normalize(0.5, 0.5) on a [0,1]-ranged image."""
    return (image.astype(np.float32) - 0.5) / 0.5


class SynapseDataset2D:
    """split 'train': slice npz sampler; split 'test_vol': h5 volumes."""

    def __init__(self, base_dir, list_dir, split="train", img_size=224,
                 seed=1234, num_classes=9, augment=True):
        self.data_dir = Path(base_dir)
        self.split = split
        self.img_size = img_size
        names = (Path(list_dir) / f"{split}.txt").read_text().splitlines()
        self.sample_list = [n.strip() for n in names if n.strip()]
        self.rng = np.random.RandomState(seed)
        self.augment = augment and split == "train"
        self.aug = SliceAugmenter(self.rng, num_classes)

    def __len__(self):
        return len(self.sample_list)

    def get(self, idx):
        name = self.sample_list[idx]
        if self.split == "train":
            with np.load(self.data_dir / f"{name}.npz") as d:
                image, label = d["image"].astype(np.float32), d["label"]
            if self.augment:
                image, label = self.aug(image, label)
            image, label = zoom_to(image, label,
                                   (self.img_size, self.img_size))
            image = normalize_05(image)
            return {"image": image[..., None],
                    "label": label.astype(np.int32), "case_name": name}
        try:
            import h5py
        except ImportError as err:
            raise RuntimeError("h5py unavailable: the test volumes are h5 files") from err
        with h5py.File(self.data_dir / f"{name}.npy.h5", "r") as f:
            image, label = f["image"][:], f["label"][:]
        return {"image": image.astype(np.float32),
                "label": label.astype(np.int32), "case_name": name}

    def batches(self, batch_size: int, shuffle=True, drop_last=True):
        idx = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(idx)
        end = (len(idx) // batch_size * batch_size if drop_last
               else len(idx))
        for s in range(0, end, batch_size):
            samples = [self.get(i) for i in idx[s:s + batch_size]]
            yield {"image": np.stack([x["image"] for x in samples])
                   .astype(np.float32),
                   "label": np.stack([x["label"] for x in samples])
                   .astype(np.int32)}


class SynapseLoader2D:
    """Infinite generator adapter with `.next()` for Trainer2D."""

    def __init__(self, dataset: SynapseDataset2D, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_batches = max(1, len(dataset) // batch_size)
        self._it = None

    def next(self):
        if self._it is None:
            self._it = self.dataset.batches(self.batch_size)
        try:
            return next(self._it)
        except StopIteration:
            self._it = self.dataset.batches(self.batch_size)
            return next(self._it)
