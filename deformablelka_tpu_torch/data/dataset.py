"""Dataset loading and patch sampling.

The port's copy of `deformablelka_tpu/data/dataset.py` (numpy only).
Upstream's behaviour, as the JAX package re-derived it:
  3D/d_lka_former/training/dataloading/dataset_loading.py
    unpack_dataset (:58-71): npz["data"] → .npy memmap-able files.
    load_dataset (:89): case dict {data_file, properties_file}.
    DataLoader3D (:155-380): random-case batches; per-sample 33%
    foreground-forced patches via precomputed `class_locations`
    (oversample_foreground_percent, Trainer_synapse.py:130); pad with
    zeros (data) / -1 (seg) when the patch exceeds the volume.
  2D Synapse: 2D/datasets/dataset_synapse.py:75-128 (train: per-slice
    npz with image/label keys; test: per-case h5 volumes; case lists in
    lists/lists_Synapse).
  Pancreas: 3D/pancreas_code/dataloaders/la_heart.py (h5 per case with
    image/label, RandomCrop 96³).
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def unpack_dataset(folder: str | Path):
    """npz → npy for memmap loading (dataset_loading.py:58-71)."""
    folder = Path(folder)
    for f in sorted(folder.glob("*.npz")):
        npy = f.with_suffix(".npy")
        if not npy.exists():
            data = np.load(f)["data"]
            np.save(npy, data)


def load_dataset(folder: str | Path) -> Dict[str, dict]:
    folder = Path(folder)
    dataset = {}
    for f in sorted(folder.glob("*.npz")):
        case = f.stem
        dataset[case] = {
            "data_file": str(f),
            "properties_file": str(f.with_suffix(".pkl")),
        }
    return dataset


def load_case(entry: dict) -> tuple[np.ndarray, dict]:
    npy = Path(entry["data_file"]).with_suffix(".npy")
    if npy.exists():
        data = np.load(npy, mmap_mode="r")
    else:
        data = np.load(entry["data_file"])["data"]
    props = {}
    pf = Path(entry["properties_file"])
    if pf.exists():
        with open(pf, "rb") as fh:
            props = pickle.load(fh)
    return data, props


class DataLoader3D:
    """Random patch sampler with foreground oversampling.

    Yields {"data": (B, *patch, C), "seg": (B, *patch), "keys": [...]}
    channels-last float32 host arrays.
    """

    def __init__(self, dataset: Dict[str, dict], patch_size, batch_size,
                 oversample_foreground_percent: float = 0.33,
                 rng: Optional[np.random.RandomState] = None,
                 seg_from_prev_stage_folder: Optional[str] = None,
                 cascade_classes: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.keys = sorted(dataset.keys())
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.rng = rng or np.random.RandomState(1234)
        # cascade (dataset_loading.py DataLoader3D cascade path): the
        # previous stage's segmentation is appended as one-hot input
        # channels; files <case>_segFromPrevStage.npz come from
        # training/cascade.predict_next_stage
        self.prev_stage_folder = (Path(seg_from_prev_stage_folder)
                                  if seg_from_prev_stage_folder else None)
        self.cascade_classes = (list(cascade_classes)
                                if cascade_classes else None)

    def _load_prev_stage(self, key: str) -> Optional[np.ndarray]:
        if self.prev_stage_folder is None:
            return None
        f = self.prev_stage_folder / f"{key}_segFromPrevStage.npz"
        return np.load(f)["data"] if f.exists() else None

    def _needs_fg(self, sample_idx: int) -> bool:
        # last `round(B*oversample)` samples of the batch are fg-forced
        # (dataset_loading.py:231-240 semantics)
        return sample_idx >= round(self.batch_size * (1 - self.oversample))

    def _sample_patch(self, data: np.ndarray, props: dict, force_fg: bool):
        # data: (C+1, x, y, z) with seg as last channel (nnUNet layout)
        shape = data.shape[1:]
        ps = self.patch_size
        lb = [-(p // 2) for p in ps]
        ub = [s + p // 2 + p % 2 - p for s, p in zip(shape, ps)]
        if force_fg and props.get("class_locations"):
            classes = [c for c, locs in props["class_locations"].items()
                       if len(locs)]
            if classes:
                c = classes[self.rng.randint(len(classes))]
                locs = props["class_locations"][c]
                voxel = locs[self.rng.randint(len(locs))]
                center = [int(v) for v in voxel[-3:]]
                start = [min(max(cv - p // 2, l), u)
                         for cv, p, l, u in zip(center, ps, lb, ub)]
            else:
                start = [self.rng.randint(l, u + 1) for l, u in zip(lb, ub)]
        else:
            start = [self.rng.randint(l, u + 1) for l, u in zip(lb, ub)]

        # crop with zero/-1 padding outside
        C = data.shape[0]
        patch_data = np.zeros((C - 1, *ps), np.float32)
        patch_seg = -np.ones(ps, np.float32)
        src = [slice(max(s, 0), min(s + p, dim))
               for s, p, dim in zip(start, ps, shape)]
        dst = [slice(sl.start - s, sl.start - s + (sl.stop - sl.start))
               for sl, s in zip(src, start)]
        patch_data[(slice(None),) + tuple(dst)] = \
            data[(slice(0, C - 1),) + tuple(src)]
        patch_seg[tuple(dst)] = data[(C - 1,) + tuple(src)]
        return patch_data, patch_seg

    def next(self):
        idx = self.rng.choice(len(self.keys), self.batch_size, True)
        datas, segs, keys = [], [], []
        for i, ki in enumerate(idx):
            key = self.keys[ki]
            data, props = load_case(self.dataset[key])
            data = np.asarray(data)
            prev = self._load_prev_stage(key)
            if prev is not None:
                classes = (self.cascade_classes or
                           sorted(int(c) for c in np.unique(prev)
                                  if c > 0))
                onehot = np.stack([(prev == c).astype(np.float32)
                                   for c in classes])
                # insert before the stacked seg channel
                data = np.concatenate(
                    [data[:-1], onehot, data[-1:]], axis=0)
            d, s = self._sample_patch(data, props,
                                      self._needs_fg(i))
            datas.append(d)
            segs.append(s)
            keys.append(key)
        data = np.stack(datas)                       # (B, C, *patch)
        seg = np.stack(segs)                         # (B, *patch)
        # channels-last for the device pipeline
        data = np.moveaxis(data, 1, -1)
        return {"data": data, "seg": seg, "keys": keys}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


class DataLoader2D:
    """Random-slice 2D patch sampler — the nnUNet `2d` configuration.

    Parity target: dataset_loading.py DataLoader2D (:382-595). Per
    sample: pick a case, pick a z-slice (fg-forced samples choose a
    slice containing a random present foreground class via
    `class_locations`, :478-502), then crop/pad a 2D patch. Data is
    edge-padded (upstream's default pad_mode="edge", :384), seg is
    padded with -1 (:585-588). Centered sampling rule for fg patches
    and the lb/ub arithmetic match :531-560.

    Yields {"data": (B, *patch, C), "seg": (B, *patch), "keys": [...]}
    channels-last, like DataLoader3D.
    """

    def __init__(self, dataset: Dict[str, dict], patch_size, batch_size,
                 oversample_foreground_percent: float = 0.33,
                 rng: Optional[np.random.RandomState] = None,
                 pad_mode: str = "edge"):
        self.dataset = dataset
        self.keys = sorted(dataset.keys())
        self.patch_size = tuple(patch_size)
        assert len(self.patch_size) == 2
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.rng = rng or np.random.RandomState(1234)
        self.pad_mode = pad_mode

    def _needs_fg(self, sample_idx: int) -> bool:
        return sample_idx >= round(self.batch_size * (1 - self.oversample))

    def _pick_slice(self, data: np.ndarray, props: dict, force_fg: bool):
        """Return (slice_idx, voxels2d or None) — dataset_loading.py:478-502."""
        nz = data.shape[1]
        if force_fg and props.get("class_locations"):
            classes = [c for c, locs in props["class_locations"].items()
                       if len(locs) and int(c) > 0]
            if classes:
                c = classes[self.rng.randint(len(classes))]
                locs = np.asarray(props["class_locations"][c])
                valid = np.unique(locs[:, 0])
                z = int(valid[self.rng.randint(len(valid))])
                vox = locs[locs[:, 0] == z][:, 1:]
                return z, vox
        return int(self.rng.randint(nz)), None

    def _sample_patch(self, sl: np.ndarray, vox):
        """sl: (C, x, y) slice with seg last channel."""
        shape = sl.shape[1:]
        ps = self.patch_size
        lb = [-(p // 2) for p in ps]
        ub = [s + p // 2 + p % 2 - p for s, p in zip(shape, ps)]
        if vox is not None and len(vox):
            center = vox[self.rng.randint(len(vox))]
            start = [min(max(int(cv) - p // 2, l), u)
                     for cv, p, l, u in zip(center, ps, lb, ub)]
        else:
            start = [self.rng.randint(l, u + 1) for l, u in zip(lb, ub)]
        src = [slice(max(s, 0), min(s + p, dim))
               for s, p, dim in zip(start, ps, shape)]
        pads = [(-min(0, s), max(s + p - dim, 0))
                for s, p, dim in zip(start, ps, shape)]
        crop = sl[(slice(None),) + tuple(src)]
        patch_data = np.pad(crop[:-1].astype(np.float32),
                            ((0, 0),) + tuple(pads), self.pad_mode)
        patch_seg = np.pad(crop[-1].astype(np.float32), tuple(pads),
                           "constant", constant_values=-1)
        return patch_data, patch_seg

    def next(self):
        idx = self.rng.choice(len(self.keys), self.batch_size, True)
        datas, segs, keys = [], [], []
        for i, ki in enumerate(idx):
            key = self.keys[ki]
            data, props = load_case(self.dataset[key])
            data = np.asarray(data)
            if data.ndim == 3:           # (C, x, y) single-slice case
                data = data[:, None]
            z, vox = self._pick_slice(data, props, self._needs_fg(i))
            d, s = self._sample_patch(data[:, z], vox)
            datas.append(d)
            segs.append(s)
            keys.append(key)
        data = np.moveaxis(np.stack(datas), 1, -1)   # (B, *patch, C)
        return {"data": data, "seg": np.stack(segs), "keys": keys}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


def compute_class_locations(seg: np.ndarray, classes: Sequence[int],
                            max_per_class: int = 10000,
                            rng=None) -> dict:
    """Precompute foreground voxel coordinates per class (the
    `class_locations` properties entry written by the preprocessor)."""
    rng = rng or np.random.RandomState(1234)
    out = {}
    for c in classes:
        coords = np.argwhere(seg == c)
        if len(coords) > max_per_class:
            sel = rng.choice(len(coords), max_per_class, replace=False)
            coords = coords[sel]
        out[int(c)] = coords
    return out
