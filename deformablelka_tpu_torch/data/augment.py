"""moreDA-equivalent training augmentation (host-side numpy/scipy).

Parity targets (re-derived parameterisation):
  data_augmentation_moreDA.py:37-205 + default_data_augmentation.py +
  d_lka_former_trainer_synapse.py:383-435:
    - Spatial: rotation ±30° per axis (p 0.2/sample), scaling 0.7–1.4
      (p 0.2/sample), NO elastic; data order-3 constant-0 border, seg
      order-1 constant −1 border; sampled on an enlarged patch
      (`get_patch_size`) and centre-cropped to the final patch.
    - GaussianNoise p 0.1 (σ² ∈ U(0, 0.1)).
    - GaussianBlur p 0.2/sample, p 0.5/channel, σ ∈ (0.5, 1).
    - BrightnessMultiplicative ×U(0.75, 1.25), p 0.15.
    - Contrast ×U(0.75, 1.25) keeping mean, p 0.15.
    - SimulateLowRes zoom ∈ (0.5, 1), p 0.25/sample, 0.5/channel.
    - Gamma (0.7, 1.5): inverted p 0.1, normal p 0.3, retain stats.
    - Mirror p 0.5 per axis (0, 1, 2).
    - RemoveLabel −1 → 0; deep-supervision target downsampling.

The port's copy of `deformablelka_tpu/data/augment.py` (numpy, scipy and
the port's `native` resampler). Upstream runs this in
`MultiThreadedAugmenter` worker processes; here a `ThreadedAugmenter`
provides the same prefetch decoupling (numpy releases the GIL inside scipy
kernels). Its workers share one loader and one augmenter, so the order of
the batches depends on the thread scheduler.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range):
    """Enlarged sampling patch covering worst-case rotation+scale
    (default_data_augmentation.py:107-127)."""
    rot_x = min(90 / 360 * 2 * np.pi, max(np.abs(rot_x)))
    rot_y = min(90 / 360 * 2 * np.pi, max(np.abs(rot_y)))
    rot_z = min(90 / 360 * 2 * np.pi, max(np.abs(rot_z)))
    coords = np.array(final_patch_size)
    final_shape = np.copy(coords)
    if len(coords) == 3:
        final_shape = np.max(np.vstack(
            [np.abs(_rot3d(coords, rot_x, 0, 0)), final_shape]), 0)
        final_shape = np.max(np.vstack(
            [np.abs(_rot3d(coords, 0, rot_y, 0)), final_shape]), 0)
        final_shape = np.max(np.vstack(
            [np.abs(_rot3d(coords, 0, 0, rot_z)), final_shape]), 0)
    else:
        final_shape = np.max(np.vstack(
            [np.abs(_rot2d(coords, rot_x)), final_shape]), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


def _rot3d(coords, ax, ay, az):
    rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)],
                   [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx @ np.asarray(coords, float)


def _rot2d(coords, a):
    r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return r @ np.asarray(coords, float)


def _interp_seg(seg, matrix, offset, out_shape, order=1, cval=-1):
    """Per-label affine interpolation (batchgenerators is_seg semantics)."""
    labels = np.unique(seg)
    if order == 0 or len(labels) <= 2:
        return ndimage.affine_transform(seg, matrix, offset, out_shape,
                                        order=0, mode="constant", cval=cval)
    out = np.full(out_shape, cval, seg.dtype)
    best = None
    for lab in labels:
        r = ndimage.affine_transform((seg == lab).astype(np.float32),
                                     matrix, offset, out_shape, order=order,
                                     mode="constant", cval=0)
        if best is None:
            best = r
            out = np.where(r > 0, lab, cval).astype(seg.dtype)
        else:
            sel = r > best
            out[sel] = lab
            best = np.maximum(best, r)
    return out


class MoreDAAugmenter:
    """Per-batch augmentation; call with {"data": (B, *S, C), "seg":
    (B, *S)} (channels-last) on the ENLARGED patch; returns the final
    patch size with deep-supervision targets."""

    def __init__(self, final_patch_size, rotation=(-np.pi / 6, np.pi / 6),
                 scale_range=(0.7, 1.4), p_rot=0.2, p_scale=0.2,
                 do_mirror=True, mirror_axes=(0, 1, 2),
                 gamma_range=(0.7, 1.5),
                 do_elastic: bool = False, p_elastic: float = 0.2,
                 elastic_alpha=(0.0, 900.0), elastic_sigma=(9.0, 13.0),
                 do_intensity: bool = True,
                 deep_supervision_scales: Optional[Sequence] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.final_patch_size = tuple(final_patch_size)
        self.rotation = rotation
        self.scale_range = scale_range
        self.p_rot = p_rot
        self.p_scale = p_scale
        self.do_mirror = do_mirror
        self.mirror_axes = mirror_axes
        self.gamma_range = gamma_range
        self.do_elastic = do_elastic
        self.p_elastic = p_elastic
        self.elastic_alpha = elastic_alpha
        self.elastic_sigma = elastic_sigma
        self.do_intensity = do_intensity
        self.ds_scales = deep_supervision_scales
        self.rng = rng or np.random.RandomState(5678)

    def _elastic(self, data, seg):
        """Elastic deformation (insaneDA pipelines,
        data_augmentation_insaneDA.py:60-61: SpatialTransform
        do_elastic_deform with alpha/sigma): affine-free smoothed random
        displacement field applied with cubic (data) / nearest-valid
        (seg) interpolation."""
        rng = self.rng
        ps = self.final_patch_size
        ndim = seg.ndim
        alpha = rng.uniform(*self.elastic_alpha)
        sigma = rng.uniform(*self.elastic_sigma)
        start = [(s - p) // 2 for s, p in zip(seg.shape, ps)]
        grids = np.meshgrid(*[np.arange(st, st + p, dtype=np.float64)
                              for st, p in zip(start, ps)], indexing="ij")
        coords = []
        for g in grids:
            disp = ndimage.gaussian_filter(
                rng.uniform(-1, 1, ps), sigma, mode="constant")
            mx = np.abs(disp).max()
            if mx > 0:
                disp = disp / mx * (alpha / 100.0)
            coords.append(g + disp)
        coords = np.stack(coords)
        out_data = np.stack([
            ndimage.map_coordinates(data[..., c], coords, order=3,
                                    mode="constant", cval=0)
            for c in range(data.shape[-1])], axis=-1)
        labels = np.unique(seg)
        out_seg = np.full(ps, -1, seg.dtype)
        best = np.zeros(ps, np.float64)
        for lab in labels:
            m = ndimage.map_coordinates((seg == lab).astype(np.float32),
                                        coords, order=1, mode="constant",
                                        cval=1.0 if lab == -1 else 0.0)
            upd = m > best
            out_seg[upd] = lab
            best[upd] = m[upd]
        return out_data.astype(np.float32), out_seg

    # -- individual transforms ------------------------------------------
    def _spatial(self, data, seg):
        """data: (*S, C), seg: (*S)."""
        rng = self.rng
        ndim = seg.ndim
        do_rot = rng.uniform() < self.p_rot
        do_scale = rng.uniform() < self.p_scale
        ps = self.final_patch_size
        in_shape = np.array(seg.shape, float)
        center = (in_shape - 1) / 2
        out_center = (np.array(ps, float) - 1) / 2
        mat = np.eye(ndim)
        if do_rot:
            if ndim == 3:
                a = [rng.uniform(*self.rotation) for _ in range(3)]
                mat = _rotmat3(a[0], a[1], a[2])
            else:
                a = rng.uniform(*self.rotation)
                mat = np.array([[np.cos(a), -np.sin(a)],
                                [np.sin(a), np.cos(a)]])
        if do_scale:
            sc = rng.uniform(*self.scale_range)
            mat = mat * sc
        if not do_rot and not do_scale:
            # plain centre crop
            start = [(s - p) // 2 for s, p in zip(seg.shape, ps)]
            sl = tuple(slice(st, st + p) for st, p in zip(start, ps))
            return data[sl], seg[sl]
        offset = center - mat @ out_center
        if ndim == 3:
            # native C++/OpenMP resampler (deformablelka_tpu_torch/native):
            # order-3 spline with mirror border — the augmentation crops
            # the patch larger than final (get_patch_size) precisely so
            # the border never enters the final patch, making the
            # mirror-vs-constant border choice invisible. Falls back to
            # scipy when the toolchain is absent.
            from deformablelka_tpu_torch import native
            out_data = np.stack([
                native.affine_transform(data[..., c], mat, offset, ps,
                                        order=3)
                for c in range(data.shape[-1])], axis=-1)
        else:
            out_data = np.stack([
                ndimage.affine_transform(data[..., c], mat, offset, ps,
                                         order=3, mode="constant", cval=0)
                for c in range(data.shape[-1])], axis=-1)
        out_seg = _interp_seg(seg, mat, offset, ps, order=1, cval=-1)
        return out_data.astype(np.float32), out_seg

    def _intensity(self, data):
        rng = self.rng
        if rng.uniform() < 0.1:  # gaussian noise
            var = rng.uniform(0, 0.1)
            data = data + rng.normal(0, np.sqrt(var), data.shape)
        if rng.uniform() < 0.2:  # blur per channel
            for c in range(data.shape[-1]):
                if rng.uniform() < 0.5:
                    sigma = rng.uniform(0.5, 1.0)
                    data[..., c] = ndimage.gaussian_filter(data[..., c],
                                                           sigma)
        if rng.uniform() < 0.15:  # brightness
            data = data * rng.uniform(0.75, 1.25)
        if rng.uniform() < 0.15:  # contrast, keep mean
            factor = rng.uniform(0.75, 1.25)
            mean = data.mean()
            data = (data - mean) * factor + mean
        if rng.uniform() < 0.25:  # simulate low resolution
            for c in range(data.shape[-1]):
                if rng.uniform() < 0.5:
                    zoom_f = rng.uniform(0.5, 1.0)
                    small = ndimage.zoom(data[..., c], zoom_f, order=0)
                    back = ndimage.zoom(small,
                                        np.array(data[..., c].shape)
                                        / np.array(small.shape), order=3)
                    sl = tuple(slice(0, s) for s in data[..., c].shape)
                    data[..., c] = back[sl]
        for invert, p in ((True, 0.1), (False, 0.3)):  # gamma
            if rng.uniform() < p:
                mn, sd = data.mean(), data.std()
                if invert:
                    data = -data
                dmin = data.min()
                rnge = data.max() - dmin
                gamma = (rng.uniform(self.gamma_range[0], 1)
                         if rng.uniform() < 0.5
                         else rng.uniform(1, self.gamma_range[1]))
                data = np.power((data - dmin) / max(rnge, 1e-7), gamma) \
                    * rnge + dmin
                if invert:
                    data = -data
                # retain stats
                data = (data - data.mean()) / max(data.std(), 1e-8) * sd + mn
        return data

    def _mirror(self, data, seg):
        for ax in self.mirror_axes:
            if self.rng.uniform() < 0.5:
                data = np.flip(data, axis=ax)
                seg = np.flip(seg, axis=ax)
        return data, seg

    def __call__(self, batch):
        data = np.asarray(batch["data"], np.float32)
        seg = np.asarray(batch["seg"])
        out_d, out_s = [], []
        for b in range(data.shape[0]):
            if (self.do_elastic and seg[b].ndim == 3
                    and self.rng.uniform() < self.p_elastic):
                d, s = self._elastic(data[b], seg[b])
            else:
                d, s = self._spatial(data[b], seg[b])
            if self.do_intensity:
                d = self._intensity(d)
            if self.do_mirror:
                d, s = self._mirror(d, s)
            out_d.append(np.ascontiguousarray(d))
            out_s.append(np.ascontiguousarray(s))
        data = np.stack(out_d)
        seg = np.stack(out_s)
        seg[seg == -1] = 0  # RemoveLabelTransform
        result = {"data": data.astype(np.float32),
                  "target": seg.astype(np.int32)}
        if self.ds_scales is not None:
            targets = []
            for scale in self.ds_scales:
                if all(s == 1 for s in scale):
                    targets.append(result["target"])
                else:
                    step = tuple(int(round(1 / s)) for s in scale)
                    sl = (slice(None),) + tuple(slice(None, None, st)
                                                for st in step)
                    targets.append(result["target"][sl])
            result["target"] = targets
        return result


DA_VARIANTS = ("moreDA", "insaneDA", "noDA")


def get_augmentation(variant: str, final_patch_size,
                     deep_supervision_scales=None, rng=None,
                     **overrides) -> "MoreDAAugmenter":
    """Named DA pipelines mirroring upstream's augmentation files
    (training/data_augmentation/data_augmentation_{moreDA,insaneDA,
    noDA}.py):

      moreDA   — rot ±30°, scale 0.7–1.4, no elastic, intensity stack,
                 mirror (the default training pipeline).
      insaneDA — elastic ON with wider alpha/sigma, rot ±30°, scale
                 0.65–1.6, higher transform probabilities.
      noDA     — mirror-free geometric identity; only the centre crop
                 and deep-supervision downsampling survive
                 (get_no_augmentation drop-in).
    """
    if variant == "moreDA":
        kw: dict = {}
    elif variant == "insaneDA":
        kw = dict(do_elastic=True, p_elastic=0.2, scale_range=(0.65, 1.6),
                  p_rot=0.3, p_scale=0.3)
    elif variant == "noDA":
        kw = dict(p_rot=0.0, p_scale=0.0, do_mirror=False,
                  do_intensity=False)
    else:
        raise KeyError(f"unknown DA variant {variant!r}; one of "
                       f"{DA_VARIANTS}")
    kw.update(overrides)
    return MoreDAAugmenter(final_patch_size,
                           deep_supervision_scales=deep_supervision_scales,
                           rng=rng, **kw)


def _rotmat3(ax, ay, az):
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return rz @ ry @ rx


class ThreadedAugmenter:
    """Background prefetch of augmented batches — the process-pool
    `MultiThreadedAugmenter` analog (data_augmentation_moreDA.py:178-205),
    thread-based since scipy releases the GIL."""

    def __init__(self, loader, transform, num_workers: int = 4,
                 queue_len: int = 2):
        self.loader = loader
        self.transform = transform
        self.q: queue.Queue = queue.Queue(maxsize=queue_len * num_workers)
        self.threads = []
        self._stop = threading.Event()
        for _ in range(num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            batch = self.loader.next()
            if self.transform is not None:
                batch = self.transform(batch)
            try:
                self.q.put(batch, timeout=1.0)
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def next(self):
        return self.__next__()

    def stop(self):
        self._stop.set()
