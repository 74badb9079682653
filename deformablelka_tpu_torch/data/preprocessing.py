"""nnUNet-style preprocessing: crop → resample → normalise.

The port's copy of `deformablelka_tpu/data/preprocessing.py` (numpy and
scipy only; the port imports nothing of the JAX package). Upstream's
behaviour, as the JAX package re-derived it:
  preprocessing/cropping.py:84-117 — crop to the nonzero bounding box
    (any-modality OR mask), set a nonzero-mask channel in seg (-1
    outside) for later normalisation.
  preprocessing/preprocessing.py:38-202 — `resample_patient`: data
    order-3 / seg order-1 spline zoom; when the spacing anisotropy
    exceeds 3 (configuration.py:4) the lowest-resolution axis is
    resampled separately with order 0 ("separate z"), matching
    `get_do_separate_z` / `resample_data_or_seg`.
  GenericPreprocessor.resample_and_normalize (:228-306): CT scheme — clip
    to the dataset-wide foreground 0.5/99.5 percentiles and z-score with
    dataset mean/sd; nonCT — per-image z-score over the nonzero mask when
    cropping changed the size a lot, else over the whole image.

Arrays are (C, *spatial) on the host (numpy), converted to channels-last
only when entering the device pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import zoom, binary_fill_holes

ANISO_THRESHOLD = 3.0


def get_nonzero_bbox(mask: np.ndarray):
    coords = np.where(mask)
    if len(coords[0]) == 0:
        return [[0, s] for s in mask.shape]
    return [[int(c.min()), int(c.max()) + 1] for c in coords]


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """data: (C, *spatial); OR of per-channel nonzero, holes filled
    (cropping.py:84-95)."""
    mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    return binary_fill_holes(mask)


def crop_to_nonzero(data: np.ndarray, seg: Optional[np.ndarray] = None):
    """Returns (data, seg, bbox). Outside-of-mask seg voxels become -1
    (the nonzero-region marker used by normalisation, cropping.py:96-117).
    """
    mask = create_nonzero_mask(data)
    bbox = get_nonzero_bbox(mask)
    slicer = tuple(slice(lo, hi) for lo, hi in bbox)
    data = data[(slice(None),) + slicer]
    cropped_mask = mask[slicer]
    if seg is not None:
        seg = seg[(slice(None),) + slicer]
        seg[(seg == 0) & (~cropped_mask[None])] = -1
    else:
        seg = np.where(cropped_mask[None], 0, -1).astype(np.int16)
    return data, seg, bbox


def get_do_separate_z(spacing, threshold=ANISO_THRESHOLD):
    return (np.max(spacing) / np.min(spacing)) > threshold


def get_lowres_axis(spacing):
    return int(np.argmax(spacing))


def _resample_channel(x, new_shape, order, is_seg):
    if np.all(np.asarray(x.shape) == np.asarray(new_shape)):
        return x.copy()
    factors = [n / o for n, o in zip(new_shape, x.shape)]
    if is_seg:
        # per-label nearest-ish resampling: order-N on one-hot then argmax
        # matches nnUNet's resample with order 1 for seg edges; order 0
        # falls back to plain zoom.
        if order == 0:
            return zoom(x, factors, order=0, mode="nearest")
        labels = np.unique(x)
        out = np.zeros(new_shape, dtype=x.dtype)
        best = None
        for lab in labels:
            r = zoom((x == lab).astype(np.float32), factors, order=order,
                     mode="nearest")
            if best is None:
                best = r
                out[:] = lab
            else:
                sel = r > best
                out[sel] = lab
                best = np.where(sel, r, best)
        return out
    return zoom(x.astype(np.float32), factors, order=order, mode="nearest")


def resample_data_or_seg(data, new_shape, is_seg=False, axis=None, order=3,
                         order_z=0, do_separate_z=False):
    """data: (C, x, y, z). Mirrors preprocessing.py:117-202: with
    separate-z, each in-plane slice along the low-res axis is resampled
    with `order`, then the axis itself with `order_z` (0 = nearest)."""
    data = np.asarray(data)
    C = data.shape[0]
    new_shape = [int(v) for v in new_shape]
    out = []
    for c in range(C):
        x = data[c]
        if do_separate_z and axis is not None:
            a = axis
            in_plane_shape = [s for i, s in enumerate(new_shape) if i != a]
            slices = []
            for idx in range(x.shape[a]):
                sl = np.take(x, idx, axis=a)
                slices.append(_resample_channel(sl, in_plane_shape,
                                                order, is_seg))
            stacked = np.stack(slices, axis=a)
            if stacked.shape[a] != new_shape[a]:
                # resample along the low-res axis (order_z, usually nearest)
                factors = [1.0] * 3
                factors[a] = new_shape[a] / stacked.shape[a]
                if is_seg or order_z == 0:
                    stacked = zoom(stacked, factors, order=0, mode="nearest")
                else:
                    stacked = zoom(stacked, factors, order=order_z,
                                   mode="nearest")
            out.append(stacked)
        else:
            out.append(_resample_channel(x, new_shape, order, is_seg))
    return np.stack(out)


def resample_patient(data, seg, original_spacing, target_spacing,
                     order_data=3, order_seg=1, force_separate_z=None,
                     order_z_data=0, order_z_seg=0):
    """preprocessing.py:38-110 equivalent."""
    original_spacing = np.asarray(original_spacing, float)
    target_spacing = np.asarray(target_spacing, float)
    shape = np.asarray(data.shape[1:] if data is not None
                       else seg.shape[1:], float)
    new_shape = np.round(original_spacing / target_spacing * shape).astype(int)
    if force_separate_z is not None:
        do_sep = force_separate_z
        axis = get_lowres_axis(original_spacing) if do_sep else None
    elif get_do_separate_z(original_spacing):
        do_sep = True
        axis = get_lowres_axis(original_spacing)
    elif get_do_separate_z(target_spacing):
        do_sep = True
        axis = get_lowres_axis(target_spacing)
    else:
        do_sep = False
        axis = None
    data_r = (resample_data_or_seg(data, new_shape, False, axis, order_data,
                                   order_z_data, do_sep)
              if data is not None else None)
    seg_r = (resample_data_or_seg(seg, new_shape, True, axis, order_seg,
                                  order_z_seg, do_sep)
             if seg is not None else None)
    return data_r, seg_r


def ct_normalize(data: np.ndarray, clip_lower: float, clip_upper: float,
                 mean: float, sd: float) -> np.ndarray:
    """CT scheme (preprocessing.py:276-286): clip to foreground
    percentiles then z-score with dataset statistics."""
    data = np.clip(data, clip_lower, clip_upper)
    return (data - mean) / max(sd, 1e-8)


def ct2_normalize(data: np.ndarray, clip_lower: float,
                  clip_upper: float) -> np.ndarray:
    """CT2 scheme (preprocessing.py:287-298): clip to the dataset
    foreground percentiles, but z-score with the PER-CASE mean/sd of the
    in-range voxels (alternative_experiment_planning/normalization)."""
    mask = (data > clip_lower) & (data < clip_upper)
    data = np.clip(data, clip_lower, clip_upper)
    mn = data[mask].mean() if mask.any() else data.mean()
    sd = data[mask].std() if mask.any() else data.std()
    return (data - mn) / max(sd, 1e-8)


def nonct_normalize(data: np.ndarray, seg: Optional[np.ndarray] = None,
                    use_nonzero_mask: bool = False) -> np.ndarray:
    if use_nonzero_mask and seg is not None:
        mask = seg[-1] >= 0
        out = data.copy()
        for c in range(data.shape[0]):
            out[c] = (data[c] - data[c][mask].mean()) / (
                data[c][mask].std() + 1e-8)
            out[c][~mask] = 0
        return out
    m = data.mean(axis=tuple(range(1, data.ndim)), keepdims=True)
    s = data.std(axis=tuple(range(1, data.ndim)), keepdims=True)
    return (data - m) / (s + 1e-8)


class GenericPreprocessor:
    """Crop → resample to target spacing → normalise (per-modality
    schemes), the functional core of preprocessing.py:204-316.

    intensity_properties: per-modality dict with keys
    {"percentile_00_5", "percentile_99_5", "mean", "sd"} (from the dataset
    fingerprint) for CT modalities.
    """

    def __init__(self, normalization_schemes: Sequence[str],
                 use_nonzero_mask: Sequence[bool],
                 target_spacing,
                 intensity_properties=None,
                 transpose_forward=(0, 1, 2)):
        self.schemes = list(normalization_schemes)
        self.use_nonzero_mask = list(use_nonzero_mask)
        self.target_spacing = list(target_spacing)
        self.intensity_properties = intensity_properties or {}
        self.transpose_forward = tuple(transpose_forward)

    def preprocess(self, data: np.ndarray, spacing,
                   seg: Optional[np.ndarray] = None):
        """data: (C, x, y, z) raw intensities. Returns (data, seg,
        properties)."""
        data = np.asarray(data, np.float32)
        original_shape = data.shape[1:]
        data, seg, bbox = crop_to_nonzero(data, seg)
        tf = self.transpose_forward
        data = data.transpose((0,) + tuple(1 + i for i in tf))
        seg = seg.transpose((0,) + tuple(1 + i for i in tf))
        spacing_t = [spacing[i] for i in tf]
        data, seg = resample_patient(data, seg, spacing_t,
                                     self.target_spacing)
        for c in range(data.shape[0]):
            scheme = self.schemes[c] if c < len(self.schemes) else "nonCT"
            if scheme == "CT":
                props = self.intensity_properties[c]
                data[c] = ct_normalize(
                    data[c], props["percentile_00_5"],
                    props["percentile_99_5"], props["mean"], props["sd"])
            elif scheme == "CT2":
                props = self.intensity_properties[c]
                data[c] = ct2_normalize(
                    data[c], props["percentile_00_5"],
                    props["percentile_99_5"])
            elif scheme == "noNorm":
                pass  # PreprocessorFor2D_noNormalization parity
            elif scheme == "rgb01":
                # RGB_scaleto_0_1 planner variant: scale 0-255 → 0-1
                data[c] = data[c] / 255.0
            else:
                mask_flag = (self.use_nonzero_mask[c]
                             if c < len(self.use_nonzero_mask) else False)
                data[c:c + 1] = nonct_normalize(data[c:c + 1], seg,
                                                mask_flag)
        properties = {
            "original_shape": original_shape,
            "crop_bbox": bbox,
            "original_spacing": list(spacing),
            "target_spacing": self.target_spacing,
        }
        return data, seg, properties
