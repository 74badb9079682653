"""Native (C++/OpenMP) host kernels of the data pipeline, with ctypes
bindings and a scipy fallback.

The port's copy of `deformablelka_tpu/native/__init__.py`: the order-3
spline resampler that the augmentation's spatial transform calls
(`data/augment.py`). Built at first use: `src/dlka_native.cpp` is compiled
with g++ into `deformablelka_tpu_torch/_build/libdlka_native.so` (rebuilt
when the source is newer). Without a toolchain the module degrades to scipy
(`affine_transform` keeps working; `HAVE_NATIVE` stays False); the
environment variable `DLKA_NO_NATIVE` forces that.

Unlike the original, the first load is serialised by a lock and the
library is written to a temporary file and renamed into place, so that
the augmenter's threads, or two processes, never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "src" / "dlka_native.cpp"
_BUILD = _HERE.parent / "_build"
_LIB = _BUILD / "libdlka_native.so"

_lib = None
_lock = threading.Lock()
HAVE_NATIVE = False


def _build_lib() -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, HAVE_NATIVE
    if _lib is not None:
        return _lib
    if os.environ.get("DLKA_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if (not _LIB.exists()
                    or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
                if not _build_lib():
                    return None
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.dlka_spline_filter3_3d.argtypes = [dp] + [ctypes.c_int] * 3
        lib.dlka_affine_transform_3d_f32.argtypes = (
            [fp] + [ctypes.c_int] * 3 + [dp, dp] + [fp]
            + [ctypes.c_int] * 3 + [ctypes.c_int, ctypes.c_float])
        lib.dlka_affine_transform_3d_spline3.argtypes = (
            [dp] + [ctypes.c_int] * 3 + [dp, dp] + [fp]
            + [ctypes.c_int] * 3)
        lib.dlka_num_threads.restype = ctypes.c_int
        _lib = lib
        HAVE_NATIVE = True
        return lib


def _as_c(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def spline_filter3(volume: np.ndarray) -> np.ndarray:
    """Cubic-spline coefficient prefilter (mirror), like
    scipy.ndimage.spline_filter(order=3, mode='mirror')."""
    lib = _load()
    coeff = np.ascontiguousarray(volume, np.float64)
    if lib is None:
        from scipy import ndimage
        return ndimage.spline_filter(coeff, order=3, mode="mirror")
    lib.dlka_spline_filter3_3d(_as_c(coeff, ctypes.c_double),
                               *map(int, coeff.shape))
    return coeff


def affine_transform(volume: np.ndarray, matrix: np.ndarray,
                     offset: np.ndarray, output_shape, order: int = 1,
                     cval: float = 0.0) -> np.ndarray:
    """scipy.ndimage.affine_transform semantics (3×3 matrix + offset).

    order 0/1 → mode 'constant' (cval); order 3 → mode 'mirror' with
    spline prefiltering (the augmentation's rotations and scalings never
    reach the border: patches are cropped larger than the final size so
    that it never shows, `data/augment.get_patch_size`).
    """
    lib = _load()
    matrix = np.ascontiguousarray(matrix, np.float64).reshape(3, 3)
    offset = np.ascontiguousarray(offset, np.float64).reshape(3)
    if lib is None:
        from scipy import ndimage
        mode = "mirror" if order == 3 else "constant"
        return ndimage.affine_transform(
            np.asarray(volume, np.float32), matrix, offset,
            tuple(output_shape), order=order, mode=mode,
            cval=cval).astype(np.float32)
    out = np.empty(tuple(output_shape), np.float32)
    if order == 3:
        coeff = spline_filter3(volume)
        lib.dlka_affine_transform_3d_spline3(
            _as_c(coeff, ctypes.c_double), *map(int, coeff.shape),
            _as_c(matrix, ctypes.c_double), _as_c(offset, ctypes.c_double),
            _as_c(out, ctypes.c_float), *map(int, out.shape))
    else:
        vol = np.ascontiguousarray(volume, np.float32)
        lib.dlka_affine_transform_3d_f32(
            _as_c(vol, ctypes.c_float), *map(int, vol.shape),
            _as_c(matrix, ctypes.c_double), _as_c(offset, ctypes.c_double),
            _as_c(out, ctypes.c_float), *map(int, out.shape),
            int(order), float(cval))
    return out


def num_threads() -> int:
    lib = _load()
    return lib.dlka_num_threads() if lib is not None else 1
