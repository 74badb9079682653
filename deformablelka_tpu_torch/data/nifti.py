"""Minimal NIfTI-1 reader/writer (nibabel/SimpleITK are not used).

The port's copy of `deformablelka_tpu/data/nifti.py` (numpy, gzip and
struct only; the port imports nothing of the JAX package). Supports the
subset the pipelines need: .nii/.nii.gz, scalar 3D/4D images, gzip,
scl_slope/inter, common dtypes, affine from srow/quaternion, and writing
segmentations/softmax back with a given affine — the IO layer under
upstream's cropping.py / segmentation_export.py / inference_synapse.py.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    def __init__(self, data: np.ndarray, affine: np.ndarray,
                 header: dict | None = None):
        self.data = data
        self.affine = affine
        self.header = header or {}

    @property
    def spacing(self):
        """Voxel spacing per spatial axis (norm of affine columns)."""
        return tuple(float(np.linalg.norm(self.affine[:3, i]))
                     for i in range(3))


def _quaternion_to_rotation(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])


def load(path: str | Path) -> NiftiImage:
    path = Path(path)
    raw = path.read_bytes()
    if path.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack(">i", hdr[0:4])[0] != 348:
            raise ValueError(f"not a NIfTI-1 file: {path}")
    dim = struct.unpack(endian + "8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(dim[1:1 + ndim])
    datatype = struct.unpack(endian + "h", hdr[70:72])[0]
    bitpix = struct.unpack(endian + "h", hdr[72:74])[0]
    pixdim = struct.unpack(endian + "8f", hdr[76:108])
    vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
    scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
    qform_code = struct.unpack(endian + "h", hdr[252:254])[0]
    sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
    quatern = struct.unpack(endian + "6f", hdr[256:280])
    srow = np.frombuffer(hdr[280:328], dtype=endian + "f4").reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=count,
                         offset=int(vox_offset)).reshape(shape, order="F")
    data = np.ascontiguousarray(data)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        b, c, d, qx, qy, qz = quatern
        R = _quaternion_to_rotation(b, c, d)
        qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
        spacing = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine[:3, :3] = R * spacing
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine[:3, :3] = np.diag(pixdim[1:4])
    header = {"pixdim": pixdim, "datatype": datatype, "bitpix": bitpix,
              "qform_code": qform_code, "sform_code": sform_code}
    return NiftiImage(data, affine, header)


def save(img: NiftiImage | np.ndarray, path: str | Path,
         affine: np.ndarray | None = None):
    if isinstance(img, NiftiImage):
        data, affine = img.data, img.affine
    else:
        data = img
        affine = np.eye(4) if affine is None else affine
    path = Path(path)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    spacing = [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
    pixdim = [1.0] + spacing + [1.0] * 4
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    for r in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * r, *affine[r, :4])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload, 1))
    else:
        path.write_bytes(payload)
