"""Self-contained NIfTI-1 reader/writer (a copy of
``diffusioniqt_tpu/data/nifti.py``; ``tests/test_torch_data.py`` holds the
two equal).

The reference loads and saves volumes through nibabel (reference
``data.py:96-99``, ``test.py:249-253``), which is not installed everywhere.
This module implements NIfTI-1 directly (348-byte header + optional
extension + raw data, gzipped for ``.nii.gz``):

  * :func:`read` -> (data ndarray, affine 4x4)
  * :func:`write` (float32 by default, arbitrary affine)

Scope: single-file ``.nii``/``.nii.gz``, u8/i16/i32/f32/f64 +
u16/u32/i64/u64/i8, scl_slope/scl_inter scaling, qform/sform affines with
the standard fall-back order (sform if sform_code > 0, else qform, else
pixdim diagonal). Data comes back in the file's (Fortran) axis order like
nibabel's ``get_fdata``.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_SINGLE = (b"n+1\x00", b"n+2\x00")

# NIfTI datatype codes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_to_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    dx, dy, dz = hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    aff = np.eye(4)
    aff[:3, :3] = R * np.array([dx, dy, dz])
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes, byteorder: str) -> dict:
    e = byteorder
    hdr = {}
    hdr["sizeof_hdr"] = struct.unpack(e + "i", raw[0:4])[0]
    hdr["dim"] = struct.unpack(e + "8h", raw[40:56])
    hdr["datatype"] = struct.unpack(e + "h", raw[70:72])[0]
    hdr["bitpix"] = struct.unpack(e + "h", raw[72:74])[0]
    hdr["pixdim"] = struct.unpack(e + "8f", raw[76:108])
    hdr["vox_offset"] = struct.unpack(e + "f", raw[108:112])[0]
    hdr["scl_slope"] = struct.unpack(e + "f", raw[112:116])[0]
    hdr["scl_inter"] = struct.unpack(e + "f", raw[116:120])[0]
    hdr["qform_code"] = struct.unpack(e + "h", raw[252:254])[0]
    hdr["sform_code"] = struct.unpack(e + "h", raw[254:256])[0]
    (hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"],
     hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]) = struct.unpack(
        e + "6f", raw[256:280])
    hdr["srow_x"] = struct.unpack(e + "4f", raw[280:296])
    hdr["srow_y"] = struct.unpack(e + "4f", raw[296:312])
    hdr["srow_z"] = struct.unpack(e + "4f", raw[312:328])
    hdr["magic"] = raw[344:348]
    return hdr


def read(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .nii/.nii.gz file -> (float32 data, 4x4 affine)."""
    with _open(path, "rb") as fh:
        raw = fh.read()

    size_le = struct.unpack("<i", raw[0:4])[0]
    byteorder = "<" if size_le == _HDR_SIZE else ">"
    hdr = _parse_header(raw[:_HDR_SIZE], byteorder)
    if hdr["sizeof_hdr"] != _HDR_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr="
                         f"{hdr['sizeof_hdr']})")

    ndim = hdr["dim"][0]
    shape = tuple(int(d) for d in hdr["dim"][1:1 + ndim])
    if hdr["datatype"] not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype "
                         f"{hdr['datatype']}")
    dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(byteorder)

    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F").astype(np.float32)

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    # nibabel semantics (get_slope_inter): an unusable slope — 0, NaN or
    # inf, all common in real files — disables scaling entirely, INCLUDING
    # the intercept; a usable slope with a non-finite intercept treats the
    # intercept as 0
    if not np.isfinite(inter):
        inter = 0.0
    if np.isfinite(slope) and slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data * np.float32(slope) + np.float32(inter)

    if hdr["sform_code"] > 0:
        affine = np.vstack([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"],
                            [0, 0, 0, 1]]).astype(np.float64)
    elif hdr["qform_code"] > 0:
        affine = _quaternion_to_affine(hdr)
    else:
        affine = np.diag(list(hdr["pixdim"][1:4]) + [1.0])
    return data, affine


def write(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None,
          dtype=np.float32) -> None:
    """Write a single-file NIfTI-1 volume (sform affine)."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, np.float64)
    arr = data.astype(dtype)
    code = _CODES[np.dtype(dtype)]

    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i]))
                      for i in range(min(3, ndim))]
    pixdim += [1.0] * (8 - len(pixdim))

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 2)      # sform_code = aligned
    struct.pack_into("<6f", hdr, 256, 0.0, 0.0, 0.0,
                     affine[0, 3], affine[1, 3], affine[2, 3])
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as fh:
        fh.write(bytes(hdr))
        fh.write(b"\x00" * 4)  # no extensions
        fh.write(np.asfortranarray(arr).tobytes(order="F"))
