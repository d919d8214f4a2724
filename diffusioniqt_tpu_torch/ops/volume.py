"""Volume / patch geometry ops on channels-last tensors (counterpart of
``diffusioniqt_tpu/ops/volume.py``).

Layout: channels-last ``(B, X, Y, Z, C)`` everywhere. The sub-volume batch
ordering is row-major over the (gx, gy, gz) grid: sub-volume
``b = (gx * f + gy) * f + gz`` covers
``volume[gx*s:(gx+1)*s, gy*s:(gy+1)*s, gz*s:(gz+1)*s]``, exactly as in the
JAX package, so split tensors compare without a permutation. (The
reference's unfold/permute order differs; see
``diffusioniqt_tpu/utils/torch_convert.py::reference_subvolume_permutation``.)

``halo_exchange`` here is the plain PyTorch version of the halo kernel
(``ops/kernels/halo.py``); ``upsample_trilinear`` is the attention
modules' reconstruction upsample.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# sub-volume split / merge
# ---------------------------------------------------------------------------

def volume_to_subvolumes(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """(B, f*s, f*s, f*s, C) -> (B*f^3, s, s, s, C)."""
    b, X, Y, Z, c = x.shape
    f = factor
    if X % f or Y % f or Z % f:
        raise ValueError(f"volume edges {(X, Y, Z)} not divisible by factor {f}")
    sx, sy, sz = X // f, Y // f, Z // f
    x = x.reshape(b, f, sx, f, sy, f, sz, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # (b, gx, gy, gz, sx, sy, sz, c)
    return x.reshape(b * f * f * f, sx, sy, sz, c)


def subvolumes_to_volume(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """(B*f^3, s, s, s, C) -> (B, f*s, f*s, f*s, C); inverse of
    :func:`volume_to_subvolumes`."""
    n, sx, sy, sz, c = x.shape
    f = factor
    if n % (f ** 3):
        raise ValueError(f"batch {n} not divisible by factor^3 {f ** 3}")
    b = n // (f ** 3)
    x = x.reshape(b, f, f, f, sx, sy, sz, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, f * sx, f * sy, f * sz, c)


# ---------------------------------------------------------------------------
# boundary halo (the 'boundary' conv mode)
# ---------------------------------------------------------------------------

def _grid_pos(n: int, factor: int, device) -> tuple:
    rem = torch.arange(n, device=device) % (factor ** 3)
    return rem // (factor * factor), (rem // factor) % factor, rem % factor


def halo_exchange(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """(B*f^3, s, s, s, C) -> (B*f^3, s+2, s+2, s+2, C).

    Pads every sub-volume by one voxel filled from its 26 grid neighbours,
    with zeros at the merged volume's outer border (the reference's
    ``boundary_pad``, imagen_pytorch3D.py:37-46). Axis sweep by
    concatenation: extend one spatial axis at a time with the two
    neighbour face planes; edges and corners ride along with the later
    sweeps. ``factor=1`` is plain zero padding.
    """
    n = x.shape[0]
    f = factor
    grid_pos = _grid_pos(n, f, x.device)
    strides = (f * f, f, 1)
    for axis in range(3):
        ax = axis + 1
        m = x.shape[ax]
        faces = []
        for d in (-1, 1):
            face = x.narrow(ax, m - 1 if d == -1 else 0, 1)
            face = torch.roll(face, -d * strides[axis], dims=0)
            valid = (grid_pos[axis] + d >= 0) & (grid_pos[axis] + d < f)
            face = torch.where(valid.reshape((n,) + (1,) * 4), face,
                               torch.zeros((), dtype=face.dtype,
                                           device=face.device))
            faces.append(face)
        x = torch.cat([faces[0], x, faces[1]], dim=ax)
    return x


# ---------------------------------------------------------------------------
# 3D pixel shuffle / unshuffle
# ---------------------------------------------------------------------------

def pixel_shuffle_3d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(B, X, Y, Z, C*r^3) -> (B, X*r, Y*r, Z*r, C); channel index layout
    ``c_out * r^3 + (rx * r + ry) * r + rz`` (reference ``PixelShuffle3D``,
    imagen_pytorch3D.py:427-439, transposed to channels-last)."""
    b, X, Y, Z, c = x.shape
    r = scale
    c_out = c // (r ** 3)
    x = x.reshape(b, X, Y, Z, c_out, r, r, r)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)  # (b, X, rx, Y, ry, Z, rz, c)
    return x.reshape(b, X * r, Y * r, Z * r, c_out)


def pixel_unshuffle_3d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(B, X*r, Y*r, Z*r, C) -> (B, X, Y, Z, C*r^3), the exact inverse of
    :func:`pixel_shuffle_3d` (reference ``Downsample`` rearrange,
    imagen_pytorch3D.py:489-496)."""
    b, X, Y, Z, c = x.shape
    r = scale
    x = x.reshape(b, X // r, r, Y // r, r, Z // r, r, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # (b, x, y, z, c, rx, ry, rz)
    return x.reshape(b, X // r, Y // r, Z // r, c * r ** 3)


# ---------------------------------------------------------------------------
# trilinear upsampling
# ---------------------------------------------------------------------------

def upsample_trilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, sX, sY, sZ, C), trilinear with
    ``align_corners=True`` (torch's ``nn.Upsample`` of the reference's
    ViT3D / Patchify reconstruction), one axis at a time as the JAX
    ``upsample_trilinear`` does, with the interpolation weights cast to
    ``x.dtype``."""
    out = x
    for axis in (1, 2, 3):
        n = out.shape[axis]
        m = n * scale
        if n == 1:
            coords = torch.zeros(m, dtype=torch.float32, device=x.device)
        else:
            coords = torch.arange(m, dtype=torch.float32, device=x.device) * (n - 1) / (m - 1)
        lo = torch.floor(coords).long()
        hi = torch.clamp(lo + 1, max=n - 1)
        w = (coords - lo.float()).to(x.dtype)
        shape = [1] * out.dim()
        shape[axis] = m
        w = w.reshape(shape)
        out = out.index_select(axis, lo) * (1 - w) + out.index_select(axis, hi) * w
    return out
