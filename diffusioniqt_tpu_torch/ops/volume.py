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
modules' reconstruction upsample; ``resize_volume`` is the cascade's
resize, with ``jax.image.resize`` semantics.
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


# ---------------------------------------------------------------------------
# resize (the cascade's resize_image_to)
# ---------------------------------------------------------------------------

def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of ``jax.image.resize``'s linear method
    with its default ``antialias=True``: half-pixel centres, a triangle
    kernel widened by the scale when downsampling, columns renormalised
    (jax/_src/image/scale.py ``compute_weight_mat``). ``F.interpolate``
    neither widens the kernel nor renormalises at the edges."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1 - (sample_f[None, :] - src[:, None]).abs() / kernel_scale, min=0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape, method: str = "nearest") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for the methods the JAX
    package calls: every axis whose size changes is resized on its own,
    ``"nearest"`` taking source ``floor((i + 0.5) * n_in / n_out)`` (torch's
    ``nearest-exact``), ``"trilinear"`` / ``"linear"`` by
    :func:`_linear_weights` (antialiased when downsampling). Returns ``x``
    itself when the shape already matches."""
    if tuple(x.shape) == tuple(shape):
        return x
    if method not in ("nearest", "trilinear", "linear"):
        raise ValueError(f"unknown resize method {method}")
    out = x if (method == "nearest" or x.is_floating_point()) else x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5
            out = out.index_select(axis, torch.floor(pos * n_in / n_out).long())
        else:
            w = _linear_weights(n_in, n_out, x.device).to(out.dtype)
            out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    return out


def resize_volume(x: torch.Tensor, target_size: int, method: str = "nearest",
                  clamp_range=None) -> torch.Tensor:
    """Spatially resize a channels-last volume (B, ..., C) to edge
    ``target_size`` on every spatial axis (reference ``resize_image_to``,
    imagen_pytorch3D.py:165-181), 2D slices and 3D volumes. Returns ``x``
    itself when every edge already matches. Otherwise it follows
    ``jax.image.resize``: ``"nearest"`` takes source ``floor((i + 0.5) *
    n_in / n_out)`` (torch's ``nearest-exact``), ``"trilinear"`` /
    ``"linear"`` antialiases when downsampling (:func:`_linear_weights`)."""
    spatial = x.shape[1:-1]
    if all(s == target_size for s in spatial):
        return x
    out = resize(x, (x.shape[0], *(target_size,) * len(spatial), x.shape[-1]), method)
    if clamp_range is not None:
        out = torch.clamp(out, clamp_range[0], clamp_range[1])
    return out
