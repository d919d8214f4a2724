"""The three kernel modules of the port against the JAX Pallas kernels they
replace, run as the JAX package's own tests run them on the CPU
(interpret mode). On a CPU tensor each wrapper takes its plain PyTorch
version, which is what these tests hold against the Pallas kernels; the
CUDA kernels themselves are held against the same plain versions on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import diffusioniqt_tpu.ops.pallas.fused_block as jfb
from diffusioniqt_tpu.ops.pallas.conv3d import conv3d_valid as j_conv3d_valid
from diffusioniqt_tpu.ops.pallas.halo import halo_exchange_pallas
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.ops.kernels import conv3d as tconv
from diffusioniqt_tpu_torch.ops.kernels import fused_block as tfb
from diffusioniqt_tpu_torch.ops.kernels import halo as thalo

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _torch_w(w_jax):
    """(3, 3, 3, Cin, Cout) flax kernel -> (Cout, Cin, 3, 3, 3)."""
    return _t(np.asarray(w_jax).transpose(4, 3, 0, 1, 2).copy())


# ----------------------------------------------------------------- halo

@pytest.mark.parametrize("n,s,c", [(27, 4, 3), (54, 3, 2)])
def test_halo_plain_equals_pallas_interpret(n, s, c):
    x = _rand((n, s, s, s, c), seed=0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(halo_exchange_pallas(jnp.asarray(x), 3))
    before = kernels.launch_counts()
    got = kernels.halo_exchange(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert kernels.launch_counts() == before  # the CPU path launches nothing


def _halo_by_rows(x: torch.Tensor, factor: int) -> torch.Tensor:
    """What the row-wise halo kernel writes: each output row (n, px, py)
    from the three sources :func:`row_sources` gives it (low z end voxel,
    interior run of s voxels, high z end voxel), zeros where one is None."""
    n, s, c = x.shape[0], x.shape[1], x.shape[4]
    e = s + 2
    out = torch.zeros((n, e, e, e, c), dtype=x.dtype)
    for nn in range(n):
        for px in range(e):
            for py in range(e):
                lo, mid, hi = thalo.row_sources(nn, px, py, s, factor)
                if lo is not None:
                    out[nn, px, py, 0] = x[lo[0], lo[1], lo[2], lo[3]]
                if mid is not None:
                    out[nn, px, py, 1:s + 1] = x[mid[0], mid[1], mid[2], mid[3]:mid[3] + s]
                if hi is not None:
                    out[nn, px, py, s + 1] = x[hi[0], hi[1], hi[2], hi[3]]
    return out


@pytest.mark.parametrize("n,s,c,factor", [(2, 5, 3, 1), (54, 4, 2, 3), (27, 3, 1, 3)])
def test_halo_row_decomposition_matches_plain_and_pallas(n, s, c, factor):
    """The halo kernel's row decomposition, exact against the axis sweep
    and the Pallas kernel in interpret mode."""
    x = _rand((n, s, s, s, c), seed=13)
    got = _halo_by_rows(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, kernels.halo_exchange_plain(torch.from_numpy(x),
                                                                   factor).numpy())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(halo_exchange_pallas(jnp.asarray(x), factor))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- conv3d

@pytest.mark.parametrize("b,s,cin,cout", [(2, 8, 8, 8), (27, 4, 2, 16)])
def test_conv3d_plain_matches_pallas_interpret(b, s, cin, cout):
    xh = _rand((b, s + 2, s + 2, s + 2, cin), seed=1)
    w = _rand((3, 3, 3, cin, cout), seed=2, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_conv3d_valid(jnp.asarray(xh), jnp.asarray(w)))
    got = kernels.conv3d_valid(torch.from_numpy(xh), _torch_w(w)).numpy()
    # the tolerance the JAX package holds this kernel to against lax.conv
    # (tests/test_more_models.py): fp32 sums taken in another order
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_pack_weight_layout_and_cache():
    w = torch.randn(16, 4, 3, 3, 3)
    packed = tconv.pack_weight(w)
    # no padding: the kernel's TMA fills channels past Cin with zeros
    assert packed.shape == (27 * 4, 16) and packed.dtype == torch.bfloat16
    # row ((kx*3 + ky)*3 + kz)*Cin + c, column o
    assert packed[((1 * 3 + 2) * 3 + 0) * 4 + 3, 5] == w[5, 3, 1, 2, 0].to(torch.bfloat16)
    cache = tconv.PackedWeight()
    first = cache.get(w)
    assert cache.get(w) is first           # unchanged parameter: no repack
    with torch.no_grad():
        w.mul_(2.0)                         # in-place update bumps the version
    assert cache.get(w) is not first
    torch.testing.assert_close(cache.get(w).float(), tconv.pack_weight(w).float())


def _bf16_values(a):
    """fp32 array holding bf16-representable values, so a bf16 packing of it
    is exact and the comparisons below see only summation order."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _im2col_dense(xh: torch.Tensor, k_pad: int) -> torch.Tensor:
    """What the small-Cin kernel reads: one row per output voxel, column
    k = ((kx*3 + ky)*3 + kz)*Cin + c, zero columns from 27*Cin to k_pad."""
    b, s, cin = xh.shape[0], xh.shape[1] - 2, xh.shape[4]
    taps = [xh[:, kx:kx + s, ky:ky + s, kz:kz + s, :]
            for kx in range(3) for ky in range(3) for kz in range(3)]
    a = torch.stack(taps, dim=4).reshape(b * s ** 3, 27 * cin)
    return torch.nn.functional.pad(a, (0, k_pad - 27 * cin))


@pytest.mark.parametrize("cin", [1, 2, 3, 8])
def test_small_cin_dense_k_matches_plain_and_pallas(cin):
    """The small-Cin route's layout (dense k = tap*Cin + c, K padded to a
    multiple of 16) times its packed weight is the conv, against the plain
    version and the Pallas kernel in interpret mode, fp32."""
    b, s, cout = 2, 4, 16
    xh = _bf16_values(_rand((b, s + 2, s + 2, s + 2, cin), seed=11))
    w = _bf16_values(_rand((3, 3, 3, cin, cout), seed=12, scale=0.1))
    packed = tconv.pack_weight_small(_torch_w(w))
    assert packed.shape == (-(-27 * cin // 16) * 16, cout)
    got = (_im2col_dense(_t(xh), packed.shape[0]) @ packed.float()).reshape(b, s, s, s, cout)
    plain = tconv.conv3d_valid_plain(_t(xh), _torch_w(w))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_conv3d_valid(jnp.asarray(xh), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv3d_route_by_input_width():
    assert [tconv.route(c) for c in (1, 2, 3, 8)] == ["small_cin"] * 4
    assert [tconv.route(c) for c in (9, 16, 64, 256)] == ["igemm"] * 4


def test_pack_weight_small_layout_and_cache():
    w = torch.randn(16, 2, 3, 3, 3)
    packed = tconv.pack_weight_small(w)
    # K = 27 * 2 = 54 padded to 64 with zero rows, not Cin to 32
    assert packed.shape == (64, 16) and packed.dtype == torch.bfloat16
    # row ((kx*3 + ky)*3 + kz)*Cin + c, column o
    assert packed[((1 * 3 + 2) * 3 + 0) * 2 + 1, 5] == w[5, 1, 1, 2, 0].to(torch.bfloat16)
    assert not packed[54:].any()
    cache = tconv.PackedWeight()
    first = cache.get(w, tconv.pack_weight_small)
    assert cache.get(w, tconv.pack_weight_small) is first  # unchanged: no repack
    assert cache.get(w).shape == (27 * 2, 16)    # the other route's layout: repacked
    with torch.no_grad():
        w.mul_(2.0)                              # in-place update bumps the version
    again = cache.get(w, tconv.pack_weight_small)
    assert again is not first
    torch.testing.assert_close(again.float(), tconv.pack_weight_small(w).float())


# ---------------------------------------------------------- fused block

@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(jfb, "INTERPRET", True)


def _fused_inputs(b=27, s=4, c=8, cout=8):
    x = _rand((b, s, s, s, c), seed=3)
    ns = 1.0 + _rand((c,), seed=4, scale=0.1)
    nb = _rand((c,), seed=5, scale=0.1)
    w = _rand((3, 3, 3, c, cout), seed=6, scale=0.1)
    return x, ns, nb, w


@pytest.mark.parametrize("with_scale_shift", [False, True])
def test_fused_block_plain_matches_pallas_interpret(_interpret, with_scale_shift):
    x, ns, nb, w = _fused_inputs()
    b, c = x.shape[0], x.shape[-1]
    ss_np = None
    if with_scale_shift:
        ss_np = (_rand((b, 1, 1, 1, c), seed=7, scale=0.2),
                 _rand((b, 1, 1, 1, c), seed=8, scale=0.2))
    ss_j = None if ss_np is None else tuple(jnp.asarray(a) for a in ss_np)
    want = np.asarray(jfb.fused_boundary_block(
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nb), ss_j, jnp.asarray(w),
        4, 3, jnp.float32))
    ss_t = None if ss_np is None else tuple(_t(a) for a in ss_np)
    got = tfb.fused_boundary_block(_t(x), _t(ns), _t(nb), ss_t, _torch_w(w),
                                   groups=4, factor=3).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-4)


def test_groupnorm_affine_and_tables_match_jax():
    x, ns, nb, _ = _fused_inputs(b=27, s=3, c=8)
    ss = (_rand((27, 1, 1, 1, 8), seed=9, scale=0.2),
          _rand((27, 1, 1, 1, 8), seed=10, scale=0.2))
    ja, jb = jfb.groupnorm_affine(jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nb),
                                  4, scale_shift=tuple(map(jnp.asarray, ss)))
    ta, tb = tfb.groupnorm_affine(_t(x), _t(ns), _t(nb), 4,
                                  scale_shift=tuple(map(_t, ss)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    jta, jtb = jfb._neighbor_tables(ja, jb, 3)
    tta, ttb = tfb.neighbor_tables(_t(np.asarray(ja)), _t(np.asarray(jb)), 3)
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(ttb.numpy(), np.asarray(jtb))


def _time_scale_shift(kind, b, c):
    """No time scale-shift, one per sub-volume, or one per group of b // 3
    sub-volumes (n < B, broadcast as ``_per_sample`` does)."""
    if kind is None:
        return None, None
    n = b if kind == "per_sample" else 3
    return (_t(_rand((n, 1, 1, 1, c), seed=11, scale=0.2)),
            _t(_rand((n, 1, 1, 1, c), seed=12, scale=0.2)))


@pytest.mark.parametrize("factor", [3, 1])
@pytest.mark.parametrize("kind", [None, "per_sample", "per_group"])
def test_norm_tables_plain_equals_affine_and_tables(kind, factor):
    """``PLAIN.norm_tables`` and ``KERNELS.norm_tables`` on a CPU tensor are
    :func:`groupnorm_affine` then :func:`neighbor_tables`, exactly."""
    x, ns, nb, _ = _fused_inputs(b=54, s=3, c=8)
    scale, shift = _time_scale_shift(kind, 54, 8)
    a, bb = tfb.groupnorm_affine(_t(x), _t(ns), _t(nb), 4, scale_shift=(
        None if scale is None else (scale, shift)))
    want = tfb.neighbor_tables(a, bb, factor)
    before = kernels.launch_counts()
    for ops in (kernels.PLAIN, kernels.KERNELS):
        got = ops.norm_tables(_t(x), _t(ns), _t(nb), scale, shift, 4, factor)
        for g, w in zip(got, want):
            assert g.shape == (54, 27, 8) and g.dtype == torch.float32 and g.is_contiguous()
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.launch_counts() == before  # the CPU path launches nothing


@pytest.mark.parametrize("with_scale_shift", [False, True])
def test_fused_boundary_block_plain_ops_unchanged(with_scale_shift):
    """The Block through :data:`PLAIN` is the composition it was before the
    tables had an entry of their own: affine, tables, halo, fused conv."""
    x, ns, nb, w = _fused_inputs(b=27, s=4, c=8, cout=8)
    ss = _time_scale_shift("per_sample" if with_scale_shift else None, 27, 8)
    ss = None if ss[0] is None else ss
    got = tfb.fused_boundary_block(_t(x), _t(ns), _t(nb), ss, _torch_w(w), 4, 3,
                                   ops=kernels.PLAIN)
    a, bb = tfb.groupnorm_affine(_t(x), _t(ns), _t(nb), 4, scale_shift=ss)
    ta, tb = tfb.neighbor_tables(a, bb, 3)
    want = tfb.fused_conv_plain(kernels.halo_exchange_plain(_t(x), 3), ta, tb, _torch_w(w))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# the forwards of chip_smoke.py whose group_norm launches it checks against
# GROUP_NORM_SHAPES on the card: config (a chip_smoke.py constant, or
# SRUnet256), the change chip_smoke.py makes to it, and the rows it runs at
# (the EDM config's: tp-serve and tp-train's ranks at one window, tp-train's
# 1-rank trainer at data 1, 2 and 4)
_SMOKE_NORM_PATHS = {
    "flagship": ("FLAGSHIP_CONFIG", {}, (27, 216)),
    "attention": ("ATTN_CONFIG", {}, (27, 216)),
    "vit": ("ATTN_CONFIG", {"att_type": "vit"}, (27,)),
    "efficient": ("FLAGSHIP_CONFIG", {"efficient": True}, (27, 216)),
    "edm": ("EDM_CONFIG", {}, (27, 54, 108)),
    "train": ("TRAIN_CONFIG", {}, (27,)),
    "srunet256": (None, {}, (27,)),
}


@pytest.mark.parametrize("path", sorted(_SMOKE_NORM_PATHS))
def test_chip_smoke_compares_every_group_norm_shape(path):
    """``chip_smoke.py``'s GROUP_NORM_SHAPES holds the (B, s, C, factor) of
    every ``norm_tables`` call of each forward whose launches it checks
    (``compared_norm_tables``), so that the card run fails on none: the
    model built on the meta device and run at that path's rows."""
    import dataclasses
    import os
    import runpy

    from diffusioniqt_tpu_torch.config import load_config
    from diffusioniqt_tpu_torch.models.unet3d import SRUnet256, iqt_unet_from_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = runpy.run_path(os.path.join(root, "chip_smoke.py"), run_name="chip_smoke_constants")
    config, changes, row_counts = _SMOKE_NORM_PATHS[path]
    meta = torch.device("meta")
    if config is None:
        with meta:
            model = SRUnet256(channels=1, lowres_cond=True, dtype=torch.bfloat16)
    else:
        cfg = load_config(os.path.join(root, smoke[config]))
        for key, value in changes.items():
            setattr(cfg.train, key, value)
        model = iqt_unet_from_config(cfg, device=meta)
    seen = set()

    def norm_tables(x, norm_scale, norm_bias, scale, shift, groups, factor, eps=1e-5):
        seen.add((x.shape[0], x.shape[1], x.shape[4], factor))
        tab = x.new_empty((x.shape[0], 27, x.shape[4]), dtype=torch.float32)
        return tab, tab

    def conv(xh, w, *rest):  # the shape of a VALID 3^3 conv, on the meta device
        s = xh.shape[1] - 2
        return xh.new_empty((xh.shape[0], s, s, s, w.shape[0]))

    ops = dataclasses.replace(kernels.PLAIN, norm_tables=norm_tables,
                              conv3d=conv, fused_conv=lambda xh, a, b, w, cache=None: conv(xh, w))
    model.use_ops(ops)
    with torch.no_grad():
        for rows in row_counts:
            x, lowres = (torch.empty((rows, 32, 32, 32, 1), device=meta) for _ in range(2))
            model(x, torch.full((rows,), 0.5, device=meta), torch.full((rows,), -1.0, device=meta),
                  lowres_cond_img=lowres)
    assert seen
    assert seen <= set(smoke["GROUP_NORM_SHAPES"]), sorted(seen - set(smoke["GROUP_NORM_SHAPES"]))


def test_norm_chunks_fill_the_card():
    """The statistics kernel's chunks (``fused_block.norm_chunks``, 132 SMs):
    several waves of CTAs at the serve and train shapes, at least
    NORM_MIN_LOADS loads a thread, one CTA a sub-volume at the small edges."""
    sms = 132
    want = {(216, 32, 64): 20, (216, 32, 128): 20, (216, 16, 64): 8, (216, 16, 192): 20,
            (216, 8, 128): 2, (27, 32, 64): 64, (216, 4, 256): 1, (27, 4, 512): 1,
            (27, 2, 1024): 1, (27, 32, 32): 32}
    for (nb, s, c), chunks in want.items():
        got = tfb.norm_chunks(nb, s ** 3, c, sms)
        assert got == chunks, ((nb, s, c), got)
        rows = tfb.NORM_THREADS // min(c // 8, tfb.NORM_TILE_VECS)
        if got > 1:
            assert s ** 3 // got >= rows * tfb.NORM_MIN_LOADS
            assert nb * got >= sms * tfb.NORM_CTAS_PER_SM or (
                s ** 3 // (got + 1) < rows * tfb.NORM_MIN_LOADS)


def test_mish_one_exp_matches_mish():
    from diffusioniqt_tpu_torch.utils.misc import mish

    v = torch.linspace(-30.0, 30.0, 2001)
    torch.testing.assert_close(tfb.mish_one_exp(v), mish(v), rtol=1e-5, atol=1e-6)


def test_kernel_ops_backward_through_plain_versions():
    """The autograd path of the Block unit (plain on CPU) matches the
    gradient of the plain composition written out."""
    x, ns, nb, w = _fused_inputs(b=27, s=3, c=4, cout=4)
    xt = _t(x).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    out = tfb.fused_boundary_block(xt, _t(ns), _t(nb), None, wt, 2, 3)
    out.square().sum().backward()
    x2 = _t(x).requires_grad_()
    w2 = _torch_w(w).requires_grad_()
    a, b = tfb.groupnorm_affine(x2, _t(ns), _t(nb), 2)
    ta, tb = tfb.neighbor_tables(a, b, 3)
    ref = tfb.fused_conv_plain(kernels.halo_exchange_plain(x2, 3), ta, tb, w2)
    ref.square().sum().backward()
    torch.testing.assert_close(xt.grad, x2.grad)
    torch.testing.assert_close(wt.grad, w2.grad)


def test_wrappers_refuse_other_devices():
    x = torch.empty((27, 4, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.halo_exchange(x)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.conv3d_valid(torch.empty((1, 6, 6, 6, 8), device="meta"),
                             torch.empty((8, 8, 3, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.norm_tables(x, torch.empty(8, device="meta"), torch.empty(8, device="meta"),
                        None, None, 4, 3)


# ------------------------------------------- the implicit GEMM, tile by tile

def _region_per_axis(p: torch.Tensor, e: int) -> torch.Tensor:
    """0 on the low halo plane, 2 on the high one, 1 inside (per axis)."""
    return torch.where(p == 0, 0, torch.where(p == e - 1, 2, 1))


# brick_plan at every shape of fused_block.BRICK_SHAPES (the presets' Blocks
# and the column shards) and a few more on a card of 132 SMs: (bn, kc, tap,
# split, n_tiles, units, chunks, ctas)
BRICK_PLANS = {
    # the flagship's levels 0 and 1 at Cout 64: the base unit, at any batch
    (216, 32, 64, 64): (64, 64, False, False, 1, 27648, 1, 132),
    (216, 32, 128, 64): (64, 64, False, False, 1, 27648, 2, 132),
    (216, 16, 64, 64): (64, 64, False, False, 1, 3456, 1, 132),
    (27, 32, 64, 64): (64, 64, False, False, 1, 3456, 1, 132),
    # Cout a multiple of 128 (the deeper levels): BN 128, 64-channel chunks
    # in whole-tap groups (A from shared memory); ranges of chunks where
    # whole units leave the last round part full (432 units of 2 or 4
    # chunks: 7 or 14 chunks a CTA, not 8 or 16), whole units where ranges
    # save less than an eighth (3456 units of 2: 53 chunks, not 54) or where
    # the units take one round (108 of 8 chunks)
    (216, 16, 192, 128): (128, 64, True, False, 1, 3456, 3, 132),
    (216, 16, 128, 128): (128, 64, True, False, 1, 3456, 2, 132),
    (216, 8, 128, 128): (128, 64, True, True, 1, 432, 2, 132),
    (216, 8, 256, 256): (128, 64, True, False, 2, 864, 4, 132),
    (216, 8, 256, 128): (128, 64, True, True, 1, 432, 4, 132),
    (27, 32, 128, 128): (128, 64, True, False, 1, 3456, 2, 132),
    (27, 16, 128, 128): (128, 64, True, True, 1, 432, 2, 132),
    (27, 16, 256, 128): (128, 64, True, True, 1, 432, 4, 132),
    (27, 8, 256, 256): (128, 64, True, False, 2, 108, 4, 108),
    (27, 8, 512, 256): (128, 64, True, False, 2, 108, 8, 108),
    # the plain-load brick (Cin % 8 != 0) commits half a tap at any width
    (27, 8, 12, 128): (128, 64, False, False, 1, 54, 1, 54),
    # Cin 32 (SRUnet256's first level): 32-channel chunks, whole taps, at
    # BN 128 and at the narrow unit
    (27, 32, 32, 128): (128, 32, True, False, 1, 3456, 1, 132),
    (27, 32, 32, 32): (32, 32, True, False, 1, 3456, 1, 132),
    # the other 64-wide Blocks: BN 64 in whole-tap groups
    (216, 16, 128, 64): (64, 64, True, False, 1, 3456, 2, 132),
    (216, 8, 128, 64): (64, 64, True, True, 1, 432, 2, 132),
    (216, 16, 192, 64): (64, 64, True, False, 1, 3456, 3, 132),
    # Cout 32 and 16: the narrow unit, whole-tap groups where the brick
    # comes by TMA (Cin % 8 == 0), else half-tap ones
    (216, 32, 64, 32): (32, 64, True, False, 1, 27648, 1, 132),
    (216, 32, 64, 16): (32, 64, True, False, 1, 27648, 1, 132),
    (216, 32, 128, 32): (32, 64, True, False, 1, 27648, 2, 132),
    (216, 16, 64, 32): (32, 64, True, False, 1, 3456, 1, 132),
    (27, 8, 2, 32): (32, 64, False, False, 1, 54, 1, 54),
    (27, 8, 16, 32): (32, 32, True, False, 1, 54, 1, 54),
    (27, 8, 40, 64): (64, 64, True, False, 1, 54, 1, 54),
}


def _conv_plan(nb, s, cin, cout, sms=132):
    """The plan of conv3d's implicit-GEMM route: the base unit
    (:func:`gemm_geometry`'s BN), whole units, one CTA per SM."""
    return tfb.make_brick_plan(nb, s, cin, cout, sms, tconv.gemm_geometry(s, cin, cout).bn)


def _swizzle_phase(r: torch.Tensor, chunk: int) -> torch.Tensor:
    """The brick's swizzle at ``chunk`` channels a row: 16-byte group pc of
    row r holds the chunk's channels 8 (pc ^ phase(r)); 128-byte rows (64
    channels) take the 128-byte swizzle (offset bits 7-9 into 4-6), 64-byte
    rows (32 channels) the 64-byte one (bits 7-8 into 4-5)."""
    return r % 8 if chunk == 64 else (r // 2) % 4


def _emulate_igemm(xh, a_tab, b_tab, w, fused=True, plan=None):
    """What ``csrc/igemm.cuh`` computes under ``plan`` (default: the fused
    route's :func:`brick_plan`, or conv3d's :func:`_conv_plan`, for a card
    of 132 SMs), in fp32. Each unit (n tile, sub-volume, 4 x 8 x 8 output
    brick, in the kernel's ``Unit`` order) by chunk: the halo'd 6 x 10 x 10
    brick's ``plan.kc`` channels (zeros past Cin), put through mish(A_r x +
    B_r) with r the region of each brick voxel, stored with the swizzle of
    its row width (:func:`_swizzle_phase`), and 27 taps, each a row shift
    of the brick read back through the same swizzle, times the tap's weight
    slice: ``kc`` K rows by the unit's ``bn`` columns (zeros past Cout).
    (At BN 128 in whole taps the card reads the same A tiles through a
    matrix descriptor, not by gathers; that layout is held on the card
    only, by ``brick_trace``'s ``desc_check`` and the card tests.)
    Then CTA by CTA (:meth:`BrickPlan.pieces`), every (unit, chunk) once: a
    piece sums its chunks in order; a whole unit is stored, a cut one's
    pieces summed in the order of the CTAs (the reduction's order). Only
    columns below Cout are stored."""
    nb, e, cin = xh.shape[0], xh.shape[1], xh.shape[4]
    s, cout = e - 2, w.shape[0]
    if plan is None:
        plan = (tfb.brick_plan(nb, s, cin, cout, 132) if fused
                else _conv_plan(nb, s, cin, cout))
    tx, ty, tz = tfb.BRICK
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    rows, chunk = hx * hy * hz, plan.kc
    groups_per_row = chunk // 8
    cin_pad = -(-cin // chunk) * chunk
    by, bz = s // ty, s // tz
    per_sub = (s // tx) * by * bz
    assert plan.units == nb * per_sub * plan.n_tiles and plan.n_tiles == -(-cout // plan.bn)
    assert plan.chunks * chunk == cin_pad
    # the kernel's Unit: u -> n tile, sub-volume, brick origin
    u = torch.arange(plan.units)
    nt, r = u // (nb * per_sub), u % (nb * per_sub)
    ub, r = r // per_sub, r % per_sub
    ux, uy, uz = (r // (by * bz)) * tx, ((r // bz) % by) * ty, (r % bz) * tz
    ncol = plan.n_tiles * plan.bn
    wpad = torch.zeros((27, cin_pad, ncol))
    wpad[:, :cin, :cout] = tconv.pack_weight(w).float().reshape(27, cin, cout)
    # brick row r = (hx*HY + hy)*HZ + hz; output row m = (mx*TY + my)*TZ + mz
    bx, bby, bbz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(hx), torch.arange(hy), torch.arange(hz), indexing="ij"))
    px, py, pz = ux[:, None] + bx, uy[:, None] + bby, uz[:, None] + bbz   # (U, rows)
    region = (_region_per_axis(px, e) * 3 + _region_per_axis(py, e)) * 3 + \
        _region_per_axis(pz, e)
    mx, my, mz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(tx), torch.arange(ty), torch.arange(tz), indexing="ij"))
    row0 = (mx * hy + my) * hz + mz
    phase = _swizzle_phase(torch.arange(rows), chunk)
    gidx = torch.arange(groups_per_row)
    # the CTAs' pieces: each (unit, chunk) exactly once, a unit's pieces in
    # the order of the CTAs; new[k, u]: chunk k starts a later piece of unit u
    pieces = [[] for _ in range(plan.units)]
    for c in range(plan.ctas):
        for unit, k0, k1 in plan.pieces(c):
            pieces[unit].append((k0, k1))
    new = torch.zeros((plan.chunks, plan.units), dtype=torch.bool)
    for unit, parts in enumerate(pieces):
        assert [k for k0, k1 in parts for k in range(k0, k1)] == list(range(plan.chunks))
        for k0, _ in parts[1:]:
            new[k0, unit] = True
    # acc: the piece in flight, summed over its chunks' taps in order; done:
    # the unit's finished pieces, summed in the order of the CTAs
    acc = torch.zeros((plan.units, tx * ty * tz, plan.bn))
    done = torch.zeros_like(acc)
    for k, c0 in enumerate(range(0, cin_pad, chunk)):
        done[new[k]] += acc[new[k]]
        acc[new[k]] = 0.0
        n_c = min(chunk, cin - c0)
        brick = torch.zeros((plan.units, rows, chunk))
        raw = xh[ub[:, None], px, py, pz, c0:c0 + n_c]
        if fused:
            ub_r = ub[:, None].expand_as(region)
            raw = tfb.mish_one_exp(a_tab[ub_r, region, c0:c0 + n_c] * raw
                                   + b_tab[ub_r, region, c0:c0 + n_c])
        brick[..., :n_c] = raw
        groups = brick.reshape(-1, rows, groups_per_row, 8)
        phys = groups[:, torch.arange(rows)[:, None], gidx[None, :] ^ phase[:, None]]
        stage = wpad[:, c0:c0 + chunk].reshape(27, chunk, plan.n_tiles, plan.bn)
        for tap in range(27):
            kx, ky, kz = tap // 9, (tap // 3) % 3, tap % 3
            rr = row0 + (kx * hy + ky) * hz + kz
            a = phys[:, rr[:, None], gidx[None, :] ^ phase[rr][:, None]]
            acc += torch.bmm(a.reshape(a.shape[0], -1, chunk), stage[tap].permute(1, 0, 2)[nt])
    cut = new.any(dim=0)
    acc[cut] += done[cut]
    out = torch.zeros((nb, s, s, s, ncol))
    ox, oy, oz = ux[:, None] + mx, uy[:, None] + my, uz[:, None] + mz          # (U, 256)
    cols = nt[:, None] * plan.bn + torch.arange(plan.bn)                       # (U, bn)
    out[ub[:, None, None], ox[..., None], oy[..., None], oz[..., None], cols[:, None, :]] = acc
    return out[..., :cout]


def test_gemm_geometry():
    assert _conv_plan(27, 8, 64, 64).kc == 64
    assert tconv.gemm_geometry(32, 64, 64) == tconv.GemmGeometry(
        brick=(4, 8, 8), chunk=64, cin_pad=64, bn=64, n_tiles=1, bricks=128, tma_brick=True)
    g = tconv.gemm_geometry(8, 256, 256)
    assert (g.bn, g.n_tiles, g.bricks, g.cin_pad) == (128, 2, 2, 256)
    g = tconv.gemm_geometry(16, 2, 16)
    assert (g.bn, g.n_tiles, g.cin_pad, g.tma_brick) == (64, 1, 64, False)
    assert tconv.gemm_geometry(8, 72, 32).cin_pad == 128
    assert set(tfb.BRICK_SHAPES) <= set(BRICK_PLANS)
    for (nb, s, cin, cout), want in BRICK_PLANS.items():
        assert tuple(tfb.brick_plan(nb, s, cin, cout, 132)) == want, (nb, s, cin, cout)


@pytest.mark.parametrize("cout", [16, 64, 128])
@pytest.mark.parametrize("cin", [2, 16, 64, 72])
@pytest.mark.parametrize("s", [8, 16])
def test_fused_kernel_tiles_match_plain_and_pallas(_interpret, s, cin, cout):
    """The fused kernel's decomposition (bricks, regions, chunk padding,
    swizzle, taps as row shifts) equals ``fused_conv_plain`` at fp32, and
    the JAX fused_boundary_block in interpret mode; at s = 8 the same
    decomposition without the prologue is the conv (the wide conv route)."""
    factor, groups = 2, (1 if cin == 2 else 8)
    nb = factor ** 3
    x = _bf16_values(_rand((nb, s, s, s, cin), seed=21))
    ns = 1.0 + _rand((cin,), seed=22, scale=0.1)
    nbias = _rand((cin,), seed=23, scale=0.1)
    ss = (_rand((nb, 1, 1, 1, cin), seed=24, scale=0.2),
          _rand((nb, 1, 1, 1, cin), seed=25, scale=0.2))
    w = _bf16_values(_rand((3, 3, 3, cin, cout), seed=26, scale=(27 * cin) ** -0.5))
    a, b = tfb.groupnorm_affine(_t(x), _t(ns), _t(nbias), groups,
                                scale_shift=tuple(map(_t, ss)))
    ta, tb = tfb.neighbor_tables(a, b, factor)
    xh = kernels.halo_exchange_plain(_t(x), factor)
    got = _emulate_igemm(xh, ta, tb, _torch_w(w))
    np.testing.assert_allclose(got.numpy(), tfb.fused_conv_plain(xh, ta, tb, _torch_w(w)).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jfb.fused_boundary_block(
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nbias), tuple(map(jnp.asarray, ss)),
        jnp.asarray(w), groups, factor, jnp.float32))
    # the tolerance of test_fused_block_plain_matches_pallas_interpret
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3, atol=3e-4)
    if s == 8:
        conv = _emulate_igemm(xh, None, None, _torch_w(w), fused=False)
        np.testing.assert_allclose(conv.numpy(),
                                   tconv.conv3d_valid_plain(xh, _torch_w(w)).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,cin,cout,bn,tap,split,sms", [
    # the narrow unit at Cout 32 and 16 (a ragged n tile), and at 48 (two
    # n tiles, the second ragged) on a card smaller than the units; the
    # plain-load brick (Cin 2) in half-tap groups
    (8, 64, 32, 32, True, False, 132), (8, 16, 16, 32, True, False, 132),
    (16, 72, 48, 32, True, False, 6), (8, 2, 32, 32, False, False, 132),
    # BN 64 and 128, several n tiles, a card smaller than the units
    (8, 64, 128, 64, True, False, 10), (8, 136, 256, 128, True, False, 132),
    # ranges of chunks: 16 units of 3 chunks on 5 CTAs (3 rounds, the last
    # unit cut across three CTAs); 16 units of 5 chunks on 40 CTAs (no whole
    # round, each unit cut across three); whole-tap BN 64; two narrow n
    # tiles, the second ragged
    (8, 136, 128, 128, True, True, 5), (8, 264, 128, 128, True, True, 40),
    (8, 72, 64, 64, True, True, 7), (8, 72, 48, 32, True, True, 13),
    # BN 128 in whole taps (the card reads A by descriptor): one and two
    # chunks, a ragged last chunk with Cout short of the unit, two n tiles;
    # and half taps beside the plain-load brick
    (8, 64, 128, 128, True, False, 132), (16, 128, 128, 128, True, False, 132),
    (8, 136, 96, 128, True, False, 132), (8, 128, 256, 128, True, False, 132),
    (8, 4, 128, 128, False, False, 132)])
def test_brick_plans_match_plain_and_pallas(_interpret, s, cin, cout, bn, tap, split, sms):
    """Each unit width of the brick route under an explicit plan
    (:func:`make_brick_plan`): the emulation, CTA by CTA (with ranges of
    chunks, the cut units summed from their pieces in the order of the
    CTAs), equals ``fused_conv_plain`` at fp32, and the JAX
    fused_boundary_block in interpret mode at the tolerance of the
    fused-block cases above. Whole- and half-tap commit groups compute the
    same sums, unit by unit: they differ in when a group ends. Every plan
    here is one the build runs (half taps only beside the plain-load brick
    and in the BN 64 base unit; ranges of chunks in whole taps)."""
    _check_brick_plan(s, cin, cout, bn, tap, split, sms, kc=64)


def _check_brick_plan(s, cin, cout, bn, tap, split, sms, kc):
    """The emulation under :func:`make_brick_plan`'s plan against
    ``fused_conv_plain`` (fp32, 1e-5) and the JAX fused_boundary_block in
    interpret mode (3e-3 / 3e-4, the fused-block cases' tolerance)."""
    factor, groups = 2, (1 if cin < 8 else 8)
    nb = factor ** 3
    x = _bf16_values(_rand((nb, s, s, s, cin), seed=51))
    ns = 1.0 + _rand((cin,), seed=52, scale=0.1)
    nbias = _rand((cin,), seed=53, scale=0.1)
    ss = (_rand((nb, 1, 1, 1, cin), seed=54, scale=0.2),
          _rand((nb, 1, 1, 1, cin), seed=55, scale=0.2))
    w = _bf16_values(_rand((3, 3, 3, cin, cout), seed=56, scale=(27 * cin) ** -0.5))
    a, b = tfb.groupnorm_affine(_t(x), _t(ns), _t(nbias), groups,
                                scale_shift=tuple(map(_t, ss)))
    ta, tb = tfb.neighbor_tables(a, b, factor)
    xh = kernels.halo_exchange_plain(_t(x), factor)
    plan = tfb.make_brick_plan(nb, s, cin, cout, sms, bn, tap, split, kc=kc)
    assert plan.ctas <= sms and plan.split == split and plan.kc == kc
    assert plan.chunks == -(-cin // kc) and (plan.tap or kc == 64)
    if split:  # some unit is cut
        assert any(k1 - k0 < plan.chunks for c in range(plan.ctas) for _, k0, k1 in plan.pieces(c))
    got = _emulate_igemm(xh, ta, tb, _torch_w(w), plan=plan)
    np.testing.assert_allclose(got.numpy(), tfb.fused_conv_plain(xh, ta, tb, _torch_w(w)).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jfb.fused_boundary_block(
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nbias), tuple(map(jnp.asarray, ss)),
        jnp.asarray(w), groups, factor, jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("s,cin,cout,bn,sms", [
    # Cin 32 at BN 32, 64 and 128 (one chunk, the whole 64-byte row);
    # Cin 16 (zeros past Cin in the chunk) and 40 (a second chunk of 8
    # channels) on a card smaller than the units; Cin 128 in four chunks at
    # BN 128; two narrow n tiles, the second ragged
    (8, 32, 32, 32, 132), (8, 32, 64, 64, 132), (16, 32, 128, 128, 132),
    (8, 16, 32, 32, 132), (8, 40, 64, 64, 7), (8, 128, 128, 128, 132), (8, 64, 48, 32, 13)])
def test_narrow_chunk_plans_match_plain_and_pallas(_interpret, s, cin, cout, bn, sms):
    """32-channel chunks (``kc`` 32: 64-byte brick rows and weight-slice K
    rows, the 64-byte swizzle, whole-tap groups, whole units; at BN 128 A
    read through the descriptor) at each unit width: the emulation, CTA by
    CTA, equals ``fused_conv_plain`` at fp32 and the JAX
    fused_boundary_block in interpret mode."""
    _check_brick_plan(s, cin, cout, bn, True, False, sms, kc=32)


@pytest.mark.parametrize("sms", [132, 14])
@pytest.mark.parametrize("nb,s,cin,cout", tfb.BRICK_SHAPES)
def test_brick_plan_covers_every_product_once(nb, s, cin, cout, sms):
    """Every (output brick, column, chunk of 27 K slices) of the shape is in
    exactly one CTA's pieces; whole units go to the CTAs round robin; with
    ranges of chunks, the units left over after the rounds that fill the
    grid are cut into contiguous ranges of their chunks, in the order of
    the CTAs, each cutting at most its first and last units; the CTAs'
    chunk counts differ by at most one; the grid fits the card; and the
    plan computes no more columns than Cout rounded up to its unit width,
    the narrow unit's 32 at Cout 32 and below."""
    _check_covers_once(tfb.brick_plan(nb, s, cin, cout, sms), nb, s, cin, cout, sms)
    assert tfb.brick_plan(nb, s, cin, cout, sms).kc == (32 if cin <= 32 and cin % 8 == 0 else 64)


@pytest.mark.parametrize("sms", [132, 14])
@pytest.mark.parametrize("nb,s,cin,cout", [
    sh for sh in tfb.BRICK_SHAPES if sh[2] <= 32] + [
    (27, 8, 16, 32), (8, 16, 8, 48), (216, 32, 32, 64), (1, 8, 24, 256)])
def test_narrow_chunk_plan_covers_every_product_once(nb, s, cin, cout, sms):
    """The same coverage for 32-channel chunks (whole taps, whole units)
    where :func:`brick_plan` takes them (Cin <= 32, Cin % 8 == 0): the
    brick-route shapes at Cin 32 and a few more widths, batches and
    unit widths."""
    plan = tfb.brick_plan(nb, s, cin, cout, sms)
    assert plan.tap and plan.kc == 32 and not plan.split
    _check_covers_once(plan, nb, s, cin, cout, sms)


def _check_covers_once(plan, nb, s, cin, cout, sms):
    per_sub = (s // 4) * (s // 8) * (s // 8)
    assert plan.units == nb * per_sub * plan.n_tiles and plan.chunks == -(-cin // plan.kc)
    assert plan.n_tiles * plan.bn >= cout > (plan.n_tiles - 1) * plan.bn
    assert plan.bn == (tfb.NARROW if cout <= tfb.NARROW else plan.bn)
    assert plan.ctas <= sms
    seen = np.zeros((plan.units, plan.chunks), np.int64)
    counts, order = [], []
    for c in range(plan.ctas):
        pieces = plan.pieces(c)
        whole = [u for u, k0, k1 in pieces if u < plan.tail0 or not plan.split]
        assert whole == list(range(c, plan.tail0 if plan.split else plan.units, plan.ctas))
        tail = pieces[len(whole):]
        for i, (u, k0, k1) in enumerate(pieces):
            seen[u, k0:k1] += 1
            assert 0 <= k0 < k1 <= plan.chunks
        for i, (u, k0, k1) in enumerate(tail):
            order += [u * plan.chunks + k for k in range(k0, k1)]
            if 0 < i < len(tail) - 1:
                assert (k0, k1) == (0, plan.chunks)
        counts.append(sum(k1 - k0 for _, k0, k1 in pieces))
    assert (seen == 1).all()
    assert max(counts) - min(counts) <= (1 if plan.split else plan.chunks)
    assert order == list(range(plan.tail0 * plan.chunks, plan.units * plan.chunks))


# ------------------------------------------- the small-edge route, tile by tile

def _emulate_small_edge(xh, a_tab, b_tab, w, sms=132):
    """What ``csrc/fused_block_small.cu`` computes under
    :func:`small_edge_plan` for a card of ``sms`` SMs, in fp32. Per m block
    (``subs`` whole sub-volumes; those past B are zeros) and 64-channel
    chunk (zeros past Cin), the halo'd inputs as one brick of ``subs *
    (S+2)^3`` rows, put through mish(A_r x + B_r) with each row's own
    sub-volume and region r, stored with the 128-byte swizzle; slice k of a
    tile is tap ``k % 27`` (a row shift (kx*E + ky)*E + kz of chunk ``k //
    27``'s brick, read back through the swizzle) times the packed weight's
    slice at the tile's n block. Each CTA of a pair sums the slices of the
    pair's range for its m block in order, tile by tile: a whole tile is
    the output, a cut one goes to the CTA's partial slot, and a cut tile is
    the sum of its CTAs' partials in CTA order. Output row o of m block mb
    is voxel o of sub-volume run mb, stored only below B * S^3."""
    nb, e, cin = xh.shape[0], xh.shape[1], xh.shape[4]
    s, cout = e - 2, w.shape[0]
    plan = tfb.small_edge_plan(nb, s, cin, cout, sms)
    p, v, e3 = plan.subs, s ** 3, e ** 3
    rows, mbs, ks = p * e3, plan.m_blocks, plan.k_slices
    assert p * v == tfb.TILE_ROWS
    ncol, cin_pad = plan.n_blocks * plan.bn, ks // 27 * 64
    wpad = torch.zeros((27, cin_pad, ncol))
    wpad[:, :cin, :cout] = tconv.pack_weight(w).float().reshape(27, cin, cout)
    # brick row -> (sub-volume of the run, x, y, z); output row -> brick row
    sub, hx, hy, hz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(p), torch.arange(e), torch.arange(e), torch.arange(e), indexing="ij"))
    region = (_region_per_axis(hx, e) * 3 + _region_per_axis(hy, e)) * 3 + \
        _region_per_axis(hz, e)
    osub, ox, oy, oz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(p), torch.arange(s), torch.arange(s), torch.arange(s), indexing="ij"))
    row0 = osub * e3 + (ox * e + oy) * e + oz
    r8 = torch.arange(rows) % 8
    xh_pad = torch.cat([xh, torch.zeros((mbs * p - nb,) + tuple(xh.shape[1:]))])
    b_of = torch.arange(mbs)[:, None] * p + sub[None, :]        # (m blocks, rows)
    inside = b_of < nb
    a_slices = []  # [chunk][tap] (m blocks, 128, 64): the A operand of a slice
    for c0 in range(0, cin_pad, 64):
        n_c = min(64, cin - c0)
        brick = torch.zeros((mbs, rows, 64))
        raw = xh_pad[b_of, hx, hy, hz, c0:c0 + n_c]
        bi = torch.where(inside, b_of, 0)
        act = tfb.mish_one_exp(a_tab[bi, region, c0:c0 + n_c] * raw
                               + b_tab[bi, region, c0:c0 + n_c])
        brick[..., :n_c] = torch.where(inside[..., None], act, raw)
        groups = brick.reshape(mbs, rows, 8, 8)
        phys = groups[:, torch.arange(rows)[:, None], torch.arange(8)[None, :] ^ r8[:, None]]
        taps = []
        for tap in range(27):
            kx, ky, kz = tap // 9, (tap // 3) % 3, tap % 3
            r = row0 + (kx * e + ky) * e + kz
            taps.append(phys[:, r[:, None], torch.arange(8)[None, :] ^ (r % 8)[:, None]]
                        .reshape(mbs, 128, 64))
        a_slices.append(taps)
    out = torch.zeros((mbs * 128, ncol))
    ws, cuts = {}, {}
    for g, tile, kb, ke, slot in plan.segments():
        mb, nbk = tile % mbs, tile // mbs
        cols = slice(nbk * plan.bn, (nbk + 1) * plan.bn)
        acc = torch.zeros((128, plan.bn))
        for k in range(kb, ke):
            c, tap = divmod(k, 27)
            acc += a_slices[c][tap][mb] @ wpad[tap, c * 64:(c + 1) * 64, cols]
        if (kb, ke) == (0, ks):
            out[mb * 128:(mb + 1) * 128, cols] = acc
        else:
            ws[g, slot] = acc
            cuts.setdefault(tile, []).append((g, slot))
    # the reduction: each cut tile from its CTAs' partials, in CTA order
    assert bool(cuts) == plan.cut
    for tile, parts in cuts.items():
        mb, nbk = tile % mbs, tile // mbs
        total = torch.zeros((128, plan.bn))
        for key in sorted(parts):
            total += ws[key]
        out[mb * 128:(mb + 1) * 128, nbk * plan.bn:(nbk + 1) * plan.bn] = total
    return out[:nb * v, :cout].reshape(nb, s, s, s, cout)


def test_small_edge_geometry_and_route():
    assert tfb.route(32) == tfb.route(8) == "igemm"
    assert tfb.route(4) == tfb.route(2) == "small_edge"
    for s in (6, 1, 12):
        with pytest.raises(ValueError, match="no route"):
            tfb.route(s)
    # 54 pair tiles of 2 x 2 x 4^3 by 256 columns, 4 chunks: 216 bricks, 4
    # to a pair at most, so 54 pairs of one whole pair tile each, nothing cut
    assert tfb.small_edge_plan(216, 4, 256, 256, 132) == (2, 256, 108, 1, 108, 108, False)
    # one pair of m blocks of 16 x 2^3 by 4 n blocks of 256, 16 chunks:
    # split-K, one chunk of one pair tile on each of 64 pairs (128 SMs)
    assert tfb.small_edge_plan(27, 2, 1024, 1024, 132) == (16, 256, 2, 4, 432, 128, True)
    # 7 pair tiles of one chunk: a pair each, nothing cut; Cout 64 in a 128 tile
    assert tfb.small_edge_plan(27, 4, 64, 64, 132) == (2, 128, 14, 1, 27, 14, False)
    # 2 pair tiles of 3 chunks: on 4 SMs, 2 pairs of one whole pair tile
    # each; on 8 SMs, 3 pairs of 2 bricks, so the middle one's range starts
    # inside a pair tile
    assert tfb.small_edge_plan(8, 4, 192, 256, 4) == (2, 256, 4, 1, 81, 4, False)
    assert tfb.small_edge_plan(8, 4, 192, 256, 8) == (2, 256, 4, 1, 81, 6, True)


def test_small_edge_trace_stamps_only_in_the_trace_build():
    """``small_edge_trace`` reads six phase stamps: ``TRACE(0)`` ...
    ``TRACE(5)`` each once in the kernel's source, compiled to nothing
    unless ``SMALL_EDGE_TRACE`` is defined, which the port's build never
    is."""
    from diffusioniqt_tpu_torch.ops.kernels import runtime, small_edge_trace

    src = (runtime.CSRC / "fused_block_small.cu").read_text()
    stamps = re.findall(r"^\s*TRACE\((\d), ", src, re.M)
    assert sorted(int(k) for k in stamps) == list(range(6))
    assert "#define TRACE(k, cond) do {} while (0)" in src
    assert not any("SMALL_EDGE_TRACE" in flag for flag in runtime.NVCC_FLAGS)
    assert callable(small_edge_trace.build)


@pytest.mark.parametrize("sms", [132, 14])
@pytest.mark.parametrize("nb,s,cin,cout,factor", tfb.SMALL_EDGE_SHAPES)
def test_small_edge_plan_covers_every_product_once(nb, s, cin, cout, factor, sms):
    """Every (output row, output column, K slice) of the shape is in
    exactly one CTA's range, the ranges are whole bricks (27 slices) and
    the pairs' differ by at most one, no pair holds more bricks than one
    wave of ``sms // 2`` pairs must, both CTAs of a pair take the same
    slices, and each CTA writes at most one partial per slot."""
    plan = tfb.small_edge_plan(nb, s, cin, cout, sms)
    assert plan.subs * s ** 3 == tfb.TILE_ROWS and plan.ctas <= sms and plan.ctas % 2 == 0
    assert plan.m_blocks * plan.subs >= nb > (plan.m_blocks - 1) * plan.subs
    assert plan.n_blocks * plan.bn >= cout > (plan.n_blocks - 1) * plan.bn
    assert plan.k_slices == 27 * -(-cin // 64)
    seen = np.zeros((plan.m_blocks * plan.n_blocks, plan.k_slices), np.int64)
    per_cta = np.zeros(plan.ctas, np.int64)
    pieces = {}
    slots = set()
    for g, tile, kb, ke, slot in plan.segments():
        assert 0 <= kb < ke <= plan.k_slices and kb % 27 == 0 and ke % 27 == 0
        seen[tile, kb:ke] += 1
        per_cta[g] += ke - kb
        pieces.setdefault(g, []).append((tile // plan.m_blocks, kb, ke))
        if (kb, ke) != (0, plan.k_slices):
            assert (g, slot) not in slots
            slots.add((g, slot))
    assert (seen == 1).all()
    per_pair = np.maximum(per_cta[0::2], per_cta[1::2])
    assert per_pair.max() - per_pair.min() <= 27
    assert per_pair.max() == 27 * -(-plan.bricks // (sms // 2))
    for g in range(1, plan.ctas, 2):  # a pair's CTAs: the same n blocks and slices
        assert g not in pieces or pieces[g] == pieces[g - 1]
    assert plan.cut == bool(slots)


@pytest.mark.parametrize("s,factor,cin,cout,sms", [
    (4, 3, 72, 64, 132), (2, 3, 64, 128, 132), (2, 1, 8, 16, 132),
    # a 2^3 shape whose tiles are split over several CTAs, and one with
    # whole tiles, cut tiles and several CTAs per tile on a small card
    (2, 3, 192, 256, 132), (4, 1, 136, 192, 10)])
def test_small_edge_tiles_match_plain_and_pallas(_interpret, s, factor, cin, cout, sms):
    """The small-edge kernel's decomposition (tiles of whole sub-volumes, a
    ragged last m block, per-row regions and sub-volumes, chunk padding,
    swizzle, taps as row shifts, stream-K ranges, partials summed in CTA
    order) equals ``fused_conv_plain`` at fp32, and the JAX
    fused_boundary_block in interpret mode."""
    nb, groups = 27, 8
    x = _bf16_values(_rand((nb, s, s, s, cin), seed=31))
    ns = 1.0 + _rand((cin,), seed=32, scale=0.1)
    nbias = _rand((cin,), seed=33, scale=0.1)
    ss = (_rand((nb, 1, 1, 1, cin), seed=34, scale=0.2),
          _rand((nb, 1, 1, 1, cin), seed=35, scale=0.2))
    w = _bf16_values(_rand((3, 3, 3, cin, cout), seed=36, scale=(27 * cin) ** -0.5))
    a, b = tfb.groupnorm_affine(_t(x), _t(ns), _t(nbias), groups,
                                scale_shift=tuple(map(_t, ss)))
    ta, tb = tfb.neighbor_tables(a, b, factor)
    xh = kernels.halo_exchange_plain(_t(x), factor)
    got = _emulate_small_edge(xh, ta, tb, _torch_w(w), sms)
    np.testing.assert_allclose(got.numpy(), tfb.fused_conv_plain(xh, ta, tb, _torch_w(w)).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jfb.fused_boundary_block(
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nbias), tuple(map(jnp.asarray, ss)),
        jnp.asarray(w), groups, factor, jnp.float32))
    # the tolerance of test_fused_block_plain_matches_pallas_interpret
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3, atol=3e-4)


def test_block_backward_runs_no_conv_forward():
    """The Block's backward recomputes the GroupNorm / Mish chain and the
    halo and runs the conv's backward products only: no forward
    convolution among its operators (the remat policy 'conv' rests on it)."""
    x, ns, nb, w = _fused_inputs(b=27, s=4, c=8, cout=8)
    xt = _t(x).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    out = tfb.fused_boundary_block(xt, _t(ns).requires_grad_(), _t(nb), None, wt,
                                   groups=4, factor=3)
    ops = _aten_ops_of(lambda: out.square().sum().backward())
    assert "aten::convolution_backward" in ops
    assert not {"aten::convolution", "aten::_convolution"} & ops, sorted(ops)
    assert xt.grad is not None and wt.grad is not None


# ------------------------------------------- the Block's backward (custom VJP)

@pytest.mark.parametrize("with_scale_shift", [False, True])
def test_block_gradients_match_jax_custom_vjp(_interpret, with_scale_shift):
    """The port's Block backward (one autograd Function over the whole unit,
    its backward the plain composition) against the JAX
    ``fused_boundary_block`` custom_vjp (the Pallas forward in interpret
    mode): gradients of x, norm_scale, norm_bias, scale, shift and w within
    1e-4 of each tensor's largest entry, at fp32."""
    import jax

    b, s, c, groups = 27, 8, 16, 8
    x = _rand((b, s, s, s, c), seed=20)
    ns = 1.0 + _rand((c,), seed=21, scale=0.1)
    nb = _rand((c,), seed=22, scale=0.1)
    w = _rand((3, 3, 3, c, c), seed=23, scale=(27 * c) ** -0.5)
    g = _rand((b, s, s, s, c), seed=24)
    ss = None
    if with_scale_shift:
        ss = (_rand((b, 1, 1, 1, c), seed=25, scale=0.2),
              _rand((b, 1, 1, 1, c), seed=26, scale=0.2))

    def loss(x_, ns_, nb_, ss_, w_):
        out = jfb.fused_boundary_block(x_, ns_, nb_, ss_, w_, groups, 3, jnp.float32)
        return jnp.sum(out * jnp.asarray(g))

    ss_j = None if ss is None else tuple(map(jnp.asarray, ss))
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nb), ss_j, jnp.asarray(w))

    leaves = [_t(a).requires_grad_() for a in (x, ns, nb)]
    ss_t = None if ss is None else tuple(_t(a).requires_grad_() for a in ss)
    wt = _torch_w(w).requires_grad_()
    out = tfb.fused_boundary_block(*leaves, ss_t, wt, groups=groups, factor=3,
                                   ops=kernels.PLAIN)
    (out * _t(g)).sum().backward()

    pairs = [(leaves[0].grad, want[0], "x"), (leaves[1].grad, want[1], "norm_scale"),
             (leaves[2].grad, want[2], "norm_bias"),
             (wt.grad.permute(2, 3, 4, 1, 0), want[4], "w")]
    if ss is not None:
        pairs += [(ss_t[0].grad, want[3][0], "scale"), (ss_t[1].grad, want[3][1], "shift")]
    for got, ref, name in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _aten_ops_of(fn) -> set:
    """Names of the aten operators ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func.name())
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


@pytest.mark.parametrize("with_scale_shift", [False, True])
def test_block_backward_has_no_gather_or_scatter(with_scale_shift):
    """No operator of the Block's backward indexes by tensor: neither a
    gather (``index``, ``index_select``) nor the accumulating scatter
    (``index_put_``, ``index_add_``) that their backward would be. The
    scale-shift comes per 27-sub-volume group, as the U-Net's time
    embedding does, so its broadcast is on the path too."""
    x, ns, nb, w = _fused_inputs(b=54, s=4, c=8, cout=8)
    xt = _t(x).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    ss = None
    if with_scale_shift:
        ss = tuple(_t(_rand((2, 1, 1, 1, 8), seed=k, scale=0.2)).requires_grad_()
                   for k in (11, 12))
    out = tfb.fused_boundary_block(xt, _t(ns).requires_grad_(), _t(nb).requires_grad_(),
                                   ss, wt, groups=4, factor=3)
    ops = _aten_ops_of(lambda: out.square().sum().backward())
    assert xt.grad is not None and wt.grad is not None
    assert "aten::convolution_backward" in ops  # the recorder sees the backward
    assert not [op for op in ops if "index" in op], sorted(ops)
    # the recorder sees the scatter where there is one: autograd through the
    # kernel's coefficient tables, whose gathers the Block's backward avoids
    a, bb = tfb.groupnorm_affine(xt, _t(ns), _t(nb), 4, scale_shift=ss)
    a_tab, b_tab = tfb.neighbor_tables(a, bb, 3)
    tabled = tfb.fused_conv_plain(kernels.halo_exchange_plain(xt, 3), a_tab, b_tab, wt)
    assert "aten::index_put" in _aten_ops_of(lambda: tabled.square().sum().backward())
