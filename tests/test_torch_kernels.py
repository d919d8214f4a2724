"""The three kernel modules of the port against the JAX Pallas kernels they
replace, run as the JAX package's own tests run them on the CPU
(interpret mode). On a CPU tensor each wrapper takes its plain PyTorch
version, which is what these tests hold against the Pallas kernels; the
CUDA kernels themselves are held against the same plain versions on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

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


# ------------------------------------------- the implicit GEMM, tile by tile

def _region_per_axis(p: torch.Tensor, e: int) -> torch.Tensor:
    """0 on the low halo plane, 2 on the high one, 1 inside (per axis)."""
    return torch.where(p == 0, 0, torch.where(p == e - 1, 2, 1))


def _emulate_igemm(xh, a_tab, b_tab, w, fused=True):
    """What ``csrc/igemm.cuh`` computes, unit by unit, in fp32: for each
    4 x 8 x 8 output brick (:func:`gemm_geometry`) and BN output channels,
    the halo'd 6 x 10 x 10 brick in 64-channel chunks (zeros past Cin),
    put through mish(A_r x + B_r) with r the region of each brick voxel,
    stored with the 128-byte swizzle (16-byte group pc of row r holds the
    chunk's channels 8 (pc ^ (r & 7))), and 27 taps, each a row shift of the
    brick read back through the same swizzle, times the packed weight."""
    nb, e, cin = xh.shape[0], xh.shape[1], xh.shape[4]
    s, cout = e - 2, w.shape[0]
    geo = tconv.gemm_geometry(s, cin, cout)
    assert geo.bricks == (s // 4) * (s // 8) * (s // 8)
    tx, ty, tz = geo.brick
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    rows = hx * hy * hz
    ncol = geo.n_tiles * geo.bn
    wpad = torch.zeros((27, geo.cin_pad, ncol))
    wpad[:, :cin, :cout] = tconv.pack_weight(w).float().reshape(27, cin, cout)
    # every unit's brick origin (sub-volume, x0, y0, z0)
    ub, ux, uy, uz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(nb), torch.arange(0, s, tx), torch.arange(0, s, ty),
        torch.arange(0, s, tz), indexing="ij"))
    # brick row r = (hx*HY + hy)*HZ + hz; output row m = (mx*TY + my)*TZ + mz
    bx, by, bz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(hx), torch.arange(hy), torch.arange(hz), indexing="ij"))
    px, py, pz = ux[:, None] + bx, uy[:, None] + by, uz[:, None] + bz   # (U, rows)
    region = (_region_per_axis(px, e) * 3 + _region_per_axis(py, e)) * 3 + \
        _region_per_axis(pz, e)
    mx, my, mz = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(tx), torch.arange(ty), torch.arange(tz), indexing="ij"))
    row0 = (mx * hy + my) * hz + mz
    r8 = torch.arange(rows) % 8
    acc = torch.zeros((ux.shape[0], tx * ty * tz, ncol))
    for c0 in range(0, geo.cin_pad, geo.chunk):
        n_c = min(geo.chunk, cin - c0)
        brick = torch.zeros((ux.shape[0], rows, geo.chunk))
        raw = xh[ub[:, None], px, py, pz, c0:c0 + n_c]
        if fused:
            ub_r = ub[:, None].expand_as(region)
            raw = tfb.mish_one_exp(a_tab[ub_r, region, c0:c0 + n_c] * raw
                                   + b_tab[ub_r, region, c0:c0 + n_c])
        brick[..., :n_c] = raw
        groups = brick.reshape(-1, rows, 8, 8)
        phys = groups[:, torch.arange(rows)[:, None], torch.arange(8)[None, :] ^ r8[:, None]]
        for tap in range(27):
            kx, ky, kz = tap // 9, (tap // 3) % 3, tap % 3
            r = row0 + (kx * hy + ky) * hz + kz
            a = phys[:, r[:, None], torch.arange(8)[None, :] ^ (r % 8)[:, None]]
            acc += a.reshape(a.shape[0], -1, geo.chunk) @ wpad[tap, c0:c0 + geo.chunk]
    out = acc[..., :cout].reshape(nb, s // tx, s // ty, s // tz, tx, ty, tz, cout)
    return out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(nb, s, s, s, cout)


def test_gemm_geometry():
    assert tconv.gemm_geometry(32, 64, 64) == tconv.GemmGeometry(
        brick=(4, 8, 8), chunk=64, cin_pad=64, bn=64, n_tiles=1, bricks=128, tma_brick=True)
    g = tconv.gemm_geometry(8, 256, 256)
    assert (g.bn, g.n_tiles, g.bricks, g.cin_pad) == (128, 2, 2, 256)
    g = tconv.gemm_geometry(16, 2, 16)
    assert (g.bn, g.n_tiles, g.cin_pad, g.tma_brick) == (64, 1, 64, False)
    assert tconv.gemm_geometry(8, 72, 32).cin_pad == 128


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
