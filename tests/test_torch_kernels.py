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
    # Cin padded to the kernel's 32-channel chunk with zero rows
    assert packed.shape == (27 * 32, 16) and packed.dtype == torch.bfloat16
    # row ((kx*3 + ky)*3 + kz)*Cin_pad + c, column o
    assert packed[((1 * 3 + 2) * 3 + 0) * 32 + 3, 5] == w[5, 3, 1, 2, 0].to(torch.bfloat16)
    assert not packed.reshape(27, 32, 16)[:, 4:].any()
    cache = tconv.PackedWeight()
    first = cache.get(w)
    assert cache.get(w) is first           # unchanged parameter: no repack
    with torch.no_grad():
        w.mul_(2.0)                         # in-place update bumps the version
    assert cache.get(w) is not first
    torch.testing.assert_close(cache.get(w).float(), tconv.pack_weight(w).float())


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
