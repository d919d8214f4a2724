"""The port's debugging, profiling and FLOP utilities
(``utils/debug.py``, ``utils/profiling.py``, ``utils/flops.py``) against
the JAX package's: NaNs trapped where they are produced, the finite check's
message, the phase timer's summary, a profiler trace, and the conv + matmul
FLOP count held exactly equal to the JAX walker's
(``diffusioniqt_tpu/utils/flops.py``) on ``tests/test_flops.py``'s cases,
a small UNet3D forward and a 3-step ancestral sampler loop."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.utils import debug as jdebug
from diffusioniqt_tpu.utils import profiling as jprof
from diffusioniqt_tpu.utils.flops import matmul_flops as jax_flops
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, gaussian_noise
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.utils import debug, flops, profiling
from diffusioniqt_tpu_torch.utils.flops import matmul_flops

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------


def _nan_forward(x):
    return (x.log() * 2.0).sum()  # log of a negative entry: a NaN in the forward


def test_nan_scope_traps_a_forward_nan_like_jax_debug_nans():
    """A NaN produced in the forward raises ``FloatingPointError`` inside
    ``nan_check_scope`` (as ``jax_debug_nans`` does in the JAX scope), not
    outside it; anomaly detection (the backward) is on inside only."""
    x = np.array([1.0, -1.0], np.float32)
    with jdebug.nan_check_scope():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda v: jnp.log(v).sum())(jnp.asarray(x)).block_until_ready()
    t = torch.from_numpy(x)
    assert torch.isnan(_nan_forward(t))
    with debug.nan_check_scope():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="log"):
            _nan_forward(t)
        _nan_forward(t.abs() + 1)  # finite: no error
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(_nan_forward(t))


def test_enable_nan_checks_globally_and_off_again():
    """``enable_nan_checks`` traps from the call on (forward and backward)
    until ``enable_nan_checks(False)``; a NaN in the backward only is
    trapped too."""
    t = torch.tensor([1.0, -1.0])
    debug.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError):
            _nan_forward(t)
        w = torch.tensor([0.0], requires_grad=True)
        y = (torch.sqrt(w) * 0.0).sum()  # finite forward; backward 0 * inf at sqrt(0)
        with pytest.raises((FloatingPointError, RuntimeError), match="NaN|nan"):
            torch.autograd.grad(y, w)
    finally:
        debug.enable_nan_checks(False)
    assert torch.isnan(_nan_forward(t))
    assert not torch.is_anomaly_enabled()


def test_assert_tree_finite_names_the_paths_like_jax():
    """Nested dicts and lists (and a module's state dict) of tensors: the
    same message as the JAX check on the same tree, the first 8 bad
    paths."""
    good = {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.float32)]}
    debug.assert_tree_finite({k: v for k, v in good.items()})
    bad = {"w": [np.array([np.nan], np.float32), np.ones(1, np.float32)],
           "a": {f"x{i}": np.array([np.inf], np.float32) for i in range(9)}}
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_tree_finite(bad, name="params")
    port_tree = {"w": [torch.from_numpy(v) for v in bad["w"]],
                 "a": {k: torch.from_numpy(v) for k, v in bad["a"].items()}}
    with pytest.raises(FloatingPointError) as got:
        debug.assert_tree_finite(port_tree, name="params")
    assert str(got.value) == str(want.value)
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\['bias'\]"):
        debug.assert_tree_finite(lin)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_phase_timer_summary_format_and_trace(tmp_path):
    """``PhaseTimer.summary`` prints the JAX lines for the same totals; a
    phase with ``sync`` waits for its tensors; ``trace`` writes a Chrome
    trace that holds an ``annotate`` region."""
    got, want = profiling.PhaseTimer(), jprof.PhaseTimer()
    for timer in (got, want):
        timer.totals, timer.counts = {"sample": 2.5, "load": 0.125}, {"sample": 4, "load": 1}
    assert got.summary() == want.summary()
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("matmul", sync=torch.ones(8) @ torch.ones(8)):
            pass
    assert timer.counts == {"matmul": 2} and timer.totals["matmul"] >= 0.0
    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)


# ---------------------------------------------------------------------------
# flops: tests/test_flops.py's cases, exactly the JAX walker's counts
# ---------------------------------------------------------------------------

def _jconv(k):
    return lambda v: jax.lax.conv_general_dilated(
        v, k, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def _tconv(k):  # the same conv, channels last in and out
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2))))
    return lambda v: F.conv3d(v.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)


def test_flops_closed_forms_equal_jax():
    a, b = np.zeros((16, 32), np.float32), np.zeros((32, 8), np.float32)
    assert matmul_flops(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b)) \
        == jax_flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b)) == 2 * 16 * 8 * 32
    k = jnp.zeros((3, 3, 3, 4, 8), jnp.float32)
    x = np.zeros((2, 8, 8, 8, 4), np.float32)
    assert matmul_flops(_tconv(k), torch.from_numpy(x)) == jax_flops(_jconv(k), jnp.asarray(x)) \
        == 2.0 * (2 * 8 * 8 * 8 * 8) * (27 * 4)
    # a depthwise conv: k_elems / C_out counts its one input channel per output
    kd = torch.zeros(8, 1, 3, 3, 3)
    assert matmul_flops(lambda v: F.conv3d(v, kd, padding=1, groups=8),
                        torch.zeros(2, 8, 8, 8, 8)) == 2.0 * (2 * 8 * 8 * 8 * 8) * 27


def test_flops_repeated_body_and_gradient_equal_jax():
    """A body run 7 times (the JAX case's ``lax.scan`` of length 7; here a
    Python loop, every pass counted) and a forward with its gradient
    (``jax.grad`` over the input: the conv and its input-gradient conv)."""
    k = jnp.zeros((3, 3, 3, 4, 4), jnp.float32)
    x = np.zeros((2, 8, 8, 8, 4), np.float32)
    one, tone = _jconv(k), _tconv(k)

    def scanned(v):
        c, _ = jax.lax.scan(lambda c, _: (one(c), None), v, None, length=7)
        return c

    def looped(v):
        for _ in range(7):
            v = tone(v)
        return v

    tx = torch.from_numpy(x)
    assert matmul_flops(looped, tx) == jax_flops(scanned, jnp.asarray(x)) \
        == 7 * matmul_flops(tone, tx)
    want = jax_flops(jax.grad(lambda v: jnp.sum(one(v))), jnp.asarray(x))
    leaf = tx.clone().requires_grad_(True)
    got = matmul_flops(lambda v: torch.autograd.grad(tone(v).sum(), v), leaf)
    assert got == want == 2 * matmul_flops(tone, tx)


SMALL_UNET = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
                  resnet_groups=4, lowres_cond=True, use_se_attn=True, init_cross_embed=False,
                  boundary=True, batch_sample=True, img_size=12)
# softmax attention in the first level's slot and the deep_feature middle
ATTN = dict(attend_at_middle=True, attend_at_enc=(True, False), deep_feature=True,
            attn_dim_head=8, attend_at_enc_heads=2, attend_at_middle_heads=2, init_patch_size=4)
NO_ATTN = dict(attend_at_middle=False, attend_at_enc=False, deep_feature=False)
B, EDGE = 27, 4


@pytest.mark.parametrize("variant", ["plain", "softmax"])
def test_flops_unet3d_forward_equals_jax(variant):
    """A boundary UNet3D forward (27 sub-volumes of 4^3; with softmax
    attention slots in the second case) against the JAX walker over the
    JAX module with ``use_pallas=False`` / ``use_flash=False`` (its Block
    conv on the halo'd input, its attention two einsums)."""
    kw = dict(SMALL_UNET, **(ATTN if variant == "softmax" else NO_ATTN))
    att = "softmax" if variant == "softmax" else "linear"
    jnet = JUNet3D(**kw, att_type=att, use_pallas=False, use_flash=False, dtype=jnp.float32)
    x, t = jnp.zeros((B, EDGE, EDGE, EDGE, 1)), jnp.zeros((B,))
    params = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, t,
                                              lowres_cond_img=x))
    want = jax_flops(lambda p, v: jnet.apply(p, v, t, t, lowres_cond_img=v), params, x)
    unet = UNet3D(**kw, att_type=att).eval()
    tx, tt = torch.zeros(B, EDGE, EDGE, EDGE, 1), torch.zeros(B)
    with torch.no_grad():
        counts = flops.flop_counts(lambda v: unet(v, tt, tt, lowres_cond_img=v), tx)
    assert counts["conv"] + counts["dot"] == want
    assert counts["conv"] > 0 and counts["dot"] > 0  # the dense layers and the SE gates


def test_flops_ancestral_loop_equals_jax():
    """A 3-step ancestral ``p_sample_loop`` (the JAX loop a ``lax.scan``,
    counted times its length; here 3 passes of a Python loop)."""
    steps = 3
    ikw = dict(image_sizes=(EDGE, EDGE), channels=1, timesteps=steps, pred_objectives="x_start",
               dynamic_thresholding=False, batch_sample=True)
    jimagen = JImagen([JNullUnet(), JUNet3D(**SMALL_UNET, **NO_ATTN, att_type="linear",
                                            dtype=jnp.float32)], cond_drop_prob=0.0, **ikw)
    shape = (B, EDGE, EDGE, EDGE, 1)
    lowres = jnp.zeros(shape)
    params = jax.eval_shape(lambda: jimagen.init_params(jax.random.PRNGKey(0), batch_size=B))
    want = jax_flops(lambda p: jimagen.p_sample_loop(
        jimagen.unets[1], p[1], jax.random.PRNGKey(1), shape,
        noise_scheduler=jimagen.noise_schedulers[1], lowres_cond_img=lowres,
        pred_objective="x_start", dynamic_threshold=False), params)
    timagen = Imagen([NullUnet(), UNet3D(**SMALL_UNET, **NO_ATTN)], cond_drop_prob=0.0, **ikw)
    with torch.no_grad():
        one = matmul_flops(lambda v: timagen.unets[1](v, torch.zeros(B), torch.zeros(B),
                                                      lowres_cond_img=v), torch.zeros(shape))
        got = matmul_flops(lambda: timagen.p_sample_loop(
            timagen.unets[1], shape, noise=gaussian_noise(torch.Generator().manual_seed(0)),
            noise_scheduler=timagen.noise_schedulers[1], lowres_cond_img=torch.zeros(shape),
            pred_objective="x_start", dynamic_threshold=False))
    assert got == want == steps * one


def test_kernel_wrappers_report_their_work():
    """Where a kernel launches outside the dispatcher its wrapper reports
    the count its plain version gives: the fused Block and the init conv as
    a 3^3 VALID conv, flash attention as its two products (``record``, a
    no-op without a counter)."""
    xh = torch.zeros(2, 6, 6, 6, 3)
    w = torch.zeros(5, 3, 3, 3, 3)
    plain = flops.flop_counts(kernels.conv3d_valid_plain, xh, w)
    with flops.FlopCounter() as counter:
        flops.record("conv", flops.conv3d_valid_flops((2, 4, 4, 4, 5), 3), "conv3d")
    assert counter.counts == plain == {"conv": 2 * 2 * 4 ** 3 * 5 * 27 * 3, "dot": 0}
    assert counter.by_source == {"conv3d": plain["conv"]}
    q = torch.zeros(3, 7, 4)
    k = torch.zeros(3, 9, 4)
    assert flops.flop_counts(kernels.attention_reference, q, k, k, 0.5)["dot"] \
        == flops.attention_flops(3, 7, 9, 4)
    flops.record("conv", 1, "conv3d")  # no counter running
