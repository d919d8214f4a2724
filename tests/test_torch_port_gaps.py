"""The last JAX pieces with a port counterpart, against the JAX package at
fp32 on seeded numpy inputs (1e-4 of the largest output where the two
compute in another order, bit for bit where they only move data):

* the wrappers' casting of every U-Net (``cast_model_parameters`` of
  ``UNet3D`` and ``NullUnet``, ``Imagen`` / ``ElucidatedImagen`` casting
  each stage, ``Imagen.get_unet``);
* ``upsample_trilinear(..., align_corners=False)``;
* ``StridedDownsample`` (on even and odd edges: flax SAME pads (0, 1) at
  stride 2 on an even edge), ``TrilinearUpsample``, ``UpsampleCombiner``
  with its JAX parameters carried by ``block_state_dict_from_jax_params``;
* merged-volume GroupNorm (``subvol_group_norm`` at factor > 1,
  ``subvol_stats_reshape``), also against the split -> ``group_stats`` ->
  merge path;
* ``boundary_halo``, also against ``halo_exchange``;
* ``ElucidatedImagen.threshold_x_start``,
  ``GaussianDiffusionContinuousTimes.get_times`` /
  ``predict_v_from_start_and_noise``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.core import schedules as jsched
from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.models import blocks as jb
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.ops import volume as jv
from diffusioniqt_tpu_torch.core import schedules as tsched
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.models import blocks as tb
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.ops import volume as tv
from diffusioniqt_tpu_torch.ops.kernels.fused_block import group_stats
from diffusioniqt_tpu_torch.utils.convert import (
    block_state_dict_from_jax_params,
    state_dict_from_jax_params,
)

torch.set_num_threads(1)

EDGE = 4
UNET_KW = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2),
               resnet_groups=4, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=True, batch_sample=True, img_size=12)
WRAP_KW = dict(image_sizes=(EDGE, EDGE), channels=1)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _filled(variables, seed):
    """Every leaf of a flax variable tree replaced by a seeded normal draw
    of scale 1 / sqrt(fan) (kernels) or 0.5 around its init (the rest), so
    no norm scale is one and no bias zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if str(path[-1].key) == "kernel":
            return (rng.standard_normal(x.shape) * np.prod(x.shape[:-1]) ** -0.5
                    ).astype(np.float32)
        return (x + 0.5 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


# ---------------------------------------------------------------------------
# casting the cascade's U-Nets
# ---------------------------------------------------------------------------

def _jax_param_shapes(unet, channels):
    """The flax ``UNet3D``'s parameter shapes as port ``state_dict`` shapes."""
    x = jnp.zeros((27, EDGE, EDGE, EDGE, channels))
    t = jnp.zeros((27,))
    low = x if unet.lowres_cond else None
    shapes = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), x, t, t,
                                              lowres_cond_img=low))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return {k: tuple(v.shape) for k, v in state_dict_from_jax_params(zeros).items()}


@pytest.mark.parametrize("wrapper", ["gaussian", "elucidated"])
def test_wrappers_cast_every_unet_as_jax(wrapper):
    """``UNet3D(lowres_cond=True, channels=2)`` given as unet 1 of a
    one-channel cascade: the JAX wrappers re-instantiate it unconditioned
    with one channel in and out, and so does the port (a fresh module
    whose parameters have the JAX cast module's shapes). A stage that
    already matches is kept as it is, ``NullUnet`` too. On a port whose
    wrappers cast only ``UNet2D``, unet 1 stayed lowres-conditioned with
    two channels."""
    jklass, tklass = ((JImagen, Imagen) if wrapper == "gaussian"
                      else (JElucidated, ElucidatedImagen))
    jfirst = JUNet3D(**UNET_KW, lowres_cond=True, channels=2, att_type="linear",
                     dtype=jnp.float32)
    jsecond = JUNet3D(**UNET_KW, lowres_cond=True, channels=1, att_type="linear",
                      dtype=jnp.float32)
    jwrap = jklass([jfirst, jsecond], **WRAP_KW)
    first, second = UNet3D(**UNET_KW, lowres_cond=True, channels=2), UNet3D(**UNET_KW)
    wrap = tklass([first, second], **WRAP_KW)

    cast = wrap.unets[0]
    want = jwrap.unets[0]
    assert (want.lowres_cond, want.channels, want.channels_out) == (False, 1, 1)
    assert cast is not first
    assert (cast.lowres_cond, cast.channels, cast.channels_out) == (False, 1, 1)
    assert {k: tuple(v.shape) for k, v in cast.state_dict().items()} \
        == _jax_param_shapes(want, 1)
    # the JAX cast rebuilds a module whose channels_out field is None; the
    # port keeps one whose effective channels_out already matches
    assert wrap.unets[1] is second
    assert {k: tuple(v.shape) for k, v in second.state_dict().items()} \
        == _jax_param_shapes(jwrap.unets[1], 1)

    # a lowres-unconditioned U-Net as stage 2 gets the conditioning channels
    lifted = tklass([NullUnet(), UNet3D(**UNET_KW, lowres_cond=False)], **WRAP_KW)
    jlifted = jklass([JNullUnet(), JUNet3D(**UNET_KW, lowres_cond=False, att_type="linear",
                                           dtype=jnp.float32)], **WRAP_KW)
    assert isinstance(lifted.unets[0], NullUnet) and lifted.unets[1].lowres_cond
    assert lifted.unets[1].init_conv.weight.shape[1] == 2
    assert {k: tuple(v.shape) for k, v in lifted.unets[1].state_dict().items()} \
        == _jax_param_shapes(jlifted.unets[1], 1)
    if wrapper == "gaussian":
        assert lifted.get_unet(2) is lifted.unets[1] and jlifted.get_unet(2) is jlifted.unets[1]
        with pytest.raises(ValueError):
            lifted.get_unet(3)


def test_cast_model_parameters_keeps_a_matching_unet():
    unet = UNet3D(**UNET_KW, channels=1, lowres_cond=True)
    assert unet.cast_model_parameters(lowres_cond=True, channels=1, channels_out=1) is unet
    assert unet.cast_model_parameters(lowres_cond=True, channels=1, channels_out=None) is unet
    wider = unet.cast_model_parameters(lowres_cond=True, channels=1, channels_out=2)
    assert wider.channels_out == 2 and wider.final_conv.weight.shape[0] == 2
    assert wider.config == {**unet.config, "channels_out": 2}
    null = NullUnet()
    assert null.cast_model_parameters(lowres_cond=True, channels=3, channels_out=3) is null


# ---------------------------------------------------------------------------
# volume ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape,scale", [((2, 3, 4, 5, 3), 2), ((1, 2, 3, 2, 2), 3)])
def test_upsample_trilinear_matches_jax(shape, scale, align_corners):
    x = _rand(shape, 0)
    want = jv.upsample_trilinear(jnp.asarray(x), scale=scale, align_corners=align_corners)
    got = tv.upsample_trilinear(torch.from_numpy(x), scale=scale, align_corners=align_corners)
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,s,c,factor,halo", [(27, 4, 3, 3, 1), (8, 5, 2, 2, 1),
                                               (27, 4, 2, 3, 2)])
def test_boundary_halo_matches_jax_and_halo_exchange(n, s, c, factor, halo):
    x = _rand((n, s, s, s, c), 1)
    want = np.asarray(jv.boundary_halo(jnp.asarray(x), factor, halo))
    got = tv.boundary_halo(torch.from_numpy(x), factor, halo).numpy()
    np.testing.assert_array_equal(got, want)
    if halo == 1:
        np.testing.assert_array_equal(got, tv.halo_exchange(torch.from_numpy(x), factor).numpy())


# ---------------------------------------------------------------------------
# merged-volume GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,s,c,groups", [(2, 3, 4, 8, 4), (1, 2, 3, 6, 3), (2, 1, 5, 4, 2)])
def test_subvol_group_norm_matches_jax_and_the_split_path(b, f, s, c, groups):
    x = _rand((b, f * s, f * s, f * s, c), 2, scale=3.0) + 1.5
    scale = _rand((c,), 3) + 1.0
    want = jb.subvol_group_norm(jnp.asarray(x), jnp.asarray(scale), f, groups)
    got = tb.subvol_group_norm(torch.from_numpy(x), torch.from_numpy(scale), groups, factor=f)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(
        tb.subvol_stats_reshape(torch.from_numpy(x), f).numpy(),
        np.asarray(jb.subvol_stats_reshape(jnp.asarray(x), f)))
    # per-sub-volume statistics: split, normalise each sub-volume, merge
    split = tv.volume_to_subvolumes(torch.from_numpy(x), f)
    mean, rstd = group_stats(split, groups)
    shape = (split.shape[0], 1, 1, 1, c)
    normed = (split - mean.reshape(shape)) * rstd.reshape(shape) * torch.from_numpy(scale)
    _close(got.numpy(), tv.subvolumes_to_volume(normed, f).numpy())


# ---------------------------------------------------------------------------
# the reference blocks outside the U-Net
# ---------------------------------------------------------------------------

def _jax_block(module, x, *extra, seed):
    variables = _filled(jax.jit(module.init)(jax.random.PRNGKey(0), x, *extra), seed)
    return variables, module.apply(variables, x, *extra)


@pytest.mark.parametrize("edge", [8, 7])
def test_strided_downsample_matches_jax(edge):
    """Flax SAME at stride 2 pads (0, 1) on the even edge 8, (1, 1) on 7."""
    x = _rand((2, edge, edge + 2, edge, 3), 4)
    variables, want = _jax_block(jb.StridedDownsample(5, dtype=jnp.float32), jnp.asarray(x),
                                 seed=5)
    port = tb.StridedDownsample(3, 5)
    port.load_state_dict(block_state_dict_from_jax_params("StridedDownsample", variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, -(-edge // 2), -(-(edge + 2) // 2), -(-edge // 2), 5)
    _close(got.numpy(), want)


def test_trilinear_upsample_matches_jax():
    x = _rand((2, 3, 4, 3, 4), 6)
    variables, want = _jax_block(jb.TrilinearUpsample(6, dtype=jnp.float32), jnp.asarray(x),
                                 seed=7)
    port = tb.TrilinearUpsample(4, 6)
    port.load_state_dict(block_state_dict_from_jax_params("TrilinearUpsample", variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 6, 8, 6, 6)
    _close(got.numpy(), want)


@pytest.mark.parametrize("enabled", [True, False])
def test_upsample_combiner_matches_jax(enabled):
    """Two feature maps (4^3 x 16 and 2^3 x 8) resized to the input's 8^3,
    each through a norm Block at factor 1 (SAME conv, whole-sample
    GroupNorm), concatenated after the 8-channel input."""
    x = _rand((2, 8, 8, 8, 8), 8)
    fmaps = [_rand((2, 4, 4, 4, 16), 9), _rand((2, 2, 2, 2, 8), 10)]
    module = jb.UpsampleCombiner(dim=8, enabled=enabled, dim_outs=(4, 6), dtype=jnp.float32)
    variables, want = _jax_block(module, jnp.asarray(x), [jnp.asarray(f) for f in fmaps],
                                 seed=11)
    port = tb.UpsampleCombiner(8, enabled=enabled, dim_ins=(16, 8), dim_outs=(4, 6))
    port.load_state_dict(block_state_dict_from_jax_params("UpsampleCombiner", variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x), [torch.from_numpy(f) for f in fmaps])
    assert got.shape == want.shape == (2, 8, 8, 8, port.dim_out)
    assert port.dim_out == (18 if enabled else 8)
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrappers' and the scheduler's public methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("norm", ["z-score", "min-max"])
def test_elucidated_threshold_x_start_matches_jax(dynamic, norm):
    kw = dict(WRAP_KW, norm=norm, min_bound=-0.7)
    jwrap = JElucidated([JNullUnet(), JNullUnet()], **kw)
    wrap = ElucidatedImagen([NullUnet(), NullUnet()], **kw)
    x = _rand((3, 4, 4, 4, 1), 12, scale=2.0)
    want = jwrap.threshold_x_start(jnp.asarray(x), dynamic)
    _close(wrap.threshold_x_start(torch.from_numpy(x), dynamic).numpy(), want)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedule_get_times_and_v_target_match_jax(schedule):
    jsch = jsched.GaussianDiffusionContinuousTimes(noise_schedule=schedule)
    tsch = tsched.GaussianDiffusionContinuousTimes(noise_schedule=schedule)
    np.testing.assert_array_equal(tsch.get_times(5, 0.25).numpy(),
                                  np.asarray(jsch.get_times(5, 0.25)))
    assert tsch.get_times(2, 0.0).dtype == torch.float32
    x0, noise = _rand((4, 3, 3, 3, 1), 13), _rand((4, 3, 3, 3, 1), 14)
    t = np.linspace(0.05, 0.95, 4).astype(np.float32)
    want = jsch.predict_v_from_start_and_noise(jnp.asarray(x0), jnp.asarray(t),
                                               jnp.asarray(noise))
    got = tsch.predict_v_from_start_and_noise(torch.from_numpy(x0), torch.from_numpy(t),
                                              torch.from_numpy(noise))
    _close(got.numpy(), want, rtol=1e-5)
