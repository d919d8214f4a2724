"""Port blocks and UNet3D (diffusioniqt_tpu_torch/models) against the JAX
package's flax modules at fp32, with weights carried across by name
(``diffusioniqt_tpu.utils.torch_convert`` one way,
``diffusioniqt_tpu_torch.utils.convert`` the other). On CPU tensors the
port's 3^3 convs run the kernels' plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.config import load_config as j_load_config
from diffusioniqt_tpu.models import blocks as jb
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.utils import torch_convert as tc
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.models import blocks as tb
from diffusioniqt_tpu_torch.models.unet3d import UNet3D, iqt_unet_from_config
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4  # fp32 sums in other orders, as tests/test_model_parity.py


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _sd(module, prefix):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def _randomize(module, seed):
    """Non-trivial values for every parameter (GroupNorm starts at 1/0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.dim() == 1 else 0.0))
    return module


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------- blocks

def test_learned_sinusoidal_pos_emb():
    port = tb.LearnedSinusoidalPosEmb(16)
    t = _rand((5,), 0)
    want = jb.LearnedSinusoidalPosEmb(16).apply(
        {"params": {"weights": jnp.asarray(port.weights.detach().numpy())}}, jnp.asarray(t))
    _close(port(torch.from_numpy(t)), want, 1e-5, 1e-5)


def test_subvol_group_norm():
    x, g = _rand((3, 4, 4, 4, 16), 1), _rand((16,), 2)
    want = jb.subvol_group_norm(jnp.asarray(x), jnp.asarray(g), 1, 4)
    _close(tb.subvol_group_norm(torch.from_numpy(x), torch.from_numpy(g), 4), want, 1e-5, 1e-5)


@pytest.mark.parametrize("dim_in,with_scale_shift", [(8, False), (12, True)])
def test_block_boundary(dim_in, with_scale_shift):
    port = _randomize(tb.Block(dim_in, 12, groups=4, factor=3), 3)
    x = _rand((27, 4, 4, 4, dim_in), 4)
    ss_j = ss_t = None
    if with_scale_shift:  # acts after the GroupNorm, so needs dim_in == 12
        ss = (_rand((27, 1, 1, 1, 12), 5, 0.2), _rand((27, 1, 1, 1, 12), 6, 0.2))
        ss_j, ss_t = tuple(map(jnp.asarray, ss)), tuple(map(torch.from_numpy, ss))
    flax = jb.Block(12, groups=4, boundary=True, factor=3, dtype=jnp.float32)
    want = flax.apply({"params": tc._block(_sd(port, "b"), "b")}, jnp.asarray(x),
                      scale_shift=ss_j)
    _close(port(torch.from_numpy(x), scale_shift=ss_t), want)


def test_se3d():
    port = _randomize(tb.SE3D(32), 9)
    x = _rand((2, 4, 4, 4, 32), 10)
    sd = port.state_dict()
    params = {"params": {"Dense_0": {"kernel": jnp.asarray(sd["fc.0.weight"].numpy().T)},
                         "Dense_1": {"kernel": jnp.asarray(sd["fc.2.weight"].numpy().T)}}}
    want = jb.SE3D(reduction=16, dtype=jnp.float32).apply(params, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want, 1e-5, 1e-5)


@pytest.mark.parametrize("dim_in,dim_out,use_se", [(8, 8, True), (12, 8, False)])
def test_resnet_block(dim_in, dim_out, use_se):
    port = _randomize(tb.ResnetBlock(dim_in, dim_out, time_cond_dim=16, groups=4,
                                     use_se=use_se, factor=3), 11)
    x, t = _rand((27, 4, 4, 4, dim_in), 12), _rand((27, 16), 13)
    params = {"params": tc._resnet_block(_sd(port, "r"), "r")}
    flax = jb.ResnetBlock(dim_out, time_cond_dim=16, groups=4, use_se=use_se,
                          boundary=True, factor=3, dtype=jnp.float32)
    want = flax.apply(params, jnp.asarray(x), jnp.asarray(t))
    _close(port(torch.from_numpy(x), torch.from_numpy(t)), want)


def test_downsample_and_pixel_shuffle_upsample():
    x = _rand((2, 4, 4, 4, 6), 14)
    down = _randomize(tb.Downsample(6, 10), 15)
    want = jb.Downsample(10, dtype=jnp.float32).apply(
        {"params": {"Conv_0": tc._conv(_sd(down, "d"), "d.1")}}, jnp.asarray(x))
    _close(down(torch.from_numpy(x)), want, 1e-5, 1e-5)
    up = _randomize(tb.PixelShuffleUpsample(6, 5), 16)
    want = jb.PixelShuffleUpsample(5, dtype=jnp.float32).apply(
        {"params": {"Conv_0": tc._conv(_sd(up, "u"), "u.net.0")}}, jnp.asarray(x))
    _close(up(torch.from_numpy(x)), want, 1e-5, 1e-5)


# ---------------------------------------------------------- whole UNet3D

SMALL = dict(dim=16, init_dim=16, num_resnet_blocks=(2, 2), dim_mults=(1, 2),
             channels=1, resnet_groups=4, lowres_cond=True, use_se_attn=True,
             attend_at_middle=False, attend_at_enc=False, init_cross_embed=False,
             pixel_shuffle_upsample=True)


@pytest.mark.parametrize("boundary,batch_sample,deep_feature,edge", [
    (True, True, False, 8),    # the flagship path: 27 sub-volumes, halo convs
    (False, False, True, 8),   # SAME convs (factor 1) and the mid ResnetBlock
])
def test_unet3d_matches_jax(boundary, batch_sample, deep_feature, edge):
    kw = dict(SMALL, boundary=boundary, batch_sample=batch_sample,
              deep_feature=deep_feature, img_size=edge * 3)
    flax = JUNet3D(**kw, att_type="linear", dtype=jnp.float32)
    b = 27 if batch_sample else 2
    x, lr = _rand((b, edge, edge, edge, 1), 17), _rand((b, edge, edge, edge, 1), 18)
    t = np.repeat(_rand((1,), 19), b) if batch_sample else _rand((b,), 19)
    params = jax.jit(flax.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(t), lowres_cond_img=jnp.asarray(lr))
    # non-trivial GroupNorm affine parameters
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jnp.cos(jnp.arange(v.size).reshape(v.shape))
        if "norm" in jax.tree_util.keystr(path) else v, params)
    want = flax.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(t),
                      lowres_cond_img=jnp.asarray(lr))
    port = UNet3D(**kw)
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t),
                   lowres_cond_img=torch.from_numpy(lr))
    _close(got, want)


def _eval_cfg():
    return load_config("config/eval_config.yaml")


@pytest.mark.parametrize("width", ["small", "eval_config"])
def test_weight_round_trip(width):
    """port state_dict -> JAX converter -> state_dict_from_jax_params is the
    identity, key for key."""
    if width == "small":
        port = UNet3D(**SMALL, img_size=24)
    else:
        port = iqt_unet_from_config(_eval_cfg(), device="cpu")
    sd = port.state_dict()
    back = state_dict_from_jax_params(tc.convert_iqt_unet_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_jax_params_round_trip_at_eval_config_width():
    """JAX param tree -> port state_dict -> JAX converter gives the tree
    back, and the port model built from the same config accepts it."""
    jcfg = j_load_config("config/eval_config.yaml")
    from diffusioniqt_tpu.models.unet3d import iqt_unet_from_config as j_iqt

    flax = dataclasses.replace(j_iqt(jcfg), dtype=jnp.float32)
    x = jnp.zeros((27, 32, 32, 32, 1))
    shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), x, x[:, 0, 0, 0, 0],
                                              x[:, 0, 0, 0, 0], lowres_cond_img=x))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(
        treedef, [rng.standard_normal(l.shape).astype(np.float32) for l in leaves])
    sd = state_dict_from_jax_params(params)
    iqt_unet_from_config(_eval_cfg(), device="cpu").load_state_dict(sd)
    again = tc.convert_iqt_unet_state_dict(sd)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(params)


def test_iqt_unet_from_config_eval_geometry():
    port = iqt_unet_from_config(_eval_cfg(), device="cpu")
    assert port.dtype == torch.bfloat16 and port.factor == 3
    blocks = [m for m in port.modules() if isinstance(m, tb.Block)]
    assert len(blocks) == 38  # 19 ResnetBlocks


def test_iqt_unet_from_config_efficient_and_remat_conv():
    """``Train.efficient`` and ``Train.remat_policy: 'conv'`` build: a
    pre-downsample at every level, an upsample at every up level, and the
    'conv' policy (no checkpoint around the ResnetBlocks)."""
    cfg = _eval_cfg()
    cfg.train.efficient, cfg.train.remat, cfg.train.remat_policy = True, True, "conv"
    port = iqt_unet_from_config(cfg, device="cpu")
    assert port.remat and port.remat_policy == "conv"
    assert all(isinstance(d[0], tb.Downsample) for d in port.downs)
    assert all(isinstance(u[0], tb.PixelShuffleUpsample) for u in port.ups)


def test_iqt_unet_from_config_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iqt_unet_from_config(_eval_cfg())
