"""The port's attention path (diffusioniqt_tpu_torch/models/attention.py,
ops/attention.py, ops/kernels/flash_attention.py and the attention slots
of UNet3D) against the JAX package's flax modules at fp32, with numpy-seeded
inputs and weights carried across by name. On CPU tensors softmax attention
runs the flash kernel's plain version, which is the JAX
``attention_reference``; the Pallas flash kernel runs in interpret mode.

Tolerances: 1e-4 / 1e-5 (rtol / atol) for single modules and for the plain
attention against the Pallas kernel (fp32 sums in other orders, one online
softmax against one two-pass softmax); 2e-3 / 2e-4 for whole U-Nets, as in
tests/test_torch_unet.py. Weight round trips are exact."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusioniqt_tpu.config import load_config as j_load_config
from diffusioniqt_tpu.models import attention as ja
from diffusioniqt_tpu.models.blocks import ChanLayerNorm as JChanLayerNorm
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.models.unet3d import iqt_unet_from_config as j_iqt_unet_from_config
from diffusioniqt_tpu.ops.volume import upsample_trilinear as j_upsample_trilinear
from diffusioniqt_tpu.utils import torch_convert as tc
from diffusioniqt_tpu_torch import infer
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.models import attention as ta
from diffusioniqt_tpu_torch.models.blocks import ChanLayerNorm
from diffusioniqt_tpu_torch.models.unet3d import UNet3D, iqt_unet_from_config
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.ops.attention import attention_plain, scaled_dot_product_attention
from diffusioniqt_tpu_torch.ops.kernels.flash_attention import check_flash_args, flash_attention
from diffusioniqt_tpu_torch.ops.volume import upsample_trilinear
from diffusioniqt_tpu_torch.utils import convert as port_convert
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NET_RTOL, NET_ATOL = 2e-3, 2e-4
ATTN_CONFIG = "diffusioniqt_tpu_torch/configs/eval_attn_softmax.yaml"


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _sd(module, prefix="m"):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def _randomize(module, seed):
    """Non-trivial values for every parameter (norm scales start at 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.dim() == 1 else 0.0))
    return module.eval()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("shape", [(2, 100, 32), (2, 200, 32)])
def test_flash_plain_matches_pallas_interpret(shape):
    """(2, 200, 32): two 128-column kv tiles of the Pallas kernel, 56 of
    them masked."""
    from jax.experimental.pallas import tpu as pltpu

    from diffusioniqt_tpu.ops.pallas.flash_attention import flash_attention as pallas_fa

    q, k, v = (_rand(shape, s) for s in (1, 2, 3))
    scale = shape[-1] ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    _close(got, want)


def test_sdpa_routing_on_cpu():
    """A CPU tensor runs the plain version and launches nothing, with
    ``use_flash`` on or off; a tensor on another device raises."""
    q, k, v = (torch.from_numpy(_rand((3, 50, 16), s)) for s in (4, 5, 6))
    want = attention_plain(q, k, v, 0.25)
    kernels.reset_launch_counts()
    for use_flash in (True, False):
        torch.testing.assert_close(scaled_dot_product_attention(q, k, v, 0.25, use_flash),
                                   want, rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v, 0.25), want, rtol=0, atol=0)
    assert kernels.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="flash_attention kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)


def test_flash_args_refused():
    bf = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    check_flash_args(bf, bf, bf)
    with pytest.raises(ValueError, match="bfloat16"):
        check_flash_args(bf.float(), bf, bf)
    odd = torch.zeros((2, 16, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        check_flash_args(odd, odd, odd)
    with pytest.raises(ValueError, match="contiguous"):
        check_flash_args(bf.transpose(0, 1), bf, bf)
    with pytest.raises(ValueError, match="do not match"):
        check_flash_args(bf, bf[:, :8].contiguous(), bf)


# ------------------------------------------------------- shared modules

def test_chan_layer_norm():
    port = _randomize(ChanLayerNorm(12), 7)
    x = _rand((2, 3, 4, 5, 12), 8, 3.0) + 1.0
    want = JChanLayerNorm(dtype=jnp.float32).apply(
        {"params": tc._chan_ln(_sd(port), "m")}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want)


@pytest.mark.parametrize("shape,scale", [((2, 3, 4, 2, 5), 2), ((1, 3, 3, 3, 4), 4),
                                         ((1, 1, 2, 3, 2), 2)])
def test_upsample_trilinear(shape, scale):
    x = _rand(shape, 9)
    want = j_upsample_trilinear(jnp.asarray(x), scale=scale, align_corners=True)
    _close(upsample_trilinear(torch.from_numpy(x), scale), want)


def test_patchify_and_reconstruct():
    x = _rand((2, 8, 8, 8, 6), 10)
    patchify = _randomize(ta.Patchify(6, 6, patch_size=4), 11)
    sd = _sd(patchify)
    params = {"ChanLayerNorm_0": tc._chan_ln(sd, "m.norm"),
              "DepthwiseSeparableConv_0": tc._dsconv(sd, "m.projection")}
    want = ja.Patchify(6, 4, dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    tok = patchify(torch.from_numpy(x))
    _close(tok, want)

    recon = _randomize(ta.PatchReconstruct(6, patch_size=4), 12)
    sd = _sd(recon)
    params = {"DepthwiseSeparableConv_0": tc._dsconv(sd, "m.1"),
              "ChanLayerNorm_0": tc._chan_ln(sd, "m.2")}
    want = ja.PatchReconstruct(6, 4, dtype=jnp.float32).apply({"params": params},
                                                              jnp.asarray(tok.detach().numpy()))
    _close(recon(tok), want)


@pytest.mark.parametrize("att_type", ["linear", "softmax"])
@pytest.mark.parametrize("patch", [False, True])
def test_voxel_attention(att_type, patch):
    cls_t = ta.LinearAttention if att_type == "linear" else ta.SoftMaxAttention
    cls_j = ja.LinearAttention if att_type == "linear" else ja.SoftMaxAttention
    port = _randomize(cls_t(12, dim_head=8, heads=3, patch_size=2, patch=patch), 13)
    x = _rand((2, 4, 6, 4, 12), 14)
    want = cls_j(12, dim_head=8, heads=3, patch_size=2, patch=patch, dtype=jnp.float32).apply(
        {"params": tc._attention(_sd(port), "m")}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want)
    # built without context_dim, the module refuses a text context
    with pytest.raises(ValueError, match="context_dim"):
        port(torch.from_numpy(x), context=torch.zeros(2, 3, 12))


@pytest.mark.parametrize("att_type", ["linear", "softmax"])
@pytest.mark.parametrize("patch", [False, True])
def test_voxel_attention_with_text_context(att_type, patch):
    """The text context's LayerNorm and bias-free projection give per-head
    keys and values after the voxel tokens' (JAX attention.py:162-171,
    222-231): softmax attention takes Nq = N queries against Nk = N + L
    keys (the flash kernel's plain version here)."""
    cls_t = ta.LinearAttention if att_type == "linear" else ta.SoftMaxAttention
    cls_j = ja.LinearAttention if att_type == "linear" else ja.SoftMaxAttention
    port = _randomize(cls_t(12, dim_head=8, heads=3, patch_size=2, patch=patch,
                            context_dim=10), 21)
    x, ctx = _rand((2, 4, 6, 4, 12), 22), _rand((2, 5, 10), 23)
    sd = _sd(port)
    params = tc._attention(sd, "m")
    params["LayerNorm_0"] = {"scale": sd["m.to_context.0.weight"].numpy(),
                             "bias": sd["m.to_context.0.bias"].numpy()}
    params["Dense_0"] = {"kernel": sd["m.to_context.1.weight"].numpy().T}
    want = cls_j(12, dim_head=8, heads=3, patch_size=2, patch=patch, context_dim=10,
                 dtype=jnp.float32).apply({"params": params}, jnp.asarray(x),
                                          context=jnp.asarray(ctx))
    _close(port(torch.from_numpy(x), context=torch.from_numpy(ctx)), want,
           rtol=0, atol=1e-4 * np.abs(np.asarray(want)).max())
    # the flax tree converts back to the same state dict
    back = {}
    port_convert._voxel_attention(params, "m", back)
    assert set(back) == set(sd)
    for key, val in sd.items():
        torch.testing.assert_close(back[key], val)


def test_chan_feed_forward():
    port = _randomize(ta.ChanFeedForward(10, mult=2.0), 15)
    x = _rand((2, 3, 3, 3, 10), 16)
    want = ja.ChanFeedForward(10, 2.0, dtype=jnp.float32).apply(
        {"params": tc._chan_feed_forward(_sd(port), "m")}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want)


@pytest.mark.parametrize("att_type", ["linear", "softmax"])
def test_attention_transformer_block(att_type):
    port = _randomize(ta.AttentionTransformerBlock(
        8, att_type=att_type, depth=2, heads=2, dim_head=8, ff_mult=2.0,
        patch_size=2, patch=True), 17)
    x = _rand((1, 4, 4, 4, 8), 18)
    flax = ja.AttentionTransformerBlock(8, att_type=att_type, depth=2, heads=2, dim_head=8,
                                        ff_mult=2.0, patch_size=2, patch=True,
                                        dtype=jnp.float32)
    params = tc._attn_module(_sd(port), "m", att_type)
    _close(port(torch.from_numpy(x)), flax.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("local", [False, True])
def test_vit3d(local):
    port = _randomize(ta.ViT3D(16, patch_size=2, num_heads=2, dim_head=8, img_size=8,
                               depth=2, forward_expansion=2, local=local), 19)
    x = _rand((2, 8, 8, 8, 16), 20)
    flax = ja.ViT3D(16, patch_size=2, num_heads=2, dim_head=8, img_size=8, depth=2,
                    forward_expansion=2, local=local, dtype=jnp.float32)
    want = flax.apply({"params": tc._vit3d(_sd(port), "m")}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want)


# ---------------------------------------------------------- whole UNet3D

SMALL = dict(dim=16, init_dim=16, num_resnet_blocks=(1, 1), dim_mults=(1, 2),
             channels=1, resnet_groups=4, lowres_cond=True, use_se_attn=True,
             init_cross_embed=False, pixel_shuffle_upsample=True, boundary=True,
             batch_sample=True, deep_feature=True, attend_at_middle=True,
             attend_at_enc=(True, True), attn_dim_head=8, attend_at_enc_heads=2,
             attend_at_middle_heads=2, img_size=24)


def _jax_params(flax, x, seed, **kw):
    """A seeded numpy parameter tree of ``flax`` for input ``x``, laid out
    by ``jax.eval_shape`` (no init compile): kernels at 1/sqrt(fan-in),
    norm scales near 1, biases and the rest near 0."""
    t = x[:, 0, 0, 0, 0]
    shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), x, t, t, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        v = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            return v * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        return v * np.float32(0.1) + np.float32(re.search(r"'(g|scale|norm_scale)'\]$", name)
                                                is not None)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("att_type", ["linear", "softmax", "vit"])
def test_unet3d_attention_matches_jax(att_type):
    """Attention after every encoder level's init block (merged 24^3 and
    12^3 volumes, patches 8 and 4) and in the middle, on 27 sub-volumes of
    8^3 with halo convs; vit with the LocalViT feed-forward."""
    kw = dict(SMALL, att_type=att_type)
    flax = JUNet3D(**kw, dtype=jnp.float32)
    x, lr = _rand((27, 8, 8, 8, 1), 21), _rand((27, 8, 8, 8, 1), 22)
    t = np.repeat(_rand((1,), 23), 27)
    params = _jax_params(flax, jnp.asarray(x), 24, lowres_cond_img=jnp.asarray(lr))
    want = jax.jit(flax.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(t),
                               lowres_cond_img=jnp.asarray(lr))
    port = UNet3D(**kw).eval()
    port.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t),
                   lowres_cond_img=torch.from_numpy(lr))
    _close(got, want, NET_RTOL, NET_ATOL)


# ------------------------------------------- the attention configuration

def _attn_cfg(loader, att_type):
    cfg = loader(ATTN_CONFIG)
    cfg.train.att_type = att_type
    return cfg


def test_attn_config_is_the_flagship_with_attention_on():
    new, old = (yaml.safe_load(open(p)) for p in (ATTN_CONFIG, "config/eval_config.yaml"))
    changed = {k for k in old["Train"] if old["Train"][k] != new["Train"][k]}
    assert changed == {"att_type", "att_enc", "att_mid", "deep_feature"}
    assert {k: v for k, v in new.items() if k != "Train"} == \
        {k: v for k, v in old.items() if k != "Train"}
    a, b = j_load_config(ATTN_CONFIG), load_config(ATTN_CONFIG)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_attn_config_geometry():
    """Every slot attends over 12^3 tokens: patches 8, 4, 2 over merged
    edges 96, 48, 24, and patch 2 at edge 24 in the middle."""
    port = iqt_unet_from_config(load_config(ATTN_CONFIG), device="cpu")
    slots = [port.downs[i][2] for i in range(3)] + [port.mid_attn]
    edges, dims = (96, 48, 24, 24), (64, 64, 128, 256)
    for slot, edge, dim in zip(slots, edges, dims):
        attn = slot.layers[0][0]
        assert isinstance(attn, ta.SoftMaxAttention) and attn.heads == 8
        conv = attn.patch_embed.projection.depthwise
        assert edge // conv.kernel_size[0] == 12 and conv.in_channels == dim
    assert port.mid_block is not None


@pytest.mark.parametrize("att_type", ["linear", "softmax", "vit"])
def test_attn_weight_round_trip_at_full_width(att_type):
    """port state_dict -> JAX converter -> state_dict_from_jax_params is the
    identity, and a JAX parameter tree of the same config goes to the port
    and back unchanged."""
    port = iqt_unet_from_config(_attn_cfg(load_config, att_type), device="cpu")
    sd = port.state_dict()
    back = state_dict_from_jax_params(tc.convert_iqt_unet_state_dict(sd, att_type=att_type))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

    flax = dataclasses.replace(j_iqt_unet_from_config(_attn_cfg(j_load_config, att_type)),
                               dtype=jnp.float32)
    x = jnp.zeros((27, 32, 32, 32, 1))
    params = _jax_params(flax, x, 1, lowres_cond_img=x)
    sd = state_dict_from_jax_params(params)
    port.load_state_dict(sd)
    again = tc.convert_iqt_unet_state_dict(sd, att_type=att_type)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_infer_main_serves_the_attention_config_on_cpu(tmp_path):
    """``python -m diffusioniqt_tpu_torch.infer --config <attention yaml>``
    end to end, at a tiny width and one 24^3 window."""
    raw = yaml.safe_load(open(ATTN_CONFIG))
    raw["Train"].update({"dim": 8, "init_dim": 8, "dim_mults": [1, 2],
                         "num_resnet_blocks": [1, 1], "resnet_groups": 4,
                         "patch_size_sub": 8, "timesteps": 2, "att_head_dim": 8,
                         "att_enc": [True, True], "att_enc_depth": [1, 1],
                         "att_enc_heads": [2, 2], "att_mid_heads": 2,
                         "compute_dtype": "float32"})
    cfg_path = tmp_path / "tiny_attn.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    infer.main(["--config", str(cfg_path), "--fake-data", "--fake-edge", "24",
                "--device", "cpu", "--output-dir", str(out)])
    vol = np.load(out / "volume_inf.npy")
    assert vol.shape == (24, 24, 24) and np.isfinite(vol).all()
