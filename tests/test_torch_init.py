"""The port's fresh parameters against the JAX package's flax initialisers
(``models/blocks.py::lecun_normal_`` and ``LecunInit``): on a narrow
UNet3D (softmax attention slots, the mid ResnetBlock, the deconv upsample)
a narrow UNet2D (softmax and linear attention, the pixel-shuffle
upsample) and a narrow text-conditioned Unet3DVideo (temporal stride 2, a
transformer block, the Perceiver, global-context gates), each tensor of a fresh port module beside the same tensor of a
JAX ``init`` converted to the port's names:

  * every tensor the JAX init zeroes (conv and dense biases, norm biases)
    is zero, every tensor it sets to one (norm scales) is one;
  * every kernel of at least 2048 entries has a standard deviation within
    10% of the JAX tensor's (the sampling error of 2048 draws is about
    1.6%; torch's default ``kaiming_uniform_(a=sqrt(5))`` is 42% under);
  * no kernel entry lies beyond the initialiser's bound: two standard
    deviations of flax's truncated normal, ``2 sqrt(1 / fan_in) /
    0.8796``, or ``sqrt(6 / fan_in)`` for the pixel-shuffle conv's
    ``kaiming_uniform`` ICNR base; the JAX tensors stay within it too;
  * the video U-Net's temporal convs are the identity at their last tap,
    as the JAX ``_identity_temporal_init``, and its normal(1) tensors
    (``null_kv``, ``null_attn_bias``, ``null_text_embed``,
    ``null_text_hidden``, the Perceiver's ``latents`` and ``pos_emb``)
    have, pooled, a standard deviation within 10% of 1."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.models.unet2d import UNet2D as JUNet2D
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.models.unet_video import Unet3DVideo as JUnet3DVideo
from diffusioniqt_tpu_torch.models.blocks import TRUNCATED_NORMAL_STD
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import UNet3D
from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo
from diffusioniqt_tpu_torch.utils.convert import (
    state_dict_from_jax_params,
    unet2d_state_dict_from_jax_params,
    video_state_dict_from_jax_params,
)

torch.set_num_threads(1)

UNET3D = dict(dim=16, init_dim=16, num_resnet_blocks=1, dim_mults=(1, 2), channels=1,
              resnet_groups=4, lowres_cond=True, use_se_attn=True, boundary=False,
              batch_sample=False, deep_feature=True, attend_at_middle=True,
              attend_at_enc=(False, True), att_type="softmax", attn_dim_head=16,
              attend_at_middle_heads=2, attend_at_enc_heads=2, init_patch_size=2,
              pixel_shuffle_upsample=False, init_cross_embed=False, img_size=8)
UNET2D = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, lowres_cond=True,
              resnet_groups=4, att_type="softmax", layer_attns=(False, True),
              attend_at_middle=True, attn_heads=2, attn_dim_head=16)
VIDEO = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, resnet_groups=4,
             attn_dim_head=8, attn_heads=2, layer_attns=(False, True),
             layer_cross_attns=(False, True), init_cross_embed=False, init_conv_kernel_size=3,
             text_embed_dim=32, max_text_len=8, attn_pool_num_latents=4,
             temporal_strides=(1, 2))
NORMAL_1 = ("null_kv", "null_attn_bias", "null_text_embed", "null_text_hidden", "latents",
            "pos_emb")


def _fan_in(key: str, w: torch.Tensor) -> int:
    if "deconv" in key:  # ConvTranspose3d (in, out, k^3): fan_in over the input
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def _is_icnr(key: str) -> bool:
    return ".net.0." in key or "_upsample.conv." in key or "_tup.conv." in key


def _check(port: torch.nn.Module, jax_sd: dict) -> int:
    port_sd = port.state_dict()
    assert set(jax_sd) == set(port_sd)
    kernels = 0
    for key, want in jax_sd.items():
        got = port_sd[key].float()
        want = want.float()
        if key.endswith("temporal.weight"):  # the identity at the last tap
            assert torch.equal(got, want), key
        elif torch.all(want == 0):
            assert torch.all(got == 0), key
        elif torch.all(want == 1):
            assert torch.all(got == 1), key
        elif key.endswith("weight") and want.dim() >= 2:
            fan_in = _fan_in(key, got)
            bound = (math.sqrt(6.0 / fan_in) if _is_icnr(key)
                     else 2.0 * math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD)
            assert got.abs().max() <= bound * (1 + 1e-6), key
            assert want.abs().max() <= bound * (1 + 1e-6), key
            if got.numel() >= 2048:
                assert abs(got.std().item() / want.std().item() - 1.0) < 0.1, key
                kernels += 1
    return kernels


@pytest.fixture(autouse=True)
def _seed():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        yield


def test_unet3d_draws_the_jax_initialisers():
    x = jnp.zeros((1, 8, 8, 8, 1))
    t = jnp.zeros((1,))
    params = jax.jit(JUNet3D(**UNET3D, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), x, t, t, lowres_cond_img=x)
    assert _check(UNet3D(**UNET3D), state_dict_from_jax_params(jax.device_get(params))) >= 10


def test_unet2d_draws_the_jax_initialisers():
    x = jnp.zeros((1, 16, 16, 1))
    t = jnp.zeros((1,))
    params = jax.jit(JUNet2D(**UNET2D, use_flash=False).init)(
        jax.random.PRNGKey(0), x, t, t, lowres_cond_img=x)
    jax_sd = unet2d_state_dict_from_jax_params(jax.device_get(params))
    assert _check(UNet2D(**UNET2D), jax_sd) >= 10


def test_unet3d_video_draws_the_jax_initialisers():
    x = jnp.zeros((1, 4, 16, 16, 1))
    t = jnp.zeros((1,))
    params = jax.jit(JUnet3DVideo(**VIDEO, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), x, t, t, text_embeds=jnp.zeros((1, 8, 32)))
    jax_sd = video_state_dict_from_jax_params(jax.device_get(params))
    port = Unet3DVideo(**VIDEO)
    assert _check(port, jax_sd) >= 10
    port_sd = port.state_dict()
    for sd in (port_sd, jax_sd):
        pooled = torch.cat([v.flatten() for k, v in sd.items() if k.endswith(NORMAL_1)])
        assert pooled.numel() > 4096 and abs(pooled.std().item() - 1.0) < 0.1
    assert not any(port_sd[k].any() for k in port_sd if k.endswith("out_gate"))
    assert not port_sd["final_conv.weight"].any() and not port_sd["final_conv.bias"].any()
