"""The port's UNet3D options (memory_efficient, the cross-embed stem, the
deconv upsample, other init / final conv sizes, merged_boundary, self- and
image conditioning, the presets) against the JAX package's flax UNet3D at
fp32 on the CPU, with weights carried across by
``diffusioniqt_tpu_torch.utils.convert.state_dict_from_jax_params``.

The JAX parameters come from the flax shapes (``jax.eval_shape``, no
compile of ``init``) with a seeded numpy fan-in init; the JAX forward runs
eagerly. Tolerance: the largest difference within 1e-4 of the largest
output entry (fp32 sums in other orders through some 20 convs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.models import unet3d as junet
from diffusioniqt_tpu.utils import torch_convert as tc
from diffusioniqt_tpu_torch.models import unet3d as tunet
from diffusioniqt_tpu_torch.models.blocks import CrossEmbedLayer, DeconvUpsample
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

torch.set_num_threads(1)

REL_TOL = 1e-4
SMALL = dict(dim=8, init_dim=8, num_resnet_blocks=1, dim_mults=(1, 2), channels=1,
             resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
             attend_at_enc=False, init_cross_embed=False, deep_feature=False,
             att_type="linear")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _init_params(flax, args, kwargs, seed):
    """flax variables of ``flax`` at the shapes of ``args``: kernels
    N(0, 1/fan_in), biases and shifts N(0, 0.01), scales 1 + N(0, 0.01),
    the rest N(0, 1)."""
    shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        if name in ("bias", "norm_bias"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("norm_scale", "scale", "g"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(b, edge, seed, group_time=True):
    x = _rand((b, edge, edge, edge, 1), seed)
    lr = _rand((b, edge, edge, edge, 1), seed + 1)
    if group_time:  # one time per group of 27, as batch_sample draws it
        t = np.repeat(np.random.default_rng(seed + 2).uniform(size=-(-b // 27)), 27)[:b]
    else:
        t = np.random.default_rng(seed + 2).uniform(size=b)
    return x, lr, t.astype(np.float32)


def _both(kw, b, edge, seed=0, group_time=True, extra=None, jax_cls=None, port_cls=None):
    """(port output, JAX output, port model) for one configuration."""
    x, lr, t = _inputs(b, edge, seed, group_time)
    extra = extra or {}
    flax = (jax_cls or junet.UNet3D)(**kw, dtype=jnp.float32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(t))
    jkw = dict(lowres_cond_img=jnp.asarray(lr), **{k: jnp.asarray(v) for k, v in extra.items()})
    params = _init_params(flax, jargs, jkw, seed)
    want = np.asarray(flax.apply(params, *jargs, **jkw))
    port = (port_cls or tunet.UNet3D)(**kw).eval()
    port.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t),
                   lowres_cond_img=torch.from_numpy(lr),
                   **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
    return got, want, port


def _close(got, want, tol=REL_TOL):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name,kw,b", [
    # the flagship layout: 27 sub-volumes of 8^3, levels at 4^3 and 2^3
    ("memory_efficient, boundary", dict(memory_efficient=True, boundary=True,
                                        batch_sample=True, img_size=24), 27),
    ("memory_efficient, SAME convs", dict(memory_efficient=True, boundary=False,
                                          batch_sample=False, deep_feature=True,
                                          img_size=8), 2),
    ("cross-embed stem", dict(init_cross_embed=True, init_cross_embed_kernel_sizes=(3, 7, 5),
                              boundary=False, batch_sample=False, img_size=8), 2),
    ("deconv upsample", dict(pixel_shuffle_upsample=False, boundary=True, batch_sample=True,
                             img_size=24), 27),
    ("init conv 7, final conv 3", dict(init_conv_kernel_size=7, final_conv_kernel_size=3,
                                       boundary=False, batch_sample=False, img_size=8), 2),
])
def test_option_matches_jax(name, kw, b):
    got, want, _ = _both({**SMALL, **kw}, b, 8)
    _close(got, want)


def test_self_cond_and_cond_images_match_jax():
    kw = dict(SMALL, self_cond=True, cond_images_channels=2, boundary=False,
              batch_sample=False, img_size=8)
    extra = {"self_cond": _rand((2, 8, 8, 8, 1), 40), "cond_images": _rand((2, 4, 4, 4, 2), 41)}
    got, want, _ = _both(kw, 2, 8, extra=extra)
    _close(got, want)


@pytest.mark.parametrize("more", [
    {},
    # the convs that are not local to a sub-volume run on the merged volume
    dict(pixel_shuffle_upsample=False, final_conv_kernel_size=3, init_conv_kernel_size=5),
])
def test_merged_boundary_matches_jax_merged_and_port_split(more):
    """Port merged against JAX merged with a time per sub-volume (merged
    mode takes each group's first); against the port's split layout with
    one time per group and the 3^3 convs (the two layouts are one
    function there)."""
    kw = dict(SMALL, boundary=True, batch_sample=True, merged_boundary=True,
              deep_feature=True, img_size=24, **more)
    got, want, merged = _both(kw, 54, 8, group_time=False)
    _close(got, want)
    if more:
        return
    split = tunet.UNet3D(**{**kw, "merged_boundary": False}).eval()
    split.load_state_dict(merged.state_dict())
    x, lr, t = (torch.from_numpy(a) for a in _inputs(54, 8, 0, group_time=True))
    with torch.no_grad():
        a = merged(x, t, t, lowres_cond_img=lr)
        b = split(x, t, t, lowres_cond_img=lr)
    assert torch.equal(a, b)


def test_srunet256_preset_matches_jax():
    """SRUnet256 narrowed in width and depth only (dim 8, one ResnetBlock a
    level): memory_efficient over four levels, the cross-embed stem (3, 7,
    15), ViT at the middle, deep_feature, batch_sample over 27 sub-volumes
    of 16^3 (levels 8^3 ... 1^3)."""
    kw = dict(channels=1, lowres_cond=True, dim=8, init_dim=8, num_resnet_blocks=(1, 1, 1, 1),
              attn_dim_head=8, attend_at_middle_heads=2, img_size=48)
    got, want, port = _both(kw, 27, 16, jax_cls=junet.SRUnet256, port_cls=tunet.SRUnet256)
    _close(got, want)
    assert isinstance(port.init_conv, CrossEmbedLayer)
    assert [c.kernel_size[0] for c in port.init_conv.convs] == [3, 7, 15]
    assert [c.out_channels for c in port.init_conv.convs] == [4, 2, 2]
    # the preset's own stem width: 32 channels split 16 / 8 / 8
    assert [c.out_channels for c in CrossEmbedLayer(2, 32).convs] == [16, 8, 8]


def test_presets_take_the_jax_defaults():
    for name in ("SRUnet256", "BaseUnet64", "SRUnet1024"):
        jmod = getattr(junet, name)(dim=8, num_resnet_blocks=1)
        port = getattr(tunet, name)(dim=8, num_resnet_blocks=1)
        assert port.channels == jmod.channels and port.lowres_cond == jmod.lowres_cond
        assert port.factor == 1 and port.batch_sample == jmod.batch_sample
        assert port.mid_block is not None and port.mid_attn is not None
        assert isinstance(port.init_conv, CrossEmbedLayer) == jmod.init_cross_embed
        assert len(port.downs) == len(jmod.dim_mults)
        pre = port.downs[0][0]
        assert isinstance(pre, torch.nn.Identity) != jmod.memory_efficient


def test_round_trip_with_new_parameter_groups():
    """A port state_dict with a cross-embed stem, pre-downsamples, 1x1 post
    convs and deconv upsamples -> the JAX converter -> back, key for key;
    and the deconv module's weight loads into the reference layout."""
    port = tunet.UNet3D(**{**SMALL, "init_cross_embed": True, "memory_efficient": True,
                           "pixel_shuffle_upsample": False, "boundary": False,
                           "batch_sample": False, "img_size": 8})
    sd = port.state_dict()
    assert "init_conv.convs.2.weight" in sd and "downs.1.0.1.weight" in sd
    assert "ups.1.0.deconv.0.weight" in sd and "downs.1.4.weight" in sd
    back = state_dict_from_jax_params(tc.convert_iqt_unet_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert isinstance(port.ups[0][0], DeconvUpsample)
    assert tuple(sd["ups.0.0.deconv.0.weight"].shape) == (16, 8, 3, 3, 3)


def test_option_errors():
    with pytest.raises(ValueError, match="remat_policy"):
        tunet.UNet3D(**SMALL, img_size=24, remat=True, remat_policy="nope")
    with pytest.raises(ValueError, match="init conv"):
        tunet.UNet3D(**{**SMALL, "init_cross_embed": True}, boundary=True, img_size=24)
    with pytest.raises(ValueError, match="init_conv_kernel_size"):
        tunet.UNet3D(**SMALL, boundary=True, init_conv_kernel_size=5, img_size=24)
