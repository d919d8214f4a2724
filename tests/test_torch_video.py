"""The port's text-conditioned video U-Net (``models/unet_video.py``), the
text embeddings (``utils/t5.py``), the global-context gate and the
converter ``utils/convert.py::video_state_dict_from_jax_params`` against
the JAX package at fp32 on the CPU.

Each JAX module's parameters come from ``jax.eval_shape`` of its ``init``
(no init compile) filled with numpy draws: kernels N(0, 1 / fan_in), norm
scales 1 + N(0, 0.1), biases N(0, 0.1), the rest (``null_kv``, latents,
positions, the ``init_zero`` gates) non-zero draws, so that no gate or
zero-initialised conv hides a path. The JAX modules run eagerly; the port
modules take the same parameters through the converter. Tolerance: 1e-4 of
the largest JAX output entry. The EDM wrapper's video paths are in
``tests/test_torch_video_edm.py``."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.models import blocks as jb
from diffusioniqt_tpu.models import unet_video as jv
from diffusioniqt_tpu.utils import t5 as jt5
from diffusioniqt_tpu_torch.models import blocks as tb
from diffusioniqt_tpu_torch.models import unet_video as tv
from diffusioniqt_tpu_torch.utils import convert as tc
from diffusioniqt_tpu_torch.utils import t5 as tt5

torch.set_num_threads(1)

REL = 1e-4
# tests/test_unet_video.py::video_unet: text, cross-attention and a
# transformer block at level 1, temporal stride 2
VIDEO_UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, init_dim=8,
                  resnet_groups=4, attn_dim_head=4, attn_heads=2, layer_attns=(False, True),
                  layer_cross_attns=(False, True), init_cross_embed=False,
                  init_conv_kernel_size=3, cond_on_text=True, text_embed_dim=16,
                  max_text_len=8, attn_pool_num_latents=4, memory_efficient=False,
                  temporal_strides=(1, 2))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def fill_params(shapes, seed=0):
    """numpy values for a flax parameter tree of ``jax.eval_shape`` leaves."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            draw = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("g", "scale"):
            draw = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            draw = 0.1 * rng.standard_normal(shape)
        elif name == "out_gate_zero":
            draw = 0.5 + 0.1 * rng.standard_normal(shape)
        else:
            draw = rng.standard_normal(shape)
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def module_pair(jmod, port, convert, *args, **kwargs):
    """The flax module's filled parameters (``init`` on ``args``) and the
    port module with them loaded: ``convert(tree, path, key, out)`` is one
    of the converter's module functions or an inline mapping."""
    shapes = jax.eval_shape(functools.partial(jmod.init, **kwargs), jax.random.PRNGKey(0),
                            *args)
    params = fill_params(shapes)
    tree = tc._Tree({"m": params["params"]})
    out = {}
    convert(tree, "m", "m", out)
    assert not set(tree.flat) - tree.read, "parameters left unread"
    port.load_state_dict({k[2:]: v for k, v in out.items()})
    return params, port.eval()


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# ------------------------------------------------------------- text embeddings

def test_hash_text_encode_equals_jax():
    texts = ["a brain mri", "t1 weighted axial slice of a healthy adult", ""]
    want_emb, want_mask = jt5.hash_text_encode(texts, dim=24, max_length=5,
                                               return_attn_mask=True)
    emb, mask = tt5.hash_text_encode(texts, dim=24, max_length=5, return_attn_mask=True,
                                     device="cpu")
    assert emb.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(emb.numpy(), want_emb)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(tt5.hash_text_encode(texts, dim=24, max_length=5).numpy(),
                                  jt5.hash_text_encode(texts, dim=24, max_length=5))
    assert tt5.get_encoded_dim("google/t5-v1_1-xl") == jt5.get_encoded_dim("google/t5-v1_1-xl")
    assert tt5.get_encoded_dim("unknown") == 768 and tt5.T5_CONFIGS == jt5.T5_CONFIGS


def test_t5_encode_text_random_init_equals_jax():
    """The random-init tier runs the HF ``T5EncoderModel`` in both
    packages (the JAX module's is PyTorch too), from the same seed."""
    pytest.importorskip("transformers", reason="t5_encode_text needs transformers")
    texts = ["a brain mri", "a sagittal view of the left hemisphere"]
    with torch.random.fork_rng(devices=[]):
        want, want_mask = jt5.t5_encode_text(texts, name="t5-small", return_attn_mask=True,
                                             allow_random_init=True)
        got, mask = tt5.t5_encode_text(texts, name="t5-small", return_attn_mask=True,
                                       allow_random_init=True)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.all(got.numpy()[~want_mask] == 0)


def test_t5_encode_text_names_transformers_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setattr(tt5, "_CACHE", {})
    with pytest.raises(ImportError, match="transformers"):
        tt5.t5_encode_text(["a brain mri"], allow_random_init=True)


# ------------------------------------------------------------------- modules

def test_global_context_matches_jax():
    x = _rand((2, 3, 5, 4, 6), 1)

    def convert(p, path, key, out):
        for i, name in enumerate(("to_k", "net.0", "net.2")):
            p.conv(f"{path}/Conv_{i}", f"{key}.{name}", out)

    jmod = jb.GlobalContext(10, dtype=jnp.float32)
    params, port = module_pair(jmod, tb.GlobalContext(6, 10), convert, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("stable", [False, True])
def test_token_layer_norm_matches_jax(stable):
    x = _rand((2, 7, 12), 2) + 0.5 * stable

    def convert(p, path, key, out):
        p.param(f"{path}/g", f"{key}.g", out)

    jmod = jv.TokenLayerNorm(stable=stable, dtype=jnp.float32)
    params, port = module_pair(jmod, tv.TokenLayerNorm(12, stable=stable), convert,
                               jnp.asarray(x))
    _close(port(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("ignore_time", [False, True])
def test_pseudo_conv3d_matches_jax(ignore_time):
    x = _rand((2, 5, 6, 7, 3), 3)

    def convert(p, path, key, out):
        p.conv(f"{path}/spatial", f"{key}.spatial", out)
        p.conv(f"{path}/temporal", f"{key}.temporal", out)

    jmod = jv.PseudoConv3d(4, 3, dtype=jnp.float32)
    params, port = module_pair(jmod, tv.PseudoConv3d(3, 4, 3), convert, jnp.asarray(x))
    _close(port(torch.from_numpy(x), ignore_time=ignore_time),
           jmod.apply(params, jnp.asarray(x), ignore_time=ignore_time))
    # a fresh temporal conv is the identity, as the JAX init's
    fresh = tv.PseudoConv3d(3, 4, 3)
    with torch.no_grad():
        y = fresh.spatial(torch.from_numpy(x))
        torch.testing.assert_close(fresh.temporal(y), y, rtol=0, atol=0)


def test_spatial_conv2d_matches_jax():
    x = _rand((2, 3, 9, 8, 5), 4)
    for k, pad in ((7, 3), (3, 1), (1, 0)):
        jmod = jv.spatial_conv2d(6, k, padding=pad, dtype=jnp.float32)
        params, port = module_pair(
            jmod, tv.SpatialConv(5, 6, k, pad),
            lambda p, path, key, out: p.conv(path, key, out), jnp.asarray(x))
        _close(port(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dynamic_position_bias_matches_jax(depth):
    n = 6

    def convert(p, path, key, out):
        for i in range(depth + 1):
            p.dense(f"{path}/Dense_{i}", f"{key}.mlp.{3 * i}", out)
            if i < depth:
                p.param(f"{path}/TokenLayerNorm_{i}/g", f"{key}.mlp.{3 * i + 1}.g", out)

    jmod = jv.DynamicPositionBias(dim=8, heads=3, depth=depth, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jmod.init(k, n), jax.random.PRNGKey(0))
    params = fill_params(shapes, depth)
    tree, out = tc._Tree({"m": params["params"]}), {}
    convert(tree, "m", "m", out)
    port = tv.DynamicPositionBias(8, 3, depth)
    port.load_state_dict({k[2:]: v for k, v in out.items()})
    got = port(n, torch.device("cpu"), torch.float32)
    assert got.shape == (3, n, n)
    _close(got, jmod.apply(params, n))


@pytest.mark.parametrize("causal,context,cosine,rel,init_zero,mask", [
    (False, False, False, False, False, False),
    (True, False, False, True, True, False),
    (False, True, False, False, False, True),
    (True, True, True, True, False, True),
    (False, True, True, True, True, False),
])
def test_video_attention_matches_jax(causal, context, cosine, rel, init_zero, mask):
    """Null key / value, the context's keys in front, cosine similarity,
    the relative bias with its null column, the causal and key masks."""
    x = _rand((2, 5, 12), 5)
    kw = {}
    if context:
        kw["context"] = _rand((2, 3, 10), 6)
    if mask:
        m = np.ones((2, 5), bool)
        m[1, 3:] = False
        kw["mask"] = m
    jmod = jv.VideoAttention(dim=12, dim_head=4, heads=3, causal=causal,
                             context_dim=10 if context else None, cosine_sim_attn=cosine,
                             rel_pos_bias=rel, init_zero=init_zero, dtype=jnp.float32)
    port = tv.VideoAttention(12, 4, 3, causal=causal, context_dim=10 if context else None,
                             cosine_sim_attn=cosine, rel_pos_bias=rel, init_zero=init_zero)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params, port = module_pair(jmod, port, tc._v_attention, jnp.asarray(x), **jkw)
    got = port(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got, jmod.apply(params, jnp.asarray(x), **jkw))


@pytest.mark.parametrize("causal", [True, False])
def test_temporal_attention_and_peg_match_jax(causal):
    x = _rand((2, 4, 3, 5, 8), 7)
    jmod = jv.TemporalAttention(dim=8, dim_head=4, heads=2, causal=causal, dtype=jnp.float32)
    params, port = module_pair(
        jmod, tv.TemporalAttention(8, 4, 2, causal=causal),
        lambda p, path, key, out: tc._v_attention(p, f"{path}/VideoAttention_0",
                                                  f"{key}.attn", out), jnp.asarray(x))
    _close(port(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))

    jpeg = jv.TemporalPEG(8, causal=causal, dtype=jnp.float32)
    params, peg = module_pair(jpeg, tv.TemporalPEG(8, causal=causal),
                              lambda p, path, key, out: p.conv(f"{path}/Conv_0", key, out),
                              jnp.asarray(x))
    _close(peg(torch.from_numpy(x)), jpeg.apply(params, jnp.asarray(x)))


def test_spatial_and_temporal_shuffles_match_jax():
    """Each (un)shuffle's channel order, with random kernels, and ICNR."""
    x = _rand((2, 4, 6, 8, 3), 8)

    def conv0(p, path, key, out):
        p.conv(f"{path}/Conv_0", f"{key}.conv", out)

    cases = [(jv.SpatialDownsample(5, dtype=jnp.float32), tv.SpatialDownsample(3, 5)),
             (jv.SpatialPixelShuffleUpsample(5, dtype=jnp.float32),
              tv.SpatialPixelShuffleUpsample(3, 5)),
             (jv.TemporalDownsample(5, stride=2, dtype=jnp.float32),
              tv.TemporalDownsample(3, 5, 2)),
             (jv.TemporalPixelShuffleUpsample(5, stride=2, dtype=jnp.float32),
              tv.TemporalPixelShuffleUpsample(3, 5, 2))]
    for jmod, port in cases:
        params, port = module_pair(jmod, port, conv0, jnp.asarray(x))
        _close(port(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))
    for r, up in ((4, tv.SpatialPixelShuffleUpsample(5, 3)),
                  (2, tv.TemporalPixelShuffleUpsample(5, 3, 2))):
        w = up.conv.weight.detach()
        assert torch.equal(w, w[::r].repeat_interleave(r, dim=0)) and not up.conv.bias.any()


@pytest.mark.parametrize("scale_shift", [False, True])
def test_video_block_matches_jax(scale_shift):
    x = _rand((2, 4, 5, 6, 8), 9, 2.0)
    ss = None
    if scale_shift:
        ss = (_rand((2, 1, 1, 1, 8), 10, 0.3), _rand((2, 1, 1, 1, 8), 11, 0.3))

    def convert(p, path, key, out):
        p.norm(f"{path}/GroupNorm_0", f"{key}.groupnorm", out)
        p.conv(f"{path}/PseudoConv3d_0/spatial", f"{key}.project.spatial", out)
        p.conv(f"{path}/PseudoConv3d_0/temporal", f"{key}.project.temporal", out)

    jmod = jv.VideoBlock(6, groups=2, dtype=jnp.float32)
    params, port = module_pair(jmod, tv.VideoBlock(8, 6, groups=2), convert, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x),
                      scale_shift=None if ss is None else tuple(map(jnp.asarray, ss)))
    got = port(torch.from_numpy(x),
               scale_shift=None if ss is None else tuple(map(torch.from_numpy, ss)))
    _close(got, want)


@pytest.mark.parametrize("linear,cosine", [(False, False), (True, False), (False, True)])
def test_video_cross_attention_matches_jax(linear, cosine):
    x, ctx = _rand((2, 9, 8), 12), _rand((2, 4, 6), 13)
    jmod = jv.VideoCrossAttention(dim=8, context_dim=6, dim_head=4, heads=2, linear=linear,
                                  cosine_sim_attn=cosine, dtype=jnp.float32)
    port = tv.VideoCrossAttention(8, 6, 4, 2, linear=linear, cosine_sim_attn=cosine)
    params, port = module_pair(jmod, port, tc._v_cross_attention, jnp.asarray(x),
                               jnp.asarray(ctx))
    _close(port(torch.from_numpy(x), torch.from_numpy(ctx)),
           jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("dim_in,cond,gca,linear", [
    (8, True, False, False), (6, False, True, False), (8, True, True, True)])
def test_video_resnet_block_matches_jax(dim_in, cond, gca, linear):
    x, t = _rand((2, 4, 4, 6, dim_in), 14), _rand((2, 12), 15)
    c = _rand((2, 5, 10), 16) if cond else None
    jmod = jv.VideoResnetBlock(8, cond_dim=10 if cond else None, time_cond_dim=12, groups=2,
                               linear_attn=linear, use_gca=gca, attn_dim_head=4, attn_heads=2,
                               dtype=jnp.float32)
    port = tv.VideoResnetBlock(dim_in, 8, cond_dim=10 if cond else None, time_cond_dim=12,
                               groups=2, linear_attn=linear, use_gca=gca, attn_dim_head=4,
                               attn_heads=2)
    jc = None if c is None else jnp.asarray(c)
    params, port = module_pair(jmod, port, tc._v_resnet, jnp.asarray(x), jnp.asarray(t), jc)
    for ignore_time in (False, True):
        want = jmod.apply(params, jnp.asarray(x), jnp.asarray(t), jc, ignore_time=ignore_time)
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   None if c is None else torch.from_numpy(c), ignore_time=ignore_time)
        _close(got, want)


@pytest.mark.parametrize("linear,depth", [(False, 2), (True, 1)])
def test_video_transformer_block_matches_jax(linear, depth):
    x, ctx = _rand((2, 3, 4, 4, 8), 17), _rand((2, 5, 10), 18)
    jmod = jv.VideoTransformerBlock(dim=8, depth=depth, heads=2, dim_head=4, ff_mult=2.0,
                                    context_dim=None if linear else 10, linear=linear,
                                    dtype=jnp.float32)
    port = tv.VideoTransformerBlock(8, depth, 2, 4, 2.0, context_dim=None if linear else 10,
                                    linear=linear)
    jctx = None if linear else jnp.asarray(ctx)
    params, port = module_pair(jmod, port, tc._v_transformer, jnp.asarray(x), jctx)
    _close(port(torch.from_numpy(x), None if linear else torch.from_numpy(ctx)),
           jmod.apply(params, jnp.asarray(x), jctx))


@pytest.mark.parametrize("mean_pooled,mask", [(4, False), (0, True)])
def test_perceiver_resampler_matches_jax(mean_pooled, mask):
    x = _rand((2, 7, 8), 19)
    m = None
    if mask:
        m = np.ones((2, 7), bool)
        m[0, 4:] = False
    jmod = jv.PerceiverResampler(dim=8, depth=2, dim_head=4, heads=2, num_latents=3,
                                 num_latents_mean_pooled=mean_pooled, max_seq_len=16,
                                 dtype=jnp.float32)
    port = tv.PerceiverResampler(8, 2, 4, 2, num_latents=3,
                                 num_latents_mean_pooled=mean_pooled, max_seq_len=16)
    jm = None if m is None else jnp.asarray(m)
    params, port = module_pair(jmod, port, tc._v_perceiver, jnp.asarray(x), jm)
    got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert got.shape == (2, 3 + mean_pooled, 8)
    _close(got, jmod.apply(params, jnp.asarray(x), jm))


# -------------------------------------------------------------- whole U-Net

@pytest.fixture(scope="module")
def text_unet():
    """``VIDEO_UNET`` (text, cross-attention, a transformer block,
    temporal stride 2): the JAX module's filled parameters, the port
    module with them, and the inputs."""
    jmod = jv.Unet3DVideo(**VIDEO_UNET, dtype=jnp.float32)
    x = _rand((2, 4, 16, 16, 1), 20)
    t = np.asarray([0.3, -1.1], np.float32)
    text = _rand((2, 6, 16), 21)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    shapes = jax.eval_shape(functools.partial(jmod.init, text_embeds=text, text_mask=mask),
                            jax.random.PRNGKey(0), x, t, t)
    params = fill_params(shapes, 22)
    port = tv.Unet3DVideo(**VIDEO_UNET)
    port.load_state_dict(tc.video_state_dict_from_jax_params(params))
    return jmod, params, port.eval(), dict(x=x, t=t, text=text, mask=mask)


@pytest.mark.parametrize("cond_drop_prob", [0.0, 1.0])
def test_unet3d_video_matches_jax(text_unet, cond_drop_prob):
    """The text-conditioned forward, and with ``cond_drop_prob=1`` the
    null text (the guidance's second evaluation)."""
    jmod, params, port, inp = text_unet
    want = jmod.apply(params, inp["x"], inp["t"], inp["t"], text_embeds=inp["text"],
                      text_mask=inp["mask"], cond_drop_prob=cond_drop_prob)
    with torch.no_grad():
        got = port(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                   torch.from_numpy(inp["t"]), text_embeds=torch.from_numpy(inp["text"]),
                   text_mask=torch.from_numpy(inp["mask"]), cond_drop_prob=cond_drop_prob)
    assert got.dtype == torch.float32
    _close(got, want)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_cond_drop_prob_draws_the_keep_mask_from_a_generator(text_unet):
    """Between 0 and 1 the keep mask comes from the caller's generator:
    kept rows equal the text forward's, dropped rows the null text's."""
    _, _, port, inp = text_unet
    args = [torch.from_numpy(inp[k]) for k in ("x", "t", "t")]
    kw = dict(text_embeds=torch.from_numpy(inp["text"]), text_mask=torch.from_numpy(inp["mask"]))
    with torch.no_grad():
        full, null = (port(*args, **kw, cond_drop_prob=p) for p in (0.0, 1.0))
        with pytest.raises(ValueError, match="Generator"):
            port(*args, **kw, cond_drop_prob=0.5)
        for seed in range(4):
            keep = torch.rand(2, generator=torch.Generator().manual_seed(seed)) < 0.5
            got = port(*args, **kw, cond_drop_prob=0.5,
                       generator=torch.Generator().manual_seed(seed))
            torch.testing.assert_close(got, torch.where(keep[:, None, None, None, None],
                                                        full, null), rtol=0, atol=0)


def test_video_converter_reads_every_parameter(text_unet):
    """A JAX parameter the converter does not read, or one it expects and
    does not find, raises."""
    _, params, port, _ = text_unet
    extra = jax.tree_util.tree_map(np.asarray, params)
    extra["params"]["down1_init"]["Dense_7"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unread.*down1_init/Dense_7"):
        tc.video_state_dict_from_jax_params(extra)
    missing = jax.tree_util.tree_map(np.asarray, params)
    del missing["params"]["mid_attn"]["null_kv"]
    with pytest.raises(KeyError, match="null_kv"):
        tc.video_state_dict_from_jax_params(missing)
    assert set(tc.video_state_dict_from_jax_params(params)) == set(port.state_dict())


def test_cast_model_parameters_and_divisor():
    port = tv.Unet3DVideo(**VIDEO_UNET)
    for channels_out in (None, 1):
        assert port.cast_model_parameters(lowres_cond=False, channels=1,
                                          channels_out=channels_out) is port
    cast = port.cast_model_parameters(lowres_cond=True, channels=1, channels_out=1)
    assert cast.lowres_cond and cast is not port and cast.total_temporal_divisor == 2
    with pytest.raises(ValueError, match="divisible"):
        port(torch.zeros(1, 3, 16, 16, 1), torch.zeros(1), torch.zeros(1))
