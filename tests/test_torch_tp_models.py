"""Tensor parallelism for the 2D and the video U-Nets (``models/unet2d.py``,
``models/unet_video.py``: their convs and dense layers column-parallel) on
the CPU: gloo ranks of a ``("data", "model")`` mesh of (1, 2), one process
and one thread each, against one process and, for ``UNet2D``, against the
JAX mesh trainer on a (``data`` 1, ``model`` 2) mesh of the conftest's
virtual CPU devices, on the same weights, batches and draws (fp32).

  (a) the port's ``param_shardings`` names exactly the leaves the JAX rule
      shards on both families, but the video U-Net's learned tokens and
      null embeddings that ``replicated_params`` keeps whole
  (b) ``UNet2D`` under the trainer (the rule's 4096 elements): one clipped
      step of 2 microbatches and an EMA sampler call against one process
      and the JAX mesh trainer's step
  (c) every weight of two or more axes split (``min_size`` 1: the depthwise
      temporal PEG, the causal temporal conv, the frame-wise convs, the
      attention projections): a ``UNet2D`` forward with softmax attention,
      and a ``Unet3DVideo`` forward with text and one EDM loss step with
      its gradients, against one process

The ranks run the module-level ``_*_rank`` functions below; JAX is
imported only inside the fixtures and cases that hold the port against it.
"""

import functools

import numpy as np
import pytest
import torch

from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, gaussian_noise
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import NullUnet
from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo
from diffusioniqt_tpu_torch.parallel import sharding
from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer
from tests.test_torch_parallel import LR, _assert_params_close, _assert_tensors_close, _rand
from tests.test_torch_tp import MAX_GRAD_NORM, _launch, _Mesh

torch.set_num_threads(1)

EDGE2D, ROWS2D = 16, 4  # 4 slices of 16^2: 2 microbatches of 2
# softmax attention at the second level and the middle (4 heads of 16): its
# q / k / v projection is sharded at the rule's 4096 elements, as are the
# second level's 3x3 convs and the time MLPs
UNET2D = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, resnet_groups=4,
              lowres_cond=True, att_type="softmax", layer_attns=(False, True),
              attend_at_middle=True, attn_heads=4, attn_dim_head=16)
I2D = dict(image_sizes=(EDGE2D, EDGE2D), channels=1, timesteps=3, min_bound=-0.7,
           norm="z-score", dynamic_thresholding=False, batch_sample=False, spatial_dims=2)
TRAIN_KW = dict(gradient_accumulation_steps=2, ema_update_every=1, ema_update_after_step=0,
                lr=LR, max_grad_norm=MAX_GRAD_NORM)
# tests/test_torch_video.py's text U-Net at dim 16 (cross-attention, a
# transformer block, temporal stride 2)
VIDEO = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, init_dim=16,
             resnet_groups=4, attn_dim_head=8, attn_heads=2, layer_attns=(False, True),
             layer_cross_attns=(False, True), init_cross_embed=False, init_conv_kernel_size=3,
             cond_on_text=True, text_embed_dim=16, max_text_len=8, attn_pool_num_latents=4,
             temporal_strides=(1, 2))
FRAMES, EDGE_V = 8, 8


def _batch2d(seed):
    return (_rand((ROWS2D, EDGE2D, EDGE2D, 1), seed), _rand((ROWS2D, EDGE2D, EDGE2D, 1),
                                                            seed + 1))


def _trainer2d(state, mesh=None):
    unet = UNet2D(**UNET2D)
    unet.load_state_dict(state)
    return ImagenTrainer(None, Imagen([NullUnet(), unet], cond_drop_prob=0.0, **I2D),
                         mesh=mesh, **TRAIN_KW)


def _step2d(state, mesh, batch, draws):
    """One clipped step of the 2D trainer on ``draws``: the loss, the
    gathered gradient and parameters; then an EMA sampler call of the
    untrained weights (3 ancestral steps)."""
    tr = _trainer2d(state, mesh)
    lowres = torch.from_numpy(batch[1][:2])
    sample = tr.sample(batch_size=2, start_image_or_video=lowres, start_at_unet_number=2,
                       noise=gaussian_noise(torch.Generator().manual_seed(3)))
    loss = tr.train_step(unet_number=2, batch=batch, draws=draws)
    unet, dims = tr.imagen.unets[1], tr.shard_dims[1]
    grads = sharding.gather_state({k: p.grad.clone() for k, p in unet.named_parameters()},
                                  dims, mesh)
    params = sharding.gather_state({k: v.clone() for k, v in unet.state_dict().items()},
                                   dims, mesh)
    return dict(loss=loss, grads=grads, params=params, sample=sample, dims=sorted(dims))


def _video_edm(state):
    unet = Unet3DVideo(**VIDEO)
    unet.load_state_dict(state)
    return ElucidatedImagen([unet], image_sizes=(EDGE_V,), channels=1, sigma_data=1.0)


def _video_inputs():
    videos = torch.from_numpy(_rand((2, FRAMES, EDGE_V, EDGE_V, 1), 50))
    text = torch.from_numpy(_rand((2, 6, 16), 51))
    mask = torch.ones(2, 6, dtype=torch.bool)
    mask[1, 4:] = False
    return videos, text, mask


def _split_models(state2d, state_video, mesh):
    """(c): the U-Nets with every weight of two or more axes split (or whole
    without a mesh): the 2D forward, the video forward with text, the video
    EDM loss and its gathered gradients."""
    out = {}
    torch.manual_seed(0)
    unet2d = UNet2D(**UNET2D)
    unet2d.load_state_dict(state2d)
    edm = _video_edm(state_video)
    dims2d = dims_v = {}
    if mesh is not None:
        for module in (unet2d, edm.unets[0]):
            sharding.broadcast_params(module, mesh)
        dims2d, dims_v = (sharding.keep_shards_(m, mesh, sharding.param_shardings(m, mesh, 1))
                          for m in (unet2d, edm.unets[0]))
    x, lowres = (torch.from_numpy(_rand((2, EDGE2D, EDGE2D, 1), s)) for s in (40, 41))
    t = torch.tensor([0.3, -1.1])
    with torch.no_grad():
        out["forward2d"] = unet2d(x, t, t, lowres_cond_img=lowres)
    videos, text, mask = _video_inputs()
    unet_v = edm.unets[0]
    with torch.no_grad():
        out["forward_video"] = unet_v(videos, t, t, text_embeds=text, text_mask=mask)
    loss = edm.forward(videos, text_embeds=text, text_mask=mask,
               generator=torch.Generator().manual_seed(7))
    loss.backward()
    out["loss_video"] = float(loss)
    out["grads_video"] = sharding.gather_state(
        {k: p.grad.clone() for k, p in unet_v.named_parameters()}, dims_v, mesh)
    out["dims2d"], out["dims_video"] = dict(dims2d), dict(dims_v)
    out["local_video"] = {k: tuple(p.shape) for k, p in unet_v.named_parameters()}
    return out


def _models_rank(device, state2d, batch, draws, state_video):
    torch.set_num_threads(1)
    mesh = create_mesh(("data", "model"), (1, 2))
    return {"train2d": _step2d(state2d, mesh, batch, draws),
            "split": _split_models(state2d, state_video, mesh)}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_draws2d(key, imagen, rows):
    """What the JAX Gaussian forward draws from one microbatch key for
    ``rows`` slices without ``batch_sample``: a time per row, then the
    noise (gaussian.py:598-606, 511)."""
    import jax

    key, t_key = jax.random.split(key)
    times = imagen.noise_schedulers[1].sample_random_times(t_key, rows)
    _, noise_key = jax.random.split(key)
    noise = jax.random.normal(noise_key, (rows, EDGE2D, EDGE2D, 1))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            (("times", times), ("noise", noise))}


@functools.lru_cache(maxsize=None)
def _jax_2d():
    """The JAX mesh trainer on (``data`` 1, ``model`` 2) over ``UNET2D`` with
    filled parameters, prepared and not stepped; those parameters as a port
    state dict; its first step's draws (2 microbatches)."""
    import jax
    import jax.numpy as jnp

    from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
    from diffusioniqt_tpu.models.unet2d import UNet2D as JUNet2D
    from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
    from diffusioniqt_tpu.parallel.mesh import create_mesh as j_create_mesh
    from diffusioniqt_tpu.train.trainer import ImagenTrainer as JTrainer
    from diffusioniqt_tpu_torch.utils.convert import unet2d_state_dict_from_jax_params
    from tests.test_torch_video import fill_params

    jnet = JUNet2D(**UNET2D, use_flash=False, dtype=jnp.float32)
    x, t = jnp.zeros((2, EDGE2D, EDGE2D, 1)), jnp.zeros((2,))
    params0 = fill_params(jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, t,
                                                           lowres_cond_img=x)), 3)
    null = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: JNullUnet().init(jax.random.PRNGKey(0), x)))
    wrapper = JImagen([JNullUnet(), jnet], cond_drop_prob=0.0, **I2D)
    wrapper.init_params = lambda key, batch_size=1: [
        jax.tree_util.tree_map(jnp.asarray, p) for p in (null, params0)]
    jt = JTrainer(None, wrapper, mesh=j_create_mesh(("data", "model"), (1, 2),
                                                    jax.devices()[:2]),
                  **TRAIN_KW)
    jt.prepare()
    _, sub = jax.random.split(jt._key)  # what train_step's _next_key returns
    draws = [_jax_draws2d(k, wrapper, ROWS2D // 2) for k in jax.random.split(sub, 2)]
    return jt, unet2d_state_dict_from_jax_params(params0), draws


@pytest.fixture(scope="module")
def runs():
    """The ranks at (1, 2) and one process, on the same weights and draws."""
    _, state2d, draws = _jax_2d()
    torch.manual_seed(1)
    state_video = {k: v.clone() for k, v in Unet3DVideo(**VIDEO).state_dict().items()}
    # the zero-initialised final conv and gates would hide the split's paths
    gen = torch.Generator().manual_seed(2)
    for k, v in state_video.items():
        if v.is_floating_point() and not v.abs().max() > 0:
            state_video[k] = 0.1 * torch.randn(v.shape, generator=gen)
    batch = _batch2d(60)
    ranks = _launch(_models_rank, state2d, batch, draws, state_video, nprocs=2)
    one = {"train2d": _step2d(state2d, None, batch, draws),
           "split": _split_models(state2d, state_video, None)}
    return dict(ranks=ranks, one=one, batch=batch, state2d=state2d, state_video=state_video)


# ---------------------------------------------------------------------------
# (a) the rule
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_rule_leaves(family, min_size):
    """The port names of the leaves the JAX ``param_shardings`` shards at
    model 2 (marks carried by the family's converter)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from diffusioniqt_tpu.models.unet2d import UNet2D as JUNet2D
    from diffusioniqt_tpu.models.unet_video import Unet3DVideo as JVideo
    from diffusioniqt_tpu.parallel.mesh import create_mesh as j_create_mesh
    from diffusioniqt_tpu.parallel.sharding import param_shardings as j_param_shardings
    from diffusioniqt_tpu_torch.utils import convert

    if family == "2d":
        jnet = JUNet2D(**UNET2D, dtype=jnp.float32)
        x, t = jnp.zeros((2, EDGE2D, EDGE2D, 1)), jnp.zeros((2,))
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, t,
                                                  lowres_cond_img=x))
        to_port = convert.unet2d_state_dict_from_jax_params
    else:
        jnet = JVideo(**VIDEO, dtype=jnp.float32)
        x, t = jnp.zeros((2, FRAMES, EDGE_V, EDGE_V, 1)), jnp.zeros((2,))
        text, mask = jnp.zeros((2, 6, 16)), jnp.ones((2, 6), bool)
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, t,
                                                  text_embeds=text, text_mask=mask))
        to_port = convert.video_state_dict_from_jax_params
    jmesh = j_create_mesh(("data", "model"), (1, 2), jax.devices()[:2])
    specs = j_param_shardings(shapes, jmesh, min_size=min_size)
    marks = jax.tree_util.tree_map(
        lambda s, sh: np.full(s.shape, float(sh.spec == P(*([None] * (len(s.shape) - 1)),
                                                           "model")), np.float32),
        shapes, specs)
    return frozenset(k for k, v in to_port(marks).items() if bool(v.all()))


@pytest.mark.parametrize("min_size", [4096, 64])
@pytest.mark.parametrize("family", ["2d", "video"])
def test_param_shardings_name_the_jax_rule_leaves(family, min_size):
    """(a) On both families, ``param_shardings`` at model 2 shards exactly
    the leaves that the JAX rule shards, along the JAX kernel's last axis
    (torch axis 0), without raising; the leaves the JAX rule shards that
    the port keeps whole are the video U-Net's ``replicated_params``: the
    Perceiver's ``pos_emb`` and ``latents``, the null text embeddings and
    the attention's ``null_kv``, as far as they reach ``min_size``."""
    module = UNet2D(**UNET2D) if family == "2d" else Unet3DVideo(**VIDEO)
    want = _jax_rule_leaves(family, min_size)
    got = {k: spec[1] for k, spec in
           sharding.param_shardings(module, _Mesh(2), min_size=min_size).items()
           if hasattr(spec[1], "dim")}
    assert set(got) - want == set()
    assert {placement.dim for placement in got.values()} == {0}
    kept = want - set(got)
    assert all(k.rsplit(".", 1)[-1] in ("pos_emb", "latents", "null_text_embed",
                                        "null_text_hidden", "null_kv") for k in kept), kept
    if family == "2d":
        assert kept == set() and "mid_attn.to_qkv.weight" in got
    else:
        assert "attn_pool.pos_emb" in kept and any(".spatial.weight" in k for k in got)
        if min_size == 64:  # the causal temporal convs and the depthwise PEGs (3 x 16 x 2)
            assert any(".temporal.weight" in k for k in got)
            assert any(k.endswith("_peg.weight") for k in got)


def test_layer_without_a_column_split_raises():
    """A module holding a weight of two axes that is neither a
    column-parallel layer's nor named in ``replicated_params`` raises under
    a model axis, in the rule and in the trainer; it is replicated without
    one."""
    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.table = torch.nn.Parameter(torch.zeros(64, 64))

    with pytest.raises(NotImplementedError, match="no column split"):
        sharding.param_shardings(Plain(), _Mesh(2))
    assert sharding.param_shardings(Plain(), _Mesh(1)) == {"table": sharding.param_shardings(
        Plain(), _Mesh(1))["table"]}


# ---------------------------------------------------------------------------
# (b) UNet2D under the trainer
# ---------------------------------------------------------------------------

def test_unet2d_tp_step_and_sample_equal_one_process(runs):
    """(b) One clipped step at (1, 2) ranks: the loss within 1e-5 relative,
    the gathered gradient within 1e-4 of each tensor's largest entry, the
    parameters by ``_assert_params_close``; an EMA sampler call of 3 steps
    within 1e-5 of the sample's largest entry; the ranks hold the column
    shards of the rule's 6 weights (the 32-channel convs, two time MLPs,
    the middle attention's q / k / v projection)."""
    one = runs["one"]["train2d"]
    for rank in runs["ranks"]:
        got = rank["train2d"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        _assert_tensors_close(got["grads"], one["grads"], 1e-4, "gradient")
        _assert_params_close(got["params"], one["params"], got["grads"])
        torch.testing.assert_close(got["sample"], one["sample"], rtol=0,
                                   atol=1e-5 * float(one["sample"].abs().max()))
        assert got["dims"] == ["mid_attn.to_qkv.weight", "mid_block.block1.project.weight",
                               "mid_block.block2.project.weight", "mid_block.time_mlp.1.weight",
                               "to_time_cond.0.weight", "up0_init.block1.project.weight"]


def test_unet2d_tp_step_equals_jax_mesh_trainer(runs):
    """(b) The first clipped step at (1, 2) ranks against the JAX trainer
    on a (``data`` 1, ``model`` 2) mesh, on the same weights, batch and
    draws: the loss within 1e-5 relative, the gradient (Adam's first
    moment over 1 - beta1) within 1e-4 of each tensor's largest entry, the
    parameters by ``_assert_params_close``."""
    import jax

    from diffusioniqt_tpu_torch.utils.convert import (
        _find_adam_state,
        unet2d_state_dict_from_jax_params,
    )

    jt = _jax_2d()[0]
    jloss = jt.train_step(unet_number=2, batch=runs["batch"])
    adam = _find_adam_state(jax.device_get(jt.opt_states[1]))
    mu = adam.mu if "params" in adam.mu else {"params": adam.mu}
    want_grads = {k: v / (1 - 0.9) for k, v in unet2d_state_dict_from_jax_params(mu).items()}
    want_params = unet2d_state_dict_from_jax_params(jax.device_get(jt.params[1]))
    for rank in runs["ranks"]:
        got = rank["train2d"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        _assert_tensors_close(got["grads"], want_grads, 1e-4, "gradient")
        _assert_params_close(got["params"], want_params, got["grads"])


# ---------------------------------------------------------------------------
# (c) every weight split
# ---------------------------------------------------------------------------

def _assert_grads_close(got, want):
    """Each gradient within 1e-4 of its largest entry, where that entry is
    above 1e-6 of the largest over all tensors; below, both runs' entries
    under that floor: the global-context gates' ``to_k`` bias is a constant
    added before a softmax over every position, whose exact gradient is
    zero, so both runs read rounding noise there (4e-10 of the largest)."""
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        if float(w.abs().max()) < 1e-6 * top:
            assert float(got[k].abs().max()) < 1e-6 * top, k
        else:
            _assert_tensors_close({k: got[k]}, {k: w}, 1e-4, "gradient")


def test_split_models_equal_one_process(runs):
    """(c) Every weight of two or more axes column-sharded over 2 ranks: the
    2D forward and the video forward within 1e-4 of the output's largest
    entry, the video EDM loss within 1e-5 relative and its gradients within
    1e-4 of each tensor's largest entry; the depthwise temporal PEG and the
    causal temporal conv hold half their output channels."""
    one = runs["one"]["split"]
    for rank in runs["ranks"]:
        got = rank["split"]
        for key in ("forward2d", "forward_video"):
            torch.testing.assert_close(got[key], one[key], rtol=0,
                                       atol=1e-4 * float(one[key].abs().max()))
        np.testing.assert_allclose(got["loss_video"], one["loss_video"], rtol=1e-5)
        _assert_grads_close(got["grads_video"], one["grads_video"])
        dims = got["dims_video"]
        for leaf in ("init_temporal_peg.weight", "down0_init.block1.project.temporal.weight"):
            assert dims[leaf] == 0
            whole = runs["state_video"][leaf].shape[0]
            assert got["local_video"][leaf][0] * 2 == whole, leaf
        assert len(got["dims2d"]) > 20
