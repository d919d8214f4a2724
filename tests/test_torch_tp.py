"""The port's tensor parallelism (a ``("data", "model")`` mesh: the column
split of ``parallel/sharding.py``, the column-parallel layers of
``models/``, the DP x TP branch of ``train/trainer.py``) and the trainer's
fsspec checkpoint URLs, on the CPU: gloo ranks, one process and one thread
each, against one process and against the JAX package.

The rule every case holds, as ``tests/test_torch_parallel.py`` holds it for
data parallelism: a (D, M) run computes what the one-process run computes
on the same weights, batches and draws (the JAX DP x TP mesh trainer is one
SPMD program). The ranks run the module-level ``_*_rank`` functions below;
JAX is imported only inside the cases that hold the port against it, so
the spawned ranks import torch and the port alone.

The U-Net is the boundary U-Net of ``tests/test_torch_parallel.py`` at
dim 16 (one group of 3^3 sub-volumes of 4^3), fp32: the narrowest width at
which the JAX rule (4096 elements) shards its Blocks, its time MLP and its
upsample.
"""

import copy
import functools
import io
import os

import numpy as np
import pytest
import torch

from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.parallel import multihost, sharding
from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer
from tests.test_torch_parallel import (
    LR,
    RANK_TIMEOUT_S,
    _assert_params_close,
    _assert_tensors_close,
    _rand,
)

torch.set_num_threads(1)

B, EDGE = 27, 4
TP_UNET = dict(dim=16, init_dim=16, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
               resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=True, batch_sample=True, img_size=12)
# the attention config's slots at this width: softmax attention after the
# first level's init ResnetBlock and in the deep_feature middle (patch 4 of
# the merged 12^3 window, 8 heads of 32: q / k / v / out projections and
# the depthwise q / k / v convs are sharded), dropout off
ATTN_UNET = dict(TP_UNET, att_type="softmax", attend_at_enc=(True, False), deep_feature=True,
                 attend_at_middle=True, attn_dim_head=32, attend_at_enc_heads=8,
                 attend_at_middle_heads=8, init_patch_size=4, att_drop=0.0,
                 att_forward_drop=0.0)
E_KW = dict(image_sizes=(EDGE, EDGE), channels=1, auto_normalize_img=False,
            dynamic_thresholding=False, norm="z-score", min_bound=-0.72,
            lowres_noise_aug=False, num_sample_steps=3, sigma_data=1.0)
# a global-norm limit well under the gradient's norm (about 1-3 here): the
# clip bites on every step
MAX_GRAD_NORM = 0.05
TRAIN_KW = dict(gradient_accumulation_steps=2, ema_update_every=1, ema_update_after_step=0,
                lr=LR, max_grad_norm=MAX_GRAD_NORM)
BATCH_ROWS = 4 * B  # 2 microbatches of 54 rows: one group per data rank at D = 2
STEPS = 2


def _batches(n=STEPS):
    return [(_rand((BATCH_ROWS, EDGE, EDGE, EDGE, 1), s),
             _rand((BATCH_ROWS, EDGE, EDGE, EDGE, 1), s + 1)) for s in range(1, 2 * n, 2)]


def _state(unet_kw, seed=0):
    torch.manual_seed(seed)
    return {k: v.detach().clone() for k, v in UNet3D(**unet_kw).state_dict().items()}


def _trainer(state, mesh=None, unet_kw=TP_UNET, **kw):
    unet = UNet3D(**unet_kw)
    unet.load_state_dict(state)
    imagen = ElucidatedImagen([NullUnet(), unet], **E_KW)
    return ImagenTrainer(None, imagen, mesh=mesh, **{**TRAIN_KW, **kw})


def _whole(tr, tensors):
    """The one-process tensors of unet 2 (shards gathered over the model
    group; every rank of it calls this)."""
    return sharding.gather_state(tensors, tr.shard_dims[1], tr.mesh)


def _params(tr, module=None):
    module = tr.imagen.unets[1] if module is None else module
    return _whole(tr, {k: v.detach().clone() for k, v in module.state_dict().items()})


def _steps(tr, batches, first_draws=None, ckpt=None, url=None):
    """The optimizer steps; the first with ``first_draws``. Returns the
    losses, the first step's gathered gradients and parameters, this rank's
    replicated parameters after the steps, the gathered parameters and EMA;
    with ``ckpt`` (and ``url``) a bundle after the first step."""
    out = {"losses": []}
    for i, batch in enumerate(batches):
        out["losses"].append(tr.train_step(unet_number=2, batch=batch,
                                           draws=first_draws if i == 0 else None))
        if i == 0:
            unet = tr.imagen.unets[1]
            out["grads"] = _whole(tr, {k: p.grad.clone() for k, p in unet.named_parameters()})
            out["params1"] = _params(tr)
            if ckpt is not None:
                tr.save(ckpt)
            if url is not None:
                tr.save(url)
    out["params"], out["ema"] = _params(tr), _params(tr, tr.ema_unets[1])
    out["replicated"] = {k: v.detach().clone() for k, v in tr.imagen.unets[1].state_dict().items()
                         if k not in tr.shard_dims[1]}
    return out


def _sample_valid(state, mesh):
    """From the untrained weights (as ``test_torch_parallel.py`` samples:
    a step's Adam update moves a parameter whose gradient is rounding noise
    by up to 2 lr, which the sampler would carry): EMA sampling of 3 groups
    (padded to 4 over 2 data ranks) and a validation sweep of one batch of 2
    groups (sharded over 2 data ranks)."""
    tr = _trainer(state, mesh)
    start = torch.from_numpy(_rand((3 * B, EDGE, EDGE, EDGE, 1), 20))
    sample = tr.sample(batch_size=3 * B, start_image_or_video=start, start_at_unet_number=2)
    hr, lr = _rand((2 * B, EDGE, EDGE, EDGE, 1), 30), _rand((2 * B, EDGE, EDGE, EDGE, 1), 31)
    tr.add_valid_dataset([(hr[i], lr[i]) for i in range(2 * B)], batch_size=2 * B)
    return {"sample": sample, "valid": tr.valid_step(unet_number=2)}


def _attention_step(state, mesh, batch):
    """One step of the attention U-Net; its loss, gathered gradients and
    parameters, and a forward of the EMA unet's sampler."""
    tr = _trainer(state, mesh, unet_kw=ATTN_UNET, gradient_accumulation_steps=1)
    sample = tr.sample(batch_size=B, start_image_or_video=torch.from_numpy(batch[1][:B]),
                       start_at_unet_number=2)  # the untrained weights, as _sample_valid
    torch.manual_seed(5)  # the q / k / v dropout's masks (0.05), the same in both runs
    out = _steps(tr, [batch])
    out.update(sample=sample, shards=sorted(tr.shard_dims[1]))
    return out


# ---------------------------------------------------------------------------
# the ranks (module-level: the spawned processes import them)
# ---------------------------------------------------------------------------

def _tp_rank(device, state, attn_state, batches, draws, mesh_shape, ckpt, url):
    """(b)-(e) and, at (1, 2), (f): the steps (the first with ``draws``)
    with a bundle after the first (a file and an fsspec URL); a resume from
    the file, one step; sampling and validation."""
    torch.set_num_threads(1)
    mesh = create_mesh(("data", "model"), mesh_shape)
    tr = _trainer(state, mesh)
    out = _steps(tr, batches, draws, ckpt=ckpt, url=url)
    if multihost.is_main_process():  # the memory file system is this process's
        import fsspec

        with fsspec.open(url, "rb") as fh:
            out["url_bundle"] = torch.load(io.BytesIO(fh.read()), weights_only=True)
    resumed = _trainer(state, mesh)
    resumed.load(ckpt)
    out["resumed_loss"] = resumed.train_step(unet_number=2, batch=batches[1])
    out["resumed_params"] = _params(resumed)
    out.update(_sample_valid(state, mesh))
    out["shard_dims"] = dict(tr.shard_dims[1])
    out["local_shapes"] = {k: tuple(p.shape) for k, p in tr.imagen.unets[1].named_parameters()}
    if mesh_shape == (1, 2):
        out["attention"] = _attention_step(attn_state, mesh, batches[0])
    return out


def _launch(fn, *args, nprocs):
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return multihost.launch(fn, args, nprocs=nprocs, device="cpu",
                                timeout_s=RANK_TIMEOUT_S)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


# ---------------------------------------------------------------------------
# (a) the sharding rule against the JAX package's
# ---------------------------------------------------------------------------

class _Mesh:
    """A stand-in for a ``("data", "model")`` mesh of 1 x ``m`` ranks: the
    rule reads the axis names and sizes only."""

    mesh_dim_names = ("data", "model")
    ndim = 2

    def __init__(self, m):
        self.m = m

    def __getitem__(self, name):
        m = self.m
        return type("Axis", (), {"size": lambda self: m if name == "model" else 1})()


# a flagship-shaped UNet3D at a small width with attention on: softmax
# slots at the first two levels and the deep_feature middle, or ViT3D there
RULE_UNET = dict(dim=32, init_dim=32, dim_mults=(1, 2, 4), num_resnet_blocks=1,
                 channels=1, resnet_groups=8, lowres_cond=True, use_se_attn=True,
                 init_cross_embed=False, boundary=True, batch_sample=True, img_size=24,
                 attn_dim_head=16, attend_at_enc=(True, True, False), attend_at_enc_heads=4,
                 attend_at_middle_heads=4, deep_feature=True, attend_at_middle=True,
                 init_patch_size=4)


@functools.lru_cache(maxsize=None)
def _jax_rule_leaves(att_type, model, min_size):
    """The port names of the leaves that the JAX ``param_shardings`` shards
    along their last axis on the JAX UNet3D (``RULE_UNET``): each JAX leaf as
    ones where it is sharded, zeros elsewhere, carried into the port's names
    by ``state_dict_from_jax_params``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from diffusioniqt_tpu.parallel.mesh import create_mesh as j_create_mesh
    from diffusioniqt_tpu.parallel.sharding import param_shardings as j_param_shardings
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

    shapes = _jax_param_shapes(att_type)
    jmesh = j_create_mesh(("data", "model"), (1, model), jax.devices()[:model])
    specs = j_param_shardings(shapes, jmesh, min_size=min_size)
    marks = jax.tree_util.tree_map(
        lambda s, sh: np.full(s.shape, float(sh.spec == P(*([None] * (len(s.shape) - 1)),
                                                           "model")), np.float32),
        shapes, specs)
    return frozenset(k for k, v in state_dict_from_jax_params(marks).items() if bool(v.all()))


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(att_type):
    import jax
    import jax.numpy as jnp

    from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D

    jnet = JUNet3D(**RULE_UNET, att_type=att_type, dtype=jnp.float32)
    x, t = jnp.zeros((27, 8, 8, 8, 1)), jnp.zeros((27,))
    return jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, t,
                                            lowres_cond_img=x))["params"]


@pytest.mark.parametrize("min_size", [4096, 256])
@pytest.mark.parametrize("model", [2, 4])
def test_param_shardings_name_the_jax_rule_leaves(model, min_size):
    """(a) On a flagship-shaped UNet3D at a small width with attention on
    (``RULE_UNET``: softmax slots, the deep_feature middle; again with
    ViT3D in those slots), the port's ``param_shardings`` shards exactly the
    leaves that the JAX ``param_shardings`` shards on the same U-Net, along
    the JAX kernel's last axis; the only leaves the JAX rule shards and the
    port keeps replicated are the ViT3D ``patch_embedding.positions``
    (``replicated_params`` of ``models/attention.py::_PatchEmbedding``)."""
    exceptions = set()
    for att_type in ("softmax", "vit"):
        want = _jax_rule_leaves(att_type, model, min_size)
        port = UNet3D(**RULE_UNET, att_type=att_type)
        got = {k: spec[1] for k, spec in
               sharding.param_shardings(port, _Mesh(model), min_size=min_size).items()
               if hasattr(spec[1], "dim")}
        exceptions |= want - set(got)
        assert set(got) - want == set(), att_type
        assert any(".block1.project.weight" in k for k in got)
        for k, placement in got.items():  # the JAX kernel's last axis
            assert placement.dim == (1 if ".deconv." in k else 0), k
    assert exceptions == {"downs.0.2.patch_embedding.positions",
                          "downs.1.2.patch_embedding.positions",
                          "mid_attn.patch_embedding.positions"}


class _NoColumnSplit(torch.nn.Module):
    """A U-Net stand-in whose 3x3 conv is a plain ``nn.Conv2d``: a layer
    without the column split."""

    lowres_cond, self_cond, channels = True, False, 1

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(64, 64, 3)

    def cast_model_parameters(self, **_):
        return self


def test_sharding_refusals():
    """A TP mesh on a module with a weight of two axes whose layer has no
    column split raises NotImplementedError saying so, in the rule and in
    the trainer, rather than replicating it; ``UNet2D`` (column-parallel
    since its layers got the split) no longer raises; a mesh's model axis is
    its innermost."""
    from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen

    plain = _NoColumnSplit()
    with pytest.raises(NotImplementedError, match="no column split"):
        sharding.param_shardings(plain, _Mesh(2))
    imagen = Imagen([NullUnet(), plain], image_sizes=(8, 8), channels=1, timesteps=4,
                    spatial_dims=2)
    with pytest.raises(NotImplementedError, match="no column split"):
        ImagenTrainer(None, imagen, mesh=_Mesh(2))
    assert sharding.param_shardings(plain, _Mesh(1))  # nothing to split: all replicated
    unet2d = UNet2D(dim=32, dim_mults=(1, 2), channels=1, lowres_cond=True)
    assert any(hasattr(spec[1], "dim") for spec in
               sharding.param_shardings(unet2d, _Mesh(2)).values())
    with pytest.raises(ValueError, match="mesh axes"):
        create_mesh(("model", "data"), (2, 1))


# ---------------------------------------------------------------------------
# (b), (d), (e), (f) against one process
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_setup():
    """The JAX DP x TP mesh trainer on (``data`` 2, ``model`` 2) of the
    conftest's virtual CPU devices, prepared on seeded weights
    (``tests/test_torch_train.py::_init_params``) and not stepped; those
    weights as a port state dict; and the global draws of its first step's
    2 microbatches (``tests/test_torch_parallel.py::_jax_draws``), which
    every port run's first step takes."""
    import jax
    import jax.numpy as jnp

    from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
    from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
    from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
    from diffusioniqt_tpu.parallel.mesh import create_mesh as j_create_mesh
    from diffusioniqt_tpu.train.trainer import ImagenTrainer as JTrainer
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_parallel import _jax_draws
    from tests.test_torch_train import _init_params

    jnet = JUNet3D(**TP_UNET, att_type="linear", dtype=jnp.float32)
    params0 = _init_params(jnet, seed=0)
    null = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: JNullUnet().init(jax.random.PRNGKey(0),
                                                jnp.zeros((B, EDGE, EDGE, EDGE, 1)))))
    wrapper = JElucidated([JNullUnet(), jnet], cond_drop_prob=0.0, **E_KW)
    wrapper.init_params = lambda key, batch_size=1: [
        jax.tree_util.tree_map(jnp.asarray, p) for p in (null, params0)]
    jt = JTrainer(None, wrapper, mesh=j_create_mesh(("data", "model"), (2, 2),
                                                    jax.devices()[:4]), **TRAIN_KW)
    jt.prepare()
    _, sub = jax.random.split(jt._key)  # what train_step's _next_key returns
    draws = [_jax_draws(k, wrapper, True, BATCH_ROWS // 2) for k in jax.random.split(sub, 2)]
    return jt, state_dict_from_jax_params(params0), draws


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port at (2, 2) and at (1, 2) ranks and in one process, on the same
    weights, batches and seed, the first step on the JAX trainer's draws."""
    _, state, draws = _jax_setup()
    attn_state = _state(ATTN_UNET, seed=1)
    batches = _batches()
    out = {"state": state, "batches": batches}
    for shape in ((2, 2), (1, 2)):
        ckpt = str(tmp_path_factory.mktemp("tp") / "step1.pt")
        out[shape] = _launch(_tp_rank, state, attn_state, batches, draws, shape, ckpt,
                             f"memory://tp{shape[0]}/step1.pt", nprocs=shape[0] * shape[1])
        out[shape, "ckpt"] = ckpt
    one_ckpt = str(tmp_path_factory.mktemp("one") / "step1.pt")
    tr = _trainer(state)
    out["one"] = _steps(tr, batches, draws, ckpt=one_ckpt)
    out["one"].update(_sample_valid(state, None))
    out["one_ckpt"] = one_ckpt
    out["one_attention"] = _attention_step(attn_state, None, batches[0])
    return out


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["dp2_tp2", "dp1_tp2"])
def test_tp_steps_equal_one_process(runs, shape):
    """(b) Two clipped steps at (D, M) ranks against the one-process
    trainer: the losses within 1e-5 relative, the gathered first-step
    gradient (clipped: its norm is the limit) within 1e-4 of each tensor's
    largest entry, the parameters by ``_assert_params_close``; the ranks
    hold the column shards of 20 weights (the 18 Blocks' convs, the time
    MLP's second dense layer, the upsample's conv) at ``Cout / M``."""
    one = runs["one"]
    grad_norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in one["grads"].values()])))
    np.testing.assert_allclose(grad_norm, MAX_GRAD_NORM, rtol=1e-4)  # the clip bit
    m = shape[1]
    for got in runs[shape]:
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        _assert_tensors_close(got["grads"], one["grads"], 1e-4, "gradient")
        _assert_params_close(got["params1"], one["params1"], got["grads"])
        _assert_params_close(got["params"], one["params"], got["grads"])
        assert len(got["shard_dims"]) == 20 and set(got["shard_dims"].values()) == {0}
        for name in got["shard_dims"]:
            assert got["local_shapes"][name][0] * m == runs["state"][name].shape[0], name


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["dp2_tp2", "dp1_tp2"])
def test_replicated_parameters_bitwise_equal_across_model_groups(runs, shape):
    """(b) The replicated parameters (GroupNorms, biases, small kernels) are
    bitwise equal on every rank of a model group after the steps, and so
    are the losses; every rank holds the same gathered parameters and EMA."""
    ranks = runs[shape]
    m = shape[1]
    for lo in range(0, len(ranks), m):
        group = ranks[lo:lo + m]
        for got in group[1:]:
            assert got["losses"] == group[0]["losses"]
            for k, v in group[0]["replicated"].items():
                assert torch.equal(v, got["replicated"][k]), k
    for got in ranks[1:]:
        for what in ("params", "ema"):
            for k, v in ranks[0][what].items():
                assert torch.equal(v, got[what][k]), f"{what} {k}"


def _flat(tree, prefix=""):
    """``{path: tensor or value}`` of a bundle's nested dicts and lists."""
    if isinstance(tree, (dict, list, tuple)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return a == b


def test_tp_bundle_is_the_one_process_bundle(runs):
    """(d) The bundle saved under TP after step 1 has the one-process
    bundle's names and shapes (shards gathered); it loads into a
    one-process trainer, whose parameters then equal the TP run's gathered
    ones bit for bit; a TP trainer that loads it and takes step 2 gives the
    uninterrupted run's loss and parameters bit for bit; the bundle written
    to a ``memory://`` URL equals the file's."""
    one = _flat(torch.load(runs["one_ckpt"], weights_only=True))
    for shape in ((2, 2), (1, 2)):
        raw = torch.load(runs[shape, "ckpt"], weights_only=True)
        tp = _flat(raw)
        assert sorted(tp) == sorted(one)
        for k, v in one.items():
            assert np.shape(tp[k]) == np.shape(v), k
        tr = _trainer(runs["state"])
        tr.load(runs[shape, "ckpt"])
        for k, v in _params(tr).items():
            assert torch.equal(v, runs[shape][0]["params1"][k]), k
        url = _flat(runs[shape][0]["url_bundle"])
        assert sorted(url) == sorted(tp)
        for k, v in tp.items():
            assert _same(url[k], v), k
        for got in runs[shape]:
            assert got["resumed_loss"] == got["losses"][1]
            for k, v in got["resumed_params"].items():
                assert torch.equal(v, got["params"][k]), k


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["dp2_tp2", "dp1_tp2"])
def test_tp_sample_and_valid_step_equal_one_process(runs, shape):
    """(e) EMA sampling of 3 groups and a validation sweep of 2 groups at
    (D, M) ranks return the one-process results on every rank. The sweep
    (one forward) within 1e-5 relative (arrays: of their largest entry), the
    tolerance of ``test_torch_parallel.py``'s sampling case. The sampler's 5
    chained forwards within 1e-4 of the sample's largest entry, the
    gradients' tolerance of (b): on top of the data ranks' other batch
    sizes (about 1e-6 of the largest entry per call there), every sharded
    layer sums its products in the CPU kernels' blocking for ``Cout / M``
    channels, and the sampler's noise scale (sigma up to 80) carries those
    last-bit differences (2.3e-5 of the largest entry at (2, 2), in 3 of
    5184 voxels, in the run that set this bound)."""
    one = runs["one"]
    for got in runs[shape]:
        torch.testing.assert_close(got["sample"], one["sample"], rtol=1e-5,
                                   atol=1e-4 * float(one["sample"].abs().max()))
        loss, preds, noisy, (hrs, lows), ssim, psnr = got["valid"]
        w_loss, w_preds, w_noisy, (w_hrs, w_lows), w_ssim, w_psnr = one["valid"]
        np.testing.assert_allclose([loss, ssim, psnr], [w_loss, w_ssim, w_psnr], rtol=1e-5)
        for a, w in ((preds, w_preds), (noisy, w_noisy), (hrs, w_hrs), (lows, w_lows)):
            assert a.shape == w.shape
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def test_attention_config_under_model_two_equals_one_process(runs):
    """(f) The attention config's slots (softmax attention at the first
    level and the middle, the mid ResnetBlock) under ``model`` 2: the
    q / k / v / out projections and the depthwise q / k / v convs are
    column shards (the flash path sees whole heads after the gather); one
    clipped step and an EMA sampler call equal one process (the loss within
    1e-5 relative, gradients within 1e-4 of each tensor's largest entry,
    parameters by ``_assert_params_close``, the sample within 1e-5 of its
    largest entry)."""
    one = runs["one_attention"]
    for rank in runs[(1, 2)]:
        got = rank["attention"]
        assert any(".to_q.2.weight" in k for k in got["shards"])  # a depthwise conv
        assert any(".to_out.0.weight" in k for k in got["shards"])
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        _assert_tensors_close(got["grads"], one["grads"], 1e-4, "gradient")
        _assert_params_close(got["params1"], one["params1"], got["grads"])
        torch.testing.assert_close(got["sample"], one["sample"], rtol=1e-5,
                                   atol=1e-5 * float(one["sample"].abs().max()))


# ---------------------------------------------------------------------------
# (c) against the JAX DP x TP mesh trainer
# ---------------------------------------------------------------------------

def test_dp2_tp2_step_equals_jax_mesh_trainer(runs):
    """(c) The first clipped step at (2, 2) gloo ranks against the JAX
    trainer on a (``data`` 2, ``model`` 2) mesh of the conftest's virtual
    CPU devices (as ``tests/test_trainer_tp.py`` sets it up), on the same
    weights, batch and global draws: the loss within 1e-5 relative, the
    gathered gradient against the JAX gradient (Adam's first moment over
    1 - beta1) within 1e-4 of each tensor's largest entry, the parameters
    by ``_assert_params_close``."""
    import jax

    from diffusioniqt_tpu_torch.utils.convert import (
        adam_state_from_optax,
        state_dict_from_jax_params,
    )

    jt = _jax_setup()[0]
    jloss = jt.train_step(unet_number=2, batch=runs["batches"][0])
    assert {key[1] for key in jt._train_step_fns} == {2}  # the microbatches the draws assume
    adam = adam_state_from_optax(jax.device_get(jt.opt_states[1]))
    want_params = state_dict_from_jax_params(jax.device_get(jt.params[1]))
    want_grads = {k: v["exp_avg"] / (1 - 0.9) for k, v in adam.items()}
    for got in runs[(2, 2)]:
        np.testing.assert_allclose(got["losses"][0], jloss, rtol=1e-5)
        _assert_tensors_close(got["grads"], want_grads, 1e-4, "gradient")
        _assert_params_close(got["params1"], want_params, got["grads"])


# ---------------------------------------------------------------------------
# (g) the kernels' CPU emulation at Cout / M
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,s", [("igemm", 8), ("small_edge", 4)])
def test_kernel_emulation_at_the_column_shard(route, s, monkeypatch):
    """(g) ``tests/test_torch_kernels.py``'s plain-torch emulation of the
    fused kernel's tiles (the implicit GEMM's bricks at BN 64, or the
    small-edge route's whole sub-volumes at BN 128) on each rank's
    ``(Cout / M, Cin, 3, 3, 3)`` shard of a 64-channel weight at M = 2 and
    4 (Cout / M 32 and 16: a tile wider than the weight, its extra columns
    computed and not stored) against the Pallas ``fused_boundary_block`` in
    interpret mode on the matching column shard of the JAX weight (rank 0's
    shard at each width); the ranks' outputs side by side are the whole
    layer's plain output, which ``test_torch_kernels.py`` holds against the
    Pallas kernel."""
    import jax.numpy as jnp

    import diffusioniqt_tpu.ops.pallas.fused_block as jfb
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.ops.kernels import fused_block as tfb
    from tests.test_torch_kernels import (
        _bf16_values,
        _emulate_igemm,
        _emulate_small_edge,
        _t,
        _torch_w,
    )

    monkeypatch.setattr(jfb, "INTERPRET", True)
    cin, cout, groups = 16, 64, 8
    factor = 2 if route == "igemm" else 3
    emulate = _emulate_igemm if route == "igemm" else _emulate_small_edge
    nb = factor ** 3
    x = _bf16_values(_rand((nb, s, s, s, cin), 41))
    ns, nbias = 1.0 + 0.1 * _rand((cin,), 42), 0.1 * _rand((cin,), 43)
    ss = (0.2 * _rand((nb, 1, 1, 1, cin), 44), 0.2 * _rand((nb, 1, 1, 1, cin), 45))
    w = _bf16_values(_rand((3, 3, 3, cin, cout), 46) * (27 * cin) ** -0.5)
    a, b = tfb.groupnorm_affine(_t(x), _t(ns), _t(nbias), groups, scale_shift=tuple(map(_t, ss)))
    ta, tb = tfb.neighbor_tables(a, b, factor)
    xh = kernels.halo_exchange_plain(_t(x), factor)
    assert tfb.route(s) == route
    whole = tfb.fused_conv_plain(xh, ta, tb, _torch_w(w))
    for model in (2, 4):
        n = cout // model
        parts = [emulate(xh, ta, tb, _torch_w(np.ascontiguousarray(w[..., r * n:(r + 1) * n])))
                 for r in range(model)]
        assert parts[0].shape == (nb, s, s, s, n)
        # the Pallas kernel at the shard's width (rank 0's shard: each call in
        # interpret mode takes seconds), at the tolerance of
        # test_torch_kernels.py's fused-block cases
        want = jfb.fused_boundary_block(
            jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nbias), tuple(map(jnp.asarray, ss)),
            jnp.asarray(np.ascontiguousarray(w[..., :n])), groups, factor, jnp.float32)
        np.testing.assert_allclose(parts[0].numpy(), np.asarray(want), rtol=3e-3, atol=3e-4)
        # every rank's columns: the whole layer's plain output
        np.testing.assert_allclose(torch.cat(parts, dim=-1).numpy(), whole.numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fsspec checkpoint URLs (tests/test_fsspec_checkpoints.py's three cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def small_trainer():
    return _trainer(_state(TP_UNET), gradient_accumulation_steps=1, max_grad_norm=None)


def _train_one(tr):
    hr, lr = _batches(1)[0]
    tr.train_step(unet_number=2, batch=(hr[:B], lr[:B]))


def test_memory_url_roundtrip(small_trainer, tmp_path):
    """A bundle saved to a ``memory://`` URL restores the saved state after
    more training, and equals the bundle saved to a local file."""
    tr = small_trainer
    _train_one(tr)
    url = "memory://ckpts/bundle.pt"
    tr.save(url)
    tr.save(str(tmp_path / "bundle.pt"))
    before = copy.deepcopy(tr.imagen.unets[1].state_dict())
    _train_one(tr)
    assert any(not torch.equal(v, tr.imagen.unets[1].state_dict()[k]) for k, v in before.items())
    tr.load(url)
    for k, v in tr.imagen.unets[1].state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tr.steps[1] == 1
    import fsspec

    with fsspec.open(url, "rb") as fh:
        url_bundle = _flat(torch.load(io.BytesIO(fh.read()), weights_only=True))
    file_bundle = _flat(torch.load(str(tmp_path / "bundle.pt"), weights_only=True))
    assert sorted(url_bundle) == sorted(file_bundle)
    for k, v in file_bundle.items():
        assert _same(url_bundle[k], v), k


def test_memory_url_noop_if_not_exist(small_trainer):
    small_trainer.load("memory://nope/missing.pt", noop_if_not_exist=True)
    with pytest.raises(FileNotFoundError):
        small_trainer.load("memory://nope/missing.pt")


def test_url_checkpoint_folder_rolling(small_trainer):
    """The rolling folder at a ``memory://`` URL keeps the newest
    ``max_checkpoints_keep`` bundles and resumes from the newest."""
    tr = small_trainer
    tr.checkpoint_path, tr.checkpoint_every = "memory://torch_roll", 1000
    tr.max_checkpoints_keep = 2
    for _ in range(3):
        _train_one(tr)
        tr.save_to_checkpoint_folder()
    ckpts = tr.all_checkpoints_sorted
    assert len(ckpts) == 2 and ckpts[0].endswith("checkpoint.3.pt")
    assert ckpts[1].endswith("checkpoint.2.pt")
    steps_before = list(tr.steps)
    _train_one(tr)
    tr.load_from_checkpoint_folder()
    assert tr.steps == steps_before
    fresh = _trainer(_state(TP_UNET), checkpoint_path="memory://torch_roll", checkpoint_every=1000)
    assert fresh.steps == steps_before  # a trainer on the folder resumes from its newest
