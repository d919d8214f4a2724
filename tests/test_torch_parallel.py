"""The port's data parallelism (diffusioniqt_tpu_torch/parallel, the mesh
branch of train/trainer.py, ``infer`` / ``evaluate --mesh N`` and the
training entry point under torchrun) on the CPU: gloo ranks, one process
each, against one process and against the JAX package.

The rule every case holds: a W-rank run computes what the one-process run
computes on the same seed (the JAX mesh trainer is one SPMD program with
one key for the global batch). The ranks run the module-level ``_*_rank``
functions below, spawned by ``parallel.multihost.launch`` with a timeout of
their own (a hung rendezvous fails one test), one thread each. JAX is
imported only where a case holds the port against it, so the spawned ranks
import torch and the port alone.

The U-Net is the small boundary U-Net of tests/test_torch_train.py (dim 8,
one group of 3^3 sub-volumes of 4^3) at fp32.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from diffusioniqt_tpu_torch import evaluate, infer
from diffusioniqt_tpu_torch.data.datasets import FakeIQTDataset
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.metrics.lpips import make_lpips_fn
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.parallel import multihost, sharding
from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
MIN_BOUND = (0.0 - 271.64814106698583) / 377.117173547721  # eval_edm z-score
B, EDGE = 27, 4  # one group of 3^3 sub-volumes of 4^3
UNET_KW = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
               resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=True, batch_sample=True, img_size=12)
G_KW = dict(image_sizes=(EDGE, EDGE), channels=1, timesteps=1000, dynamic_thresholding=False,
            min_bound=MIN_BOUND, norm="z-score", batch_sample=True)
E_KW = dict(image_sizes=(EDGE, EDGE), channels=1, auto_normalize_img=False,
            dynamic_thresholding=False, norm="z-score", min_bound=MIN_BOUND,
            lowres_noise_aug=False, num_sample_steps=4, sigma_data=1.0)
LR = 1e-3
TRAIN_KW = dict(gradient_accumulation_steps=2, ema_update_every=1, ema_update_after_step=0,
                lr=LR)
STEPS = 3
BATCH_ROWS = 4 * B  # 4 groups: 2 microbatches of 54 rows, 27 per rank


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _batches():
    return [(_rand((BATCH_ROWS, EDGE, EDGE, EDGE, 1), s),
             _rand((BATCH_ROWS, EDGE, EDGE, EDGE, 1), s + 1)) for s in (1, 3, 5)]


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _trainer(state, edm, mesh=None, **kw):
    unet = UNet3D(**UNET_KW)
    unet.load_state_dict(state)
    imagen = (ElucidatedImagen([NullUnet(), unet], **E_KW) if edm
              else Imagen([NullUnet(), unet], pred_objectives="x_start",
                          p2_loss_weight_gamma=0.0, **G_KW))
    return ImagenTrainer(None, imagen, mesh=mesh, **{**TRAIN_KW, **kw})


def _run_steps(tr, batches, first_draws):
    """Steps over ``batches``; the first with ``first_draws`` (global
    microbatch draws), the rest from the trainer's generator. Returns the
    losses and the first step's gradients and parameters."""
    out = {"losses": []}
    for i, batch in enumerate(batches):
        out["losses"].append(tr.train_step(unet_number=2, batch=batch,
                                           draws=first_draws if i == 0 else None))
        if i == 0:
            unet = tr.imagen.unets[1]
            out["grads"] = {k: p.grad.clone() for k, p in unet.named_parameters()}
            out["params1"] = {k: p.detach().clone() for k, p in unet.named_parameters()}
    out["params"] = _state(tr.imagen.unets[1])
    out["ema"] = _state(tr.ema_unets[1])
    return out


# ---------------------------------------------------------------------------
# the ranks (module-level: the spawned processes import them)
# ---------------------------------------------------------------------------

def _train_rank(device, state, edm, batches, first_draws, ckpt):
    """3 steps with a bundle after each; then a share that cuts a group."""
    torch.set_num_threads(1)
    rank = multihost.process_index()
    mesh = create_mesh(("data",))
    unet_state = {k: v + 1.0 if rank == 1 else v for k, v in state.items()}
    tr = _trainer(unet_state, edm, mesh, checkpoint_path=ckpt, checkpoint_every=1)
    first = next(tr.imagen.unets[1].parameters())
    version = first._version
    saves = []
    real_save = torch.save
    torch.save = lambda *a, **k: (saves.append(a[1]), real_save(*a, **k))
    try:
        out = _run_steps(tr, batches, first_draws)
    finally:
        torch.save = real_save
    out.update(saves=len(saves), version_bumped=first._version > version)
    errors = []
    for rows in (36, 3 * B):  # 18 rows per rank; 81 rows over 2 ranks
        tr.gradient_accumulation_steps = 1
        try:
            tr.train_step(unet_number=2, batch=tuple(a[:rows] for a in batches[0]))
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _resume_rank(device, state, edm, batch, ckpt):
    """A fresh trainer resumed from the folder's bundle of step 2, one more
    step."""
    torch.set_num_threads(1)
    tr = _trainer(state, edm, create_mesh(("data",)), checkpoint_path=ckpt,
                  checkpoint_every=100)  # loads the newest bundle, of step 3
    tr.load_from_checkpoint_folder(2)
    loss = tr.train_step(unet_number=2, batch=batch)
    return {"steps": list(tr.steps), "loss": loss}


def _sample_valid(state, mesh):
    """EMA sampling of 5 groups (whole, and in chunks of 2 groups: the last
    chunk is one group over two ranks), and a validation sweep over a batch
    of 2 groups (sharded) and one of 1 group (computed whole)."""
    tr = _trainer(state, edm=True, mesh=mesh)
    start = torch.from_numpy(_rand((5 * B, EDGE, EDGE, EDGE, 1), 20))
    whole = tr.sample(batch_size=5 * B, start_image_or_video=start, start_at_unet_number=2)
    chunked = tr.sample(batch_size=5 * B, start_image_or_video=start, start_at_unet_number=2,
                        max_batch_size=2 * B)
    tg = _trainer(state, edm=False, mesh=mesh)
    hr, lr = _rand((3 * B, EDGE, EDGE, EDGE, 1), 30), _rand((3 * B, EDGE, EDGE, EDGE, 1), 31)
    tg.add_valid_dataset([(hr[i], lr[i]) for i in range(3 * B)], batch_size=2 * B)
    # the ancestral trajectory, (steps, rows, ...), gathered on its row axis
    tg.imagen.noise_schedulers[1] = type(tg.imagen.noise_schedulers[1])(timesteps=3)
    traj = tg.sample(batch_size=3 * B, start_image_or_video=torch.from_numpy(lr),
                     start_at_unet_number=2, return_trajectory=True,
                     return_all_unet_outputs=True)
    return {"whole": whole, "chunked": chunked, "valid": tg.valid_step(unet_number=2),
            "traj": traj}


def _sample_valid_rank(device, state):
    torch.set_num_threads(1)
    return _sample_valid(state, create_mesh(("data",)))


def _lpips_run(state, mesh, batches):
    """2 steps of the x_start trainer with the VGG-LPIPS term (the proxy
    network on 16^2 slices), then a validation sweep of one sharded batch
    of 2 groups."""
    unet = UNet3D(**UNET_KW)
    unet.load_state_dict(state)
    imagen = Imagen([NullUnet(), unet], pred_objectives="x_start", p2_loss_weight_gamma=0.0,
                    lpips_fn=make_lpips_fn(target_size=16), **G_KW)
    tr = ImagenTrainer(None, imagen, mesh=mesh, **TRAIN_KW)
    out = _run_steps(tr, batches, None)
    hr, lr = _rand((2 * B, EDGE, EDGE, EDGE, 1), 40), _rand((2 * B, EDGE, EDGE, EDGE, 1), 41)
    tr.add_valid_dataset([(hr[i], lr[i]) for i in range(2 * B)], batch_size=2 * B)
    out["valid_loss"] = tr.valid_step(unet_number=2)[0]
    return out


def _lpips_rank(device, state, batches):
    torch.set_num_threads(1)
    return _lpips_run(state, create_mesh(("data",)), batches)


def _launch(fn, *args, nprocs=2):
    """``fn`` on ``nprocs`` gloo ranks of one thread each."""
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
# (a) the helpers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,count", [(8, 1), (8, 2), (8, 4), (6, 3), (5, 2), (7, 4)])
def test_local_batch_slice_matches_jax(batch, count, monkeypatch):
    """``local_batch_slice`` gives each process the JAX function's slice and
    raises where it raises (an indivisible batch)."""
    import jax

    from diffusioniqt_tpu.parallel import multihost as jmultihost

    monkeypatch.setattr(jax, "process_count", lambda: count)
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda index=index: index)
        if batch % count:
            with pytest.raises(ValueError, match="not divisible"):
                jmultihost.local_batch_slice(batch)
            with pytest.raises(ValueError, match="not divisible"):
                multihost.local_batch_slice(batch, count, index)
        else:
            assert multihost.local_batch_slice(batch, count, index) == \
                jmultihost.local_batch_slice(batch)
    assert multihost.local_batch_slice(batch) == slice(0, batch)  # one process
    assert multihost.is_main_process() and multihost.process_count() == 1


def test_single_process_is_a_noop(monkeypatch):
    """Without torchrun's environment ``initialize_multihost`` joins no group
    (the JAX function's single-host no-op) and ``run_ranks`` runs in this
    process."""
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_multihost("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.run_ranks(lambda device, x: (str(device), x), (3,), device="cpu") == \
        ("cpu", 3)


def test_pad_rows_repeats_whole_groups():
    x = torch.arange(5 * 3).reshape(5, 3)
    assert torch.equal(sharding.pad_rows(x, 8), torch.cat([x, x[:3]]))
    assert sharding.pad_rows(x, 5) is x


# ---------------------------------------------------------------------------
# (b)-(e) training
# ---------------------------------------------------------------------------

def _jax_draws(key, imagen, edm, rows):
    """What the JAX wrappers' forward draws from one microbatch key for a
    microbatch of ``rows`` sub-volumes (tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp

    shape = (rows, EDGE, EDGE, EDGE, 1)
    if edm:
        _, _, _, k_sigma, k_noise = jax.random.split(key, 5)
        draws = {"sigmas": imagen.hparams[1].noise_distribution(k_sigma, rows),
                 "noise": jax.random.normal(k_noise, shape, jnp.float32)}
    else:
        key, t_key = jax.random.split(key)
        times = imagen.noise_schedulers[1].sample_random_times(t_key, 1)
        _, noise_key = jax.random.split(key)
        draws = {"times": jnp.broadcast_to(times, (rows,)),
                 "noise": jax.random.normal(noise_key, shape)}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in draws.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["gaussian_x_start", "edm"])
def runs(request, tmp_path_factory):
    """One step of the JAX mesh trainer on 2 of the virtual CPU devices;
    the port on 2 gloo ranks (3 steps, the first with the JAX step's
    draws, a bundle after each, then a resume from step 2's bundle); the
    port in one process (3 steps)."""
    import jax
    import jax.numpy as jnp

    from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
    from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
    from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
    from diffusioniqt_tpu.parallel.mesh import create_mesh as j_create_mesh
    from diffusioniqt_tpu.train.trainer import ImagenTrainer as JTrainer
    from diffusioniqt_tpu_torch.utils.convert import (
        adam_state_from_optax,
        state_dict_from_jax_params,
    )
    from tests.test_torch_train import _init_params, _jax_unet

    edm = request.param
    params0 = _init_params(_jax_unet(), seed=0)
    null = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: JNullUnet().init(jax.random.PRNGKey(0),
                                                jnp.zeros((B, EDGE, EDGE, EDGE, 1)))))
    wrapper = (JElucidated([JNullUnet(), _jax_unet()], cond_drop_prob=0.0, **E_KW) if edm
               else JImagen([JNullUnet(), _jax_unet()], pred_objectives="x_start",
                            p2_loss_weight_gamma=0.0, **G_KW))
    wrapper.init_params = lambda key, batch_size=1: [
        jax.tree_util.tree_map(jnp.asarray, p) for p in (null, params0)]
    jt = JTrainer(None, wrapper, mesh=j_create_mesh(("data",), (2,), jax.devices()[:2]),
                  **TRAIN_KW)
    jt.prepare()
    batches = _batches()
    _, sub = jax.random.split(jt._key)  # what train_step's _next_key returns
    jloss = jt.train_step(unet_number=2, batch=batches[0])
    (accum,) = {key[1] for key in jt._train_step_fns}
    draws = [_jax_draws(k, wrapper, edm, BATCH_ROWS // accum)
             for k in jax.random.split(sub, accum)]
    adam = adam_state_from_optax(jax.device_get(jt.opt_states[1]))
    jax_run = {"loss": jloss, "accum": accum,
               "params": state_dict_from_jax_params(jax.device_get(jt.params[1])),
               "grads": {k: v["exp_avg"] / (1 - 0.9) for k, v in adam.items()}}

    state = state_dict_from_jax_params(params0)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    ranks = _launch(_train_rank, state, edm, batches, draws, ckpt)
    resumed = _launch(_resume_rank, state, edm, batches[2], ckpt)
    one = _run_steps(_trainer(state, edm), batches, draws)
    return dict(edm=edm, jax=jax_run, ranks=ranks, one=one, resumed=resumed,
                ckpt=ckpt, state=state)


def _assert_tensors_close(got, want, rel, what):
    """Each tensor within ``rel`` of its largest entry."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = torch.as_tensor(w).float()
        torch.testing.assert_close(got[k].float(), w, rtol=0,
                                   atol=rel * float(w.abs().max()) + 1e-12, msg=f"{what} {k}")


def _assert_params_close(got, want, grads):
    """The parameters after one Adam step of ``LR``: Adam's first update is
    about ``lr * g / (|g| + eps)``, so where a gradient is fp32 noise its
    sign, and a whole ``lr`` step, may differ between two sums of the same
    gradient; every parameter within ``2 * lr``, and those whose gradient is
    firm (|g| above 1e-3 of its tensor's largest) within ``1e-3 * lr`` plus
    1e-6 relative (tests/test_torch_train.py's rule)."""
    for k, w in want.items():
        w = torch.as_tensor(w).float()
        diff = (got[k] - w).abs()
        g = grads[k].abs()
        firm = g > 1e-3 * g.max()
        assert float(diff.max()) <= 2 * LR, k
        assert bool((diff[firm] <= 1e-3 * LR + 1e-6 * w[firm].abs()).all()), k


def test_two_ranks_step_equals_jax_mesh_trainer(runs):
    """(b) One step over 2 ranks against the JAX mesh trainer on 2 virtual
    devices, same weights, batch and global draws: the loss within 1e-5
    relative; the all-reduced gradient against the JAX gradient (Adam's
    first moment over 1 - beta1) within 1e-4 of each tensor's largest entry
    (fp32 sums in other orders through two U-Net passes, as
    tests/test_torch_train.py holds the one-device trainers); the
    parameters by :func:`_assert_params_close`."""
    want, got = runs["jax"], runs["ranks"][0]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=1e-5)
    _assert_tensors_close(got["grads"], want["grads"], 1e-4, "gradient")
    _assert_params_close(got["params1"], want["params"], got["grads"])


def test_two_ranks_equal_one_process(runs):
    """(b) The 2-rank run against the one-process port over 3 steps (the
    last two drawing from the trainer's generator: each rank draws the
    global microbatch's and keeps its rows): the losses within 1e-5
    relative, the first step's gradients within 1e-5 of each tensor's
    largest entry, the parameters by :func:`_assert_params_close`."""
    got, one = runs["ranks"][0], runs["one"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    _assert_tensors_close(got["grads"], one["grads"], 1e-5, "gradient")
    _assert_params_close(got["params1"], one["params1"], got["grads"])


def test_ranks_stay_bitwise_equal(runs):
    """(c) Rank 1 starts from other weights; rank 0's are broadcast (its
    parameters' version counters bumped), and after 3 steps with an EMA
    update each the two ranks' parameters and EMA are bitwise equal and
    their losses the same."""
    r0, r1 = runs["ranks"]
    assert r0["losses"] == r1["losses"]
    assert r0["version_bumped"] and r1["version_bumped"]
    for what in ("params", "ema"):
        for k, v in r0[what].items():
            assert torch.equal(v, r1[what][k]), f"{what} {k}"
    for k, v in r0["params1"].items():
        assert torch.equal(v, r1["params1"][k]), k


def test_microbatch_rule_matches_jax_and_groups_stay_whole(runs):
    """(d) The microbatch count with a data size is the JAX mesh trainer's
    (trainer.py:416-428): here 2 of 54 rows, read from the JAX trainer's
    compiled step, and the JAX rule's count everywhere; where that count
    would give a rank part of a 27-group, the next smaller count that does
    not (the flagship config's 4 patches over 4 ranks: 1, not JAX's 3). A
    batch whose per-rank share cuts a group raises on every rank, as does
    one whose rows do not divide over the ranks."""
    rule = ImagenTrainer.microbatches
    assert runs["jax"]["accum"] == rule(BATCH_ROWS, 2, None, 2, B) == 2

    def jax_rule(b, accum, max_batch_size, data_size):  # trainer.py:410-428, verbatim
        if max_batch_size is not None:
            accum = max(accum, -(-b // max_batch_size))
        if b % accum != 0:
            accum = 1
        while accum > 1 and (b // accum) % data_size != 0:
            accum -= 1
        return accum

    for b in (27, 54, 81, 108, 216, 270):
        for accum in (1, 2, 3, 4):
            for max_bs in (None, 27, 54):
                for n in (1, 2, 4):
                    assert rule(b, accum, max_bs, n) == jax_rule(b, accum, max_bs, n)
                    got = rule(b, accum, max_bs, n, B)
                    assert got <= jax_rule(b, accum, max_bs, n)
                    assert got == 1 or (b // got) % (n * B) == 0
    assert jax_rule(BATCH_ROWS, 4, 27, 4) == 3 and rule(BATCH_ROWS, 4, 27, 4, B) == 1
    assert jax_rule(BATCH_ROWS, 4, None, 2) == 3 and rule(BATCH_ROWS, 4, None, 2, B) == 2
    for rank in runs["ranks"]:
        cut, ragged = rank["errors"]
        assert "cuts a group of 27" in cut
        assert "does not split" in ragged


def test_only_rank_zero_writes_and_resume_reproduces(runs):
    """(e) Only rank 0 wrote the bundles (one per step); a 2-rank resume from
    step 2's bundle takes step 3 with the uninterrupted run's loss, bit for
    bit."""
    r0, r1 = runs["ranks"]
    assert r0["saves"] == STEPS and r1["saves"] == 0
    assert sorted(os.listdir(runs["ckpt"])) == [f"checkpoint.{n}.pt" for n in (1, 2, 3)]
    for rank in runs["resumed"]:
        assert rank["steps"] == [0, STEPS] and rank["loss"] == r0["losses"][2]


def test_lpips_term_two_ranks_equal_one_process():
    """(b) with ``Train.lpips``: the term min-max normalises each slice
    stack over the whole microbatch, so the 2 ranks take each stack's min
    and max over both shares (``parallel/sharding.py::global_extremes``),
    and its gradient goes to the rank that holds it. 2 steps and a sharded
    validation sweep against the one-process run: the losses within 1e-5
    relative, the first step's gradients within 1e-5 of each tensor's
    largest entry, the parameters by :func:`_assert_params_close`. The
    weights are the file's shared ones (``runs``): the port's fresh init
    draws the SE gates' dense layers without bias, and at dim 8 (one hidden
    unit) one gate is nearly dead, its gradient all rounding noise."""
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_train import _init_params, _jax_unet

    state = state_dict_from_jax_params(_init_params(_jax_unet(), seed=0))
    batches = _batches()[:2]
    ranks = _launch(_lpips_rank, state, batches)
    one = _lpips_run(state, None, batches)
    for got in ranks:
        np.testing.assert_allclose(got["losses"] + [got["valid_loss"]],
                                   one["losses"] + [one["valid_loss"]], rtol=1e-5)
        _assert_tensors_close(got["grads"], one["grads"], 1e-5, "gradient")
        _assert_params_close(got["params1"], one["params1"], got["grads"])


# ---------------------------------------------------------------------------
# (f), (g) sampling and validation
# ---------------------------------------------------------------------------

def test_sharded_sample_and_valid_step_equal_one_process():
    """(f) EMA sampling of 5 groups over 2 ranks (padded to 6 groups and cut
    back; in chunks of 2 groups the last chunk is one group, padded to two)
    equals the one-process sample, and so does a 3-step ancestral call of 3
    groups with its trajectory (padded to 4 groups); (g) the validation sweep (one sharded
    batch of 2 groups, one whole batch of 1 group) returns the one-process
    loss, outputs and metrics; on both ranks. Tolerance: 1e-5 relative,
    arrays within 1e-5 of their largest entry: CPU convolutions pick their
    blocking by batch size, so the one-process sampler itself moves by about
    1e-6 of the largest entry when its batch is cut to a rank's share."""
    torch.manual_seed(0)
    state = _state(UNet3D(**UNET_KW))
    ranks = _launch(_sample_valid_rank, state)
    one = _sample_valid(state, None)
    for got in ranks:
        for key in ("whole", "chunked"):
            assert got[key].shape == (5 * B, EDGE, EDGE, EDGE, 1)
            torch.testing.assert_close(got[key], one[key], rtol=1e-5,
                                       atol=1e-5 * float(one[key].abs().max()))
        (head,), *steps = got["traj"]
        (w_head,), *w_steps = one["traj"]
        assert head.shape == (3 * B, EDGE, EDGE, EDGE, 1)
        for a, w in ((head, w_head), *zip(steps, w_steps)):
            assert a.shape == w.shape
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
        loss, preds, noisy, (hrs, lows), ssim, psnr = got["valid"]
        w_loss, w_preds, w_noisy, (w_hrs, w_lows), w_ssim, w_psnr = one["valid"]
        np.testing.assert_allclose([loss, ssim, psnr], [w_loss, w_ssim, w_psnr], rtol=1e-5)
        for a, w in ((preds, w_preds), (noisy, w_noisy), (hrs, w_hrs), (lows, w_lows)):
            assert a.shape == w.shape == (3 * B, EDGE, EDGE, EDGE, 1)
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


# the cascade test's tiny text-conditioned video U-Net
# (tests/test_torch_video_edm.py::TINY_UNET)
VIDEO_UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, init_dim=8,
                  resnet_groups=4, attn_dim_head=4, attn_heads=2, layer_attns=(False, False),
                  layer_cross_attns=(False, True), init_cross_embed=False,
                  init_conv_kernel_size=3, cond_on_text=True, text_embed_dim=16,
                  max_text_len=8, attn_pool_num_latents=4, memory_efficient=False,
                  temporal_strides=(1, 1))
VIDEO_KW = dict(batch_size=2, video_frames=4, cond_scale=3.0)


def _video_edm():
    """The tiny video U-Net behind the EDM wrapper (3 steps at 16^2), every
    parameter drawn N(0, 0.1^2) from seed 0: the module's init zeroes the
    final conv and the temporal gates, which would make the sample
    independent of the text."""
    from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo

    unet = Unet3DVideo(**VIDEO_UNET)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return ElucidatedImagen([unet.eval()], image_sizes=(16,), channels=1,
                            auto_normalize_img=True, num_sample_steps=3,
                            dynamic_thresholding=False, norm="min-max")


def _video_text():
    from diffusioniqt_tpu_torch.utils.t5 import hash_text_encode

    return hash_text_encode(["a brain mri", "an axial t2 flair slice"], dim=16, max_length=8,
                            return_attn_mask=True)


def _replayed(draws):
    """A noise function that serves the draws of one whole-batch call to
    calls over consecutive chunks of its rows: the k-th draw of the chunk
    starting at row ``lo`` is rows ``lo:lo + n`` of the whole call's k-th."""
    state = {"i": 0, "lo": 0}

    def noise(shape):
        k = state["i"] % len(draws)
        if k == 0 and state["i"]:
            state["lo"] += shape[0]
        state["i"] += 1
        return draws[k][state["lo"]:state["lo"] + shape[0]]
    return noise


def _video_trainer_sample(mesh, draws):
    """``ImagenTrainer.sample`` of the 2 videos in chunks of 1 with their
    texts and masks, on the whole call's noise."""
    emb, mask = _video_text()
    tr = ImagenTrainer(None, _video_edm(), mesh=mesh)
    return tr.sample(max_batch_size=1, noise=_replayed(draws), text_embeds=emb,
                     text_mask=mask, **VIDEO_KW)


def _video_sample_rank(device, draws):
    torch.set_num_threads(1)
    return _video_trainer_sample(create_mesh(("data",)), draws)


def test_trainer_samples_video_with_text_in_chunks():
    """``ImagenTrainer.sample(text_embeds=..., text_mask=...,
    video_frames=..., max_batch_size=1)`` on a small video EDM wrapper slices
    the text and its mask per chunk and equals the wrapper's own unchunked
    ``sample`` on the same noise stream (each chunk served its rows of the
    whole call's draws), in one process and on 2 gloo ranks (each chunk's
    one row padded to one per rank), within 1e-5 of the largest entry (CPU
    kernels block other batch sizes in other orders); the texts give the
    two videos different samples."""
    emb, mask = _video_text()
    draws = []
    gen = torch.Generator().manual_seed(1)

    def record(shape):
        draws.append(torch.randn(shape, generator=gen))
        return draws[-1]

    with torch.no_grad():
        want = _video_edm().sample(noise=record, text_embeds=emb, text_mask=mask, **VIDEO_KW)
    assert want.shape == (2, 4, 16, 16, 1)
    for got in [_video_trainer_sample(None, draws)] + _launch(_video_sample_rank, draws):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    swapped = _video_edm().sample(noise=_replayed(draws), text_embeds=emb.flip(0),
                                  text_mask=mask.flip(0), **VIDEO_KW)
    assert not torch.allclose(swapped, want)


# ---------------------------------------------------------------------------
# (h)-(j) entry points
# ---------------------------------------------------------------------------

def _tiny_config(tmp_path, source="config/eval_edm.yaml"):
    raw = yaml.safe_load(open(os.path.join(ROOT, source)))
    raw["Train"].update(dim=8, init_dim=8, dim_mults=[1, 2], num_resnet_blocks=[1, 1],
                        resnet_groups=4, patch_size_sub=4, compute_dtype="float32",
                        att_enc=[False, False], pretrain=False, edm_num_sample_steps=2,
                        timesteps=2)
    raw["Eval"].update(repeat=1, overlap=8)
    raw["Results"] = str(tmp_path / "results")
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path, raw


def test_train_entry_point_under_two_gloo_ranks(tmp_path):
    """(h) ``torchrun --nproc-per-node 2 -m diffusioniqt_tpu_torch.train
    --device cpu --fake-data``: a data mesh over the 2 ranks, the global
    batch of 2 patches (one whole group per rank), the logs and bundles
    written once, by rank 0."""
    cfg_path, raw = _tiny_config(tmp_path)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "diffusioniqt_tpu_torch.train", "--config", str(cfg_path), "--fake-data",
         "--device", "cpu", "--steps", "2", "--eval-every", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Training done") == 1
    assert "data-parallel over 2 ranks" in proc.stdout
    project = tmp_path / "results" / raw["ProjectName"]
    losses = (project / "train_log" / "train_loss.csv").read_text().splitlines()
    assert losses[0] == "loss" and len(losses) == 3
    assert all(np.isfinite(float(v)) for v in losses[1:])
    for name in ("checkpoint.pt", "last_checkpoint.pt"):
        sd = infer.load_unet_state_dict(str(project / "model" / name))
        assert all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point())
    assert not [n for n in os.listdir(project / "model") if ".tmp" in n]


@pytest.mark.parametrize("entry", ["infer", "evaluate"])
def test_mesh_entry_point_equals_one_process(entry, tmp_path, monkeypatch):
    """(i) ``infer`` / ``evaluate --mesh 2 --device cpu --fake-data`` (8
    windows in batches of 3: the last batch of 2 windows is one per rank,
    the others padded from 3 to 4) equal the one-process run on the same
    seed within 1e-5 relative (of the volume's largest entry; see
    :func:`test_sharded_sample_and_valid_step_equal_one_process`); rank 0
    alone writes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # for the spawned ranks
    cfg_path, _ = _tiny_config(tmp_path, "config/eval_config.yaml")
    outs = {}
    for mesh in (0, 2):
        out = tmp_path / f"mesh{mesh}"
        args = ["--config", str(cfg_path), "--fake-data", "--fake-edge", "20", "--device",
                "cpu", "--output-dir", str(out), "--patch-batch", "3", "--mesh", str(mesh)]
        if entry == "infer":
            infer.main(args)
            outs[mesh] = np.load(out / "volume_inf.npy")
        else:
            scores = evaluate.main(args)
            outs[mesh] = np.load(out / "fake0_inf.npy")
            assert scores is not None and len(scores["msssim"]) == 1
            outs[f"scores{mesh}"] = scores
        assert outs[mesh].shape == (20, 20, 20) and np.isfinite(outs[mesh]).all()
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-5,
                               atol=1e-5 * float(np.abs(outs[0]).max()))
    if entry == "evaluate":
        for key in ("msssim", "psnr"):
            np.testing.assert_allclose(outs["scores2"][key], outs["scores0"][key], rtol=1e-5)


class _ModelMesh:
    """A stand-in for a ``("data", "model")`` mesh of 1 x 2 ranks."""

    mesh_dim_names = ("data", "model")
    ndim = 2

    def __getitem__(self, name):
        return type("Axis", (), {"size": lambda self: 2 if name == "model" else 1})()


def test_more_ranks_than_cards_and_model_axis_raise(tmp_path, monkeypatch):
    """(j) ``--mesh 3`` where there are fewer cards, and an NCCL world
    larger than the card count, raise before any process starts or any
    group forms (no fallback to fewer ranks or to the CPU); a ``model``
    axis (tensor parallelism) builds a ``("data", "model")`` mesh of
    (1, 2) over 2 ranks; the rule raises NotImplementedError on a weight
    whose layer has no column split, and places ``UNet2D`` (column-parallel
    since its layers got the split) without raising."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg_path, _ = _tiny_config(tmp_path, "config/eval_config.yaml")
    for main in (infer.main, evaluate.main):
        with pytest.raises(RuntimeError, match="3 NCCL ranks on this host but 2"):
            main(["--config", str(cfg_path), "--fake-data", "--mesh", "3"])
    with pytest.raises(RuntimeError, match="3 NCCL ranks on this host but 2"):
        multihost.initialize_multihost("cuda", world_size=3, rank=0,
                                       init_method="tcp://127.0.0.1:1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="4 NCCL ranks on this host but 2"):
        multihost.initialize_multihost("cuda", world_size=4, rank=0,
                                       init_method="tcp://127.0.0.1:1")
    assert not torch.distributed.is_initialized()
    for got in _launch(_model_mesh_rank):
        assert got == (("data", "model"), (1, 2))
    with pytest.raises(NotImplementedError, match="no column split"):
        sharding.param_shardings(torch.nn.Conv2d(64, 64, 3), _ModelMesh())
    assert sharding.param_shardings(UNet2D(dim=8, dim_mults=(1, 2), channels=1), _ModelMesh())


def _model_mesh_rank(device):
    mesh = create_mesh(("data", "model"), (1, 2))
    return mesh.mesh_dim_names, tuple(mesh.shape)


def test_a_failing_rank_fails_the_parent_and_ends_the_others():
    """A rank that raises while the other waits in a collective: the parent
    raises with that rank's traceback well before the collective's own
    timeout and leaves no rank running."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one fails"):
        _launch(_failing_rank)


def _failing_rank(device):
    if multihost.process_index() == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()  # rank 0 waits for a rank that is gone


def test_fake_dataset_batches_are_the_same_on_every_rank():
    """Every rank loads the same global batch (the deterministic loader
    contract the mesh trainer relies on)."""
    a, b = FakeIQTDataset(size=4, length=4, seed=0), FakeIQTDataset(size=4, length=4, seed=0)
    for i in range(4):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)
