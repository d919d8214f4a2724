"""The EDM quality gate's data path and one full-width gate step, the port
(``diffusioniqt_tpu_torch/quality_run.py``) against the JAX tool it ports
(``tools/quality_run.py``).

The data path runs at the gate's own size: four 192^3 training phantoms,
their population z-score stats, the seeded crop stream of
``SyntheticIQTDataset`` through each trainer's shuffled loader, the 96^3 ->
27 x 32^3 split and the grouping into microbatches, at the JAX tool's
default batch (4 crops in 4 microbatches) and at the batch the gate runs
ran with (8 crops in 2). Both tools' ``main`` run one step with the
trainer's step function replaced by one that records its microbatches.

The full-width step (``slow``) holds eval_edm's U-Net (dim 64, mults
(1, 2, 4), squeeze-excite) of the port on the JAX init's weights against
the JAX package on the first 96^3 crop of the gate's first step (27 x
32^3, fp32, every ResnetBlock recomputed in the backward in both), with
the sigmas and noise the JAX trainer's step key draws. Run it with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gate_parity.py -m slow -s``
(about 11 minutes on 8 cores, with about 30 GB resident while the JAX
gradient runs); it prints the loss, the gradient's cosine, the seconds, and
the step-1 loss from the port's initialiser and from the JAX initialiser at
a few seeds.
"""

import csv
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.data import synthetic as jsyn
from diffusioniqt_tpu_torch import quality_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_SIZE, GATE_VOLUMES = 192, 4
# (batch_patches, accum): the JAX tool's defaults, and the gate runs' batch
# (QUALITY.md's round-5 command, and the port's first card run of the gate)
BATCHES = [(4, 4), (8, 2)]
# the port initialiser's seeds whose step-1 loss the full-width step prints
# (the gate's Train.seed is 42)
INIT_SEEDS = (42, 0, 1, 2)


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/quality_run.py``, imported in the test only; its
    import-time environment defaults are undone."""
    before = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_quality_run_gate", os.path.join(ROOT, "tools", "quality_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key in set(os.environ) - set(before):
        del os.environ[key]
    return module


@pytest.fixture(scope="module")
def gate_pairs():
    """The gate's training phantoms from each package, made once for the
    module: ``{"jax": [...], "port": [...]}``."""
    return {"jax": [jsyn.generate_pair(GATE_SIZE, seed=i) for i in range(GATE_VOLUMES)],
            "port": quality_run.training_pairs(GATE_SIZE, GATE_VOLUMES)}


class _Stop(Exception):
    """Ends the JAX tool's ``main`` after its training loop."""


def _jax_step_one(jax_tool, pairs, batch_patches, accum, out, monkeypatch):
    """The JAX tool's ``main`` for one step; returns its first step's
    microbatches as (accum, 27 * crops per microbatch, 32, 32, 32, 1) numpy
    arrays and its ``stats.json``."""
    captured = {}
    real_build = jax_tool.build_trainer

    def build(cfg, accum=4, remat=False, remat_policy=None):
        if captured:  # the evaluation trainer: training is over
            raise _Stop
        jt = real_build(cfg, accum=accum, remat=remat, remat_policy=remat_policy)
        jt.prepared, jt.use_ema = True, False
        jt.params, jt.opt_states = [None, None], [None, None]
        jt.save = lambda path: os.makedirs(path, exist_ok=True)

        def step_fn(index, acc):
            def fn(params, opt_state, key, hr, lr):
                captured.update(hr=np.asarray(hr), lr=np.asarray(lr), key=key)
                return params, opt_state, jnp.zeros(())
            return fn

        jt._build_train_step = step_fn
        captured["cfg"] = cfg
        return jt

    monkeypatch.setattr(jax_tool, "build_trainer", build)
    monkeypatch.setattr(jsyn, "generate_pair", lambda size, seed: pairs[seed])
    monkeypatch.setattr("sys.argv", [
        "quality_run.py", "--elucidated", "--sigma-data", "1.0", "--steps", "1",
        "--batch-patches", str(batch_patches), "--accum", str(accum),
        "--eval-volumes", "0", "--out", out])
    with pytest.raises(_Stop):
        jax_tool.main()
    with open(os.path.join(out, "stats.json")) as fh:
        captured["stats"] = json.load(fh)
    return captured


def _port_step_one(pairs, batch_patches, accum, out, monkeypatch):
    """The port tool's ``main`` for one step on the CPU; returns its first
    step's microbatches stacked as the JAX tool's are, and its
    ``stats.json``."""
    captured = {"hr": [], "lr": []}
    real_build = quality_run.build_trainer

    def build(cfg, **kw):
        trainer = real_build(cfg, **kw)
        zero = next(trainer.imagen.unets[1].parameters())

        def loss(index, hr, lr_img, draws):
            captured["hr"].append(hr.numpy().copy())
            captured["lr"].append(lr_img.numpy().copy())
            return zero.sum() * 0.0

        trainer._loss = loss
        trainer.save = lambda path: None
        captured["trainer"], captured["cfg"] = trainer, cfg
        return trainer

    monkeypatch.setattr(quality_run, "build_trainer", build)
    monkeypatch.setattr(quality_run, "generate_pair", lambda size, seed: pairs[seed])
    assert quality_run.main([
        "--elucidated", "--sigma-data", "1.0", "--steps", "1", "--batch-patches",
        str(batch_patches), "--accum", str(accum), "--eval-volumes", "0",
        "--device", "cpu", "--out", out]) is None
    with open(os.path.join(out, "stats.json")) as fh:
        captured["stats"] = json.load(fh)
    captured["hr"], captured["lr"] = np.stack(captured["hr"]), np.stack(captured["lr"])
    return captured


@pytest.mark.parametrize("batch_patches,accum", BATCHES)
def test_gate_data_path_matches_jax_at_gate_size(jax_tool, gate_pairs, batch_patches, accum,
                                                 tmp_path, monkeypatch):
    """The phantoms, the z-score stats, the step-1 crops and their grouping
    into microbatches are those of the JAX tool, bit for bit, at 192^3."""
    for (hr, lr), (jhr, jlr) in zip(gate_pairs["port"], gate_pairs["jax"]):
        np.testing.assert_array_equal(hr, jhr)
        np.testing.assert_array_equal(lr, jlr)
    want = _jax_step_one(jax_tool, gate_pairs["jax"], batch_patches, accum,
                         str(tmp_path / "jax"), monkeypatch)
    got = _port_step_one(gate_pairs["port"], batch_patches, accum, str(tmp_path / "port"),
                         monkeypatch)
    assert got["stats"] == want["stats"]
    for key in ("mean", "std", "mean_hr", "std_hr"):
        assert getattr(got["cfg"].data, key) == getattr(want["cfg"].data, key)
    assert want["hr"].shape == (accum, 27 * batch_patches // accum, 32, 32, 32, 1)
    assert got["hr"].shape == want["hr"].shape
    np.testing.assert_array_equal(got["hr"], want["hr"])
    np.testing.assert_array_equal(got["lr"], want["lr"])
    assert got["trainer"].steps[1] == 1


def test_gate_unet_draws_the_jax_initialisers_at_full_width(jax_tool):
    """The gate's U-Net (eval_edm's, dim 64) fresh from the port's
    initialiser against the JAX tool's trainer's own init, tensor by tensor,
    by ``tests/test_torch_init.py``'s criteria at full width: every tensor
    the JAX init zeroes is zero, every one it sets to one is one, every
    kernel lies within the initialiser's bound, and every kernel of at least
    2048 entries has a standard deviation within 10% of the JAX tensor's."""
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_init import _check

    jcfg = jax_tool.flagship_cfg(elucidated=True)
    jcfg.train.edm_sigma_data = 1.0
    jt = jax_tool.build_trainer(jcfg, accum=1)
    jt.prepare()
    want = state_dict_from_jax_params(jax.device_get(jt.params[1]))
    cfg = quality_run.flagship_cfg(elucidated=True, device="cpu")
    cfg.train.edm_sigma_data = 1.0
    port = quality_run.build_trainer(cfg, accum=1, device="cpu").imagen.unets[1]
    assert _check(port, want) >= 50
    got = port.state_dict()
    ratios = np.array([float(got[k].std() / w.std()) for k, w in want.items()
                       if k.endswith("weight") and w.dim() >= 2 and w.numel() >= 2048
                       and bool(torch.any(w != 0))])
    print(f"\n{ratios.size} kernels of >= 2048 entries, port std / JAX std: min "
          f"{ratios.min():.4f} median {np.median(ratios):.4f} mean {ratios.mean():.4f} "
          f"max {ratios.max():.4f}")


# the recorded EDM gate runs: r5 (the JAX package on a TPU v5e), the port
# on an H100 from torch's default initialiser, from flax's (Train.seed 42)
# and from r5's own initial weights (test_gate_bundle_from_the_jax_init)
GATE_RUNS = {name: os.path.join(ROOT, "results", d, "train_loss.csv")
             for name, d in (("r5", "quality_edm_r5"), ("torch init", "quality_edm_torch"),
                             ("flax init", "quality_edm_torch_flax_init"),
                             ("r5 init", "quality_edm_torch_jax_init"))}
# the first step of each window of PERF.md's table of the gate runs; the
# last window ends at the last step every run compared has
WINDOW_STARTS = (1, 50, 200, 400)


def _read_losses(path):
    """``{step: loss}`` of one ``train_loss.csv`` (``step,loss,seconds``)."""
    with open(path) as fh:
        return {int(r["step"]): float(r["loss"]) for r in csv.DictReader(fh)}


def _loss_windows(runs):
    """``{(first, last): {run: (mean, median)}}`` over ``WINDOW_STARTS``,
    printed as PERF.md's table (each mean's share of r5's beside it)."""
    end = min(max(r) for r in runs.values())
    rows = {}
    for lo, hi in zip(WINDOW_STARTS, WINDOW_STARTS[1:] + (end + 1,)):
        vals = {name: np.array([r[k] for k in range(lo, hi)]) for name, r in runs.items()}
        rows[lo, hi - 1] = {name: (float(v.mean()), float(np.median(v)))
                            for name, v in vals.items()}
        print(f"steps {lo}-{hi - 1}: " + "  ".join(
            f"{name} {m:.4f} / {md:.4f} ({m / rows[lo, hi - 1]['r5'][0]:.3f})"
            for name, (m, md) in rows[lo, hi - 1].items()))
    return rows


def test_loss_table_of_the_recorded_gate_runs():
    """PERF.md's table of the recorded gate runs: each run's mean and median
    loss over steps 1-49, 50-199, 200-399 and from 400 to the last step the
    runs share (first over all four, then over the three that reach 805),
    and the verdict read from it: from r5's own initial weights the port
    lies within 2% of r5's mean in every window to step 399, while the
    run from torch's default initialiser lies 35-55% below it."""
    runs = {name: _read_losses(path) for name, path in GATE_RUNS.items()}
    rows = _loss_windows(runs)
    end = min(max(r) for r in runs.values())
    assert list(rows) == [(1, 49), (50, 199), (200, 399), (400, end)] and end >= 400
    longer = _loss_windows({k: v for k, v in runs.items() if k != "r5 init"})
    assert list(longer)[-1][1] > end
    for window in [(1, 49), (50, 199), (200, 399)]:
        r5 = rows[window]["r5"][0]
        assert abs(rows[window]["r5 init"][0] / r5 - 1) < 0.02
        assert 0.45 < rows[window]["torch init"][0] / r5 < 0.65


def _edm_draws(key, hp, shape):
    """What ``ElucidatedImagen.forward`` draws from one microbatch key with
    the lowres noise augmentation off (elucidated.py:597,637-640)."""
    _, _, _, k_sigma, k_noise = jax.random.split(key, 5)
    return {"sigmas": torch.from_numpy(np.array(hp.noise_distribution(k_sigma, shape[0]))),
            "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32)))}


def _flat(grads):
    return torch.cat([g.reshape(-1).double() for _, g in sorted(grads.items())])


@pytest.mark.slow
def test_full_width_gate_step_matches_jax(jax_tool, gate_pairs, tmp_path, monkeypatch):
    """One gate step at full width on the CPU, the port against the JAX
    package on shared weights (the JAX trainer's init, carried over by
    ``state_dict_from_jax_params``) and shared draws: the loss within 1e-4
    relative and the gradient at whole cosine >= 0.9999. Then prints the
    loss of the port's own initialiser and of the JAX initialiser at
    ``INIT_SEEDS`` on the same crop and draws (forward only)."""
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

    crops = _port_step_one(gate_pairs["port"], 8, 2, str(tmp_path / "port"), monkeypatch)
    hr, lr = crops["hr"][0][:27], crops["lr"][0][:27]  # the first crop of step 1
    stats = crops["stats"]

    jcfg = jax_tool.flagship_cfg(elucidated=True)
    jcfg.train.edm_sigma_data = 1.0
    jcfg.data.mean, jcfg.data.std = stats["mean"], stats["std"]
    jt = jax_tool.build_trainer(jcfg, accum=1, remat=True)
    t0 = time.time()
    jt.prepare()  # the JAX trainer's own init of the full-width U-Net
    t_init = time.time() - t0
    key = jax.random.split(jt._next_key(), 1)[0]  # train_step's microbatch key
    imagen, params = jt.imagen, list(jt.params)

    def loss_fn(unet_params, hr, lr):
        return imagen.forward(params[:1] + [unet_params], key, hr, lr, unet_number=2,
                              deterministic=False, rngs={"dropout": key})

    t0 = time.time()
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params[1], jnp.asarray(hr),
                                                         jnp.asarray(lr))
    jloss, jgrads = float(jloss), jax.device_get(jgrads)
    t_jax = time.time() - t0
    want = state_dict_from_jax_params(jgrads)
    draws = _edm_draws(key, imagen.hparams[1], hr.shape)
    del jgrads

    cfg = quality_run.flagship_cfg(elucidated=True, device="cpu")
    cfg.train.edm_sigma_data = 1.0
    cfg.data.mean, cfg.data.std = stats["mean"], stats["std"]
    trainer = quality_run.build_trainer(cfg, accum=1, remat=True, device="cpu")
    unet = trainer.imagen.unets[1]
    unet.load_state_dict(state_dict_from_jax_params(jax.device_get(params[1])))
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        t0 = time.time()
        unet.train()
        loss = trainer.imagen.forward(torch.from_numpy(hr), torch.from_numpy(lr),
                                      unet_number=2, **draws)
        loss.backward()
        loss = float(loss.detach())
        t_port = time.time() - t0
    finally:
        torch.set_num_threads(threads)
    got = {k: p.grad for k, p in unet.named_parameters()}
    assert sorted(got) == sorted(want)
    g, w = _flat(got), _flat(want)
    cosine = float(g @ w / (g.norm() * w.norm()))
    rel = abs(loss - jloss) / abs(jloss)
    print(f"\nfull-width gate step (27 x 32^3, fp32, JAX init): loss port {loss:.6f} "
          f"JAX {jloss:.6f} (rel {rel:.2e}), gradient cosine {cosine:.7f}, "
          f"|g| port {float(g.norm()):.6e} JAX {float(w.norm()):.6e}; seconds: JAX init "
          f"{t_init:.1f}, JAX step {t_jax:.1f}, port step {t_port:.1f}")
    assert np.isfinite(jloss) and rel <= 1e-4
    assert cosine >= 0.9999

    # the same loss from the port's own initialiser at other seeds: how far
    # one init draw moves the step-1 loss (forward only)
    spread = {}
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        for seed in INIT_SEEDS:
            cfg.train.seed = seed
            other = quality_run.build_trainer(cfg, accum=1, device="cpu")
            with torch.no_grad():
                spread[seed] = float(other.imagen.forward(
                    torch.from_numpy(hr), torch.from_numpy(lr), unet_number=2, **draws))
    finally:
        torch.set_num_threads(threads)
    print("step-1 loss on the same crop and draws from the port's initialiser, by seed: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in spread.items()))
    assert all(np.isfinite(v) for v in spread.values())

    # and from the JAX initialiser at the same seeds, drawn as the JAX
    # trainer's prepare() draws from ImagenTrainer(seed=...); seed 42 is the
    # init the step above ran on
    forward = jax.jit(loss_fn)
    jspread = {}
    for seed in INIT_SEEDS:
        init = imagen.init_params(jax.random.split(jax.random.PRNGKey(seed))[1], 1)
        jspread[seed] = float(forward(init[1], jnp.asarray(hr), jnp.asarray(lr)))
    print("step-1 loss on the same crop and draws from the JAX initialiser, by seed: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in jspread.items()))
    assert abs(jspread[42] - jloss) <= 1e-4 * abs(jloss)
    assert all(np.isfinite(v) for v in jspread.values())


@pytest.mark.slow
def test_gate_bundle_from_the_jax_init(jax_tool, tmp_path):
    """The port's gate trainer (r5's batch: 2 microbatches, remat) holding
    the JAX tool's trainer's own initial weights, drawn from its key as
    r5's were, saved as a bundle that ``quality_run --resume`` trains from:
    on the card the bundle's CPU generator state is skipped, so the run
    keeps the draws and crops of a fresh run and changes only the initial
    weights. Written to ``$GATE_JAX_INIT_BUNDLE`` when set (under ``build/``,
    outside git), else under the test's temporary directory; its model and
    EMA are the converted JAX init."""
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

    jcfg = jax_tool.flagship_cfg(elucidated=True)
    jcfg.train.edm_sigma_data = 1.0
    jt = jax_tool.build_trainer(jcfg, accum=2, remat=True)
    jt.prepare()
    want = state_dict_from_jax_params(jax.device_get(jt.params[1]))
    cfg = quality_run.flagship_cfg(elucidated=True, device="cpu")
    cfg.train.edm_sigma_data = 1.0
    trainer = quality_run.build_trainer(cfg, accum=2, remat=True, device="cpu",
                                        remat_policy="conv")
    trainer.imagen.unets[1].load_state_dict(want)
    trainer.prepare()  # Adam's zero moments, the EMA copies of the loaded weights
    path = os.environ.get("GATE_JAX_INIT_BUNDLE") or str(tmp_path / "jax_init.pt")
    trainer.save(path)
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    assert [int(v) for v in bundle["steps"]] == [0, 0]
    for k, v in want.items():
        assert torch.equal(bundle["model"][f"unets.1.{k}"], v)
        assert torch.equal(bundle["ema"][f"1.ema_model.{k}"], v)

