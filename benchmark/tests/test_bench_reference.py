"""The plain reference and the work arithmetic against the port's plain path
on the CPU, at tiny widths in fp32: a denoiser forward of each
configuration, one ancestral step, one train step's loss and gradients,
the phantom generator, the window gather and the trim stitch, and the FLOP
count against the port's ``utils/flops.py``."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch

from benchmark import harness, work
from benchmark.reference import data as ref_data
from benchmark.reference import diffusion as ref_diff
from benchmark.reference import unet as ref_unet
from benchmark.tests.tiny import CONFIGS, REPO, TINY_ARCH


def configs():
    return {name: json.load(open(path)) for name, path in CONFIGS.items()}


def tiny_port(name, mode="serve"):
    """The port's U-Net of configuration ``name`` at the tiny widths, fp32,
    plain kernels, weights from a seed; with the matching reference arch."""
    from diffusioniqt_tpu_torch.config import Config
    from diffusioniqt_tpu_torch.models.unet3d import SRUnet256, UNet3D
    from diffusioniqt_tpu_torch.ops.kernels import PLAIN

    cfg = configs()[name]
    arch = {**harness.arch(cfg, mode), **TINY_ARCH}
    if name == "srunet256-3d":
        unet = SRUnet256(channels=1, lowres_cond=True, dim=8, init_dim=8, dim_mults=(1, 2),
                         num_resnet_blocks=(1, 1), init_patch_size=2, img_size=24,
                         attn_dim_head=4, attend_at_middle_heads=2)
    else:
        c = Config.from_dict(cfg["modes"][mode]["program_config"]).train
        unet = UNet3D(dim=8, init_dim=8, dim_mults=(1, 2), num_resnet_blocks=(1, 1), channels=1,
                      lowres_cond=True, use_se_attn=c.use_se, boundary=c.boundary,
                      batch_sample=c.batch_sample, batch_sample_factor=3, deep_feature=False,
                      att_type="linear", init_cross_embed=False, dtype=torch.float32)
    unet.use_ops(PLAIN)
    weights = harness.make_weights(ref_unet.param_shapes(arch), 11, "cpu")
    unet.load_state_dict(weights)
    return unet.eval(), weights, arch


def inputs(rows, edge=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, edge, edge, edge, 1), generator=g)
    lowres = torch.randn((rows, edge, edge, edge, 1), generator=g)
    return x, ref_diff.log_snr(torch.rand((rows,), generator=g)), lowres


@pytest.mark.parametrize("name", ["iqt-sr-unet", "srunet256-3d"])
def test_reference_forward_matches_the_port(name):
    unet, weights, arch = tiny_port(name)
    x, lsnr, lowres = inputs(54)
    with torch.no_grad():
        got = unet(x, None, lsnr, lowres_cond_img=lowres)
        want = ref_unet.forward(weights, arch, x, lsnr, lowres)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_param_shapes_are_the_ports_at_full_width():
    from diffusioniqt_tpu_torch.models.unet3d import SRUnet256, iqt_unet_from_config

    cfg = configs()
    with torch.device("meta"):
        iqt = iqt_unet_from_config(harness.program_config(cfg["iqt-sr-unet"], "serve"),
                                   device="meta")
        sr = SRUnet256(channels=1, lowres_cond=True)
    for model, c in ((iqt, cfg["iqt-sr-unet"]), (sr, cfg["srunet256-3d"])):
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert ref_unet.param_shapes(harness.arch(c, "serve")) == want
    assert sum(np.prod(s) for s in ref_unet.param_shapes(
        harness.arch(cfg["srunet256-3d"], "serve")).values()) == 941_050_665


def test_one_ancestral_step_matches_the_port():
    from diffusioniqt_tpu_torch.core.schedules import GaussianDiffusionContinuousTimes
    from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen

    min_bound = -0.72
    imagen = Imagen.__new__(Imagen)
    imagen.norm, imagen.min_bound, imagen.dynamic_thresholding_percentile = \
        "z-score", min_bound, 0.95
    imagen.can_classifier_guidance = False
    sched = GaussianDiffusionContinuousTimes("cosine", 20)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 8, 8, 8, 1), generator=g)
    pred = torch.randn((4, 8, 8, 8, 1), generator=g)
    eps = torch.randn((4, 8, 8, 8, 1), generator=g)
    grid = ref_diff.sampling_times(20, "cpu")
    for step in (0, 7, 19):
        t, tn = grid[step].expand(4), grid[step + 1].expand(4)
        got, _ = imagen.p_sample(lambda *a, **k: pred, x, t, noise=lambda shape: eps,
                                 noise_scheduler=sched, t_next=tn, pred_objective="x_start",
                                 dynamic_threshold=False)
        want = ref_diff.ancestral_step(x, pred, t, tn, eps, min_bound)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), step


def test_train_loss_and_gradients_match_the_port():
    from diffusioniqt_tpu_torch.config import Config
    from diffusioniqt_tpu_torch.diffusion.gaussian import imagen_from_config
    from diffusioniqt_tpu_torch.models.unet3d import NullUnet

    unet, weights, arch = tiny_port("iqt-sr-unet", "train")
    cfg = Config.from_dict(configs()["iqt-sr-unet"]["modes"]["train"]["program_config"])
    cfg.train.patch_size_sub = 8
    imagen = imagen_from_config(cfg, (NullUnet(), unet))
    hr, _, lowres = inputs(4, seed=5)
    g = torch.Generator().manual_seed(6)
    times, noise = torch.rand((4,), generator=g), torch.randn(hr.shape, generator=g)
    unet.train()
    loss = imagen.forward(hr, lowres, unet_number=2, times=times, noise=noise)[0]
    loss.backward()
    params = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    ref, _ = ref_diff.loss(params, arch, hr, lowres, times, noise, cfg.data.min_bound)
    ref.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    # a bias before a GroupNorm has a gradient of round-off: measured against
    # the median leaf's norm, as the cell's check measures it
    median = float(np.median([float(p.grad.norm()) for p in params.values()]))
    for name, p in unet.named_parameters():
        want = params[name].grad
        assert float((p.grad - want).norm()) <= 1e-4 * max(float(want.norm()), median), name


def test_reference_adam_matches_torch_adam():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(10, generator=g)
    grads = [torch.randn(10, generator=g) for _ in range(3)]
    mine = ref_diff.Adam({"w": w.clone()}, 1e-4)
    p = torch.nn.Parameter(w.clone())
    opt = torch.optim.Adam([p], lr=1e-4, betas=(0.9, 0.99), eps=1e-8)
    for gr in grads:
        mine.step({"w": gr})
        p.grad = gr.clone()
        opt.step()
    assert torch.allclose(mine.params["w"], p.detach(), rtol=0, atol=1e-9)


def test_phantoms_are_the_ports_bit_for_bit():
    from diffusioniqt_tpu_torch.data.synthetic import generate_pair

    for seed in (0, 2 ** 40 + 3):
        hr, lr = ref_data.generate_pair(32, seed)
        want_hr, want_lr = generate_pair(32, seed=seed)
        assert np.array_equal(hr, want_hr) and np.array_equal(lr, want_lr)


def test_window_gather_and_trim_stitch_match_the_port():
    from diffusioniqt_tpu_torch.data.datasets import SupervisedIQTInference
    from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher, gather_windows
    from diffusioniqt_tpu_torch.ops.volume import volume_to_subvolumes

    cfg = harness.program_config(configs()["iqt-sr-unet"], "serve")
    cfg.train.patch_size_sub, cfg.eval.overlap = 8, 8
    _, lr = ref_data.generate_pair(32, 4)
    ds = SupervisedIQTInference(cfg, lr_file=None, volume=lr)
    starts = ref_data.window_starts(lr, 24, 8)
    assert [tuple(s) for s in ds.valid_indices().tolist()] == starts
    vol = torch.from_numpy(ds.normalize(lr))
    want = volume_to_subvolumes(gather_windows(vol, starts, 24), 3)
    got = ref_data.gather_windows(torch.from_numpy(lr), starts, 24, 3, cfg.data.mean,
                                  cfg.data.std)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    wins = torch.randn((len(starts), 24, 24, 24))
    st = DeviceVolumeStitcher(lr.shape, 24, 8, fill_value=-0.7)
    st.add_batch(wins, starts)
    assert np.array_equal(st.result(),
                          ref_data.trim_stitch(lr.shape, wins, starts, 24, 8, -0.7).numpy())


@pytest.mark.parametrize("name", ["iqt-sr-unet", "srunet256-3d"])
def test_work_counts_the_ports_flops(name):
    from diffusioniqt_tpu_torch.utils.flops import flop_counts

    unet, _, arch = tiny_port(name)
    x, lsnr, lowres = inputs(27)
    with torch.no_grad():
        want = flop_counts(unet, x, None, lsnr, lowres_cond_img=lowres)
    got = work.forward_work(arch, 27, 8)
    assert (got["conv"], got["dot"]) == (want["conv"], want["dot"])


def test_flagship_forward_work():
    w = work.forward_work(harness.arch(configs()["iqt-sr-unet"], "serve"), 27, 32)
    assert round(w["conv"] / 1e9, 3) == 4971.735 and round(w["dot"] / 1e9, 3) == 51.803
    assert len(w["blocks"]) == 38


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("diffusioniqt_tpu_torch", "diffusioniqt_tpu",
                                               "jax", "flax", "jaxlib", "optax"), (path, n)
