"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

  env           torch / CUDA versions, the card's name and power limit
  build         nvcc builds the four kernels from ``diffusioniqt_tpu_torch/csrc``,
                one process per source, all started together
  kernels       each kernel against its plain PyTorch version at every shape
                the serve phases give it (bf16, batch 8 windows x 27
                sub-volumes; attention over 8 windows x 8 heads), with
                kernel, plain, library and bound times; kernel and library
                times are the median of 5 timings (min and max beside
                them), the plain version's one timing; the conv kernels
                are timed with a packed-weight cache filled before the
                timed loop, as the model calls them, and conv3d at both of
                its routes (small Cin on the path, the implicit GEMM at one
                wide shape); each fused shape also times cuDNN's conv alone
                on the already transformed input (conv_only_library_ms);
                and at factor 1, config/config.yaml's SAME convs on its 27
                sub-volumes: the halo at C 64 against F.pad (which
                computes it in one call) and the fused Block at 64->64
  forward       the full-width ``config/eval_config.yaml`` UNet3D (seeded
                random weights, bf16) on one 27 x 32^3 group, through the
                kernels and through the plain versions; launches per forward
                must be 38 fused blocks, 39 halos, 1 conv3d
  forward-attn  the same for ``diffusioniqt_tpu_torch/configs/eval_attn_softmax.yaml``
                (softmax attention in the three encoder slots and the
                middle, plus the mid ResnetBlock): 40 fused blocks, 41
                halos, 1 conv3d, 4 flash attentions
  forward-vit   that config with ``att_type: vit``: the same counts
  serve         ``diffusioniqt_tpu_torch.infer.infer_volume`` on a seeded fake
                128^3 volume: 8 windows of 96^3, 20 sampler steps, full width;
                launch counters are zeroed just before and read just after
  serve-attn    the same with the attention config
  edm-step      one EDM sampler call of two steps (one corrected Heun step,
                one Euler step: 3 forwards) over one 27 x 32^3 group with
                ``config/eval_edm.yaml`` at full width, through the kernels
                and through the plain versions with the same noise; launches
                3 x (39 halos, 1 conv3d, 38 fused blocks), agreement within
                FORWARD_REL_TOL
  serve-edm     ``infer_volume`` with ``config/eval_edm.yaml`` on the fake
                128^3 volume: 8 windows in one sampler call, 64 Heun steps =
                127 forwards, full width, nothing cut; launches exactly 4953
                halos, 127 conv3d, 4826 fused blocks, 0 flash; seconds of the
                sampler call, ms per forward and per Heun step
  stitch        125 seeded window predictions on the card (the users' 240^3
                volume at overlap 32) stitched by the host ``VolumeStitcher``
                and by ``DeviceVolumeStitcher`` in batches of 8 (the last
                ragged, padded, and dropped by ``valid``), trim (exact) and
                Gaussian (1e-6 relative), with the ms of each
  metrics       ``evaluate.evaluate`` (centre-cropped MS-SSIM and PSNR) of the
                serve-edm output against the fake highres volume on the card
                and on the CPU, agreeing to 1e-5 relative
  train-step    the EDM loss of ``config/eval_edm.yaml`` and its backward on one
                27 x 32^3 microbatch at full width (seeded weights and draws),
                through the kernels (launches exactly 39 / 1 / 38 / 0) and
                through the plain versions: the loss within FORWARD_REL_TOL,
                every gradient within the GRAD_* bounds; again with
                ``Train.remat`` (launches 77 / 1 / 76 / 0): gradients equal to
                the remat-off ones of the kernel path
  train         ``ImagenTrainer`` (built as ``python -m diffusioniqt_tpu_torch.train``
                builds it) on two seeded 128^3 synthetic phantom pairs: 4 patches
                of 96^3 per optimizer step in 4 microbatches of 27 x 32^3, 10
                steps; finite losses, launches exactly 10 x 4 x (39, 1, 38, 0),
                the EMA equal to the online weights after the update of step
                10, every packed-weight cache equal to a fresh pack of its
                weight after the last step; seconds per step (median of steps 2-10), patches per
                second, the backward's share of a microbatch (CUDA events),
                peak device memory
  train-serve   the trainer saved to a ``.pt`` bundle and served by
                ``infer.build_sampler`` (its EMA weights): a 2-step EDM sampler
                call over one window equals, bit for bit, the same call on
                the trainer's EMA module with the same noise; then the
                optimizer step + EMA update time
  quality       the quality gate's code (``diffusioniqt_tpu_torch.quality_run``
                and ``quality_eval``) at the gate's width and step shape, cut
                in length only: the EDM flagship (sigma_data 1.0) on two seeded
                128^3 phantoms, 8 patches of 96^3 per step in 2 microbatches
                of 108 x 32^3 with remat, 4 steps (launches exactly 2 x (77,
                1, 76, 0) per step; seconds per step, patches per second,
                backward share, peak memory); the bundle loaded into a fresh
                trainer equals the saving one bit for bit (parameters, EMA,
                Adam moments, steps, generator), one more step on the same
                batch gives both the same loss; ``quality_eval`` of the bundle
                over one held-out 128^3 phantom (one 64-step Heun call of 8
                windows, EMA weights) writes the report's keys
  train-base    ``config/config.yaml`` as ``python -m diffusioniqt_tpu_torch.train``
                reads it (x_start loss, every 3^3 conv a SAME conv: the
                halo kernel at factor 1), full width, cuDNN's TF32 on as the
                entry point runs it: one microbatch of 27 independent 32^3
                patches, its loss and gradients through the kernels against
                the plain path (remat on there) under train-step's limits,
                launches exactly 39 / 1 / 38 / 0; then 4 optimizer steps of
                108 patches of 32^3 in 4 microbatches on two seeded 128^3
                phantoms (launches exactly 4 x 4 x (39, 1, 38, 0)): seconds
                per step (median of steps 2-4), patches per second, peak
                memory, a microbatch's forward and backward
  train-lpips   the same with ``Train.lpips`` (VGG16-LPIPS over 216 slices of
                224^2 per microbatch, the fixed-seed proxy), and the term's
                share of a step against train-base and its forward's ms
  train-medlpips  the same with ``Train.medlpips`` (MedicalNet ResNet-10)
  evaluate-lpips  ``evaluate --fake-data --lpips`` of one fake 96^3 subject
                on the card; its LPIPS equals the CPU's on the same
                prediction within 1e-4 relative (fp32 convs on both)

``python3 chip_smoke.py --profile`` also prints a ``torch.profiler``
breakdown of one forward of each of the two configs at the serve batch,
8 x 27 x 32^3 (device time by kernel, device busy share), and of one
training microbatch's forward and backward (27 x 32^3) in the train phase
and in each of the three config.yaml cells. Without it too,
train-step profiles one microbatch's forward and backward and fails if any
``indexing_backward`` / ``index_put`` kernel runs: the Block's backward is
the plain composition, which gathers nothing.
``python3 chip_smoke.py --kernels-only`` stops after the kernels phase and
prints no result line: a copy of this script placed in another checkout of
the repository times that checkout's kernels the same way.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
the serve run of its path, serve-edm for the conv kernels and serve-attn for
flash attention, with every serve run's and the train run's count beside
them, max abs error
against the plain version, times
in ms at the main path's heaviest shape for that kernel, the bound and what
sets it; for the halo and the fused Block also a ``factor1`` row with the
train-base launches); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of ``diffusioniqt_tpu``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
# |kernel - plain| <= BF16_TOL * max|plain|: both sides round fp32 sums to
# bf16 (half an ulp each, 2^-9 relative) after summing in different orders,
# and the fused kernel's bf16 activations may round one ulp apart where
# __expf and torch.exp differ in the last bit.
BF16_TOL = 2.0 ** -7
# whole forward, kernels vs plain versions: bf16 rounding differences
# compound through 39 convs, 19 GroupNorms and the SE gates
FORWARD_REL_TOL = 5e-2
# flash attention: the kernel rounds the unnormalised probabilities to bf16
# before P V and the plain version the normalised ones (2^-9 relative per
# term, averaging out over the 1728 terms of a row), and each side rounds
# its output to bf16 once. The outputs may then differ by one bf16 ulp,
# which at any magnitude m <= max|plain| is at most 2^-7 * max|plain|.
FLASH_TOL = 2.0 ** -7
# the device stitch against the host one: trim copies (exact); Gaussian
# accumulates the same fp32 products in the same order
STITCH_GAUSS_REL_TOL = 1e-6
# the metrics on the card against the CPU: fp32 reductions in other orders
METRICS_REL_TOL = 1e-5
# gradients of the train-step microbatch, kernels vs plain versions. Both
# backward passes are the same plain VJPs; what differs is the forward that
# fed them: the kernel forward and the plain one round fp32 sums to bf16 in
# other orders (BF16_TOL per kernel, FORWARD_REL_TOL over a forward), so the
# saved activations and the cotangents differ by bf16-level noise that does
# not cancel in the gradient sums. The whole gradient (every tensor
# concatenated) must point the same way and have the same length, and each
# tensor must keep its direction. Readings on an H100 (torch 2.11, the
# seeded weights and draws of this phase, the same in four runs): whole
# cosine 0.999999, norm 1.07e-5 relative, worst tensor cosine 0.99998
# (an SE gate's weight). Each limit leaves about 50-100x room in
# 1 - cosine or in the norm: a kernel that drops or corrupts one tensor's
# share of the gradient falls outside.
GRAD_GLOBAL_COS_MIN = 0.9999
GRAD_GLOBAL_NORM_REL_TOL = 1e-3
GRAD_TENSOR_COS_MIN = 0.999

SUB = 32                 # sub-volume edge on the main path
GROUP = 27               # one 96^3 window = 27 sub-volumes
WINDOWS = 8              # windows per sampler call in the serve phase
BATCH = GROUP * WINDOWS  # the kernels' batch on the serve path
HALO_SHAPES = [(32, 2), (32, 64), (32, 128), (16, 64), (16, 128), (16, 192), (8, 128),
               (8, 256)]
# (s, Cin, Cout): the init conv (small-Cin route) and one wide shape that
# holds the implicit-GEMM route, which no conv3d call of the path takes
CONV_SHAPES = [(32, 2, 64), (16, 64, 64)]
FUSED_SHAPES = [(32, 64, 64), (32, 128, 64), (16, 64, 64), (16, 192, 128),
                (16, 128, 128), (8, 128, 128), (8, 256, 256)]
# every attention slot of the attention config: 8 windows x 8 heads, 12^3
# patch tokens, head dim 64
FLASH_SHAPES = [(WINDOWS * 8, 1728, 64)]
REPLACES = {
    "halo": "diffusioniqt_tpu/ops/pallas/halo.py:103",
    "conv3d": "diffusioniqt_tpu/ops/pallas/conv3d.py:83",
    "fused_block": "diffusioniqt_tpu/ops/pallas/fused_block.py:272",
    "flash_attention": "diffusioniqt_tpu/ops/pallas/flash_attention.py:90",
}
HEADLINE = {"halo": (32, 64), "conv3d": (32, 2, 64), "fused_block": (32, 64, 64),
            "flash_attention": (1728, 64)}
# factor 1 (config/config.yaml's SAME convs) at its 27-sub-volume microbatch:
# the halo at the heaviest activation, and the heaviest fused Block
HALO_F1_SHAPE, FUSED_F1_SHAPE = (32, 64), (32, 64, 64)
FLAGSHIP_CONFIG = os.path.join("config", "eval_config.yaml")
TRAIN_CONFIG = os.path.join("config", "config.yaml")
EDM_CONFIG = os.path.join("config", "eval_edm.yaml")
ATTN_CONFIG = os.path.join("diffusioniqt_tpu_torch", "configs", "eval_attn_softmax.yaml")
# launches per forward of one 27-sub-volume group
FLAGSHIP_COUNTS = {"halo": 39, "conv3d": 1, "fused_block": 38, "flash_attention": 0}
ATTN_COUNTS = {"halo": 41, "conv3d": 1, "fused_block": 40, "flash_attention": 4}
# launches per microbatch forward + backward with Train.remat: each of the
# 19 ResnetBlocks is recomputed in the backward, its 2 halos and 2 fused
# blocks launched again; the init conv and its halo are not in a block
REMAT_COUNTS = {"halo": 1 + 2 * 38, "conv3d": 1, "fused_block": 2 * 38, "flash_attention": 0}
# the train phase, as tools/quality_run.py trains the EDM flagship: 96^3
# patches per optimizer step, microbatches per step (27 x 32^3 each), steps
# (the EMA is applied every 10th), and the synthetic phantoms' edge and count
TRAIN_PATCHES, TRAIN_ACCUM, TRAIN_STEPS = 4, 4, 10
PHANTOM_EDGE, PHANTOMS = 128, 2
# the quality gate's step (QUALITY.md:37-45): 8 patches in 2 microbatches
# of 108 x 32^3 with remat, EDM sigma_data 1.0; this many steps
QUALITY_PATCHES, QUALITY_ACCUM, QUALITY_STEPS, QUALITY_SIGMA_DATA = 8, 2, 4, 1.0
# config/config.yaml's training (x_start, SAME convs, 27 independent 32^3
# patches per microbatch): patches per optimizer step, microbatches, steps
BASE_PATCHES, BASE_ACCUM, BASE_STEPS = 4 * GROUP, 4, 4
# LPIPS of evaluate on the card against the CPU: both run the VGG's convs
# in fp32 (TF32 off), summed in other orders through 13 convs; the distance
# is a sum of squared differences of unit-normalised features
LPIPS_REL_TOL = 1e-4
# keys of tools/quality_eval.py's report and of each held-out volume's row
QUALITY_EVAL_KEYS = {"ckpt", "steps", "stitch", "sampler", "edm_s_churn", "edm_sigma_data",
                     "volumes", "pred_beats_lr_msssim", "pred_beats_lr_psnr"}
QUALITY_ROW_KEYS = {"volume", "pred_msssim", "pred_psnr", "lr_msssim", "lr_psnr", "seconds",
                    "stitch"}
# device kernels of an accumulating scatter: the backward of a gather
SCATTER_KERNELS = ("indexing_backward", "index_put")
# device-kernel names of each hand-written kernel, for the profile's layers
LAYERS = {"fused_block": ("igemm::conv_sm90<true",),
          "conv3d": ("small_cin_kernel", "igemm::conv_sm90<false"),
          "halo": ("halo_row_kernel",), "flash_attention": ("flash_kernel",)}
# the one PyTorch call timed beside each kernel as its library yardstick
LIBRARY = {"halo": "index_select gather from a precomputed source table",
           "conv3d": "F.conv3d (cuDNN)",
           "fused_block": "none: no single PyTorch call computes GroupNorm-affine + "
                          "Mish + halo'd conv (conv_only_library_ms: F.conv3d, cuDNN, on "
                          "the transformed input materialised beforehand)",
           "flash_attention": "F.scaled_dot_product_attention"}


def phase(name: str) -> float:
    print(f"=== {name}", flush=True)
    return time.perf_counter()


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, repeats: int = 5, **kw):
    """(median, min, max) of ``repeats`` timings of :func:`cuda_time_ms`."""
    runs = sorted(cuda_time_ms(fn, **kw) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def fmt(t) -> str:
    return "null" if t is None else f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]"


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, shape, got, want, tol_rel: float) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = tol_rel * scale
    ok = err <= tol
    print(f"  {name} {shape}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"(max|plain|={scale:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with plain version")
    return {"max_abs_err": err, "tol": tol}


def slots_ms(fn, modules) -> float:
    """Device time inside ``modules`` during one ``fn()``: CUDA events that
    forward hooks record around each call (one stream, and the modules do
    not nest, so each pair of events brackets one module's kernels)."""
    events = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    hooks = [h for m in modules for h in (m.register_forward_pre_hook(mark),
                                          m.register_forward_hook(mark))]
    fn()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return sum(a.elapsed_time(b) for a, b in zip(events[::2], events[1::2]))


def profile_forward(label: str, fn) -> None:
    """Device time of one ``fn()`` by kernel name, and the device's busy
    share of the wall time (kernels on one stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_ms = cuda_time_ms(fn, iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {label}: {plain_ms:.3f} ms per call unprofiled, {wall_ms:.3f} ms "
          f"profiled; device busy {busy_ms:.3f} ms = {100 * busy_ms / plain_ms:.1f}% of "
          f"the unprofiled call")
    for layer, tags in LAYERS.items():
        ms = sum(r[1] for r in rows if any(t in r[0] for t in tags))
        print(f"  layer {layer}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)")
    other = sum(r[1] for r in rows
                if not any(t in r[0] for tags in LAYERS.values() for t in tags))
    print(f"  layer plain torch ops: {other:.3f} ms ({100 * other / busy_ms:.1f}% of busy)")
    for key, ms, count in rows[:25]:
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:4d}  {key[:100]}")


def scatter_ms(fn):
    """Device ms of :data:`SCATTER_KERNELS` kernels in one ``fn()``, and
    the device ms of all its kernels (so that an empty trace shows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    hits = [(k, ms) for k, ms in rows if any(t in k for t in SCATTER_KERNELS)]
    return sum(ms for _, ms in hits), sum(ms for _, ms in rows), hits


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from diffusioniqt_tpu_torch.config import load_config
    from diffusioniqt_tpu_torch.data.stitching import VolumeStitcher, sliding_window_grid
    from diffusioniqt_tpu_torch.data.synthetic import (
        SyntheticIQTDataset,
        generate_pair,
        population_stats,
    )
    from diffusioniqt_tpu_torch.diffusion.elucidated import elucidated_imagen_from_config
    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
    from diffusioniqt_tpu_torch.evaluate import evaluate
    from diffusioniqt_tpu_torch.infer import (
        build_sampler,
        fake_subjects,
        fake_volumes,
        infer_volume,
    )
    from diffusioniqt_tpu_torch.models.unet3d import NullUnet, iqt_unet_from_config
    from diffusioniqt_tpu_torch.train.__main__ import build_trainer
    from diffusioniqt_tpu_torch.train.ema import ema_update
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.ops.kernels import fused_block as fused_module
    from diffusioniqt_tpu_torch.ops.kernels import runtime
    from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight, conv3d_valid_plain
    from diffusioniqt_tpu_torch.ops.kernels.fused_block import (
        groupnorm_affine,
        neighbor_tables,
    )
    from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher
    from diffusioniqt_tpu_torch.ops.volume import halo_exchange as halo_plain

    def conv_route(cin):
        """conv3d's route at ``cin`` input channels (a checkout that predates
        the small-Cin route has the implicit GEMM only)."""
        from diffusioniqt_tpu_torch.ops.kernels import conv3d as conv_module
        return conv_module.route(cin) if hasattr(conv_module, "route") else "igemm"

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---------------------------------------------------------------- env
    phase("env")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # -------------------------------------------------------------- build
    t0 = phase("build")
    logs = runtime.build()
    for name, log in logs.items():
        info = [ln.strip() for ln in log.splitlines()
                if any(k in ln.lower() for k in ("registers", "spill", "error", "warning"))]
        print(f"  {name}: " + " | ".join(info[-12:]))
    for name in runtime.SOURCES:
        runtime.library(name)
    print(f"build seconds {time.perf_counter() - t0:.1f} "
          f"({len(logs)} compiled, dir {runtime._lib_path('halo').parent})", flush=True)

    # ------------------------------------------------------------ kernels
    t0 = phase("kernels")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, shape, stats, k_ms, p_ms, lib_ms, bnd, **extra):
        """``k_ms`` and ``lib_ms`` are :func:`timed` triples (``lib_ms``
        may be None), ``p_ms`` one timing; ``extra`` more timed triples."""
        row = {"shape": list(shape), **stats, "ms": k_ms[0], "ms_min": k_ms[1],
               "ms_max": k_ms[2], "plain_ms": p_ms,
               "library_ms": None if lib_ms is None else lib_ms[0],
               "library_ms_min": None if lib_ms is None else lib_ms[1],
               "library_ms_max": None if lib_ms is None else lib_ms[2],
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        for key, val in extra.items():
            row.update({key: val[0], f"{key}_min": val[1], f"{key}_max": val[2]})
        results.setdefault(name, []).append(row)
        more = "".join(f" {k}={fmt(v)}" for k, v in extra.items())
        print(f"    kernel_ms={fmt(k_ms)} plain_ms={p_ms:.4f} library_ms={fmt(lib_ms)}"
              f"{more} bound_ms={bnd[0]:.4f} ({bnd[1]})", flush=True)

    checked_gather = False
    for s, c in HALO_SHAPES:
        x = torch.randn((BATCH, s, s, s, c), generator=gen, device=dev).to(torch.bfloat16)
        got, want = kernels.halo_exchange(x, 3), halo_plain(x, 3)
        torch.cuda.synchronize()
        stats = compare("halo", (BATCH, s, s, s, c), got, want, 0.0)
        # the library yardstick: one gather. Built outside the timed loop: a
        # table of source voxels (the plain halo of the voxel ids; 0 is a
        # zero-padded voxel) and the source with one zero row appended
        ids = torch.arange(1, BATCH * s ** 3 + 1, device=dev).view(BATCH, s, s, s, 1)
        src_ids = halo_plain(ids, 3).flatten()
        idx = torch.where(src_ids == 0, BATCH * s ** 3, src_ids - 1)
        src = torch.cat([x.reshape(-1, c), x.new_zeros((1, c))])
        gather = lambda: torch.index_select(src, 0, idx)  # noqa: E731
        if not checked_gather:  # the gather is the kernel's function, exactly
            if not torch.equal(gather().view_as(got), got):
                raise AssertionError("halo: the gather yardstick disagrees with the kernel")
            print(f"  halo gather == kernel at {(BATCH, s, s, s, c)}: exact")
            checked_gather = True
        record("halo", (BATCH, s, c),
               stats, timed(lambda: kernels.halo_exchange(x, 3)),
               cuda_time_ms(lambda: halo_plain(x, 3)), timed(gather),
               bound_ms(0.0, nbytes(x, got)))
        del ids, src_ids, idx, src

    for s, cin, cout in CONV_SHAPES:
        xh = torch.randn((BATCH, s + 2, s + 2, s + 2, cin), generator=gen,
                         device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (27 * cin) ** -0.5
        cache = PackedWeight()  # filled by the first call, as in the model
        got, want = kernels.conv3d_valid(xh, w, cache), conv3d_valid_plain(xh, w)
        torch.cuda.synchronize()
        stats = compare("conv3d", (BATCH, s, cin, cout), got, want, BF16_TOL)
        w_bf = w.to(torch.bfloat16)
        x_cf = xh.permute(0, 4, 1, 2, 3)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        record("conv3d", (BATCH, s, cin, cout), stats,
               timed(lambda: kernels.conv3d_valid(xh, w, cache)),
               cuda_time_ms(lambda: conv3d_valid_plain(xh, w)),
               timed(lambda: torch.nn.functional.conv3d(x_cf, w_bf)),
               bound_ms(flops, nbytes(xh, w_bf, got)))
        results["conv3d"][-1]["kernel_route"] = conv_route(cin)
        del xh, got, want, x_cf

    for s, cin, cout in FUSED_SHAPES:
        x = torch.randn((BATCH, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
        ns = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev)
        nb = 0.1 * torch.randn(cin, generator=gen, device=dev)
        ss = tuple(0.2 * torch.randn((BATCH, 1, 1, 1, cin), generator=gen, device=dev)
                   for _ in range(2))
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
        a, b = groupnorm_affine(x, ns, nb, 8, scale_shift=ss)
        a_tab, b_tab = neighbor_tables(a, b, 3)
        xh = kernels.halo_exchange(x, 3)
        cache = PackedWeight()
        got = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
        want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
        torch.cuda.synchronize()
        stats = compare("fused_block", (BATCH, s, cin, cout), got, want, BF16_TOL)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        # the GEMM's floor: cuDNN's conv alone on mish(A_r * xh + B_r),
        # materialised in bf16 outside the timed loop
        reg = fused_module._region_index(s + 2, dev)
        act = fused_module.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
        act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w_bf = w.to(torch.bfloat16)
        del act
        record("fused_block", (BATCH, s, cin, cout), stats,
               timed(lambda: kernels.fused_conv(xh, a_tab, b_tab, w, cache)),
               cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
               None, bound_ms(flops, nbytes(xh, a_tab, b_tab, w_bf, got)),
               conv_only_library_ms=timed(lambda: torch.nn.functional.conv3d(act_cf, w_bf)))
        del act_cf, xh, got, want

    # factor 1, the SAME convs of config/config.yaml, at its microbatch of
    # 27 independent sub-volumes: the halo is zero padding, which one F.pad
    # call computes; the fused Block's tables hold the sub-volume's own
    # coefficients only
    s, c = HALO_F1_SHAPE
    x = torch.randn((GROUP, s, s, s, c), generator=gen, device=dev).to(torch.bfloat16)
    got, want = kernels.halo_exchange(x, 1), halo_plain(x, 1)
    torch.cuda.synchronize()
    stats = compare("halo factor 1", (GROUP, s, s, s, c), got, want, 0.0)
    pad = lambda: torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))  # noqa: E731
    if not torch.equal(pad(), got):
        raise AssertionError("halo factor 1: F.pad disagrees with the kernel")
    record("halo_f1", (GROUP, s, c), stats, timed(lambda: kernels.halo_exchange(x, 1)),
           cuda_time_ms(lambda: halo_plain(x, 1)), timed(pad), bound_ms(0.0, nbytes(x, got)))
    del x, got, want

    s, cin, cout = FUSED_F1_SHAPE
    x = torch.randn((GROUP, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
    ns = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev)
    nb = 0.1 * torch.randn(cin, generator=gen, device=dev)
    ss = tuple(0.2 * torch.randn((GROUP, 1, 1, 1, cin), generator=gen, device=dev)
               for _ in range(2))
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
    a, b = groupnorm_affine(x, ns, nb, 8, scale_shift=ss)
    a_tab, b_tab = neighbor_tables(a, b, 1)
    xh = kernels.halo_exchange(x, 1)
    cache = PackedWeight()
    got = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
    want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
    torch.cuda.synchronize()
    stats = compare("fused_block factor 1", (GROUP, s, cin, cout), got, want, BF16_TOL)
    reg = fused_module._region_index(s + 2, dev)
    act = fused_module.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
    act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    w_bf = w.to(torch.bfloat16)
    del act
    record("fused_block_f1", (GROUP, s, cin, cout), stats,
           timed(lambda: kernels.fused_conv(xh, a_tab, b_tab, w, cache)),
           cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
           None, bound_ms(2.0 * GROUP * s ** 3 * 27 * cin * cout,
                          nbytes(xh, a_tab, b_tab, w_bf, got)),
           conv_only_library_ms=timed(lambda: torch.nn.functional.conv3d(act_cf, w_bf)))
    del act_cf, xh, got, want

    for bh, n, d in FLASH_SHAPES:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = d ** -0.5
        got = kernels.flash_attention(q, k, v, scale)
        want = kernels.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        stats = compare("flash_attention", (bh, n, d), got, want, FLASH_TOL)
        # the library yardstick: one SDPA call over (windows, heads, N, D)
        q4, k4, v4 = (a.view(WINDOWS, bh // WINDOWS, n, d) for a in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        record("flash_attention", (bh, n, d), stats,
               timed(lambda: kernels.flash_attention(q, k, v, scale)),
               cuda_time_ms(lambda: kernels.attention_plain(q, k, v, scale), iters=3),
               timed(lambda: sdpa(q4, k4, v4, scale=scale)),
               bound_ms(4.0 * bh * n * n * d, nbytes(q, k, v, got)))
    print(f"kernels seconds {time.perf_counter() - t0:.1f}", flush=True)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernel_rows": results}))
        return 0

    def held_forward(label, cfg, want_counts, profile):
        """One 27 x 32^3 window through the kernels and through the plain
        versions: exact launch counts, agreement within FORWARD_REL_TOL."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = iqt_unet_from_config(cfg, device=dev).eval()
        x, lowres = (torch.randn((BATCH, SUB, SUB, SUB, 1), generator=gen, device=dev)
                     for _ in range(2))
        t = torch.full((BATCH,), 0.5, device=dev)
        log_snr = torch.full((BATCH,), -1.0, device=dev)
        if profile and "--profile" in sys.argv[1:]:
            with torch.no_grad():
                call = lambda: model(x, t, log_snr, lowres_cond_img=lowres)  # noqa: E731
                profile_forward(label, call)
                slots = [d[2] for d in model.downs if not isinstance(d[2], torch.nn.Identity)]
                slots += [model.mid_attn] if model.mid_attn is not None else []
                if slots:
                    print(f"  attention slots (CUDA events): {slots_ms(call, slots):.3f} ms "
                          f"of one forward, {len(slots)} slots", flush=True)
        # the held forward: one window's 27 sub-volumes
        x, lowres, t, log_snr = x[:GROUP], lowres[:GROUP], t[:GROUP], log_snr[:GROUP]
        with torch.no_grad():
            kernels.reset_launch_counts()
            out_k = model(x, t, log_snr, lowres_cond_img=lowres)
            torch.cuda.synchronize()
            per_forward = kernels.launch_counts()
            print(f"launches per forward {per_forward}")
            if per_forward != want_counts:
                raise AssertionError(f"launches per forward {per_forward}, "
                                     f"expected {want_counts}")
            fwd_ms = cuda_time_ms(lambda: model(x, t, log_snr, lowres_cond_img=lowres),
                                  iters=5, warmup=1)
            model.use_ops(kernels.PLAIN)
            out_p = model(x, t, log_snr, lowres_cond_img=lowres)
            plain_fwd_ms = cuda_time_ms(lambda: model(x, t, log_snr, lowres_cond_img=lowres),
                                        iters=2, warmup=0)
            model.use_ops(kernels.KERNELS)
        rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        print(f"forward out {tuple(out_k.shape)} {out_k.dtype} finite "
              f"{bool(torch.isfinite(out_k).all())} max_rel_err_vs_plain {rel:.3e} "
              f"(tol {FORWARD_REL_TOL})")
        print(f"ms per forward (27x32^3, bf16): kernels {fwd_ms:.3f} plain {plain_fwd_ms:.3f}",
              flush=True)
        if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError(f"{label}: forward through the kernels disagrees with "
                                 "the plain path")

    def serve(cfg, per_forward):
        """infer_volume on the seeded fake 128^3 volume; the launches must be
        ``per_forward`` times the forwards the sampler ran (one per step for
        the ancestral sampler, two per Heun step but the last one for EDM).
        Returns the launches, the prediction and the fake highres volume."""
        edge, windows_per_batch = 128, WINDOWS
        if cfg.train.elucidated:
            steps = cfg.train.edm_num_sample_steps
            nfe = 2 * steps - 1
        else:
            steps = nfe = cfg.train.timesteps
        imagen = build_sampler(cfg, device=dev, seed=0)
        lowres_vol, highres_vol = fake_volumes(cfg, edge, seed=0)
        noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
        call_s, sample = [], imagen.sample

        def timed_sample(**kw):  # the sampler calls alone, synchronised
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sample(**kw)
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
            return out

        imagen.sample = timed_sample
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t_serve = time.perf_counter()
        pred = infer_volume(cfg, imagen, lowres_vol, noise=noise,
                            patch_batch=windows_per_batch, verbose=False)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        served = kernels.launch_counts()
        n_windows = ((edge - cfg.train.patch_size) // cfg.eval.overlap + 1) ** 3
        n_calls = -(-n_windows // windows_per_batch)
        print(f"sampler {type(imagen).__name__} windows {n_windows} steps {steps} "
              f"forwards per call {nfe} width dim={cfg.train.dim} "
              f"mults={cfg.train.dim_mults} nothing cut")
        print(f"serve seconds {serve_s:.3f} ms per denoise step "
              f"{serve_s * 1e3 / (steps * n_calls):.3f} ({n_calls} sampler call(s) of "
              f"{min(n_windows, windows_per_batch)} windows)")
        print(f"sampler call seconds {' '.join(f'{s:.3f}' for s in call_s)}; ms per "
              f"forward (NFE) {sum(call_s) * 1e3 / (nfe * n_calls):.3f}, per step "
              f"{sum(call_s) * 1e3 / (steps * n_calls):.3f}")
        print(f"output {pred.shape} finite {bool(np.isfinite(pred).all())} "
              f"launches {served}", flush=True)
        want_counts = {k: n * nfe * n_calls for k, n in per_forward.items()}
        if pred.shape != (edge,) * 3 or not np.isfinite(pred).all():
            raise AssertionError("serve output is not a finite volume of the input's shape")
        if served != want_counts:
            raise AssertionError(f"serve launches {served}, expected {want_counts}")
        return served, pred, highres_vol

    def edm_step(cfg):
        """Two EDM steps (3 forwards) over one 27 x 32^3 group through the
        kernels and through the plain versions, with the same noise."""
        imagen = build_sampler(cfg, device=dev, seed=0)
        model = imagen.unets[-1]
        lowres = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)

        def run():
            noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
            return imagen.sample(batch_size=GROUP, noise=noise, start_at_unet_number=2,
                                 start_image_or_video=lowres)

        kernels.reset_launch_counts()
        out_k = run()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k: 3 * n for k, n in FLAGSHIP_COUNTS.items()}
        model.use_ops(kernels.PLAIN)
        out_p = run()
        model.use_ops(kernels.KERNELS)
        rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        print(f"edm 2 steps out {tuple(out_k.shape)} finite {bool(torch.isfinite(out_k).all())} "
              f"max_rel_err_vs_plain {rel:.3e} (tol {FORWARD_REL_TOL}) launches {counts}",
              flush=True)
        if counts != want:
            raise AssertionError(f"edm-step launches {counts}, expected {want}")
        if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError("edm-step: the sampler through the kernels disagrees "
                                 "with the plain path")

    def stitch():
        """The users' 240^3 volume at overlap 32: 125 seeded window
        predictions on the card, host and device stitch in both modes."""
        vol_shape, patch, overlap = (240,) * 3, 96, 32
        starts = sliding_window_grid(vol_shape, patch, overlap)
        preds = torch.randn((len(starts), patch, patch, patch), generator=gen, device=dev)
        for mode in ("trim", "gaussian"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = VolumeStitcher(vol_shape, patch, overlap, mode=mode, fill_value=-0.72)
            for b in range(0, len(starts), WINDOWS):
                outs = preds[b:b + WINDOWS].cpu().numpy()
                for j, idx in enumerate(starts[b:b + WINDOWS]):
                    host.add(outs[j], idx)
            want = host.result()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device = DeviceVolumeStitcher(vol_shape, patch, overlap, mode=mode,
                                          fill_value=-0.72, device=dev)
            for b in range(0, len(starts), WINDOWS):
                outs, idx = preds[b:b + WINDOWS], starts[b:b + WINDOWS]
                valid = np.ones(WINDOWS, bool)
                if len(idx) < WINDOWS:  # the ragged last batch, padded
                    pad = WINDOWS - len(idx)
                    valid[len(idx):] = False
                    outs = torch.cat([outs, torch.full_like(preds[:pad], 1e3)])
                    idx = np.concatenate([idx, starts[:pad]])
                device.add_batch(outs, idx, valid)
            got = device.result()
            device_ms = (time.perf_counter() - t0) * 1e3
            err = float(np.abs(got - want).max())
            tol = 0.0 if mode == "trim" else STITCH_GAUSS_REL_TOL * float(np.abs(want).max())
            print(f"stitch {mode} 240^3, {len(starts)} windows of {patch}^3 in batches of "
                  f"{WINDOWS}: host {host_ms:.1f} ms (incl. the per-batch copies back), "
                  f"device {device_ms:.1f} ms (incl. the one copy back); max_abs_err "
                  f"{err:.3e} tol {tol:.3e}", flush=True)
            if err > tol:
                raise AssertionError(f"stitch {mode}: device and host stitch disagree")

    def metrics(pred, highres):
        """evaluate() of the serve-edm output on the card and on the CPU."""
        gt = (highres - cfg_edm.data.mean) / cfg_edm.data.std
        border = min(32, (pred.shape[0] - 1) // 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = evaluate(pred, gt, border=border, device=dev)
        card_ms = (time.perf_counter() - t0) * 1e3
        on_cpu = evaluate(pred, gt, border=border, device="cpu")
        print(f"metrics (border {border}) on the card {on_card} in {card_ms:.1f} ms; "
              f"on the CPU {on_cpu} (random weights: no measure of quality)", flush=True)
        for key, want in on_cpu.items():
            if not abs(on_card[key] - want) <= METRICS_REL_TOL * abs(want):
                raise AssertionError(f"metrics: {key} on the card disagrees with the CPU")

    def grad_stats(got, want):
        """Per-tensor and whole-gradient cosine similarity and the whole
        gradient's relative norm difference. Two gradients that are both
        exactly zero (a squeeze-excite gate whose ReLU is dead for every
        sample of the microbatch, in both paths) agree: cosine 1; a zero
        gradient beside a nonzero one has cosine 0."""
        def cos(a, b):
            if not (a.any() or b.any()):
                return 1.0
            return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
        per = {k: cos(got[k].double(), want[k].double()) for k in want}
        dead = sorted(k for k in want if not (got[k].any() or want[k].any()))
        if dead:
            print(f"  gradients exactly zero in both paths: {dead}")
        g = torch.cat([got[k].double().flatten() for k in want])
        w = torch.cat([want[k].double().flatten() for k in want])
        return per, cos(g, w), float((g.norm() - w.norm()).abs() / w.norm())

    def assert_packs_fresh(model, label):
        """Every packed-weight cache of ``model`` hands the kernels the pack
        of its weight as it is now (no pack kept across an in-place update
        such as the optimizer's)."""
        from diffusioniqt_tpu_torch.ops.kernels.conv3d import pack_weight, pack_weight_small
        stale = [name for name, m in model.named_modules() if hasattr(m, "_packed")
                 and not torch.equal(m._packed.get(m.project.weight),
                                     pack_weight(m.project.weight))]
        w = model.init_conv.weight
        if not torch.equal(model._init_packed.get(w, pack_weight_small), pack_weight_small(w)):
            stale.append("init_conv")
        print(f"  {label}: packed weights fresh: {not stale}", flush=True)
        if stale:
            raise AssertionError(f"{label}: stale packed weights in {stale[:5]}")

    def train_step_phase(cfg):
        """The EDM loss and backward of one 27 x 32^3 microbatch at full
        width through the kernels and the plain versions with the same
        draws; then remat on. The plain path runs with remat on: its saved
        fp32 intermediates would hold some 50 GB without it, and remat
        changes no gradient of the plain path (tests/test_torch_train.py).
        cuDNN is held to deterministic algorithms here so that two backward
        passes can be compared bit for bit."""
        torch.backends.cudnn.deterministic = True
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = iqt_unet_from_config(cfg, device=dev)
        imagen = elucidated_imagen_from_config(cfg, (NullUnet().to(dev), model))
        hr = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
        lowres = hr + 0.1 * torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
        draws = {"sigmas": imagen.hparams[1].noise_distribution(gen, GROUP),
                 "noise": torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)}

        def run(ops, remat=False):
            model.use_ops(ops)
            model.remat = remat
            model.train().zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            loss = imagen.forward(hr, lowres, unet_number=2, **draws)
            loss.backward()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            return (loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                    counts)

        loss_k, grads_k, counts = run(kernels.KERNELS)
        _, grads_k2, _ = run(kernels.KERNELS)
        loss_p, grads_p, _ = run(kernels.PLAIN, remat=True)
        loss_r, grads_r, counts_r = run(kernels.KERNELS, remat=True)
        model.use_ops(kernels.KERNELS)
        model.remat = False
        torch.backends.cudnn.deterministic = False
        print(f"train-step loss kernels {loss_k:.6f} plain {loss_p:.6f} remat {loss_r:.6f}; "
              f"launches {counts}, with remat {counts_r}")
        if counts != FLAGSHIP_COUNTS:
            raise AssertionError(f"train-step launches {counts}, expected {FLAGSHIP_COUNTS}")
        if counts_r != REMAT_COUNTS:
            raise AssertionError(f"train-step remat launches {counts_r}, expected {REMAT_COUNTS}")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        per, cos_all, norm_rel = grad_stats(grads_k, grads_p)
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        print(f"  loss rel err {rel:.3e} (tol {FORWARD_REL_TOL}); gradients vs plain: whole "
              f"cos {cos_all:.6f} (min {GRAD_GLOBAL_COS_MIN}), norm rel {norm_rel:.3e} (tol "
              f"{GRAD_GLOBAL_NORM_REL_TOL}); per-tensor cos min {worst[0][1]:.5f} (min "
              f"{GRAD_TENSOR_COS_MIN}), worst {[(k, round(c, 5)) for k, c in worst]}")
        if not (math.isfinite(loss_k) and rel <= FORWARD_REL_TOL):
            raise AssertionError("train-step: the loss through the kernels disagrees with the plain path")
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > GRAD_GLOBAL_NORM_REL_TOL
                or worst[0][1] < GRAD_TENSOR_COS_MIN):
            raise AssertionError("train-step: gradients through the kernels disagree with the plain path")
        spread = max((grads_k2[k] - grads_k[k]).abs().max().item() for k in grads_k)
        remat_err = max((grads_r[k] - grads_k[k]).abs().max().item() for k in grads_k)
        print(f"  remat vs remat-off gradients (kernels): max abs diff {remat_err:.3e}; two "
              f"remat-off runs differ by {spread:.3e}", flush=True)
        if remat_err > spread or loss_r != loss_k:
            raise AssertionError("train-step: remat changes the gradients beyond the run-to-run "
                                 "spread of the backward")
        model.zero_grad(set_to_none=True)
        hit_ms, busy_ms, hits = scatter_ms(
            lambda: imagen.forward(hr, lowres, unet_number=2, **draws).backward())
        print(f"  profile of one microbatch's forward + backward: {busy_ms:.3f} device ms, of "
              f"which {hit_ms:.3f} ms in {SCATTER_KERNELS} kernels {hits}", flush=True)
        if busy_ms <= 0.0:
            raise AssertionError("train-step: the profiler recorded no device time")
        if hits:
            raise AssertionError("train-step: an accumulating scatter runs in the backward")
        del model, imagen, grads_k, grads_k2, grads_p, grads_r
        torch.cuda.empty_cache()

    def train_phase(cfg):
        """ImagenTrainer on synthetic phantoms, as tools/quality_run.py
        trains the EDM flagship; launches counted over the 10 steps only."""
        t_data = time.perf_counter()
        pairs = [generate_pair(PHANTOM_EDGE, seed=i) for i in range(PHANTOMS)]
        cfg.data.mean, cfg.data.std = population_stats([lr for _, lr in pairs])
        dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)
        trainer = build_trainer(cfg, dev)
        trainer.add_train_dataset(dataset, batch_size=TRAIN_PATCHES)
        print(f"phantoms {PHANTOMS} x {PHANTOM_EDGE}^3 in {time.perf_counter() - t_data:.1f} s; "
              f"{TRAIN_PATCHES} patches of {cfg.train.patch_size}^3 per step, accum "
              f"{trainer.gradient_accumulation_steps}, width dim={cfg.train.dim} "
              f"mults={cfg.train.dim_mults}, sigma_data {cfg.train.edm_sigma_data}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(unet_number=2, sync=False))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        want = {k: TRAIN_STEPS * TRAIN_ACCUM * n for k, n in FLAGSHIP_COUNTS.items()}
        ema_equal = all(torch.equal(e, p) for e, p in zip(trainer.ema_unets[1].parameters(),
                                                          trainer.imagen.unets[1].parameters()))
        med = sorted(step_s[1:])[len(step_s[1:]) // 2]
        print(f"train losses {' '.join(f'{v:.4f}' for v in losses)}")
        print(f"step seconds {' '.join(f'{v:.3f}' for v in step_s)}; median of steps 2-"
              f"{TRAIN_STEPS} {med:.4f} s, {TRAIN_PATCHES / med:.3f} patches/s of 96^3; peak "
              f"memory {peak / 2 ** 30:.2f} GiB; launches {counts} ({want['halo'] // TRAIN_STEPS} "
              f"halos per step); EMA == online after step {TRAIN_STEPS}: {ema_equal}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError("train: a loss is not finite")
        if counts != want:
            raise AssertionError(f"train launches {counts}, expected {want}")
        if trainer.ema_steps[1] != TRAIN_STEPS or not ema_equal:
            raise AssertionError("train: the EMA does not equal the online weights after the "
                                 "decay-0 update of step 10")
        assert_packs_fresh(trainer.imagen.unets[1], "train")
        # one more microbatch, for the split of its time (not counted above)
        hr, lr = trainer._maybe_batch_sample_split(*trainer._device_batch(
            next(iter(trainer.train_dl))))
        hr, lr = hr[:GROUP], lr[:GROUP]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        loss = trainer._loss(1, hr, lr, {})
        events[1].record()
        loss.backward()
        events[2].record()
        torch.cuda.synchronize()
        fwd, bwd = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
        print(f"microbatch (27 x 32^3): forward {fwd:.3f} ms, backward {bwd:.3f} ms, backward "
              f"share {bwd / (fwd + bwd):.3f}", flush=True)
        if "--profile" in sys.argv[1:]:
            profile_forward("train microbatch (forward + backward)",
                            lambda: trainer._loss(1, hr, lr, {}).backward())
        trainer.imagen.unets[1].zero_grad(set_to_none=True)
        return trainer, counts

    def train_serve(trainer, cfg):
        """The trainer's bundle served by build_sampler (EMA weights) against
        its EMA module, 2 EDM steps over one window with the same noise."""
        cfg.train.edm_num_sample_steps = 2
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            path = os.path.join(tmp, "trainer.pt")
            trainer.save(path)
            print(f"bundle {os.path.getsize(path) / 2 ** 20:.1f} MiB")
            served = build_sampler(cfg, device=dev, checkpoint=path)
        direct = elucidated_imagen_from_config(cfg, (NullUnet().to(dev), trainer.ema_unets[1]))
        lowres = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)

        def run(imagen):
            noise = gaussian_noise(torch.Generator(device=dev).manual_seed(5))
            return imagen.sample(batch_size=GROUP, noise=noise, start_at_unet_number=2,
                                 start_image_or_video=lowres)

        got, want = run(served), run(direct)
        err = (got - want).abs().max().item()
        print(f"served bundle vs trainer EMA module: out {tuple(got.shape)} finite "
              f"{bool(torch.isfinite(got).all())} equal {torch.equal(got, want)} max abs diff "
              f"{err:.3e}", flush=True)
        if not (torch.isfinite(got).all() and torch.equal(got, want)):
            raise AssertionError("train-serve: the served bundle differs from the trainer's EMA")
        # the optimizer update + EMA application of one step (gradients of
        # one more microbatch in place)
        unet, opt = trainer.imagen.unets[1], trainer.optimizers[1]
        loss = trainer._loss(1, lowres, lowres, {})
        loss.backward()
        ms = []
        for _ in range(3):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            opt.step()
            events[1].record()
            ema_update(trainer.ema_unets[1], unet, trainer.steps[1], **trainer.ema_kwargs)
            events[2].record()
            torch.cuda.synchronize()
            ms.append((events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])))
        n_params = sum(p.numel() for p in unet.parameters())
        print(f"optimizer step ms {' '.join(f'{a:.3f}' for a, _ in ms)}; EMA update ms "
              f"{' '.join(f'{b:.3f}' for _, b in ms)} ({n_params} parameters)", flush=True)

    def quality_phase():
        """The gate's training at its full step shape for QUALITY_STEPS steps,
        the bundle round trip, one resumed step, quality_eval of the bundle."""
        from diffusioniqt_tpu_torch import quality_eval, quality_run

        cfg = quality_run.flagship_cfg(elucidated=True, device=dev)
        cfg.train.edm_sigma_data = QUALITY_SIGMA_DATA
        pairs = quality_run.training_pairs(PHANTOM_EDGE, PHANTOMS)
        mean, std = population_stats([lr for _, lr in pairs])
        cfg.data.mean, cfg.data.std = mean, std
        cfg.data.mean_hr, cfg.data.std_hr = population_stats([hr for hr, _ in pairs])

        def gate_trainer():
            trainer = quality_run.build_trainer(cfg, accum=QUALITY_ACCUM, remat=True, device=dev)
            dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)
            trainer.add_train_dataset(dataset, batch_size=QUALITY_PATCHES)
            return trainer

        trainer = gate_trainer()
        per_step = {k: QUALITY_ACCUM * n for k, n in REMAT_COUNTS.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, total = [], [], {k: 0 for k in per_step}
        for _ in range(QUALITY_STEPS):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(unet_number=2, sync=False))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            counts = kernels.launch_counts()
            if counts != per_step:
                raise AssertionError(f"quality: launches per step {counts}, expected {per_step}")
            total = {k: total[k] + counts[k] for k in total}
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        med = sorted(step_s[1:])[len(step_s[1:]) // 2]
        print(f"gate step: {QUALITY_PATCHES} patches of 96^3 in {QUALITY_ACCUM} microbatches of "
              f"{QUALITY_PATCHES * GROUP // QUALITY_ACCUM} x 32^3, remat, sigma_data "
              f"{cfg.train.edm_sigma_data}, dim={cfg.train.dim}")
        print(f"gate losses {' '.join(f'{v:.4f}' for v in losses)}; step seconds "
              f"{' '.join(f'{v:.3f}' for v in step_s)}; s per gate step (median of steps 2-"
              f"{QUALITY_STEPS}) {med:.4f}, {QUALITY_PATCHES / med:.3f} patches/s of 96^3; peak "
              f"memory {peak / 2 ** 30:.2f} GiB; launches per step {per_step}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError("quality: a loss is not finite")

        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            ckpt = os.path.join(work, "ckpt.pt")
            quality_run.write_stats(work, mean, std, PHANTOM_EDGE, PHANTOMS,
                                    cfg.train.edm_sigma_data)
            trainer.save(ckpt)
            fresh = gate_trainer()
            fresh.load(ckpt)

            def same(a, b):
                return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

            def adam(trainer):
                state = trainer.optimizers[1].state_dict()["state"]
                return {f"{i}.{k}": v for i, st in state.items() for k, v in st.items()}

            checks = {
                "parameters": same(trainer.imagen.unets[1].state_dict(),
                                   fresh.imagen.unets[1].state_dict()),
                "EMA": same(trainer.ema_unets[1].state_dict(), fresh.ema_unets[1].state_dict()),
                "Adam moments": same(adam(trainer), adam(fresh)),
                "steps": (trainer.steps, trainer.ema_steps) == (fresh.steps, fresh.ema_steps),
                "generator": torch.equal(trainer.generator.get_state(),
                                         fresh.generator.get_state()),
            }
            print(f"bundle {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB at step {trainer.steps[1]}; "
                  f"loaded == saved: {checks}", flush=True)
            if not all(checks.values()):
                raise AssertionError(f"quality: the bundle round trip differs: {checks}")
            batch = next(iter(trainer.train_dl))
            resumed = []
            for t in (trainer, fresh):
                torch.manual_seed(0)
                resumed.append(t.train_step(unet_number=2, batch=batch))
            print(f"one more step on the same batch and draws: loss {resumed[0]:.6f} (saving "
                  f"trainer), {resumed[1]:.6f} (loaded one)", flush=True)
            if resumed[0] != resumed[1] or not math.isfinite(resumed[0]):
                raise AssertionError("quality: the resumed trainer's step gives another loss")
            # the backward's share of one gate microbatch (not counted above)
            hr, lr = trainer._maybe_batch_sample_split(*trainer._device_batch(batch))
            mb = hr.shape[0] // QUALITY_ACCUM
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            loss = trainer._loss(1, hr[:mb], lr[:mb], {})
            events[1].record()
            loss.backward()
            events[2].record()
            torch.cuda.synchronize()
            fwd, bwd = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
            print(f"gate microbatch ({mb} x 32^3, remat): forward {fwd:.3f} ms, backward "
                  f"{bwd:.3f} ms, backward share {bwd / (fwd + bwd):.3f}", flush=True)
            del trainer, fresh, loss
            torch.cuda.empty_cache()

            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            report = quality_eval.main(["--ckpt", ckpt, "--elucidated", "--size",
                                        str(PHANTOM_EDGE), "--eval-volumes", "1", "--out", work])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            evaluated = kernels.launch_counts()
            with open(os.path.join(work, "quality_eval.json")) as fh:
                written = json.load(fh)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        forwards = evaluated["conv3d"]
        rows = report["volumes"]
        print(f"quality_eval: {eval_s:.1f} s, {forwards} U-Net forwards, launches {evaluated}, "
              f"sampler {report['sampler']}, sigma_data {report['edm_sigma_data']}, steps "
              f"{report['steps']}; rows {rows} (untrained: no measure of quality)", flush=True)
        if not (QUALITY_EVAL_KEYS <= set(written) and len(rows) == 1
                and set(rows[0]) == QUALITY_ROW_KEYS
                and all(math.isfinite(rows[0][k]) for k in QUALITY_ROW_KEYS - {"stitch"})):
            raise AssertionError(f"quality: quality_eval's report is not the schema: {written}")
        if (report["steps"][1] != QUALITY_STEPS or report["edm_sigma_data"] != QUALITY_SIGMA_DATA
                or report["sampler"] != "edm-heun-64"):
            raise AssertionError("quality: quality_eval did not read the bundle and its stats")
        if forwards % (2 * 64 - 1) or evaluated != {k: forwards * n
                                                    for k, n in FLAGSHIP_COUNTS.items()}:
            raise AssertionError(f"quality: quality_eval launches {evaluated} are not whole "
                                 "64-step Heun calls through the kernels")
        return total, evaluated

    def base_config(flag, pairs):
        """``config/config.yaml`` as ``python -m diffusioniqt_tpu_torch.train``
        reads it, the perceptual term ``flag`` on (None: none), the z-score
        stats of the phantoms."""
        cfg = load_config(os.path.join(ROOT, TRAIN_CONFIG))
        if flag is not None:
            setattr(cfg.train, flag, True)
        cfg.data.mean, cfg.data.std = population_stats([lr for _, lr in pairs])
        return cfg

    def train_cell(flag, pairs, base=None):
        """``config/config.yaml``'s trainer with the perceptual term ``flag``:
        one 27 x 32^3 microbatch's loss and gradients through the kernels
        against the plain path (remat on, for its memory), launches exactly
        FLAGSHIP_COUNTS; then BASE_STEPS optimizer steps of BASE_PATCHES 32^3
        patches in BASE_ACCUM microbatches on the phantoms, launches exactly
        BASE_STEPS x BASE_ACCUM x FLAGSHIP_COUNTS; s per step, patches/s, peak
        memory, a microbatch's forward / backward and the term's forward
        (CUDA events). ``base``: train-base's result, for the term's share."""
        cfg = base_config(flag, pairs)
        trainer = build_trainer(cfg, dev)
        imagen, model = trainer.imagen, trainer.imagen.unets[1]
        term = imagen.lpips_fn
        if (term is None) != (flag is None):
            raise AssertionError(f"{flag}: the config's perceptual term was not built")
        hr = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
        lowres = hr + 0.1 * torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
        draws = {"times": torch.rand((GROUP,), generator=gen, device=dev),
                 "noise": torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)}

        def run(ops, remat=False):
            model.use_ops(ops)
            model.remat = remat
            model.train().zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            loss = imagen.forward(hr, lowres, unet_number=2, **draws)[0]
            loss.backward()
            torch.cuda.synchronize()
            return (loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                    kernels.launch_counts())

        loss_k, grads_k, counts = run(kernels.KERNELS)
        loss_p, grads_p, _ = run(kernels.PLAIN, remat=True)
        model.use_ops(kernels.KERNELS)
        model.remat = False
        model.zero_grad(set_to_none=True)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        per, cos_all, norm_rel = grad_stats(grads_k, grads_p)
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        del grads_k, grads_p
        print(f"microbatch 27 x 32^3 (x_start, SAME convs, term {flag}): loss kernels "
              f"{loss_k:.6f} plain {loss_p:.6f} (rel {rel:.3e}, tol {FORWARD_REL_TOL}); "
              f"launches {counts}; gradients: whole cos {cos_all:.6f} (min "
              f"{GRAD_GLOBAL_COS_MIN}), norm rel {norm_rel:.3e} (tol {GRAD_GLOBAL_NORM_REL_TOL}), "
              f"per-tensor cos min {worst[0][1]:.5f} (min {GRAD_TENSOR_COS_MIN}), worst "
              f"{[(k, round(c, 5)) for k, c in worst]}", flush=True)
        if counts != FLAGSHIP_COUNTS:
            raise AssertionError(f"{flag}: launches per microbatch {counts}, expected "
                                 f"{FLAGSHIP_COUNTS}")
        if not (math.isfinite(loss_k) and rel <= FORWARD_REL_TOL):
            raise AssertionError(f"{flag}: the loss through the kernels disagrees with the plain path")
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > GRAD_GLOBAL_NORM_REL_TOL
                or worst[0][1] < GRAD_TENSOR_COS_MIN):
            raise AssertionError(f"{flag}: gradients through the kernels disagree with the plain path")
        torch.cuda.empty_cache()

        dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=BASE_PATCHES // len(pairs),
                                      pairs=pairs)
        trainer.add_train_dataset(dataset, batch_size=BASE_PATCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(BASE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(unet_number=2, sync=False))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        want = {k: BASE_STEPS * BASE_ACCUM * n for k, n in FLAGSHIP_COUNTS.items()}
        med = sorted(step_s[1:])[len(step_s[1:]) // 2]
        # one more microbatch, for the split of its time (not counted above)
        hr, lowres = trainer._device_batch(next(iter(trainer.train_dl)))
        hr, lowres = hr[:GROUP], lowres[:GROUP]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        term_ms = (slots_ms(lambda: trainer._loss(1, hr, lowres, {}), [term])
                   if term is not None else 0.0)
        events[0].record()
        loss = trainer._loss(1, hr, lowres, {})
        events[1].record()
        loss.backward()
        events[2].record()
        torch.cuda.synchronize()
        fwd, bwd = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
        model.zero_grad(set_to_none=True)
        if "--profile" in sys.argv[1:]:
            profile_forward(f"config.yaml microbatch, term {flag} (forward + backward)",
                            lambda: trainer._loss(1, hr, lowres, {}).backward())
            model.zero_grad(set_to_none=True)
        share = "" if base is None else (
            f"; the term's share of a step {(med - base['s_per_step']) / med:.3f} (against "
            f"train-base's {base['s_per_step']:.4f} s)")
        print(f"{BASE_STEPS} steps of {BASE_PATCHES} patches of 32^3 in {BASE_ACCUM} "
              f"microbatches: losses {' '.join(f'{v:.4f}' for v in losses)}; step seconds "
              f"{' '.join(f'{v:.3f}' for v in step_s)}; median of steps 2-{BASE_STEPS} "
              f"{med:.4f} s, {BASE_PATCHES / med:.2f} patches/s; peak memory "
              f"{peak / 2 ** 30:.2f} GiB; launches {counts}{share}")
        print(f"microbatch (27 x 32^3): forward {fwd:.3f} ms (the term's forward {term_ms:.3f} "
              f"ms), backward {bwd:.3f} ms, backward share {bwd / (fwd + bwd):.3f}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{flag}: a loss is not finite")
        if counts != want:
            raise AssertionError(f"{flag}: launches {counts} over the steps, expected {want}")
        del trainer, imagen, model, term, loss
        torch.cuda.empty_cache()
        return {"s_per_step": med, "launches": counts}

    def evaluate_lpips():
        """``evaluate --fake-data --lpips`` of one fake 96^3 subject (one
        window, one 64-step Heun call) on the card; its LPIPS against the
        CPU's on the same prediction and ground truth."""
        from diffusioniqt_tpu_torch import evaluate as evaluate_module
        from diffusioniqt_tpu_torch.metrics.lpips import LPIPS, lpips_volume_metric

        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            t0 = time.perf_counter()
            res = evaluate_module.main(["--config", os.path.join(ROOT, EDM_CONFIG),
                                        "--fake-data", "--fake-edge", "96", "--lpips",
                                        "--output-dir", work])
            eval_s = time.perf_counter() - t0
            pred = np.load(os.path.join(work, "fake0_inf.npy"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        cfg = load_config(os.path.join(ROOT, EDM_CONFIG))
        _, highres = fake_subjects(cfg, 96, 1, seed=0)[0]
        b = res["border"]
        gt = ((highres - cfg.data.mean) / cfg.data.std)[b:-b, b:-b, b:-b]
        on_cpu = lpips_volume_metric(gt, pred[b:-b, b:-b, b:-b], LPIPS())
        on_card = res["lpips"][0]
        rel = abs(on_card - on_cpu) / abs(on_cpu)
        print(f"evaluate --lpips (1 fake 96^3 subject, border {b}): {eval_s:.1f} s; LPIPS"
              f"(random-features) on the card {on_card:.7f}, on the CPU {on_cpu:.7f}, rel "
              f"{rel:.3e} (tol {LPIPS_REL_TOL}); msssim {res['msssim'][0]:.4f} psnr "
              f"{res['psnr'][0]:.3f} (random weights: no measure of quality)", flush=True)
        if not (math.isfinite(on_card) and rel <= LPIPS_REL_TOL):
            raise AssertionError("evaluate-lpips: the card's LPIPS disagrees with the CPU's")

    cfg = load_config(os.path.join(ROOT, FLAGSHIP_CONFIG))
    cfg_attn = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit.train.att_type = "vit"
    cfg_edm = load_config(os.path.join(ROOT, EDM_CONFIG))
    cfg_edm_step = load_config(os.path.join(ROOT, EDM_CONFIG))
    cfg_edm_step.train.edm_num_sample_steps = 2

    phase("forward")
    held_forward("flagship", cfg, FLAGSHIP_COUNTS, profile=True)
    phase("forward-attn")
    held_forward("attention", cfg_attn, ATTN_COUNTS, profile=True)
    phase("forward-vit")
    held_forward("vit", cfg_vit, ATTN_COUNTS, profile=False)
    phase("serve")
    served, _, _ = serve(cfg, FLAGSHIP_COUNTS)
    phase("serve-attn")
    served_attn, _, _ = serve(cfg_attn, ATTN_COUNTS)
    phase("edm-step")
    edm_step(cfg_edm_step)
    phase("serve-edm")
    served_edm, pred_edm, highres_edm = serve(cfg_edm, FLAGSHIP_COUNTS)
    phase("stitch")
    stitch()
    phase("metrics")
    metrics(pred_edm, highres_edm)
    phase("train-step")
    train_step_phase(load_config(os.path.join(ROOT, EDM_CONFIG)))
    phase("train")
    trainer, trained = train_phase(load_config(os.path.join(ROOT, EDM_CONFIG)))
    phase("train-serve")
    train_serve(trainer, load_config(os.path.join(ROOT, EDM_CONFIG)))
    del trainer
    torch.cuda.empty_cache()
    phase("quality")
    gated, gate_evaluated = quality_phase()
    # config/config.yaml's training, with the cuDNN TF32 setting the
    # training entry point runs with (torch's default; the kernel checks
    # above hold fp32 references with it off)
    torch.backends.cudnn.allow_tf32 = True
    pairs = [generate_pair(PHANTOM_EDGE, seed=i) for i in range(PHANTOMS)]
    phase("train-base")
    cells = {"train-base": train_cell(None, pairs)}
    phase("train-lpips")
    cells["train-lpips"] = train_cell("lpips", pairs, base=cells["train-base"])
    phase("train-medlpips")
    cells["train-medlpips"] = train_cell("medlpips", pairs, base=cells["train-base"])
    torch.backends.cudnn.allow_tf32 = False
    phase("evaluate-lpips")
    evaluate_lpips()

    # ------------------------------------------------------------- report
    line = []
    for name in ("halo", "conv3d", "fused_block", "flash_attention"):
        rows = results[name]
        head = next(r for r in rows if tuple(r["shape"][1:]) == HEADLINE[name])
        extra = {k: head[k] for k in ("kernel_route", "conv_only_library_ms",
                                      "conv_only_library_ms_min", "conv_only_library_ms_max")
                 if k in head}
        f1 = results.get(f"{name}_f1")
        if f1:  # the factor-1 row: config/config.yaml's SAME convs
            extra["factor1"] = {
                k: f1[0][k] for k in ("shape", "max_abs_err", "ms", "ms_min", "ms_max",
                                      "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "library_ms_min", "library_ms_max",
                                      "conv_only_library_ms") if k in f1[0]}
            extra["factor1"]["launches_train_base"] = cells["train-base"]["launches"][name]
            extra["factor1"]["library"] = ("F.pad (zero padding)" if name == "halo"
                                           else LIBRARY[name])
        line.append({
            "name": name, "route": "cuda",
            "source": f"diffusioniqt_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            # the serve run of the kernel's own path: the flagship's EDM
            # sampler for the conv kernels, the attention config for flash
            "launches": (served_attn if name == "flash_attention" else served_edm)[name],
            "launches_by_path": {"serve": served[name], "serve-attn": served_attn[name],
                                 "serve-edm": served_edm[name], "train": trained[name],
                                 "quality": gated[name], "quality-eval": gate_evaluated[name],
                                 **{k: c["launches"][name] for k, c in cells.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": head["tol"],
            "ms": head["ms"], "ms_min": head["ms_min"], "ms_max": head["ms_max"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_ms_min": head["library_ms_min"],
            "library_ms_max": head["library_ms_max"], "library": LIBRARY[name],
            "shape": "x".join(str(v) for v in head["shape"]), **extra,
        })
    print(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
