"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

  env           torch / CUDA versions, the card's name and power limit
  build         nvcc builds the six kernel sources from ``diffusioniqt_tpu_torch/csrc``,
                one process per source, all started together
  kernels       each kernel against its plain PyTorch version at every shape
                the serve phases give it (bf16, batch 8 windows x 27
                sub-volumes; attention over 8 windows x 8 heads), with
                kernel, plain, library and bound times; kernel and library
                times are the median of 5 timings (min and max beside
                them; device time: the device sleeps while the host enqueues
                the timed calls), the plain version's one timing; the conv kernels
                are timed with a packed-weight cache filled before the
                timed loop, as the model calls them, and conv3d at both of
                its routes (small Cin on the path, the implicit GEMM at one
                wide shape); each fused shape also times cuDNN's conv alone
                on the already transformed input (conv_only_library_ms);
                and at factor 1, config/config.yaml's SAME convs on its 27
                sub-volumes: the halo at C 64 against F.pad (which
                computes it in one call) and the fused Block at 64->64;
                and the fused Block's small-edge kernel (with the halo) at
                every shape the presets launch it at (SMALL_EDGE_SHAPES:
                the efficient flagship's 4^3 x 256 at 216 and 27 rows,
                SRUnet256's 4^3 x 512, 4^3 1024->512 and 2^3 x 1024), each
                launched twice (identical bits required) and printed with
                its plan; then the brick route's headline row against the
                spread PERF.md records for it (fails outside it, widened by
                BRICK_ROUTE_MARGIN, on a card at the recorded power limit),
                and there once the whole-tap commit groups of the other
                64-wide Blocks' plan (a reading, not the route);
                flash attention at the attention config's (64, 1728, 64) and
                at serve-2d's (128, 3600, 32), and at attn-context's
                (64, Nq 1728, Nk 1744, 64); the fused Block at the column
                shards of tensor parallelism (TP_FUSED_SHAPES: Cout / M 32
                and 16 at 32^3, and the shard shapes tp-train launches) and
                the small-edge route at (216, 4^3, 256->128). The fused
                Block's brick-route rows (FUSED_SHAPES: every shape serve,
                serve-attn, serve-efficient and preset-srunet256 launch,
                each printed with its plan from ``brick_plan``: unit
                width, channels a chunk (kc), commit groups) at their
                own batch: 216 sub-volumes at factor 3, SRUnet256's 27 at
                factor 1. First, the Blocks' statistics and tables (the
                group_norm pair, GROUP_NORM_SHAPES: every (B, s, C, factor)
                that a recording path launches, which fails on any other)
                against the plain composition (GROUP_NORM_TOL), launched
                twice (identical bits required); 32^3 x 64 and x 128 at the
                serve batch also timed, with torch.var_mean over the group
                view as the library row and the profiler's split between the
                statistics and the tables kernel
  forward       the full-width ``config/eval_config.yaml`` UNet3D (seeded
                random weights, bf16) on one 27 x 32^3 group, through the
                kernels and through the plain versions; launches per forward
                must be 38 fused blocks, 38 group_norm, 39 halos, 1 conv3d
  forward-attn  the same for ``diffusioniqt_tpu_torch/configs/eval_attn_softmax.yaml``
                (softmax attention in the three encoder slots and the
                middle, plus the mid ResnetBlock): 40 fused blocks, 40
                group_norm, 41 halos, 1 conv3d, 4 flash attentions
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
                through the plain versions, whose squeeze-excite ReLUs
                keep the kernel path's branches (SEBranches): the loss within
                FORWARD_REL_TOL, every gradient within the GRAD_* bounds; again with
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
                backward share, peak memory); the step-1 loss beside the same
                first step (batch, draws) from torch's default initialisers,
                which the port drew before it took the JAX package's (flax's
                lecun_normal kernels, zero biases); the bundle loaded into a fresh
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
                the plain path (remat on there, SEBranches) under train-step's limits,
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
  ddp-train     data-parallel training (``parallel/``, the trainer's mesh
                branch): the EDM flagship at train-edm-96's shape, 2 crops
                of 96^3 per rank per step in 2 microbatches of 27 x 32^3,
                3 steps, the EMA applied every step. Ranks: NCCL over
                min(cards, 4) cards, or on one card 2 gloo ranks sharing it
                (NCCL takes one card per rank; such a run measures
                correctness and overhead, not scaling). Held against the
                1-rank trainer on the same global batches and seed: the
                first step's all-reduced gradient by train-step's criterion
                (whole cosine, per-tensor cosine; the norm within
                DDP_GRAD_NORM_REL_TOL), every loss within
                DDP_LOSS_REL_TOL (beside it, how far a rank's own rows'
                loss is off: what a loss left out of the all-reduce would
                read); the ranks' parameters and EMA bitwise equal
                after the steps; launches exactly 3 x 2 x (39, 1, 38, 0) per
                rank. Prints backend, world, s per step at W and at 1 rank,
                the all-reduce's ms (CUDA events and host clock) and bytes
                per step, peak memory per rank. Then ``torchrun
                --nproc-per-node 1 -m diffusioniqt_tpu_torch.train`` (a
                1-rank NCCL world through the entry point, 2 steps of the
                full-width EDM config on fake data)
  ddp-serve     the serve phase's run (``config/eval_config.yaml``, 8
                windows of the fake 128^3 volume, 20 ancestral steps) with
                ``infer_volume(mesh=...)`` over the same ranks: 4 windows
                per rank (on one card, 2 gloo ranks), gathered and stitched
                on rank 0; launches exactly 20 x (39, 1, 38, 0) per rank;
                the volume within DDP_SERVE_REL_TOL of the serve phase's
                1-rank volume; seconds at W ranks beside the serve phase's;
                then one ``sharded_sample`` call over the same 8 windows:
                the rows gathered from the ranks equal, bit for bit, one
                process sampling each rank's rows alone with the rows of
                the same global noise (and the difference one process
                shows between 108 and 216 rows per call is printed)

  tp-train      tensor-parallel training (the trainer's DP x TP branch: the
                column split of ``parallel/sharding.py``): the EDM flagship at
                full width over a (data 1, model 2) mesh of 2 gloo ranks
                sharing the card (gloo stages every collective through the
                host: correctness and overhead, not speed), 2 steps of 2
                crops of 96^3 in 2 microbatches of 27 x 32^3, the EMA every
                step. Held against the 1-rank trainer on the same weights,
                batches and draws: every loss within DDP_LOSS_REL_TOL of the
                free-running 1-rank trainer's, and step 2's also of the
                1-rank step from the mesh run's bundle of step 1 (saved
                under TP: the shards gathered); that bundle against the
                1-rank state after step 1 (parameters and EMA within
                TP_STEP1_LR_BOUND lr,
                Adam's first moments by the gradient criteria); the
                gradients of step 1 and of step 2 from that bundle gathered
                whole by ddp-train's criteria; the replicated parameters
                bitwise equal in each model group; the fused Block's launches exactly the 1-rank
                run's shapes at Cout / 2 (66 parameters sharded, 38 Blocks);
                the all-gathers and all-reduces per microbatch (count,
                bytes), peak memory per rank
  tp-serve      one EDM call (TP_SERVE_STEPS Heun steps) of one 96^3 window
                through ``ImagenTrainer.sample`` over the same 2 ranks,
                within DDP_SERVE_REL_TOL of the 1-rank call on the same
                weights and noise, the same launches at Cout / 2

  tp-2d         UNet2D at serve-2d's width (SERVE_2D, bf16, its convs,
                dense layers and q / k / v projections column-split) behind
                ``Imagen(spatial_dims=2)`` over a (data 1, model 2) mesh of
                the same ranks as tp-train, TP2D_SLICES slices of 240^2,
                against one process on the same weights and seeds: one
                forward within FORWARD_REL_TOL; one 20-step ancestral call
                (flash on all heads after the gather: 40 launches per rank)
                each of its U-Net calls within FORWARD_REL_TOL of one
                process's U-Net on that call's inputs (the chained result
                printed); one optimizer step, its squeeze-excite
                ReLUs pinned to one process's (SEBranches), the loss within
                DDP_LOSS_REL_TOL and the gathered gradient by ddp-train's
                criteria
  tp-video      Unet3DVideo at serve-video's width in fp32 with every weight
                of the rule column-split over the same ranks (its learned
                tokens kept whole): serve-video's forward within
                TP_VIDEO_REL_TOL of one process's, one EDM loss step of
                VIDEO_BATCH videos at TP_VIDEO_EDGE^2 (the loss within
                DDP_LOSS_REL_TOL, the gathered gradient by ddp-train's
                criteria; the global-context gates' to_k biases, whose exact
                gradient is zero, under 1e-6 of the largest entry); no
                hand-written kernel launches
  nifti-roundtrip  ``python -m diffusioniqt_tpu_torch.nifti_roundtrip --prepare
                --run`` at its smallest full size: one train, one valid and
                one test phantom of 256^3 as NIfTI, NIFTI_STEPS train steps
                and one gaussian-stitched ``evaluate`` of the test volume's
                240^3 crop, as subprocesses that print their launches last
                (the tool reports them): whole flagship
                forwards through the kernels in both, whole 20-step calls
                in evaluate, a finite prediction; the seconds of each stage
  flops         ``utils/flops.py`` over one flagship forward (27 x 32^3)
                through the kernels and through the plain versions: equal
                conv and matmul counts, the fused kernel's reported work
                equal to the forward phase's count of the Blocks' GFLOP
                (run after forward-efficient)
  edm-probe     ``python -m diffusioniqt_tpu_torch.edm_probe`` over the
                quality phase's bundle at ``--size 96`` (run inside
                quality): its table, finite, and exactly 12 flagship
                forwards' launches (two per sigma)

  forward-efficient  ``config/eval_config.yaml`` with ``Train.efficient: True``
                (a pixel-unshuffle before every level, levels at 16^3, 8^3
                and 4^3; every up level upsamples) at full width: one
                27 x 32^3 window through the kernels and the plain versions
                within FORWARD_REL_TOL; launches exactly EFFICIENT_COUNTS
                (the fused Block's small-edge route at 4^3), its small-edge
                shapes, and those of a forward at the serve batch, all in
                SMALL_EDGE_SHAPES; the Blocks' conv GFLOP beside the
                flagship's
  serve-efficient  the serve phase's ``infer_volume`` call (8 windows, 20
                ancestral steps) with that config; seconds and ms per
                forward beside the serve phase's. serve, serve-attn,
                serve-efficient and preset-srunet256's sampler call first
                record, from one untimed forward at their batch, the (B, s,
                Cin, Cout) of every brick-route Block they launch, and fail
                on one that FUSED_SHAPES does not hold
  edm-merged    edm-step's call with ``merged_boundary=True`` (the same
                weights and noise) against the split model: bit for bit,
                as merged mode runs on the split kernels
  missing-pieces  ``UpsampleCombiner`` at the flagship's widths on one
                window (27 x 32^3 x 64, the feature maps 16^3 x 128 and 8^3 x
                256 resized to 32^3, each through a 64-wide Block: the fused
                kernel's factor-1 route at 128->64 and 256->64), kernels
                against plain within BF16_TOL, launches exactly 2 halos and 2
                fused blocks; ``TrilinearUpsample`` (128->64 from 16^3) and
                ``StridedDownsample`` (64->128 from 32^3) against their fp32
                CPU output on 2 sub-volumes; ``Imagen([NullUnet(),
                UNet3D(lowres_cond=False)])`` at the flagship's config, whose
                cast unet 2 (the lowres-conditioned flagship) takes the
                flagship's weights: one 20-step ancestral call of one window
                equal bit for bit to the wrapper built around the flagship
  train-remat-conv  the gate's step (EDM, sigma_data 1.0, 8 patches of
                96^3 in 2 microbatches of 108 x 32^3) under full remat and
                under ``remat_policy='conv'``, 3 steps each from the same
                weights, batch and draws: step-1 gradients within
                train-step's GRAD_* bounds of each other; per policy s per
                step, backward share, peak memory, launches per
                microbatch (full: REMAT_COUNTS; 'conv': FLAGSHIP_COUNTS,
                its backward launches nothing); then none / full / 'conv'
                on one 27 x 32^3 microbatch: forward and backward ms, peak
                memory, launches, 'conv' gradients equal to none's
  preset-srunet256  ``SRUnet256(channels=1, lowres_cond=True)`` at its
                full width (dim 128, mults (1, 2, 4, 8), ResnetBlocks (2,
                4, 8, 8), memory_efficient, the cross-embed stem, ViT at
                the middle), seeded weights on the card: one forward of a
                96^3 window (27 x 32^3) through the kernels and the plain
                versions within FORWARD_REL_TOL, launches exactly
                SRUNET_COUNTS (the small-edge route at 4^3 and 2^3, up to
                1024 channels; every small-edge shape in SMALL_EDGE_SHAPES);
                one 20-step ancestral sampler call of the window; ms per
                forward, parameters, peak memory
  serve-2d      the 2D slice family: UNet2D at the JAX defaults' full width
                (dim 64, mults (1, 2, 4), 2 ResnetBlocks a level, SE) with
                softmax attention at the last level and the middle (60^2
                tokens, head dim 32), behind ``Imagen(spatial_dims=2)``, on 16
                axial slices of 240^2 from a seeded 240^3 phantom, the LR
                slices as conditioning, bf16: one forward through the kernels
                and the plain versions within FORWARD_REL_TOL (launches 2
                flash attentions, nothing else), then one 20-step ancestral
                call (launches exactly 40 flash): s per call, ms per NFE, finite
                slices of the input's shape
  attn-context  the attention config's first SoftMaxAttention slot (64
                channels, patch 8 over the 96^3 merged window: 12^3 tokens,
                8 heads of 64), seeded, given a 16-token, 768-wide text
                context (``hash_text_encode``), on 8 windows in bf16:
                through the kernel (flash at Nq 1728, Nk 1744: launched
                exactly once) and the plain version within FORWARD_REL_TOL;
                ms per call, and its device time by kernel
  video-forward  ``Unet3DVideo`` (VIDEO_UNET: dim 64, mults (1, 2, 4, 8),
                RGB, the class's defaults otherwise: text width 768, 8 heads
                of 64, cross-attention at every level, middle attention,
                causal temporal attention with its relative bias, the
                cross-embed stem, Perceiver pooling, global-context gates),
                seeded (its zero-initialised gates and final conv drawn),
                bf16 compute: one forward of 2 videos of 16 frames at 64^2
                with 16-word texts padded to 256 tokens, held against the
                same weights in fp32 within FORWARD_REL_TOL, with time and
                with ``ignore_time``; parameters, ms per forward, peak
                memory, the bf16 forward's device time by kernel and busy
                share; no hand-written kernel launches (the JAX module
                runs none)
  serve-video   ``ElucidatedImagen([that U-Net], image_sizes=(64,),
                channels=3)``: one ``sample(video_frames=16, text_embeds,
                text_mask, cond_scale=3.0)`` at the default 32 Heun steps
                (63 forwards, each beside its null-text forward): finite
                videos of the asked shape; s per call, ms per forward
  video-loss    the EDM loss of 2 such videos with their texts and its
                backward: the wrapper resizes the frame axis to 64 too, as
                the JAX ``forward`` does (printed: the frames the U-Net was
                given); the loss and every gradient finite
  train-2d      ``quality_run_2d``'s trainer at its default width (dim 24,
                linear attention type, no slot on) on the card: 10 steps of 8
                crops of 96^2 from two seeded 128^3 phantoms; every loss
                finite; s per step, peak memory
  cli           ``python -m diffusioniqt_tpu_torch.cli config``, then
                ``train --steps 2`` and ``sample`` of the JAX CLI test's
                small config, as subprocesses on the card: finite samples
                of shape (2, 8, 8, 8, 1)

``python3 chip_smoke.py --profile`` also prints a ``torch.profiler``
breakdown of one forward of each config at the serve batch, 8 x 27 x
32^3 (device time by kernel, device busy share), of SRUnet256's one
window (27 x 32^3), and of one
training microbatch's forward and backward (27 x 32^3) in the train phase
and in each of the three config.yaml cells. Without it too,
train-step profiles one microbatch's forward and backward and fails if any
``indexing_backward`` / ``index_put`` kernel runs: the Block's backward is
the plain composition, which gathers nothing.
``python3 chip_smoke.py --ddp-only`` runs, after the kernels phase, only
serve, ddp-train and ddp-serve, and prints no result line: the data-parallel
path and what it is held against, for a run on a machine with several
cards.
``python3 chip_smoke.py --tp-only`` runs, after the kernels phase, only the
tensor-parallel phases and prints no result line: with 4 cards or more,
tp-train's comparison over NCCL at data 2 x model 2 and at data 4 x model
1 (each against the 1-rank trainer on its global batch, then TP_TIMED_STEPS
more steps timed, then one with every collective synchronised and timed),
s per step and crops per second (median and min-max of the timed steps),
the collectives' ms and bytes, peak memory per rank, then tp-2d at the same
two meshes (TP_TIMED_STEPS more steps timed); with fewer, tp-train,
tp-serve, tp-2d and tp-video as above.
``python3 chip_smoke.py --host-paths`` runs, after the kernels phase, only
the paths whose pace the host sets (preset-srunet256, video-forward,
serve-video, train), each timed HOST_REPEATS times or more, and prints no
result line: a copy of this script placed in another checkout of the
repository (``git archive`` of a parent commit) times that checkout's
Python layers the same way.
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
train-base launches; the halo's ``small_edge`` rows; the fused Block's
small-edge kernel as its own row, ``fused_block_small``
(``csrc/fused_block_small.cu``, its reduction kernel counted in the same
launch), launched in serve-efficient, headed by the (216, 4^3, 256->256)
shape, every shape of SMALL_EDGE_SHAPES in its ``shapes`` list; flash
attention's ``shapes`` list holds its serve-attn, serve-2d and
attn-context rows, each with its launches; every kernel's
``launches_by_path`` has the video phases' zeros, tp-train's, tp-serve's,
tp-2d's and tp-video's launches (rank 0), edm-probe's and the round trip's
train and evaluate processes'; the fused Block's ``shapes`` rows hold
every brick-route shape of FUSED_SHAPES with its plan, times, bound, cuDNN's
conv alone and its launches in each serve path that recorded it, and its
``tp_shapes`` rows the column shards' with tp-train's launches); the last
line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of ``diffusioniqt_tpu``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import collections
import dataclasses
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
# torch.cuda._sleep cycles per ms at the H100 SXM's 1.98 GHz boost clock
# (at a lower clock the sleep only lasts longer)
SLEEP_CYCLES_PER_MS = 1.98e6
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
# (B, s, C, factor) of every Block input that the group_norm kernels see
# on the paths that record their launches (held forwards, the serve paths'
# shape forwards, tp-train and tp-serve; each fails on a shape not listed
# here), each compared with the plain composition (8 groups, a bf16 time
# scale-shift of one row a group of factor^3 sub-volumes, as the
# ResnetBlocks give it). The first GROUP_NORM_TIMED rows are also timed:
# the flagship's heaviest Block inputs at the serve batch, 32^3 x 64 (the
# headline) and x 128. Then the rest of the flagship's serve forward
# (16^3 x 64, 128 and 192: 8 and 20 chunks a sub-volume, a 24-vector tile
# with 10 voxel rows a pass; 8^3 x 128: 2 chunks) and the attention and
# efficient configs' 8^3 x 256 and 4^3 x 256, all at the serve batch and
# at one window (held forwards, tp-serve); the flagship's at two and four
# windows (tp-train's 1-rank trainer at data 2 and 4); the flagship's at
# factor 1 (config/config.yaml, the train phases, which record nothing);
# and SRUnet256's at one window (factor 1, C 32 to 1024)
_FLAGSHIP_NORM = [(32, 64), (32, 128), (16, 64), (16, 128), (16, 192), (8, 128)]
GROUP_NORM_SHAPES = (
    [(rows, s, c, 3) for rows in (BATCH, GROUP)
     for s, c in _FLAGSHIP_NORM + [(8, 256), (4, 256)]]
    + [(rows * GROUP, s, c, 3) for rows in (2, 4) for s, c in _FLAGSHIP_NORM]
    + [(GROUP, s, c, 1) for s, c in _FLAGSHIP_NORM]
    + [(GROUP, s, c, 1) for s, c in [(32, 32), (16, 256), (8, 256), (8, 512), (4, 512),
                                     (4, 1024), (2, 1024)]])
GROUP_NORM_TIMED = 2
# the tables against the plain composition, relative to each table's
# largest entry: the plain version sums 2^18 fp32 squares a group at
# (216, 32^3, 64) (about 1e-5 relative where the sums run long), the
# kernel sums short runs around a per-group shift and adds them in double
GROUP_NORM_TOL = 1e-4
# (s, Cin, Cout): the init conv (small-Cin route) and one wide shape that
# holds the implicit-GEMM route, which no conv3d call of the path takes
CONV_SHAPES = [(32, 2, 64), (16, 64, 64)]
# (B, s, Cin, Cout) of every brick-route Block that serve, serve-attn,
# serve-efficient and preset-srunet256 launch (each of those phases records
# its shapes and fails on one not listed here): the flagship's at the serve
# batch (the first row is the route's headline), the attention config's 8^3
# 256->256, the efficient flagship's 16^3 128->64 and 8^3 256->128, and
# SRUnet256's at one window: the first 16 rows of
# ops/kernels/fused_block.py::BRICK_SHAPES
FUSED_SHAPES = [(BATCH, 32, 64, 64), (BATCH, 32, 128, 64), (BATCH, 16, 64, 64),
                (BATCH, 16, 192, 128), (BATCH, 16, 128, 128), (BATCH, 8, 128, 128),
                (BATCH, 8, 256, 256), (BATCH, 16, 128, 64), (BATCH, 8, 256, 128),
                (GROUP, 32, 32, 32), (GROUP, 32, 32, 128), (GROUP, 32, 128, 128),
                (GROUP, 16, 128, 128), (GROUP, 16, 256, 128), (GROUP, 8, 256, 256),
                (GROUP, 8, 512, 256)]
# the 2D slice family's serve cell (serve-2d): UNet2D at the JAX defaults'
# full width (dim 64, mults (1, 2, 4), 2 ResnetBlocks a level, SE) with
# softmax attention at the last level and the middle, 16 axial slices of
# the users' 240^3 volume (240^2 each), lowres-conditioned, 20 ancestral
# steps; bf16 compute, fp32 parameters
SERVE_2D = dict(dim=64, dim_mults=(1, 2, 4), num_resnet_blocks=2, channels=1, lowres_cond=True,
                use_se_attn=True, att_type="softmax", layer_attns=(False, False, True),
                attend_at_middle=True)
SLICES_2D, EDGE_2D, STEPS_2D = 16, 240, 20
# launches per UNet2D forward: the two softmax slots at 60^2 tokens
SERVE_2D_COUNTS = {"halo": 0, "conv3d": 0, "fused_block": 0, "fused_block_small": 0,
                   "flash_attention": 2, "group_norm": 0}
# train-2d: quality_run_2d's trainer (tools/quality_run_2d.py:88-92: dim 24,
# linear attention type with no slot on) on 96^2 crops, batch 8, this many steps
TRAIN_2D_DIM, TRAIN_2D_CROP, TRAIN_2D_BATCH, TRAIN_2D_STEPS = 24, 96, 8, 10
# attn-context: the attention config's first slot (level 0 of the merged
# 96^3 window: 64 channels, patch 8, 12^3 tokens, 8 heads of 64) given a
# text context of this many tokens of this width (hash_text_encode, the
# T5-base width), on the serve batch of 8 windows; it launches flash once
CONTEXT_TOKENS, CONTEXT_DIM = 16, 768
CONTEXT_COUNTS = {"halo": 0, "conv3d": 0, "fused_block": 0, "fused_block_small": 0,
                  "flash_attention": 1, "group_norm": 0}
# (batch, heads, query tokens, key tokens, head dim) of every softmax
# attention the serve phases launch: the attention config's slots (8
# windows x 8 heads, 12^3 patch tokens, head dim 64), serve-2d's (16 slices
# x 8 heads, 60^2 tokens, head dim 32: not a multiple of the kernel's query
# or key tile) and attn-context's (the slot's 12^3 queries against its
# tokens and the 16 text tokens)
FLASH_SHAPES = [(WINDOWS, 8, 1728, 1728, 64),
                (SLICES_2D, 8, (EDGE_2D // 4) ** 2, (EDGE_2D // 4) ** 2, 32),
                (WINDOWS, 8, 1728, 1728 + CONTEXT_TOKENS, 64)]
# the text-conditioned video cell (video-forward, serve-video, video-loss):
# Unet3DVideo at the width of the imagen-pytorch README's Imagen-Video
# example (dim 64, mults (1, 2, 4, 8), RGB) with the class's defaults
# otherwise: text width 768 (google/t5-v1_1-base), 8 heads of 64,
# cross-attention at every level, attention at the middle, causal temporal
# attention with its relative bias, the cross-embed stem (3, 7, 15),
# Perceiver pooling to 32 latents, global-context gates; 2 videos of 16
# frames at 64^2, each with a 16-word text (hash_text_encode) padded to
# max_text_len 256; bf16 compute, fp32 parameters. It runs no hand-written
# kernel: the JAX module leaves it all to XLA
VIDEO_UNET = dict(dim=64, dim_mults=(1, 2, 4, 8), channels=3)
VIDEO_BATCH, VIDEO_FRAMES, VIDEO_EDGE, VIDEO_TEXT_LEN, VIDEO_WORDS = 2, 16, 64, 256, 16
VIDEO_TEXTS = ["an axial flair slice of an adult brain with periventricular white matter "
               "lesions in both hemispheres",
               "a sagittal t1 weighted sweep across the midline showing the corpus callosum "
               "cerebellum and fourth ventricle"]
VIDEO_COND_SCALE = 3.0
NO_COUNTS = {"halo": 0, "conv3d": 0, "fused_block": 0, "fused_block_small": 0,
             "flash_attention": 0, "group_norm": 0}
# missing-pieces: UpsampleCombiner at the flagship's widths on one window,
# the input at level 0 (32^3 x 64), the feature maps of levels 1 and 2
# (16^3 x 128, 8^3 x 256) resized to 32^3, each through a 64-wide Block
COMBINER_DIM, COMBINER_DIM_INS, COMBINER_DIM_OUTS = 64, (128, 256), (64, 64)
REPLACES = {
    "halo": "diffusioniqt_tpu/ops/pallas/halo.py:103",
    "conv3d": "diffusioniqt_tpu/ops/pallas/conv3d.py:83",
    "fused_block": "diffusioniqt_tpu/ops/pallas/fused_block.py:272",
    "fused_block_small": "diffusioniqt_tpu/ops/pallas/fused_block.py:272",
    "flash_attention": "diffusioniqt_tpu/ops/pallas/flash_attention.py:90",
    "group_norm": "none: diffusioniqt_tpu/ops/pallas/fused_block.py's groupnorm_affine and "
                  "_neighbor_tables, left to XLA",
}
HEADLINE = {"halo": (32, 64), "conv3d": (32, 2, 64), "fused_block": (32, 64, 64),
            "flash_attention": (1728, 1728, 64)}
# factor 1 (config/config.yaml's SAME convs) at its 27-sub-volume microbatch:
# the halo at the heaviest activation, and the heaviest fused Block
HALO_F1_SHAPE, FUSED_F1_SHAPE = (32, 64), (32, 64, 64)
FLAGSHIP_CONFIG = os.path.join("config", "eval_config.yaml")
TRAIN_CONFIG = os.path.join("config", "config.yaml")
EDM_CONFIG = os.path.join("config", "eval_edm.yaml")
ATTN_CONFIG = os.path.join("diffusioniqt_tpu_torch", "configs", "eval_attn_softmax.yaml")
# launches per forward of one 27-sub-volume group (fused_block_small: the
# fused Block's small-edge route, sub-volume edges 4 and 2; group_norm: each
# Block's statistics and tables, one per fused Block launch)
FLAGSHIP_COUNTS = {"halo": 39, "conv3d": 1, "fused_block": 38, "fused_block_small": 0,
                   "flash_attention": 0, "group_norm": 38}
ATTN_COUNTS = {"halo": 41, "conv3d": 1, "fused_block": 40, "fused_block_small": 0,
               "flash_attention": 4, "group_norm": 40}
# launches per microbatch forward + backward with Train.remat: each of the
# 19 ResnetBlocks is recomputed in the backward, its 2 halos, 2 tables and
# 2 fused blocks launched again; the init conv and its halo are not in a
# block
REMAT_COUNTS = {"halo": 1 + 2 * 38, "conv3d": 1, "fused_block": 2 * 38, "fused_block_small": 0,
                "flash_attention": 0, "group_norm": 2 * 38}
# Train.efficient: levels at 16^3, 8^3, 4^3, up levels at 8^3, 16^3, 32^3;
# the 3 ResnetBlocks at 4^3 take the small-edge route, the 16 others the
# implicit GEMM
EFFICIENT_COUNTS = {"halo": 39, "conv3d": 1, "fused_block": 32, "fused_block_small": 6,
                    "flash_attention": 0, "group_norm": 38}
# SRUnet256 at 27 x 32^3: 54 ResnetBlocks (26 down, the mid one, 26 up, the
# final one), 28 of them at 4^3 or 2^3; the cross-embed stem is cuDNN (no
# conv3d); the mid ViT's one attention layer goes through flash
SRUNET_COUNTS = {"halo": 108, "conv3d": 0, "fused_block": 52, "fused_block_small": 56,
                 "flash_attention": 1, "group_norm": 108}
# the small-edge route's rows in the kernels phase: every (batch, s, Cin,
# Cout, factor) that the fused Block's wrapper sees in one forward of the
# efficient flagship (6 launches at 4^3, factor 3; 27 rows in
# forward-efficient, 216 in serve-efficient) and one of SRUnet256 at one
# window (35 at 4^3 x 512, 1 at 4^3 1024->512 on the up path, 20 at 2^3 x
# 1024; factor 1); the first is the route's headline. The same list as
# ops/kernels/fused_block.py::SMALL_EDGE_SHAPES, written out so that a copy
# of this script times an older checkout's kernels too
SMALL_EDGE_SHAPES = [(BATCH, 4, 256, 256, 3), (GROUP, 4, 256, 256, 3), (GROUP, 4, 512, 512, 1),
                     (GROUP, 4, 1024, 512, 1), (GROUP, 2, 1024, 1024, 1),
                     (BATCH, 4, 256, 128, 3)]
# (s, Cin, Cout / M) of the fused Block under a column split, at the serve
# batch: the flagship's level-0 Block 64->64 at M = 2 and 4, and the wider
# levels' at M = 2 (16^3 128->128, 8^3 256->256); then the other shard
# shapes that tp-train launches (M = 2: the flagship's Blocks 64->64 at
# 16^3, 128->128 at 8^3, 192->128 at 16^3, 128->64 at 32^3). The small-edge
# route's (216, 4^3, 256->128) is the last row of SMALL_EDGE_SHAPES
TP_FUSED_SHAPES = [(32, 64, 32), (16, 128, 64), (8, 256, 128), (32, 64, 16),
                   (16, 64, 32), (8, 128, 64), (16, 192, 64), (32, 128, 32)]
# tp-train / --tp-only: crops of 96^3 per data rank per step, microbatches
# per step (27 x 32^3 each on one data rank), steps held against the 1-rank
# trainer (one more step follows with every collective timed); tp-serve:
# Heun steps of its one EDM call (7 forwards; cut from the config's 64: on
# one card gloo stages every gathered activation through the host)
TP_CROPS_PER_DATA_RANK, TP_ACCUM, TP_STEPS, TP_SERVE_STEPS = 2, 2, 2, 4
# --tp-only on 4 cards: steps timed after the compared ones (their median
# and min-max give s per step and crops per second)
TP_TIMED_STEPS = 5
# tp-train: the state after step 1 against the 1-rank state, in units of the
# learning rate. Adam's first update is about lr * sign(g), so where a
# rounding-level gradient entry takes the other sign the two runs' weights
# (and EMA) lie 2 lr apart (2.000e-4 read at lr 1e-4 on an H100); 1% more
# for the rounding of fp32 weights near 1, an ulp of which is 6e-4 of 2 lr
# at lr 1e-4
TP_STEP1_LR_BOUND = 2.02
# tp-2d: UNet2D at serve-2d's width (SERVE_2D, bf16) over a (data, model)
# mesh: one optimizer step of this many axial slices of 240^2 and one
# STEPS_2D-step ancestral call of them (cut from serve-2d's 16 slices: on one
# card gloo stages every gathered activation through the host)
TP2D_SLICES = 4
# tp-2d's sampler call against one rank's: each of its STEPS_2D U-Net calls
# is held within FORWARD_REL_TOL of one rank's U-Net on that call's own
# inputs. The chained result is printed, not held: 20 chained bf16 forwards
# of an untrained U-Net carry one rounding about as far as the split's
# reordering (0.138 and 0.159 of the sample's largest entry on an H100 80GB
# HBM3 at 700 W), so its distance tells no fault from noise
# tp-video: Unet3DVideo at serve-video's width (VIDEO_UNET) in fp32 (no
# hand-written kernel on this path; fp32 holds the split to the rounding of
# the column shards' products): one forward of serve-video's input against
# one rank within TP_VIDEO_REL_TOL of its largest entry, and one EDM loss
# step of VIDEO_BATCH videos of VIDEO_FRAMES frames at TP_VIDEO_EDGE^2 (the
# wrapper gives the U-Net TP_VIDEO_EDGE frames)
TP_VIDEO_EDGE = 32
TP_VIDEO_REL_TOL = 1e-4
# edm-probe: the held-out phantom's edge (its whole 96^3: 27 x 32^3)
EDM_PROBE_SIZE = 96
# nifti-roundtrip: the smallest full run of the 256^3 NIfTI round trip
# (one train, one valid and one test volume; this many optimizer steps; one
# gaussian-stitched evaluation of the test volume)
NIFTI_STEPS = 2
# repeats of the host-bound paths' timings (the video forward, the video
# and SRUnet256 sampler calls): median and min-max
HOST_REPEATS = 3
# the brick route's headline row: the min-max of 5 device timings that
# PERF.md's kernel table records for it before the small-edge route moved to
# its own kernel (H100 80GB HBM3, 700 W). This run's median must lie within
# it, widened by the noise margin on each side (the parent's own median read
# 3.5819, just under it, in a later call), where the card's power limit is
# that of the recording; on a card held lower it is printed only
BRICK_ROUTE_SPREAD_MS = (3.5828, 3.7128)
BRICK_ROUTE_MARGIN = 0.05
BRICK_ROUTE_WATTS = 700.0
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
# ddp-train: crops of 96^3 per rank per step, microbatches per step, steps
DDP_CROPS_PER_RANK, DDP_ACCUM, DDP_STEPS = 2, 2, 3
# ddp-train's all-reduced gradient against the 1-rank one: the whole
# gradient's relative norm difference. The two gradients differ by bf16
# noise of forwards at other batch sizes, about 1.5e-3 of the gradient's
# norm at whole cosine 0.999999, which moves the norm by up to that much
# (readings on H100s, torch 2.11: 6.6e-4 at 2 ranks on one card, 1.9e-3 at
# 4 ranks on 4 cards); a sum over the ranks in place of the mean is off by
# W - 1
DDP_GRAD_NORM_REL_TOL = 1e-2
# ddp-train's losses (the all-reduced mean over the ranks) against the
# 1-rank trainer's, relative: sound readings 5.2e-5 (2 ranks on one card)
# and 2.5e-5 (4 ranks on 4 cards) on H100s, torch 2.11; ten times the
# larger. The phase also prints what a rank would have returned with the
# loss left out of the all-reduce (its own rows' mean, read before the
# reduction) against the same 1-rank losses: the reading this limit has to
# stay below
DDP_LOSS_REL_TOL = 5e-4
# ddp-serve's volume against the serve phase's 1-rank volume, relative to
# its largest entry. Each rank's sampler calls run at 4 windows (108 rows)
# where the 1-rank call runs at 8 (216): the kernels compute each
# sub-volume alone, but cuDNN / cuBLAS and the reductions of the plain ops
# between them may pick other algorithms at another batch size, and their
# last-bit differences, rounded to bf16 and compounded over 20 sampler
# steps, moved the volume by 3.2e-2 (2 ranks) and 3.4e-2 (4 ranks) of its
# largest entry on H100s (torch 2.11), as far as one process moves at 108
# or 54 rows against 216; held to the bound of one forward through the
# kernels against the plain versions. The rows check beside it holds the distributed sampler
# bit for bit against one process sampling each rank's rows alone.
DDP_SERVE_REL_TOL = FORWARD_REL_TOL
# train-remat-conv: gate steps per policy
REMAT_CONV_STEPS = 3
# the cli phase's model: the JAX CLI test's small config
# (tests/test_cli_entry.py:29-58)
CLI_TINY_CONFIG = {
    "elucidated": False,
    "imagen": {
        "unets": [
            {"kind": "null"},
            {"kind": "unet3d", "dim": 8, "dim_mults": [1, 2], "channels": 1,
             "kwargs": {"num_resnet_blocks": 1, "init_dim": 8, "resnet_groups": 4,
                        "init_cross_embed": False, "att_type": "linear",
                        "attend_at_middle": False, "attend_at_enc": [False, False],
                        "use_se_attn": True, "batch_sample": False, "boundary": False,
                        "deep_feature": False, "img_size": 8}},
        ],
        "image_sizes": [8, 8], "channels": 1, "timesteps": 8, "pred_objectives": "x_start",
        "cond_drop_prob": 0.0, "dynamic_thresholding": False, "norm": "z-score",
    },
}
# a rank that has not finished by then fails the phase
DDP_RANK_TIMEOUT_S = 600
# device kernels of an accumulating scatter: the backward of a gather
SCATTER_KERNELS = ("indexing_backward", "index_put")
# device-kernel names of each hand-written kernel, for the profile's layers
LAYERS = {"fused_block": ("igemm::conv_sm90<true",),
          "fused_block_small": ("small_edge::conv_kernel", "small_edge::reduce_partials"),
          "conv3d": ("small_cin_kernel", "igemm::conv_sm90<false"),
          "halo": ("halo_row_kernel",), "flash_attention": ("flash_kernel",),
          "group_norm": ("gn_stats::",)}
# the one PyTorch call timed beside each kernel as its library yardstick
LIBRARY = {"halo": "index_select gather from a precomputed source table",
           "conv3d": "F.conv3d (cuDNN)",
           "fused_block": "none: no single PyTorch call computes GroupNorm-affine + "
                          "Mish + halo'd conv (conv_only_library_ms: F.conv3d, cuDNN, on "
                          "the transformed input materialised beforehand)",
           "fused_block_small": "none, as for fused_block (conv_only_library_ms: "
                                "F.conv3d, cuDNN, on the transformed input)",
           "flash_attention": "F.scaled_dot_product_attention",
           "group_norm": "torch.var_mean over the (B, s^3, groups, C / groups) view "
                         "(the statistics alone)"}


def recording_ops(seen):
    """The kernels, counting in ``seen`` the (B, s, Cin, Cout, factor) of
    every fused Block launch at a small sub-volume edge, and failing on a
    group_norm shape not in GROUP_NORM_SHAPES (:func:`compared_norm_tables`)."""
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS
    factor = {}

    def halo(x, f):
        factor["f"] = f  # the Block's halo, just before its fused conv
        return KERNELS.halo(x, f)

    def fused_conv(xh, a_tab, b_tab, w, cache=None):
        s = xh.shape[1] - 2
        if s in (4, 2):
            seen[(xh.shape[0], s, xh.shape[4], w.shape[0], factor["f"])] += 1
        return KERNELS.fused_conv(xh, a_tab, b_tab, w, cache)

    return dataclasses.replace(KERNELS, halo=halo, fused_conv=fused_conv,
                               norm_tables=compared_norm_tables)


def compared_norm_tables(x, norm_scale, norm_bias, scale, shift, groups, factor, eps=1e-5):
    """``KERNELS.norm_tables``, failing on a (B, s, C, factor) that the
    kernels phase did not hold to the plain composition
    (GROUP_NORM_SHAPES)."""
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS

    shape = (x.shape[0], x.shape[1], x.shape[4], factor)
    if shape not in GROUP_NORM_SHAPES:
        raise AssertionError(f"group_norm: (B, s, C, factor) {shape} not in GROUP_NORM_SHAPES")
    return KERNELS.norm_tables(x, norm_scale, norm_bias, scale, shift, groups, factor, eps)


def torch_default_init_(unet: torch.nn.Module) -> None:
    """Redraw ``unet``'s convs and dense layers with torch's own
    ``reset_parameters`` (``kaiming_uniform_(a=sqrt(5))`` weights, uniform
    biases): the port's initialisers before it took flax's. The
    pixel-shuffle convs keep their ICNR draw, which is the same in both."""
    from diffusioniqt_tpu_torch.models.blocks import PixelShuffleUpsample

    icnr = {id(m.net[0]) for m in unet.modules() if isinstance(m, PixelShuffleUpsample)}
    for m in unet.modules():
        if id(m) in icnr:
            continue
        for base in (torch.nn.Linear, torch.nn.Conv3d, torch.nn.ConvTranspose3d):
            if isinstance(m, base):
                base.reset_parameters(m)
    torch.autograd.graph.increment_version(list(unet.parameters()))


class SEBranches:
    """Forward hooks on every squeeze-excite ReLU of ``model``. ``record``
    keeps which hidden units pass; ``pin`` makes each ReLU pass exactly
    those (its input times the recorded mask), so that a second path's
    gradient is taken on the same linear piece of every gate as the first
    path's. A hidden unit within bf16 noise of zero (a gate's first dense
    layer has no bias) otherwise passes on one path and not on the other,
    and the gate weight's row of that unit then differs between the two
    gradients by the whole contribution of a sample, not by rounding: one
    such unit in 2 of 4 seeded microbatches of config/config.yaml at the
    flax init, per-tensor cosine 0.9986 (NVIDIA H100 80GB HBM3, 700 W).
    ``flips`` counts, per gate, the units on which a pinned path's own ReLU
    would have decided otherwise."""

    def __init__(self, model: torch.nn.Module):
        from diffusioniqt_tpu_torch.models.blocks import SE3D
        from diffusioniqt_tpu_torch.models.unet2d import SE2D

        self.mode, self.masks, self.flips = None, {}, {}
        self.relus = {f"{name}.fc.1": m.fc[1] for name, m in model.named_modules()
                      if isinstance(m, (SE3D, SE2D))}
        self.hooks = [relu.register_forward_hook(self._hook) for relu in self.relus.values()]

    def by_name(self) -> dict:
        """The recorded masks by module name, on the host (to pin another
        process's copy of the model with :meth:`pin_to`)."""
        return {n: self.masks[r].cpu() for n, r in self.relus.items() if r in self.masks}

    def pin_to(self, masks: dict, device) -> None:
        self.masks = {self.relus[n]: m.to(device) for n, m in masks.items()}
        self.mode = "pin"

    def _hook(self, module, inputs, output):
        x = inputs[0]
        if self.mode == "record":
            self.masks[module] = x > 0
        elif self.mode == "pin":
            mask = self.masks[module]
            self.flips[module] = int(((x > 0) != mask).sum())
            return x * mask.to(x.dtype)
        return None

    def flipped(self) -> int:
        return sum(self.flips.values())

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


_STARTED = time.perf_counter()


def phase(name: str) -> float:
    """Print the phase's header with the seconds since the script started."""
    now = time.perf_counter()
    print(f"=== {name} (at {now - _STARTED:.1f} s)", flush=True)
    return now


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


def device_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per ``fn()``: CUDA events around ``iters`` calls, after the
    device has slept for longer than the host takes to enqueue them, so
    that a call whose host side (checks, TMA descriptors, ctypes) takes
    longer than its kernels is timed by its kernels, back to back, and not
    by the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2.0 * iters * host_ms + 0.5, 200.0) * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, repeats: int = 5, **kw):
    """(median, min, max) of ``repeats`` timings of :func:`device_time_ms`."""
    runs = sorted(device_time_ms(fn, **kw) for _ in range(repeats))
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


def kernel_ms_by_tag(fn, tags, iters: int = 10) -> dict:
    """Device ms per ``fn()`` of the kernels whose names hold each tag, from
    ``torch.profiler`` over ``iters`` calls after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return {tag: sum(ms for k, ms in rows if tag in k) / iters for tag in tags}


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


def power_watts(smi: str) -> float:
    """The power limit in an ``nvidia-smi --query-gpu=name,power.limit`` line
    (0 where the card does not report one)."""
    try:
        return float(smi.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return 0.0


def card_settings() -> None:
    """The fp32 settings every phase runs with (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def ddp_train_rank(device, cfg, batches):
    """One rank of ddp-train: the trainer over a data mesh of every rank,
    one optimizer step per global batch; the all-reduce timed by CUDA
    events and the host clock around it (synchronised: measurement only)."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel import sharding
    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
    from diffusioniqt_tpu_torch.train.__main__ import build_trainer

    card_settings()
    trainer = build_trainer(cfg, device, mesh=create_mesh(("data",)))
    trainer.prepare()
    reductions, local_losses = [], []
    all_reduce_mean_ = sharding.all_reduce_mean_

    def timed(tensors, mesh):
        local_losses.append(float(tensors[-1]) / DDP_ACCUM)  # this rank's rows
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        all_reduce_mean_(tensors, mesh)
        events[1].record()
        torch.cuda.synchronize()
        reductions.append((events[0].elapsed_time(events[1]),
                           (time.perf_counter() - t0) * 1e3, nbytes(*tensors)))

    sharding.all_reduce_mean_ = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    kernels.reset_launch_counts()
    losses, step_s, grads = [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(unet_number=2, batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0 and dist.get_rank() == 0:
            grads = {k: p.grad.detach().cpu() for k, p in
                     trainer.imagen.unets[1].named_parameters()}
    counts = kernels.launch_counts()
    sharding.all_reduce_mean_ = all_reduce_mean_
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": str(device), "losses": losses, "local_losses": local_losses,
            "step_s": step_s,
            "reductions": reductions, "peak": torch.cuda.max_memory_allocated(device),
            "launches": counts, "grads": grads,
            "params": {k: v.detach().cpu() for k, v in
                       trainer.imagen.unets[1].state_dict().items()},
            "ema": {k: v.detach().cpu() for k, v in trainer.ema_unets[1].state_dict().items()}}


def serve_windows(cfg, lowres_vol, windows, device):
    """The first ``windows`` windows of ``infer_volume``'s grid over
    ``lowres_vol``, split into sub-volumes, on ``device``."""
    from diffusioniqt_tpu_torch.data.datasets import SupervisedIQTInference
    from diffusioniqt_tpu_torch.ops.stitch_device import gather_windows
    from diffusioniqt_tpu_torch.ops.volume import volume_to_subvolumes

    dataset = SupervisedIQTInference(cfg, lr_file=None, volume=lowres_vol)
    volume = torch.from_numpy(dataset.normalize(lowres_vol.astype(np.float32))).to(device)
    x = gather_windows(volume, dataset.valid_indices()[:windows], cfg.train.patch_size)
    return volume_to_subvolumes(x, cfg.train.batch_sample_factor)


def ddp_serve_rank(device, cfg, edge, windows):
    """One rank of ddp-serve: the serve phase's ``infer_volume`` call with
    its windows spread over a data mesh of every rank; then one
    ``sharded_sample`` call over the same windows, its gathered rows
    returned by rank 0."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
    from diffusioniqt_tpu_torch.infer import build_sampler, fake_volumes, infer_volume
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
    from diffusioniqt_tpu_torch.parallel.sharding import sharded_sample

    card_settings()
    imagen = build_sampler(cfg, device=device, seed=0)
    lowres_vol, _ = fake_volumes(cfg, edge, seed=0)
    noise = gaussian_noise(torch.Generator(device=device).manual_seed(0))
    mesh = create_mesh(("data",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pred = infer_volume(cfg, imagen, lowres_vol, noise=noise, patch_batch=windows,
                        verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "launches": kernels.launch_counts(),
           "pred": pred, "peak": torch.cuda.max_memory_allocated(device)}
    x = serve_windows(cfg, lowres_vol, windows, device)
    rows = sharded_sample(imagen.sample, mesh, batch_size=x.shape[0], group=GROUP,
                          noise=gaussian_noise(torch.Generator(device=device).manual_seed(1)),
                          start_image_or_video=x, start_at_unet_number=2)
    out["rows"] = rows.cpu() if dist.get_rank() == 0 else None
    return out


class CollectiveLog:
    """Counts the ``torch.distributed`` collectives this process issues (by
    kind: calls and bytes moved into or out of this rank's buffers) and,
    while ``timed``, their host time with the device synchronised before
    and after each (measurement only)."""

    KINDS = ("all_gather", "all_reduce")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.real = dist, {k: getattr(dist, k) for k in self.KINDS}
        self.timed = False
        self.reset()

    def reset(self):
        self.calls, self.bytes = collections.Counter(), collections.Counter()
        self.ms = collections.Counter()

    def install(self):
        for kind, real in self.real.items():
            def wrapped(*args, _kind=kind, _real=real, **kw):
                t = args[1] if _kind == "all_gather" else args[0]
                n = t.numel() * t.element_size() * (len(args[0]) if _kind == "all_gather" else 1)
                self.calls[_kind] += 1
                self.bytes[_kind] += n
                if not self.timed:
                    return _real(*args, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kw)
                torch.cuda.synchronize()
                self.ms[_kind] += (time.perf_counter() - t0) * 1e3
                return out
            setattr(self.dist, kind, wrapped)

    def uninstall(self):
        for kind, real in self.real.items():
            setattr(self.dist, kind, real)

    def summary(self, per: int = 1) -> dict:
        return {k: {"calls": self.calls[k] / per, "bytes": self.bytes[k] / per,
                    **({"ms": self.ms[k] / per} if self.ms else {})}
                for k in self.KINDS if self.calls[k]}


def shape_recording_ops(seen):
    """The kernels, counting in ``seen`` the (B, s, Cin, Cout) of every
    fused Block launch (both routes), and failing on a group_norm shape not
    in GROUP_NORM_SHAPES (:func:`compared_norm_tables`)."""
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS

    def fused_conv(xh, a_tab, b_tab, w, cache=None):
        seen[(xh.shape[0], xh.shape[1] - 2, xh.shape[4], w.shape[0])] += 1
        return KERNELS.fused_conv(xh, a_tab, b_tab, w, cache)

    return dataclasses.replace(KERNELS, fused_conv=fused_conv, norm_tables=compared_norm_tables)


def tp_train_rank(device, cfg, batches, mesh_shape, bundle, timed_steps):
    """One rank of tp-train (and of --tp-only): the trainer over a (data,
    model) mesh, one optimizer step per global batch, the state after the
    first saved to ``bundle`` (the one-process format: shards gathered);
    with ``timed_steps``, that many more steps over the batches again,
    timed, then one with every collective timed. Returns the compared
    steps' losses, s per step, launches and fused Block shapes, the
    collectives of step 1, the gradients of steps 1 and 2 gathered whole
    (rank 0), this rank's replicated parameters, the peak memory, the
    timed steps' seconds."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel import sharding
    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
    from diffusioniqt_tpu_torch.train.__main__ import build_trainer

    card_settings()
    mesh = create_mesh(("data", "model"), mesh_shape)
    trainer = build_trainer(cfg, device, mesh=mesh)
    trainer.prepare()
    unet = trainer.imagen.unets[1]
    shapes = collections.Counter()
    unet.use_ops(shape_recording_ops(shapes))
    log = CollectiveLog()
    log.install()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    kernels.reset_launch_counts()
    log.reset()
    losses, step_s, grads = [], [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(unet_number=2, batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            comms = log.summary()
        log.uninstall()  # what follows is measurement, not the step's
        if i < 2:
            g = sharding.gather_state({k: p.grad.detach() for k, p in unet.named_parameters()},
                                      trainer.shard_dims[1], mesh)
            grads.append({k: v.cpu() for k, v in g.items()} if dist.get_rank() == 0 else None)
        if i == 0:
            trainer.save(bundle)
        log.install()
        log.reset()
    counts, fused = kernels.launch_counts(), dict(shapes)
    peak = torch.cuda.max_memory_allocated(device)
    log.uninstall()
    extra_s = []
    for i in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(unet_number=2, batch=batches[i % len(batches)])
        torch.cuda.synchronize()
        extra_s.append(time.perf_counter() - t0)
    timed, timed_s = None, None
    if timed_steps:
        log.install()
        log.reset()
        log.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(unet_number=2, batch=batches[-1])
        timed_s = time.perf_counter() - t0
        timed = log.summary()
    log.uninstall()
    dims = trainer.shard_dims[1]
    return {"backend": dist.get_backend(), "world": dist.get_world_size(), "device": str(device),
            "losses": losses, "step_s": step_s, "launches": counts, "shapes": fused,
            "comms": comms, "timed": timed, "timed_s": timed_s, "extra_s": extra_s,
            "peak": peak, "grads": grads,
            "sharded": len(dims),
            "replicated": {k: v.detach().cpu() for k, v in unet.state_dict().items()
                           if k not in dims}}


def tp_serve_rank(device, cfg, window):
    """One rank of tp-serve: one EDM call of ``window`` through
    ``ImagenTrainer.sample`` (the EMA weights: the seeded ones, untrained)
    over a (1, model) mesh of every rank."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
    from diffusioniqt_tpu_torch.train.__main__ import build_trainer

    card_settings()
    trainer = build_trainer(cfg, device, mesh=create_mesh(("data", "model"),
                                                          (1, dist.get_world_size())))
    trainer.prepare()
    shapes = collections.Counter()
    trainer.ema_unets[1].use_ops(shape_recording_ops(shapes))
    log = CollectiveLog()
    log.install()
    window = window.to(device)
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.sample(batch_size=window.shape[0], start_image_or_video=window,
                         start_at_unet_number=2,
                         noise=gaussian_noise(torch.Generator(device=device).manual_seed(2)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log.uninstall()
    return {"out": out.cpu() if dist.get_rank() == 0 else None, "seconds": seconds,
            "launches": kernels.launch_counts(), "shapes": dict(shapes), "comms": log.summary(),
            "peak": torch.cuda.max_memory_allocated(device)}


def tp2d_batch():
    """tp-2d's slices: the central TP2D_SLICES axial slices of a seeded
    240^3 phantom pair (HR, LR), z-scored with the LR volume's stats, and
    the z-scored zero (the wrapper's ``min_bound``)."""
    from diffusioniqt_tpu_torch.data.synthetic import generate_pair, population_stats

    hr, lr = generate_pair(EDGE_2D, seed=0)
    mean, std = population_stats([lr])
    z0 = (EDGE_2D - TP2D_SLICES) // 2
    hr_s, lr_s = (((v[z0:z0 + TP2D_SLICES] - mean) / std).astype(np.float32)[..., None]
                  for v in (hr, lr))
    return hr_s, lr_s, (0.0 - mean) / std


def tensors_to(tree, device):
    """``tree`` (tensors in tuples, lists and dicts) with every tensor
    detached and moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_to(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: tensors_to(v, device) for k, v in tree.items()}
    return tree


def tp2d_run(device, hr, lr, min_bound, mesh, timed_steps=0, se_masks=None):
    """tp-2d on one rank (``mesh``) or in one process (None): the trainer
    over ``Imagen(spatial_dims=2)`` with UNet2D (SERVE_2D, bf16, seeded);
    one forward of the slices at t = 0.5; one STEPS_2D-step ancestral call
    of the slices' LR from the untrained EMA weights, each of its U-Net
    calls recorded on the mesh's rank 0 (inputs and output, on the host);
    in one process a copy of the sampling U-Net to replay them on; then one
    optimizer step of the (HR, LR) slices, its squeeze-excite ReLUs
    recorded (``se_masks`` None) or pinned to ``se_masks`` (SEBranches);
    with ``timed_steps`` that many more steps, timed. Returns the forward,
    the sample, the calls and the gathered step-1 gradient (on rank 0, on
    the host), the copy, the loss, the masks, each part's launches and
    seconds, the peak memory."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, gaussian_noise
    from diffusioniqt_tpu_torch.models.unet2d import UNet2D
    from diffusioniqt_tpu_torch.models.unet3d import NullUnet
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel import sharding
    from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = UNet2D(**SERVE_2D, dtype=torch.bfloat16).to(device)
    imagen = Imagen([NullUnet().to(device), unet], image_sizes=(EDGE_2D, EDGE_2D), channels=1,
                    timesteps=STEPS_2D, pred_objectives="x_start", dynamic_thresholding=False,
                    p2_loss_weight_gamma=0.0, cond_drop_prob=0.0, min_bound=min_bound,
                    norm="z-score", spatial_dims=2)
    trainer = ImagenTrainer(None, imagen, mesh=mesh, gradient_accumulation_steps=1, lr=1e-4,
                            ema_update_after_step=0, ema_update_every=1, seed=0)
    trainer.prepare()
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    lowres = torch.from_numpy(lr).to(device)
    x = torch.randn(lowres.shape, generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    t = torch.full((lr.shape[0],), 0.5, device=device)
    with torch.no_grad():
        forward = unet(x, t, imagen.noise_schedulers[1].get_condition(t),
                       lowres_cond_img=lowres)

    sampler_unet = trainer._sampling_imagen().unets[1]
    calls, hook = [], None
    if mesh is not None and rank0:
        hook = sampler_unet.register_forward_hook(
            lambda module, args, kwargs, out: calls.append(tensors_to((args, kwargs, out), "cpu")),
            with_kwargs=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    if dist.is_initialized():
        dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.sample(batch_size=lr.shape[0], start_image_or_video=lowres,
                         start_at_unet_number=2,
                         noise=gaussian_noise(torch.Generator(device=device).manual_seed(0)))
    torch.cuda.synchronize(device)
    sample_s, sample_counts = time.perf_counter() - t0, kernels.launch_counts()
    replica = None
    if hook is not None:
        hook.remove()
    if mesh is None:
        replica = UNet2D(**SERVE_2D, dtype=torch.bfloat16).to(device)
        replica.load_state_dict(sampler_unet.state_dict())
        replica.eval()
    branches = SEBranches(unet)
    if se_masks is None:
        branches.mode = "record"
    else:
        branches.pin_to(se_masks, device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = trainer.train_step(unet_number=2, batch=(hr, lr))
    torch.cuda.synchronize(device)
    step_s, step_counts = time.perf_counter() - t0, kernels.launch_counts()
    branches.remove()
    grads = {k: p.grad.detach() for k, p in unet.named_parameters()}
    if mesh is not None:
        grads = sharding.gather_state(grads, trainer.shard_dims[1], mesh)
    extra_s = []
    for _ in range(timed_steps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        trainer.train_step(unet_number=2, batch=(hr, lr))
        torch.cuda.synchronize(device)
        extra_s.append(time.perf_counter() - t0)
    return {"out": out.float().cpu() if rank0 else None, "loss": loss,
            "forward": forward.float().cpu() if rank0 else None, "calls": calls,
            "replica": replica,
            "se_masks": branches.by_name(), "se_flips": branches.flipped(),
            "grads": {k: v.cpu() for k, v in grads.items()} if rank0 else None,
            "sample_s": sample_s, "step_s": step_s, "extra_s": extra_s,
            "sample_launches": sample_counts, "step_launches": step_counts,
            "sharded": len(trainer.shard_dims[1]),
            "peak": torch.cuda.max_memory_allocated(device), "device": str(device)}


def tp2d_rank(device, hr, lr, min_bound, mesh_shape, timed_steps, se_masks):
    """One rank of tp-2d: :func:`tp2d_run` over a (data, model) mesh, the
    step's squeeze-excite ReLUs pinned to the one-process run's."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh

    from diffusioniqt_tpu_torch.parallel import sharding
    from diffusioniqt_tpu_torch.parallel.multihost import local_batch_slice

    card_settings()
    mesh = create_mesh(("data", "model"), mesh_shape)
    rows = local_batch_slice(hr.shape[0], sharding.data_size(mesh), sharding.data_rank(mesh))
    out = tp2d_run(device, hr, lr, min_bound, mesh, timed_steps,
                   {k: m[rows] for k, m in se_masks.items()})
    out["backend"] = dist.get_backend()
    return out


def tp_video_run(device, state, inputs, mesh):
    """tp-video on one rank (``mesh``: every weight of the rule column-split,
    the U-Net's learned tokens whole) or in one process (None): VIDEO_UNET
    in fp32 with ``state``; one forward of serve-video's input (no grad),
    then the EDM loss of the loss step's videos and its backward. Returns
    the forward (rank 0, host), the loss, the gathered gradient (rank 0,
    host), the launches, the seconds and peak memory, the sharded count."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
    from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.parallel import sharding

    unet = Unet3DVideo(**VIDEO_UNET).to(device)
    unet.load_state_dict(state)
    dims = {}
    if mesh is not None:
        sharding.broadcast_params(unet, mesh)
        dims = sharding.shard_module_(unet, mesh)
    x, t, emb, mask, videos = (v.to(device) for v in inputs)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = unet(x, t, t, text_embeds=emb, text_mask=mask)
    torch.cuda.synchronize(device)
    forward_s = time.perf_counter() - t0
    edm = ElucidatedImagen([unet], image_sizes=(TP_VIDEO_EDGE,), channels=3)
    t0 = time.perf_counter()
    loss = edm.forward(videos, text_embeds=emb, text_mask=mask,
                       generator=torch.Generator(device=device).manual_seed(7))
    loss.backward()
    torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    grads = {k: p.grad.detach() for k, p in unet.named_parameters()}
    if mesh is not None:
        grads = sharding.gather_state(grads, dims, mesh)
    return {"out": out.cpu() if rank0 else None, "loss": loss.item(),
            "grads": {k: v.cpu() for k, v in grads.items()} if rank0 else None,
            "launches": kernels.launch_counts(), "forward_s": forward_s, "step_s": step_s,
            "peak": torch.cuda.max_memory_allocated(device), "sharded": len(dims),
            "device": str(device)}


def tp_video_rank(device, state, inputs):
    """One rank of tp-video: :func:`tp_video_run` over a (1, model) mesh of
    every rank."""
    import torch.distributed as dist

    from diffusioniqt_tpu_torch.parallel.mesh import create_mesh

    card_settings()
    return tp_video_run(device, state, inputs,
                        create_mesh(("data", "model"), (1, dist.get_world_size())))


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
    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise, imagen_from_config
    from diffusioniqt_tpu_torch.evaluate import evaluate
    from diffusioniqt_tpu_torch.infer import (
        build_sampler,
        fake_subjects,
        fake_volumes,
        infer_volume,
    )
    from diffusioniqt_tpu_torch.models.blocks import Block
    from diffusioniqt_tpu_torch.models.unet3d import NullUnet, SRUnet256, iqt_unet_from_config
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
    card_settings()

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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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

    # the Blocks' statistics and tables: the group_norm pair against the
    # plain composition at every shape of GROUP_NORM_SHAPES; the first
    # GROUP_NORM_TIMED rows also timed (with torch.var_mean for the
    # statistics alone)
    for i, (n, s, c, f) in enumerate(GROUP_NORM_SHAPES):
        x = torch.randn((n, s, s, s, c), generator=gen, device=dev).to(torch.bfloat16)
        ns = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        nb = 0.1 * torch.randn(c, generator=gen, device=dev)
        # the time MLP's (scale, shift): two halves of one (rows, 1, 1, 1, 2C) bf16 tensor
        emb = 0.2 * torch.randn((n // f ** 3, 1, 1, 1, 2 * c), generator=gen, device=dev)
        sc, sh = emb.to(torch.bfloat16).chunk(2, dim=-1)
        args = (x, ns, nb, sc, sh, 8, f)
        kernels.reset_launch_counts()
        got = fused_module.norm_tables(*args)
        again = fused_module.norm_tables(*args)
        want = fused_module.norm_tables_plain(*args)
        torch.cuda.synchronize()
        shape = (n, s, s, s, c, f)
        if kernels.launch_counts()["group_norm"] != 2:
            raise AssertionError("group_norm: two calls did not count two launches")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"group_norm {shape}: two launches differ")
        stats = max((compare(f"group_norm {tab}", shape, g, w_, GROUP_NORM_TOL)
                     for tab, g, w_ in zip(("a_tab", "b_tab"), got, want)),
                    key=lambda st: st["max_abs_err"] / st["tol"])
        chunks = fused_module.norm_chunks(n, s ** 3, c, sms)
        results.setdefault("group_norm_compared", []).append(
            {"shape": [n, s, c, f], **stats, "chunks": chunks})
        if i >= GROUP_NORM_TIMED:
            del x, got, again, want
            continue
        xv = x.view(n, s ** 3, 8, c // 8)
        split = kernel_ms_by_tag(lambda: fused_module.norm_tables(*args),
                                 ("gn_stats::stats_kernel", "gn_stats::tables_kernel"))
        record("group_norm", (n, s, c), stats,
               timed(lambda: fused_module.norm_tables(*args)),
               cuda_time_ms(lambda: fused_module.norm_tables_plain(*args), iters=3),
               timed(lambda: torch.var_mean(xv, dim=(1, 3))),
               bound_ms(0.0, nbytes(x, *got)))
        row = results["group_norm"][-1]
        row["chunks"] = chunks
        row["stats_ms"], row["tables_ms"] = split.values()
        print(f"    {row['chunks']} chunks a sub-volume; profiler: statistics "
              f"{row['stats_ms']:.4f} ms ({100 * nbytes(x) / PEAK_HBM_BYTES / 1e-3 / row['stats_ms']:.1f}% "
              f"of HBM bandwidth), tables {row['tables_ms']:.4f} ms", flush=True)
        del x, xv, got, again, want

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

    # the path's shapes, then the column shards' (TP_FUSED_SHAPES), recorded
    # apart as fused_block_tp
    fused_rows = ([(n, s, cin, cout, "fused_block") for n, s, cin, cout in FUSED_SHAPES]
                  + [(BATCH, s, cin, cout, "fused_block_tp") for s, cin, cout in TP_FUSED_SHAPES])
    for n, s, cin, cout, row_name in fused_rows:
        factor = 3 if n == BATCH else 1
        x = torch.randn((n, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
        ns = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev)
        nb = 0.1 * torch.randn(cin, generator=gen, device=dev)
        ss = tuple(0.2 * torch.randn((n, 1, 1, 1, cin), generator=gen, device=dev)
                   for _ in range(2))
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
        a, b = groupnorm_affine(x, ns, nb, 8, scale_shift=ss)
        a_tab, b_tab = neighbor_tables(a, b, factor)
        xh = kernels.halo_exchange(x, factor)
        cache = PackedWeight()
        got = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
        want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
        torch.cuda.synchronize()
        stats = compare("fused_block", (n, s, cin, cout), got, want, BF16_TOL)
        brick = fused_module.brick_plan(n, s, cin, cout, sms)
        plan = brick._asdict()
        left = (f", the last {brick.units - brick.tail0} in ranges of chunks" if brick.split
                else "")
        print(f"    plan: BN {brick.bn}, kc {brick.kc} (channels a chunk), "
              f"{'whole' if brick.tap else 'half'}-tap groups, "
              f"{brick.units} units of {brick.chunks} chunks on {brick.ctas} CTAs: "
              f"{brick.rounds} rounds of whole units{left}; factor {factor}", flush=True)
        flops = 2.0 * n * s ** 3 * 27 * cin * cout
        # the GEMM's floor: cuDNN's conv alone on mish(A_r * xh + B_r),
        # materialised in bf16 outside the timed loop
        reg = fused_module._region_index(s + 2, dev)
        act = fused_module.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
        act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w_bf = w.to(torch.bfloat16)
        del act
        record(row_name, (n, s, cin, cout), stats,
               timed(lambda: kernels.fused_conv(xh, a_tab, b_tab, w, cache)),
               cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
               None, bound_ms(flops, nbytes(xh, a_tab, b_tab, w_bf, got)),
               conv_only_library_ms=timed(lambda: torch.nn.functional.conv3d(act_cf, w_bf)))
        results[row_name][-1]["plan"] = plan
        if (n, s, cin, cout) == (BATCH,) + HEADLINE["fused_block"]:
            # whole-tap groups at the headline, which keeps the half-tap unit: a
            # reading for the headline's later redesign, not a route
            tap = fused_module.make_brick_plan(n, s, cin, cout, sms, 64, tap=True)
            got_tap = fused_module.launch_brick(xh, a_tab, b_tab, cache.get(w), tap)
            torch.cuda.synchronize()
            compare("fused_block tap groups", (n, s, cin, cout), got_tap, want, BF16_TOL)
            t_tap = timed(lambda: fused_module.launch_brick(xh, a_tab, b_tab, cache.get(w), tap))
            results[row_name][-1].update(tap_unit_ms=t_tap[0], tap_unit_ms_min=t_tap[1],
                                         tap_unit_ms_max=t_tap[2])
            print(f"    whole-tap groups (not this shape's plan): {fmt(t_tap)}", flush=True)
            del got_tap
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

    # the fused Block's small-edge route and the halo at its input, at every
    # shape the presets launch it at (SMALL_EDGE_SHAPES)
    for n, s, cin, cout, f in SMALL_EDGE_SHAPES:
        x = torch.randn((n, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
        xh = kernels.halo_exchange(x, f)
        want = halo_plain(x, f)
        torch.cuda.synchronize()
        stats = compare("halo small edge", (n, s, s, s, cin), xh, want, 0.0)
        if f == 1:
            lib = lambda: torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))  # noqa: E731
        else:  # the gather yardstick of the halo rows above
            ids = torch.arange(1, n * s ** 3 + 1, device=dev).view(n, s, s, s, 1)
            src_ids = halo_plain(ids, f).flatten()
            idx = torch.where(src_ids == 0, n * s ** 3, src_ids - 1)
            src = torch.cat([x.reshape(-1, cin), x.new_zeros((1, cin))])
            lib = lambda: torch.index_select(src, 0, idx)  # noqa: E731
        if not torch.equal(lib().view_as(xh), xh):
            raise AssertionError("halo small edge: the library yardstick disagrees with the kernel")
        record("halo_small", (n, s, cin), stats, timed(lambda: kernels.halo_exchange(x, f)),
               cuda_time_ms(lambda: halo_plain(x, f)), timed(lib), bound_ms(0.0, nbytes(x, xh)))
        results["halo_small"][-1]["factor"] = f
        ns = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev)
        nb = 0.1 * torch.randn(cin, generator=gen, device=dev)
        ss = tuple(0.2 * torch.randn((n, 1, 1, 1, cin), generator=gen, device=dev)
                   for _ in range(2))
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
        a, b = groupnorm_affine(x, ns, nb, 8, scale_shift=ss)
        a_tab, b_tab = neighbor_tables(a, b, f)
        cache = PackedWeight()
        before = kernels.launch_counts()["fused_block_small"]
        got = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
        if kernels.launch_counts()["fused_block_small"] != before + 1:
            raise AssertionError(f"fused_block at s={s} did not take the small-edge route")
        again = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
        want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
        torch.cuda.synchronize()
        stats = compare("fused_block small edge", (n, s, cin, cout), got, want, BF16_TOL)
        if not torch.equal(got, again):
            raise AssertionError(f"fused_block small edge {(n, s, cin, cout)}: two launches "
                                 "differ")
        reg = fused_module._region_index(s + 2, dev)
        act = fused_module.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
        act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w_bf = w.to(torch.bfloat16)
        del act
        plan = fused_module.small_edge_plan(n, s, cin, cout, sms)
        print(f"    plan: tiles {plan.m_blocks} x {plan.n_blocks} of {plan.subs} "
              f"sub-volumes x {plan.bn} channels, {plan.k_slices // 27} chunks each, "
              f"{plan.ctas} CTAs in pairs, cut {plan.cut}")
        record("fused_block_small", (n, s, cin, cout), stats,
               timed(lambda: kernels.fused_conv(xh, a_tab, b_tab, w, cache)),
               cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
               None, bound_ms(2.0 * n * s ** 3 * 27 * cin * cout,
                              nbytes(xh, a_tab, b_tab, w_bf, got)),
               conv_only_library_ms=timed(lambda: torch.nn.functional.conv3d(act_cf, w_bf)))
        results["fused_block_small"][-1]["factor"] = f
        del act_cf, xh, got, again, want, x
    brick = next(r for r in results["fused_block"] if tuple(r["shape"][1:]) == (32, 64, 64))
    lo, hi = BRICK_ROUTE_SPREAD_MS
    held = lo * (1 - BRICK_ROUTE_MARGIN) <= brick["ms"] <= hi * (1 + BRICK_ROUTE_MARGIN)
    print(f"  fused_block brick route (216, 32^3, 64->64): {brick['ms']:.4f} ms, recorded "
          f"spread {lo}-{hi}: {'within' if lo <= brick['ms'] <= hi else 'OUTSIDE'} "
          f"(margin {BRICK_ROUTE_MARGIN:.0%}: {'held' if held else 'missed'})", flush=True)
    if not held and power_watts(smi) >= BRICK_ROUTE_WATTS:
        raise AssertionError(f"fused_block brick route: {brick['ms']:.4f} ms outside "
                             f"{lo}-{hi} ms widened by {BRICK_ROUTE_MARGIN:.0%}")

    for nb, heads, nq, nk, d in FLASH_SHAPES:
        bh = nb * heads
        q = torch.randn((bh, nq, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((bh, nk, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        scale = d ** -0.5
        got = kernels.flash_attention(q, k, v, scale)
        want = kernels.attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        stats = compare("flash_attention", (bh, nq, nk, d), got, want, FLASH_TOL)
        # the library yardstick: one SDPA call over (batch, heads, N, D)
        q4 = q.view(nb, heads, nq, d)
        k4, v4 = (a.view(nb, heads, nk, d) for a in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        record("flash_attention", (bh, nq, nk, d), stats,
               timed(lambda: kernels.flash_attention(q, k, v, scale)),
               cuda_time_ms(lambda: kernels.attention_reference(q, k, v, scale), iters=3),
               timed(lambda: sdpa(q4, k4, v4, scale=scale)),
               bound_ms(4.0 * bh * nq * nk * d, nbytes(q, k, v, got)))
        del q, k, v, q4, k4, v4, got, want
    print(f"kernels seconds {time.perf_counter() - t0:.1f}", flush=True)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernel_rows": results}))
        return 0

    def held_forward(label, cfg, want_counts, profile, build=None, serve_batch=False,
                     profile_rows=BATCH):
        """One 27 x 32^3 window through the kernels and through the plain
        versions: exact launch counts, agreement within FORWARD_REL_TOL.
        ``build`` makes the model (default: ``iqt_unet_from_config(cfg)``),
        seeded. The small-edge Blocks of the window's forward (and, with
        ``serve_batch``, of one forward at the serve batch) must all be
        shapes of SMALL_EDGE_SHAPES. With ``--profile``, one forward of
        ``profile_rows`` sub-volumes is profiled. Returns ms per forward and
        the Blocks' conv GFLOP."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = (build() if build else iqt_unet_from_config(cfg, device=dev)).eval()
        x, lowres = (torch.randn((BATCH, SUB, SUB, SUB, 1), generator=gen, device=dev)
                     for _ in range(2))
        t = torch.full((BATCH,), 0.5, device=dev)
        log_snr = torch.full((BATCH,), -1.0, device=dev)
        if profile and "--profile" in sys.argv[1:]:
            r = profile_rows
            with torch.no_grad():
                call = lambda: model(x[:r], t[:r], log_snr[:r],  # noqa: E731
                                     lowres_cond_img=lowres[:r])
                profile_forward(f"{label} ({r} x 32^3)", call)
                slots = [d[2] for d in model.downs if not isinstance(d[2], torch.nn.Identity)]
                slots += [model.mid_attn] if model.mid_attn is not None else []
                if slots:
                    print(f"  attention slots (CUDA events): {slots_ms(call, slots):.3f} ms "
                          f"of one forward, {len(slots)} slots", flush=True)
        seen = collections.Counter()
        if serve_batch:
            with torch.no_grad():
                model.use_ops(recording_ops(seen))(x, t, log_snr, lowres_cond_img=lowres)
                model.use_ops(kernels.KERNELS)
        # the held forward: one window's 27 sub-volumes
        x, lowres, t, log_snr = x[:GROUP], lowres[:GROUP], t[:GROUP], log_snr[:GROUP]
        flops = []  # the Blocks' 3^3 convs: 2 * voxels * 27 * Cin * Cout each
        hooks = [m.register_forward_pre_hook(
            lambda mod, a: flops.append(2.0 * a[0][..., 0].numel() * 27 * a[0].shape[-1]
                                        * mod.project.out_channels))
            for m in model.modules() if isinstance(m, Block)]
        with torch.no_grad():
            kernels.reset_launch_counts()
            out_k = model.use_ops(recording_ops(seen))(x, t, log_snr, lowres_cond_img=lowres)
            torch.cuda.synchronize()
            per_forward = kernels.launch_counts()
            model.use_ops(kernels.KERNELS)
            for h in hooks:
                h.remove()
            print(f"launches per forward {per_forward}")
            if seen:
                print(f"small-edge Blocks (B, s, Cin, Cout, factor): {dict(seen)}")
            if not set(seen) <= set(SMALL_EDGE_SHAPES):
                raise AssertionError(f"{label}: small-edge shapes {sorted(set(seen))} not all in "
                                     f"SMALL_EDGE_SHAPES")
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
        print(f"ms per forward (27x32^3, bf16): kernels {fwd_ms:.3f} plain {plain_fwd_ms:.3f}; "
              f"the Blocks' 3^3 convs {sum(flops) / 1e9:.1f} GFLOP ({len(flops)} Blocks); "
              f"parameters {sum(p.numel() for p in model.parameters())}", flush=True)
        if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError(f"{label}: forward through the kernels disagrees with "
                                 "the plain path")
        return {"ms": fwd_ms, "gflop": sum(flops) / 1e9, "model": model}

    brick_shapes = {}  # path -> Counter of the brick-route shapes it launches

    def record_brick_shapes(label, unet, rows, forwards):
        """One untimed forward of ``unet`` at ``rows`` sub-volumes through
        :func:`shape_recording_ops`: keep its brick-route (B, s, Cin, Cout)
        launches, times the ``forwards`` of path ``label``; fail unless
        FUSED_SHAPES holds each."""
        seen = collections.Counter()
        g = torch.Generator(device=dev).manual_seed(0)
        x, lowres = (torch.randn((rows, SUB, SUB, SUB, 1), generator=g, device=dev)
                     for _ in range(2))
        with torch.no_grad():
            unet.use_ops(shape_recording_ops(seen))(
                x, torch.full((rows,), 0.5, device=dev), torch.full((rows,), -1.0, device=dev),
                lowres_cond_img=lowres)
            unet.use_ops(kernels.KERNELS)
        brick = collections.Counter({k: v * forwards for k, v in seen.items() if k[1] % 8 == 0})
        brick_shapes[label] = brick
        print(f"{label} brick-route Blocks (B, s, Cin, Cout): {dict(brick)}", flush=True)
        if not set(brick) <= set(FUSED_SHAPES):
            raise AssertionError(f"{label}: brick-route shapes {sorted(set(brick) - set(FUSED_SHAPES))}"
                                 " not in FUSED_SHAPES")

    def serve(cfg, per_forward, label=None):
        """infer_volume on the seeded fake 128^3 volume; the launches must be
        ``per_forward`` times the forwards the sampler ran (one per step for
        the ancestral sampler, two per Heun step but the last one for EDM).
        With ``label``, the run's brick-route shapes are recorded under it
        first, from one untimed forward (:func:`record_brick_shapes`).
        Returns the launches, the prediction, the fake highres volume and
        the seconds of the run."""
        edge, windows_per_batch = 128, WINDOWS
        if cfg.train.elucidated:
            steps = cfg.train.edm_num_sample_steps
            nfe = 2 * steps - 1
        else:
            steps = nfe = cfg.train.timesteps
        imagen = build_sampler(cfg, device=dev, seed=0)
        n_windows = ((edge - cfg.train.patch_size) // cfg.eval.overlap + 1) ** 3
        n_calls = -(-n_windows // windows_per_batch)
        if label:
            record_brick_shapes(label, imagen.unets[1],
                                min(n_windows, windows_per_batch) * GROUP, nfe * n_calls)
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
        return served, pred, highres_vol, serve_s

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

    def edm_merged(cfg):
        """edm-step's call with ``merged_boundary=True`` (the same weights
        and noise) against the split model: merged mode runs on the split
        kernels, so the two must agree bit for bit."""
        split = build_sampler(cfg, device=dev, seed=0)
        merged_unet = iqt_unet_from_config(cfg, device=dev, merged_boundary=True).eval()
        merged_unet.load_state_dict(split.unets[-1].state_dict())
        merged = elucidated_imagen_from_config(cfg, (NullUnet().to(dev), merged_unet))
        lowres = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)

        def run(imagen):
            noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
            return imagen.sample(batch_size=GROUP, noise=noise, start_at_unet_number=2,
                                 start_image_or_video=lowres)

        kernels.reset_launch_counts()
        out_m = run(merged)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        out_s = run(split)
        equal = torch.equal(out_m, out_s)
        print(f"edm 2 steps, merged_boundary vs split: out {tuple(out_m.shape)} finite "
              f"{bool(torch.isfinite(out_m).all())} equal {equal} max abs diff "
              f"{(out_m - out_s).abs().max().item():.3e}; launches {counts}", flush=True)
        if counts != {k: 3 * n for k, n in FLAGSHIP_COUNTS.items()}:
            raise AssertionError(f"edm-merged launches {counts}")
        if not (torch.isfinite(out_m).all() and equal):
            raise AssertionError("edm-merged: merged mode differs from the split layout")

    def missing_pieces(cfg):
        """The reference blocks that the U-Net leaves off, at the flagship's
        widths on one window, and the wrappers' casting of their U-Nets
        (the docstring's missing-pieces entry). Returns the launches of
        the combiner's forward."""
        from diffusioniqt_tpu_torch.models.blocks import (
            StridedDownsample,
            TrilinearUpsample,
            UpsampleCombiner,
        )
        from diffusioniqt_tpu_torch.models.unet3d import UNet3D

        def bf16(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        x = bf16(GROUP, SUB, SUB, SUB, COMBINER_DIM)
        fmaps = [bf16(GROUP, SUB // 2 ** (i + 1), SUB // 2 ** (i + 1), SUB // 2 ** (i + 1), c)
                 for i, c in enumerate(COMBINER_DIM_INS)]
        torch.manual_seed(0)
        comb = UpsampleCombiner(COMBINER_DIM, enabled=True, dim_ins=COMBINER_DIM_INS,
                                dim_outs=COMBINER_DIM_OUTS).to(dev)
        with torch.no_grad():  # a GroupNorm affine and conv bias away from 1 / 0
            for blk in comb.fmap_convs:
                for prm, base in ((blk.groupnorm.weight, 1.0), (blk.groupnorm.bias, 0.0),
                                  (blk.project.bias, 0.0)):
                    prm.copy_(base + 0.1 * torch.randn(prm.shape, generator=gen, device=dev))
        kernels.reset_launch_counts()
        got = comb(x, fmaps)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for blk in comb.fmap_convs:
            blk.ops = kernels.PLAIN
        want = comb(x, fmaps)
        plain_ms = cuda_time_ms(lambda: comb(x, fmaps), iters=3)
        for blk in comb.fmap_convs:
            blk.ops = kernels.KERNELS
        if counts != {**NO_COUNTS, "halo": 2, "fused_block": 2, "group_norm": 2}:
            raise AssertionError(f"missing-pieces: the combiner launched {counts}")
        if not torch.equal(got[..., :COMBINER_DIM], x):
            raise AssertionError("missing-pieces: the combiner changed its input")
        lo = COMBINER_DIM
        for cin, cout in zip(COMBINER_DIM_INS, COMBINER_DIM_OUTS):
            compare("combiner Block, fused kernel at factor 1", (GROUP, SUB, cin, cout),
                    got[..., lo:lo + cout], want[..., lo:lo + cout], BF16_TOL)
            lo += cout
        ms = timed(lambda: comb(x, fmaps))
        flops = sum(2.0 * GROUP * SUB ** 3 * 27 * cin * cout
                    for cin, cout in zip(COMBINER_DIM_INS, COMBINER_DIM_OUTS))
        # the fmaps read, their resized copies written and read once, x and
        # the output
        resized = 2 * 2 * GROUP * SUB ** 3 * sum(COMBINER_DIM_INS)
        bound, by = bound_ms(flops, nbytes(x, *fmaps, got) + resized)
        print(f"combiner (27, 32^3, 64) + fmaps (16^3, 128), (8^3, 256) -> (64, 64): "
              f"{fmt(ms)} ms (plain {plain_ms:.4f}), bound {bound:.4f} ms ({by}), "
              f"launches {counts}", flush=True)
        del got, want

        for name, block, inp in (
                ("TrilinearUpsample", TrilinearUpsample(COMBINER_DIM_INS[0], COMBINER_DIM),
                 fmaps[0]),
                ("StridedDownsample", StridedDownsample(COMBINER_DIM, COMBINER_DIM_INS[0]), x)):
            block = block.to(dev)
            with torch.no_grad():
                out = block(inp)
                cpu = block.cpu()(inp[:2].float().cpu())
            block.to(dev)
            compare(f"{name} against the CPU (fp32)", tuple(inp.shape), out[:2],
                    cpu.to(dev), BF16_TOL)
            print(f"{name} {tuple(inp.shape)} -> {tuple(out.shape)}: "
                  f"{fmt(timed(lambda: block(inp)))} ms", flush=True)

        # the flagship behind Imagen([NullUnet(), UNet3D(lowres_cond=False)]):
        # the wrapper casts unet 2 to the lowres-conditioned flagship
        ref = build_sampler(cfg, device=dev, seed=0)
        bare = UNet3D(**{**ref.unets[1].config, "lowres_cond": False}).to(dev)
        cast = imagen_from_config(cfg, (NullUnet().to(dev), bare))
        unet = cast.get_unet(2)
        if unet is bare or not unet.lowres_cond or unet.init_conv.weight.shape[1] != 2:
            raise AssertionError("missing-pieces: unet 2 was not cast to lowres conditioning")
        unet.load_state_dict(ref.unets[1].state_dict())
        unet.eval()
        lowres = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)

        def run(imagen):
            noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
            return imagen.sample(batch_size=GROUP, noise=noise, start_at_unet_number=2,
                                 start_image_or_video=lowres)

        kernels.reset_launch_counts()
        out_cast = run(cast)
        torch.cuda.synchronize()
        cast_counts = kernels.launch_counts()
        out_ref = run(ref)
        equal = torch.equal(out_cast, out_ref)
        print(f"cast wrapper, {cfg.train.timesteps}-step ancestral call of one window: "
              f"finite {bool(torch.isfinite(out_cast).all())} equal to today's wrapper "
              f"{equal}; launches {cast_counts}", flush=True)
        if cast_counts != {k: cfg.train.timesteps * n for k, n in FLAGSHIP_COUNTS.items()}:
            raise AssertionError(f"missing-pieces: the cast wrapper launched {cast_counts}")
        if not (torch.isfinite(out_cast).all() and equal):
            raise AssertionError("missing-pieces: the cast wrapper differs from today's")
        return counts

    def train_remat_conv():
        """The gate's step under full remat and under remat_policy 'conv' from
        the same weights, batches and draws; then none / full / 'conv' on one
        27 x 32^3 microbatch."""
        from diffusioniqt_tpu_torch import quality_run

        cfg = quality_run.flagship_cfg(elucidated=True, device=dev)
        cfg.train.edm_sigma_data = QUALITY_SIGMA_DATA
        pairs = quality_run.training_pairs(PHANTOM_EDGE, PHANTOMS)
        cfg.data.mean, cfg.data.std = population_stats([lr for _, lr in pairs])
        cfg.data.mean_hr, cfg.data.std_hr = population_stats([hr for hr, _ in pairs])
        dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)
        items = [dataset[j] for j in range(REMAT_CONV_STEPS * QUALITY_PATCHES)]
        batches = [tuple(np.stack(a) for a in zip(*items[i * QUALITY_PATCHES:
                                                         (i + 1) * QUALITY_PATCHES]))
                   for i in range(REMAT_CONV_STEPS)]
        rows = QUALITY_PATCHES * GROUP // QUALITY_ACCUM
        state, out = None, {}
        for policy in (None, "conv"):
            trainer = quality_run.build_trainer(cfg, accum=QUALITY_ACCUM, remat=True,
                                                device=dev, remat_policy=policy)
            unet = trainer.imagen.unets[1]
            if state is None:
                state = {k: v.detach().clone() for k, v in unet.state_dict().items()}
            else:
                unet.load_state_dict(state)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step_s, counts, losses = [], [], []
            for i, batch in enumerate(batches):
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(trainer.train_step(unet_number=2, batch=batch))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                counts.append(kernels.launch_counts())
                if i == 0:
                    grads = {k: p.grad.detach().cpu() for k, p in unet.named_parameters()}
            peak = torch.cuda.max_memory_allocated()
            hr, lr = trainer._maybe_batch_sample_split(*trainer._device_batch(batches[0]))
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            loss = trainer._loss(1, hr[:rows], lr[:rows], {})
            events[1].record()
            loss.backward()
            events[2].record()
            torch.cuda.synchronize()
            fwd, bwd = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
            want = {k: QUALITY_ACCUM * n for k, n in
                    (REMAT_COUNTS if policy is None else FLAGSHIP_COUNTS).items()}
            name = "full" if policy is None else "conv"
            med = sorted(step_s[1:])[len(step_s[1:]) // 2]
            print(f"remat {name}: gate step ({QUALITY_ACCUM} microbatches of {rows} x 32^3) "
                  f"losses {' '.join(f'{v:.5f}' for v in losses)}; step seconds "
                  f"{' '.join(f'{v:.3f}' for v in step_s)}, median of steps 2-"
                  f"{REMAT_CONV_STEPS} {med:.4f}; microbatch forward {fwd:.3f} ms backward "
                  f"{bwd:.3f} ms, backward share {bwd / (fwd + bwd):.3f}; peak memory "
                  f"{peak / 2 ** 30:.2f} GiB; launches per step {counts[0]}, per microbatch "
                  f"{ {k: v // QUALITY_ACCUM for k, v in counts[0].items()} }", flush=True)
            if any(c != want for c in counts):
                raise AssertionError(f"train-remat-conv {name}: launches {counts}, expected "
                                     f"{want} per step")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"train-remat-conv {name}: a loss is not finite")
            out[name] = {"s_per_step": med, "peak": peak, "grads": grads, "losses": losses,
                         "share": bwd / (fwd + bwd)}
            if policy == "conv":
                break
            del trainer, unet, loss, grads
            torch.cuda.empty_cache()
        per, cos_all, norm_rel = grad_stats(out["conv"]["grads"], out["full"]["grads"])
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        print(f"  step-1 gradient 'conv' vs full remat: whole cos {cos_all:.7f} (min "
              f"{GRAD_GLOBAL_COS_MIN}), norm rel {norm_rel:.3e} (tol {GRAD_GLOBAL_NORM_REL_TOL}), "
              f"per-tensor cos min {worst[0][1]:.6f} (min {GRAD_TENSOR_COS_MIN}); s per gate step "
              f"full {out['full']['s_per_step']:.4f} 'conv' {out['conv']['s_per_step']:.4f}; "
              f"peak full {out['full']['peak'] / 2 ** 30:.2f} 'conv' "
              f"{out['conv']['peak'] / 2 ** 30:.2f} GiB", flush=True)
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > GRAD_GLOBAL_NORM_REL_TOL
                or worst[0][1] < GRAD_TENSOR_COS_MIN):
            raise AssertionError("train-remat-conv: 'conv' gradients disagree with full remat's")

        # none / full / 'conv' on one 27 x 32^3 microbatch, cuDNN deterministic
        imagen, model = trainer.imagen, unet
        hr27, lr27 = hr[:GROUP], lr[:GROUP]
        draws = {"sigmas": imagen.hparams[1].noise_distribution(gen, GROUP),
                 "noise": torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)}
        torch.backends.cudnn.deterministic = True
        three = {}
        for name, remat, policy in (("none", False, None), ("full", True, None),
                                    ("conv", True, "conv")):
            model.remat, model.remat_policy = remat, policy
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            loss = imagen.forward(hr27, lr27, unet_number=2, **draws)
            events[1].record()
            loss.backward()
            events[2].record()
            torch.cuda.synchronize()
            three[name] = {"fwd": events[0].elapsed_time(events[1]),
                           "bwd": events[1].elapsed_time(events[2]),
                           "peak": torch.cuda.max_memory_allocated() - base,
                           "counts": kernels.launch_counts(),
                           "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()}}
            print(f"  27 x 32^3 microbatch, remat {name}: forward {three[name]['fwd']:.3f} ms, "
                  f"backward {three[name]['bwd']:.3f} ms, peak memory above the "
                  f"{base / 2 ** 30:.2f} GiB before it {three[name]['peak'] / 2 ** 30:.3f} GiB, "
                  f"launches {three[name]['counts']}", flush=True)
        torch.backends.cudnn.deterministic = False
        model.remat, model.remat_policy = True, "conv"
        diff = {n: max((three[n]["grads"][k] - three["none"]["grads"][k]).abs().max().item()
                       for k in three["none"]["grads"]) for n in ("full", "conv")}
        print(f"  gradients against none: full remat max abs diff {diff['full']:.3e}, 'conv' "
              f"{diff['conv']:.3e}", flush=True)
        if three["conv"]["counts"] != FLAGSHIP_COUNTS or three["full"]["counts"] != REMAT_COUNTS:
            raise AssertionError("train-remat-conv: launches per microbatch differ")
        if diff["conv"] != 0.0:
            raise AssertionError("train-remat-conv: 'conv' gradients differ from no remat's")
        if not three["full"]["peak"] < three["conv"]["peak"] <= three["none"]["peak"]:
            raise AssertionError("train-remat-conv: 'conv' peak memory is not between full "
                                 "remat's and no remat's")
        del trainer, model, imagen, three, out
        torch.cuda.empty_cache()

    def preset_srunet256(cfg):
        """SRUnet256 at full width on one 96^3 window: the held forward, then
        one 20-step ancestral sampler call (``cfg``'s Gaussian wrapper)."""
        def build():
            with torch.device(dev):
                return SRUnet256(channels=1, lowres_cond=True, dtype=torch.bfloat16)

        torch.cuda.reset_peak_memory_stats()
        held = held_forward("SRUnet256", None, SRUNET_COUNTS, profile=True, build=build,
                            profile_rows=GROUP)
        model = held["model"]
        imagen = imagen_from_config(cfg, (NullUnet().to(dev), model))
        lowres = torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
        steps = cfg.train.timesteps
        record_brick_shapes("preset-srunet256 sampler call", imagen.unets[1], GROUP, steps)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = imagen.sample(batch_size=GROUP,
                                noise=gaussian_noise(torch.Generator(device=dev).manual_seed(0)),
                                start_at_unet_number=2, start_image_or_video=lowres)
        torch.cuda.synchronize()
        calls = [time.perf_counter() - t0]
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for _ in range(HOST_REPEATS - 1):  # the same call again, for the spread
            t0 = time.perf_counter()
            with torch.no_grad():
                imagen.sample(batch_size=GROUP,
                              noise=gaussian_noise(torch.Generator(device=dev).manual_seed(0)),
                              start_at_unet_number=2, start_image_or_video=lowres)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        calls.sort()
        call_s = calls[len(calls) // 2]
        print(f"SRUnet256 {sum(p.numel() for p in model.parameters())} parameters; a "
              f"{steps}-step ancestral call of a 96^3 window: {call_s:.3f} s [{calls[0]:.3f}-"
              f"{calls[-1]:.3f}] over {len(calls)} calls, {call_s * 1e3 / steps:.3f} ms per step "
              f"[{calls[0] * 1e3 / steps:.3f}-{calls[-1] * 1e3 / steps:.3f}]; held forward "
              f"{held['ms']:.3f} ms, "
              f"{held['gflop']:.1f} GFLOP in the Blocks' convs; peak memory "
              f"{peak / 2 ** 30:.2f} GiB; out {tuple(out.shape)} finite "
              f"{bool(torch.isfinite(out).all())}; launches {counts}", flush=True)
        if counts != {k: steps * n for k, n in SRUNET_COUNTS.items()}:
            raise AssertionError(f"preset-srunet256: launches {counts}")
        if out.shape != (GROUP, SUB, SUB, SUB, 1) or not torch.isfinite(out).all():
            raise AssertionError("preset-srunet256: the sample is not finite or of the shape")
        del model, imagen, held
        torch.cuda.empty_cache()
        return counts

    def cli_phase():
        """``python -m diffusioniqt_tpu_torch.cli`` config, train, sample as
        subprocesses on the card."""
        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            def run(*argv):
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "diffusioniqt_tpu_torch.cli", *argv], cwd=ROOT,
                    env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True,
                    timeout=600)
                lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
                print(f"cli {argv[0]}: rc {proc.returncode} in {time.perf_counter() - t0:.1f} "
                      f"s; {lines[-2:]}", flush=True)
                if proc.returncode != 0:
                    raise AssertionError(f"cli {argv[0]} failed:\n" + proc.stdout[-3000:]
                                         + proc.stderr[-3000:])

            starter = os.path.join(work, "starter.json")
            run("config", "--path", starter)
            with open(starter) as fh:
                if set(json.load(fh)) != {"elucidated", "imagen"}:
                    raise AssertionError("cli config: not a model config")
            tiny, ckpt = os.path.join(work, "tiny.json"), os.path.join(work, "ckpt.pt")
            samples = os.path.join(work, "samples.npy")
            with open(tiny, "w") as fh:
                json.dump(CLI_TINY_CONFIG, fh)
            run("train", "--config", tiny, "--checkpoint", ckpt, "--steps", "2",
                "--batch-size", "2")
            run("sample", "--config", tiny, "--checkpoint", ckpt, "--batch-size", "2",
                "--output", samples)
            arr = np.load(samples)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"cli samples {arr.shape} finite {bool(np.isfinite(arr).all())}", flush=True)
        if arr.shape != (2, 8, 8, 8, 1) or not np.isfinite(arr).all():
            raise AssertionError("cli: the samples are not finite or of the shape")

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

        # the plain path's squeeze-excite gates on the kernel path's branches
        branches = SEBranches(model)
        branches.mode = "record"
        loss_k, grads_k, counts = run(kernels.KERNELS)
        branches.mode = None
        _, grads_k2, _ = run(kernels.KERNELS)
        branches.mode = "pin"
        loss_p, grads_p, _ = run(kernels.PLAIN, remat=True)
        branches.mode = None
        loss_r, grads_r, counts_r = run(kernels.KERNELS, remat=True)
        branches.remove()
        model.use_ops(kernels.KERNELS)
        model.remat = False
        torch.backends.cudnn.deterministic = False
        print(f"train-step loss kernels {loss_k:.6f} plain {loss_p:.6f} remat {loss_r:.6f}; "
              f"launches {counts}, with remat {counts_r}; squeeze-excite units the plain "
              f"path's own ReLU would have decided otherwise: {branches.flipped()}")
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
              f"{TRAIN_STEPS} {med:.4f} s [{min(step_s[1:]):.4f}-{max(step_s[1:]):.4f}], "
              f"{TRAIN_PATCHES / med:.3f} patches/s of 96^3; peak "
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

    def edm_probe_phase(ckpt, work):
        """``python -m diffusioniqt_tpu_torch.edm_probe`` over the gate's
        bundle (``stats.json`` beside it) at ``--size EDM_PROBE_SIZE``: its
        table printed, finite, one row per sigma of the default ladder;
        two flagship forwards per sigma through the kernels (unclamped and
        clamped). Returns the launches."""
        from diffusioniqt_tpu_torch import edm_probe

        sigmas = edm_probe.SIGMAS.split(",")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        table = edm_probe.main(["--ckpt", ckpt, "--size", str(EDM_PROBE_SIZE),
                                "--out", os.path.join(work, "probe.json")])
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        probed = kernels.launch_counts()
        want = {k: 2 * len(sigmas) * n for k, n in FLAGSHIP_COUNTS.items()}
        print(f"edm-probe: {probe_s:.1f} s (the trainer's build and the bundle's load "
              f"included); launches {probed}", flush=True)
        values = [table["baseline_rmse_lr"], table["data_std"]] + [
            row[k] for row in table["rows"] for k in ("rmse_in", "rmse_D", "rmse_D_clamped")]
        if len(table["rows"]) != len(sigmas) or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"edm-probe: the table is not finite rows per sigma: {table}")
        if probed != want:
            raise AssertionError(f"edm-probe launches {probed}, expected {want}")
        return probed

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
        # the same first step (batch, draws) from torch's default initialisers,
        # which the port drew before it took the JAX package's
        old = gate_trainer()
        with torch.no_grad():
            torch.manual_seed(cfg.train.seed)
            torch_default_init_(old.imagen.unets[1])
        old_loss = old.train_step(unet_number=2)
        del old
        torch.cuda.empty_cache()
        print(f"gate step-1 loss {losses[0]:.4f} from the port's initialisers (flax's "
              f"lecun_normal, zero biases); {old_loss:.4f} from torch's defaults on the same "
              f"batch and draws (the JAX gate run r5: 13.136)", flush=True)
        if not math.isfinite(old_loss):
            raise AssertionError("quality: the step from torch's default init is not finite")

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
            phase("edm-probe")
            probed = edm_probe_phase(ckpt, work)
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
        return total, evaluated, probed

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

        # the plain path's squeeze-excite gates on the kernel path's branches
        branches = SEBranches(model)
        branches.mode = "record"
        loss_k, grads_k, counts = run(kernels.KERNELS)
        branches.mode = "pin"
        loss_p, grads_p, _ = run(kernels.PLAIN, remat=True)
        branches.remove()
        model.use_ops(kernels.KERNELS)
        model.remat = False
        model.zero_grad(set_to_none=True)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        per, cos_all, norm_rel = grad_stats(grads_k, grads_p)
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        del grads_k, grads_p
        print(f"microbatch 27 x 32^3 (x_start, SAME convs, term {flag}): loss kernels "
              f"{loss_k:.6f} plain {loss_p:.6f} (rel {rel:.3e}, tol {FORWARD_REL_TOL}); "
              f"launches {counts}; squeeze-excite units flipped {branches.flipped()}; "
              f"gradients: whole cos {cos_all:.6f} (min "
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

    def ddp_ranks():
        """(world, backend for launch): NCCL over min(cards, 4) cards, or 2
        gloo ranks sharing the one card."""
        count = torch.cuda.device_count()
        return (min(count, 4), None) if count >= 2 else (2, "gloo")

    def ddp_train(pairs):
        """The mesh trainer over the ranks against the 1-rank trainer on the
        same global batches and seed; then a 1-rank NCCL world through the
        training entry point."""
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        world, backend = ddp_ranks()
        crops = DDP_CROPS_PER_RANK * world
        cfg = load_config(os.path.join(ROOT, EDM_CONFIG))
        cfg.data.mean, cfg.data.std = population_stats([lr for _, lr in pairs])
        cfg.train.gradient_accumulation_steps = DDP_ACCUM
        cfg.train.ema_update_every, cfg.train.ema_update_after_step = 1, 0
        dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)
        items = [dataset[j] for j in range(DDP_STEPS * crops)]
        batches = [tuple(np.stack(a) for a in zip(*items[i * crops:(i + 1) * crops]))
                   for i in range(DDP_STEPS)]
        print(f"{DDP_STEPS} global batches of {crops} crops of {cfg.train.patch_size}^3; "
              f"{world} ranks ({backend or 'nccl'}) of {DDP_CROPS_PER_RANK} crops, accum "
              f"{DDP_ACCUM}", flush=True)

        ref = build_trainer(cfg, dev)
        ref.imagen.unets[1].remat = world > 2  # a microbatch of 27 x world rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses1, step_s1, grads1 = [], [], None
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses1.append(ref.train_step(unet_number=2, batch=batch))
            torch.cuda.synchronize()
            step_s1.append(time.perf_counter() - t0)
            if i == 0:
                grads1 = {k: p.grad.detach().cpu() for k, p in
                          ref.imagen.unets[1].named_parameters()}
        peak1 = torch.cuda.max_memory_allocated()
        del ref
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = launch(ddp_train_rank, (cfg, batches), nprocs=world, device="cuda",
                       backend=backend, timeout_s=DDP_RANK_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        r0 = ranks[0]
        want = {k: DDP_STEPS * DDP_ACCUM * n for k, n in FLAGSHIP_COUNTS.items()}
        print(f"backend {r0['backend']} world {r0['world']} devices "
              f"{[r['device'] for r in ranks]}"
              + (" (ranks sharing one card: correctness and overhead, not scaling)"
                 if backend == "gloo" else ""))
        print(f"losses W={world} {' '.join(f'{v:.6f}' for v in r0['losses'])}; 1 rank "
              f"{' '.join(f'{v:.6f}' for v in losses1)}")
        print(f"s per step W={world} {' '.join(f'{v:.3f}' for v in r0['step_s'])} (rank 0), "
              f"1 rank {' '.join(f'{v:.3f}' for v in step_s1)}; launch of the ranks "
              f"{launch_s:.1f} s")
        for r, rank in enumerate(ranks):
            print(f"  rank {r}: all-reduce per step ms (events) "
                  f"{' '.join(f'{e:.3f}' for e, _, _ in rank['reductions'])}, ms (host) "
                  f"{' '.join(f'{h:.3f}' for _, h, _ in rank['reductions'])}, bytes "
                  f"{rank['reductions'][0][2]}; peak memory {rank['peak'] / 2 ** 30:.2f} GiB; "
                  f"launches {rank['launches']}")
        print(f"  1 rank: peak memory {peak1 / 2 ** 30:.2f} GiB", flush=True)
        unequal = [f"{what} {k}" for rank in ranks[1:] for what in ("params", "ema")
                   for k, v in r0[what].items() if not torch.equal(v, rank[what][k])]
        per, cos_all, norm_rel = grad_stats(r0["grads"], grads1)
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], losses1))
        local_rel = [max(abs(a - b) / abs(b) for a, b in zip(rank["local_losses"], losses1))
                     for rank in ranks]
        print(f"  ranks bitwise equal after {DDP_STEPS} steps: {not unequal}; step-1 gradient "
              f"W={world} vs 1 rank: whole cos {cos_all:.7f} (min {GRAD_GLOBAL_COS_MIN}), norm "
              f"rel {norm_rel:.3e} (tol {DDP_GRAD_NORM_REL_TOL}), per-tensor cos min "
              f"{worst[0][1]:.6f} (min {GRAD_TENSOR_COS_MIN}) {worst}; losses max rel diff "
              f"{rel:.3e} (tol {DDP_LOSS_REL_TOL}); a rank's own rows' loss (no all-reduce) "
              f"vs 1 rank: max rel diff per rank "
              f"{' '.join(f'{v:.3e}' for v in local_rel)}"
              + ("" if min(local_rel) > DDP_LOSS_REL_TOL else
                 " (at or under the limit: this run's loss check could not tell a "
                 "rank's own loss from the mean)"), flush=True)
        if unequal:
            raise AssertionError(f"ddp-train: the ranks' weights differ: {unequal[:5]}")
        if any(rank["launches"] != want for rank in ranks):
            raise AssertionError(f"ddp-train launches {[r['launches'] for r in ranks]}, "
                                 f"expected {want} per rank")
        if not (all(math.isfinite(v) for v in r0["losses"]) and rel <= DDP_LOSS_REL_TOL):
            raise AssertionError("ddp-train: the losses disagree with the 1-rank trainer's")
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > DDP_GRAD_NORM_REL_TOL
                or worst[0][1] < GRAD_TENSOR_COS_MIN):
            raise AssertionError("ddp-train: the all-reduced gradient disagrees with the "
                                 "1-rank trainer's")

        # a 1-rank NCCL world through the entry point, as torchrun starts it
        import yaml

        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            raw = yaml.safe_load(open(os.path.join(ROOT, EDM_CONFIG)))
            raw["Train"]["pretrain"] = False
            raw["Eval"]["repeat"] = 1
            raw["Results"] = os.path.join(work, "results")
            path = os.path.join(work, "edm.yaml")
            with open(path, "w") as fh:
                yaml.safe_dump(raw, fh)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", "-m", "diffusioniqt_tpu_torch.train", "--config",
                 path, "--fake-data", "--steps", "2", "--eval-every", "100"],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                text=True, timeout=DDP_RANK_TIMEOUT_S)
            entry_s = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
            print(f"torchrun --nproc-per-node 1 -m diffusioniqt_tpu_torch.train: rc "
                  f"{proc.returncode} in {entry_s:.1f} s; {lines[-4:]}", flush=True)
            if proc.returncode != 0 or "process group nccl, 1 rank" not in proc.stdout:
                raise AssertionError("ddp-train: the training entry point under torchrun "
                                     "failed:\n" + proc.stdout[-3000:] + proc.stderr[-3000:])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return r0["launches"]

    def tp_batches(pairs, data_ranks):
        """The EDM flagship's config (the EMA every step) and tp-train's
        global batches: TP_CROPS_PER_DATA_RANK crops of 96^3 per data rank."""
        cfg = load_config(os.path.join(ROOT, EDM_CONFIG))
        cfg.data.mean, cfg.data.std = population_stats([lr for _, lr in pairs])
        cfg.train.gradient_accumulation_steps = TP_ACCUM
        cfg.train.ema_update_every, cfg.train.ema_update_after_step = 1, 0
        crops = TP_CROPS_PER_DATA_RANK * data_ranks
        dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)
        items = [dataset[j] for j in range(TP_STEPS * crops)]
        return cfg, [tuple(np.stack(a) for a in zip(*items[i * crops:(i + 1) * crops]))
                     for i in range(TP_STEPS)]

    def step1_state(bundle):
        """A bundle's U-Net parameters, its EMA and Adam's first moments
        (unet 2), in fp32 on the host."""
        return ({k: v.float().cpu() for k, v in bundle["model"].items()
                 if k.startswith("unets.1.")},
                {k: v.float().cpu() for k, v in bundle["ema"].items()
                 if k.startswith("1.ema_model.")},
                {i: st["exp_avg"].float().cpu() for i, st in bundle["optim1"]["state"].items()})

    def tp_reference(cfg, batches, bundle):
        """The 1-rank trainer on the global batches: losses, s per step, the
        step-1 gradient, the state after step 1 beside the mesh run's
        (``bundle``, gathered into the one-process bundle), the fused Block
        shapes it launched, peak memory, the learning rate of step 1. Then
        step 2 again from ``bundle``: the gradient the mesh run's step 2 is
        held to."""
        ref = build_trainer(cfg, dev)
        unet = ref.imagen.unets[1]
        shapes = collections.Counter()
        unet.use_ops(shape_recording_ops(shapes))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"losses": [], "step_s": []}
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["losses"].append(ref.train_step(unet_number=2, batch=batch))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            if i == 0:
                out["grads"] = {k: p.grad.detach().cpu() for k, p in unet.named_parameters()}
                out["state1"] = step1_state(ref.state_bundle())
        out["mesh_state1"] = step1_state(torch.load(bundle, map_location="cpu",
                                                    weights_only=False))
        out["lr"] = ref.schedules[1](0)
        # the fused Block launches of one microbatch's forward and backward
        out["per_microbatch"] = {k: n // (TP_STEPS * TP_ACCUM) for k, n in shapes.items()}
        out.update(shapes=dict(shapes), peak=torch.cuda.max_memory_allocated())
        ref.load(bundle)
        out["resynced"] = ref.train_step(unet_number=2, batch=batches[1])
        out["grads2"] = {k: p.grad.detach().cpu() for k, p in unet.named_parameters()}
        del ref, unet
        torch.cuda.empty_cache()
        return out

    def tp_train(pairs, mesh_shape, backend):
        """The DP x TP trainer over ``mesh_shape`` ranks against the 1-rank
        trainer on the same global batches and seed: every loss (step 1
        from the same weights, step 2 from each run's own step 1, and step 2
        from the mesh run's bundle of step 1); the state after step 1 (each
        parameter and EMA entry within TP_STEP1_LR_BOUND lr, Adam's first
        moments by the gradient criteria); the gradients gathered whole of step 1 and of
        step 2 from the same bundle; the replicated parameters of each
        model group bitwise equal; the fused Block's launches exactly the
        1-rank run's shapes at Cout / M. Returns rank 0's results."""
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        d, m = mesh_shape
        cfg, batches = tp_batches(pairs, d)
        print(f"mesh data {d} x model {m} ({backend or 'nccl'}): {TP_STEPS} global batches of "
              f"{batches[0][0].shape[0]} crops of {cfg.train.patch_size}^3, accum {TP_ACCUM}",
              flush=True)
        work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        bundle = os.path.join(work, "step1.pt")
        torch.cuda.empty_cache()  # the ranks share this card with the cache of earlier phases
        try:
            t0 = time.perf_counter()
            ranks = launch(tp_train_rank, (cfg, batches, mesh_shape, bundle,
                                           TP_TIMED_STEPS if backend is None else 0),
                           nprocs=d * m, device="cuda", backend=backend,
                           timeout_s=DDP_RANK_TIMEOUT_S)
            launch_s = time.perf_counter() - t0
            ref = tp_reference(cfg, batches, bundle)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        r0 = ranks[0]
        # what one rank launches: the 1-rank run's per-microbatch launches at
        # its own rows (1 / D of each microbatch), every Cout / M
        (rows1,) = {k[0] for k in ref["shapes"]}
        want_shapes = {(rows1 // d, s, cin, cout // m): n for (_, s, cin, cout), n
                       in ref["per_microbatch"].items()}
        want = {k: TP_STEPS * TP_ACCUM * n for k, n in FLAGSHIP_COUNTS.items()}
        print(f"backend {r0['backend']} world {r0['world']} devices "
              f"{[r['device'] for r in ranks]}; sharded parameters {r0['sharded']}"
              + (" (ranks sharing one card: correctness and overhead, not scaling)"
                 if backend == "gloo" else ""))
        print(f"losses {' '.join(f'{v:.6f}' for v in r0['losses'])}; 1 rank "
              f"{' '.join(f'{v:.6f}' for v in ref['losses'])}")
        print(f"s per step {' '.join(f'{v:.3f}' for v in r0['step_s'])} (rank 0), 1 rank "
              f"{' '.join(f'{v:.3f}' for v in ref['step_s'])}; launch of the ranks "
              f"{launch_s:.1f} s; 1 rank peak memory {ref['peak'] / 2 ** 30:.2f} GiB")
        for r, rank in enumerate(ranks):
            timed = ("" if rank["timed"] is None else
                     f"step {TP_STEPS + 1} with each collective synchronised and timed: "
                     f"{rank['timed_s']:.3f} s, {rank['timed']}; ")
            print(f"  rank {r}: collectives of step 1 {rank['comms']}, per microbatch "
                  f"{ {k: {q: v / TP_ACCUM for q, v in c.items()} for k, c in rank['comms'].items()} }; "
                  f"{timed}peak memory {rank['peak'] / 2 ** 30:.2f} GiB; launches "
                  f"{rank['launches']}")
        print(f"  fused Block shapes per rank {r0['shapes']} (1 rank: {ref['shapes']})",
              flush=True)
        unequal = [f"rank {lo + j} {k}" for lo in range(0, d * m, m) for j in range(1, m)
                   for k, v in ranks[lo]["replicated"].items()
                   if not torch.equal(v, ranks[lo + j]["replicated"][k])]
        # step 1 from the same weights; step 2 from each run's own step 1
        # (free running) and from the mesh run's bundle of step 1
        stats = [grad_stats(g, w) for g, w in zip(r0["grads"], (ref["grads"], ref["grads2"]))]
        held = [ref["losses"][0], ref["resynced"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], held))
        free = abs(r0["losses"][1] - ref["losses"][1]) / abs(ref["losses"][1])
        # the state after step 1 (TP_STEP1_LR_BOUND: a shard saved in the
        # wrong place or a wrong EMA slice is off by a weight's size); the
        # first moments are (1 - beta1) times the clipped gradient: the
        # clip's scale and the moments' shards
        (p_want, e_want, m_want), (p_got, e_got, m_got) = ref["state1"], ref["mesh_state1"]
        if (set(p_got), set(e_got), set(m_got)) != (set(p_want), set(e_want), set(m_want)):
            raise AssertionError("tp-train: the mesh run's bundle names other tensors")
        p_gap = max(float((p_got[k] - v).abs().max()) for k, v in p_want.items())
        e_gap = max(float((e_got[k] - v).abs().max()) for k, v in e_want.items())
        flips = (sum(int(((p_got[k] - v).abs() > ref["lr"]).sum()) for k, v in p_want.items())
                 / sum(v.numel() for v in p_want.values()))
        m_per, m_cos, m_norm = grad_stats(m_got, m_want)
        print(f"  replicated parameters bitwise equal in each model group: {not unequal}")
        print(f"  after step 1 vs 1 rank: parameters max |diff| {p_gap:.3e}, EMA {e_gap:.3e} "
              f"(bound {TP_STEP1_LR_BOUND} lr = {TP_STEP1_LR_BOUND * ref['lr']:.3e}), share of "
              f"parameters more than lr apart {flips:.3e}; Adam first moments whole cos "
              f"{m_cos:.7f}, norm rel {m_norm:.3e}, per-tensor cos min "
              f"{min(m_per.values()):.6f}")
        for step, (per, cos_all, norm_rel) in enumerate(stats, 1):
            worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
            print(f"  step-{step} gradient vs 1 rank: whole cos {cos_all:.7f} (min "
                  f"{GRAD_GLOBAL_COS_MIN}), norm rel {norm_rel:.3e} (tol "
                  f"{DDP_GRAD_NORM_REL_TOL}), per-tensor cos min {worst[0][1]:.6f} (min "
                  f"{GRAD_TENSOR_COS_MIN}) {worst}")
        print(f"  losses {' '.join(f'{v:.6f}' for v in r0['losses'])} vs the 1-rank step "
              f"from the same state {' '.join(f'{v:.6f}' for v in held)}: max rel diff "
              f"{rel:.3e} (tol {DDP_LOSS_REL_TOL}); step 2 vs the free-running 1-rank step 2 "
              f"{ref['losses'][1]:.6f}: {free:.3e} (tol {DDP_LOSS_REL_TOL})", flush=True)
        if unequal:
            raise AssertionError(f"tp-train: replicated parameters differ: {unequal[:5]}")
        if any(rank["launches"] != want for rank in ranks):
            raise AssertionError(f"tp-train launches {[r['launches'] for r in ranks]}, "
                                 f"expected {want} per rank")
        if any(rank["shapes"] != {k: TP_STEPS * TP_ACCUM * v for k, v in want_shapes.items()}
               for rank in ranks):
            raise AssertionError(f"tp-train fused Block shapes {[r['shapes'] for r in ranks]}, "
                                 f"expected {TP_STEPS * TP_ACCUM} x {want_shapes} per rank")
        if not (all(math.isfinite(v) for v in r0["losses"]) and rel <= DDP_LOSS_REL_TOL
                and free <= DDP_LOSS_REL_TOL):
            raise AssertionError("tp-train: the losses disagree with the 1-rank trainer's")
        if max(p_gap, e_gap) > TP_STEP1_LR_BOUND * ref["lr"]:
            raise AssertionError(f"tp-train: the state after step 1 is more than "
                                 f"{TP_STEP1_LR_BOUND} lr from the 1-rank trainer's")
        if (m_cos < GRAD_GLOBAL_COS_MIN or m_norm > DDP_GRAD_NORM_REL_TOL
                or min(m_per.values()) < GRAD_TENSOR_COS_MIN):
            raise AssertionError("tp-train: Adam's first moments after step 1 disagree with the "
                                 "1-rank trainer's")
        if any(cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > DDP_GRAD_NORM_REL_TOL
               or min(per.values()) < GRAD_TENSOR_COS_MIN for per, cos_all, norm_rel in stats):
            raise AssertionError("tp-train: the gathered gradient disagrees with the 1-rank "
                                 "trainer's")
        return r0

    def tp_serve():
        """One EDM call of one 96^3 window through ``ImagenTrainer.sample``
        over 2 ranks (data 1 x model 2) against the 1-rank call on the same
        weights and noise."""
        from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        world, backend = 2, ddp_ranks()[1]
        cfg = load_config(os.path.join(ROOT, EDM_CONFIG))
        cfg.train.edm_num_sample_steps = TP_SERVE_STEPS
        lowres_vol, _ = fake_volumes(cfg, 128, seed=0)
        window = serve_windows(cfg, lowres_vol, 1, dev).float()
        ref = build_trainer(cfg, dev)
        shapes = collections.Counter()
        ref.prepare()
        ref.ema_unets[1].use_ops(shape_recording_ops(shapes))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        want = ref.sample(batch_size=GROUP, start_image_or_video=window, start_at_unet_number=2,
                          noise=gaussian_noise(torch.Generator(device=dev).manual_seed(2)))
        torch.cuda.synchronize()
        ref_s, ref_counts = time.perf_counter() - t0, kernels.launch_counts()
        del ref
        torch.cuda.empty_cache()
        ranks = launch(tp_serve_rank, (cfg, window.cpu()), nprocs=world, device="cuda",
                       backend=backend, timeout_s=DDP_RANK_TIMEOUT_S)
        got, r0 = ranks[0]["out"], ranks[0]
        nfe = 2 * TP_SERVE_STEPS - 1
        want_shapes = {(b, s, cin, cout // world): n for (b, s, cin, cout), n in shapes.items()}
        err = float((got - want.cpu()).abs().max())
        scale = float(want.abs().max())
        print(f"tp-serve: EDM, {TP_SERVE_STEPS} Heun steps ({nfe} forwards) of one 96^3 window "
              f"over data 1 x model {world} ({backend or 'nccl'}): {r0['seconds']:.2f} s "
              f"(1 rank {ref_s:.2f} s); max abs diff {err:.3e} of max {scale:.3e} (tol "
              f"{DDP_SERVE_REL_TOL} relative); launches {r0['launches']} (1 rank {ref_counts}); "
              f"fused shapes {r0['shapes']}; collectives per forward "
              f"{ {k: {q: v / nfe for q, v in c.items()} for k, c in r0['comms'].items()} }; "
              f"peak memory per rank {[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB",
              flush=True)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError("tp-serve: the sample is not finite or of another shape")
        if err > DDP_SERVE_REL_TOL * scale:
            raise AssertionError("tp-serve: the 2-rank sample disagrees with the 1-rank one")
        if any(r["launches"] != ref_counts or r["shapes"] != want_shapes for r in ranks):
            raise AssertionError(f"tp-serve launches {[r['launches'] for r in ranks]} "
                                 f"{[r['shapes'] for r in ranks]}, expected {ref_counts} "
                                 f"{want_shapes} per rank")
        return r0["launches"]

    def tp_2d(mesh_shape, backend):
        """UNet2D (SERVE_2D) over ``mesh_shape`` ranks against one process on
        the same weights, slices and seeds: each U-Net call of the sampler
        within FORWARD_REL_TOL of one rank's U-Net on its inputs (bf16), the
        chained call printed; the step's loss
        within DDP_LOSS_REL_TOL and its gathered gradient by ddp-train's
        criteria; every rank's flash launches those of one process (whole
        heads after the q / k / v gather). Returns rank 0's launches of the
        call and the step together."""
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        d, m = mesh_shape
        hr, lr, min_bound = tp2d_batch()
        ref = tp2d_run(dev, hr, lr, min_bound, None)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(tp2d_rank, (hr, lr, min_bound, mesh_shape,
                                   TP_TIMED_STEPS if backend is None else 0, ref["se_masks"]),
                       nprocs=d * m, device="cuda", backend=backend,
                       timeout_s=DDP_RANK_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        r0 = ranks[0]
        fwd_rel = float((r0["forward"] - ref["forward"]).abs().max()
                        / ref["forward"].abs().max())
        err = float((r0["out"] - ref["out"]).abs().max())
        scale = float(ref["out"].abs().max())
        call_rel = []
        with torch.no_grad():
            for args, kwargs, got in r0["calls"]:
                want = ref["replica"](*tensors_to(args, dev), **tensors_to(kwargs, dev)).float()
                call_rel.append(float((got.to(dev).float() - want).abs().max()
                                      / want.abs().max()))
        del ref["replica"]
        loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
        per, cos_all, norm_rel = grad_stats(r0["grads"], ref["grads"])
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        print(f"tp-2d: UNet2D {SERVE_2D} (bf16) over data {d} x model {m} "
              f"({r0['backend']}; devices {[r['device'] for r in ranks]}), "
              f"{r0['sharded']} parameters sharded; {TP2D_SLICES} slices of {EDGE_2D}^2; "
              f"launch of the ranks {launch_s:.1f} s", flush=True)
        print(f"  one forward at t 0.5: max rel diff {fwd_rel:.3e} (tol {FORWARD_REL_TOL})")
        print(f"  sampler call ({STEPS_2D} ancestral steps): {r0['sample_s']:.2f} s (1 rank "
              f"{ref['sample_s']:.2f} s); its {len(call_rel)} U-Net calls against one rank's "
              f"U-Net on their inputs: max rel diff {max(call_rel, default=float('nan')):.3e} "
              f"(tol {FORWARD_REL_TOL}; per call {' '.join(f'{v:.2e}' for v in call_rel)}); "
              f"the chained result (not held) max abs diff {err:.3e} of max {scale:.3e}: "
              f"{err / scale:.3e} relative; launches {r0['sample_launches']} (1 rank "
              f"{ref['sample_launches']})")
        print(f"  train step: loss {r0['loss']:.6f} (1 rank {ref['loss']:.6f}, rel diff "
              f"{loss_rel:.3e}, tol {DDP_LOSS_REL_TOL}); gradient whole cos {cos_all:.7f} (min "
              f"{GRAD_GLOBAL_COS_MIN}), norm rel {norm_rel:.3e} (tol {DDP_GRAD_NORM_REL_TOL}), "
              f"per-tensor cos min {worst[0][1]:.6f} (min {GRAD_TENSOR_COS_MIN}) {worst}, "
              f"squeeze-excite ReLUs pinned to the 1-rank step's (units a rank's own ReLU "
              f"would have decided otherwise: {[r['se_flips'] for r in ranks]}); "
              f"{r0['step_s']:.2f} s (1 rank {ref['step_s']:.2f} s); launches "
              f"{r0['step_launches']} (1 rank {ref['step_launches']}); peak memory per rank "
              f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB (1 rank "
              f"{ref['peak'] / 2 ** 30:.2f})", flush=True)
        if r0["extra_s"]:
            later = sorted(r0["extra_s"])
            med = later[len(later) // 2]
            print(f"  data {d} x model {m}: {TP2D_SLICES} slices per step, s per step "
                  f"{med:.4f} [{later[0]:.4f}-{later[-1]:.4f}] over {len(later)} steps, "
                  f"{TP2D_SLICES / med:.2f} slices per s", flush=True)
        if not (torch.isfinite(r0["forward"]).all() and fwd_rel <= FORWARD_REL_TOL):
            raise AssertionError("tp-2d: the mesh forward disagrees with the 1-rank one")
        if r0["out"].shape != ref["out"].shape or not torch.isfinite(r0["out"]).all():
            raise AssertionError("tp-2d: the sample is not finite or of another shape")
        if len(call_rel) != STEPS_2D or not max(call_rel) <= FORWARD_REL_TOL:
            raise AssertionError("tp-2d: the mesh sampler's U-Net calls disagree with the "
                                 "1-rank U-Net on their inputs")
        if not (math.isfinite(r0["loss"]) and loss_rel <= DDP_LOSS_REL_TOL):
            raise AssertionError("tp-2d: the mesh step's loss disagrees with the 1-rank one")
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > DDP_GRAD_NORM_REL_TOL
                or min(per.values()) < GRAD_TENSOR_COS_MIN):
            raise AssertionError("tp-2d: the gathered gradient disagrees with the 1-rank one")
        want_sample = {k: STEPS_2D * n for k, n in SERVE_2D_COUNTS.items()}
        if any((r["sample_launches"], r["step_launches"]) != (want_sample, SERVE_2D_COUNTS)
               for r in ranks + [ref]):
            raise AssertionError(f"tp-2d launches {[(r['sample_launches'], r['step_launches']) for r in ranks]}, "
                                 f"expected {want_sample} and {SERVE_2D_COUNTS}")
        return {k: r0["sample_launches"][k] + r0["step_launches"][k] for k in NO_COUNTS}

    def tp_video():
        """Unet3DVideo (VIDEO_UNET, fp32) with every weight of the rule
        column-split over 2 ranks against one process: the forward of
        serve-video's input within TP_VIDEO_REL_TOL of its largest entry,
        the EDM loss within DDP_LOSS_REL_TOL, the gathered gradient by
        ddp-train's criteria; no hand-written kernel launches."""
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        world, backend = ddp_ranks()
        video = video_unet()
        state = {k: v.detach().float().cpu() for k, v in video.state_dict().items()}
        del video
        torch.cuda.empty_cache()
        emb, mask = video_text()
        x = torch.randn((VIDEO_BATCH, VIDEO_FRAMES, VIDEO_EDGE, VIDEO_EDGE, 3), generator=gen,
                        device=dev)
        videos = torch.rand((VIDEO_BATCH, VIDEO_FRAMES, TP_VIDEO_EDGE, TP_VIDEO_EDGE, 3),
                            generator=gen, device=dev)
        inputs = [v.cpu() for v in (x, torch.tensor([0.7, -1.3]), emb, mask, videos)]
        ranks = launch(tp_video_rank, (state, inputs), nprocs=world, device="cuda",
                       backend=backend, timeout_s=DDP_RANK_TIMEOUT_S)
        ref = tp_video_run(dev, state, inputs, None)
        r0 = ranks[0]
        err = float((r0["out"] - ref["out"]).abs().max())
        scale = float(ref["out"].abs().max())
        loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
        # the global-context gates' to_k bias is a constant added before a
        # softmax over every position: its exact gradient is zero, and both
        # runs read rounding noise there (held under 1e-6 of the largest
        # gradient entry, not by its direction)
        null = [k for k in ref["grads"] if k.endswith("gca.to_k.bias")]
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        noise = max(float(g[k].abs().max()) for g in (r0["grads"], ref["grads"]) for k in null)
        per, cos_all, norm_rel = grad_stats(
            *({k: v for k, v in g.items() if k not in null} for g in (r0["grads"], ref["grads"])))
        worst = sorted(per.items(), key=lambda kv: kv[1])[:3]
        print(f"tp-video: Unet3DVideo {VIDEO_UNET} (fp32) over data 1 x model {world} "
              f"({backend or 'nccl'}), {r0['sharded']} parameters sharded; forward of "
              f"{VIDEO_BATCH} x {VIDEO_FRAMES} x {VIDEO_EDGE}^2: {r0['forward_s']:.2f} s (1 rank "
              f"{ref['forward_s']:.2f} s), max abs diff {err:.3e} of max {scale:.3e} (tol "
              f"{TP_VIDEO_REL_TOL} relative)", flush=True)
        print(f"  EDM loss step of {VIDEO_BATCH} x {VIDEO_FRAMES} frames at {TP_VIDEO_EDGE}^2: "
              f"loss {r0['loss']:.6f} (1 rank {ref['loss']:.6f}, rel diff {loss_rel:.3e}, tol "
              f"{DDP_LOSS_REL_TOL}); gradient whole cos {cos_all:.7f}, norm rel {norm_rel:.3e}, "
              f"per-tensor cos min {worst[0][1]:.6f} {worst}; the {len(null)} gates' to_k "
              f"bias gradients at most {noise:.3e} of the largest entry's {top:.3e}; "
              f"{r0['step_s']:.2f} s (1 rank "
              f"{ref['step_s']:.2f} s); launches {r0['launches']}; peak memory per rank "
              f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB (1 rank "
              f"{ref['peak'] / 2 ** 30:.2f})", flush=True)
        if not torch.isfinite(r0["out"]).all() or err > TP_VIDEO_REL_TOL * scale:
            raise AssertionError("tp-video: the split forward disagrees with the 1-rank one")
        if not (math.isfinite(r0["loss"]) and loss_rel <= DDP_LOSS_REL_TOL):
            raise AssertionError("tp-video: the split loss disagrees with the 1-rank one")
        if (cos_all < GRAD_GLOBAL_COS_MIN or norm_rel > DDP_GRAD_NORM_REL_TOL
                or min(per.values()) < GRAD_TENSOR_COS_MIN or noise > 1e-6 * top):
            raise AssertionError("tp-video: the gathered gradient disagrees with the 1-rank one")
        if any(r["launches"] != NO_COUNTS for r in ranks):
            raise AssertionError("tp-video launched hand-written kernels")
        return r0["launches"]

    def flops_phase(model, blocks_gflop):
        """``utils/flops.py`` over one flagship forward (27 x 32^3) on the
        card through the kernels (each wrapper reports its work) and
        through the plain versions (every conv an aten op): equal counts;
        the Blocks' conv GFLOP the fused kernel reports equal to the
        forward phase's count of them."""
        from diffusioniqt_tpu_torch.utils.flops import FlopCounter

        x, lowres = (torch.randn((GROUP, SUB, SUB, SUB, 1), generator=gen, device=dev)
                     for _ in range(2))
        t = torch.full((GROUP,), 0.5, device=dev)
        log_snr = torch.full((GROUP,), -1.0, device=dev)
        counters = {}
        for label, ops in (("kernels", kernels.KERNELS), ("plain", kernels.PLAIN)):
            model.use_ops(ops)
            with torch.no_grad(), FlopCounter() as counter:
                model(x, t, log_snr, lowres_cond_img=lowres)
            counters[label] = counter
        model.use_ops(kernels.KERNELS)
        card, plain = counters["kernels"], counters["plain"]
        blocks = card.by_source.get("fused_block", 0) + card.by_source.get("fused_block_small", 0)
        print(f"flops of one flagship forward (27 x 32^3): through the kernels conv "
              f"{card.counts['conv'] / 1e9:.3f} GFLOP, matmul {card.counts['dot'] / 1e9:.3f} "
              f"GFLOP; plain conv {plain.counts['conv'] / 1e9:.3f}, matmul "
              f"{plain.counts['dot'] / 1e9:.3f}; by source "
              f"{ {k: round(v / 1e9, 3) for k, v in card.by_source.items()} }; the Blocks' conv "
              f"{blocks / 1e9:.3f} GFLOP read from the fused kernel (forward phase: "
              f"{blocks_gflop:.3f})", flush=True)
        if card.counts != plain.counts:
            raise AssertionError(f"flops: the kernel path counts {card.counts}, the plain path "
                                 f"{plain.counts}")
        if abs(blocks / 1e9 - blocks_gflop) > 1e-9 * blocks_gflop:
            raise AssertionError("flops: the fused kernel's reported work is not the Blocks'")
        return card.counts

    def nifti_phase():
        """``python -m diffusioniqt_tpu_torch.nifti_roundtrip --prepare --run``
        at its smallest full size (one train, one valid, one test volume of
        256^3, NIFTI_STEPS steps): the train and evaluate subprocesses each
        print their launches last (the tool reports them); both run the
        conv kernels, evaluate in whole 20-step calls; the seconds of each
        stage; a finite gaussian-stitched prediction of the test volume's
        240^3 centre crop (evaluate crops a 256-edge volume, reference
        test.py:151-153)."""
        from diffusioniqt_tpu_torch import nifti_roundtrip
        from diffusioniqt_tpu_torch.data.datasets import load_volume

        root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            t0 = time.perf_counter()
            log = nifti_roundtrip.main(["--root", root, "--prepare", "--run", "--train-volumes",
                                        "1", "--valid-volumes", "1", "--test-volumes", "1",
                                        "--steps", str(NIFTI_STEPS)])
            total_s = time.perf_counter() - t0
            preds = sorted(f for f in os.listdir(os.path.join(root, "inference_out"))
                           if f.endswith("_inf.nii.gz"))
            pred = load_volume(os.path.join(root, "inference_out", preds[0]))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        by_entry = {entry: log.pop(f"{entry}_launches") for entry in ("train", "evaluate")}
        print(f"nifti-roundtrip: {log} ({total_s:.1f} s in all); launches {by_entry}; "
              f"prediction {preds[0]} {pred.shape} finite {bool(np.isfinite(pred).all())}",
              flush=True)
        for entry, counts in by_entry.items():
            if counts is None:
                raise AssertionError(f"nifti-roundtrip {entry}: no launch counts printed")
            forwards = counts["conv3d"]
            if forwards < NIFTI_STEPS or counts != {k: forwards * n
                                                    for k, n in FLAGSHIP_COUNTS.items()}:
                raise AssertionError(f"nifti-roundtrip {entry}: launches {counts} are not "
                                     "whole flagship forwards through the kernels")
        if by_entry["evaluate"]["conv3d"] % 20:
            raise AssertionError("nifti-roundtrip: evaluate's forwards are not whole 20-step "
                                 "sampler calls")
        if pred.shape != (240, 240, 240) or not np.isfinite(pred).all():
            raise AssertionError("nifti-roundtrip: the prediction is not a finite volume of the "
                                 "test volume's 240^3 centre crop")
        return {f"nifti-roundtrip {k}": v for k, v in by_entry.items()}

    def ddp_serve(cfg, want_pred, serve_s):
        """The serve phase's run over the ranks; rank 0's volume against the
        1-rank one."""
        from diffusioniqt_tpu_torch.parallel.multihost import launch

        world, backend = ddp_ranks()
        edge = want_pred.shape[0]
        ranks = launch(ddp_serve_rank, (cfg, edge, WINDOWS), nprocs=world, device="cuda",
                       backend=backend, timeout_s=DDP_RANK_TIMEOUT_S)
        pred = ranks[0]["pred"]
        want = {k: cfg.train.timesteps * n for k, n in FLAGSHIP_COUNTS.items()}
        err = float(np.abs(pred - want_pred).max())
        tol = DDP_SERVE_REL_TOL * float(np.abs(want_pred).max())
        # one process: the same windows' rows sampled whole, and each rank's
        # rows alone with the rows of the same global noise
        imagen = build_sampler(cfg, device=dev, seed=0)
        x = serve_windows(cfg, fake_volumes(cfg, edge, seed=0)[0], WINDOWS, dev)
        n, share = x.shape[0], x.shape[0] // world

        def sample(lo, hi):
            gen = torch.Generator(device=dev).manual_seed(1)
            return imagen.sample(
                batch_size=hi - lo, start_image_or_video=x[lo:hi], start_at_unet_number=2,
                noise=lambda shape: torch.randn((n,) + tuple(shape[1:]), generator=gen,
                                                device=dev)[lo:hi])

        whole = sample(0, n).cpu()
        alone = torch.cat([sample(r * share, (r + 1) * share).cpu() for r in range(world)])
        rows = ranks[0]["rows"]
        rows_equal = torch.equal(rows, alone)
        print(f"  rows of the {WINDOWS} windows: gathered from the ranks vs one process "
              f"sampling each rank's {share} rows alone: equal {rows_equal}, max abs diff "
              f"{(rows - alone).abs().max().item():.3e}; one process at {share} rows vs "
              f"at {n}: max abs diff {(alone - whole).abs().max().item():.3e} (max|x| "
              f"{whole.abs().max().item():.3e})", flush=True)
        secs = " ".join(f"{r['seconds']:.3f}" for r in ranks)
        print(f"{world} ranks ({backend or 'nccl'}), {WINDOWS // world} windows each: "
              f"seconds per 128^3 volume W={world} {secs} (per rank), 1 rank {serve_s:.3f}"
              + (" (ranks sharing one card: correctness and overhead, not scaling)"
                 if backend == "gloo" else ""))
        print(f"  launches per rank {[r['launches'] for r in ranks]}; peak memory per rank "
              f"{[round(r['peak'] / 2 ** 30, 2) for r in ranks]} GiB; others returned "
              f"{[type(r['pred']).__name__ for r in ranks[1:]]}")
        print(f"  volume {pred.shape} vs 1 rank: max abs diff {err:.3e}, equal "
              f"{bool(np.array_equal(pred, want_pred))} (tol {tol:.3e} = {DDP_SERVE_REL_TOL} x "
              f"max|1-rank|)", flush=True)
        if any(r["launches"] != want for r in ranks):
            raise AssertionError(f"ddp-serve launches {[r['launches'] for r in ranks]}, "
                                 f"expected {want} per rank")
        if not (pred.shape == want_pred.shape and np.isfinite(pred).all() and err <= tol):
            raise AssertionError("ddp-serve: the sharded volume disagrees with the 1-rank one")
        if not rows_equal:
            raise AssertionError("ddp-serve: the gathered rows differ from one process "
                                 "sampling each rank's rows alone")
        return ranks[0]["launches"]

    def serve_2d():
        """The 2D slice family's serve cell: UNet2D at full width
        (SERVE_2D) behind ``Imagen(spatial_dims=2)``, as quality_run_2d
        builds the wrapper, on the central SLICES_2D axial slices of a
        seeded 240^3 phantom's LR volume: one forward through the kernels
        and through the plain versions (FORWARD_REL_TOL, SERVE_2D_COUNTS),
        then one STEPS_2D-step ancestral call with the counts zeroed just
        before and read just after. Returns the call's launches."""
        from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
        from diffusioniqt_tpu_torch.models.unet2d import UNet2D

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            unet = UNet2D(**SERVE_2D, dtype=torch.bfloat16).to(dev).eval()
        _, lr = generate_pair(EDGE_2D, seed=0)
        mean, std = population_stats([lr])
        z0 = (EDGE_2D - SLICES_2D) // 2
        lowres = torch.from_numpy(((lr[z0:z0 + SLICES_2D] - mean) / std).astype(np.float32))
        lowres = lowres[..., None].to(dev)
        imagen = Imagen([NullUnet().to(dev), unet], image_sizes=(EDGE_2D, EDGE_2D), channels=1,
                        timesteps=STEPS_2D, pred_objectives="x_start",
                        dynamic_thresholding=False, p2_loss_weight_gamma=0.0,
                        cond_drop_prob=0.0, min_bound=(0.0 - mean) / std, norm="z-score",
                        spatial_dims=2)
        x = torch.randn(lowres.shape, generator=gen, device=dev)
        t = torch.full((SLICES_2D,), 0.5, device=dev)
        log_snr = imagen.noise_schedulers[1].get_condition(t)
        call = lambda: unet(x, t, log_snr, lowres_cond_img=lowres)  # noqa: E731
        with torch.no_grad():
            kernels.reset_launch_counts()
            out_k = call()
            torch.cuda.synchronize()
            per_forward = kernels.launch_counts()
            fwd_ms = cuda_time_ms(call, iters=5, warmup=1)
            unet.use_ops(kernels.PLAIN)
            out_p = call()
            plain_ms = cuda_time_ms(call, iters=2, warmup=0)
            unet.use_ops(kernels.KERNELS)
        rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        print(f"UNet2D {SERVE_2D}: {sum(p.numel() for p in unet.parameters())} parameters; "
              f"forward of {SLICES_2D} x {EDGE_2D}^2: launches {per_forward}, out "
              f"{tuple(out_k.shape)} finite {bool(torch.isfinite(out_k).all())}, "
              f"max_rel_err_vs_plain {rel:.3e} (tol {FORWARD_REL_TOL}); ms per forward: "
              f"kernels {fwd_ms:.3f} plain {plain_ms:.3f}", flush=True)
        if per_forward != SERVE_2D_COUNTS:
            raise AssertionError(f"serve-2d: launches per forward {per_forward}, expected "
                                 f"{SERVE_2D_COUNTS}")
        if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError("serve-2d: the forward through the kernels disagrees with "
                                 "the plain path")
        del out_k, out_p
        noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = imagen.sample(batch_size=SLICES_2D, noise=noise, start_at_unet_number=2,
                            start_image_or_video=lowres)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        served = kernels.launch_counts()
        want = {k: STEPS_2D * n for k, n in SERVE_2D_COUNTS.items()}
        print(f"sampler call ({STEPS_2D} ancestral steps, {SLICES_2D} slices of {EDGE_2D}^2, "
              f"bf16): {call_s:.3f} s per call, {call_s * 1e3 / STEPS_2D:.3f} ms per NFE; "
              f"output {tuple(out.shape)} finite {bool(torch.isfinite(out).all())}; launches "
              f"{served}; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        if served != want:
            raise AssertionError(f"serve-2d launches {served}, expected {want}")
        if out.shape != (SLICES_2D, EDGE_2D, EDGE_2D, 1) or not torch.isfinite(out).all():
            raise AssertionError("serve-2d: the samples are not finite slices of the input's "
                                 "shape")
        return served

    def attn_context():
        """The attention config's first SoftMaxAttention slot (level 0,
        patch 8 over the 96^3 merged window: 12^3 tokens, 8 heads of 64),
        seeded, given a CONTEXT_TOKENS-token, CONTEXT_DIM-wide text context
        from ``hash_text_encode``, on the serve batch of 8 windows in bf16:
        through the kernel (flash at Nq 1728 against Nk 1744, launched
        exactly once) and through the plain version, within
        FORWARD_REL_TOL. Returns the launches."""
        from diffusioniqt_tpu_torch.models.attention import SoftMaxAttention
        from diffusioniqt_tpu_torch.utils.t5 import hash_text_encode

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            slot = SoftMaxAttention(64, dim_head=64, heads=8, patch_size=8, patch=True,
                                    context_dim=CONTEXT_DIM).to(dev).eval()
        x = torch.randn((WINDOWS, 96, 96, 96, 64), generator=gen, device=dev).to(torch.bfloat16)
        words = " ".join(VIDEO_TEXTS).split()
        texts = [" ".join(words[i:i + CONTEXT_TOKENS]) for i in range(WINDOWS)]
        context = hash_text_encode(texts, dim=CONTEXT_DIM, max_length=CONTEXT_TOKENS,
                                   device=dev)
        call = lambda: slot(x, context=context)  # noqa: E731
        with torch.no_grad():
            kernels.reset_launch_counts()
            out_k = call()
            torch.cuda.synchronize()
            launched = kernels.launch_counts()
            k_ms = cuda_time_ms(call, iters=5, warmup=1)
            profile_forward("attn-context slot", call)
            slot.ops = kernels.PLAIN
            out_p = call()
            p_ms = cuda_time_ms(call, iters=2, warmup=0)
            slot.ops = kernels.KERNELS
        rel = ((out_k.float() - out_p.float()).abs().max() / out_p.float().abs().max()).item()
        print(f"SoftMaxAttention slot (64 ch, patch 8, 8 x 64 heads, context {CONTEXT_TOKENS} x "
              f"{CONTEXT_DIM}) on {WINDOWS} x 96^3: launches {launched}, out "
              f"{tuple(out_k.shape)} finite {bool(torch.isfinite(out_k).all())}, "
              f"max_rel_err_vs_plain {rel:.3e} (tol {FORWARD_REL_TOL}); ms per call: kernel "
              f"{k_ms:.3f} plain {p_ms:.3f}", flush=True)
        if launched != CONTEXT_COUNTS:
            raise AssertionError(f"attn-context: launches {launched}, expected {CONTEXT_COUNTS}")
        if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError("attn-context: the slot through the kernel disagrees with the "
                                 "plain path")
        return launched

    def video_unet():
        """VIDEO_UNET from torch.manual_seed(0), the JAX initialisers, but
        with the zero-initialised temporal-attention gates set to 0.5 and
        the final conv drawn like the others: at init the output is zero."""
        from diffusioniqt_tpu_torch.models.blocks import lecun_normal_
        from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            unet = Unet3DVideo(**VIDEO_UNET, dtype=torch.bfloat16)
            with torch.no_grad():
                for name, p in unet.named_parameters():
                    if name.endswith("out_gate"):
                        p.fill_(0.5)
                lecun_normal_(unet.final_conv.weight)
        return unet.to(dev).eval()

    def video_text():
        """Each video's VIDEO_WORDS-word text, embedded by ``hash_text_encode``
        and padded to VIDEO_TEXT_LEN tokens, with its mask."""
        from diffusioniqt_tpu_torch.utils.t5 import hash_text_encode

        assert all(len(text.split()) == VIDEO_WORDS for text in VIDEO_TEXTS)
        return hash_text_encode(VIDEO_TEXTS[:VIDEO_BATCH], dim=768, max_length=VIDEO_TEXT_LEN,
                                return_attn_mask=True, device=dev)

    def video_forward(unet):
        """One forward of VIDEO_BATCH videos of VIDEO_FRAMES x VIDEO_EDGE^2
        with their texts in bf16, held against the same weights in fp32
        within FORWARD_REL_TOL, with time and with ``ignore_time``; no
        hand-written kernel launches. Returns the launches."""
        emb, mask = video_text()
        x = torch.randn((VIDEO_BATCH, VIDEO_FRAMES, VIDEO_EDGE, VIDEO_EDGE, 3), generator=gen,
                        device=dev)
        t = torch.tensor([0.7, -1.3], device=dev)
        launched = {}
        for ignore_time in (False, True):
            call = lambda: unet(x, t, t, text_embeds=emb, text_mask=mask,  # noqa: E731
                                ignore_time=ignore_time)
            with torch.no_grad():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                out = call()
                torch.cuda.synchronize()
                launched = kernels.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                runs = sorted(cuda_time_ms(call, iters=3, warmup=1 if r == 0 else 0)
                              for r in range(HOST_REPEATS))
                ms = runs[len(runs) // 2]
                if not ignore_time:
                    profile_forward("video-forward bf16", call)
                unet.dtype = torch.float32
                want = call()
                ms32 = cuda_time_ms(call, iters=2, warmup=0)
                unet.dtype = torch.bfloat16
            rel = ((out - want).abs().max() / want.abs().max()).item()
            print(f"Unet3DVideo {VIDEO_UNET} ignore_time={ignore_time}: "
                  f"{sum(p.numel() for p in unet.parameters())} parameters; forward of "
                  f"{VIDEO_BATCH} x {VIDEO_FRAMES} x {VIDEO_EDGE}^2 with {VIDEO_TEXT_LEN} text "
                  f"tokens: out {tuple(out.shape)} finite {bool(torch.isfinite(out).all())}, "
                  f"max|out| {want.abs().max().item():.3e}, bf16 vs fp32 max_rel_err {rel:.3e} "
                  f"(tol {FORWARD_REL_TOL}); ms per forward bf16 {ms:.3f} [{runs[0]:.3f}-"
                  f"{runs[-1]:.3f}] fp32 {ms32:.3f}; "
                  f"peak memory {peak:.2f} GiB; launches {launched}", flush=True)
            if launched != NO_COUNTS:
                raise AssertionError(f"video-forward launched hand-written kernels: {launched}")
            if not (torch.isfinite(out).all() and rel <= FORWARD_REL_TOL
                    and out.shape == x.shape):
                raise AssertionError("video-forward: the bf16 forward disagrees with fp32")
        return launched

    def serve_video(unet):
        """``ElucidatedImagen([unet], image_sizes=(VIDEO_EDGE,), channels=3)``
        at its default 32 Heun steps: ``sample(video_frames=VIDEO_FRAMES,
        text_embeds, text_mask, cond_scale=VIDEO_COND_SCALE)``, 63 forwards
        each beside its null-text forward; finite videos of the asked
        shape, no hand-written kernel. Returns the call's launches."""
        from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen

        emb, mask = video_text()
        edm = ElucidatedImagen([unet], image_sizes=(VIDEO_EDGE,), channels=3)
        forwards = []
        hook = unet.register_forward_pre_hook(lambda m, a: forwards.append(a[0].shape))
        noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out = edm.sample(batch_size=VIDEO_BATCH, noise=noise, video_frames=VIDEO_FRAMES,
                             text_embeds=emb, text_mask=mask, cond_scale=VIDEO_COND_SCALE)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        calls = [time.perf_counter() - t0]
        served = kernels.launch_counts()
        for _ in range(HOST_REPEATS - 1):  # the same call again, for the spread
            t0 = time.perf_counter()
            edm.sample(batch_size=VIDEO_BATCH, noise=noise, video_frames=VIDEO_FRAMES,
                       text_embeds=emb, text_mask=mask, cond_scale=VIDEO_COND_SCALE)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        calls.sort()
        call_s = calls[len(calls) // 2]
        steps = edm.hparams[0].num_sample_steps
        print(f"EDM video sampler call ({steps} Heun steps, cond_scale {VIDEO_COND_SCALE}, "
              f"{VIDEO_BATCH} x {VIDEO_FRAMES} x {VIDEO_EDGE}^2, bf16): {call_s:.3f} s per call "
              f"[{calls[0]:.3f}-{calls[-1]:.3f}] over {len(calls)} calls, {len(forwards)} "
              f"forwards, {call_s * 1e3 / len(forwards):.3f} ms per forward "
              f"[{calls[0] * 1e3 / len(forwards):.3f}-{calls[-1] * 1e3 / len(forwards):.3f}]; "
              f"output {tuple(out.shape)} finite {bool(torch.isfinite(out).all())} in "
              f"[{out.min().item():.3f}, {out.max().item():.3f}]; launches {served}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
        if served != NO_COUNTS:
            raise AssertionError(f"serve-video launched hand-written kernels: {served}")
        if len(forwards) != 2 * (2 * steps - 1):
            raise AssertionError(f"serve-video: {len(forwards)} forwards, expected "
                                 f"{2 * (2 * steps - 1)}")
        if (out.shape != (VIDEO_BATCH, VIDEO_FRAMES, VIDEO_EDGE, VIDEO_EDGE, 3)
                or not torch.isfinite(out).all()):
            raise AssertionError("serve-video: the samples are not finite videos of the "
                                 "asked shape")
        return served

    def video_loss(unet):
        """The EDM loss of VIDEO_BATCH videos of VIDEO_FRAMES frames at
        VIDEO_EDGE^2 with their texts and its backward (bf16, seeded
        draws): the wrapper resizes every axis between the batch and the
        channels to the stage's size, as the JAX ``forward`` does, so the
        U-Net is given VIDEO_EDGE frames; the loss and every gradient
        finite. Returns the launches."""
        from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen

        emb, mask = video_text()
        edm = ElucidatedImagen([unet], image_sizes=(VIDEO_EDGE,), channels=3)
        videos = torch.rand((VIDEO_BATCH, VIDEO_FRAMES, VIDEO_EDGE, VIDEO_EDGE, 3),
                            generator=gen, device=dev)
        frames = []
        hook = unet.register_forward_pre_hook(lambda m, a: frames.append(a[0].shape[1]))
        unet.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            loss = edm.forward(videos, text_embeds=emb, text_mask=mask,
                               generator=torch.Generator(device=dev).manual_seed(0))
            loss.backward()
            torch.cuda.synchronize()
        finally:
            hook.remove()
        step_s = time.perf_counter() - t0
        launched = kernels.launch_counts()
        missing = [n for n, p in unet.named_parameters() if p.grad is None]
        bad = [n for n, p in unet.named_parameters()
               if p.grad is not None and not torch.isfinite(p.grad).all()]
        gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in unet.parameters()
                               if p.grad is not None)).item()
        print(f"EDM video loss of {VIDEO_BATCH} x {VIDEO_FRAMES} x {VIDEO_EDGE}^2: the U-Net "
              f"was given {frames} frames; loss {loss.item():.5f}, gradient norm {gnorm:.4e}, "
              f"{len(missing)} parameters without a gradient, {len(bad)} with a non-finite "
              f"one; forward + backward {step_s:.3f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {launched}",
              flush=True)
        unet.zero_grad(set_to_none=True)
        if launched != NO_COUNTS:
            raise AssertionError(f"video-loss launched hand-written kernels: {launched}")
        if frames != [VIDEO_EDGE] or not math.isfinite(loss.item()) or missing or bad:
            raise AssertionError(f"video-loss: frames {frames}, loss {loss.item()}, without a "
                                 f"gradient {missing[:5]}, non-finite {bad[:5]}")
        return launched

    def train_2d():
        """quality_run_2d's own trainer (``build_trainer_2d``, its
        ``SliceIQTDataset``) at its default width on the card: TRAIN_2D_STEPS
        steps of TRAIN_2D_BATCH crops of TRAIN_2D_CROP^2 from two seeded
        128^3 phantoms; every loss finite; s per step."""
        from diffusioniqt_tpu_torch import quality_run_2d

        pairs = [generate_pair(PHANTOM_EDGE, seed=i) for i in range(PHANTOMS)]
        mean, std = population_stats([lr for _, lr in pairs])
        trainer = quality_run_2d.build_trainer_2d(TRAIN_2D_DIM, TRAIN_2D_CROP, 1000, mean, std,
                                                  2e-4, dev)
        trainer.add_train_dataset(quality_run_2d.SliceIQTDataset(pairs, mean, std,
                                                                 crop=TRAIN_2D_CROP, seed=0),
                                  batch_size=TRAIN_2D_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(TRAIN_2D_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(unet_number=2))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        med = sorted(step_s[1:])[len(step_s[1:]) // 2]
        print(f"train-2d: UNet2D dim {TRAIN_2D_DIM}, {TRAIN_2D_BATCH} crops of "
              f"{TRAIN_2D_CROP}^2 per step, bf16; losses {' '.join(f'{v:.4f}' for v in losses)}; "
              f"s per step (median of steps 2-{TRAIN_2D_STEPS}) {med:.4f}; step seconds "
              f"{' '.join(f'{v:.3f}' for v in step_s)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
              f"{kernels.launch_counts()}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError("train-2d: a loss is not finite")

    cfg = load_config(os.path.join(ROOT, FLAGSHIP_CONFIG))
    cfg_attn = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit.train.att_type = "vit"
    cfg_edm = load_config(os.path.join(ROOT, EDM_CONFIG))
    cfg_edm_step = load_config(os.path.join(ROOT, EDM_CONFIG))
    cfg_edm_step.train.edm_num_sample_steps = 2
    cfg_eff = load_config(os.path.join(ROOT, FLAGSHIP_CONFIG))
    cfg_eff.train.efficient = True

    if "--tp-only" in sys.argv[1:]:
        pairs = [generate_pair(PHANTOM_EDGE, seed=i) for i in range(PHANTOMS)]
        if torch.cuda.device_count() < 4:  # one card: the main run's TP phases
            phase("tp-train")
            tp_train(pairs, (1, 2), "gloo")
            phase("tp-serve")
            tp_serve()
            phase("tp-2d")
            tp_2d((1, 2), ddp_ranks()[1])
            phase("tp-video")
            tp_video()
            print(f"total seconds {time.perf_counter() - t_all:.1f}")
            return 0
        # the 4-card comparison: DP2 x TP2 and DP4 x 1 over NCCL, each held
        # against the 1-rank trainer on its global batches
        runs = {}
        for shape in ((2, 2), (4, 1)):
            phase(f"tp-train {shape[0]}x{shape[1]}")
            runs[shape] = tp_train(pairs, shape, None)
        for shape, r0 in runs.items():
            crops = TP_CROPS_PER_DATA_RANK * shape[0]
            later = sorted(r0["extra_s"])  # after the compared steps
            med = later[len(later) // 2]
            print(f"data {shape[0]} x model {shape[1]}: {crops} crops of 96^3 per step, s per "
                  f"step {med:.3f} [{later[0]:.3f}-{later[-1]:.3f}] over {len(later)} steps "
                  f"after the {TP_STEPS} compared ({' '.join(f'{v:.3f}' for v in r0['step_s'])}), "
                  f"{crops / med:.2f} [{crops / later[-1]:.2f}-{crops / later[0]:.2f}] crops per "
                  f"s, peak memory rank 0 "
                  f"{r0['peak'] / 2 ** 30:.2f} GiB, collectives of step 1 {r0['comms']}, timed "
                  f"step {r0['timed']}", flush=True)
        # the 2D slice family over the same meshes
        for shape in ((2, 2), (4, 1)):
            phase(f"tp-2d {shape[0]}x{shape[1]}")
            tp_2d(shape, None)
        print(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0

    if "--host-paths" in sys.argv[1:]:
        # the paths whose pace the host sets, alone: a copy of this script
        # placed in another checkout times that checkout's Python layers
        # the same way
        phase("preset-srunet256")
        preset_srunet256(cfg)
        video = video_unet()
        phase("video-forward")
        video_forward(video)
        phase("serve-video")
        serve_video(video)
        del video
        torch.cuda.empty_cache()
        phase("train")
        train_phase(load_config(os.path.join(ROOT, EDM_CONFIG)))
        print(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0

    if "--ddp-only" in sys.argv[1:]:
        phase("serve")
        _, pred_serve, _, serve_s = serve(cfg, FLAGSHIP_COUNTS)
        phase("ddp-train")
        ddp_train([generate_pair(PHANTOM_EDGE, seed=i) for i in range(PHANTOMS)])
        phase("ddp-serve")
        ddp_serve(cfg, pred_serve, serve_s)
        print(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0

    phase("forward")
    flagship_fwd = held_forward("flagship", cfg, FLAGSHIP_COUNTS, profile=True)
    phase("forward-attn")
    held_forward("attention", cfg_attn, ATTN_COUNTS, profile=True)
    phase("forward-vit")
    held_forward("vit", cfg_vit, ATTN_COUNTS, profile=False)
    phase("forward-efficient")
    efficient_fwd = held_forward("efficient", cfg_eff, EFFICIENT_COUNTS, profile=True,
                                 serve_batch=True)
    print(f"efficient vs flagship forward (27 x 32^3): {efficient_fwd['ms']:.3f} vs "
          f"{flagship_fwd['ms']:.3f} ms, the Blocks' convs {efficient_fwd['gflop']:.1f} vs "
          f"{flagship_fwd['gflop']:.1f} GFLOP", flush=True)
    phase("flops")
    flops_phase(flagship_fwd["model"], flagship_fwd["gflop"])
    del flagship_fwd["model"], efficient_fwd["model"]
    phase("preset-srunet256")
    served_srunet = preset_srunet256(cfg)
    phase("serve")
    served, pred_serve, _, serve_s = serve(cfg, FLAGSHIP_COUNTS, label="serve")
    phase("serve-attn")
    served_attn, _, _, _ = serve(cfg_attn, ATTN_COUNTS, label="serve-attn")
    phase("serve-efficient")
    served_eff, _, _, serve_eff_s = serve(cfg_eff, EFFICIENT_COUNTS, label="serve-efficient")
    print(f"serve-efficient {serve_eff_s:.3f} s against the serve phase's {serve_s:.3f} s "
          f"(8 windows, {cfg.train.timesteps} steps)", flush=True)
    phase("serve-2d")
    served_2d = serve_2d()
    phase("attn-context")
    served_context = attn_context()
    video = video_unet()
    phase("video-forward")
    served_video = {"video-forward": video_forward(video)}
    phase("serve-video")
    served_video["serve-video"] = serve_video(video)
    phase("video-loss")
    served_video["video-loss"] = video_loss(video)
    del video
    torch.cuda.empty_cache()
    phase("edm-step")
    edm_step(cfg_edm_step)
    phase("edm-merged")
    edm_merged(cfg_edm_step)
    phase("missing-pieces")
    pieces = missing_pieces(cfg)
    phase("serve-edm")
    served_edm, pred_edm, highres_edm, _ = serve(cfg_edm, FLAGSHIP_COUNTS)
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
    gated, gate_evaluated, probed = quality_phase()
    phase("train-remat-conv")
    train_remat_conv()
    phase("train-2d")
    train_2d()
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
    phase("ddp-train")
    ddp_trained = ddp_train(pairs)
    phase("ddp-serve")
    ddp_served = ddp_serve(cfg, pred_serve, serve_s)
    phase("tp-train")
    tp_trained = tp_train(pairs, (1, 2), "gloo")
    phase("tp-serve")
    tp_served = tp_serve()
    phase("tp-2d")
    tp_2d_served = tp_2d((1, 2), ddp_ranks()[1])
    phase("tp-video")
    tp_video_served = tp_video()
    phase("nifti-roundtrip")
    nifti_served = nifti_phase()
    phase("cli")
    cli_phase()
    # the paths of the last slice: the launches of each (rank 0 on a mesh)
    slice_paths = {"tp-2d (rank 0)": tp_2d_served, "tp-video (rank 0)": tp_video_served,
                   "edm-probe": probed, **nifti_served}

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
                                 "serve-edm": served_edm[name],
                                 "serve-efficient": served_eff[name],
                                 "preset-srunet256 sampler call": served_srunet[name],
                                 "train": trained[name],
                                 "quality": gated[name], "quality-eval": gate_evaluated[name],
                                 **{k: c["launches"][name] for k, c in cells.items()},
                                 "ddp-train (rank 0)": ddp_trained[name],
                                 "ddp-serve (rank 0)": ddp_served[name],
                                 "tp-train (rank 0)": tp_trained["launches"][name],
                                 "tp-serve (rank 0)": tp_served[name],
                                 "attn-context": served_context[name],
                                 "missing-pieces combiner": pieces[name],
                                 **{k: c[name] for k, c in served_video.items()},
                                 **{k: c[name] for k, c in slice_paths.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": head["tol"],
            "ms": head["ms"], "ms_min": head["ms_min"], "ms_max": head["ms_max"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_ms_min": head["library_ms_min"],
            "library_ms_max": head["library_ms_max"], "library": LIBRARY[name],
            "shape": "x".join(str(v) for v in head["shape"]), **extra,
        })
    # flash's rows: the attention config's (the headline), serve-2d's and
    # attn-context's (Nk = Nq + 16 text tokens), each with its phase's launches
    flash = next(r for r in line if r["name"] == "flash_attention")
    flash["launches_by_path"]["serve-2d"] = served_2d["flash_attention"]
    flash_phase = {(1728, 1728, 64): served_attn, (3600, 3600, 32): served_2d,
                   (1728, 1728 + CONTEXT_TOKENS, 64): served_context}
    flash["shapes"] = [
        {**{k: r[k] for k in ("shape", "max_abs_err", "ms", "ms_min", "ms_max", "plain_ms",
                              "bound_ms", "bound_by", "library_ms", "library_ms_min",
                              "library_ms_max")},
         "launches": flash_phase[tuple(r["shape"][1:])]["flash_attention"]}
        for r in results["flash_attention"]]
    # the fused Block's rows at Cout / M, with the launches at each shape in
    # tp-train (rank 0, both steps); tp-serve launches the same shapes
    fused = next(r for r in line if r["name"] == "fused_block")
    fused["tp_shapes"] = [
        {**{k: r[k] for k in ("shape", "plan", "max_abs_err", "ms", "ms_min", "ms_max",
                              "plain_ms", "bound_ms", "bound_by", "conv_only_library_ms",
                              "conv_only_library_ms_min", "conv_only_library_ms_max")},
         "launches_tp_train": sum(n for (_, s, cin, cout), n in tp_trained["shapes"].items()
                                  if [s, cin, cout] == r["shape"][1:])}
        for r in results["fused_block_tp"]]
    # every brick-route row: its plan, times, bound and cuDNN's conv alone,
    # with its launches in each serve path that recorded its shapes
    fused["shapes"] = [
        {**{k: r[k] for k in ("shape", "plan", "max_abs_err", "ms", "ms_min", "ms_max",
                              "plain_ms", "bound_ms", "bound_by", "conv_only_library_ms",
                              "conv_only_library_ms_min", "conv_only_library_ms_max",
                              "tap_unit_ms", "tap_unit_ms_min", "tap_unit_ms_max") if k in r},
         "launches_by_path": {path: seen[tuple(r["shape"])] for path, seen in brick_shapes.items()}}
        for r in results["fused_block"]]
    line[0]["small_edge"] = [{k: r[k] for k in ("shape", "factor", "max_abs_err", "ms", "ms_min",
                                              "ms_max", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "library_ms_min", "library_ms_max")}
                             for r in results["halo_small"]]
    small = results["fused_block_small"]
    head = small[0]
    keys = ("shape", "factor", "max_abs_err", "ms", "ms_min", "ms_max", "plain_ms", "bound_ms",
            "bound_by", "conv_only_library_ms", "conv_only_library_ms_min",
            "conv_only_library_ms_max")
    line.insert(3, {
        "name": "fused_block_small", "route": "cuda",
        "source": "diffusioniqt_tpu_torch/csrc/fused_block_small.cu",
        "replaces": REPLACES["fused_block_small"],
        # the serve run of its path: the efficient flagship's sampler call
        "launches": served_eff["fused_block_small"],
        "launches_by_path": {"serve-efficient": served_eff["fused_block_small"],
                             "preset-srunet256 sampler call": served_srunet["fused_block_small"],
                             "forward-efficient": EFFICIENT_COUNTS["fused_block_small"],
                             "attn-context": served_context["fused_block_small"],
                             **{k: c["fused_block_small"] for k, c in served_video.items()},
                             **{k: c["fused_block_small"] for k, c in slice_paths.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in small), "tolerance": head["tol"],
        "ms": head["ms"], "ms_min": head["ms_min"], "ms_max": head["ms_max"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "library_ms_min": None, "library_ms_max": None,
        "library": LIBRARY["fused_block_small"],
        "shape": "x".join(str(v) for v in head["shape"]),
        "conv_only_library_ms": head["conv_only_library_ms"],
        "conv_only_library_ms_min": head["conv_only_library_ms_min"],
        "conv_only_library_ms_max": head["conv_only_library_ms_max"],
        # every shape the presets launch it at (SMALL_EDGE_SHAPES)
        "shapes": [{k: r[k] for k in keys if k in r} for r in small],
    })
    gn = results["group_norm"]
    line.append({
        "name": "group_norm", "route": "cuda", "source": "diffusioniqt_tpu_torch/csrc/group_norm.cu",
        "replaces": REPLACES["group_norm"],
        "launches": served["group_norm"],
        "launches_by_path": {"serve": served["group_norm"], "serve-attn": served_attn["group_norm"],
                             "serve-edm": served_edm["group_norm"],
                             "serve-efficient": served_eff["group_norm"],
                             "preset-srunet256 sampler call": served_srunet["group_norm"],
                             "train": trained["group_norm"],
                             **{k: c["launches"]["group_norm"] for k, c in cells.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in results["group_norm_compared"]),
        "tolerance": gn[0]["tol"],
        **{k: gn[0][k] for k in ("ms", "ms_min", "ms_max", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_ms_min", "library_ms_max", "stats_ms",
                                 "tables_ms", "chunks")},
        "library": LIBRARY["group_norm"], "shape": "x".join(str(v) for v in gn[0]["shape"]),
        "shapes": [{k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "stats_ms", "tables_ms", "chunks")}
                   for r in gn],
        # every shape the paths launch it at (GROUP_NORM_SHAPES), compared
        "compared": results["group_norm_compared"],
    })
    print(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
