"""The 2D-slice quality run on the card: the port's counterpart of
``tools/quality_run_2d.py``.

Trains ``UNet2D`` (dim 24, mults (1, 2, 4), 2 ResnetBlocks a level, SE,
``att_type`` linear with no attention slot on, as the JAX tool builds it)
through the ancestral ``Imagen`` with ``spatial_dims=2`` on random
foreground axial slices of the procedural phantoms (``data/synthetic.py``),
cropped to ``--crop``, x_start objective, z-scored; then samples held-out
central slices of a phantom
with the EMA weights (20 ancestral steps, the full slice: the model is
fully convolutional) and scores the slice stack against the LR input with
the reference's acceptance rule (test_all.py:304-324): the samples must
beat the LR input on MS-SSIM and on PSNR.

    python -m diffusioniqt_tpu_torch.quality_run_2d --steps 600 --out build/quality_2d
    python -m diffusioniqt_tpu_torch.quality_run_2d --quick --device cpu --out build/q2d

Writes under ``--out``: ``train_loss.csv`` (step, loss, seconds since this
invocation began; appended to), the rolling bundle ``ckpt.pt`` (every
``--ckpt-every`` steps and at the end, written beside the old one and then
renamed over it) and ``quality_eval_2d.json`` (the JAX tool's keys, plus
the seconds per training step and the card). ``--resume BUNDLE`` restores
the model, EMA, Adam state, step count and generator before training;
``--eval-only`` scores the resumed bundle without training. Runs on
``cuda`` (bf16 compute) unless ``--device cpu`` is given (fp32).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from diffusioniqt_tpu_torch.config import Config
from diffusioniqt_tpu_torch.data.synthetic import generate_pair, population_stats
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.evaluate import evaluate
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import NullUnet
from diffusioniqt_tpu_torch.quality_run import HELDOUT_SEED, device_record, mask_background
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer
from diffusioniqt_tpu_torch.utils.misc import resolve_device

QUICK = {"steps": 6, "dim": 8, "crop": 32, "size": 96, "volumes": 1, "batch": 2,
         "eval_slices": 8}


class SliceIQTDataset:
    """Random foreground axial slices, each cropped to a random ``crop``
    square, of (hr, lr) phantom pairs, z-scored with the population stats:
    the 2D analogue of ``SyntheticIQTDataset`` (a copy of the JAX tool's
    class). Items are ``(hr, lr)`` of shape ``(crop, crop, 1)``, fp32; the
    crops come from one ``numpy`` generator seeded with ``seed + 1234``,
    whatever the index asked for."""

    def __init__(self, pairs, mean, std, crop: int = 96, samples_per_volume: int = 32,
                 seed: int = 0, min_foreground: float = 0.2):
        self.mean, self.std = mean, std
        self.crop = crop
        self.samples_per_volume = samples_per_volume
        self._rng = np.random.default_rng(seed + 1234)
        self.slices = []  # (hr_slice, lr_slice) raw intensity
        for hr, lr in pairs:
            for z in range(hr.shape[0]):
                if np.count_nonzero(lr[z]) / lr[z].size >= min_foreground:
                    self.slices.append((hr[z], lr[z]))
        if not self.slices:
            raise ValueError("no foreground slices found")

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, idx: int):
        hr, lr = self.slices[self._rng.integers(0, len(self.slices))]
        c = self.crop
        ry, rx = self._rng.integers(0, hr.shape[0] - c + 1, size=2)
        hr_p = (hr[ry:ry + c, rx:rx + c] - self.mean) / self.std
        lr_p = (lr[ry:ry + c, rx:rx + c] - self.mean) / self.std
        return hr_p[..., None].astype(np.float32), lr_p[..., None].astype(np.float32)


def build_trainer_2d(dim: int, crop: int, timesteps: int, mean: float, std: float,
                     lr_rate: float, device, seed: int = 0,
                     dtype: Optional[torch.dtype] = None) -> ImagenTrainer:
    """The JAX tool's ``build_trainer_2d``: ``UNet2D`` (weights drawn under
    ``torch.manual_seed(seed)``) behind a ``NullUnet`` stage in an ancestral
    ``Imagen`` of ``spatial_dims=2`` (x_start, no dynamic thresholding, no
    p2 weighting, no [0, 1] rescaling, no conditioning dropout, the
    z-score ``min_bound``), trained one microbatch a step with the EMA from
    step 100, every 10th step. ``dtype`` is the compute dtype, as the JAX
    tool's ``dtype`` argument; by default bf16 on the card and fp32 on the
    CPU (the JAX CLI picks by backend, and so does :func:`main`)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = Config()
    cfg.train.batch_sample = False
    cfg.train.boundary = False
    cfg.train.patch_size_sub = crop
    cfg.train.timesteps = timesteps
    cfg.train.pred_obj = "x_start"
    cfg.train.compute_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg.data.mean, cfg.data.std = mean, std
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        unet = UNet2D(dim=dim, dim_mults=(1, 2, 4), num_resnet_blocks=2, channels=1,
                      lowres_cond=True, init_dim=dim, resnet_groups=8, att_type="linear",
                      use_se_attn=True, dtype=dtype)
    imagen = Imagen(
        [NullUnet().to(device), unet.to(device)], image_sizes=(crop, crop), channels=1,
        timesteps=timesteps, pred_objectives="x_start", dynamic_thresholding=False,
        p2_loss_weight_gamma=0.0, auto_normalize_img=False, cond_drop_prob=0.0,
        min_bound=(0.0 - mean) / std, norm="z-score", spatial_dims=2)
    return ImagenTrainer(configs=cfg, imagen=imagen, gradient_accumulation_steps=1,
                         lr=lr_rate, use_ema=True, ema_update_after_step=100,
                         ema_update_every=10)


def heldout_slices(size: int, count: int, mean: float, std: float):
    """The ``count`` central axial slices of held-out phantom
    ``HELDOUT_SEED``, z-scored: ``(hr_n, lr_n)``, each ``(count, size, size)``."""
    hr, lr = generate_pair(size, seed=HELDOUT_SEED)
    z0 = (hr.shape[0] - count) // 2
    zs = slice(z0, z0 + count)
    return (((hr[zs] - mean) / std).astype(np.float32),
            ((lr[zs] - mean) / std).astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=os.path.join("build", "quality_2d"))
    ap.add_argument("--volumes", type=int, default=3)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--dim", type=int, default=24)
    ap.add_argument("--crop", type=int, default=96)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--train-timesteps", type=int, default=1000)
    ap.add_argument("--sample-timesteps", type=int, default=20)
    ap.add_argument("--eval-slices", type=int, default=32)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="save the rolling bundle every N steps (0: only at the end)")
    ap.add_argument("--resume", default=None, help="bundle to load before training")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate the --resume bundle")
    ap.add_argument("--quick", action="store_true",
                    help="tiny run: dim 8, 32^2 crops, one 96^3 phantom, 6 steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        for key, val in QUICK.items():
            setattr(args, key, val)
    if args.eval_only and not args.resume:
        ap.error("--eval-only needs --resume")
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    pairs = [generate_pair(args.size, seed=i) for i in range(args.volumes)]
    mean, std = population_stats([lr for _, lr in pairs])
    dataset = SliceIQTDataset(pairs, mean, std, crop=args.crop, seed=0)
    trainer = build_trainer_2d(args.dim, args.crop, args.train_timesteps, mean, std, args.lr,
                               device)
    trainer.add_train_dataset(dataset, batch_size=args.batch)
    print(f"config: dim={args.dim} crop={args.crop} slices={len(dataset)} mean={mean:.2f} "
          f"std={std:.2f} device={device}", flush=True)
    if args.resume:
        trainer.load(args.resume)
        print(f"resumed from {args.resume} at step {trainer.steps[1]}", flush=True)

    losses, train_s = [], None
    if not args.eval_only:
        ckpt_path = os.path.join(args.out, "ckpt.pt")
        csv_path = os.path.join(args.out, "train_loss.csv")
        new_csv = not os.path.exists(csv_path)
        t0 = time.time()
        with open(csv_path, "a") as fh:
            if new_csv:
                fh.write("step,loss,seconds\n")
            pending = []  # (step, device loss): the host syncs at log boundaries only
            for step in range(1, args.steps + 1):
                pending.append((step, trainer.train_step(unet_number=2, sync=False)))
                if step % args.log_every == 0 or step in (1, args.steps):
                    for s, loss in pending:
                        losses.append(float(loss))
                        fh.write(f"{s},{losses[-1]:.6f},{time.time() - t0:.1f}\n")
                    pending = []
                    fh.flush()
                    print(f"step {step}/{args.steps} loss "
                          f"{np.mean(losses[-args.log_every:]):.5f} ({time.time() - t0:.0f}s)",
                          flush=True)
                if args.ckpt_every and step % args.ckpt_every == 0:
                    trainer.save(ckpt_path)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.time() - t0
        trainer.save(ckpt_path)

    # held-out central slices, sampled whole by an eval trainer at the
    # slice size and the sampling timesteps, with the trained weights
    hr_n, lr_n = heldout_slices(args.size, args.eval_slices, mean, std)
    evaluator = build_trainer_2d(args.dim, args.size, args.sample_timesteps, mean, std,
                                 args.lr, device)
    evaluator.prepare()
    trainer.prepare()
    evaluator.imagen.unets[1].load_state_dict(trainer.imagen.unets[1].state_dict())
    evaluator.ema_unets[1].load_state_dict(trainer.ema_unets[1].state_dict())
    t1 = time.time()
    pred = evaluator.sample(start_at_unet_number=2,
                            start_image_or_video=torch.from_numpy(lr_n[..., None]).to(device),
                            batch_size=args.eval_slices, max_batch_size=8)
    pred = pred[..., 0].float().cpu().numpy()
    elapsed = time.time() - t1
    mask_background(pred, lr_n)  # reference test_all.py:300
    border = min(8, (args.eval_slices - 1) // 3)
    m_pred = evaluate(pred, hr_n, border=border, device=device)
    m_lr = evaluate(lr_n, hr_n, border=border, device=device)

    summary = {
        "steps": 0 if args.eval_only else args.steps,
        "final_loss_mean_50": float(np.mean(losses[-50:])) if losses else None,
        "first_loss_mean_50": float(np.mean(losses[:50])) if losses else None,
        "eval_slices": args.eval_slices,
        "sample_seconds": round(elapsed, 1),
        "pred_msssim": m_pred["msssim"], "pred_psnr": m_pred["psnr"],
        "lr_msssim": m_lr["msssim"], "lr_psnr": m_lr["psnr"],
        "pred_beats_lr_msssim": m_pred["msssim"] > m_lr["msssim"],
        "pred_beats_lr_psnr": m_pred["psnr"] > m_lr["psnr"],
        "config": {"dim": args.dim, "crop": args.crop, "size": args.size,
                   "volumes": args.volumes, "batch": args.batch, "backend": device.type},
        "train_seconds_per_step": train_s / args.steps if train_s else None,
        "bundle_steps": trainer.steps[1],
        "device": device_record(device),
    }
    with open(os.path.join(args.out, "quality_eval_2d.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
