"""The quality gate's training run on the card: the port's counterpart of
``tools/quality_run.py`` (QUALITY.md).

Trains the flagship SR U-Net (dim 64, ``batch_sample`` 27 x 32^3,
boundary halo convs, x_start objective; with ``--elucidated`` the EDM loss
and the 64-step Heun sampler) on seeded synthetic phantom pairs
(``data/synthetic.py``), then samples held-out phantoms with the **EMA**
weights over full sliding-window inference and the trim stitch, and scores
MS-SSIM and PSNR against the LR input: the reference's acceptance test
(test_all.py:304-324). The gate's run (QUALITY.md:37-45):

    python -m diffusioniqt_tpu_torch.quality_run --elucidated --steps 3000 \\
        --sigma-data 1.0 --batch-patches 8 --accum 2 --remat

A tiny CPU run (dim 16, one 96^3 phantom, 6 steps):

    python -m diffusioniqt_tpu_torch.quality_run --quick --elucidated --device cpu --out build/q

Writes under ``--out`` (default ``build/quality``, outside git): the loss
CSV ``train_loss.csv`` (step, loss, seconds since this invocation began),
``stats.json`` (the z-score stats the model is trained under, which
``quality_eval`` reads back), the rolling bundle ``ckpt.pt`` (every
``--ckpt-every`` steps and at the end, written beside the old one and then
renamed over it) and ``quality.json``.

``--resume BUNDLE`` restores the model, EMA, Adam state, step count and
the trainer's generator (so the diffusion draws continue their stream);
the dataset is rebuilt, so its crop stream restarts from its seed, as in
the JAX tool. ``--steps`` counts the steps of this invocation; the CSV
and ``quality.json`` count the bundle's steps too, and the CSV is
appended to. ``--max-seconds`` ends training early (at the first step
that finishes after it) and still saves and evaluates; ``quality.json``
then says how far it came (``steps`` against ``steps_planned``).
``--eval-volumes 0`` trains only. Runs on ``cuda`` unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

from diffusioniqt_tpu_torch.config import Config
from diffusioniqt_tpu_torch.data.synthetic import (
    SyntheticIQTDataset,
    generate_pair,
    population_stats,
)
from diffusioniqt_tpu_torch.diffusion.elucidated import elucidated_imagen_from_config
from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise, imagen_from_config
from diffusioniqt_tpu_torch.evaluate import evaluate
from diffusioniqt_tpu_torch.infer import infer_volume
from diffusioniqt_tpu_torch.models.unet3d import NullUnet
from diffusioniqt_tpu_torch.train import __main__ as train_main
from diffusioniqt_tpu_torch.utils.misc import resolve_device

# held-out phantom i is generate_pair(size, seed=HELDOUT_SEED + i); the
# training phantoms take seeds 0 .. volumes - 1
HELDOUT_SEED = 10_000
QUICK = {"size": 96, "volumes": 1, "batch_patches": 1, "eval_volumes": 1}
FULL = {"size": 192, "volumes": 4, "batch_patches": 4, "eval_volumes": 2}


def flagship_cfg(quick: bool = False, elucidated: bool = False, device="cuda") -> Config:
    """The gate's config (``tools/quality_run.py::flagship_cfg``): bf16
    compute on the card, fp32 on the CPU; ``quick`` the tiny CPU model."""
    cfg = Config()
    if elucidated:
        cfg.train.elucidated = True
        cfg.train.edm_num_sample_steps = 64
    cfg.train.batch_sample = True
    cfg.train.boundary = True
    cfg.train.patch_size_sub = 32
    cfg.train.pred_obj = "x_start"
    cfg.train.timesteps = 1000
    cfg.train.dynamic_threshold = False
    cfg.train.lr = 1e-4
    cfg.train.compute_dtype = ("bfloat16" if torch.device(device).type == "cuda"
                               else "float32")
    cfg.eval.overlap = 32
    if quick:
        cfg.train.dim = 16
        cfg.train.init_dim = 16
        cfg.train.dim_mults = (1, 2)
        cfg.train.num_resnet_blocks = (1, 1)
        cfg.train.att_enc = (False, False)
        cfg.train.att_enc_depth = (1, 1)
        cfg.train.att_enc_heads = (8, 8)
        cfg.train.timesteps = 20
    return cfg


def build_trainer(cfg, accum: int = 4, remat: bool = False, device="cuda"):
    """The cascade's trainer with the EMA on (``use_ema``, the config's
    ``ema_update_after_step`` / ``ema_update_every``), ``accum``
    microbatches per step and, with ``remat``, each ResnetBlock recomputed
    in the backward."""
    if remat:
        cfg.train.remat = True
    cfg.train.gradient_accumulation_steps = accum
    return train_main.build_trainer(cfg, device)


def training_pairs(size: int, volumes: int):
    """The training phantoms: (hr, lr) raw pairs of seeds 0 .. volumes-1."""
    return [generate_pair(size, seed=i) for i in range(volumes)]


def write_stats(out: str, mean: float, std: float, size: int, volumes: int,
                sigma_data: Optional[float] = None) -> dict:
    """``stats.json``: the z-score stats (and, for EDM, ``edm_sigma_data``)
    that evaluation must use again."""
    row = {"mean": mean, "std": std, "size": size, "volumes": volumes}
    if sigma_data is not None:
        row["edm_sigma_data"] = sigma_data
    with open(os.path.join(out, "stats.json"), "w") as fh:
        json.dump(row, fh)
    return row


def metric_border(edge: int) -> int:
    """The centre crop of the metrics (test_all.py:304): 32 voxels, less on
    small volumes."""
    return min(32, (edge - 1) // 3)


def mask_background(pred: np.ndarray, lr_n: np.ndarray) -> np.ndarray:
    """Background masking (test_all.py:300), in place: where the normalised
    LR volume is at its minimum, so is the prediction."""
    min_val = lr_n.min()
    pred[lr_n == min_val] = min_val
    return pred


def heldout_sampler(cfg, unet):
    """The sampler the config names (EDM Heun or ancestral) over ``unet``."""
    device = next(unet.parameters()).device
    unets = (NullUnet().to(device), unet.eval())
    return (elucidated_imagen_from_config(cfg, unets) if cfg.train.elucidated
            else imagen_from_config(cfg, unets))


def evaluate_heldout(cfg, imagen, *, size: int, volumes: int, mean: float, std: float,
                     stitch: str = "trim", patch_batch: int = 8) -> List[dict]:
    """Full-volume inference of held-out phantoms ``HELDOUT_SEED + i`` and
    their MS-SSIM / PSNR beside the LR input's, on the sampler's device.
    The noise comes from one generator seeded with 0, so a bundle scored
    again by ``quality_eval`` gives the same numbers."""
    device = next(imagen.unets[-1].parameters()).device
    noise = gaussian_noise(torch.Generator(device=device).manual_seed(0))
    rows = []
    for i in range(volumes):
        hr, lr = generate_pair(size, seed=HELDOUT_SEED + i)
        hr_n, lr_n = (hr - mean) / std, (lr - mean) / std
        t0 = time.time()
        with torch.no_grad():
            pred = infer_volume(cfg, imagen, lr, noise=noise, stitch_mode=stitch,
                                patch_batch=patch_batch, verbose=False)
        elapsed = time.time() - t0
        mask_background(pred, lr_n)
        border = metric_border(hr.shape[0])
        m_pred = evaluate(pred, hr_n, border=border, device=device)
        m_lr = evaluate(lr_n, hr_n, border=border, device=device)
        row = {"volume": i, "pred_msssim": m_pred["msssim"], "pred_psnr": m_pred["psnr"],
               "lr_msssim": m_lr["msssim"], "lr_psnr": m_lr["psnr"],
               "seconds": round(elapsed, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def verdict(rows: List[dict]) -> dict:
    """Whether the prediction beats the LR input on every volume."""
    return {"pred_beats_lr_msssim": all(r["pred_msssim"] > r["lr_msssim"] for r in rows),
            "pred_beats_lr_psnr": all(r["pred_psnr"] > r["lr_psnr"] for r in rows)}


def device_record(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``{"name": "cpu", "power_limit": None}`` on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, limit = lines[device.index or 0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def _loss_history(csv_path: str) -> List[float]:
    with open(csv_path) as fh:
        return [float(r["loss"]) for r in csv.DictReader(fh)]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported: --transfer-dtype (the port copies fp32 batches; the option "
               "was removed from the port), --remat-policy (the 'conv' policy raises in "
               "the port's UNet3D), --cpu (use --device cpu).")
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps of this invocation (default 3000; 6 with --quick)")
    ap.add_argument("--out", default=os.path.join("build", "quality"))
    ap.add_argument("--volumes", type=int, default=None, help="training phantoms (4)")
    ap.add_argument("--size", type=int, default=None, help="phantom edge (192)")
    ap.add_argument("--batch-patches", type=int, default=None,
                    help="96^3 patches per optimizer step (4)")
    ap.add_argument("--accum", type=int, default=4,
                    help="microbatches per step; a microbatch holds batch-patches / accum "
                         "patches of 27 sub-volumes")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each ResnetBlock in the backward (Train.remat)")
    ap.add_argument("--resume", default=None, help="bundle to resume from")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--eval-volumes", type=int, default=None,
                    help="held-out phantoms to score (2); 0 trains only")
    ap.add_argument("--elucidated", action="store_true",
                    help="EDM: train the elucidated loss, sample 64-step Heun + churn")
    ap.add_argument("--sigma-data", type=float, default=None,
                    help="EDM sigma_data (z-scored data: 1.0, Karras et al. 2022)")
    ap.add_argument("--edm-steps", type=int, default=None,
                    help="Heun steps of the final evaluation's EDM sampler (64; 8 with --quick)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny run: dim 16, one 96^3 phantom, 1 patch per step, 6 steps")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="end training at the first step that finishes after this many "
                         "seconds, then save and evaluate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    for key, val in (QUICK if args.quick else FULL).items():
        if getattr(args, key) is None:
            setattr(args, key, val)
    if args.steps is None:
        args.steps = 6 if args.quick else 3000
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg = flagship_cfg(args.quick, args.elucidated, device)
    if args.sigma_data is not None:
        cfg.train.edm_sigma_data = args.sigma_data
    # population z-score stats of the training LR volumes (config/config.yaml:12-15)
    pairs = training_pairs(args.size, args.volumes)
    mean, std = population_stats([lr for _, lr in pairs])
    cfg.data.mean, cfg.data.std = mean, std
    cfg.data.mean_hr, cfg.data.std_hr = population_stats([hr for hr, _ in pairs])
    write_stats(args.out, mean, std, args.size, args.volumes,
                cfg.train.edm_sigma_data if args.elucidated else None)
    dataset = SyntheticIQTDataset(cfg, seed=0, samples_per_volume=8, pairs=pairs)

    trainer = build_trainer(cfg, accum=1 if args.quick else args.accum, remat=args.remat,
                            device=device)
    trainer.add_train_dataset(dataset, batch_size=args.batch_patches)
    if args.resume:
        trainer.load(args.resume)
        print(f"resumed from {args.resume} at step {trainer.steps[1]}", flush=True)
    planned = trainer.steps[1] + args.steps
    print(f"config: dim={cfg.train.dim} steps={args.steps} mean={mean:.2f} std={std:.2f} "
          f"device={device}", flush=True)

    csv_path = os.path.join(args.out, "train_loss.csv")
    ckpt_path = os.path.join(args.out, "ckpt.pt")
    new_csv = not os.path.exists(csv_path)
    t0 = time.time()
    recent: List[float] = []
    with open(csv_path, "a") as fh:
        if new_csv:
            fh.write("step,loss,seconds\n")
        pending = []  # (step, device loss): the host syncs at log boundaries only
        for i in range(1, args.steps + 1):
            pending.append((trainer.steps[1] + 1, trainer.train_step(unet_number=2, sync=False)))
            last = i == args.steps or (args.max_seconds is not None
                                       and time.time() - t0 >= args.max_seconds)
            if i % args.log_every == 0 or i == 1 or last:
                for step, loss in pending:
                    recent = (recent + [float(loss)])[-args.log_every:]
                    fh.write(f"{step},{recent[-1]:.6f},{time.time() - t0:.1f}\n")
                pending = []
                fh.flush()
                print(f"step {trainer.steps[1]}/{planned} loss {np.mean(recent):.5f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if i % args.ckpt_every == 0 or last:
                trainer.save(ckpt_path)  # a temporary file renamed over the old one
            if last:
                break

    if args.eval_volumes <= 0:
        return None
    cfg_eval = flagship_cfg(args.quick, args.elucidated, device)
    if args.sigma_data is not None:
        cfg_eval.train.edm_sigma_data = args.sigma_data
    cfg_eval.data.mean, cfg_eval.data.std = mean, std
    cfg_eval.train.timesteps = 20
    if args.edm_steps is not None or args.quick:
        cfg_eval.train.edm_num_sample_steps = args.edm_steps or 8
    rows = evaluate_heldout(cfg_eval, heldout_sampler(cfg_eval, trainer.ema_unets[1]),
                            size=args.size, volumes=args.eval_volumes, mean=mean, std=std,
                            patch_batch=1 if args.quick else 8)
    losses = _loss_history(csv_path)
    summary = {
        "sampler": (f"edm-heun-{cfg_eval.train.edm_num_sample_steps}" if args.elucidated
                    else "gaussian-ancestral-20"),
        "steps": trainer.steps[1], "steps_planned": planned,
        "final_loss_mean_100": float(np.mean(losses[-100:])),
        "first_loss_mean_100": float(np.mean(losses[:100])),
        "volumes": rows, **verdict(rows),
        "config": {"dim": cfg.train.dim, "size": args.size, "mean": mean, "std": std,
                   "edm_sigma_data": cfg.train.edm_sigma_data if args.elucidated else None},
        "device": device_record(device),
    }
    with open(os.path.join(args.out, "quality.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
