"""Denoiser-accuracy probe of a trained EDM bundle: the port's counterpart
of ``tools/edm_probe.py``.

Separates a training-side failure (the preconditioned denoiser
``D(x; sigma)`` is inaccurate) from a sampler-side one (D is accurate but
the Heun / churn loop degrades it): ``x = clean + sigma * n`` goes through
``ElucidatedImagen.preconditioned_network_forward`` (EDM eq. 7) at a ladder
of sigmas, and the table reports RMSE(D(x), clean) against two baselines,
the identity denoiser (RMSE = sigma) and the LR conditioning input itself.

Reading the table:
  * rmse_D << min(sigma, rmse_lr) at every sigma: training is fine; suspect
    the sampling loop or its hyperparameters
  * rmse_D ~ rmse_lr at small sigma: the model ignores the noisy input and
    reproduces the conditioning
  * rmse_D > sigma at small sigma: the denoiser adds noise below that scale

The probe volume is the held-out phantom (seed 10000) at ``--size``, its
centre crop of ``factor * sub`` voxels (96 for the flagship: 27 sub-volumes
of 32^3; a phantom smaller than that gives sub-volumes of ``size //
factor``), z-scored with the ``stats.json`` beside the bundle, as the
quality run trained. The noise of each rung comes from a generator seeded
with 0, as the JAX tool fixes its key.

Usage (the bundle of ``quality_run --elucidated``, ``stats.json`` beside it):

    python -m diffusioniqt_tpu_torch.edm_probe --ckpt build/quality_gate/ckpt.pt
    python -m diffusioniqt_tpu_torch.edm_probe --ckpt build/q/ckpt.pt --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffusioniqt_tpu_torch.data.synthetic import generate_pair
from diffusioniqt_tpu_torch.ops.volume import volume_to_subvolumes
from diffusioniqt_tpu_torch.quality_run import build_trainer, flagship_cfg
from diffusioniqt_tpu_torch.utils.misc import resolve_device

SIGMAS = "0.01,0.05,0.2,1.0,5.0,20.0"
HELDOUT_SEED = 10_000


def probe_volumes(size: int, mean: float, std: float, sub: int, factor: int,
                  device) -> tuple:
    """``(clean, lowres)``: the held-out phantom pair's centre crop of
    ``factor * sub`` voxels, z-scored, split into ``factor^3`` sub-volumes ``(factor^3, sub, sub,
    sub, 1)`` fp32 on ``device``."""
    hr, lr = generate_pair(size, seed=HELDOUT_SEED)
    c0 = max((size - factor * sub) // 2, 0)
    sl = slice(c0, c0 + factor * sub)
    out = []
    for vol in (hr, lr):
        crop = ((vol - mean) / std)[sl, sl, sl].astype(np.float32)[None, ..., None]
        out.append(volume_to_subvolumes(torch.from_numpy(crop).to(device), factor))
    return tuple(out)


def _rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


@torch.no_grad()
def probe_rows(imagen, index: int, clean: torch.Tensor, lowres: torch.Tensor,
               sigmas: Sequence[float], generator: torch.Generator,
               lowres_noise_level: Optional[float] = None) -> Dict:
    """The probe's table for unet ``index`` of ``imagen`` (an
    ``ElucidatedImagen``): the conditioning noised as ``sample`` noises it
    (clean when ``lowres_noise_aug`` is off, the IQT default; a draw from
    ``generator`` otherwise), then for each sigma a draw ``n`` from
    ``generator`` and the RMSEs of ``x = clean + sigma n``, of ``D(x)`` and
    of the clamped ``D(x)`` against ``clean``."""
    unet, hp = imagen.unets[index], imagen.hparams[index]
    level = lowres_noise_level
    if level is None:
        level = imagen.lowres_sample_noise_level if imagen.lowres_noise_aug else 0.0
    lowres_noisy = lowres
    if level > 0.0:
        t_low = imagen.lowres_noise_schedule.get_times(lowres.shape[0], level,
                                                       device=lowres.device)
        draw = torch.randn(lowres.shape, generator=generator,
                           device=generator.device).to(lowres.device)
        lowres_noisy = imagen.lowres_noise_schedule.q_sample(lowres, t_low, draw)[0]
    rows: List[dict] = []
    for sigma in sigmas:
        n = torch.randn(clean.shape, generator=generator, device=generator.device)
        x = clean + sigma * n.to(clean.device)
        d = imagen.preconditioned_network_forward(unet, x, sigma, hp, clamp=False,
                                                  lowres_cond_img=lowres_noisy)
        dc = imagen.preconditioned_network_forward(
            unet, x, sigma, hp, clamp=True,
            dynamic_threshold=bool(imagen.dynamic_thresholding[index]),
            lowres_cond_img=lowres_noisy)
        rows.append({"sigma": float(sigma), "rmse_in": _rmse(x, clean),
                     "rmse_D": _rmse(d, clean), "rmse_D_clamped": _rmse(dc, clean)})
    return {"lowres_noise_level": float(level),
            "data_std": float(clean.float().std(unbiased=False)),
            "baseline_rmse_lr": _rmse(lowres, clean), "rows": rows}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 epilog="Not ported: --cpu (use --device cpu).")
    ap.add_argument("--ckpt", required=True, help="a .pt bundle with stats.json beside it")
    ap.add_argument("--size", type=int, default=192, help="the held-out phantom's edge")
    ap.add_argument("--sigmas", default=SIGMAS)
    ap.add_argument("--sigma-data", type=float, default=None)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--lowres-noise-level", type=float, default=None,
                    help="conditioning noise level at probe time (default: the model's, "
                         "clean conditioning when lowres noise augmentation is off)")
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default: probe.json beside the bundle)")
    ap.add_argument("--quick", action="store_true",
                    help="the tiny model of quality_run --quick")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    stats_path = os.path.join(os.path.dirname(os.path.abspath(args.ckpt)), "stats.json")
    with open(stats_path) as fh:
        stats = json.load(fh)
    mean, std = stats["mean"], stats["std"]
    cfg = flagship_cfg(args.quick, elucidated=True, device=device)
    cfg.data.mean, cfg.data.std = mean, std
    if args.sigma_data is not None:
        cfg.train.edm_sigma_data = args.sigma_data
    elif "edm_sigma_data" in stats:
        cfg.train.edm_sigma_data = stats["edm_sigma_data"]
    print(f"sigma_data={cfg.train.edm_sigma_data}")

    trainer = build_trainer(cfg, device=device)
    trainer.prepare()
    trainer.load(args.ckpt)
    print(f"loaded {args.ckpt} at steps {list(trainer.steps)}")
    imagen = trainer._sampling_imagen(use_ema=not args.no_ema)
    factor = cfg.train.batch_sample_factor
    sub = min(cfg.train.patch_size_sub, args.size // factor)
    clean, lowres = probe_volumes(args.size, mean, std, sub, factor, device)
    generator = torch.Generator(device=device).manual_seed(0)
    table = probe_rows(imagen, len(imagen.unets) - 1, clean, lowres,
                       [float(s) for s in args.sigmas.split(",")], generator,
                       args.lowres_noise_level)
    print(f"conditioning noise level = {table['lowres_noise_level']}")
    print(f"baseline RMSE(lowres, clean) = {table['baseline_rmse_lr']:.4f}   "
          f"(data std ~= {table['data_std']:.4f})")
    print(f"{'sigma':>8} {'rmse_in':>9} {'rmse_D':>9} {'rmse_D_clamped':>14}")
    for row in table["rows"]:
        print(f"{row['sigma']:8.3f} {row['rmse_in']:9.4f} {row['rmse_D']:9.4f} "
              f"{row['rmse_D_clamped']:14.4f}")
    summary = {"ckpt": args.ckpt, "sigma_data": cfg.train.edm_sigma_data,
               "lowres_noise_level": table["lowres_noise_level"],
               "data_std": table["data_std"], "baseline_rmse_lr": table["baseline_rmse_lr"],
               "rows": table["rows"]}
    out_path = args.out or os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                                         "probe.json")
    with open(out_path, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
