"""Quality evaluation of a saved bundle on the card: the port's counterpart
of ``tools/quality_eval.py``.

Loads the EMA weights of a bundle that ``quality_run`` wrote, regenerates
the held-out phantoms (the same seeds), samples them over full
sliding-window inference and stitching, and scores MS-SSIM / PSNR beside
the LR input, with the evaluation ``quality_run`` ends with
(:func:`..quality_run.evaluate_heldout`). So training and evaluation can be
decoupled: score an earlier bundle, or the trim against the Gaussian
stitch.

    python -m diffusioniqt_tpu_torch.quality_eval --ckpt build/quality/ckpt.pt \\
        --elucidated --out build/quality

The z-score stats and, for EDM, ``edm_sigma_data`` come from the
``stats.json`` beside the bundle unless ``--mean`` / ``--std`` /
``--sigma-data`` are given. Writes ``quality_eval[_SUFFIX].json`` under
``--out``. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from diffusioniqt_tpu_torch import quality_run
from diffusioniqt_tpu_torch.data.synthetic import population_stats
from diffusioniqt_tpu_torch.infer import build_sampler
from diffusioniqt_tpu_torch.utils.misc import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported: --device-stitch (the port always stitches in device buffers), "
               "--cpu (use --device cpu).")
    ap.add_argument("--ckpt", required=True, help="a quality_run bundle (.pt)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mean", type=float, default=None)
    ap.add_argument("--std", type=float, default=None)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--eval-volumes", type=int, default=2)
    ap.add_argument("--stitch", choices=["trim", "gaussian"], default="trim")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--elucidated", action="store_true",
                    help="an EDM bundle (64-step Heun sampler)")
    ap.add_argument("--edm-steps", type=int, default=64)
    ap.add_argument("--edm-churn", type=float, default=None,
                    help="S_churn of the Heun sampler (0: deterministic Heun)")
    ap.add_argument("--sigma-data", type=float, default=None,
                    help="EDM sigma_data; defaults to the stats.json value (must match "
                         "training)")
    ap.add_argument("--patch-batch", type=int, default=8)
    ap.add_argument("--quick", action="store_true",
                    help="a bundle of quality_run --quick (the tiny model)")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    stats = {}
    stats_path = os.path.join(os.path.dirname(os.path.abspath(args.ckpt)), "stats.json")
    if os.path.exists(stats_path):
        with open(stats_path) as fh:
            stats = json.load(fh)
    if args.mean is not None and args.std is not None:
        mean, std = args.mean, args.std
    elif stats:
        mean, std = stats["mean"], stats["std"]
        print(f"stats from {stats_path}: mean={mean:.3f} std={std:.3f}")
    else:
        print("WARNING: no --mean/--std and no stats.json beside the bundle; recomputing "
              f"from 4 default training volumes at size {args.size}: the metrics are skewed "
              "if the run used other --volumes/--size", file=sys.stderr)
        mean, std = population_stats([lr for _, lr in quality_run.training_pairs(args.size, 4)])

    cfg = quality_run.flagship_cfg(args.quick, args.elucidated, device)
    cfg.data.mean, cfg.data.std = mean, std
    cfg.train.timesteps = args.timesteps
    if args.elucidated:
        cfg.train.edm_num_sample_steps = args.edm_steps
        if args.edm_churn is not None:
            cfg.train.edm_s_churn = args.edm_churn
        # the preconditioning must be the training's
        if args.sigma_data is not None:
            cfg.train.edm_sigma_data = args.sigma_data
        elif "edm_sigma_data" in stats:
            cfg.train.edm_sigma_data = stats["edm_sigma_data"]
            print(f"edm_sigma_data from stats.json: {cfg.train.edm_sigma_data}")
    imagen = build_sampler(cfg, device=device, checkpoint=args.ckpt, use_ema=True)
    steps = [int(s) for s in torch.load(args.ckpt, map_location="cpu",
                                        weights_only=True)["steps"]]
    print(f"loaded the EMA weights of {args.ckpt} at steps {steps}", flush=True)

    rows = quality_run.evaluate_heldout(cfg, imagen, size=args.size,
                                        volumes=args.eval_volumes, mean=mean, std=std,
                                        stitch=args.stitch,
                                        patch_batch=args.patch_batch)
    for row in rows:
        row["stitch"] = args.stitch
    summary = {
        "ckpt": args.ckpt, "steps": steps, "stitch": args.stitch,
        "sampler": (f"edm-heun-{args.edm_steps}" if args.elucidated
                    else f"gaussian-ancestral-{args.timesteps}"),
        "edm_s_churn": cfg.train.edm_s_churn if args.elucidated else None,
        "edm_sigma_data": cfg.train.edm_sigma_data if args.elucidated else None,
        "volumes": rows, **quality_run.verdict(rows),
        "device": quality_run.device_record(device),
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        suffix = args.suffix.lstrip("_")
        name = f"quality_eval{('_' + suffix) if suffix else ''}.json"
        with open(os.path.join(args.out, name), "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary


if __name__ == "__main__":
    main()
