"""Full-scale file-driven round trip through the port's entry points: the
counterpart of ``tools/nifti_roundtrip.py``.

The reference's workflow is 256^3 NIfTI volumes on disk -> train ->
test-set evaluation (reference ``data.py:112-113`` asserts 256^3 volumes).
This proves it end to end with no loop of its own:

  1. ``--prepare`` writes synthetic phantoms as 256^3 ``.nii.gz`` in the
     reference's layout (``<root>/{train,valid,test}/sub*/T1w/``) and
     derives the train and eval YAML configs from ``config/config.yaml``
     and ``config/eval_config.yaml`` (the flagship's batch_sample / boundary
     geometry) with the population z-score stats filled in
  2. ``--run`` drives the entry points as subprocesses::

        python -m diffusioniqt_tpu_torch.train --config <root>/config_train.yaml \\
            --steps N --eval-every E
        python -m diffusioniqt_tpu_torch.evaluate --config <root>/config_eval.yaml \\
            --checkpoint <root>/results/nifti_roundtrip/model/checkpoint.pt \\
            --stitch gaussian --output-dir <root>/inference_out

     and prints the seconds of each stage and the kernel launches of each
     entry point (the line it prints last, ``ops/kernels::launches_line``)
     as one JSON line.

Usage (on the card):

    python -m diffusioniqt_tpu_torch.nifti_roundtrip --root build/phantom_nifti \\
        --prepare --run --steps 300
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
import yaml

from diffusioniqt_tpu_torch.data.nifti import write
from diffusioniqt_tpu_torch.data.synthetic import generate_pair, population_stats
from diffusioniqt_tpu_torch.ops.kernels import LAUNCHES_LINE

REPO = Path(__file__).resolve().parents[1]
EDGE = 256
HR_NAME, LR_NAME = "T1w_acpc_dc_restore_brain.nii.gz", "lr_norm.nii.gz"


def prepare(root: str, n_train: int, n_valid: int, n_test: int) -> Dict[str, str]:
    """Write the phantoms (seeds 0, 1, ... over train, valid, test) and the
    two configs; returns ``{file name: path}`` of the configs."""
    splits = {"train": n_train, "valid": n_valid, "test": n_test}
    train_lr, train_hr = [], []
    seed = 0
    for split, n in splits.items():
        for i in range(n):
            hr, lr = generate_pair(EDGE, seed=seed)
            seed += 1
            d = os.path.join(root, split, f"sub{i:02d}", "T1w")
            os.makedirs(d, exist_ok=True)
            write(os.path.join(d, HR_NAME), hr.astype(np.float32))
            write(os.path.join(d, LR_NAME), lr.astype(np.float32))
            if split == "train":
                train_lr.append(lr)
                train_hr.append(hr)
            print(f"wrote {split}/sub{i:02d} ({EDGE}^3)", flush=True)

    mean, std = population_stats(train_lr)
    mean_hr, std_hr = population_stats(train_hr)
    paths = {}
    for name, base, patch in (
        ("config_train.yaml", "config.yaml", {
            "Train": {"batch_sample": True, "boundary": True, "use_se": True},
            "Eval": {"repeat": 1},
        }),
        ("config_eval.yaml", "eval_config.yaml", {}),
    ):
        with open(REPO / "config" / base) as fh:
            cfg = yaml.safe_load(fh)
        held_out = "valid" if name == "config_train.yaml" else "test"
        cfg["ProjectName"] = "nifti_roundtrip/"
        cfg["Results"] = os.path.join(root, "results") + "/"
        cfg["Data"].update({
            "groundtruth_path": os.path.join(root, "train/*/T1w/" + HR_NAME),
            "lowres_path": os.path.join(root, "train/*/T1w/lr_norm*.gz"),
            "groundtruth_path_test": os.path.join(root, held_out + "/*/T1w/" + HR_NAME),
            "lowres_path_test": os.path.join(root, held_out + "/*/T1w/lr_norm*.gz"),
            "mean": mean, "std": std, "mean_hr": mean_hr, "std_hr": std_hr,
        })
        for sect, kv in patch.items():
            cfg[sect].update(kv)
        out = os.path.join(root, name)
        with open(out, "w") as fh:
            yaml.dump(cfg, fh)
        paths[name] = out
        print(f"wrote {out}", flush=True)
    return paths


def run_entry(cmd) -> dict:
    """Run ``cmd`` from the repo's root, echo its standard output, and
    return the launch counts of its :data:`LAUNCHES_LINE` (None if it
    printed none); raises ``CalledProcessError`` if it fails."""
    print("+ " + " ".join(cmd), flush=True)
    launches = None
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith(LAUNCHES_LINE):
                launches = json.loads(line[len(LAUNCHES_LINE):])
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return launches


def run(root: str, steps: int, eval_every: int, device: str = "cuda") -> dict:
    """Train on ``<root>/config_train.yaml`` for ``steps`` steps, then
    evaluate the best bundle (the last one when no validation ran) on the
    test split with the gaussian stitch; returns the seconds and the kernel
    launches of each stage, and the bundle's path."""
    project = os.path.join(root, "results", "nifti_roundtrip")
    log = {"steps": steps}
    t0 = time.time()
    cmd = [sys.executable, "-m", "diffusioniqt_tpu_torch.train",
           "--config", os.path.join(root, "config_train.yaml"),
           "--steps", str(steps), "--eval-every", str(eval_every), "--device", device]
    log["train_launches"] = run_entry(cmd)
    log["train_seconds"] = round(time.time() - t0, 1)

    ckpt = os.path.join(project, "model", "checkpoint.pt")
    if not os.path.isfile(ckpt):  # no validation ran -> the best was never saved
        ckpt = os.path.join(project, "model", "last_checkpoint.pt")
    t1 = time.time()
    cmd = [sys.executable, "-m", "diffusioniqt_tpu_torch.evaluate",
           "--config", os.path.join(root, "config_eval.yaml"),
           "--checkpoint", ckpt, "--stitch", "gaussian",
           "--output-dir", os.path.join(root, "inference_out"), "--device", device]
    log["evaluate_launches"] = run_entry(cmd)
    log["evaluate_seconds"] = round(time.time() - t1, 1)
    log["checkpoint"] = ckpt
    return log


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join("build", "phantom_nifti"))
    ap.add_argument("--train-volumes", type=int, default=3)
    ap.add_argument("--valid-volumes", type=int, default=1)
    ap.add_argument("--test-volumes", type=int, default=1)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--prepare", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    log = {}
    if args.prepare:
        t0 = time.time()
        prepare(root, args.train_volumes, args.valid_volumes, args.test_volumes)
        log["prepare_seconds"] = round(time.time() - t0, 1)
    if args.run:
        log.update(run(root, args.steps, args.eval_every, args.device))
        print(json.dumps(log))
    return log


if __name__ == "__main__":
    main()
