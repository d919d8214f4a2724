"""A benchmark root at a size the CPU holds: a copy of ``benchmark/`` in a
temporary directory with tiny configurations, traffic mixes and limits of
its own, and a manifest that names only them. The port runs there on the
CPU through the plain versions of its kernels."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[2]
# the configurations the tiny ones are cut from: the cell's, and the port's
# SRUnet256 preset (cross-embed stem, middle attention), which no cell runs
CONFIGS = {"iqt-sr-unet": REPO / "benchmark" / "configs" / "iqt-sr-unet.json",
           "srunet256-3d": REPO / "benchmark" / "tests" / "srunet256-preset.json"}

TINY_ARCH = dict(dim=8, init_dim=8, dim_mults=[1, 2], num_resnet_blocks=[1, 1],
                 init_patch_size=2, img_size=24, attn_dim_head=4, attend_at_middle_heads=2)
TINY_TRAIN = dict(dim=8, init_dim=8, dim_mults=[1, 2], num_resnet_blocks=[1, 1],
                  patch_size_sub=8, timesteps=4, att_mid_heads=2, att_head_dim=4,
                  att_enc=[False, False], att_enc_depth=[1, 1], att_enc_heads=[8, 8])


def _program(path: str, **train):
    cfg = yaml.safe_load(open(REPO / path))
    cfg["Train"].update(TINY_TRAIN, **train)
    cfg["Eval"]["overlap"] = 8
    return cfg


def make_root(tmp: Path, limits=None) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``benchmark/`` with the tiny
    workloads ``tiny-iqt-serve``, ``tiny-sr-serve`` and ``tiny-iqt-train``."""
    root = Path(tmp)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.load(open(REPO / "BENCHMARK.json"))
    for name, path in CONFIGS.items():
        cfg = json.load(open(path))
        cfg["name"] = "tiny-" + name
        cfg["arch"].update(TINY_ARCH)
        if name == "srunet256-3d":
            cfg["arch"]["dim_mults"] = [1, 2]
            cfg["program"]["kwargs"].update(dim=8, init_dim=8, dim_mults=[1, 2],
                                            num_resnet_blocks=[1, 1], init_patch_size=2,
                                            img_size=24, attn_dim_head=4, attend_at_middle_heads=2,
                                            dtype="float32")
        for mode, spec in cfg["modes"].items():
            spec["program_config"] = _program(
                "config/eval_config.yaml" if mode == "serve" else "config/config.yaml")
            spec["program_config"]["Train"]["compute_dtype"] = "float32"
        json.dump(cfg, open(root / "benchmark" / "configs" / f"tiny-{name}.json", "w"))
    json.dump({"driver": "serve_volumes", "params": {
        "mode": "serve", "volume_edge": 32, "volumes": 2, "patch_batch": 8, "trace_calls": 2,
        "recorded_calls": 2, "nfe_min_intervals": 4}},
        open(root / "benchmark" / "traffic" / "tiny-serve.json", "w"))
    json.dump({"driver": "train_steps", "params": {
        "mode": "train", "phantoms": 2, "phantom_edge": 32, "batch": 8, "steps_per_epoch": 2,
        "setup_steps": 3, "trace_steps": 2}},
        open(root / "benchmark" / "traffic" / "tiny-train.json", "w"))
    cells = [("tiny-iqt-serve", "tiny-iqt-sr-unet", "tiny-serve"),
             ("tiny-sr-serve", "tiny-srunet256-3d", "tiny-serve"),
             ("tiny-iqt-train", "tiny-iqt-sr-unet", "tiny-train")]
    manifest["configs"] = [{"name": "tiny-" + name, "source": "tiny", "reduced": [],
                            "file": f"benchmark/configs/tiny-{name}.json", "why": "tiny"}
                           for name in CONFIGS]
    manifest["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                             for n, c, t in cells]
    # each tiny cell stands in for the cell whose metrics and limits it takes
    cut_from = {"tiny-iqt-serve": "iqt-serve-128", "tiny-sr-serve": "iqt-serve-128",
                "tiny-iqt-train": "iqt-train-32"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, cell in cut_from.items() if cell in m["workloads"]]
    json.dump(manifest, open(root / "BENCHMARK.json", "w"))
    for new, old in cut_from.items():
        lim = json.load(open(REPO / "benchmark" / "limits" / f"{old}.json"))
        if limits is not None:
            lim = copy.deepcopy(limits.get(new, lim))
        json.dump(lim, open(root / "benchmark" / "limits" / f"{new}.json", "w"))
    return root
