"""Command-line interface of the port (counterpart of the root ``cli.py``;
reference cli.py:28-180): ``config`` / ``train`` / ``sample`` over a JSON
model config and a ``.pt`` bundle.

    python -m diffusioniqt_tpu_torch.cli config --path imagen_config.json
    python -m diffusioniqt_tpu_torch.cli train  --config imagen_config.json --steps 100
    python -m diffusioniqt_tpu_torch.cli sample --config imagen_config.json --lowres lr.npy

It reads the same JSON as the JAX ``cli.py`` (``model_configs.py``), so a
file either one wrote loads in the other. ``train`` trains on random
LR/HR pairs (``data/datasets.py::FakeIQTDataset``) and writes the
trainer's ``.pt`` bundle (``--checkpoint``, resumed from when it exists);
``sample`` draws with the bundle's EMA weights (random weights, with a
warning, when there is none), from stage 1, or with ``--lowres x.npy`` (one
``(s, s, s)`` volume or a ``(B, s, s, s, C)`` batch) from stage 2 upward.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from diffusioniqt_tpu_torch.utils.misc import resolve_device


def starter_config(elucidated: bool = False) -> dict:
    """What ``config`` writes: the JAX ``cli.py config`` starter, a null
    first stage and the 3D SR U-Net (dim 64, mults (1, 2, 4), SAME convs)."""
    return {
        "elucidated": elucidated,
        "imagen": {
            "unets": [
                {"kind": "null"},
                {
                    "kind": "unet3d", "dim": 64, "dim_mults": [1, 2, 4],
                    "channels": 1,
                    "kwargs": {
                        "num_resnet_blocks": [2, 2, 2], "init_dim": 64,
                        "init_cross_embed": False, "att_type": "linear",
                        "attend_at_middle": False,
                        "attend_at_enc": [False, False, False],
                        "use_se_attn": True, "batch_sample": False,
                        "boundary": False, "deep_feature": False,
                        "img_size": 32,
                    },
                },
            ],
            "image_sizes": [32, 32],
            "channels": 1,
            "timesteps": 1000,
            "pred_objectives": "x_start",
            "cond_drop_prob": 0.0,
            "dynamic_thresholding": False,
            "norm": "z-score",
        },
    }


def build_trainer(config_path: str, device):
    from diffusioniqt_tpu_torch.model_configs import ImagenTrainerConfig

    with open(config_path) as fh:
        raw = json.load(fh)
    return ImagenTrainerConfig.from_dict(raw).create(device)


def cmd_config(args) -> None:
    with open(args.path, "w") as fh:
        json.dump(starter_config(args.elucidated), fh, indent=2)
    print(f"wrote {args.path}")


def cmd_train(args) -> None:
    from diffusioniqt_tpu_torch.data.datasets import FakeIQTDataset

    trainer = build_trainer(args.config, resolve_device(args.device))
    if args.checkpoint and os.path.exists(args.checkpoint):
        trainer.load(args.checkpoint)
    size = trainer.imagen.image_sizes[-1]
    trainer.add_train_dataset(FakeIQTDataset(size=size, length=args.batch_size * 2),
                              batch_size=args.batch_size)
    for i in range(args.steps):
        loss = trainer.train_step(unet_number=args.unet)
        if i % 10 == 0:
            print(f"step {i}: loss {loss:.5f}")
    if args.checkpoint:
        trainer.save(args.checkpoint)
        print(f"saved {args.checkpoint}")


def cmd_sample(args) -> None:
    device = resolve_device(args.device)
    trainer = build_trainer(args.config, device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        trainer.load(args.checkpoint)
    else:
        trainer.prepare()
        print("WARNING: sampling with random weights")
    kwargs = {}
    if args.lowres:
        lowres = torch.from_numpy(np.load(args.lowres).astype(np.float32))
        if lowres.dim() == 3:
            lowres = lowres[None, ..., None]
        kwargs.update(start_image_or_video=lowres.to(device), start_at_unet_number=2)
        batch = lowres.shape[0]
    else:
        batch = args.batch_size
    out = trainer.sample(batch_size=batch, **kwargs).float().cpu().numpy()
    np.save(args.output, out)
    print(f"wrote {args.output} shape={out.shape}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m diffusioniqt_tpu_torch.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("config", help="write a starter model config JSON")
    p.add_argument("--path", default="./imagen_config.json")
    p.add_argument("--elucidated", action="store_true")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("train", help="train from a model config JSON")
    p.add_argument("--config", default="./imagen_config.json")
    p.add_argument("--checkpoint", default="./imagen_ckpt.pt")
    p.add_argument("--unet", type=int, default=2)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("sample", help="sample volumes from a bundle")
    p.add_argument("--config", default="./imagen_config.json")
    p.add_argument("--checkpoint", default="./imagen_ckpt.pt")
    p.add_argument("--lowres", default=None, help=".npy lowres volume")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--output", default="./samples.npy")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_sample)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
