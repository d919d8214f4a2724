"""Training entry point: the port's counterpart of the root ``train.py``
(reference train.py:27-195). Reads the YAML config, builds the (NullUnet,
SR U-Net) cascade, Gaussian or EDM as ``Train.elucidated`` says, and the
trainer, then trains with periodic validation, CSV loss logs, best-model
bundles and ``.npy`` dumps of the validation outputs:

    python -m diffusioniqt_tpu_torch.train --config config/config.yaml --fake-data --steps 100

Bundles are ``.pt`` files in the reference's trainer format
(``train/trainer.py``), ``Train.save_model`` (the best validation loss)
and ``Train.save_last_model`` under ``Results/ProjectName/Model``; a name
without ``.pt`` gets it, and so does ``Train.pretrain_model``, which a
config with ``Train.pretrain`` loads first (``strict=False``). ``python -m
diffusioniqt_tpu_torch.infer --checkpoint`` serves them. Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np
import torch
import yaml

from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.data.datasets import FakeIQTDataset, SupervisedIQT
from diffusioniqt_tpu_torch.diffusion.elucidated import elucidated_imagen_from_config
from diffusioniqt_tpu_torch.diffusion.gaussian import imagen_from_config
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, iqt_unet_from_config
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer
from diffusioniqt_tpu_torch.utils.misc import resolve_device
from diffusioniqt_tpu_torch.utils.seed import set_seed


def build_trainer(cfg, device="cuda") -> ImagenTrainer:
    """The cascade and its trainer as ``train.py`` builds them, the SR
    U-Net on ``device`` with weights from ``Train.seed``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        unet = iqt_unet_from_config(cfg, device=device)
    unets = (NullUnet().to(device), unet)
    imagen = (elucidated_imagen_from_config(cfg, unets) if cfg.train.elucidated
              else imagen_from_config(cfg, unets))
    t = cfg.train
    return ImagenTrainer(
        configs=cfg, imagen=imagen, gradient_accumulation_steps=t.gradient_accumulation_steps,
        lr=t.lr, ema_decay=t.ema_decay, ema_update_after_step=t.ema_update_after_step,
        ema_update_every=t.ema_update_every, max_grad_norm=t.max_grad_norm,
        warmup_steps=t.warmup_steps, cosine_decay_max_steps=t.cosine_decay_max_steps,
        seed=t.seed)


def _pt(path: str) -> str:
    return path if path.endswith(".pt") else f"{path}.pt"


def _bundle_path(project_path: str, cfg, name: str) -> str:
    return os.path.join(project_path, cfg.model_dir, _pt(name))


def _write_csv(path: str, rows: dict) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(rows.keys())
        for vals in zip(*rows.values()):
            w.writerow(vals)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="./config/config.yaml")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--fake-data", action="store_true",
                    help="train on random volumes (smoke test, no NIfTI needed)")
    ap.add_argument("--fake-size", type=int, default=None,
                    help="edge of fake volumes (defaults to config patch size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    set_seed(cfg.train.seed)

    project_path = os.path.join(cfg.results_dir, cfg.project_name)
    if os.path.isdir(project_path):
        raise FileExistsError(f"project {project_path} exists!")
    for sub in (cfg.model_dir, cfg.file_dir, cfg.eval.save_imgs):
        os.makedirs(os.path.join(project_path, sub))
    with open(os.path.join(project_path, "config.yaml"), "w") as fh:
        yaml.dump(cfg.to_dict(), fh)

    batch_size = 1 if cfg.train.batch_sample else cfg.train.batch_size
    batch_size_test = 1 if cfg.train.batch_sample else cfg.eval.batch_size
    if args.fake_data:
        size = args.fake_size or cfg.train.patch_size
        train_dataset = FakeIQTDataset(size=size, length=max(batch_size * 2, 8), seed=0)
        valid_dataset = FakeIQTDataset(size=size, length=max(batch_size_test, 4), seed=1)
    else:
        hr_files = sorted(glob.glob(cfg.data.groundtruth_path))
        lr_files = sorted(glob.glob(cfg.data.lowres_path))
        print(len(hr_files), len(lr_files))
        train_dataset = SupervisedIQT(cfg, lr_files, hr_files)
        hr_t = sorted(glob.glob(cfg.data.groundtruth_path_test))
        lr_t = sorted(glob.glob(cfg.data.lowres_path_test))
        print(len(hr_t), len(lr_t))
        valid_dataset = SupervisedIQT(cfg, lr_t, hr_t, train=False)
    print("Min bound ", cfg.data.min_bound)

    trainer = build_trainer(cfg, device)
    print(f"{type(trainer.imagen).__name__} loaded on {device}")
    if cfg.train.pretrain:
        trainer.load(_pt(cfg.train.pretrain_model), strict=False, noop_if_not_exist=False)
        print("Pretrained model is loaded")
    trainer.add_train_dataset(train_dataset, batch_size=batch_size)
    trainer.add_valid_dataset(valid_dataset, batch_size=batch_size_test)
    print("Model and Data are loaded!")

    train_ls, valid_ls, ssim_val, psnr_val = [], [], [], []
    best = 1e4
    log_dir = os.path.join(project_path, cfg.file_dir)
    fig_dir = os.path.join(project_path, cfg.eval.save_imgs)

    def drain(ls):
        # sync=False keeps the losses on the device so steps queue up;
        # convert at log boundaries only
        for j in range(len(ls)):
            if not isinstance(ls[j], float):
                ls[j] = float(ls[j])

    for i in range(args.steps):
        train_ls.append(trainer.train_step(unet_number=2, max_batch_size=cfg.train.batch_size,
                                           sync=False))
        trainer.update(unet_number=2)

        if i % args.eval_every == 0:
            drain(train_ls)
            _write_csv(os.path.join(log_dir, cfg.train.save_file), {"loss": train_ls})
            print(f"unet: 2, Step: {i}, loss: {train_ls[-1]}")
            valid_loss, preds, condi1, data, ssim, psnr = trainer.valid_step(
                unet_number=2, max_batch_size=cfg.eval.batch_size)
            valid_ls.append(float(np.mean(valid_loss)))
            ssim_val.append(ssim)
            psnr_val.append(psnr)
            rows = {"loss": valid_ls}
            if cfg.train.pred_obj == "x_start":
                rows.update(ssim=ssim_val, psnr=psnr_val)
            _write_csv(os.path.join(log_dir, cfg.eval.save_file), rows)

            if best > valid_ls[-1]:
                best = valid_ls[-1]
                print("Best model!")
                np.save(os.path.join(fig_dir, f"conditional_iqt_{i}_gt.npy"), data[0])
                np.save(os.path.join(fig_dir, f"conditional_iqt_{i}_lr.npy"), data[1])
                np.save(os.path.join(fig_dir, f"conditional_iqt_{i}_noisy.npy"), condi1)
                np.save(os.path.join(fig_dir, f"conditional_iqt_{i}_pred.npy"), preds)
                trainer.save(_bundle_path(project_path, cfg, cfg.train.save_model))

    drain(train_ls)
    _write_csv(os.path.join(log_dir, cfg.train.save_file), {"loss": train_ls})
    trainer.save(_bundle_path(project_path, cfg, cfg.train.save_last_model))
    print("Training done")


if __name__ == "__main__":
    main()
