"""Full-volume inference on the card: the port's counterpart of the root
``test.py`` (reference test.py:141-256).

A low-field volume is covered by ``patch_size`` windows at stride
``Eval.overlap``; windows with at least 5% non-zero voxels are split into
``f^3`` sub-volumes, sampled over the SR U-Net (cascade stage 2 over a
``NullUnet``), merged back and stitched (trim or Gaussian). The sampler is
the one the config names: the 64-step EDM Heun sampler when
``Train.elucidated`` is set (``config/eval_edm.yaml``), else the 20-step
ancestral sampler. One batch of ``patch_batch`` windows is in flight at a
time; the last batch is not padded (eager PyTorch needs no fixed shape).

The normalised volume is copied to the model's device once, the windows are
sliced out there and stitched into device buffers (``ops/stitch_device.py``),
and the result comes back in one copy. A trainer bundle (``--checkpoint``,
as ``python -m diffusioniqt_tpu_torch.train`` writes it) serves its EMA
weights unless ``--use-non-ema`` is given, as ``test.py`` samples.

    python -m diffusioniqt_tpu_torch.infer --config config/eval_config.yaml --fake-data
    python -m diffusioniqt_tpu_torch.infer --config config/eval_edm.yaml --fake-data

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.data.datasets import (
    SupervisedIQTInference,
    load_affine,
    load_volume,
    save_volume,
)
from diffusioniqt_tpu_torch.diffusion.elucidated import (
    ElucidatedImagen,
    elucidated_imagen_from_config,
)
from diffusioniqt_tpu_torch.diffusion.gaussian import (
    Imagen,
    NoiseFn,
    gaussian_noise,
    imagen_from_config,
)
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, iqt_unet_from_config
from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher, gather_windows
from diffusioniqt_tpu_torch.ops.volume import subvolumes_to_volume, volume_to_subvolumes
from diffusioniqt_tpu_torch.utils.misc import resolve_device

Sampler = Union[Imagen, ElucidatedImagen]


def load_unet_state_dict(path: str, use_ema: bool = True) -> dict:
    """SR U-Net weights from a ``.pt`` file: a port or reference ``Unet``
    state dict, a model-only ``{"state_dict": ...}`` dict, or a trainer
    bundle. Of a bundle, the EMA weights by default (its ``ema`` entry,
    ``1.ema_model.*`` for unet 2, or a bare EMA wrapper's ``ema_model.*``),
    as the JAX entry points sample (test.py:63,116); with ``use_ema=False``
    the online weights (``model``, an Imagen state dict whose keys are
    ``unets.1.*``). A bundle asked for EMA weights that holds none raises,
    as ``utils/torch_convert.py::convert_reference_checkpoint`` does."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        if not use_ema:
            obj = obj["model"]
        else:
            ema = obj.get("ema")
            if ema is None:
                raise KeyError(f"{path}: asked for the EMA weights but the bundle has no "
                               "'ema' entry (serve the online ones with --use-non-ema)")
            for prefix in ("1.ema_model.", "ema_model."):
                picked = {k[len(prefix):]: v for k, v in ema.items() if k.startswith(prefix)}
                if picked:
                    return picked
            raise KeyError(f"{path}: no '1.ema_model.*' or 'ema_model.*' keys in the "
                           "bundle's 'ema' entry; refusing to serve the online weights")
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if any(k.startswith("unets.") for k in obj):
        obj = {k[len("unets.1."):]: v for k, v in obj.items()
               if k.startswith("unets.1.")}
    return obj


def build_sampler(cfg, device="cuda", checkpoint: Optional[str] = None,
                  seed: int = 0, use_ema: bool = True) -> Sampler:
    """The IQT cascade sampler with the SR U-Net on ``device``: the EDM
    ``ElucidatedImagen`` when ``Train.elucidated`` is set, else the
    Gaussian ``Imagen`` (as test.py:45-54 chooses). Weights from
    ``checkpoint`` (a bundle's EMA weights unless ``use_ema=False``), else
    random from ``seed``. Raises if CUDA is asked for and missing."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        unet = iqt_unet_from_config(cfg, device=device)
    if checkpoint:
        unet.load_state_dict(load_unet_state_dict(checkpoint, use_ema=use_ema))
    unet.eval()
    if cfg.train.elucidated:
        return elucidated_imagen_from_config(cfg, (NullUnet(), unet))
    return imagen_from_config(cfg, (NullUnet(), unet))


def describe_sampler(imagen: Sampler) -> str:
    """One line naming the sampler and its steps."""
    if isinstance(imagen, ElucidatedImagen):
        return (f"ElucidatedImagen (EDM) loaded: {imagen.hparams[-1].num_sample_steps} "
                f"Heun steps")
    return f"Imagen loaded: {imagen.noise_schedulers[-1].timesteps} ancestral steps"


def infer_volume(cfg, imagen: Sampler, lowres_raw: np.ndarray, *,
                 noise: NoiseFn, stitch_mode: str = "trim",
                 patch_batch: int = 8, verbose: bool = True) -> np.ndarray:
    """Sliding-window sampling + stitching over one raw LR volume, on the
    model's device. Returns the prediction in normalised (z-score) space,
    shaped like ``lowres_raw``."""
    device = next(imagen.unets[-1].parameters()).device
    dataset = SupervisedIQTInference(cfg, lr_file=None, volume=lowres_raw)
    starts = dataset.valid_indices()
    patch = cfg.train.patch_size
    volume = torch.from_numpy(dataset.normalize(lowres_raw.astype(np.float32))).to(device)
    stitcher = DeviceVolumeStitcher(lowres_raw.shape, patch, cfg.eval.overlap,
                                    mode=stitch_mode, fill_value=cfg.data.min_bound,
                                    device=device)
    f = cfg.train.batch_sample_factor
    split = cfg.train.batch_sample and patch != cfg.train.patch_size_sub
    for start in range(0, len(starts), patch_batch):
        chunk = starts[start:start + patch_batch]
        x = gather_windows(volume, chunk, patch)
        if split:
            x = volume_to_subvolumes(x, f)
        out = imagen.sample(batch_size=x.shape[0], noise=noise,
                            start_image_or_video=x, start_at_unet_number=2)
        if split:
            out = subvolumes_to_volume(out, f)
        stitcher.add_batch(out[..., 0], chunk)
        if verbose:
            print(f"patches {start + len(chunk)}/{len(starts)}")
    return stitcher.result()


def fake_subjects(cfg, edge: int, count: int, seed: int = 0):
    """``count`` synthetic (lowres, highres) raw-intensity pairs drawn in
    turn from one ``default_rng(seed)`` stream, as ``test_all.py
    --fake-data`` draws its subjects (test_all.py:90-97, seed 0)."""
    rng = np.random.default_rng(seed)
    std = cfg.data.std
    pairs = []
    for _ in range(count):
        highres = np.abs(rng.standard_normal((edge,) * 3)).astype(np.float32) * std
        lowres = highres + rng.standard_normal(highres.shape).astype(np.float32) * 0.1 * std
        pairs.append((lowres, highres))
    return pairs


def fake_volumes(cfg, edge: int, seed: int = 0):
    """A synthetic (lowres, highres) raw-intensity pair, as ``test.py
    --fake-data`` makes it."""
    return fake_subjects(cfg, edge, 1, seed)[0]


def add_serving_args(ap: argparse.ArgumentParser) -> None:
    """The options ``infer`` and ``evaluate`` share."""
    ap.add_argument("--config", default="./config/eval_config.yaml")
    ap.add_argument("--checkpoint", default=None,
                    help="SR U-Net weights (.pt state dict or trainer bundle)")
    ap.add_argument("--use-non-ema", action="store_true",
                    help="of a trainer bundle, serve the online weights, not the EMA ones")
    ap.add_argument("--stitch", choices=["trim", "gaussian"], default="trim")
    ap.add_argument("--patch-batch", type=int, default=8,
                    help="windows denoised together per sampler call")
    ap.add_argument("--fake-data", action="store_true")
    ap.add_argument("--fake-edge", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)


def serve_from_args(args):
    """(cfg, sampler, noise, infer kwargs) from parsed :func:`add_serving_args`."""
    cfg = load_config(args.config)
    imagen = build_sampler(cfg, device=args.device, checkpoint=args.checkpoint,
                           seed=args.seed, use_ema=not args.use_non_ema)
    print(describe_sampler(imagen))
    if not args.checkpoint:
        print("WARNING: no checkpoint given — sampling with random weights")
    device = next(imagen.unets[-1].parameters()).device
    noise = gaussian_noise(torch.Generator(device=device).manual_seed(args.seed))
    kwargs = dict(stitch_mode=args.stitch, patch_batch=args.patch_batch)
    return cfg, imagen, noise, kwargs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serving_args(ap)
    ap.add_argument("--lowres", default=None, help="LR NIfTI/.npy path")
    ap.add_argument("--highres", default=None, help="HR NIfTI/.npy path")
    ap.add_argument("--output-dir", default=".")
    args = ap.parse_args(argv)

    cfg, imagen, noise, kwargs = serve_from_args(args)
    if args.fake_data:
        edge = args.fake_edge or cfg.train.patch_size + cfg.eval.overlap
        lowres, highres = fake_volumes(cfg, edge, args.seed)
        affine = np.eye(4)
    else:
        if not (args.lowres and args.highres):
            ap.error("--lowres and --highres are required without --fake-data")
        lowres = load_volume(args.lowres)
        highres = load_volume(args.highres)
        affine = load_affine(args.highres)
        if lowres.shape[-1] == 256:
            low, high = 8, 248  # reference test.py:151-153
            lowres = lowres[low:high, low:high, low:high]
            highres = highres[low:high, low:high, low:high]
    print(f"lowres: {lowres.shape} highres: {highres.shape}")

    start = time.time()
    pred = infer_volume(cfg, imagen, lowres, noise=noise, **kwargs)
    print(f"TIME: {time.time() - start}")

    mean, std = cfg.data.mean, cfg.data.std
    os.makedirs(args.output_dir, exist_ok=True)
    for name, vol in (("volume_inf", pred), ("volume_gt", (highres - mean) / std),
                      ("volume_lr", (lowres - mean) / std)):
        np.save(os.path.join(args.output_dir, f"{name}.npy"), vol)
        save_volume(os.path.join(args.output_dir, f"{name}.nii.gz"), vol, affine)


if __name__ == "__main__":
    main()
