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

Runs on ``cuda`` unless ``--device cpu`` is given. ``--mesh N`` spreads
each batch of windows over N ranks (``test.py --mesh N``), one spawned
process and one card each (gloo processes with ``--device cpu``), or the
ranks of a ``torchrun --nproc-per-node N`` world: the batch is padded by
whole windows to split evenly, each rank samples its windows with its rows
of the one-process noise, and rank 0 gathers them in order, stitches and
writes. On the CPU the result equals the one-process result (within 1e-5
of its largest entry, ``tests/test_torch_parallel.py``); on the card each
rank's rows are bit for bit those of one process sampling them alone, but
the volume moves with the batch size each sampler call runs at (3.2e-2
and 3.4e-2 of its largest entry at 2 and 4 ranks on H100s, as far as one
process moves at that batch size: ``chip_smoke.py`` ddp-serve). More ranks
than cards raise.
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
from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
from diffusioniqt_tpu_torch.parallel.multihost import is_main_process, process_count, run_ranks
from diffusioniqt_tpu_torch.parallel.sharding import data_rank, sharded_sample
from diffusioniqt_tpu_torch.utils import profiling
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
    random from ``seed``. Raises if CUDA is asked for and missing.

    The weights are loaded into the wrapper's own unet 2, after the
    wrapper has cast it, so a cast can never drop them."""
    device = resolve_device(device)
    from_config = elucidated_imagen_from_config if cfg.train.elucidated else imagen_from_config
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        imagen = from_config(cfg, (NullUnet(), iqt_unet_from_config(cfg, device=device)))
    unet = imagen.unets[1]
    if checkpoint:
        unet.load_state_dict(load_unet_state_dict(checkpoint, use_ema=use_ema))
    unet.eval()
    return imagen


def describe_sampler(imagen: Sampler) -> str:
    """One line naming the sampler and its steps."""
    if isinstance(imagen, ElucidatedImagen):
        return (f"ElucidatedImagen (EDM) loaded: {imagen.hparams[-1].num_sample_steps} "
                f"Heun steps")
    return f"Imagen loaded: {imagen.noise_schedulers[-1].timesteps} ancestral steps"


def infer_volume(cfg, imagen: Sampler, lowres_raw: np.ndarray, *,
                 noise: NoiseFn, stitch_mode: str = "trim",
                 patch_batch: int = 8, verbose: bool = True,
                 mesh=None) -> Optional[np.ndarray]:
    """Sliding-window sampling + stitching over one raw LR volume, on the
    model's device. Returns the prediction in normalised (z-score) space,
    shaped like ``lowres_raw``.

    With ``mesh`` (a ``data`` mesh over the ranks, every rank calling with
    the same volume, weights and seeded noise) each batch of windows is
    spread over the ranks (``parallel/sharding.py::sharded_sample``: the
    last, short batch is padded by whole windows) and gathered in order;
    rank 0 stitches and returns the volume, the other ranks None."""
    with profiling.span("infer.volume"):
        device = next(imagen.unets[-1].parameters()).device
        main = data_rank(mesh) == 0
        with profiling.span("infer.prepare"):
            dataset = SupervisedIQTInference(cfg, lr_file=None, volume=lowres_raw)
            starts = dataset.valid_indices()
            patch = cfg.train.patch_size
            volume = torch.from_numpy(dataset.normalize(lowres_raw.astype(np.float32))).to(device)
            stitcher = DeviceVolumeStitcher(lowres_raw.shape, patch, cfg.eval.overlap,
                                            mode=stitch_mode, fill_value=cfg.data.min_bound,
                                            device=device) if main else None
        f = cfg.train.batch_sample_factor
        split = cfg.train.batch_sample and patch != cfg.train.patch_size_sub
        for start in range(0, len(starts), patch_batch):
            chunk = starts[start:start + patch_batch]
            x = gather_windows(volume, chunk, patch)
            if split:
                x = volume_to_subvolumes(x, f)
            kwargs = dict(batch_size=x.shape[0], noise=noise, start_image_or_video=x,
                          start_at_unet_number=2)
            out = sharded_sample(imagen.sample, mesh, group=f ** 3 if split else 1, **kwargs)
            if not main:
                continue
            if split:
                out = subvolumes_to_volume(out, f)
            stitcher.add_batch(out[..., 0], chunk)
            if verbose:
                print(f"patches {start + len(chunk)}/{len(starts)}")
        return stitcher.result() if main else None


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
    ap.add_argument("--mesh", type=int, default=0,
                    help="spread each batch of windows over N ranks (one card each)")


def serve_from_args(args, device=None):
    """(cfg, sampler, noise, infer kwargs) from parsed :func:`add_serving_args`,
    on ``device`` (default ``--device``); with more than one rank in the
    process group, a ``data`` mesh over them in the kwargs. Only the main
    process prints."""
    cfg = load_config(args.config)
    imagen = build_sampler(cfg, device=device or args.device, checkpoint=args.checkpoint,
                           seed=args.seed, use_ema=not args.use_non_ema)
    mesh = create_mesh(("data",)) if process_count() > 1 else None
    if is_main_process():
        print(describe_sampler(imagen)
              + (f", windows spread over {process_count()} ranks" if mesh else ""))
        if not args.checkpoint:
            print("WARNING: no checkpoint given — sampling with random weights")
    device = next(imagen.unets[-1].parameters()).device
    noise = gaussian_noise(torch.Generator(device=device).manual_seed(args.seed))
    kwargs = dict(stitch_mode=args.stitch, patch_batch=args.patch_batch, mesh=mesh)
    return cfg, imagen, noise, kwargs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serving_args(ap)
    ap.add_argument("--lowres", default=None, help="LR NIfTI/.npy path")
    ap.add_argument("--highres", default=None, help="HR NIfTI/.npy path")
    ap.add_argument("--output-dir", default=".")
    args = ap.parse_args(argv)
    if not args.fake_data and not (args.lowres and args.highres):
        ap.error("--lowres and --highres are required without --fake-data")
    run_ranks(_infer_rank, (args,), nprocs=args.mesh, device=args.device)


def _infer_rank(device, args):
    """One rank of ``main`` (the only one without ``--mesh``)."""
    cfg, imagen, noise, kwargs = serve_from_args(args, device)
    main = is_main_process()
    if args.fake_data:
        edge = args.fake_edge or cfg.train.patch_size + cfg.eval.overlap
        lowres, highres = fake_volumes(cfg, edge, args.seed)
        affine = np.eye(4)
    else:
        lowres = load_volume(args.lowres)
        highres = load_volume(args.highres)
        affine = load_affine(args.highres)
        if lowres.shape[-1] == 256:
            low, high = 8, 248  # reference test.py:151-153
            lowres = lowres[low:high, low:high, low:high]
            highres = highres[low:high, low:high, low:high]
    if main:
        print(f"lowres: {lowres.shape} highres: {highres.shape}")

    start = time.time()
    pred = infer_volume(cfg, imagen, lowres, noise=noise, verbose=main, **kwargs)
    if not main:
        return
    print(f"TIME: {time.time() - start}")

    mean, std = cfg.data.mean, cfg.data.std
    os.makedirs(args.output_dir, exist_ok=True)
    for name, vol in (("volume_inf", pred), ("volume_gt", (highres - mean) / std),
                      ("volume_lr", (lowres - mean) / std)):
        np.save(os.path.join(args.output_dir, f"{name}.npy"), vol)
        save_volume(os.path.join(args.output_dir, f"{name}.nii.gz"), vol, affine)


if __name__ == "__main__":
    main()
