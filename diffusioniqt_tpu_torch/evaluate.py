"""Test-set evaluation on the card: the port's counterpart of the root
``test_all.py`` (reference test_all.py:43-326). Every test subject is
enhanced by full-volume inference (``infer.py``), its background masked,
and scored by MS-SSIM and PSNR on a centre crop, and with ``--lpips`` by
slice-wise LPIPS (``metrics/lpips.py::lpips_volume_metric``); the run ends
with the mean ± std of each and the average sampling time.

    python -m diffusioniqt_tpu_torch.evaluate --config config/eval_edm.yaml --fake-data
    python -m diffusioniqt_tpu_torch.evaluate --config config/eval_edm.yaml --fake-data --lpips

``--lpips-weights`` names a torch VGG16 / LPIPS state dict. Without one the
LPIPS is the fixed-seed random-feature proxy, reported under the label
``LPIPS(random-features)`` after a warning, as ``test_all.py`` does: it is
not comparable with published LPIPS values.

Subjects come from ``Data.lowres_path_test`` (ground truth beside each, as
the reference names it), or ``--fake-data --fake-volumes N`` synthetic
pairs. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from diffusioniqt_tpu_torch.data.datasets import load_volume, save_volume
from diffusioniqt_tpu_torch.infer import (
    add_serving_args,
    fake_subjects,
    infer_volume,
    serve_from_args,
)
from diffusioniqt_tpu_torch.metrics.image import MSSIM, PSNR
from diffusioniqt_tpu_torch.metrics.lpips import (
    LPIPS,
    lpips_from_torch_checkpoint,
    lpips_volume_metric,
)
from diffusioniqt_tpu_torch.utils.misc import resolve_device


def evaluate(pred: np.ndarray, gt: np.ndarray, border: int = 32, device="cuda") -> dict:
    """Centre-cropped MS-SSIM (on jointly min-max-normalised volumes) and
    PSNR (reference ``eval()``, test_all.py:47-85), computed on ``device``
    (raises if CUDA is asked for and missing)."""
    device = resolve_device(device)
    b = border
    p = torch.as_tensor(pred[b:-b, b:-b, b:-b], dtype=torch.float32, device=device)
    g = torch.as_tensor(gt[b:-b, b:-b, b:-b], dtype=torch.float32, device=device)
    p5, g5 = p[None, ..., None], g[None, ..., None]
    msssim = MSSIM((p5 - p5.min()) / (p5.max() - p5.min()),
                   (g5 - g5.min()) / (g5.max() - g5.min()))
    return {"msssim": float(msssim), "psnr": float(PSNR(p5, g5))}


def load_subjects(cfg, args):
    """[(name, lowres, highres)] raw volumes, 256-edge volumes cropped to
    240 (reference test.py:151-153); with ``--fake-data`` the subjects of
    ``test_all.py --fake-data``, all from one stream of ``--seed``."""
    if args.fake_data:
        edge = args.fake_edge or cfg.train.patch_size + cfg.eval.overlap
        return [(f"fake{i}", lowres, highres) for i, (lowres, highres)
                in enumerate(fake_subjects(cfg, edge, args.fake_volumes, seed=args.seed))]
    subjects = []
    for lrf in sorted(glob.glob(cfg.data.lowres_path_test)):
        lr = load_volume(lrf)
        hr = load_volume(lrf.replace("lr_norm", cfg.data.groundtruth_fname))
        if lr.shape[-1] == 256:
            lr, hr = lr[8:248, 8:248, 8:248], hr[8:248, 8:248, 8:248]
        subjects.append((os.path.basename(os.path.dirname(lrf)), lr, hr))
    return subjects


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serving_args(ap)
    ap.add_argument("--output-dir", default="./inference_out")
    ap.add_argument("--fake-volumes", type=int, default=1)
    ap.add_argument("--lpips", action="store_true",
                    help="report slice-wise LPIPS (reference test_all.py:43)")
    ap.add_argument("--lpips-weights", default=None,
                    help="torch VGG16/LPIPS checkpoint for trained features")
    args = ap.parse_args(argv)

    cfg, imagen, noise, kwargs = serve_from_args(args)
    device = next(imagen.unets[-1].parameters()).device
    lpips_model = None
    if args.lpips:
        if args.lpips_weights:
            lpips_model = lpips_from_torch_checkpoint(args.lpips_weights)
            lpips_label = "LPIPS"
        else:
            print("WARNING: no --lpips-weights given; reporting LPIPS(random-features), "
                  "a proxy not comparable to trained-VGG LPIPS values")
            lpips_model = LPIPS()
            lpips_label = "LPIPS(random-features)"
        lpips_model = lpips_model.to(device)
    subjects = load_subjects(cfg, args)
    if not subjects:
        raise FileNotFoundError(f"no test subjects match {cfg.data.lowres_path_test}")
    mean, std = cfg.data.mean, cfg.data.std
    os.makedirs(args.output_dir, exist_ok=True)

    msssims, psnrs, lpipss, times = [], [], [], []
    border = min(32, (subjects[0][1].shape[0] - 1) // 3)
    for name, lowres, highres in subjects:
        start = time.time()
        pred = infer_volume(cfg, imagen, lowres, noise=noise, verbose=False, **kwargs)
        elapsed = time.time() - start
        times.append(elapsed)

        lowres_n = (lowres - mean) / std
        highres_n = (highres - mean) / std
        # background masking (reference test_all.py:300)
        min_val = lowres_n.min()
        pred[lowres_n == min_val] = min_val

        m = evaluate(pred, highres_n, border=border, device=device)
        msssims.append(m["msssim"])
        psnrs.append(m["psnr"])
        lpips_msg = ""
        if lpips_model is not None:
            b = border
            lp = lpips_volume_metric(highres_n[b:-b, b:-b, b:-b], pred[b:-b, b:-b, b:-b],
                                     lpips_model)
            lpipss.append(lp)
            lpips_msg = f" lpips={lp:.4f}"
        print(f"{name}: msssim={m['msssim']:.4f} psnr={m['psnr']:.3f} "
              f"time={elapsed:.1f}s{lpips_msg}")
        np.save(os.path.join(args.output_dir, f"{name}_inf.npy"), pred)
        save_volume(os.path.join(args.output_dir, f"{name}_inf.nii.gz"), pred)

    print(f"MS-SSIM: {np.mean(msssims):.4f} +/- {np.std(msssims):.4f}")
    print(f"PSNR:    {np.mean(psnrs):.3f} +/- {np.std(psnrs):.3f}")
    if lpipss:
        print(f"{lpips_label}:   {np.mean(lpipss):.4f} +/- {np.std(lpipss):.4f}")
    print(f"Avg sampling time: {np.mean(times):.2f}s")
    return {"msssim": msssims, "psnr": psnrs, "lpips": lpipss, "border": border}


if __name__ == "__main__":
    main()
