"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

  env      torch / CUDA versions, the card's name and power limit
  build    nvcc builds the three kernels from ``diffusioniqt_tpu_torch/csrc``
  kernels  each kernel against its plain PyTorch version at every shape the
           serve phase gives it (bf16, batch 8 windows x 27 sub-volumes),
           with kernel, plain, library and bound times
  forward  the full-width ``config/eval_config.yaml`` UNet3D (seeded random
           weights, bf16) on one 27 x 32^3 group, through the kernels and
           through the plain versions; launches per forward must be
           38 fused blocks, 39 halos, 1 conv3d
  serve    ``diffusioniqt_tpu_torch.infer.infer_volume`` on a seeded fake
           128^3 volume: 8 windows of 96^3, 20 sampler steps, full width;
           launch counters are zeroed just before and read just after

``python3 chip_smoke.py --profile`` also prints a ``torch.profiler``
breakdown of one forward at the serve batch, 8 x 27 x 32^3 (device time by
kernel, device busy share).

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
the serve run, max abs error against the plain version, times in ms at the
main path's heaviest shape for that kernel, the bound and what sets it); the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
of ``diffusioniqt_tpu``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
# |kernel - plain| <= BF16_TOL * max|plain|: both sides round fp32 sums to
# bf16 (half an ulp each, 2^-9 relative) after summing in different orders,
# and the fused kernel's bf16 activations may round one ulp apart where
# __expf and torch.exp differ in the last bit.
BF16_TOL = 2.0 ** -7
# whole forward, kernels vs plain versions: bf16 rounding differences
# compound through 39 convs, 19 GroupNorms and the SE gates
FORWARD_REL_TOL = 5e-2

SUB = 32                 # sub-volume edge on the main path
GROUP = 27               # one 96^3 window = 27 sub-volumes
WINDOWS = 8              # windows per sampler call in the serve phase
BATCH = GROUP * WINDOWS  # the kernels' batch on the serve path
HALO_SHAPES = [(32, 2), (32, 64), (32, 128), (16, 64), (16, 128), (16, 192), (8, 128)]
CONV_SHAPES = [(32, 2, 64)]
FUSED_SHAPES = [(32, 64, 64), (32, 128, 64), (16, 64, 64), (16, 192, 128),
                (16, 128, 128), (8, 128, 128)]
REPLACES = {
    "halo": "diffusioniqt_tpu/ops/pallas/halo.py:103",
    "conv3d": "diffusioniqt_tpu/ops/pallas/conv3d.py:83",
    "fused_block": "diffusioniqt_tpu/ops/pallas/fused_block.py:272",
}
HEADLINE = {"halo": (32, 64), "conv3d": (32, 2, 64), "fused_block": (32, 64, 64)}


def phase(name: str) -> float:
    print(f"=== {name}", flush=True)
    return time.perf_counter()


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, shape, got, want, tol_rel: float) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = tol_rel * scale
    ok = err <= tol
    print(f"  {name} {shape}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"(max|plain|={scale:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with plain version")
    return {"max_abs_err": err, "tol": tol}


def profile_forward(fn) -> None:
    """Device time of one ``fn()`` by kernel name, and the device's busy
    share of the wall time (kernels on one stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_ms = cuda_time_ms(fn, iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profile: {plain_ms:.3f} ms per call unprofiled, {wall_ms:.3f} ms profiled; "
          f"device busy {busy_ms:.3f} ms = {100 * busy_ms / plain_ms:.1f}% of the "
          f"unprofiled call")
    layers = {"fused_block": "igemm::conv_kernel<true", "conv3d": "igemm::conv_kernel<false",
              "halo": "halo_kernel"}
    for layer, tag in layers.items():
        ms = sum(r[1] for r in rows if tag in r[0])
        print(f"  layer {layer}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)")
    other = sum(r[1] for r in rows if not any(t in r[0] for t in layers.values()))
    print(f"  layer plain torch ops: {other:.3f} ms ({100 * other / busy_ms:.1f}% of busy)")
    for key, ms, count in rows[:25]:
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:4d}  {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from diffusioniqt_tpu_torch.config import load_config
    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
    from diffusioniqt_tpu_torch.infer import build_sampler, fake_volumes, infer_volume
    from diffusioniqt_tpu_torch.models.unet3d import iqt_unet_from_config
    from diffusioniqt_tpu_torch.ops import kernels
    from diffusioniqt_tpu_torch.ops.kernels import runtime
    from diffusioniqt_tpu_torch.ops.kernels.conv3d import conv3d_valid_plain
    from diffusioniqt_tpu_torch.ops.kernels.fused_block import (
        groupnorm_affine,
        neighbor_tables,
    )
    from diffusioniqt_tpu_torch.ops.volume import halo_exchange as halo_plain

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---------------------------------------------------------------- env
    phase("env")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # -------------------------------------------------------------- build
    t0 = phase("build")
    logs = runtime.build()
    for name, log in logs.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"  {name}: " + " | ".join(info[-6:]))
    for name in runtime.SOURCES:
        runtime.library(name)
    print(f"build seconds {time.perf_counter() - t0:.1f} "
          f"({len(logs)} compiled, dir {runtime._lib_path('halo').parent})", flush=True)

    # ------------------------------------------------------------ kernels
    t0 = phase("kernels")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, shape, stats, k_ms, p_ms, lib_ms, bnd):
        row = {"shape": list(shape), **stats, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        results.setdefault(name, []).append(row)
        print(f"    kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={bnd[0]:.4f} ({bnd[1]})", flush=True)

    for s, c in HALO_SHAPES:
        x = torch.randn((BATCH, s, s, s, c), generator=gen, device=dev).to(torch.bfloat16)
        got, want = kernels.halo_exchange(x, 3), halo_plain(x, 3)
        torch.cuda.synchronize()
        stats = compare("halo", (BATCH, s, s, s, c), got, want, 0.0)
        record("halo", (BATCH, s, c),
               stats, cuda_time_ms(lambda: kernels.halo_exchange(x, 3)),
               cuda_time_ms(lambda: halo_plain(x, 3)), None,
               bound_ms(0.0, nbytes(x, got)))

    for s, cin, cout in CONV_SHAPES:
        xh = torch.randn((BATCH, s + 2, s + 2, s + 2, cin), generator=gen,
                         device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * 0.1
        got, want = kernels.conv3d_valid(xh, w), conv3d_valid_plain(xh, w)
        torch.cuda.synchronize()
        stats = compare("conv3d", (BATCH, s, cin, cout), got, want, BF16_TOL)
        w_bf = w.to(torch.bfloat16)
        x_cf = xh.permute(0, 4, 1, 2, 3)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        record("conv3d", (BATCH, s, cin, cout), stats,
               cuda_time_ms(lambda: kernels.conv3d_valid(xh, w)),
               cuda_time_ms(lambda: conv3d_valid_plain(xh, w)),
               cuda_time_ms(lambda: torch.nn.functional.conv3d(x_cf, w_bf)),
               bound_ms(flops, nbytes(xh, w_bf, got)))

    for s, cin, cout in FUSED_SHAPES:
        x = torch.randn((BATCH, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
        ns = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev)
        nb = 0.1 * torch.randn(cin, generator=gen, device=dev)
        ss = tuple(0.2 * torch.randn((BATCH, 1, 1, 1, cin), generator=gen, device=dev)
                   for _ in range(2))
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
        a, b = groupnorm_affine(x, ns, nb, 8, scale_shift=ss)
        a_tab, b_tab = neighbor_tables(a, b, 3)
        xh = kernels.halo_exchange(x, 3)
        got = kernels.fused_conv(xh, a_tab, b_tab, w)
        want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
        torch.cuda.synchronize()
        stats = compare("fused_block", (BATCH, s, cin, cout), got, want, BF16_TOL)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        record("fused_block", (BATCH, s, cin, cout), stats,
               cuda_time_ms(lambda: kernels.fused_conv(xh, a_tab, b_tab, w)),
               cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
               None, bound_ms(flops, nbytes(xh, a_tab, b_tab, w.to(torch.bfloat16), got)))
    print(f"kernels seconds {time.perf_counter() - t0:.1f}", flush=True)

    # ------------------------------------------------------------ forward
    phase("forward")
    cfg = load_config(os.path.join(ROOT, "config", "eval_config.yaml"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = iqt_unet_from_config(cfg, device=dev).eval()
    x, lowres = (torch.randn((BATCH, SUB, SUB, SUB, 1), generator=gen, device=dev)
                 for _ in range(2))
    t = torch.full((BATCH,), 0.5, device=dev)
    log_snr = torch.full((BATCH,), -1.0, device=dev)
    if "--profile" in sys.argv[1:]:
        with torch.no_grad():
            profile_forward(lambda: model(x, t, log_snr, lowres_cond_img=lowres))
    # the held forward: one window's 27 sub-volumes
    x, lowres, t, log_snr = x[:GROUP], lowres[:GROUP], t[:GROUP], log_snr[:GROUP]
    with torch.no_grad():
        kernels.reset_launch_counts()
        out_k = model(x, t, log_snr, lowres_cond_img=lowres)
        torch.cuda.synchronize()
        per_forward = kernels.launch_counts()
        print(f"launches per forward {per_forward}")
        if per_forward != {"halo": 39, "conv3d": 1, "fused_block": 38}:
            raise AssertionError(f"launches per forward {per_forward}, "
                                 "expected halo 39, conv3d 1, fused_block 38")
        fwd_ms = cuda_time_ms(lambda: model(x, t, log_snr, lowres_cond_img=lowres),
                              iters=5, warmup=1)
        model.use_ops(kernels.PLAIN)
        out_p = model(x, t, log_snr, lowres_cond_img=lowres)
        plain_fwd_ms = cuda_time_ms(lambda: model(x, t, log_snr, lowres_cond_img=lowres),
                                    iters=2, warmup=0)
        model.use_ops(kernels.KERNELS)
    rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    print(f"forward out {tuple(out_k.shape)} {out_k.dtype} finite "
          f"{bool(torch.isfinite(out_k).all())} max_rel_err_vs_plain {rel:.3e} "
          f"(tol {FORWARD_REL_TOL})")
    print(f"ms per forward (27x32^3, bf16): kernels {fwd_ms:.3f} plain {plain_fwd_ms:.3f}",
          flush=True)
    if not (torch.isfinite(out_k).all() and rel <= FORWARD_REL_TOL):
        raise AssertionError("forward through the kernels disagrees with the plain path")
    del model, out_k, out_p

    # -------------------------------------------------------------- serve
    phase("serve")
    edge, steps, windows_per_batch = 128, cfg.train.timesteps, WINDOWS
    imagen = build_sampler(cfg, device=dev, seed=0)
    lowres_vol, _ = fake_volumes(cfg, edge, seed=0)
    noise = gaussian_noise(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_serve = time.perf_counter()
    pred = infer_volume(cfg, imagen, lowres_vol, noise=noise,
                        patch_batch=windows_per_batch, verbose=False)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    served = kernels.launch_counts()
    n_windows = ((edge - cfg.train.patch_size) // cfg.eval.overlap + 1) ** 3
    n_calls = -(-n_windows // windows_per_batch)
    print(f"windows {n_windows} steps {steps} width dim={cfg.train.dim} "
          f"mults={cfg.train.dim_mults} nothing cut")
    print(f"serve seconds {serve_s:.3f} ms per denoise step "
          f"{serve_s * 1e3 / (steps * n_calls):.3f} ({n_calls} sampler call(s) of "
          f"{min(n_windows, windows_per_batch)} windows)")
    print(f"output {pred.shape} finite {bool(np.isfinite(pred).all())} "
          f"launches {served}", flush=True)
    want_counts = {"halo": 39 * steps * n_calls, "conv3d": steps * n_calls,
                   "fused_block": 38 * steps * n_calls}
    if pred.shape != (edge,) * 3 or not np.isfinite(pred).all():
        raise AssertionError("serve output is not a finite volume of the input's shape")
    if served != want_counts:
        raise AssertionError(f"serve launches {served}, expected {want_counts}")

    # ------------------------------------------------------------- report
    line = []
    for name in ("halo", "conv3d", "fused_block"):
        rows = results[name]
        head = next(r for r in rows if tuple(r["shape"][1:]) == HEADLINE[name])
        line.append({
            "name": name, "route": "cuda",
            "source": f"diffusioniqt_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": served[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": head["tol"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "x".join(str(v) for v in head["shape"]),
        })
    print(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
