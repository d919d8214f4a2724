"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

  env           torch / CUDA versions, the card's name and power limit
  build         nvcc builds the four kernels from ``diffusioniqt_tpu_torch/csrc``,
                one process per source, all started together
  kernels       each kernel against its plain PyTorch version at every shape
                the serve phases give it (bf16, batch 8 windows x 27
                sub-volumes; attention over 8 windows x 8 heads), with
                kernel, plain, library and bound times; kernel and library
                times are the median of 5 timings (min and max beside
                them), the plain version's one timing; the conv kernels
                are timed with a packed-weight cache filled before the
                timed loop, as the model calls them, and conv3d at both of
                its routes (small Cin on the path, the implicit GEMM at one
                wide shape); each fused shape also times cuDNN's conv alone
                on the already transformed input (conv_only_library_ms)
  forward       the full-width ``config/eval_config.yaml`` UNet3D (seeded
                random weights, bf16) on one 27 x 32^3 group, through the
                kernels and through the plain versions; launches per forward
                must be 38 fused blocks, 39 halos, 1 conv3d
  forward-attn  the same for ``diffusioniqt_tpu_torch/configs/eval_attn_softmax.yaml``
                (softmax attention in the three encoder slots and the
                middle, plus the mid ResnetBlock): 40 fused blocks, 41
                halos, 1 conv3d, 4 flash attentions
  forward-vit   that config with ``att_type: vit``: the same counts
  serve         ``diffusioniqt_tpu_torch.infer.infer_volume`` on a seeded fake
                128^3 volume: 8 windows of 96^3, 20 sampler steps, full width;
                launch counters are zeroed just before and read just after
  serve-attn    the same with the attention config

``python3 chip_smoke.py --profile`` also prints a ``torch.profiler``
breakdown of one forward of each of the two configs at the serve batch,
8 x 27 x 32^3 (device time by kernel, device busy share).
``python3 chip_smoke.py --kernels-only`` stops after the kernels phase and
prints no result line: a copy of this script placed in another checkout of
the repository times that checkout's kernels the same way.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
the serve run of its path, max abs error against the plain version, times
in ms at the main path's heaviest shape for that kernel, the bound and what
sets it); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of ``diffusioniqt_tpu``. Exits non-zero without CUDA.
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
# flash attention: the kernel rounds the unnormalised probabilities to bf16
# before P V and the plain version the normalised ones (2^-9 relative per
# term, averaging out over the 1728 terms of a row), and each side rounds
# its output to bf16 once. The outputs may then differ by one bf16 ulp,
# which at any magnitude m <= max|plain| is at most 2^-7 * max|plain|.
FLASH_TOL = 2.0 ** -7

SUB = 32                 # sub-volume edge on the main path
GROUP = 27               # one 96^3 window = 27 sub-volumes
WINDOWS = 8              # windows per sampler call in the serve phase
BATCH = GROUP * WINDOWS  # the kernels' batch on the serve path
HALO_SHAPES = [(32, 2), (32, 64), (32, 128), (16, 64), (16, 128), (16, 192), (8, 128),
               (8, 256)]
# (s, Cin, Cout): the init conv (small-Cin route) and one wide shape that
# holds the implicit-GEMM route, which no conv3d call of the path takes
CONV_SHAPES = [(32, 2, 64), (16, 64, 64)]
FUSED_SHAPES = [(32, 64, 64), (32, 128, 64), (16, 64, 64), (16, 192, 128),
                (16, 128, 128), (8, 128, 128), (8, 256, 256)]
# every attention slot of the attention config: 8 windows x 8 heads, 12^3
# patch tokens, head dim 64
FLASH_SHAPES = [(WINDOWS * 8, 1728, 64)]
REPLACES = {
    "halo": "diffusioniqt_tpu/ops/pallas/halo.py:103",
    "conv3d": "diffusioniqt_tpu/ops/pallas/conv3d.py:83",
    "fused_block": "diffusioniqt_tpu/ops/pallas/fused_block.py:272",
    "flash_attention": "diffusioniqt_tpu/ops/pallas/flash_attention.py:90",
}
HEADLINE = {"halo": (32, 64), "conv3d": (32, 2, 64), "fused_block": (32, 64, 64),
            "flash_attention": (1728, 64)}
FLAGSHIP_CONFIG = os.path.join("config", "eval_config.yaml")
ATTN_CONFIG = os.path.join("diffusioniqt_tpu_torch", "configs", "eval_attn_softmax.yaml")
# launches per forward of one 27-sub-volume group
FLAGSHIP_COUNTS = {"halo": 39, "conv3d": 1, "fused_block": 38, "flash_attention": 0}
ATTN_COUNTS = {"halo": 41, "conv3d": 1, "fused_block": 40, "flash_attention": 4}
# device-kernel names of each hand-written kernel, for the profile's layers
LAYERS = {"fused_block": ("igemm::conv_sm90<true",),
          "conv3d": ("small_cin_kernel", "igemm::conv_sm90<false"),
          "halo": ("halo_row_kernel",), "flash_attention": ("flash_kernel",)}
# the one PyTorch call timed beside each kernel as its library yardstick
LIBRARY = {"halo": "index_select gather from a precomputed source table",
           "conv3d": "F.conv3d (cuDNN)",
           "fused_block": "none: no single PyTorch call computes GroupNorm-affine + "
                          "Mish + halo'd conv (conv_only_library_ms: F.conv3d, cuDNN, on "
                          "the transformed input materialised beforehand)",
           "flash_attention": "F.scaled_dot_product_attention"}


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


def timed(fn, repeats: int = 5, **kw):
    """(median, min, max) of ``repeats`` timings of :func:`cuda_time_ms`."""
    runs = sorted(cuda_time_ms(fn, **kw) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def fmt(t) -> str:
    return "null" if t is None else f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]"


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


def slots_ms(fn, modules) -> float:
    """Device time inside ``modules`` during one ``fn()``: CUDA events that
    forward hooks record around each call (one stream, and the modules do
    not nest, so each pair of events brackets one module's kernels)."""
    events = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    hooks = [h for m in modules for h in (m.register_forward_pre_hook(mark),
                                          m.register_forward_hook(mark))]
    fn()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return sum(a.elapsed_time(b) for a, b in zip(events[::2], events[1::2]))


def profile_forward(label: str, fn) -> None:
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
    print(f"profile {label}: {plain_ms:.3f} ms per call unprofiled, {wall_ms:.3f} ms "
          f"profiled; device busy {busy_ms:.3f} ms = {100 * busy_ms / plain_ms:.1f}% of "
          f"the unprofiled call")
    for layer, tags in LAYERS.items():
        ms = sum(r[1] for r in rows if any(t in r[0] for t in tags))
        print(f"  layer {layer}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)")
    other = sum(r[1] for r in rows
                if not any(t in r[0] for tags in LAYERS.values() for t in tags))
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
    from diffusioniqt_tpu_torch.ops.kernels import fused_block as fused_module
    from diffusioniqt_tpu_torch.ops.kernels import runtime
    from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight, conv3d_valid_plain
    from diffusioniqt_tpu_torch.ops.kernels.fused_block import (
        groupnorm_affine,
        neighbor_tables,
    )
    from diffusioniqt_tpu_torch.ops.volume import halo_exchange as halo_plain

    def conv_route(cin):
        """conv3d's route at ``cin`` input channels (a checkout that predates
        the small-Cin route has the implicit GEMM only)."""
        from diffusioniqt_tpu_torch.ops.kernels import conv3d as conv_module
        return conv_module.route(cin) if hasattr(conv_module, "route") else "igemm"

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
                if any(k in ln.lower() for k in ("registers", "spill", "error", "warning"))]
        print(f"  {name}: " + " | ".join(info[-12:]))
    for name in runtime.SOURCES:
        runtime.library(name)
    print(f"build seconds {time.perf_counter() - t0:.1f} "
          f"({len(logs)} compiled, dir {runtime._lib_path('halo').parent})", flush=True)

    # ------------------------------------------------------------ kernels
    t0 = phase("kernels")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, shape, stats, k_ms, p_ms, lib_ms, bnd, **extra):
        """``k_ms`` and ``lib_ms`` are :func:`timed` triples (``lib_ms``
        may be None), ``p_ms`` one timing; ``extra`` more timed triples."""
        row = {"shape": list(shape), **stats, "ms": k_ms[0], "ms_min": k_ms[1],
               "ms_max": k_ms[2], "plain_ms": p_ms,
               "library_ms": None if lib_ms is None else lib_ms[0],
               "library_ms_min": None if lib_ms is None else lib_ms[1],
               "library_ms_max": None if lib_ms is None else lib_ms[2],
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        for key, val in extra.items():
            row.update({key: val[0], f"{key}_min": val[1], f"{key}_max": val[2]})
        results.setdefault(name, []).append(row)
        more = "".join(f" {k}={fmt(v)}" for k, v in extra.items())
        print(f"    kernel_ms={fmt(k_ms)} plain_ms={p_ms:.4f} library_ms={fmt(lib_ms)}"
              f"{more} bound_ms={bnd[0]:.4f} ({bnd[1]})", flush=True)

    checked_gather = False
    for s, c in HALO_SHAPES:
        x = torch.randn((BATCH, s, s, s, c), generator=gen, device=dev).to(torch.bfloat16)
        got, want = kernels.halo_exchange(x, 3), halo_plain(x, 3)
        torch.cuda.synchronize()
        stats = compare("halo", (BATCH, s, s, s, c), got, want, 0.0)
        # the library yardstick: one gather. Built outside the timed loop: a
        # table of source voxels (the plain halo of the voxel ids; 0 is a
        # zero-padded voxel) and the source with one zero row appended
        ids = torch.arange(1, BATCH * s ** 3 + 1, device=dev).view(BATCH, s, s, s, 1)
        src_ids = halo_plain(ids, 3).flatten()
        idx = torch.where(src_ids == 0, BATCH * s ** 3, src_ids - 1)
        src = torch.cat([x.reshape(-1, c), x.new_zeros((1, c))])
        gather = lambda: torch.index_select(src, 0, idx)  # noqa: E731
        if not checked_gather:  # the gather is the kernel's function, exactly
            if not torch.equal(gather().view_as(got), got):
                raise AssertionError("halo: the gather yardstick disagrees with the kernel")
            print(f"  halo gather == kernel at {(BATCH, s, s, s, c)}: exact")
            checked_gather = True
        record("halo", (BATCH, s, c),
               stats, timed(lambda: kernels.halo_exchange(x, 3)),
               cuda_time_ms(lambda: halo_plain(x, 3)), timed(gather),
               bound_ms(0.0, nbytes(x, got)))
        del ids, src_ids, idx, src

    for s, cin, cout in CONV_SHAPES:
        xh = torch.randn((BATCH, s + 2, s + 2, s + 2, cin), generator=gen,
                         device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (27 * cin) ** -0.5
        cache = PackedWeight()  # filled by the first call, as in the model
        got, want = kernels.conv3d_valid(xh, w, cache), conv3d_valid_plain(xh, w)
        torch.cuda.synchronize()
        stats = compare("conv3d", (BATCH, s, cin, cout), got, want, BF16_TOL)
        w_bf = w.to(torch.bfloat16)
        x_cf = xh.permute(0, 4, 1, 2, 3)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        record("conv3d", (BATCH, s, cin, cout), stats,
               timed(lambda: kernels.conv3d_valid(xh, w, cache)),
               cuda_time_ms(lambda: conv3d_valid_plain(xh, w)),
               timed(lambda: torch.nn.functional.conv3d(x_cf, w_bf)),
               bound_ms(flops, nbytes(xh, w_bf, got)))
        results["conv3d"][-1]["kernel_route"] = conv_route(cin)
        del xh, got, want, x_cf

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
        cache = PackedWeight()
        got = kernels.fused_conv(xh, a_tab, b_tab, w, cache)
        want = kernels.fused_conv_plain(xh, a_tab, b_tab, w)
        torch.cuda.synchronize()
        stats = compare("fused_block", (BATCH, s, cin, cout), got, want, BF16_TOL)
        flops = 2.0 * BATCH * s ** 3 * 27 * cin * cout
        # the GEMM's floor: cuDNN's conv alone on mish(A_r * xh + B_r),
        # materialised in bf16 outside the timed loop
        reg = fused_module._region_index(s + 2, dev)
        act = fused_module.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
        act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w_bf = w.to(torch.bfloat16)
        del act
        record("fused_block", (BATCH, s, cin, cout), stats,
               timed(lambda: kernels.fused_conv(xh, a_tab, b_tab, w, cache)),
               cuda_time_ms(lambda: kernels.fused_conv_plain(xh, a_tab, b_tab, w), iters=3),
               None, bound_ms(flops, nbytes(xh, a_tab, b_tab, w_bf, got)),
               conv_only_library_ms=timed(lambda: torch.nn.functional.conv3d(act_cf, w_bf)))
        del act_cf, xh, got, want

    for bh, n, d in FLASH_SHAPES:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = d ** -0.5
        got = kernels.flash_attention(q, k, v, scale)
        want = kernels.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        stats = compare("flash_attention", (bh, n, d), got, want, FLASH_TOL)
        # the library yardstick: one SDPA call over (windows, heads, N, D)
        q4, k4, v4 = (a.view(WINDOWS, bh // WINDOWS, n, d) for a in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        record("flash_attention", (bh, n, d), stats,
               timed(lambda: kernels.flash_attention(q, k, v, scale)),
               cuda_time_ms(lambda: kernels.attention_plain(q, k, v, scale), iters=3),
               timed(lambda: sdpa(q4, k4, v4, scale=scale)),
               bound_ms(4.0 * bh * n * n * d, nbytes(q, k, v, got)))
    print(f"kernels seconds {time.perf_counter() - t0:.1f}", flush=True)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernel_rows": results}))
        return 0

    def held_forward(label, cfg, want_counts, profile):
        """One 27 x 32^3 window through the kernels and through the plain
        versions: exact launch counts, agreement within FORWARD_REL_TOL."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = iqt_unet_from_config(cfg, device=dev).eval()
        x, lowres = (torch.randn((BATCH, SUB, SUB, SUB, 1), generator=gen, device=dev)
                     for _ in range(2))
        t = torch.full((BATCH,), 0.5, device=dev)
        log_snr = torch.full((BATCH,), -1.0, device=dev)
        if profile and "--profile" in sys.argv[1:]:
            with torch.no_grad():
                call = lambda: model(x, t, log_snr, lowres_cond_img=lowres)  # noqa: E731
                profile_forward(label, call)
                slots = [d[2] for d in model.downs if not isinstance(d[2], torch.nn.Identity)]
                slots += [model.mid_attn] if model.mid_attn is not None else []
                if slots:
                    print(f"  attention slots (CUDA events): {slots_ms(call, slots):.3f} ms "
                          f"of one forward, {len(slots)} slots", flush=True)
        # the held forward: one window's 27 sub-volumes
        x, lowres, t, log_snr = x[:GROUP], lowres[:GROUP], t[:GROUP], log_snr[:GROUP]
        with torch.no_grad():
            kernels.reset_launch_counts()
            out_k = model(x, t, log_snr, lowres_cond_img=lowres)
            torch.cuda.synchronize()
            per_forward = kernels.launch_counts()
            print(f"launches per forward {per_forward}")
            if per_forward != want_counts:
                raise AssertionError(f"launches per forward {per_forward}, "
                                     f"expected {want_counts}")
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
            raise AssertionError(f"{label}: forward through the kernels disagrees with "
                                 "the plain path")

    def serve(cfg, per_forward):
        """infer_volume on the seeded fake 128^3 volume; the launches must be
        ``per_forward`` times the forwards the sampler ran."""
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
        want_counts = {k: n * steps * n_calls for k, n in per_forward.items()}
        if pred.shape != (edge,) * 3 or not np.isfinite(pred).all():
            raise AssertionError("serve output is not a finite volume of the input's shape")
        if served != want_counts:
            raise AssertionError(f"serve launches {served}, expected {want_counts}")
        return served

    cfg = load_config(os.path.join(ROOT, FLAGSHIP_CONFIG))
    cfg_attn = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit = load_config(os.path.join(ROOT, ATTN_CONFIG))
    cfg_vit.train.att_type = "vit"

    phase("forward")
    held_forward("flagship", cfg, FLAGSHIP_COUNTS, profile=True)
    phase("forward-attn")
    held_forward("attention", cfg_attn, ATTN_COUNTS, profile=True)
    phase("forward-vit")
    held_forward("vit", cfg_vit, ATTN_COUNTS, profile=False)
    phase("serve")
    served = serve(cfg, FLAGSHIP_COUNTS)
    phase("serve-attn")
    served_attn = serve(cfg_attn, ATTN_COUNTS)

    # ------------------------------------------------------------- report
    line = []
    for name in ("halo", "conv3d", "fused_block", "flash_attention"):
        rows = results[name]
        head = next(r for r in rows if tuple(r["shape"][1:]) == HEADLINE[name])
        extra = {k: head[k] for k in ("kernel_route", "conv_only_library_ms",
                                      "conv_only_library_ms_min", "conv_only_library_ms_max")
                 if k in head}
        line.append({
            "name": name, "route": "cuda",
            "source": f"diffusioniqt_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            # the serve run of the kernel's own path: the flagship for the
            # conv kernels, the attention config for flash attention
            "launches": (served_attn if name == "flash_attention" else served)[name],
            "launches_by_path": {"serve": served[name], "serve-attn": served_attn[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": head["tol"],
            "ms": head["ms"], "ms_min": head["ms_min"], "ms_max": head["ms_max"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_ms_min": head["library_ms_min"],
            "library_ms_max": head["library_ms_max"], "library": LIBRARY[name],
            "shape": "x".join(str(v) for v in head["shape"]), **extra,
        })
    print(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
