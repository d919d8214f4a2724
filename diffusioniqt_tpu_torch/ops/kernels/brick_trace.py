"""Where the brick route's time goes, plan by plan (needs a CUDA card).

    python -m diffusioniqt_tpu_torch.ops.kernels.brick_trace [--out FILE] [--shape B,s,Cin,Cout ...]

Builds ``csrc/fused_block.cu`` with ``-DBRICK_TRACE`` into
``build/torch_kernels/trace/``, which compiles in ``igemm.cuh``'s phase
stamps (each CTA writes the card's ``%globaltimer`` at its start, when its
first brick has landed, when its consumers start multiplying, when its last
products finish and when its epilogue ends), its ablations (:data:`ABLATIONS`)
and ``desc_check``, a one-warpgroup kernel that reads a tap's A tile from a
swizzled brick through a ``wgmma`` matrix descriptor beside the ``ldmatrix``
gathers (run first; its result is printed and written). For each shape of
:data:`SHAPES` (seeded inputs) and each candidate plan (:func:`candidates`:
the unit widths, chunk widths, commit groups and ranges of chunks the route
has), it checks the output against ``fused_conv_plain`` at ``2^-7`` of its
largest entry and prints the device ms (median of 5 timings of 10 launches,
the device asleep while the host enqueues; min and max beside it), the same
under each ablation, the CTAs' median phase times, the tail (the last CTA's
end after the median CTA's), the main loop's share of the SM's bf16 tensor
rate, and cuDNN's conv alone on the transformed input. ``--out`` writes the
rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time

import torch

from diffusioniqt_tpu_torch.ops.kernels import fused_block as fm
from diffusioniqt_tpu_torch.ops.kernels import halo_exchange, runtime
from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight

_PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
_SLEEP_CYCLES_PER_MS = 1.98e6  # torch.cuda._sleep at the H100 SXM's boost clock
# (B, s, Cin, Cout): the main path's deeper levels and the column shards of
# tensor parallelism at the serve batch, the headline, and SRUnet256's
# Blocks at one window at 8^3 and 16^3 and at Cin 32 and 128 (chip_smoke.py's
# FUSED_SHAPES and TP_FUSED_SHAPES)
SHAPES = [(216, 8, 128, 128), (216, 16, 128, 128), (216, 16, 192, 128), (216, 8, 256, 256),
          (216, 32, 64, 32), (216, 32, 128, 32), (216, 32, 64, 16), (216, 16, 64, 32),
          (216, 8, 128, 64), (216, 8, 256, 128), (216, 16, 128, 64), (216, 32, 64, 64),
          (27, 16, 128, 128), (27, 16, 256, 128), (27, 8, 512, 256), (27, 32, 32, 128),
          (27, 32, 32, 32), (27, 32, 128, 128), (27, 8, 256, 256)]
# ablation bits (igemm.cuh), each timing the kernel without that work (wrong
# sums): 1 (the A gathers), 2 (the Mish), 8 (the weight stream), 16 (the
# epilogue)
ABLATIONS = {"no_gather": 1, "no_mish": 2, "neither": 3, "no_weights": 8, "no_epilogue": 16}


def candidates(nb: int, s: int, cin: int, cout: int, sms: int):
    """The plans tried at one shape, each a plan the build runs: each unit
    width the shape can take (32 up to Cout 64, 64, and 128 from Cout 128)
    with whole units of 64-channel chunks, in half-tap commit groups where
    the brick is plain-loaded (Cin % 8 != 0) and in the base unit (BN 64),
    and in whole-tap ones where the brick comes by TMA (at BN 128: A from
    shared memory); there also 32-channel chunks (whole taps, whole units)
    at every width; and the shape's own plan (:func:`brick_plan`) with
    ranges of chunks, where it commits whole taps, has more than one chunk
    and takes more than one round of whole units."""
    widths = [bn for bn in (32, 64, 128) if (bn > 32 or cout <= 64) and (bn < 128 or cout >= 128)]
    tma = cin % 8 == 0
    plans = [fm.make_brick_plan(nb, s, cin, cout, sms, bn, tap) for bn in widths
             for tap in (False, True) if (tap and tma) or (not tap and (bn == 64 or not tma))]
    if tma:
        plans += [fm.make_brick_plan(nb, s, cin, cout, sms, bn, kc=32) for bn in widths]
    own = fm.brick_plan(nb, s, cin, cout, sms)
    if own.tap and own.chunks > 1 and own.units > sms:
        plans += [fm.make_brick_plan(nb, s, cin, cout, sms, own.bn, own.tap, split=True,
                                     kc=own.kc)]
    return list(dict.fromkeys(plans))


def build() -> ctypes.CDLL:
    out = runtime.BUILD_ROOT / "trace"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libfused_block_trace.so"
    done = subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-DBRICK_TRACE",
                           "-I", str(runtime.CSRC), "-o", str(so),
                           str(runtime.CSRC / "fused_block.cu")],
                          capture_output=True, text=True)
    # ptxas's report of each instantiation: any spill, with its function
    fn = ""
    for line in done.stderr.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
            print("ptxas:", fn, line.strip(), flush=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stderr[-8000:]}")
    lib = ctypes.CDLL(str(so))
    lib.set_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_block_launch.argtypes = fm._ARGTYPES
    lib.fused_block_launch.restype = ctypes.c_int
    lib.desc_check_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def desc_check(lib, dev, gen) -> dict:
    """``fused_block.cu``'s ``desc_check`` at every tap: one x-plane's A tile
    (8 x 8 voxels x 64 channels) of a random brick times a random 64 x 64
    slice, with A gathered by ``ldmatrix`` and read by a matrix descriptor
    (8-row groups 1280 bytes apart, base offset 0). Returns the largest
    differences from the fp32 product over all taps (the accumulators
    mapped as the kernel's epilogue maps them) and the taps each way gets
    right."""
    rows, hy, hz = 600, fm.BRICK[1] + 2, fm.BRICK[2] + 2
    xb = torch.randn((rows, 64), generator=gen, device=dev).to(torch.bfloat16)
    wk = (0.1 * torch.randn((64, 64), generator=gen, device=dev)).to(torch.bfloat16)
    t = torch.arange(128, device=dev)[:, None]
    j = torch.arange(32, device=dev)[None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * ((j // 2) % 2)
    col = (j // 4) * 8 + 2 * (t % 4) + j % 2
    yz = torch.arange(64, device=dev)
    worst, right = [0.0, 0.0], [0, 0]
    for tap in range(27):
        toff = ((tap // 9) * hy + (tap // 3) % 3) * hz + tap % 3
        ref = xb[toff + (yz // 8) * hz + yz % 8].float() @ wk.float()
        out = torch.zeros((2, 128, 32), device=dev)
        runtime.check_launch("desc_check", lib.desc_check_launch(
            xb.data_ptr(), wk.data_ptr(), out.data_ptr(), tap))
        torch.cuda.synchronize()
        for way in range(2):
            err = (out[way] - ref[row, col]).abs().max().item()
            worst[way] = max(worst[way], err)
            right[way] += err <= 1e-3 * ref.abs().max().item()
    names = ("ldmatrix", "descriptor")
    return {f"{n}_max_abs_err": e for n, e in zip(names, worst)} | {
        f"{n}_taps_right": r for n, r in zip(names, right)}


def device_ms(fn, iters: int = 10, repeats: int = 5):
    """(median, min, max) device ms per ``fn()`` over ``repeats`` timings of
    ``iters`` calls, each after the device has slept for longer than the
    host takes to enqueue them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2.0 * iters * host_ms + 0.5, 200.0) * _SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return runs[len(runs) // 2], runs[0], runs[-1]


def trace_shape(lib, shape, dev, gen, sms) -> list:
    nb, s, cin, cout = shape
    x = torch.randn((nb, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
    ss = tuple(0.2 * torch.randn((nb, 1, 1, 1, cin), generator=gen, device=dev)
               for _ in range(2))
    a, b = fm.groupnorm_affine(x, 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev),
                               0.1 * torch.randn(cin, generator=gen, device=dev), 8,
                               scale_shift=ss)
    a_tab, b_tab = fm.neighbor_tables(a, b, 3)
    xh = halo_exchange(x, 3)
    want = fm.fused_conv_plain(xh, a_tab, b_tab, w)
    packed = PackedWeight().get(w)
    reg = fm._region_index(s + 2, dev)
    act = fm.mish_one_exp(a_tab[:, reg] * xh.float() + b_tab[:, reg])
    act_cf = act.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    w_bf = w.to(torch.bfloat16)
    del act
    cudnn = device_ms(lambda: torch.nn.functional.conv3d(act_cf, w_bf))
    flop = 2.0 * nb * s ** 3 * 27 * cin * cout
    rows = []
    for plan in candidates(nb, s, cin, cout, sms):
        out = torch.empty_like(want)
        ws = fm.split_workspace(plan, dev)
        stamps = torch.zeros((plan.ctas, 8), dtype=torch.int64, device=dev)

        def mode(traced=False, ablate=0):
            # a copy to the symbols: never inside a timed loop
            torch.cuda.synchronize()
            runtime.check_launch("set_trace", lib.set_trace(
                stamps.data_ptr() if traced else None, ablate))

        def launch():
            err = lib.fused_block_launch(
                runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
                a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws is not None else None, nb, s, cin, cout, plan.bn, plan.kc,
                int(plan.tap), int(plan.split), plan.ctas, runtime.stream_handle(dev))
            runtime.check_launch("fused_block_trace", err)

        mode()
        launch()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        ok = err <= 2.0 ** -7 * want.float().abs().max().item()
        row = {"shape": list(shape), "bn": plan.bn, "kc": plan.kc, "tap": plan.tap,
               "split": plan.split,
               "ctas": plan.ctas,
               "units": plan.units, "max_abs_err": err, "ok": ok,
               "ms": device_ms(launch), "cudnn_conv_only_ms": cudnn,
               "bound_ms": flop / _PEAK_BF16_FLOPS * 1e3}
        for key, bits in ABLATIONS.items():
            mode(ablate=bits)
            row[f"{key}_ms"] = device_ms(launch)
        mode(traced=True)
        launch()
        torch.cuda.synchronize()
        mode()
        us = (stamps[:, :5].double() - stamps[:, 0].min().double()).cpu() / 1e3
        med = lambda v: float(v.median())  # noqa: E731
        loop_us = us[:, 3] - us[:, 2]
        chunks_per_cta = torch.tensor([sum(c1 - c0 for _, c0, c1 in plan.pieces(c))
                                       for c in range(plan.ctas)], dtype=torch.float64)
        chunk_flop = 2.0 * 256 * plan.bn * 27 * plan.kc
        row.update({
            "first_brick_loaded_us": med(us[:, 1] - us[:, 0]),
            "first_products_us": med(us[:, 2] - us[:, 0]),
            "main_loop_us": med(loop_us),
            "median_end_us": med(us[:, 4]),
            "tail_us": float(us[:, 4].max()) - med(us[:, 4]),
            "chunks_per_cta": [int(chunks_per_cta.min()), int(chunks_per_cta.max())],
            "tensor_rate_share": med(chunks_per_cta * chunk_flop / (loop_us * 1e-6))
            / (_PEAK_BF16_FLOPS / sms),
        })
        rows.append(row)
        del out, stamps, ws
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the rows as JSON here")
    parser.add_argument("--shape", action="append", default=None, metavar="B,s,Cin,Cout",
                        help="trace this shape only (repeatable; default: SHAPES)")
    args = parser.parse_args(argv)
    shapes = ([tuple(int(v) for v in sh.split(",")) for sh in args.shape] if args.shape
              else SHAPES)
    if not torch.cuda.is_available():
        raise SystemExit("brick_trace needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    check = desc_check(lib, dev, gen)
    print({"desc_check": check}, flush=True)
    rows = []
    for shape in shapes:
        for row in trace_shape(lib, shape, dev, gen, sms):
            rows.append(row)
            print({k: (round(v, 4) if isinstance(v, float)
                       else [round(e, 4) for e in v] if isinstance(v, tuple) else v)
                   for k, v in row.items()}, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "desc_check": check, "rows": rows}, f, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
