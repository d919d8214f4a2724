"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
directory and the port (``diffusioniqt_tpu_torch``). The workload's
configuration, traffic mix, driver and per-layer readers are files found by
the names in ``BENCHMARK.json`` (``benchmark/harness.py``). With ``--trace
0`` the run measures the cell's end-to-end metrics over a window of
``--seconds``; with ``--trace 1`` it profiles a bounded stretch and reports
the cell's per-layer metrics. Either way it then frees the program and
checks what the timed path produced against the plain reference
(``benchmark/reference``), each number beside its limit
(``benchmark/limits/<workload>.json``); a limit whose number the run did
not produce makes it not correct.

The last line of standard output is the result as one JSON object. Without
a CUDA device (or with fewer than the cell asks for) the run exits 2 and
prints no result; if a module of JAX, flax, optax or the JAX package was
loaded, it exits 3 and prints no result. Kernel builds go to ``build/``
inside the checkout.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    sys.path.insert(0, str(root))
    from benchmark import harness

    started = harness.process_start()
    import time

    import torch

    print(f"set-up: interpreter and imports {time.time() - started:.3f} s", file=sys.stderr)
    wl = harness.load_workload(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl.entry["chips"]:
        print(f"no run: {args.workload} needs {wl.entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from diffusioniqt_tpu_torch.ops.kernels import runtime
    runtime.build()
    print(f"set-up: kernels built or found by {time.time() - started:.3f} s", file=sys.stderr)
    return execute(wl, args.seed, args.seconds, bool(args.trace), "cuda", started)


def execute(wl, seed: int, seconds: float, trace: bool, device: str, started: float) -> int:
    """Run the cell's driver, read its metrics, check its output, print."""
    import torch
    from benchmark import harness

    driver = harness.load_module(wl.driver_path())
    out = driver.run(wl, seed, seconds, trace, device)
    limits = harness.load_json(wl.root / "benchmark" / "limits" / f"{wl.name}.json")
    # every limit needs its reading: one the run did not produce fails it
    checks = {k: (out["readings"].get(k), lim) for k, lim in limits.items()}
    correct = all(v is not None and v <= lim for v, lim in checks.values())

    metrics, breakdown = {}, None
    dev = (harness.device_record(torch, wl.entry["chips"], out["peak"]) if device == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    if trace:
        tr = out["trace"]
        for m in wl.per_layer():
            value = harness.load_module(wl.metric_path(m["name"])).read(tr)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        print(f"trace: {len(tr.kernels)} kernels in {tr.window_s:.3f} s; counts "
              f"{tr.counts}", file=sys.stderr)
        breakdown = tr.breakdown()
    else:
        reported = {m["name"] for m in wl.end_to_end()}
        metrics = {k: v for k, v in out["metrics"].items() if k in reported}
        metrics["setup_s"] = (out["setup_end"] - started, "s")

    found = harness.forbidden_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    facts = harness.card_facts() if device == "cuda" else {"nvidia_smi": "no card"}
    for name, (value, limit) in checks.items():
        print(f"check {name}: {'missing' if value is None else repr(value)} (limit {limit!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(f"card: {facts['nvidia_smi']}; peaks: bf16 {harness.PEAK_BF16_FLOPS:.4g} FLOP/s, "
          f"HBM {harness.PEAK_HBM_BYTES:.4g} B/s")
    print(harness.result_line(correct, out["attempted"], out["failed"], metrics, dev, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
