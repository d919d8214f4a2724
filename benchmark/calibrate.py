"""Readings for the limits of ``correct``: the program's, over many seeds,
and the control's (the reference with the operands of every product in
float8, in the program's place), with a training cell's planted faults in
the reference put in the program's place (each microbatch's loss over half
of its rows; the backward of two of the four microbatches).

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 --control-seeds 1 2 3

One process: each seed builds the cell anew, runs the traffic's recorded
calls or first steps (no measured window), frees the program and reads the
gaps as a run does, with a training cell's numbers that the check does not
compare beside them (``*_look``). One JSON line per seed on standard
output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    import torch
    from benchmark import harness
    from benchmark.reference.unet import Ctx, fp8_round_st

    wl = harness.load_workload(root, args.workload)
    if args.device == "cuda":
        from diffusioniqt_tpu_torch.ops.kernels import runtime
        runtime.build()
    driver = harness.load_module(wl.driver_path())
    for seed in args.seeds:
        t0 = time.time()
        control = seed in args.control_seeds
        line = {"workload": wl.name, "seed": seed}
        if wl.traffic["driver"] == "serve_volumes":
            cell = driver.Serve(wl, seed, args.device)
            cell.call = 0
            for _ in range(wl.traffic["params"]["recorded_calls"]):
                cell.serve_one()
                cell.call += 1
            cell.free_program()
            harness.exact_fp32(torch)
            line["program"] = cell.readings()
            if control:
                line["control"] = cell.readings(Ctx(q=fp8_round_st))
        else:
            cell = driver.Train(wl, seed, args.device)
            cell.warm()
            cell.free_program()
            harness.exact_fp32(torch)
            line["program"] = cell.readings()
            line["program_look"] = cell.looks()
            if control:
                for key, kwargs in (("control", {"ctx": Ctx(q=fp8_round_st)}),
                                    ("fault_half_rows", {"fault": "half_rows"}),
                                    ("fault_two_microbatches", {"fault": "two_microbatches"})):
                    alt = cell.reference_steps(**kwargs)
                    line[key] = cell.readings(alt)
                    line[key + "_look"] = cell.looks(alt)
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del cell
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
