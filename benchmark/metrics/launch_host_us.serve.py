"""``launch_host_us.serve``: host microseconds per launch of the port's own
kernels, from a kernel wrapper's entry to its return after the ctypes
launch (argument checks, the packed weight, the plan, the TMA descriptors
``cuTensorMapEncodeTiled`` encodes, the launch): the program's counters
``kernels.launch_host_ns.<kernel>`` over ``kernels.launches_timed.<kernel>``,
every kernel together, in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "infer.volume")
    if prog is None:
        return None
    total = lambda prefix: sum(v for k, v in prog.counters.items() if k.startswith(prefix))
    launches = total("kernels.launches_timed.")
    return total("kernels.launch_host_ns.") / launches / 1e3 if launches else None
