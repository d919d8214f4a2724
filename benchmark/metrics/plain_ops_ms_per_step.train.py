"""``plain_ops_ms_per_step.train``: device milliseconds per optimizer step
in kernels that are not the port's own (the Block's backward recompute and
conv gradients, Adam, the EMA, the loss), in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_k = load_module(Path(__file__).with_name("_kernels.py"))


def read(trace):
    steps = trace.counts.get("steps", 0)
    if not steps:
        return None
    return 1e3 * trace.kernel_s(lambda n: not _k.own(n)) / steps
