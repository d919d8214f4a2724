"""``plain_ops_ms_per_nfe.serve``: device milliseconds per denoiser forward
in kernels that are not the port's own (ATen, cuDNN, cuBLAS: GroupNorm
statistics, tables, squeeze-excite, 1x1 convs, the stem, the sampler's
arithmetic), in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_k = load_module(Path(__file__).with_name("_kernels.py"))


def read(trace):
    forwards = trace.counts.get("forwards", 0)
    if not forwards:
        return None
    return 1e3 * trace.kernel_s(lambda n: not _k.own(n)) / forwards
