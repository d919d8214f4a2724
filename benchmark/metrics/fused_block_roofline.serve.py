"""``fused_block_roofline.serve``: the fused Block launches' least time
(per launch the larger of its FLOPs at the bf16 peak and its bytes at the
HBM peak, from the Block shapes of the configuration, ``benchmark/work.py``)
over their device time in the traced stretch, in percent. Nothing to read
when no fused Block kernel ran."""

from pathlib import Path

from benchmark.harness import load_module

_k = load_module(Path(__file__).with_name("_kernels.py"))


def read(trace):
    spent = trace.kernel_s(_k.fused_block)
    forwards = trace.counts.get("forwards", 0)
    if spent <= 0 or not forwards:
        return None
    return 100.0 * forwards * trace.work["block_least_s"] / spent
