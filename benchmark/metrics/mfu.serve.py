"""``mfu.serve``: the denoiser forwards' conv and matmul FLOPs in the traced
stretch (counted from the configuration's shapes, ``benchmark/work.py``)
over the stretch's wall time at the card's bf16 peak, in percent."""

from benchmark.harness import PEAK_BF16_FLOPS


def read(trace):
    forwards = trace.counts.get("forwards", 0)
    if not forwards or trace.window_s <= 0:
        return None
    return 100.0 * forwards * trace.work["forward_flops"] / (trace.window_s * PEAK_BF16_FLOPS)
