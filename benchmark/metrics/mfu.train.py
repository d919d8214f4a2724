"""``mfu.train``: three times the forward FLOPs of every microbatch of the
traced optimizer steps (forward plus backward; counted from the
configuration's shapes, ``benchmark/work.py``) over the stretch's wall time
at the card's bf16 peak, in percent."""

from benchmark.harness import PEAK_BF16_FLOPS


def read(trace):
    micro = trace.counts.get("microbatches", 0)
    if not micro or trace.window_s <= 0:
        return None
    return 100.0 * 3 * micro * trace.work["forward_flops"] / (trace.window_s * PEAK_BF16_FLOPS)
