"""``outside_sampler_ms.serve``: host milliseconds per served volume spent
in ``infer_volume`` outside the sampler's ``sample`` (window gather,
z-score, split, merge, stitch, the copy back), from the benchmark's own
synchronised spans in the traced stretch."""


def read(trace):
    whole, sample = trace.spans.get("infer_volume", []), trace.spans.get("sample", [])
    if not whole or len(whole) != len(sample):
        return None
    return 1e3 * sum(w - s for w, s in zip(whole, sample)) / len(whole)
