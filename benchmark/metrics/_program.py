"""The port's own spans and counters (``diffusioniqt_tpu_torch/utils/profiling.py``),
placed on a traced run's clock.

The port's recorder is global to the process and records while the
profiler runs, so after a traced stretch it holds that stretch's spans. An
anchor span of the program (``infer.volume``, ``trainer.step``) is paired,
in order, with the benchmark's own range around the same call
(``infer_volume``, ``train_step`` in ``trace.host_ranges``) by their ends,
which lie microseconds apart; the median of the pairs' offsets places every
span of the program on the trace's clock. Nothing to read (None) where the
program has no recorder, where the pairs do not match one to one, or where
their offsets spread by more than :data:`SPREAD_US`.
"""

from __future__ import annotations

from statistics import median

ANCHORS = {"infer.volume": "infer_volume", "trainer.step": "train_step"}
SPREAD_US = 1e3


class Program:
    """The recorder's spans and counters, with the anchors that placed them."""

    def __init__(self, spans, counters, anchors, offset_us: float):
        self.all, self.counters, self.anchors, self.offset_us = spans, counters, anchors, offset_us

    def interval(self, span) -> tuple:
        """``span``'s start and end in microseconds on the trace's clock."""
        return (span.start[1] / 1e3 + self.offset_us, span.end[1] / 1e3 + self.offset_us)

    def spans(self, *names) -> list:
        """The ended spans named one of ``names`` that started inside the
        anchors' stretch."""
        lo, hi = self.anchors[0].start[1], self.anchors[-1].end[1]
        return [s for s in self.all
                if s.name in names and s.end is not None and lo <= s.start[1] <= hi]


def read(trace, anchor: str):
    """The :class:`Program` placed by ``anchor``'s spans, or None."""
    try:
        from diffusioniqt_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans, counters = recorded()
    mine = sorted((s for s in spans if s.name == anchor and s.end is not None),
                  key=lambda s: s.end[1])
    theirs = sorted((r for r in trace.host_ranges if r[0] == ANCHORS[anchor]), key=lambda r: r[2])
    if not mine or len(mine) != len(theirs):
        return None
    offsets = [r[2] - s.end[1] / 1e3 for s, r in zip(mine, theirs)]
    if max(offsets) - min(offsets) > SPREAD_US:
        return None
    return Program(spans, counters, mine, median(offsets))


def device_ms(spans):
    """The spans' device milliseconds summed; None without a span or where
    one has no device reading."""
    values = [s.device_ms for s in spans]
    return None if not values or None in values else sum(values)


def host_ms(spans):
    """The spans' host milliseconds summed; None without a span."""
    return sum((s.end[1] - s.start[1]) / 1e6 for s in spans) if spans else None


def union(intervals) -> list:
    """Overlapping ``(start, end)`` intervals merged, in order."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def idle(trace) -> list:
    """The stretches of the trace's window in which no kernel ran."""
    edges = [trace.window[0], *[x for iv in trace.busy_intervals() for x in iv], trace.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def overlap_us(a, b) -> float:
    """Microseconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
