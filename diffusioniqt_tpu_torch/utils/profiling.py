"""Tracing and profiling (counterpart of ``diffusioniqt_tpu/utils/profiling.py``).

  * :class:`PhaseTimer` - wall-clock per named phase, waiting for the
    device before it stops the clock
  * :func:`trace` - a ``torch.profiler`` trace of the block, written as a
    Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``
  * :func:`annotate` - a named region inside a trace
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._pytree import tree_leaves


def _synchronize(sync: Any) -> None:
    """Wait for the work that produces ``sync``: every card that holds one
    of its tensors (nested dicts, lists, tuples), or every card of this
    process for ``True``."""
    if sync is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for device in {t.device for t in tree_leaves(sync)
                   if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock per named phase, syncing the device."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None) -> Iterator[None]:
        """Time the block; with ``sync`` (tensors, or True for every card)
        the clock stops once the device has produced them."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1e3:.2f}ms avg x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block (host, and the card when there is one) and write
    ``trace.json``, a Chrome trace, into ``log_dir`` (default
    ``diffusioniqt_trace`` under the temporary directory). Yields the
    directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "diffusioniqt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        _synchronize(True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region, visible in :func:`trace`'s output."""
    return torch.profiler.record_function(name)
