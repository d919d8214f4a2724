"""What every cell of the benchmark shares: finding a workload's files by
name, seeds, weights made on the device, the profiler's summary, the check
for JAX, and the result line.

A workload of ``BENCHMARK.json`` names a configuration (its entry's
``file``, a JSON under ``benchmark/configs/``) and a traffic mix
(``benchmark/traffic/<traffic>.json``). The traffic file names its driver,
``benchmark/drivers/<driver>.py``, and holds the driver's parameters. Each
per-layer metric is read by ``benchmark/metrics/<metric name>.py``. Nothing
here lists a cell, a configuration or a metric: a new one is new files and
new entries.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

PEAK_BF16_FLOPS = 989e12   # NVIDIA H100 SXM data sheet, dense bf16
PEAK_HBM_BYTES = 3.35e12   # NVIDIA H100 SXM data sheet, HBM3
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusioniqt_tpu")


def seed_for(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of a run, from ``--seed`` and tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def process_start() -> float:
    """The epoch second at which this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def worst(values) -> float:
    """The largest of ``values``, a NaN counting as infinite (``max`` would
    pass over it where it does not come first)."""
    return max(math.inf if v != v else v for v in values)


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """The Python file at ``path`` as a module (its name from the path)."""
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Workload:
    """One cell of the manifest, its files read."""

    root: Path
    manifest: dict
    entry: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.entry["name"]

    def driver_path(self) -> Path:
        return self.root / "benchmark" / "drivers" / f"{self.traffic['driver']}.py"

    def per_layer(self) -> List[dict]:
        """The per-layer metrics whose ``workloads`` name this cell."""
        return [m for m in self.manifest["per_layer"] if self.name in m["workloads"]]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def metric_path(self, name: str) -> Path:
        return self.root / "benchmark" / "metrics" / f"{name}.py"


def load_workload(root: Path, name: str) -> Workload:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    entry = entries[0]
    configs = [c for c in manifest["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"no configuration {entry['config']!r}")
    config = load_json(root / configs[0]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    return Workload(root, manifest, entry, config, traffic)


# -- the program under test ---------------------------------------------------

def program_config(config: dict, mode: str):
    """The port's ``Config`` for ``mode`` (``serve`` or ``train``) from the
    configuration file (the repository's YAML schema)."""
    from diffusioniqt_tpu_torch.config import Config
    return Config.from_dict(config["modes"][mode]["program_config"])


def arch(config: dict, mode: str) -> dict:
    """The reference's architecture for ``mode``: the widths, and what the
    mode changes (the boundary halo, the sub-volume split)."""
    return {**config["arch"], **config["modes"][mode].get("arch", {})}


def exact_fp32(torch) -> None:
    """fp32 products without TF32, for the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_unet(config: dict, cfg, device):
    """The port's denoiser for ``config``, built without drawing weights
    (on the meta device), then given storage on ``device``."""
    import torch
    from diffusioniqt_tpu_torch.models import unet3d

    spec = config["program"]
    with torch.device("meta"):
        if spec["builder"] == "iqt_unet_from_config":
            unet = unet3d.iqt_unet_from_config(cfg, device="meta")
        else:
            kwargs = dict(spec.get("kwargs", {}))
            if "dtype" in kwargs:
                kwargs["dtype"] = getattr(torch, kwargs["dtype"])
            unet = getattr(unet3d, spec["builder"])(**kwargs)
    return unet.to_empty(device=device)


def init_rule(name: str, shape) -> tuple:
    """(scale, offset) of a weight drawn as ``offset + scale * N(0, 1)``:
    norm scales near 1, biases small, the time frequencies and the ViT
    positions unit normal, every other kernel at variance 1 / fan_in."""
    if name.endswith("positions") or name.endswith("to_time_hiddens.0.weights"):
        return 1.0, 0.0
    if name.endswith(".bias"):
        return 0.05, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    return math.sqrt(shape[0] / math.prod(shape)), 0.0


def make_weights(shapes: Dict[str, tuple], seed: int, device):
    """Every weight of ``shapes`` from one draw of a generator on
    ``device`` seeded from ``seed``, fp32, as views of one buffer."""
    import torch

    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    weights = {}
    for name, view in zip(names, flat.split(sizes)):
        scale, offset = init_rule(name, shapes[name])
        weights[name] = view.mul_(scale).add_(offset).view(shapes[name])
    return weights


# -- device ---------------------------------------------------------------------

def card_facts() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def device_record(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or the
    JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


# -- the trace -----------------------------------------------------------------

@dataclass
class Trace:
    """What a traced stretch leaves for the per-layer readers: device
    kernels ``(name, start_us, end_us)``, the stretch's window in the same
    clock, the benchmark's own spans (seconds, by name), counts (forwards,
    steps, launches) and the work arithmetic of the cell."""

    kernels: List[tuple]
    window: tuple
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, Any] = field(default_factory=dict)
    host_ranges: List[tuple] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[tuple]:
        """The union of the kernels' intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels if e > lo and s < hi)
        merged: List[list] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def breakdown(self) -> dict:
        """The ten kernels with the most device time, and the ten longest
        idle gaps named by the benchmark's host span they fell in."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        edges = [self.window[0], *[x for iv in busy for x in iv], self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            inside = [(r[2] - r[1], r[0]) for r in self.host_ranges if r[1] <= mid <= r[2]]
            named.append([min(inside)[1] if inside else "outside any span", (e - s) / 1e6])
        named.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named[:10]}


def host_now() -> tuple:
    """This instant on the two clocks a profiler's trace may be stamped in
    (wall and monotonic, ns), for :func:`trace_from_profiler`."""
    return time.time_ns(), time.monotonic_ns()


def trace_from_profiler(prof, spans) -> Trace:
    """Kernels of a ``torch.profiler`` run over the card's activity; the
    window runs from the first kernel's start to the last one's end. The
    benchmark's host ``spans`` (``(name, host_now(), host_now())``) are put
    on the trace's clock, whichever of the two holds every kernel inside
    the span named ``window``; they name the idle gaps."""
    from torch.autograd import DeviceType

    kernels = [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
               for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start]
    if not kernels:
        raise RuntimeError("the profile holds no kernel")
    window = (min(s for _, s, _ in kernels), max(e for _, _, e in kernels))
    origin = prof.profiler.kineto_results.trace_start_ns()
    ranges = []
    for clock in (0, 1):
        placed = [(n, (a[clock] - origin) / 1e3, (b[clock] - origin) / 1e3) for n, a, b in spans]
        outer = [(s, e) for n, s, e in placed if n == "window"]
        if outer and outer[0][0] <= window[0] and window[1] <= outer[0][1]:
            ranges = placed
            break
    return Trace(kernels=kernels, window=window, host_ranges=ranges)


def profiler():
    """``torch.profiler`` over the card's activity only: no host operator is
    recorded, so the host runs as it does untraced."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


# -- the result -----------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, checks: Dict[str, tuple], breakdown=None) -> str:
    """The last line of standard output; ``checks`` last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)
