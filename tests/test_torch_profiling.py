"""The port's recorder (``diffusioniqt_tpu_torch/utils/profiling.py``) on the
CPU: nothing recorded without a profiler session, spans with their parents,
request ids, threads and self time under one, the spans of a tiny
``infer_volume`` and ``train_step``, the launch counters' lines, and the
benchmark's nine readers of the program's spans (``benchmark/metrics``) on
a synthetic trace."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import REPO
from diffusioniqt_tpu_torch import infer
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.data.loader import DataLoader
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
from diffusioniqt_tpu_torch.models.blocks import Block
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer
from diffusioniqt_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_recorder_off_records_nothing():
    off = profiling.span("a")
    assert off is profiling.span("b", device=True, request=3)
    with off as inside:
        assert inside is None
    assert profiling.launch_clock() == 0
    profiling.launch_timed("halo", 0)
    assert profiling.recorded() == ([], {})


def test_recorder_under_a_cpu_profiler():
    """Names, parents, request ids (given, inherited, numbered by root), the
    prefetch thread's spans, self time; no device time on the CPU; nothing
    after the session."""
    items = [np.full((2,), i, np.float32) for i in range(6)]
    with _profiled():
        with profiling.span("outer", request=7):
            with profiling.span("inner", device=True):
                time.sleep(0.01)
            time.sleep(0.005)
        for _ in range(2):
            with profiling.span("outer"):
                pass
        batches = list(DataLoader(items, batch_size=2, prefetch=1))
        assert profiling.launch_clock() > 0
    with profiling.span("late"):
        pass
    spans, counters = profiling.recorded()
    assert profiling.recorded()[0] == spans  # reading does not clear
    named = _by_name(spans)
    assert set(named) == {"outer", "inner", "loader.batch"}
    outer, inner = named["outer"][0], named["inner"][0]
    assert inner.parent is outer and outer.parent is None
    assert [s.request for s in named["outer"]] == [7, 1, 2] and inner.request == 7
    assert inner.device_ms is None and outer.device_ms is None
    assert outer.self_ms == pytest.approx(outer.host_ms - inner.host_ms)
    assert inner.host_ms >= 10.0 and outer.self_ms >= 5.0
    for s in spans:
        assert s.start[0] <= s.end[0] and s.start[1] <= s.end[1]
    loads = named["loader.batch"]
    assert len(loads) == len(batches) == 3
    assert [s.request for s in loads] == [0, 1, 2]
    assert len({s.thread for s in loads}) == 1 and loads[0].thread != threading.get_ident()
    assert all(s.parent is None for s in loads) and counters == {}


def _tiny_serve_cfg():
    cfg = load_config("config/eval_config.yaml")
    for k, v in {"dim": 8, "init_dim": 8, "dim_mults": (1, 2), "num_resnet_blocks": (1, 1),
                 "resnet_groups": 4, "patch_size_sub": 4, "timesteps": 2,
                 "compute_dtype": "float32", "att_enc": (False, False)}.items():
        setattr(cfg.train, k, v)
    cfg.eval.overlap = 8
    return cfg


def test_infer_volume_spans():
    """Per volume one ``infer.volume`` holding one ``infer.prepare``; per
    step one ``sampler.update``; per Block and forward one ``block.norm``;
    all of a volume's spans carry its request id."""
    cfg = _tiny_serve_cfg()
    imagen = infer.build_sampler(cfg, device="cpu", seed=0)
    calls = []
    sample = imagen.sample
    imagen.sample = lambda **kw: calls.append(1) or sample(**kw)
    lowres, _ = infer.fake_volumes(cfg, 20, seed=1)
    noise = gaussian_noise(torch.Generator().manual_seed(0))
    with _profiled():
        for _ in range(2):
            infer.infer_volume(cfg, imagen, lowres, noise=noise, patch_batch=3, verbose=False)
    named = _by_name(profiling.recorded()[0])
    blocks = sum(isinstance(m, Block) for m in imagen.unets[1].modules())
    forwards = len(calls) * cfg.train.timesteps
    assert blocks > 0 and len(calls) % 2 == 0
    assert [s.request for s in named["infer.volume"]] == [0, 1]
    assert len(named["infer.prepare"]) == 2
    assert all(s.parent.name == "infer.volume" for s in named["infer.prepare"])
    assert len(named["sampler.update"]) == forwards
    assert len(named["block.norm"]) == forwards * blocks
    for s in named["block.norm"] + named["sampler.update"]:
        root = s
        while root.parent is not None:
            root = root.parent
        assert root.name == "infer.volume" and s.request == root.request


def test_train_step_spans():
    """Per step one ``trainer.step`` (request: the steps taken) holding one
    ``trainer.data_wait``, a ``trainer.forward`` and a ``trainer.backward``
    per microbatch and one ``trainer.update``; the loader's batches on its
    prefetch thread."""
    cfg = load_config("config/eval_edm.yaml")
    cfg.train.patch_size_sub, cfg.train.pretrain = 4, False
    unet = UNet3D(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
                  resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
                  attend_at_enc=False, init_cross_embed=False, deep_feature=False,
                  boundary=True, batch_sample=True, img_size=12)
    imagen = ElucidatedImagen([NullUnet(), unet], image_sizes=(4, 4), channels=1,
                              auto_normalize_img=False, dynamic_thresholding=False,
                              norm="z-score", min_bound=-0.72, lowres_noise_aug=False,
                              num_sample_steps=4, sigma_data=1.0)
    tr = ImagenTrainer(cfg, imagen, gradient_accumulation_steps=2)
    rng = np.random.default_rng(0)
    items = [tuple(rng.standard_normal((12, 12, 12, 1)).astype(np.float32) for _ in range(2))
             for _ in range(4)]
    tr.add_train_dataset(items, batch_size=2)
    with _profiled():
        for _ in range(2):
            tr.train_step(unet_number=2, max_batch_size=27, sync=False)
    named = _by_name(profiling.recorded()[0])
    steps = named["trainer.step"]
    assert [s.request for s in steps] == [0, 1]
    for name, per_step in (("trainer.data_wait", 1), ("trainer.forward", 2),
                           ("trainer.backward", 2), ("trainer.update", 1)):
        assert len(named[name]) == 2 * per_step, name
        assert all(s.parent.name == "trainer.step" for s in named[name])
        assert [s.request for s in named[name]] == [0] * per_step + [1] * per_step
    blocks = sum(isinstance(m, Block) for m in unet.modules())
    assert len(named["block.norm"]) == 4 * blocks
    assert all(s.parent.name == "trainer.forward" for s in named["block.norm"])
    main = threading.get_ident()
    assert {s.thread for s in steps} == {main}
    assert named["loader.batch"] and all(s.thread != main for s in named["loader.batch"])


def test_launch_counters_keep_their_lines():
    """``launch_counts`` / ``launches_line`` read the recorder's always-on
    launch counters, in the order and format the entry points print; a
    launch's host time is counted only while recording."""
    kernels.reset_launch_counts()
    zero = dict.fromkeys(("halo", "conv3d", "fused_block", "fused_block_small",
                          "flash_attention", "group_norm"), 0)
    assert kernels.launch_counts() == zero
    profiling.count("kernels.launches.fused_block", 3)
    profiling.count("kernels.launches.halo")
    profiling.launched("group_norm")
    assert kernels.launches_line() == (
        'Kernel launches: {"halo": 1, "conv3d": 0, "fused_block": 3, '
        '"fused_block_small": 0, "flash_attention": 0, "group_norm": 1}')
    with _profiled():
        profiling.launch_timed("halo", profiling.launch_clock())
    profiling.launch_timed("halo", profiling.launch_clock())
    counters = profiling.recorded()[1]
    assert counters["kernels.launches_timed.halo"] == 1
    assert counters["kernels.launch_host_ns.halo"] > 0
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == zero
    assert counters["kernels.launches_timed.halo"] == profiling.counter(
        "kernels.launches_timed.halo")


# -- the benchmark's readers of the program's spans ----------------------------

OFFSET_US = 5e6  # the program's monotonic clock, less the trace's


def _span(name, start_us, end_us, thread=1, device_ms=None):
    """A recorded span whose interval on the trace's clock is given."""
    stamp = lambda us: (0, int((us + OFFSET_US) * 1e3))
    return SimpleNamespace(name=name, start=stamp(start_us), end=stamp(end_us), thread=thread,
                           device_ms=device_ms, parent=None, request=0)


def _read(name, trace):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py").read(trace)


def _serve():
    spans = [_span("infer.volume", 100.5, 399.998), _span("infer.prepare", 101, 111),
             *[_span("block.norm", 150 + i, 151 + i, device_ms=1.0) for i in range(4)],
             _span("sampler.update", 200, 201, device_ms=0.25),
             _span("sampler.update", 300, 301, device_ms=0.25),
             _span("infer.volume", 500.5, 899.997), _span("infer.prepare", 501, 521)]
    counters = {"kernels.launch_host_ns.fused_block": 30000,
                "kernels.launches_timed.fused_block": 2,
                "kernels.launch_host_ns.halo": 10000, "kernels.launches_timed.halo": 2,
                "kernels.launches.halo": 99}
    trace = harness.Trace(kernels=[("k", 0.0, 1000.0)], window=(0.0, 1000.0),
                          host_ranges=[("window", 0.0, 1000.0), ("infer_volume", 100.0, 400.0),
                                       ("sample", 150.0, 390.0), ("infer_volume", 500.0, 900.0)])
    trace.counts = {"forwards": 2}
    return spans, counters, trace


def _train():
    spans = []
    for k, lo in enumerate((0.0, 500.0)):
        spans += [_span("trainer.step", lo + 0.2, lo + 499.995),
                  _span("trainer.data_wait", lo + 1, lo + 11),
                  _span("trainer.backward", lo + 390, lo + 420, device_ms=3.0)]
    spans += [_span("trainer.forward", 90, 160), _span("trainer.update", 430, 440, device_ms=0.5),
              _span("loader.batch", 380, 460, thread=2), _span("loader.batch", 600, 640, thread=2)]
    trace = harness.Trace(kernels=[("k", 0.0, 100.0), ("k", 150.0, 400.0), ("k", 450.0, 1000.0)],
                          window=(0.0, 1000.0),
                          host_ranges=[("window", 0.0, 1000.0), ("train_step", 0.0, 500.0),
                                       ("train_step", 500.0, 1000.0)])
    trace.counts = {"steps": 2, "microbatches": 8}
    return spans, {}, trace


SERVE = {"groupnorm_ms_per_nfe.serve": 2.0, "sampler_update_ms_per_nfe.serve": 0.25,
         "volume_prep_ms.serve": 0.015, "launch_host_us.serve": 10.0}
# idle (100, 150) and (400, 450) against forward (90, 160), the first step's
# backward (390, 420) and update (430, 440): 50 + 20 + 10 us over 2 steps
TRAIN = {"data_wait_ms_per_step.train": 0.01, "loader_ms_per_batch.train": 0.06,
         "launch_idle_ms_per_step.train": 0.04, "backward_ms_per_step.train": 3.0,
         "update_ms_per_step.train": 0.25}


@pytest.mark.parametrize("name,want", [*SERVE.items(), *TRAIN.items()])
def test_program_span_readers(name, want, monkeypatch):
    """Each reader's number from synthetic spans placed by the anchors'
    matched ends; None for an unpaired anchor, for anchors whose offsets
    spread by more than 1 ms, and without the recorder."""
    spans, counters, trace = (_serve if name in SERVE else _train)()
    monkeypatch.setattr(profiling, "recorded", lambda: (spans, counters))
    # the anchors' ends lie nanoseconds from the ranges', which moves the
    # placed spans by as much
    assert _read(name, trace) == pytest.approx(want, rel=1e-3)
    anchor = "infer.volume" if name in SERVE else "trainer.step"
    anchors = [s for s in spans if s.name == anchor]
    monkeypatch.setattr(profiling, "recorded",
                        lambda: ([s for s in spans if s is not anchors[0]], counters))
    assert _read(name, trace) is None
    late = SimpleNamespace(**{**vars(anchors[1]), "end": (0, anchors[1].end[1] + 2_000_000)})
    monkeypatch.setattr(profiling, "recorded",
                        lambda: ([late if s is anchors[1] else s for s in spans], counters))
    assert _read(name, trace) is None
    monkeypatch.delattr(profiling, "recorded")
    assert _read(name, trace) is None
