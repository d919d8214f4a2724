"""Driver ``serve_volumes``: a closed loop of seeded LR volumes, one after
another, through the port's ``infer.py::infer_volume`` (window gather,
z-score, sub-volume split, the ancestral sampler over the SR U-Net, merge,
trim stitch, one copy back).

Traffic parameters: ``volume_edge`` (the LR volume's edge), ``volumes``
(how many distinct seeded phantoms the loop cycles through), ``patch_batch``
(windows per sampler call, ``infer``'s ``--patch-batch``), ``trace_calls``
(sampler calls profiled in a traced run), ``recorded_calls`` (the first
calls of the window whose steps the check follows).

End-to-end metrics: ``serve_mvox_per_s`` (megavoxels of denoised window
output per second: every window of the volumes served, over the time from
the window's start to the end of the last volume) and ``nfe_ms_p90`` (the
90th percentile of the device-clock interval between the ends of
consecutive denoiser forwards of one sampler call, from CUDA events that a
hook on the denoiser records).

The check follows the program step by step from its own state: in each
recorded call, one step drawn from the seed and the last step. For each,
the reference (fp32, ``benchmark/reference``) denoises the program's
``x_t`` with the conditioning it gathers itself from the raw volume, takes
the ancestral step with the same noise, and for the last step stitches the
result; the program's denoiser output, next state and stitched volume are
held against these (relative L2 per window, the worst).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from benchmark import harness, work
from benchmark.reference import data as ref_data
from benchmark.reference import diffusion as ref_diff
from benchmark.reference import unet as ref_unet


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp(min=1e-30))


class Serve:
    """One served cell: the program built from the seed, its traffic, and
    the records the check reads."""

    def __init__(self, wl: harness.Workload, seed: int, device):
        from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise, imagen_from_config
        from diffusioniqt_tpu_torch.models.unet3d import NullUnet

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        self.p = wl.traffic["params"]
        self.arch = harness.arch(wl.config, self.p["mode"])
        self.cfg = harness.program_config(wl.config, self.p["mode"])
        self.weights = harness.make_weights(ref_unet.param_shapes(self.arch), seed, self.device)
        unet = harness.build_unet(wl.config, self.cfg, self.device)
        unet.load_state_dict(self.weights)
        self.imagen = imagen_from_config(self.cfg, (NullUnet().to(self.device), unet))
        self.unet = self.imagen.unets[1]
        self.unet.eval()
        edge = self.p["volume_edge"]
        self.volumes = [ref_data.generate_pair(edge, harness.seed_for(seed, "volume", i))[1]
                        for i in range(self.p["volumes"])]
        self.patch = self.cfg.train.patch_size
        self.overlap = self.cfg.eval.overlap
        self.starts = [ref_data.window_starts(v, self.patch, self.overlap) for v in self.volumes]
        self.steps = self.cfg.train.timesteps
        gen = torch.Generator(device=self.device).manual_seed(harness.seed_for(seed, "noise"))
        self._draw = gaussian_noise(gen)
        rng = np.random.default_rng(harness.seed_for(seed, "steps"))
        self.recorded = {c: {int(rng.integers(0, self.steps - 1)), self.steps - 1}
                         for c in range(self.p["recorded_calls"])}
        self.records = {}       # (call, step) -> dict of tensors
        self.outputs = {}       # call -> (volume index, sampler output, stitched volume)
        self.call = -1          # sampler call of the window, -1 while warming up
        self.events = []        # per call, the CUDA events at each forward's end
        self.sync_spans = False
        self.spans = {"infer_volume": [], "sample": []}
        self.host_spans = []   # (name, host_now(), host_now()) of a traced run
        self._install()

    # -- instrumentation --------------------------------------------------
    def _install(self):
        sample = self.imagen.sample

        def sample_wrapper(**kwargs):
            self._step, self._draws = 0, 0
            self.events.append([])
            t0 = self._now()
            out = sample(**kwargs)
            self._span("sample", t0)
            if self.call in self.recorded:
                self.outputs[self.call] = [None, out.detach().clone(), None]
            return out

        self.imagen.sample = sample_wrapper

        def noise(shape):
            eps = self._draw(shape)
            step = self._draws - 1
            self._draws += 1
            if step in self.recorded.get(self.call, ()):
                self.records[(self.call, step)]["eps"] = eps.clone()
            return eps

        self.noise = noise

        def pre(module, args, kwargs):
            step = self._step
            if step in self.recorded.get(self.call, ()):
                self.records[(self.call, step)] = {"x": args[0].detach().clone()}
            if step - 1 in self.recorded.get(self.call, ()):
                self.records[(self.call, step - 1)]["x_next"] = args[0].detach().clone()

        def post(module, args, kwargs, out):
            ev = torch.cuda.Event(enable_timing=True) if self.device.type == "cuda" else None
            if ev is not None:
                ev.record()
            self.events[-1].append(ev)
            if self._step in self.recorded.get(self.call, ()):
                self.records[(self.call, self._step)]["out"] = out.detach().clone()
            self._step += 1

        self.unet.register_forward_pre_hook(pre, with_kwargs=True)
        self.unet.register_forward_hook(post, with_kwargs=True)

    def _now(self) -> tuple:
        """Both host clocks (:func:`harness.host_now`), after a synchronise
        in a traced run."""
        if self.sync_spans and self.device.type == "cuda":
            torch.cuda.synchronize()
        return harness.host_now()

    def _span(self, name: str, start: tuple):
        end = self._now()
        self.spans[name].append((end[1] - start[1]) / 1e9)
        self.host_spans.append((name, start, end))

    def serve_one(self):
        """Serve the next volume of the loop; returns its stitched volume."""
        from diffusioniqt_tpu_torch.infer import infer_volume

        index = max(self.call, 0) % len(self.volumes)
        t0 = self._now()
        volume = infer_volume(self.cfg, self.imagen, self.volumes[index], noise=self.noise,
                              patch_batch=self.p["patch_batch"], verbose=False)
        self._span("infer_volume", t0)
        if self.call in self.outputs:
            self.outputs[self.call][0] = index
            self.outputs[self.call][2] = volume
        return volume

    def voxels(self, index: int) -> int:
        return len(self.starts[index]) * self.patch ** 3

    # -- phases ----------------------------------------------------------------
    def warm(self):
        """One volume before the window: every shape the window uses."""
        self.serve_one()
        self.spans = {"infer_volume": [], "sample": []}
        self.events = []
        self.call = 0

    def window(self, seconds: float) -> dict:
        """Volumes until ``seconds`` have passed; the end-to-end metrics."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        start = time.perf_counter()
        voxels = 0
        while True:
            voxels += self.voxels(self.call % len(self.volumes))
            self.serve_one()
            self.call += 1
            end = time.perf_counter()
            if end - start >= seconds:
                break
        sync()
        metrics = {"serve_mvox_per_s": (voxels / 1e6 / (end - start), "Mvox/s")}
        gaps = self.nfe_intervals_ms()
        if len(gaps) >= self.p["nfe_min_intervals"]:
            metrics["nfe_ms_p90"] = (statistics.quantiles(gaps, n=10)[-1], "ms")
        self.volumes_served = self.call
        return metrics

    def traced(self, calls: int):
        """``calls`` volumes under the profiler, spans synchronised."""
        from diffusioniqt_tpu_torch.ops import kernels

        self.sync_spans = True
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        self.host_spans = []
        with harness.profiler() as prof:
            t0 = harness.host_now()
            for _ in range(calls):
                self.serve_one()
                self.call += 1
            torch.cuda.synchronize()
            self.host_spans.append(("window", t0, harness.host_now()))
        self.volumes_served = self.call
        trace = harness.trace_from_profiler(prof, self.host_spans)
        forwards = sum(len(e) for e in self.events)
        w = work.forward_work(self.arch, self.p["patch_batch"] * self.cfg.train.batch_sample_factor ** 3,
                              self.cfg.train.patch_size_sub)
        after = kernels.launch_counts()
        trace.counts = {"forwards": forwards, "calls": calls,
                        "launches": {k: after[k] - before[k] for k in after}}
        trace.spans = dict(self.spans)
        trace.work = {"forward_flops": float(w["conv"] + w["dot"]),
                      "block_least_s": work.block_least_s(w["blocks"])}
        return trace

    def nfe_intervals_ms(self):
        out = []
        for evs in self.events:
            out += [a.elapsed_time(b) for a, b in zip(evs, evs[1:]) if a is not None]
        return out

    def free_program(self):
        """Drop the program's state before the reference runs."""
        del self.imagen, self.unet
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------
    def readings(self, ctx=None) -> dict:
        """The worst gaps, over the recorded steps and their windows, between
        the program and the reference (or, with ``ctx``, between the reference
        computed as ``ctx`` says and the fp32 reference)."""
        arch, f = self.arch, self.cfg.train.batch_sample_factor
        mean, std = self.cfg.data.mean, self.cfg.data.std
        min_bound = self.cfg.data.min_bound
        grid = ref_diff.sampling_times(self.steps, self.device)
        group = f ** 3
        worst = dict.fromkeys(("denoise_rel", "update_rel", "stitch_rel"))

        def keep(key, value):
            worst[key] = harness.worst([value] if worst[key] is None else [worst[key], value])

        for call, (index, _, volume) in sorted(self.outputs.items()):
            if volume is None:
                continue
            starts = self.starts[index]
            raw = torch.from_numpy(self.volumes[index]).to(self.device)
            lowres = ref_data.gather_windows(raw, starts, self.patch, f, mean, std)
            for step in sorted(self.recorded[call]):
                rec = self.records[(call, step)]
                x = rec["x"].float()
                t = grid[step].expand(x.shape[0])
                t_next = grid[step + 1].expand(x.shape[0])
                last = step == self.steps - 1
                ref_next, alt_next = [], []
                for w in range(x.shape[0] // group):
                    rows = slice(w * group, (w + 1) * group)
                    args = (x[rows], ref_diff.log_snr(t[rows]), lowres[rows])
                    with torch.no_grad():
                        ref = ref_unet.forward(self.weights, arch, *args)
                        alt = rec["out"][rows].float() if ctx is None else \
                            ref_unet.forward(self.weights, arch, *args, ctx)
                    keep("denoise_rel", rel(alt, ref))
                    nxt = [ref_diff.ancestral_step(x[rows], o, t[rows], t_next[rows],
                                                   rec["eps"][rows], min_bound) for o in (ref, alt)]
                    if last:
                        nxt = [torch.clamp(n, min=min_bound) for n in nxt]
                    prog_next = rec["x_next"][rows].float() if not last else \
                        self.outputs[call][1][rows].float()
                    got = prog_next if ctx is None else nxt[1]
                    keep("update_rel", rel(got, nxt[0]))
                    ref_next.append(nxt[0])
                    alt_next.append(nxt[1])
                if last:
                    def stitch(rows):
                        wins = ref_unet.merge(rows, f)[..., 0]
                        return ref_data.trim_stitch(raw.shape, wins, starts, self.patch,
                                                    self.overlap, min_bound)
                    ref_vol = stitch(torch.cat(ref_next))
                    got = torch.from_numpy(volume).to(self.device) if ctx is None \
                        else stitch(torch.cat(alt_next))
                    for i, j, k in starts:
                        sl = tuple(slice(a, a + self.patch) for a in (i, j, k))
                        keep("stitch_rel", rel(got[sl], ref_vol[sl]))
        return worst


def run(wl: harness.Workload, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """One run of a served cell: set-up, the window (or the traced
    stretch), the peak, then the check."""
    t0 = time.time()
    serve = Serve(wl, seed, device)
    t1 = time.time()
    serve.warm()
    out = {"setup_end": time.time()}
    print(f"set-up: cell built in {t1 - t0:.3f} s, warm call {out['setup_end'] - t1:.3f} s",
          file=sys.stderr)
    if trace:
        out["trace"] = serve.traced(wl.traffic["params"]["trace_calls"])
    else:
        out["metrics"] = serve.window(seconds)
    out["peak"] = torch.cuda.max_memory_allocated() if serve.device.type == "cuda" else 0
    out["attempted"], out["failed"] = serve.volumes_served, 0
    serve.free_program()
    harness.exact_fp32(torch)
    out["readings"] = serve.readings()
    return out
