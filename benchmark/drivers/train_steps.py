"""Driver ``train_steps``: optimizer steps of the port's
``train/trainer.py::ImagenTrainer.train_step`` on crops of seeded phantom
pairs, fed by the port's loader (``data/loader.py``: shuffling, a prefetch
thread, the copy to the card) the whole time.

Traffic parameters: ``phantoms`` (pairs made at set-up), ``phantom_edge``,
``batch`` (crops per optimizer step), ``steps_per_epoch`` (the dataset's
length in batches), ``setup_steps`` (steps before the window: the first
three are the ones the reference follows), ``trace_steps``.

The benchmark makes the inputs: the phantoms, the crop positions (drawn per
item from the seed, with the reference data loader's 20% non-zero rule) and
each microbatch's diffusion times and noise, which it hands to
``train_step``. End-to-end metric: ``train_mvox_per_s``, megavoxels of
high-resolution target per second over every step of the window.

The check: the reference (fp32 plain PyTorch and a plain Adam) takes the
same first three steps from the same weights, crops and draws. Compared:
the first step's denoiser outputs (the worst microbatch, relative L2); the
first gradient as Adam holds it after one step (``exp_avg / (1 -
beta1)``), relative L2 over every leaf at once; each leaf's change after
three steps, by norm, leaving out leaves whose reference gradient is under
a thousandth of the median leaf's; and the EMA copy, which up to
``ema_update_after_step`` takes the online weights exactly at every
``ema_update_every``-th step. Every number is required: one that a run
does not produce fails it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import harness, work
from benchmark.reference import data as ref_data
from benchmark.reference import diffusion as ref_diff
from benchmark.reference import unet as ref_unet


class CropDataset:
    """Items ``(hr, lr, position)`` of ``patch``^3 z-scored crops; the
    position ``(pair, x, y, z)`` is drawn per ``(seed, epoch, item)``."""

    def __init__(self, pairs, patch, mean, std, seed, length, ratio=0.2):
        self.pairs, self.patch, self.mean, self.std = pairs, patch, mean, std
        self.seed, self.length, self.ratio, self.epoch = seed, length, ratio, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.length

    def position(self, idx):
        rng = np.random.default_rng([self.seed % 2 ** 63, self.epoch, idx])
        k = idx % len(self.pairs)
        lr = self.pairs[k][1]
        high = lr.shape[0] - self.patch + 1
        best, best_nz = None, -1.0
        for _ in range(64):
            r = rng.integers(0, high, size=3)
            nz = np.count_nonzero(lr[r[0]:r[0] + self.patch, r[1]:r[1] + self.patch,
                                     r[2]:r[2] + self.patch]) / self.patch ** 3
            if nz >= self.ratio:
                best = r
                break
            if nz > best_nz:
                best, best_nz = r, nz
        return np.array([k, *best], np.int64)

    def __getitem__(self, idx):
        pos = self.position(idx)
        hr, lr = self.pairs[pos[0]]
        p, (x, y, z) = self.patch, pos[1:]
        crop = lambda v: ((v[x:x + p, y:y + p, z:z + p] - self.mean) / self.std)[..., None]
        return crop(hr).astype(np.float32), crop(lr).astype(np.float32), pos


class _Recording:
    """The trainer's loader, keeping the positions of the batches that the
    recorded steps take."""

    def __init__(self, loader, keep: int):
        self.loader, self.keep, self.positions = loader, keep, []

    def __iter__(self):
        for batch in self.loader:
            if len(self.positions) < self.keep:
                self.positions.append(torch.as_tensor(batch[2]).cpu().numpy())
            yield batch

    def __len__(self):
        return len(self.loader)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's ``|prog - ref| / max(ref, median ref)`` over norms."""
    med = float(np.median([ref[n] for n in ref]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in ref if keep is None or keep(n)}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return harness.worst(leaf_gaps(prog, ref, keep).values())


def whole_rel(prog: dict, ref: dict) -> float:
    """``||prog - ref|| / ||ref||`` over every leaf at once (1 where a leaf
    is missing or of another shape)."""
    if set(prog) != set(ref) or any(prog[n].shape != ref[n].shape for n in ref):
        return 1.0
    diff = sum(float((prog[n].double() - ref[n].double()).square().sum()) for n in ref)
    return (diff / sum(float(ref[n].double().square().sum()) for n in ref)) ** 0.5


def output_gap(prog, ref) -> float:
    """The worst microbatch's relative L2 gap of the denoiser's outputs (1
    where the program's are missing or of another shape)."""
    if len(prog) != len(ref) or any(a.shape != b.shape for a, b in zip(prog, ref)):
        return 1.0
    return harness.worst(float((a - b).norm() / b.norm()) for a, b in zip(prog, ref))


def norms(tensors: dict) -> dict:
    return {n: float(t.norm()) for n, t in tensors.items()}


class Train:
    def __init__(self, wl: harness.Workload, seed: int, device):
        from diffusioniqt_tpu_torch.diffusion.gaussian import imagen_from_config
        from diffusioniqt_tpu_torch.models.unet3d import NullUnet
        from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        self.p = wl.traffic["params"]
        self.arch = harness.arch(wl.config, self.p["mode"])
        self.cfg = cfg = harness.program_config(wl.config, self.p["mode"])
        self.weights = harness.make_weights(ref_unet.param_shapes(self.arch), seed, self.device)
        unet = harness.build_unet(wl.config, cfg, self.device)
        unet.load_state_dict(self.weights)
        imagen = imagen_from_config(cfg, (NullUnet().to(self.device), unet))
        t = cfg.train
        self.trainer = ImagenTrainer(
            configs=cfg, imagen=imagen, gradient_accumulation_steps=t.gradient_accumulation_steps,
            lr=t.lr, ema_decay=t.ema_decay, ema_update_after_step=t.ema_update_after_step,
            ema_update_every=t.ema_update_every, max_grad_norm=t.max_grad_norm,
            warmup_steps=t.warmup_steps, cosine_decay_max_steps=t.cosine_decay_max_steps,
            seed=harness.seed_for(seed, "trainer"))
        self.unet = imagen.unets[1]
        self.pairs = [ref_data.generate_pair(self.p["phantom_edge"], harness.seed_for(seed, "pair", i))
                      for i in range(self.p["phantoms"])]
        self.patch = t.patch_size
        dataset = CropDataset(self.pairs, self.patch, cfg.data.mean, cfg.data.std,
                              harness.seed_for(seed, "crops"),
                              self.p["batch"] * self.p["steps_per_epoch"])
        self.trainer.add_train_dataset(dataset, batch_size=self.p["batch"])
        self.recording = _Recording(self.trainer.train_dl, 3)
        self.trainer.train_dl = self.recording
        self.accum = t.gradient_accumulation_steps
        self.step_count = 0
        self.losses, self.ema_gap_t, self._ref = [], None, None

    def draws(self, step: int):
        """Each microbatch's diffusion times and noise for ``step``."""
        gen = torch.Generator(device=self.device).manual_seed(harness.seed_for(self.seed, "draws", step))
        rows = self.p["batch"] // self.accum
        shape = (rows, self.patch, self.patch, self.patch, self.arch["channels"])
        return [{"times": torch.rand((rows,), generator=gen, device=self.device),
                 "noise": torch.randn(shape, generator=gen, device=self.device)}
                for _ in range(self.accum)]

    def step(self, sync: bool):
        loss = self.trainer.train_step(unet_number=2, draws=self.draws(self.step_count), sync=sync)
        self.step_count += 1
        t = self.cfg.train
        if self.step_count % t.ema_update_every == 0 and self.step_count <= t.ema_update_after_step:
            # the update just made copied the online weights: keep the gap
            # on the card, read after the window
            with torch.no_grad():
                self.ema_gap_t = torch.stack([
                    (e - p).abs().max() for e, p in
                    zip(self.trainer.ema_unets[1].parameters(), self.unet.parameters())]).max()
        return loss

    def warm(self):
        """The recorded first steps, which also build and warm every kernel."""
        first = []
        hook = self.unet.register_forward_hook(
            lambda module, args, out: first.append(out.detach().float().clone()))
        for i in range(self.p["setup_steps"]):
            self.losses.append(self.step(sync=True))
            if i == 0:
                hook.remove()
                self.first_outputs = first
                opt = self.trainer.optimizers[1]
                beta1 = opt.param_groups[0]["betas"][0]
                state = {n: opt.state.get(p, {}) for n, p in self.unet.named_parameters()}
                self.first_grad = {n: st["exp_avg"] / (1 - beta1)
                                   for n, st in state.items() if "exp_avg" in st}
            if i == 2:
                self.change_norms = {n: float((p.detach() - self.weights[n]).norm())
                                     for n, p in self.unet.named_parameters()}

    def reach_ema_update(self):
        """Untimed steps after the window until the run has made an EMA
        update (a traced stretch or a short window can end before the
        first)."""
        while self.ema_gap_t is None and self.step_count < self.cfg.train.ema_update_after_step:
            self.step(sync=False)

    def voxels_per_step(self) -> int:
        return self.p["batch"] * self.patch ** 3

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            self.step(sync=False)
            steps += 1
        sync()
        end = time.perf_counter()
        self.attempted = steps
        return {"train_mvox_per_s": (steps * self.voxels_per_step() / 1e6 / (end - start),
                                     "Mvox/s")}

    def traced(self, steps: int):
        """``steps`` optimizer steps under the profiler."""
        torch.cuda.synchronize()
        spans = []
        with harness.profiler() as prof:
            start = harness.host_now()
            for _ in range(steps):
                t0 = harness.host_now()
                self.step(sync=False)
                spans.append(("train_step", t0, harness.host_now()))
            torch.cuda.synchronize()
            spans.append(("window", start, harness.host_now()))
        self.attempted = steps
        trace = harness.trace_from_profiler(prof, spans)
        rows = self.p["batch"] // self.accum
        trace.counts = {"steps": steps, "microbatches": steps * self.accum}
        trace.work = {"forward_flops": work.forward_flops(self.arch, rows, self.cfg.train.patch_size_sub)}
        return trace

    def free_program(self):
        self.ema_reading = None if self.ema_gap_t is None else float(self.ema_gap_t)
        del self.trainer, self.unet, self.ema_gap_t
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, ctx=None, fault=None):
        """The reference's first three steps: losses, the first gradient and
        each leaf's change by norm. ``ctx`` computes them as it says (the
        control); ``fault`` plants one: ``half_rows`` takes each
        microbatch's loss over the first half of its rows after a whole
        forward, ``two_microbatches`` runs the backward of only the first
        two microbatches of each step."""
        cfg, arch = self.cfg, self.arch
        params = {k: w.detach().clone().requires_grad_(True) for k, w in self.weights.items()}
        adam = ref_diff.Adam(params, cfg.train.lr)
        losses, first_grad, outputs = [], None, []
        rows = self.p["batch"] // self.accum
        for step in range(3):
            hr, lr = ref_data.crop_pairs(self.pairs, self.recording.positions[step], self.patch,
                                         cfg.data.mean, cfg.data.std, self.device)
            total = 0.0
            for m, d in enumerate(self.draws(step)):
                sl = slice(m * rows, (m + 1) * rows)
                per_row, out = ref_diff.row_losses(params, arch, hr[sl], lr[sl], d["times"],
                                                   d["noise"], cfg.data.min_bound, ctx)
                loss = per_row[:rows // 2].mean() if fault == "half_rows" else per_row.mean()
                if fault != "two_microbatches" or m < 2:
                    loss.backward()
                if step == 0:
                    outputs.append(out.detach())
                total += float(loss.detach())
            grads = {k: p.grad / self.accum for k, p in params.items()}
            if step == 0:
                first_grad = {k: g.clone() for k, g in grads.items()}
            adam.step(grads)
            for p in params.values():
                p.grad = None
            losses.append(total / self.accum)
        change = {k: float((p.detach() - self.weights[k]).norm()) for k, p in params.items()}
        return {"losses": losses, "grad": first_grad, "change": change, "outputs": outputs}

    def reference(self) -> dict:
        if self._ref is None:
            self._ref = self.reference_steps()
        return self._ref

    def _program(self) -> dict:
        return {"losses": self.losses[:3], "grad": self.first_grad, "change": self.change_norms,
                "outputs": self.first_outputs}

    def readings(self, alt=None) -> dict:
        """The compared gaps of the program (or of ``alt``, another run of
        :meth:`reference_steps`) from the fp32 reference."""
        ref = self.reference()
        prog = alt or self._program()
        ref_norms = norms(ref["grad"])
        med = float(np.median(list(ref_norms.values())))
        out = {"first_output_rel": output_gap(prog["outputs"], ref["outputs"]),
               "grad_rel": whole_rel(prog["grad"], ref["grad"]),
               "change_gap": leaf_gap(prog["change"], ref["change"],
                                      lambda n: ref_norms[n] >= 1e-3 * med)}
        if alt is None:
            out["ema_gap"] = self.ema_reading
        return out

    def looks(self, alt=None) -> dict:
        """What the check does not compare, for the calibration: each step's
        loss gap, the worst leaf's first gradient by norm, and where the gaps
        come from (the share of the first step's outputs on the other side
        of the clamp at ``min_bound``, by microbatch; the five leaves with
        the largest share of the first gradient's squared difference, with
        their own relative L2; the three worst leaves of the first gradient
        and of the change with both norms; the median leaf's gap)."""
        ref = self.reference()
        prog = alt or self._program()
        out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
               "losses": (prog["losses"], ref["losses"])}
        diff = {n: float((prog["grad"][n].double() - ref["grad"][n].double()).square().sum())
                for n in ref["grad"] if n in prog["grad"]}
        total = sum(diff.values()) or 1.0
        mb = self.cfg.data.min_bound
        out["clamp_flips"] = [float(((a < mb) != (b < mb)).double().mean())
                              for a, b in zip(prog["outputs"], ref["outputs"])]
        out["grad_diff_worst"] = [(n, diff[n] / total, diff[n] ** 0.5 / float(ref["grad"][n].norm()))
                                  for n in sorted(diff, key=diff.get)[-5:]]
        for key in ("grad", "change"):
            p, r = prog[key], ref[key]
            if key == "grad":
                p, r = norms(p), norms(r)
            gaps = leaf_gaps(p, r)
            worst = sorted(gaps, key=gaps.get)[-3:]
            out[key + "_gap"] = gaps[worst[-1]]
            out[key + "_worst"] = [(n, gaps[n], p[n], r[n]) for n in worst]
            out[key + "_median_gap"] = float(np.median(list(gaps.values())))
        return out


def run(wl: harness.Workload, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    t0 = time.time()
    train = Train(wl, seed, device)
    t1 = time.time()
    train.warm()
    out = {"setup_end": time.time()}
    print(f"set-up: cell built in {t1 - t0:.3f} s, recorded steps {out['setup_end'] - t1:.3f} s",
          file=sys.stderr)
    if trace:
        out["trace"] = train.traced(wl.traffic["params"]["trace_steps"])
    else:
        out["metrics"] = train.window(seconds)
    train.reach_ema_update()
    out["peak"] = torch.cuda.max_memory_allocated() if train.device.type == "cuda" else 0
    out["attempted"], out["failed"] = train.attempted, 0
    train.free_program()
    harness.exact_fp32(torch)
    out["readings"] = train.readings()
    return out
