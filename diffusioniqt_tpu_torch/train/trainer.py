"""ImagenTrainer on one device (counterpart of
``diffusioniqt_tpu/train/trainer.py``; reference trainer.py:236-1128).

  * per-unet Adam (0.9, 0.99, 1e-8) with optax's optional warmup / cosine
    schedule (:func:`lr_schedule`, evaluated at the update count, 0 for the
    first update) and optax's global-norm clipping (scale by
    ``max_norm / norm`` only when ``norm >= max_norm``, no epsilon)
  * the JAX trainer's microbatch rule: ``accum = max(accum, ceil(b /
    max_batch_size))``, back to 1 when ``b % accum != 0``; each microbatch's
    loss is backpropagated, the gradients summed and divided by ``accum``,
    one optimizer update per ``train_step``
  * the EMA (``train/ema.py``) as a separate fp32 copy of each unet, with
    its own packed-weight caches, updated every ``ema_update_every``
    optimizer steps with the ramp driven by the optimizer step count
  * validation (the loss with its outputs, reseeded to 42 on every call;
    and full sampling), EMA sampling chunked by whole 27-sub-volume groups
  * ``.pt`` bundles in the reference's format: ``model`` (an Imagen state
    dict, ``unets.{i}.*``), ``ema`` (``{i}.ema_model.*`` and ``{i}.step``),
    ``optim{i}``, ``steps``, and the trainer generator's state, so a resume
    reproduces the draw stream; plus the rolling ``checkpoint.{n}.pt``
    folder

Randomness: the diffusion times, sigmas and noise come from the trainer's
``torch.Generator`` on the model's device, seeded with ``seed``;
``train_step(draws=...)`` passes them in instead, one dict of keyword
arguments of the wrapper's ``forward`` per microbatch. Dropout draws from
torch's default generator.

The perceptual loss terms ``Train.lpips`` / ``Train.medlpips`` belong to
the Gaussian wrapper (``diffusion/gaussian.py::imagen_from_config`` builds
them): frozen networks outside the unets, so outside the optimizer, the
EMA and the bundle. The EDM loss has no such term (nor has the JAX
package's), so an EDM config that sets one is refused rather than trained
without it.

Data parallelism (``mesh``: a ``DeviceMesh`` with a ``data`` axis over
the ranks of a process group, ``parallel/``): a W-rank run computes what
the one-process run computes on the same seed, as the JAX mesh trainer's
SPMD program does with one key for the global batch.

  * every rank builds the same weights and takes rank 0's anyway
    (``prepare``), and every rank sees the same global batch
  * the microbatch count is the JAX mesh trainer's (:meth:`microbatches`
    with the data size); each rank keeps, of every global microbatch, its
    contiguous share of rows, selected patch-major before the 27-way
    ``batch_sample`` split. A share is always whole 27-sub-volume groups:
    the halo and the per-sub-volume GroupNorm need the whole group on one
    rank. JAX's SPMD partitioner may split a group across devices; here
    the count drops further until no microbatch does, and a batch whose
    share cuts a group even whole (or whose rows do not divide over the
    ranks) raises
  * every rank draws the global microbatch's times / sigmas / noise from
    its generator and keeps its rows, so the generators stay in step and
    every rank's objective is the one-process objective (dropout masks,
    from torch's default generator, are drawn per rank)
  * after the microbatches the gradients (and the loss) are averaged over
    the ranks in one flat all-reduce, before the clip, as optax clips the
    global mean gradient: one collective per optimizer step rather than
    DDP's bucketed reduction under ``no_sync``, because the step sums its
    microbatches' gradients locally first and needs the reduced gradient
    whole for the clip (overlapping the reduction with the backward is
    later work); every rank then takes the same Adam and EMA update, so the
    ranks' weights stay bitwise equal
  * ``valid_step`` shards its batch by whole groups when it divides, and
    ``sample`` spreads its patch batch (``parallel/sharding.py::sharded_sample``)
  * only the main process writes bundles; every rank loads them

Tensor parallelism (``mesh`` with a ``model`` axis of ``M`` ranks, the JAX
DP x TP mesh trainer, trainer.py:167-210, 340-356): every rank builds the
same weights and takes rank 0's; then each keeps the column shard of every
weight that ``parallel/sharding.py::param_shardings`` shards
(``shard_module_``), so Adam's moments and the EMA copy hold shards too.
The ranks of a model group see the same rows, the same draws and (their
default generators made equal at ``prepare``) the same dropout masks;
their layers gather the shards' outputs (``models/``). The microbatch rule
and the gradient mean run over the ``data`` axis only; the clip's global
norm sums the sharded gradients' squares over the model group and counts
the replicated ones once. Bundles hold the one-process tensors (shards
gathered by every rank, written by the main one) and are sliced on load.
The 2D and video U-Nets have no column split and raise.

``checkpoint_path`` and the paths of ``save`` / ``load`` may be fsspec URLs
(``memory://``, ``gs://``, ...; JAX trainer.py:929-936, 963-1072,
1119-1170): the same ``torch.save`` bundle, written through ``fsspec``.
"""

from __future__ import annotations

import copy
import io
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from diffusioniqt_tpu_torch.data.loader import DataLoader, device_transfer_map
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, gaussian_noise
from diffusioniqt_tpu_torch.metrics.image import PSNR, SSIM
from diffusioniqt_tpu_torch.metrics.lpips import SliceLPIPS
from diffusioniqt_tpu_torch.ops.volume import subvolumes_to_volume, volume_to_subvolumes
from diffusioniqt_tpu_torch.parallel import multihost, sharding
from diffusioniqt_tpu_torch.train.ema import ema_update
from diffusioniqt_tpu_torch.utils import profiling
from diffusioniqt_tpu_torch.utils.checkpoints import restore_parts
from diffusioniqt_tpu_torch.utils.misc import cast_tuple

_CKPT_NAME = re.compile(r"^checkpoint\.(\d+)\.pt$")


def lr_schedule(lr: float, warmup_steps: Optional[int] = None,
                cosine_decay_max_steps: Optional[int] = None) -> Callable[[int], float]:
    """The learning rate at update count ``n`` as the JAX trainer's optax
    schedules give it (trainer.py:106-118): with ``cosine_decay_max_steps``
    ``warmup_cosine_decay_schedule`` (linear from 0, or from ``lr`` without
    warmup, to ``lr`` over the warmup, then a cosine to ``lr / 1000`` over
    ``cosine_decay_max_steps - warmup`` counts: optax's ``decay_steps``
    includes the warmup); with only ``warmup_steps`` a linear ramp from 0
    to ``lr``; else constant."""
    w = warmup_steps or 0

    def linear(n: int, start: float, end: float, steps: int) -> float:
        if steps <= 0:
            return start
        frac = 1.0 - min(max(n, 0), steps) / steps
        return (start - end) * frac + end

    if cosine_decay_max_steps is not None:
        decay = cosine_decay_max_steps - w
        if decay <= 0:
            raise ValueError("cosine_decay_max_steps must exceed warmup_steps")
        alpha = 0.001

        def schedule(n: int) -> float:
            if n < w:
                return linear(n, 0.0 if warmup_steps else lr, lr, w)
            c = min(n - w, decay)
            return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + alpha)
        return schedule
    if warmup_steps is not None:
        return lambda n: linear(n, 0.0, lr, warmup_steps)
    return lambda n: lr


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None, mesh=None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global 2-norm reaches ``max_norm``, else
    unchanged. Returns the norm (a device scalar; no host sync). Under
    tensor parallelism (``sharded``: which gradients are column shards,
    ``mesh``: the DP x TP mesh) the squares of the shards are summed over
    the model group and the replicated gradients counted once."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(sharded, device=norms.device)
        sq = norms.square()
        shard_sq = torch.where(mask, sq, 0.0).sum()
        dist.all_reduce(shard_sq, group=mesh.get_group("model"))
        norm = torch.sqrt(shard_sq + torch.where(mask, 0.0, sq).sum())
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm


def _cycle(iterable):
    while True:
        for item in iterable:
            yield item


class ImagenTrainer:
    """Trains one unet of a (possibly cascaded) ``Imagen`` /
    ``ElucidatedImagen`` whose unets already sit on their device."""

    def __init__(self, configs=None, imagen=None, *, use_ema: bool = True, lr: float = 1e-4,
                 eps: float = 1e-8, beta1: float = 0.9, beta2: float = 0.99,
                 max_grad_norm: Optional[float] = None, warmup_steps: Optional[int] = None,
                 cosine_decay_max_steps: Optional[int] = None,
                 only_train_unet_number: Optional[int] = None,
                 gradient_accumulation_steps: int = 4, checkpoint_path: Optional[str] = None,
                 checkpoint_every: Optional[int] = None, max_checkpoints_keep: int = 20,
                 ema_decay: float = 0.9999,
                 ema_update_after_step: int = 100, ema_update_every: int = 10,
                 seed: int = 42, mesh=None):
        if not isinstance(imagen, (Imagen, ElucidatedImagen)):
            raise TypeError("an Imagen or ElucidatedImagen instance is required")
        if (configs is not None and isinstance(imagen, ElucidatedImagen)
                and (configs.train.lpips or configs.train.medlpips)):
            raise ValueError("Train.lpips / Train.medlpips: the EDM loss has no perceptual "
                             "term; they train with the Gaussian wrapper only")
        if (checkpoint_path is None) != (checkpoint_every is None):
            raise ValueError("checkpoint_path and checkpoint_every go together")
        self.imagen = imagen
        self.is_elucidated = isinstance(imagen, ElucidatedImagen)
        self.configs = configs
        self.mesh = mesh
        # the column-sharded parameters of each unet, {name: torch axis}
        self.shard_dims: List[Dict[str, int]] = [{} for _ in imagen.unets]
        if sharding.model_size(mesh) > 1:
            for unet in imagen.unets:  # raises for a family without the column split
                sharding.param_shardings(unet, mesh)
        if mesh is not None and isinstance(getattr(imagen, "lpips_fn", None), SliceLPIPS):
            # its slices are normalised over the batch: over every rank's rows
            imagen.lpips_fn.group = mesh.get_group("data")
        self.data_size, self.data_rank = sharding.data_size(mesh), sharding.data_rank(mesh)
        self.num_unets = imagen.num_unets
        self.device = next(imagen.unets[-1].parameters()).device

        self.use_ema = use_ema
        self.ema_kwargs = dict(beta=ema_decay, update_after_step=ema_update_after_step)
        self.ema_update_every = ema_update_every
        self.only_train_unet_number = only_train_unet_number
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.max_grad_norm = max_grad_norm
        self.adam_kwargs = [dict(betas=(beta1, beta2), eps=e)
                            for e in cast_tuple(eps, self.num_unets)]
        self.schedules = [lr_schedule(*args) for args in zip(
            cast_tuple(lr, self.num_unets), cast_tuple(warmup_steps, self.num_unets),
            cast_tuple(cosine_decay_max_steps, self.num_unets))]

        self.optimizers: Optional[List[torch.optim.Adam]] = None
        self.ema_unets: Optional[List[torch.nn.Module]] = None
        self.ema_steps = [0] * self.num_unets
        self.steps = [0] * self.num_unets
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        td = configs.train.transfer_dtype if configs is not None else None
        self._transfer = device_transfer_map(self.device, td)
        self.prepared = False

        self.train_dl = self.valid_dl = None
        self._train_iter = None

        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.max_checkpoints_keep = max_checkpoints_keep
        if checkpoint_path is not None:
            if not _is_url(checkpoint_path):
                os.makedirs(checkpoint_path, exist_ok=True)
            self.load_from_checkpoint_folder()

    # ------------------------------------------------------------------
    def prepare(self):
        """Per-unet Adam with zero moments (so a bundle always holds every
        leaf, as the JAX ``tx.init`` tree does) and the EMA copies. With a
        mesh, rank 0's weights go to every rank first (version counters
        bumped, so no rank keeps a stale packed weight); with a model axis
        each rank then keeps its column shards, before the optimizer and
        the EMA copy are made."""
        if self.prepared:
            return
        if self.mesh is not None:
            for unet in self.imagen.unets:
                sharding.broadcast_params(unet, self.mesh)
            self.shard_dims = [sharding.shard_module_(unet, self.mesh)
                               for unet in self.imagen.unets]
            sharding.sync_default_generators_(self.mesh, self.device)
        self.optimizers = []
        for index, unet in enumerate(self.imagen.unets):
            params = list(unet.parameters())
            opt = torch.optim.Adam(params, lr=self.schedules[index](0),
                                   **self.adam_kwargs[index])
            for p in params:  # torch.optim.Adam's own initial state
                opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.zeros_like(p)}
            self.optimizers.append(opt)
        if self.use_ema:
            self.ema_unets = []
            for unet in self.imagen.unets:
                ema = copy.deepcopy(unet).float().eval()
                ema.requires_grad_(False)
                self.ema_unets.append(ema)
        self.prepared = True

    def validate_unet_number(self, unet_number: Optional[int]) -> int:
        if self.num_unets == 1 and unet_number is None:
            unet_number = 1
        if unet_number is None or not 0 < unet_number <= self.num_unets:
            raise ValueError(f"unet_number must be in 1..{self.num_unets}")
        if self.only_train_unet_number not in (None, unet_number):
            raise ValueError("you can only train one unet at a time")
        return unet_number

    def get_lr(self, unet_number: Optional[int] = None) -> float:
        """The learning rate that unet ``unet_number``'s next update
        applies: its schedule at the updates taken so far (reference
        trainer.py:452-458)."""
        index = self.validate_unet_number(unet_number) - 1
        return float(self.schedules[index](self.steps[index]))

    def num_steps_taken(self, unet_number: Optional[int] = None) -> int:
        """Optimizer updates that unet ``unet_number`` has taken."""
        return self.steps[self.validate_unet_number(unet_number) - 1]

    # ------------------------------------------------------------------
    def add_train_dataloader(self, dl):
        self.train_dl = dl
        self._train_iter = None

    def add_valid_dataloader(self, dl):
        self.valid_dl = dl

    def add_train_dataset(self, dataset, *, batch_size: int, prefetch: int = 2):
        """Shuffled batches, prefetched on a worker thread that also casts
        them to ``Train.transfer_dtype`` (when set), pins them and copies
        them to the card (``data/loader.py::device_transfer_map``)."""
        self.add_train_dataloader(DataLoader(dataset, batch_size=batch_size, shuffle=True,
                                             prefetch=prefetch, worker_map=self._transfer))

    def add_valid_dataset(self, dataset, *, batch_size: int):
        self.add_valid_dataloader(DataLoader(dataset, batch_size=batch_size, shuffle=False))

    def _device_batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hr, lr) fp32 on the device; what is not there yet goes through
        the transfer map (cast to ``Train.transfer_dtype`` for the copy)."""
        hr, lr_img = self._transfer(batch[:2])
        return hr.float(), lr_img.float()

    def _split_factor(self, hr) -> int:
        """``batch_sample_factor`` when the batch still needs the 96^3 ->
        27 x 32^3 split (reference trainer :724-728), else 1."""
        cfg = self.configs
        if cfg is not None and cfg.train.batch_sample and hr.shape[1] != cfg.train.patch_size_sub:
            return cfg.train.batch_sample_factor
        return 1

    def _maybe_batch_sample_split(self, hr, lr_img):
        """96^3 -> 27 x 32^3 (reference trainer :724-728)."""
        f = self._split_factor(hr)
        if f > 1:
            hr, lr_img = volume_to_subvolumes(hr, f), volume_to_subvolumes(lr_img, f)
        return hr, lr_img

    # ------------------------------------------------------------------
    def _stage_lowres(self, index: int, lr_img):
        """The lowres batch, or None for a base (unconditioned) cascade
        stage, which never sees it (JAX trainer.py:297-304)."""
        return lr_img if getattr(self.imagen.unets[index], "lowres_cond", True) else None

    def _loss(self, index: int, hr, lr_img, draws: Dict[str, Any]) -> torch.Tensor:
        out = self.imagen.forward(hr, self._stage_lowres(index, lr_img), unet_number=index + 1,
                                  generator=self.generator, **draws)
        return out if self.is_elucidated else out[0]

    def _global_draws(self, index: int, rows: int, hr, lr_img, generator,
                      given: Dict[str, Any]) -> Dict[str, Any]:
        """The draws of a ``rows``-row global batch shaped like ``hr`` /
        ``lr_img`` (None: no lowres input) past their first axis, as the
        one-process forward draws them; those ``given`` are kept."""
        return self.imagen.training_draws(
            generator, (rows,) + tuple(hr.shape[1:]),
            None if lr_img is None else (rows,) + tuple(lr_img.shape[1:]),
            unet_number=index + 1, **given)

    def _my_rows(self, draws: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch's draws."""
        return {k: sharding.shard_rows(v, self.mesh) for k, v in draws.items()}

    @staticmethod
    def microbatches(b: int, accum: int, max_batch_size: Optional[int] = None,
                     data_size: int = 1, group: int = 1) -> int:
        """The number of microbatches a batch of ``b`` rows runs in (JAX
        trainer.py:410-428): with a mesh, fewer until each microbatch splits
        evenly over the ``data_size`` ranks, in whole groups of ``group``
        rows per rank. With ``group`` 1 this is the JAX mesh trainer's
        count; where that count would give a rank part of a 27-sub-volume
        group (which JAX's SPMD program would split across devices), the
        next smaller count that does not."""
        if max_batch_size is not None:
            accum = max(accum, -(-b // max_batch_size))
        accum = accum if b % accum == 0 else 1
        while accum > 1 and (b // accum) % (data_size * group):
            accum -= 1
        return accum

    def _plan(self, units: int, rows_per_unit: int, max_batch_size: Optional[int]):
        """``(accum, share)``: the microbatch count of a global batch of
        ``units`` patches of ``rows_per_unit`` rows each, and the rows of
        each microbatch that one rank takes. With a mesh, raises where the
        JAX mesh trainer would drop rows or where a rank's share would cut a
        27-group (the halo and the per-sub-volume GroupNorm need the whole
        group on one rank)."""
        b, n = units * rows_per_unit, self.data_size
        if self.mesh is None:
            accum = self.microbatches(b, self.gradient_accumulation_steps, max_batch_size)
            return accum, b // accum
        unit = max(self._sample_group_size(), rows_per_unit)
        accum = self.microbatches(b, self.gradient_accumulation_steps, max_batch_size, n, unit)
        if b % accum or b % n:
            raise ValueError(f"a batch of {b} rows does not split into {accum} microbatches "
                             f"over {n} data ranks")
        share = b // accum // n
        if share % unit:
            raise ValueError(
                f"each of {n} data ranks would take {share} rows of every {b // accum}-row "
                f"microbatch, which cuts a group of {unit} sub-volumes: the halo and the "
                f"per-sub-volume GroupNorm need the whole group on one rank")
        return accum, share

    def _local_batch(self, x: torch.Tensor, accum: int, share_units: int) -> torch.Tensor:
        """This rank's patches of every microbatch, in microbatch order."""
        per_mb = x.shape[0] // accum
        lo = self.data_rank * share_units
        return torch.cat([x[i * per_mb + lo:i * per_mb + lo + share_units]
                          for i in range(accum)])

    def train_step(self, unet_number: Optional[int] = None,
                   max_batch_size: Optional[int] = None, batch=None, sync: bool = True,
                   draws: Optional[Sequence[Dict[str, Any]]] = None):
        """One optimizer step over ``batch=(hr, lr)`` (channels-last), else
        the next batch of the training loader. ``draws``: one dict of the
        wrapper's ``forward`` draws per microbatch (of the global microbatch
        with a mesh). Returns the mean microbatch loss (over every rank), a
        float, or with ``sync=False`` a device scalar (no host sync).
        Recorded as the span ``trainer.step`` (request: the steps taken)."""
        index = self.validate_unet_number(unet_number) - 1
        with profiling.span("trainer.step", request=self.steps[index]):
            return self._train_step(index, max_batch_size, batch, sync, draws)

    def _train_step(self, index: int, max_batch_size, batch, sync: bool, draws):
        if batch is None:
            if self.train_dl is None:
                raise RuntimeError("training dataloader has not been registered with the trainer")
            if self._train_iter is None:
                self._train_iter = _cycle(self.train_dl)
            with profiling.span("trainer.data_wait"):
                batch = next(self._train_iter)
        hr, lr_img = self._device_batch(batch)
        self.prepare()

        rows_per_unit = self._split_factor(hr) ** 3
        accum, share = self._plan(hr.shape[0], rows_per_unit, max_batch_size)
        if draws is not None and len(draws) != accum:
            raise ValueError(f"{len(draws)} sets of draws for {accum} microbatches")
        if self.mesh is not None:
            hr, lr_img = (self._local_batch(t, accum, share // rows_per_unit)
                          for t in (hr, lr_img))
        hr, lr_img = self._maybe_batch_sample_split(hr, lr_img)
        unet, opt = self.imagen.unets[index], self.optimizers[index]
        unet.train()
        opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            sl = slice(i * share, (i + 1) * share)
            d = draws[i] if draws else {}
            if self.mesh is not None:
                d = self._my_rows(self._global_draws(
                    index, share * self.data_size, hr, self._stage_lowres(index, lr_img),
                    self.generator, d))
            with profiling.span("trainer.forward"):
                loss = self._loss(index, hr[sl], lr_img[sl], d)
            with profiling.span("trainer.backward", device=True):
                loss.backward()
            loss_sum += loss.detach()

        with profiling.span("trainer.update", device=True):
            self._update(index, unet, opt, accum, loss_sum)

        if self.checkpoint_path is not None and self.steps[index] % self.checkpoint_every == 0:
            self.save_to_checkpoint_folder()

        loss = loss_sum / accum
        return float(loss) if sync else loss

    def _update(self, index: int, unet, opt, accum: int, loss_sum: torch.Tensor) -> None:
        """The averaged gradients' all-reduce (with a mesh) and clip, the
        Adam step and the EMA update."""
        # optax updates every leaf: a parameter without a gradient gets a
        # zero one, so its moments decay as in the JAX trainer
        params = list(unet.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        torch._foreach_div_(grads, float(accum))
        if self.mesh is not None:
            sharding.all_reduce_mean_(grads + [loss_sum], self.mesh)
        if self.max_grad_norm is not None:
            dims = self.shard_dims[index]
            clip_by_global_norm_(grads, self.max_grad_norm,
                                 [n in dims for n, _ in unet.named_parameters()], self.mesh)
        for group in opt.param_groups:
            group["lr"] = self.schedules[index](self.steps[index])
        opt.step()
        # the kernels' packed-weight caches key on version counters, which
        # an Adam step on CUDA need not bump (ops/kernels/conv3d.py)
        torch.autograd.graph.increment_version(params)
        self.steps[index] += 1

        if self.use_ema and self.steps[index] % self.ema_update_every == 0:
            ema_update(self.ema_unets[index], unet, self.steps[index], **self.ema_kwargs)
            self.ema_steps[index] = self.steps[index]

    def update(self, unet_number: Optional[int] = None):
        """No-op kept for API parity: the optimizer update happens once,
        inside ``train_step`` (JAX trainer.py:481-487; the reference's
        train.py calls ``update`` a second time, stepping Adam on zeros)."""
        return None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def valid_step(self, unet_number: Optional[int] = None,
                   max_batch_size: Optional[int] = None, **kwargs):
        """Validation sweep (reference :685-765; JAX trainer.py:509-594),
        reseeded to 42 on every call. Returns ``(loss, preds, x_noisy,
        [hrs, lowres_noisy], ssim, psnr)``, arrays on the host; SSIM and
        PSNR of the merged volumes when the prediction is an x0 estimate.
        With a mesh, a batch of whole groups for every rank is sharded
        (the global draws, each rank's rows, the outputs gathered: JAX
        ``_put_valid_batch``), any other is computed whole on every rank;
        every rank returns what the one-process sweep returns."""
        index = self.validate_unet_number(unet_number) - 1
        if self.valid_dl is None:
            raise RuntimeError("validation dataloader has not been registered")
        self.prepare()
        repeat = self.configs.eval.repeat if self.configs else 1
        pred_is_x_start = self.is_elucidated or self.imagen.pred_objectives[index] == "x_start"
        split = self.configs is not None and self.configs.train.batch_sample
        f = self.configs.train.batch_sample_factor if split else 1
        unet = self.imagen.unets[index]
        unet.eval()
        generator = torch.Generator(device=self.device).manual_seed(42)
        group = self._sample_group_size()
        extra = {"return_outputs": True} if self.is_elucidated else {}
        losses, preds, noisy, hrs, lowres_list, ssims, psnrs = [], [], [], [], [], [], []
        for r in range(repeat):
            for batch in self.valid_dl:
                hr, lr_img = self._maybe_batch_sample_split(*self._device_batch(batch))
                b, n = hr.shape[0], self.data_size
                if n > 1 and b % (n * group) == 0:
                    d = self._my_rows(self._global_draws(index, b, hr, lr_img, generator, {}))
                    loss, *outs = self.imagen.forward(
                        sharding.shard_rows(hr, self.mesh), sharding.shard_rows(lr_img, self.mesh),
                        unet_number=index + 1, **d, **extra)
                    sharding.all_reduce_mean_([loss], self.mesh)
                    pred, x_noisy, lowres_noisy = (
                        None if o is None else sharding.all_gather_rows(o, self.mesh)
                        for o in outs)
                else:
                    loss, pred, x_noisy, lowres_noisy = self.imagen.forward(
                        hr, lr_img, unet_number=index + 1, generator=generator, **extra)
                losses.append(float(loss))
                if pred_is_x_start:
                    pred_m = subvolumes_to_volume(pred, f) if split else pred
                    hr_m = subvolumes_to_volume(hr, f) if split else hr
                    ssims.append(float(SSIM(pred_m, hr_m)))
                    psnrs.append(float(PSNR(pred_m, hr_m)))
                if r < 2:
                    preds.append(pred.cpu().numpy())
                    noisy.append(x_noisy.cpu().numpy())
                    hrs.append(hr.cpu().numpy())
                    lowres_list.append(lowres_noisy.cpu().numpy())

        def cat(parts):
            return np.concatenate(parts) if parts else np.zeros((0,))

        return (float(np.mean(losses)), cat(preds), cat(noisy), [cat(hrs), cat(lowres_list)],
                float(np.mean(ssims)) if ssims else float("nan"),
                float(np.mean(psnrs)) if psnrs else float("nan"))

    @torch.no_grad()
    def valid_step_sample(self, unet_number: Optional[int] = None, use_ema_unets: bool = True,
                          max_batch_size: Optional[int] = None, **kwargs):
        """Sampling validation (reference ``valid_step2``, :629-683): the
        full sampler on each validation batch's lowres input, scored by SSIM
        and PSNR. Returns ``(losses, preds, [hrs, lrs], ssim, psnr)``."""
        unet_number = self.validate_unet_number(unet_number)
        if self.valid_dl is None:
            raise RuntimeError("validation dataloader has not been registered")
        repeat = self.configs.eval.repeat if self.configs else 1
        losses, preds, hrs, lrs, ssims, psnrs = [], [], [], [], [], []
        for _ in range(repeat):
            for batch in self.valid_dl:
                hr, lr_img = self._maybe_batch_sample_split(*self._device_batch(batch))
                out = self.sample(batch_size=hr.shape[0], max_batch_size=max_batch_size,
                                  start_image_or_video=lr_img,
                                  start_at_unet_number=unet_number,
                                  use_non_ema=not use_ema_unets, **kwargs)
                losses.append(float((hr - out).abs().mean()))
                ssims.append(float(SSIM(out, hr)))
                psnrs.append(float(PSNR(out, hr)))
                preds.append(out.cpu().numpy())
                hrs.append(hr.cpu().numpy())
                lrs.append(lr_img.cpu().numpy())
        return (np.asarray(losses), np.concatenate(preds),
                [np.concatenate(hrs), np.concatenate(lrs)],
                float(np.mean(ssims)), float(np.mean(psnrs)))

    # ------------------------------------------------------------------
    def _sampling_imagen(self, use_ema: bool = True):
        """The wrapper over the EMA unets (or, with ``use_ema=False`` or no
        EMA, the online ones), sharing everything else."""
        self.prepare()
        imagen = copy.copy(self.imagen)
        if use_ema and self.use_ema:
            imagen.unets = list(self.ema_unets)
        for unet in imagen.unets:
            unet.eval()
        return imagen

    def _sample_group_size(self) -> int:
        """Sub-volumes per indivisible sampling group: ``factor^3`` under
        ``batch_sample``, else 1 (JAX trainer.py:648-656)."""
        unet = self.imagen.unets[-1]
        if getattr(self.imagen, "batch_sample", False) or getattr(unet, "batch_sample", False):
            return int(getattr(unet, "batch_sample_factor", 3)) ** 3
        return 1

    @torch.no_grad()
    def sample(self, *, batch_size: int = 1, max_batch_size: Optional[int] = None,
               use_non_ema: bool = False, noise=None, **kwargs):
        """Sampling with the EMA unets by default (reference trainer.sample,
        :1083-1097), chunked by ``max_batch_size`` rounded down to whole
        sub-volume groups; every batch-major tensor argument
        (``start_image_or_video``, ``cond_images``, each unet's
        ``init_images``, the inpainting images and masks) is sliced per
        chunk, and the chunks' outputs (trajectories along their batch axis)
        are concatenated. ``return_all_unet_outputs`` is the JAX trainer's
        alias of ``return_all_outputs`` (JAX trainer.py:853-854). ``noise``
        defaults to the trainer's generator. With a mesh, each chunk is
        spread over the data ranks and gathered back to every rank
        (``parallel/sharding.py::sharded_sample``), equal to the one-process
        result."""
        if "return_all_unet_outputs" in kwargs:
            kwargs["return_all_outputs"] = kwargs.pop("return_all_unet_outputs")
        imagen = self._sampling_imagen(use_ema=not use_non_ema)
        noise = noise or gaussian_noise(self.generator)
        group = self._sample_group_size()

        def run(n, **kw):
            return sharding.sharded_sample(imagen.sample, self.mesh, batch_size=n,
                                           noise=noise, group=group, **kw)

        if max_batch_size is not None and group > 1:
            max_batch_size = max(max_batch_size // group, 1) * group
        if max_batch_size is None or batch_size <= max_batch_size:
            return run(batch_size, **kwargs)
        outs = []
        for lo in range(0, batch_size, max_batch_size):
            hi = min(lo + max_batch_size, batch_size)
            outs.append(run(hi - lo, **sharding.map_batch_tensors(kwargs, lambda v: v[lo:hi])))

        def cat(parts, dim=0):
            if isinstance(parts[0], (list, tuple)):  # one output per unet
                return [torch.cat(p, dim=dim) for p in zip(*parts)]
            return torch.cat(parts, dim=dim)

        if kwargs.get("return_trajectory", False):
            return (cat([o[0] for o in outs]), cat([o[1] for o in outs], 1),
                    cat([o[2] for o in outs], 1))
        return cat(outs)

    # ------------------------------------------------------------------
    def _optim_dims(self, index: int) -> Dict[int, int]:
        """The sharded parameters of unet ``index`` by their position in its
        optimizer's state dict."""
        dims = self.shard_dims[index]
        return {i: dims[n] for i, (n, _) in enumerate(self.imagen.unets[index].named_parameters())
                if n in dims}

    def _map_optim(self, state: Dict[str, Any], index: int, fn) -> Dict[str, Any]:
        """An optimizer state dict with ``fn(moments, dims)`` over the Adam
        moments of the sharded parameters."""
        dims = self._optim_dims(index)
        if not dims:
            return state
        per = {}
        for key in ("exp_avg", "exp_avg_sq"):
            flat = fn({i: state["state"][i][key] for i in dims}, dims)
            for i in dims:
                per.setdefault(i, {})[key] = flat[i]
        return {**state, "state": {i: {**v, **per.get(i, {})}
                                   for i, v in state["state"].items()}}

    def state_bundle(self) -> Dict[str, Any]:
        """The reference-format bundle (reference trainer.py:813-878), with
        the one-process tensors: under tensor parallelism every rank of a
        model group calls it (it gathers the shards)."""
        self.prepare()

        def whole(state, i):
            return sharding.gather_state(state, self.shard_dims[i], self.mesh)

        bundle: Dict[str, Any] = {
            "model": {f"unets.{i}.{k}": v for i, unet in enumerate(self.imagen.unets)
                      for k, v in whole(unet.state_dict(), i).items()},
            "steps": torch.tensor(self.steps),
            "generator": self.generator.get_state(),
        }
        for i, opt in enumerate(self.optimizers):
            bundle[f"optim{i}"] = self._map_optim(
                opt.state_dict(), i, lambda t, d: sharding.gather_state(t, d, self.mesh))
        if self.use_ema:
            ema: Dict[str, Any] = {}
            for i, unet in enumerate(self.ema_unets):
                ema.update({f"{i}.ema_model.{k}": v
                            for k, v in whole(unet.state_dict(), i).items()})
                ema[f"{i}.step"] = torch.tensor(self.ema_steps[i])
            bundle["ema"] = ema
        return bundle

    def save(self, path: str):
        """Write the bundle to ``path`` (a ``.pt`` file, atomically, or an
        fsspec URL). With a mesh, every rank calls it: the main process
        writes, and the others wait for it (JAX trainer.py:977)."""
        if not self.prepared:
            raise RuntimeError("nothing to save: the trainer is not prepared")
        # under tensor parallelism every rank gathers, the main one writes
        bundle = self.state_bundle() if self._writes() or any(self.shard_dims) else None
        if self._writes():
            if _is_url(path):
                import fsspec

                fs, fpath = fsspec.core.url_to_fs(path)
                parent = fpath.rsplit("/", 1)[0]
                if parent:
                    fs.makedirs(parent, exist_ok=True)
                with fs.open(fpath, "wb") as fh:
                    torch.save(bundle, fh)
            else:
                path = os.path.abspath(path)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                torch.save(bundle, tmp)
                os.replace(tmp, path)
        if self.mesh is not None:
            multihost.barrier()

    def _writes(self) -> bool:
        """Whether this process writes files: always without a mesh, the
        main process with one."""
        return self.mesh is None or multihost.is_main_process()

    def load(self, path: str, strict: bool = True, noop_if_not_exist: bool = False):
        """Restore a bundle written by :meth:`save` (a file or an fsspec
        URL; on every rank, with a mesh). ``strict=False`` keeps every
        current part the bundle lacks or holds at another shape
        (``utils/checkpoints.py::restore_parts``), as the ``pretrain`` path
        of ``train.py`` loads."""
        if _is_url(path):
            import fsspec

            fs, fpath = fsspec.core.url_to_fs(path)
            exists = fs.exists(fpath)
        else:
            exists = os.path.exists(path)
        if not exists:
            if noop_if_not_exist:
                return
            raise FileNotFoundError(path)
        self.prepare()
        if _is_url(path):
            with fs.open(fpath, "rb") as fh:
                raw = torch.load(io.BytesIO(fh.read()), map_location="cpu", weights_only=True)
        else:
            raw = torch.load(path, map_location="cpu", weights_only=True)
        if not strict:
            raw = restore_parts(self.state_bundle(), raw)
        self._restore(raw, strict)

    def _restore(self, raw: Dict[str, Any], strict: bool) -> None:
        for i, unet in enumerate(self.imagen.unets):
            dims = self.shard_dims[i]
            prefix = f"unets.{i}."
            unet.load_state_dict(sharding.slice_state(
                {k[len(prefix):]: v for k, v in raw["model"].items() if k.startswith(prefix)},
                dims, self.mesh), strict=strict)
            self.optimizers[i].load_state_dict(self._map_optim(
                raw[f"optim{i}"], i, lambda t, d: sharding.slice_state(t, d, self.mesh)))
            if self.use_ema and "ema" in raw:
                prefix = f"{i}.ema_model."
                self.ema_unets[i].load_state_dict(sharding.slice_state(
                    {k[len(prefix):]: v for k, v in raw["ema"].items() if k.startswith(prefix)},
                    dims, self.mesh), strict=strict)
                self.ema_steps[i] = int(raw["ema"].get(f"{i}.step", 0))
        # the packed-weight caches key on version counters: bump them after
        # the in-place load, whatever the copy did
        for module in list(self.imagen.unets) + list(self.ema_unets or []):
            torch.autograd.graph.increment_version(list(module.parameters()))
        self.steps = [int(s) for s in raw["steps"]]
        # a generator of another device type has a state of another size:
        # its stream cannot be continued here
        state = raw.get("generator")
        if state is not None and state.numel() == self.generator.get_state().numel():
            self.generator.set_state(state)

    # ------------------------------------------------------------------
    def _folder_path(self, name: str) -> str:
        if _is_url(self.checkpoint_path):
            return f"{self.checkpoint_path.rstrip('/')}/{name}"
        return os.path.join(self.checkpoint_path, name)

    @property
    def all_checkpoints_sorted(self) -> List[str]:
        """The rolling folder's bundles, newest (most steps) first."""
        if self.checkpoint_path is None:
            return []
        if _is_url(self.checkpoint_path):
            import fsspec

            fs, fpath = fsspec.core.url_to_fs(self.checkpoint_path)
            names = ([p.rsplit("/", 1)[-1] for p in fs.ls(fpath, detail=False)]
                     if fs.exists(fpath) else [])
        else:
            names = os.listdir(self.checkpoint_path)
        found = [(int(m.group(1)), name) for name in names if (m := _CKPT_NAME.match(name))]
        return [self._folder_path(name) for _, name in sorted(found, reverse=True)]

    def save_to_checkpoint_folder(self):
        """``checkpoint.{total steps}.pt``, keeping the newest
        ``max_checkpoints_keep`` (all with 0); the main process writes and
        prunes (JAX trainer.py:1148)."""
        self.save(self._folder_path(f"checkpoint.{sum(self.steps)}.pt"))
        if self.max_checkpoints_keep > 0 and self._writes():
            for stale in self.all_checkpoints_sorted[self.max_checkpoints_keep:]:
                if _is_url(stale):
                    import fsspec

                    fs, fpath = fsspec.core.url_to_fs(stale)
                    fs.rm(fpath)
                else:
                    os.remove(stale)

    def load_from_checkpoint_folder(self, last_total_steps: int = -1):
        if last_total_steps != -1:
            self.load(self._folder_path(f"checkpoint.{last_total_steps}.pt"))
            return
        ckpts = self.all_checkpoints_sorted
        if ckpts:
            self.load(ckpts[0])


def _is_url(path: str) -> bool:
    """An fsspec URL (``scheme://...``; JAX trainer.py:929-936)."""
    return bool(re.match(r"^[a-z0-9]+://", path))
