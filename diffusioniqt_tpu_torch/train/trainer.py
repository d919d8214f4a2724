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

One device: a mesh, multi-host training and fsspec URLs raise
``NotImplementedError`` (not ported yet).
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusioniqt_tpu_torch.data.loader import DataLoader, device_transfer_map
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, gaussian_noise
from diffusioniqt_tpu_torch.metrics.image import PSNR, SSIM
from diffusioniqt_tpu_torch.ops.volume import subvolumes_to_volume, volume_to_subvolumes
from diffusioniqt_tpu_torch.train.ema import ema_update
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


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global 2-norm reaches ``max_norm``, else
    unchanged. Returns the norm (a device scalar; no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
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
        if mesh is not None:
            raise NotImplementedError("the mesh (data-parallel) trainer is not ported yet")
        if (configs is not None and isinstance(imagen, ElucidatedImagen)
                and (configs.train.lpips or configs.train.medlpips)):
            raise ValueError("Train.lpips / Train.medlpips: the EDM loss has no perceptual "
                             "term; they train with the Gaussian wrapper only")
        if checkpoint_path is not None and re.match(r"^[a-z0-9]+://", checkpoint_path):
            raise NotImplementedError("fsspec checkpoint URLs are not ported yet")
        if (checkpoint_path is None) != (checkpoint_every is None):
            raise ValueError("checkpoint_path and checkpoint_every go together")
        self.imagen = imagen
        self.is_elucidated = isinstance(imagen, ElucidatedImagen)
        self.configs = configs
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
            os.makedirs(checkpoint_path, exist_ok=True)
            self.load_from_checkpoint_folder()

    # ------------------------------------------------------------------
    def prepare(self):
        """Per-unet Adam with zero moments (so a bundle always holds every
        leaf, as the JAX ``tx.init`` tree does) and the EMA copies."""
        if self.prepared:
            return
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

    def _maybe_batch_sample_split(self, hr, lr_img):
        """96^3 -> 27 x 32^3 (reference trainer :724-728)."""
        cfg = self.configs
        if cfg is not None and cfg.train.batch_sample and hr.shape[1] != cfg.train.patch_size_sub:
            f = cfg.train.batch_sample_factor
            hr, lr_img = volume_to_subvolumes(hr, f), volume_to_subvolumes(lr_img, f)
        return hr, lr_img

    # ------------------------------------------------------------------
    def _loss(self, index: int, hr, lr_img, draws: Dict[str, Any]) -> torch.Tensor:
        # a base (unconditioned) cascade stage never sees the lowres batch
        # (JAX trainer.py:297-304)
        if not getattr(self.imagen.unets[index], "lowres_cond", True):
            lr_img = None
        out = self.imagen.forward(hr, lr_img, unet_number=index + 1,
                                  generator=self.generator, **draws)
        return out if self.is_elucidated else out[0]

    @staticmethod
    def microbatches(b: int, accum: int, max_batch_size: Optional[int] = None) -> int:
        """The number of microbatches a batch of ``b`` runs in (JAX
        trainer.py:410-416)."""
        if max_batch_size is not None:
            accum = max(accum, -(-b // max_batch_size))
        return accum if b % accum == 0 else 1

    def train_step(self, unet_number: Optional[int] = None,
                   max_batch_size: Optional[int] = None, batch=None, sync: bool = True,
                   draws: Optional[Sequence[Dict[str, Any]]] = None):
        """One optimizer step over ``batch=(hr, lr)`` (channels-last), else
        the next batch of the training loader. ``draws``: one dict of the
        wrapper's ``forward`` draws per microbatch. Returns the mean
        microbatch loss, a float, or with ``sync=False`` a device scalar
        (no host sync)."""
        unet_number = self.validate_unet_number(unet_number)
        index = unet_number - 1
        if batch is None:
            if self.train_dl is None:
                raise RuntimeError("training dataloader has not been registered with the trainer")
            if self._train_iter is None:
                self._train_iter = _cycle(self.train_dl)
            batch = next(self._train_iter)
        hr, lr_img = self._maybe_batch_sample_split(*self._device_batch(batch))
        self.prepare()

        b = hr.shape[0]
        accum = self.microbatches(b, self.gradient_accumulation_steps, max_batch_size)
        if draws is not None and len(draws) != accum:
            raise ValueError(f"{len(draws)} sets of draws for {accum} microbatches")
        mb = b // accum
        unet, opt = self.imagen.unets[index], self.optimizers[index]
        unet.train()
        opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss = self._loss(index, hr[sl], lr_img[sl], draws[i] if draws else {})
            loss.backward()
            loss_sum += loss.detach()

        # optax updates every leaf: a parameter without a gradient gets a
        # zero one, so its moments decay as in the JAX trainer
        params = list(unet.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        torch._foreach_div_(grads, float(accum))
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm)
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

        if self.checkpoint_path is not None and self.steps[index] % self.checkpoint_every == 0:
            self.save_to_checkpoint_folder()

        loss = loss_sum / accum
        return float(loss) if sync else loss

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
        PSNR of the merged volumes when the prediction is an x0 estimate."""
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
        losses, preds, noisy, hrs, lowres_list, ssims, psnrs = [], [], [], [], [], [], []
        for r in range(repeat):
            for batch in self.valid_dl:
                hr, lr_img = self._maybe_batch_sample_split(*self._device_batch(batch))
                if self.is_elucidated:
                    loss, pred, x_noisy, lowres_noisy = self.imagen.forward(
                        hr, lr_img, unet_number=index + 1, generator=generator,
                        return_outputs=True)
                else:
                    loss, pred, x_noisy, lowres_noisy = self.imagen.forward(
                        hr, lr_img, unet_number=index + 1, generator=generator)
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
        sub-volume groups; ``start_image_or_video`` is sliced per chunk.
        ``noise`` defaults to the trainer's generator."""
        imagen = self._sampling_imagen(use_ema=not use_non_ema)
        noise = noise or gaussian_noise(self.generator)
        group = self._sample_group_size()
        if max_batch_size is not None and group > 1:
            max_batch_size = max(max_batch_size // group, 1) * group
        if max_batch_size is None or batch_size <= max_batch_size:
            return imagen.sample(batch_size=batch_size, noise=noise, **kwargs)
        start = kwargs.pop("start_image_or_video", None)
        outs = []
        for lo in range(0, batch_size, max_batch_size):
            hi = min(lo + max_batch_size, batch_size)
            chunk = None if start is None else start[lo:hi]
            outs.append(imagen.sample(batch_size=hi - lo, noise=noise,
                                      start_image_or_video=chunk, **kwargs))
        return torch.cat(outs, dim=0)

    # ------------------------------------------------------------------
    def state_bundle(self) -> Dict[str, Any]:
        """The reference-format bundle (reference trainer.py:813-878)."""
        self.prepare()
        bundle: Dict[str, Any] = {
            "model": {f"unets.{i}.{k}": v for i, unet in enumerate(self.imagen.unets)
                      for k, v in unet.state_dict().items()},
            "steps": torch.tensor(self.steps),
            "generator": self.generator.get_state(),
        }
        for i, opt in enumerate(self.optimizers):
            bundle[f"optim{i}"] = opt.state_dict()
        if self.use_ema:
            ema: Dict[str, Any] = {}
            for i, unet in enumerate(self.ema_unets):
                ema.update({f"{i}.ema_model.{k}": v for k, v in unet.state_dict().items()})
                ema[f"{i}.step"] = torch.tensor(self.ema_steps[i])
            bundle["ema"] = ema
        return bundle

    def save(self, path: str):
        """Write the bundle to ``path`` (a ``.pt`` file), atomically."""
        if not self.prepared:
            raise RuntimeError("nothing to save: the trainer is not prepared")
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(self.state_bundle(), tmp)
        os.replace(tmp, path)

    def load(self, path: str, strict: bool = True, noop_if_not_exist: bool = False):
        """Restore a bundle written by :meth:`save`. ``strict=False`` keeps
        every current part the bundle lacks or holds at another shape
        (``utils/checkpoints.py::restore_parts``), as the ``pretrain`` path
        of ``train.py`` loads."""
        if not os.path.exists(path):
            if noop_if_not_exist:
                return
            raise FileNotFoundError(path)
        self.prepare()
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if not strict:
            raw = restore_parts(self.state_bundle(), raw)
        self._restore(raw, strict)

    def _restore(self, raw: Dict[str, Any], strict: bool) -> None:
        for i, unet in enumerate(self.imagen.unets):
            prefix = f"unets.{i}."
            unet.load_state_dict({k[len(prefix):]: v for k, v in raw["model"].items()
                                  if k.startswith(prefix)}, strict=strict)
            self.optimizers[i].load_state_dict(raw[f"optim{i}"])
            if self.use_ema and "ema" in raw:
                prefix = f"{i}.ema_model."
                self.ema_unets[i].load_state_dict(
                    {k[len(prefix):]: v for k, v in raw["ema"].items() if k.startswith(prefix)},
                    strict=strict)
                self.ema_steps[i] = int(raw["ema"].get(f"{i}.step", 0))
        self.steps = [int(s) for s in raw["steps"]]
        # a generator of another device type has a state of another size:
        # its stream cannot be continued here
        state = raw.get("generator")
        if state is not None and state.numel() == self.generator.get_state().numel():
            self.generator.set_state(state)

    # ------------------------------------------------------------------
    @property
    def all_checkpoints_sorted(self) -> List[str]:
        """The rolling folder's bundles, newest (most steps) first."""
        if self.checkpoint_path is None:
            return []
        found = [(int(m.group(1)), name) for name in os.listdir(self.checkpoint_path)
                 if (m := _CKPT_NAME.match(name))]
        return [os.path.join(self.checkpoint_path, name) for _, name in sorted(found, reverse=True)]

    def save_to_checkpoint_folder(self):
        """``checkpoint.{total steps}.pt``, keeping the newest
        ``max_checkpoints_keep`` (all with 0)."""
        self.save(os.path.join(self.checkpoint_path, f"checkpoint.{sum(self.steps)}.pt"))
        if self.max_checkpoints_keep > 0:
            for stale in self.all_checkpoints_sorted[self.max_checkpoints_keep:]:
                os.remove(stale)

    def load_from_checkpoint_folder(self, last_total_steps: int = -1):
        if last_total_steps != -1:
            self.load(os.path.join(self.checkpoint_path, f"checkpoint.{last_total_steps}.pt"))
            return
        ckpts = self.all_checkpoints_sorted
        if ckpts:
            self.load(ckpts[0])
