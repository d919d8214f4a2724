"""Config-driven model creation (counterpart of
``diffusioniqt_tpu/model_configs.py``; reference ``configs.py:44-181``).

The same JSON schemas as the JAX package, so a file written by either
package's ``cli.py config`` loads in the other: a U-Net stage
(:class:`UnetConfig`, kinds ``unet3d``, ``unet2d``, ``video`` and ``null``),
the Gaussian and EDM cascade wrappers (:class:`ImagenConfig`,
:class:`ElucidatedImagenConfig`) and the trainer (:class:`ImagenTrainerConfig`).
Each ``create`` takes the
``device`` the modules go to (``cuda`` unless told otherwise; raises if
CUDA is asked for and missing).

A ``unet3d`` stage's fields that a JSON leaves out take the JAX ``UNet3D``'s
defaults (``models/unet3d.py::JAX_DEFAULTS``), as the JAX ``create`` does
(a ``unet2d`` or ``video`` stage's are the port's ``UNet2D``'s or
``Unet3DVideo``'s, which are the JAX ones); the
cascade then sets each stage's conditioning as the JAX wrappers'
``cast_model_parameters`` does (stage 1 unconditioned, later stages
lowres-conditioned, ``channels`` and ``channels_out`` the wrapper's). The
compute dtype is ``kwargs["dtype"]`` (``"bfloat16"`` / ``"float32"``) when
given, else bf16 on the card, whose kernels take bf16, and fp32 on the CPU.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from diffusioniqt_tpu_torch.utils.misc import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _filter_kwargs(klass, kwargs: dict) -> dict:
    names = {f.name for f in fields(klass)}
    return {k: v for k, v in kwargs.items() if k in names}


def _signature_kwargs(fn, kwargs: dict) -> dict:
    names = set(inspect.signature(fn).parameters)
    return {k: v for k, v in kwargs.items() if k in names}


def _tuples(kw: dict) -> dict:
    """JSON lists -> tuples (the JAX schemas' tuple fields)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


@dataclass
class UnetConfig:
    """Schema for a single U-Net stage (reference configs.py:44-66)."""

    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    channels: int = 1
    kind: str = "unet3d"  # 'unet3d' | 'unet2d' | 'video' | 'null'
    kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: dict) -> "UnetConfig":
        known = _filter_kwargs(cls, raw)
        extra = {k: v for k, v in raw.items() if k not in known and k != "kwargs"}
        known.setdefault("kwargs", {}).update(extra)
        if isinstance(known.get("dim_mults"), list):
            known["dim_mults"] = tuple(known["dim_mults"])
        return cls(**known)

    def create(self, device="cuda", **overrides):
        """The stage's module on ``device``; ``overrides`` (the cascade's
        ``lowres_cond``, ``channels``, ``channels_out``) win over the JSON."""
        from diffusioniqt_tpu_torch.models.unet2d import UNet2D
        from diffusioniqt_tpu_torch.models.unet3d import JAX_DEFAULTS, NullUnet, UNet3D
        from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo

        device = resolve_device(device)
        if self.kind == "null":
            return NullUnet().to(device)
        kinds = {"unet3d": (UNet3D, JAX_DEFAULTS), "unet2d": (UNet2D, {}),
                 "video": (Unet3DVideo, {})}
        if self.kind not in kinds:
            raise ValueError(f"unknown U-Net kind {self.kind!r}")
        klass, defaults = kinds[self.kind]
        kw = _tuples(_signature_kwargs(klass.__init__, self.kwargs))
        dtype = kw.pop("dtype", None)
        kw["dtype"] = (_DTYPES[dtype] if dtype is not None
                       else torch.bfloat16 if device.type == "cuda" else torch.float32)
        model = klass(**{**defaults, "dim": self.dim, "dim_mults": self.dim_mults,
                         "channels": self.channels, **kw, **overrides})
        return model.to(device)


def _cascade(unets: List[dict], channels: int, device) -> list:
    """Each stage as the JAX wrappers cast it (gaussian.py:140-148)."""
    stages = []
    for i, raw in enumerate(unets):
        cfg = UnetConfig.from_dict(raw)
        cast = ({} if cfg.kind == "null"
                else dict(lowres_cond=i > 0, channels=channels, channels_out=channels))
        stages.append(cfg.create(device, **cast))
    return stages


@dataclass
class ImagenConfig:
    """Schema for the cascade wrapper (reference configs.py:68-106), passed
    to ``Imagen`` as the JAX ``create`` passes it."""

    unets: List[dict] = field(default_factory=list)
    image_sizes: Tuple[int, ...] = (32,)
    channels: int = 1
    timesteps: Union[int, Tuple[int, ...]] = 1000
    noise_schedules: Union[str, Tuple[str, ...]] = "cosine"
    pred_objectives: Union[str, Tuple[str, ...]] = "noise"
    loss_type: str = "l2"
    cond_drop_prob: float = 0.1
    auto_normalize_img: bool = False
    dynamic_thresholding: bool = True
    min_bound: float = 0.0
    norm: str = "z-score"
    batch_sample: bool = False

    @classmethod
    def from_dict(cls, raw: dict) -> "ImagenConfig":
        return cls(**_tuples(_filter_kwargs(cls, raw)))

    def create(self, device="cuda"):
        from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen

        return Imagen(
            _cascade(self.unets, self.channels, device), image_sizes=self.image_sizes,
            channels=self.channels, timesteps=self.timesteps,
            noise_schedules=self.noise_schedules, pred_objectives=self.pred_objectives,
            loss_type=self.loss_type, cond_drop_prob=self.cond_drop_prob,
            auto_normalize_img=self.auto_normalize_img,
            dynamic_thresholding=self.dynamic_thresholding, min_bound=self.min_bound,
            norm=self.norm, batch_sample=self.batch_sample)


@dataclass
class ElucidatedImagenConfig:
    """Schema for the EDM wrapper (reference configs.py:108-156);
    ``cond_drop_prob`` read and unused, as in :class:`ImagenConfig`."""

    unets: List[dict] = field(default_factory=list)
    image_sizes: Tuple[int, ...] = (32,)
    channels: int = 1
    cond_drop_prob: float = 0.1
    num_sample_steps: Union[int, Tuple[int, ...]] = 32
    sigma_min: Union[float, Tuple[float, ...]] = 0.002
    sigma_max: Union[float, Tuple[float, ...]] = 80.0
    sigma_data: Union[float, Tuple[float, ...]] = 0.5
    rho: Union[float, Tuple[float, ...]] = 7.0
    P_mean: Union[float, Tuple[float, ...]] = -1.2
    P_std: Union[float, Tuple[float, ...]] = 1.2
    S_churn: Union[float, Tuple[float, ...]] = 80.0
    S_tmin: Union[float, Tuple[float, ...]] = 0.05
    S_tmax: Union[float, Tuple[float, ...]] = 50.0
    S_noise: Union[float, Tuple[float, ...]] = 1.003
    auto_normalize_img: bool = True
    dynamic_thresholding: bool = True
    norm: str = "min-max"

    @classmethod
    def from_dict(cls, raw: dict) -> "ElucidatedImagenConfig":
        return cls(**_tuples(_filter_kwargs(cls, raw)))

    def create(self, device="cuda"):
        from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen

        kw = {f.name: getattr(self, f.name) for f in fields(self)
              if f.name not in ("unets", "cond_drop_prob")}
        return ElucidatedImagen(_cascade(self.unets, self.channels, device), **kw)


@dataclass
class ImagenTrainerConfig:
    """Schema for the trainer (reference configs.py:158-181)."""

    imagen: dict = field(default_factory=dict)
    elucidated: bool = False
    use_ema: bool = True
    lr: float = 1e-4
    eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.99
    max_grad_norm: Optional[float] = None
    gradient_accumulation_steps: int = 4
    warmup_steps: Optional[int] = None
    cosine_decay_max_steps: Optional[int] = None

    @classmethod
    def from_dict(cls, raw: dict) -> "ImagenTrainerConfig":
        return cls(**_filter_kwargs(cls, raw))

    def create(self, device="cuda"):
        from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

        wrapper = ElucidatedImagenConfig if self.elucidated else ImagenConfig
        imagen = wrapper.from_dict(self.imagen).create(device)
        return ImagenTrainer(
            imagen=imagen, use_ema=self.use_ema, lr=self.lr, eps=self.eps,
            beta1=self.beta1, beta2=self.beta2, max_grad_norm=self.max_grad_norm,
            gradient_accumulation_steps=self.gradient_accumulation_steps,
            warmup_steps=self.warmup_steps, cosine_decay_max_steps=self.cosine_decay_max_steps)
