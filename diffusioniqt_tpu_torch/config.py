"""Typed configuration for the PyTorch port (a copy of
``diffusioniqt_tpu/config.py``).

The port keeps its own copy because importing ``diffusioniqt_tpu.config``
runs ``diffusioniqt_tpu/__init__.py``, which imports JAX.
``tests/test_torch_config.py`` holds the two copies field-equal on every
file under ``config/``.

One dataclass-backed config covering both training and evaluation, loaded
from the reference YAML schema (sections
``ProjectName/Model/File/Results/Data/Train/Eval``; reference
``config/config.yaml:1-59``).

Known reference quirk handled here: ``use_se: True,`` (trailing comma) parses
as the *string* ``"True,"`` in YAML (reference ``config/config.yaml:50``).
``_coerce_bool`` normalises such values to real booleans.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import yaml


def _coerce_bool(val: Any) -> bool:
    """Coerce YAML-quirk values ('True,', 'false', 1, ...) to bool."""
    if isinstance(val, bool):
        return val
    if isinstance(val, (int, float)):
        return bool(val)
    if isinstance(val, str):
        s = val.strip().strip(",").lower()
        if s in ("true", "yes", "1", "on"):
            return True
        if s in ("false", "no", "0", "off", ""):
            return False
        # any other non-empty string is truthy (matches the reference, which
        # uses the raw value in a boolean context)
        return True
    return bool(val)


@dataclass
class DataConfig:
    """Mirrors the ``Data`` section (reference ``config/config.yaml:6-16``)."""

    groundtruth_path: str = ""
    lowres_path: str = ""
    groundtruth_path_test: str = ""
    lowres_path_test: str = ""
    groundtruth_fname: str = "T1w_acpc_dc_restore_brain"
    mean: float = 271.64814106698583
    std: float = 377.117173547721
    mean_hr: float = 259.3117656881453
    std_hr: float = 362.1817760568698
    norm: str = "z-score"  # 'z-score' | 'min-max'

    @property
    def min_bound(self) -> float:
        """Z-score of raw intensity 0 — the lower clamp used throughout
        sampling/losses (reference ``train.py:72``)."""
        if self.norm == "min-max":
            return -1.0
        return (0.0 - self.mean) / self.std


@dataclass
class TrainConfig:
    """Mirrors the ``Train`` section (reference ``config/config.yaml:18-51``)."""

    pretrain: bool = False
    pred_obj: str = "x_start"  # 'noise' | 'x_start' | 'v'
    timesteps: int = 1000
    batch_sample: bool = False
    batch_sample_factor: int = 3
    lpips: bool = False
    lpips_weights: str = ""  # optional torch VGG16/LPIPS checkpoint path
    medlpips: bool = False
    medlpips_weights: str = ""  # optional MedicalNet resnet_10 .pth path
    boundary: bool = False
    att_type: str = "linear"  # 'linear' | 'softmax' | 'vit'
    att_mid: bool = False
    att_head_dim: int = 64
    att_mid_depth: int = 1
    att_mid_heads: int = 8
    att_enc: Tuple[bool, ...] = (False, False, False)
    att_enc_depth: Tuple[int, ...] = (1, 1, 1)
    att_enc_heads: Tuple[int, ...] = (8, 8, 8)
    att_drop: float = 0.0
    att_forward_drop: float = 0.0
    att_forward_expansion: int = 2
    num_groups: int = 1
    att_localvit: bool = False
    skip_scale: bool = False
    emb_size: int = 256
    efficient: bool = False  # memory_efficient unet (pre-downsample)
    patch_size_sub: int = 32
    pretrain_model: str = ""
    batch_size: int = 27
    save_file: str = "train_loss.csv"
    save_model: str = "3dimagen.pt"
    save_last_model: str = "last_checkpoint.pt"
    dynamic_threshold: bool = False
    use_se: bool = True
    deep_feature: bool = False

    # --- framework-native additions (not in the reference YAML) ---
    # Model hyperparameters that the reference hardcodes in train.py:83-116.
    dim: int = 64
    init_dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    num_resnet_blocks: Tuple[int, ...] = (2, 2, 2)
    channels: int = 1
    resnet_groups: int = 8
    lr: float = 1e-4
    ema_decay: float = 0.9999
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    gradient_accumulation_steps: int = 4
    max_grad_norm: Optional[float] = None
    warmup_steps: Optional[int] = None
    cosine_decay_max_steps: Optional[int] = None
    seed: int = 42
    compute_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    # EDM (ElucidatedImagen) variant for the SR stage — a capability the
    # reference ships but never wires into its entry scripts
    elucidated: bool = False
    edm_num_sample_steps: int = 32
    edm_sigma_min: float = 0.002
    edm_sigma_max: float = 80.0
    edm_sigma_data: float = 0.5
    edm_rho: float = 7.0
    edm_s_churn: float = 80.0
    # noise the lowres conditioning image (training aug + sampling). The
    # upstream text-to-image ElucidatedImagen does (reference
    # elucidated_imagen.py:779-819 train aug, :620-633 sample); the 3D IQT
    # path does NOT — its Gaussian wrapper passes the conditioning clean in
    # both phases (reference imagen_pytorch3D.py:2303-2304) because in IQT
    # the lowres input is the entire signal, not an auxiliary hint. Default
    # False = IQT semantics; True restores the upstream aug for text/video.
    edm_lowres_noise_aug: bool = False
    # cap on Heun steps per device launch during EDM sampling in the JAX
    # package (a TPU-runtime workaround; numerically identical).
    # None = one launch.
    edm_steps_per_launch: Optional[int] = 16
    # rematerialize ResnetBlocks on backward (activation memory lever)
    remat: bool = False
    # remat policy: None = full-block recompute (max memory savings);
    # 'conv' = save conv inputs/outputs and recompute only the cheap
    # GN/Mish/SE chain on backward — near-zero FLOP recompute at ~half
    # the activation-memory savings
    remat_policy: Optional[str] = None
    # host->device batch transfer dtype ('bfloat16' halves H2D bytes —
    # decisive on slow links; inputs are cast to the bf16 compute dtype
    # on-device anyway, only loss targets see the quantization)
    transfer_dtype: Optional[str] = None
    # exp-weighted non-uniform sampling timesteps (the reference's
    # commented-out capability, imagen_pytorch3D.py:268-288 + :2098)
    non_uniform_sampling: bool = False
    non_uniform_gamma: float = 10.0
    # Pallas fused-block kernel (ops.pallas.fused_block). Off by default:
    # measured on v5e, the im2col-in-VMEM kernel runs the flagship block
    # unit at ~68 ms vs ~24.6 ms for the XLA chain (XLA's conv lowering is
    # ~2.8x faster than the Pallas im2col core at 216x32^3 c64) — see PERF.md
    use_pallas: bool = False

    @property
    def patch_size(self) -> int:
        """Effective extracted patch edge (reference ``data.py:59-62``)."""
        if self.batch_sample:
            return self.patch_size_sub * self.batch_sample_factor
        return self.patch_size_sub


@dataclass
class EvalConfig:
    """Mirrors the ``Eval`` section (reference ``config/config.yaml:53-59``)."""

    batch_size: int = 27
    repeat: int = 5
    overlap: int = 48
    save_file: str = "valid_loss.csv"
    save_file2: str = "valid_loss_full.csv"
    save_imgs: str = "figures/"


@dataclass
class Config:
    project_name: str = "diffusioniqt_tpu_run/"
    model_dir: str = "model/"
    file_dir: str = "train_log/"
    results_dir: str = "./results/"
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        """Build from a reference-schema YAML dict."""
        cfg = cls()
        cfg.project_name = raw.get("ProjectName", cfg.project_name)
        cfg.model_dir = raw.get("Model", cfg.model_dir)
        cfg.file_dir = raw.get("File", cfg.file_dir)
        cfg.results_dir = raw.get("Results", cfg.results_dir)
        cfg.data = _fill_section(DataConfig, raw.get("Data", {}))
        cfg.train = _fill_section(TrainConfig, raw.get("Train", {}))
        cfg.eval = _fill_section(EvalConfig, raw.get("Eval", {}))
        return cfg

    def to_dict(self) -> dict:
        """Round-trip back to the reference YAML schema."""
        return {
            "ProjectName": self.project_name,
            "Model": self.model_dir,
            "File": self.file_dir,
            "Results": self.results_dir,
            "Data": dataclasses.asdict(self.data),
            "Train": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(self.train).items()
            },
            "Eval": dataclasses.asdict(self.eval),
        }


_BOOL_FIELDS = {
    "pretrain", "batch_sample", "lpips", "medlpips", "boundary", "att_mid",
    "att_localvit", "skip_scale", "efficient", "dynamic_threshold", "use_se",
    "deep_feature", "use_pallas", "elucidated", "remat",
    "non_uniform_sampling", "edm_lowres_noise_aug",
}


def _fill_section(klass, section: dict):
    """Populate a dataclass from a raw dict, coercing quirky YAML values."""
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(klass)}
    for key, val in section.items():
        if key not in names:
            continue  # unknown keys ignored, like the reference's dict access
        f = names[key]
        if key in _BOOL_FIELDS:
            val = _coerce_bool(val)
        elif key == "att_enc":
            val = tuple(_coerce_bool(v) for v in val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[key] = val
    return klass(**kwargs)


def load_config(path: str) -> Config:
    """Load a reference-schema YAML config file."""
    with open(path, "r") as fh:
        raw = yaml.safe_load(fh)
    return Config.from_dict(raw)
