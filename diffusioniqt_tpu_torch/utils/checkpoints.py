"""Partial restore of a checkpoint bundle (counterpart of
``diffusioniqt_tpu/utils/checkpoints.py::restore_parts``; reference
``restore_parts``, trainer.py:222-233), over the nested dicts and lists of
a ``.pt`` bundle rather than a JAX pytree."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, (torch.Tensor, np.ndarray)) else np.shape(x)


def restore_parts(target: Any, source: Any) -> Any:
    """``target`` with each leaf replaced by the ``source`` leaf at the same
    path (dict key or list position) when that leaf exists and has the same
    shape; every other leaf of ``target`` is kept, and what ``source`` holds
    beyond ``target``'s paths is dropped. Scalars have shape ``()``."""
    if isinstance(target, dict):
        if not isinstance(source, dict):
            return target
        return {k: restore_parts(v, source[k]) if k in source else v
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(source, (list, tuple)) or len(source) != len(target):
            return target
        return type(target)(restore_parts(t, s) for t, s in zip(target, source))
    if isinstance(source, (dict, list, tuple)) or _shape(source) != _shape(target):
        return target
    return source
