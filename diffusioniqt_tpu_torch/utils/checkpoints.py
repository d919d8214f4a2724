"""Model bundles and partial restores (counterpart of
``diffusioniqt_tpu/utils/checkpoints.py``; reference ``utils.py:15-61`` and
``restore_parts``, trainer.py:222-233).

A model bundle is a directory holding

  * ``imagen_meta.json`` - the wrapper type (``imagen_type``: ``elucidated``
    or ``original``), ``num_unets``, ``image_sizes``, ``channels`` and the
    caller's ``extra`` config, the JAX bundle's keys
  * ``state.pt`` - ``{"params": [state dict per unet], "ema": [...]}``
    (``ema`` only when given), in place of the JAX bundle's orbax
    ``state/`` tree

:func:`load_imagen_checkpoint` checks the wrapper type and every unet's
names and shapes, and swaps the EMA weights in on request, as the
reference's ``load_imagen_from_checkpoint`` does. :func:`restore_parts`
works over the nested dicts and lists of a ``.pt`` bundle rather than a
JAX pytree.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

StateDicts = List[Dict[str, torch.Tensor]]


def _imagen_type(imagen) -> str:
    from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen

    return "elucidated" if isinstance(imagen, ElucidatedImagen) else "original"


def _cpu(state_dicts: StateDicts) -> StateDicts:
    return [{k: v.detach().cpu() for k, v in sd.items()} for sd in state_dicts]


def save_imagen_checkpoint(path: str, imagen, state_dicts: StateDicts,
                           ema: Optional[StateDicts] = None,
                           extra_config: Optional[dict] = None) -> None:
    """Write the bundle of ``imagen`` (an ``Imagen`` or ``ElucidatedImagen``)
    with one state dict per unet (and the EMA's, when given) into the
    directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = {"imagen_type": _imagen_type(imagen), "num_unets": len(imagen.unets),
            "image_sizes": [int(s) for s in imagen.image_sizes], "channels": imagen.channels,
            "extra": extra_config or {}}
    with open(os.path.join(path, "imagen_meta.json"), "w") as fh:
        json.dump(meta, fh)
    state = {"params": _cpu(state_dicts)}
    if ema is not None:
        state["ema"] = _cpu(ema)
    torch.save(state, os.path.join(path, "state.pt"))


def _check_like(loaded: StateDicts, imagen, what: str) -> None:
    if len(loaded) != len(imagen.unets):
        raise ValueError(f"{what}: {len(loaded)} unets in the bundle, "
                         f"{len(imagen.unets)} in the wrapper")
    for i, (sd, unet) in enumerate(zip(loaded, imagen.unets)):
        want = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:8]
            raise ValueError(f"{what} of unet {i + 1} does not fit the wrapper's: {diff}")


def load_imagen_checkpoint(path: str, imagen, load_ema_if_available: bool = False
                           ) -> Tuple[StateDicts, Optional[StateDicts]]:
    """``(state_dicts, ema_state_dicts)`` of the bundle at ``path`` for the
    pre-built ``imagen`` (names and shapes checked against its unets; the
    EMA's None when the bundle has none). With ``load_ema_if_available``
    the EMA weights are returned as the main ones too (the reference's EMA
    swap, utils.py:45-59)."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "imagen_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        want = _imagen_type(imagen)
        assert meta["imagen_type"] == want, (
            f"checkpoint holds a {meta['imagen_type']} imagen, got a {want} wrapper")
    state = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    params, ema = state["params"], state.get("ema")
    _check_like(params, imagen, "params")
    if ema is not None:
        _check_like(ema, imagen, "ema")
    if load_ema_if_available and ema is not None:
        params = ema
    return params, ema


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
