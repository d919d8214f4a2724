"""Weights carried across from the JAX package (counterpart of
``diffusioniqt_tpu/utils/torch_convert.py``).

The port's modules use the reference ``Unet``'s parameter names, so the
JAX package's ``convert_iqt_unet_state_dict(port.state_dict())`` loads port
weights into its flax ``UNet3D``, and reference ``.pt`` files load into the
port with ``load_state_dict``. :func:`state_dict_from_jax_params` is the
inverse of ``convert_iqt_unet_state_dict`` for the models the port builds:
it turns a flax ``UNet3D`` parameter tree (numpy arrays, or anything
``np.asarray`` takes) into a port ``state_dict``.

Layout rules (the converter's, reversed): flax conv kernel
``(k1, k2, k3, in, out)`` -> torch ``(out, in, k1, k2, k3)``; flax Dense
kernel ``(in, out)`` -> torch Linear ``(out, in)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _dense(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _block(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    _conv(p["Conv_0"], f"{key}.project", out)
    out[f"{key}.groupnorm.weight"] = _t(p["norm_scale"])
    out[f"{key}.groupnorm.bias"] = _t(p["norm_bias"])


def _resnet_block(p: Dict[str, Any], key: str,
                  out: Dict[str, torch.Tensor]) -> None:
    if "Dense_0" in p:
        _dense(p["Dense_0"], f"{key}.time_mlp.1", out)
    _block(p["Block_0"], f"{key}.block1", out)
    _block(p["Block_1"], f"{key}.block2", out)
    if "SE3D_0" in p:
        _dense(p["SE3D_0"]["Dense_0"], f"{key}.se.fc.0", out)
        _dense(p["SE3D_0"]["Dense_1"], f"{key}.se.fc.2", out)
    if "Conv_0" in p:
        _conv(p["Conv_0"], f"{key}.res_conv", out)


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``UNet3D`` variables (``{"params": ...}`` or the inner tree) ->
    port ``UNet3D`` ``state_dict`` (fp32 CPU tensors). Raises ``KeyError``
    on a parameter group the port has no module for (attention, the
    cross-embed stem, ``memory_efficient`` pre-downsampling)."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    handled = set()

    def take(name):
        handled.add(name)
        return p[name]

    _conv(take("init_conv"), "init_conv", out)
    out["to_time_hiddens.0.weights"] = _t(take("sinu_pos_emb")["weights"])
    _dense(take("time_hidden"), "to_time_hiddens.1", out)
    _dense(take("time_cond"), "to_time_cond.0", out)

    for name in sorted(p):
        if (m := re.fullmatch(r"down(\d+)_init", name)):
            _resnet_block(take(name), f"downs.{m.group(1)}.1", out)
        elif (m := re.fullmatch(r"down(\d+)_block(\d+)", name)):
            _resnet_block(take(name), f"downs.{m.group(1)}.3.{m.group(2)}", out)
        elif (m := re.fullmatch(r"down(\d+)_post", name)):
            post = take(name)
            if "Conv_0" in post:  # SP-conv downsample
                _conv(post["Conv_0"], f"downs.{m.group(1)}.4.1", out)
            else:  # plain 1x1 conv of the last level
                _conv(post, f"downs.{m.group(1)}.4", out)
        elif (m := re.fullmatch(r"up(\d+)_upsample", name)):
            _conv(take(name)["Conv_0"], f"ups.{m.group(1)}.0.net.0", out)
        elif (m := re.fullmatch(r"up(\d+)_init", name)):
            _resnet_block(take(name), f"ups.{m.group(1)}.1", out)
        elif (m := re.fullmatch(r"up(\d+)_block(\d+)", name)):
            _resnet_block(take(name), f"ups.{m.group(1)}.2.{m.group(2)}", out)
        elif name in ("mid_block", "final_res_block"):
            _resnet_block(take(name), name, out)
        elif name == "final_conv":
            _conv(take(name), name, out)

    unknown = sorted(set(p) - handled)
    if unknown:
        raise KeyError(f"parameter groups the port has no module for: {unknown}")
    return out
