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
kernel ``(in, out)`` -> torch Linear ``(out, in)``; flax LayerNorm
``scale``/``bias`` -> ``weight``/``bias``; ChanLayerNorm ``g`` as is.

Attention slots (``down{i}_attn`` -> ``downs.{i}.2``, ``mid_attn``) take
the reference's names for all three families: LinearAttention /
SoftMaxAttention ``layers.{d}.0.{norm, to_q.{1,2}, to_k, to_v,
to_out.{0,1}, patch_embed.*, reconstruct.{1,2}}`` with ChanFeedForward
``layers.{d}.1.{0,1,3,4}``; ViT3D ``patch_embedding.*``,
``transformer_encoder.layers.{d}.block.*``, ``reconstruction.{0,3,4}``.
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


def _chan_ln(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.g"] = _t(p["g"])


def _layer_norm(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _dsconv(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    _conv(p["Conv_0"], f"{key}.depthwise", out)
    _conv(p["Conv_1"], f"{key}.pointwise", out)


def _voxel_attention(p: Dict[str, Any], key: str,
                     out: Dict[str, torch.Tensor]) -> None:
    """flax LinearAttention / SoftMaxAttention (same parameter tree)."""
    if "Patchify_0" in p:
        _chan_ln(p["Patchify_0"]["ChanLayerNorm_0"], f"{key}.patch_embed.norm", out)
        _dsconv(p["Patchify_0"]["DepthwiseSeparableConv_0"],
                f"{key}.patch_embed.projection", out)
        _dsconv(p["PatchReconstruct_0"]["DepthwiseSeparableConv_0"],
                f"{key}.reconstruct.1", out)
        _chan_ln(p["PatchReconstruct_0"]["ChanLayerNorm_0"], f"{key}.reconstruct.2", out)
    _chan_ln(p["ChanLayerNorm_0"], f"{key}.norm", out)
    for i, proj in enumerate(("to_q", "to_k", "to_v")):
        _conv(p[f"_QKVConv_{i}"]["Conv_0"], f"{key}.{proj}.1", out)
        _conv(p[f"_QKVConv_{i}"]["Conv_1"], f"{key}.{proj}.2", out)
    _conv(p["Conv_0"], f"{key}.to_out.0", out)
    _chan_ln(p["ChanLayerNorm_1"], f"{key}.to_out.1", out)


def _chan_feed_forward(p: Dict[str, Any], key: str,
                       out: Dict[str, torch.Tensor]) -> None:
    _chan_ln(p["ChanLayerNorm_0"], f"{key}.0", out)
    _conv(p["Conv_0"], f"{key}.1", out)
    _chan_ln(p["ChanLayerNorm_1"], f"{key}.3", out)
    _conv(p["Conv_1"], f"{key}.4", out)


def _vit3d(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    _dsconv(p["DepthwiseSeparableConv_0"], f"{key}.patch_embedding.projection.0", out)
    out[f"{key}.patch_embedding.positions"] = _t(p["positions"])
    d = 0
    while f"TransformerEncoderBlock_{d}" in p:
        blk = p[f"TransformerEncoderBlock_{d}"]
        k = f"{key}.transformer_encoder.layers.{d}.block"
        _layer_norm(blk["LayerNorm_0"], f"{k}.0.fn.0", out)
        _dense(blk["MultiHeadAttention_0"]["Dense_0"], f"{k}.0.fn.1.qkv", out)
        _dense(blk["MultiHeadAttention_0"]["Dense_1"], f"{k}.0.fn.1.projection", out)
        _layer_norm(blk["LayerNorm_1"], f"{k}.1.fn.0", out)
        ff = blk["FeedForwardBlock_0"]
        if "Dense_0" in ff:
            _dense(ff["Dense_0"], f"{k}.1.fn.1.net.0", out)
            _dense(ff["Dense_1"], f"{k}.1.fn.1.net.3", out)
        else:  # LocalViT conv feed-forward
            _conv(ff["Conv_0"], f"{k}.1.fn.1.net.0.1", out)
            _dsconv(ff["DepthwiseSeparableConv_0"], f"{k}.1.fn.1.net.1.0", out)
            _conv(ff["Conv_1"], f"{k}.1.fn.1.net.2.0", out)
        d += 1
    _layer_norm(p["LayerNorm_0"], f"{key}.reconstruction.0", out)
    _dsconv(p["DepthwiseSeparableConv_1"], f"{key}.reconstruction.3", out)
    _chan_ln(p["ChanLayerNorm_0"], f"{key}.reconstruction.4", out)


def _attn_module(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    """One attention slot: ViT3D (it has ``positions``) or an
    AttentionTransformerBlock of Linear/SoftMax attention layers."""
    if "positions" in p:
        _vit3d(p, key, out)
        return
    for name in p:
        if (m := re.fullmatch(r"(?:LinearAttention|SoftMaxAttention)_(\d+)", name)):
            _voxel_attention(p[name], f"{key}.layers.{m.group(1)}.0", out)
        elif (m := re.fullmatch(r"ChanFeedForward_(\d+)", name)):
            _chan_feed_forward(p[name], f"{key}.layers.{m.group(1)}.1", out)
        else:
            raise KeyError(f"unknown attention parameter group {key}/{name}")


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
    on a parameter group the port has no module for (the cross-embed stem,
    ``memory_efficient`` pre-downsampling)."""
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
        elif (m := re.fullmatch(r"down(\d+)_attn", name)):
            _attn_module(take(name), f"downs.{m.group(1)}.2", out)
        elif name == "mid_attn":
            _attn_module(take(name), name, out)
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
