"""Weights carried across from the JAX package (counterpart of
``diffusioniqt_tpu/utils/torch_convert.py``).

The port's modules use the reference ``Unet``'s parameter names, so the
JAX package's ``convert_iqt_unet_state_dict(port.state_dict())`` loads port
weights into its flax ``UNet3D``, and reference ``.pt`` files load into the
port with ``load_state_dict``. :func:`state_dict_from_jax_params` is the
inverse of ``convert_iqt_unet_state_dict`` for the models the port builds:
it turns a flax ``UNet3D`` parameter tree (numpy arrays, or anything
``np.asarray`` takes) into a port ``state_dict``. :func:`adam_state_from_optax`
maps optax Adam's ``mu`` / ``nu`` trees, which have the parameters' names,
the same way onto ``torch.optim.Adam``'s ``exp_avg`` / ``exp_avg_sq``.

The perceptual networks (``metrics/``) have no reference checkpoint of
their own layout in the repository: :func:`vgg16_state_dict_from_jax`,
:func:`lin_heads_from_jax`, :func:`resnet10_features_state_dict_from_jax`
and :func:`medicalnet_state_dict_from_jax` carry the JAX package's
parameters (its proxies' fixed-seed draws, or weights it loaded) into the
port's modules, so that both packages compute the same thing. The port's
own proxies draw their own init and do not give the JAX proxies' numbers.

Layout rules (the converter's, reversed): flax conv kernel
``(k1, .., kn, in, out)`` -> torch ``(out, in, k1, .., kn)``; flax Dense
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
    kernel = np.asarray(p["kernel"])
    nd = kernel.ndim - 2
    out[f"{key}.weight"] = _t(kernel.transpose(nd + 1, nd, *range(nd)))
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


def _find_adam_state(state):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    chain's state, found by its fields so that optax need not be imported."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax Adam state of a flax ``UNet3D`` (the JAX trainer's
    ``opt_states[i]``) -> per port parameter name, ``torch.optim.Adam``'s
    state: ``exp_avg`` from ``mu`` and ``exp_avg_sq`` from ``nu``, mapped by
    the names and layouts of :func:`state_dict_from_jax_params`, and
    ``step`` from ``count``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = state_dict_from_jax_params(adam.mu), state_dict_from_jax_params(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    return {k: {"step": step, "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}


# ---------------------------------------------------------------------------
# perceptual networks (metrics/lpips.py, perceptual.py, medicalnet.py)
# ---------------------------------------------------------------------------

def vgg16_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``VGG16Features`` variables (convs ``conv{block}_{i}``) -> port
    ``VGG16Features`` state dict (torchvision's ``features.{idx}`` keys)."""
    from diffusioniqt_tpu_torch.metrics.lpips import _TV_CONV_IDX

    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for bi, idxs in enumerate(_TV_CONV_IDX):
        for ci, idx in enumerate(idxs):
            _conv(p[f"conv{bi}_{ci}"], f"features.{idx}", out)
    return out


def lin_heads_from_jax(lin_weights) -> list:
    """The JAX ``LPIPS.lin_weights`` (five (C,) arrays) as fp32 tensors."""
    return [_t(np.asarray(w).reshape(-1)) for w in lin_weights]


def resnet10_features_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``ResNet10Features`` variables (``Conv_0``, ``GroupNorm_0``,
    ``_BasicBlock3D_{i}``) -> port ``ResNet10Features`` state dict."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _conv(p["Conv_0"], "stem", out)
    _layer_norm(p["GroupNorm_0"], "stem_norm", out)
    for i in range(4):
        blk = p[f"_BasicBlock3D_{i}"]
        _conv(blk["Conv_0"], f"blocks.{i}.conv1", out)
        _layer_norm(blk["GroupNorm_0"], f"blocks.{i}.norm1", out)
        _conv(blk["Conv_1"], f"blocks.{i}.conv2", out)
        _layer_norm(blk["GroupNorm_1"], f"blocks.{i}.norm2", out)
        if "Conv_2" in blk:
            _conv(blk["Conv_2"], f"blocks.{i}.downsample", out)
    return out


def medicalnet_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``MedicalNetResNet10`` variables (BN already folded to
    ``scale`` / ``bias``) -> port ``MedicalNetResNet10`` state dict, which
    has the same names."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, sub in tree.items():
            key = f"{prefix}{name}"
            if "kernel" in sub:
                _conv(sub, key, out)
            elif "scale" in sub:
                out[f"{key}.scale"] = _t(sub["scale"])
                out[f"{key}.bias"] = _t(sub["bias"])
            else:
                walk(sub, f"{key}.")

    walk(p, "")
    return out
