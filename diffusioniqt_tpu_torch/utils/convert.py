"""Weights carried across from the JAX package (counterpart of
``diffusioniqt_tpu/utils/torch_convert.py``).

The port's modules use the reference ``Unet``'s parameter names, so the
JAX package's ``convert_iqt_unet_state_dict(port.state_dict())`` loads port
weights into its flax ``UNet3D``, and reference ``.pt`` files load into the
port with ``load_state_dict``. :func:`state_dict_from_jax_params` is the
inverse of ``convert_iqt_unet_state_dict`` for the models the port builds:
it turns a flax ``UNet3D`` parameter tree (numpy arrays, or anything
``np.asarray`` takes) into a port ``state_dict``;
:func:`unet2d_state_dict_from_jax_params` does the same for ``UNet2D``,
:func:`video_state_dict_from_jax_params` for ``Unet3DVideo`` and
:func:`block_state_dict_from_jax_params` for the reference blocks outside
the U-Net (``StridedDownsample``, ``TrilinearUpsample``,
``UpsampleCombiner``). :func:`adam_state_from_optax`
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
to_out.{0,1}, patch_embed.*, reconstruct.{1,2}, to_context.{0,1}}`` with ChanFeedForward
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
    if "LayerNorm_0" in p:  # the text context's norm and projection
        _layer_norm(p["LayerNorm_0"], f"{key}.to_context.0", out)
        _dense(p["Dense_0"], f"{key}.to_context.1", out)


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


def _deconv(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    """flax ``DeconvUpsample`` (kernel ``(3, 3, 3, in, out)``, the spatially
    flipped transposed-conv weight) -> torch ``ConvTranspose3d`` ``(in, out,
    3, 3, 3)``: the inverse of the JAX converter's ``_deconv_upsample``."""
    kernel = np.asarray(p["kernel"])
    out[f"{key}.weight"] = _t(kernel.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1])
    out[f"{key}.bias"] = _t(p["bias"])


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``UNet3D`` variables (``{"params": ...}`` or the inner tree) ->
    port ``UNet3D`` ``state_dict`` (fp32 CPU tensors), every option's
    parameters included: the 3^3 or other-size stem (``init_conv``) or the
    cross-embed stem (``init_conv/Conv_{i}`` -> ``init_conv.convs.{i}``),
    the ``memory_efficient`` pre-downsample (``down{i}_pre`` ->
    ``downs.{i}.0.1``) and 1x1 post conv (``downs.{i}.4``), the pixel-shuffle
    (``ups.{i}.0.net.0``) or deconv (``ups.{i}.0.deconv.0``, kernel flipped)
    upsample. Raises ``KeyError`` on a parameter group the port has no
    module for."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    handled = set()

    def take(name):
        handled.add(name)
        return p[name]

    stem = take("init_conv")
    if "kernel" in stem:
        _conv(stem, "init_conv", out)
    else:  # the cross-embed stem, one conv per kernel size
        for i in range(len(stem)):
            _conv(stem[f"Conv_{i}"], f"init_conv.convs.{i}", out)
    out["to_time_hiddens.0.weights"] = _t(take("sinu_pos_emb")["weights"])
    _dense(take("time_hidden"), "to_time_hiddens.1", out)
    _dense(take("time_cond"), "to_time_cond.0", out)

    for name in sorted(p):
        if (m := re.fullmatch(r"down(\d+)_pre", name)):
            _conv(take(name)["Conv_0"], f"downs.{m.group(1)}.0.1", out)
        elif (m := re.fullmatch(r"down(\d+)_init", name)):
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
            up = take(name)
            if "Conv_0" in up:  # pixel-shuffle upsample
                _conv(up["Conv_0"], f"ups.{m.group(1)}.0.net.0", out)
            else:  # deconv upsample
                _deconv(up, f"ups.{m.group(1)}.0.deconv.0", out)
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


def block_state_dict_from_jax_params(kind: str, params: Dict[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """A flax ``StridedDownsample`` / ``TrilinearUpsample`` /
    ``UpsampleCombiner`` (``kind``, the class name) parameter tree -> the
    port module's ``state_dict``: the conv ``Conv_0`` -> ``weight`` /
    ``bias`` of the strided conv or ``1.*`` after the upsample; the
    combiner's ``Block_{i}`` -> ``fmap_convs.{i}``."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    if kind == "StridedDownsample":
        _conv(p["Conv_0"], "conv", out)
        return {k.split(".", 1)[1]: v for k, v in out.items()}
    if kind == "TrilinearUpsample":
        _conv(p["Conv_0"], "1", out)
    elif kind == "UpsampleCombiner":
        for name in p:
            if not (m := re.fullmatch(r"Block_(\d+)", name)):
                raise KeyError(f"unknown UpsampleCombiner parameter group {name}")
            _block(p[name], f"fmap_convs.{m.group(1)}", out)
    else:
        raise ValueError(f"no converter for {kind}")
    return out


def _resnet_block_2d(p: Dict[str, Any], key: str, out: Dict[str, torch.Tensor]) -> None:
    """flax ``ResnetBlock2D`` -> port ``ResnetBlock2D``: flax GroupNorm
    ``scale`` / ``bias`` -> ``groupnorm.weight`` / ``.bias``."""
    if "Dense_0" in p:
        _dense(p["Dense_0"], f"{key}.time_mlp.1", out)
    for i in (0, 1):
        blk = p[f"Block2D_{i}"]
        _conv(blk["Conv_0"], f"{key}.block{i + 1}.project", out)
        _layer_norm(blk["GroupNorm_0"], f"{key}.block{i + 1}.groupnorm", out)
    if "SE2D_0" in p:
        _dense(p["SE2D_0"]["Dense_0"], f"{key}.se.fc.0", out)
        _dense(p["SE2D_0"]["Dense_1"], f"{key}.se.fc.2", out)
    if "Conv_0" in p:
        _conv(p["Conv_0"], f"{key}.res_conv", out)


def unet2d_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``UNet2D`` variables (``{"params": ...}`` or the inner tree) ->
    port ``UNet2D`` ``state_dict`` (fp32 CPU tensors). The top-level names
    are the same in both (``init_conv``, ``down{i}_init``, ``down{i}_attn``,
    ``down{i}_block{j}``, ``down{i}_post``, ``mid_attn``, ``mid_block``,
    ``up{i}_upsample``, ``up{i}_init``, ``up{i}_block{j}``,
    ``final_res_block``, ``final_conv``); the time embedding's flax
    ``LearnedSinusoidalPosEmb_0`` / ``Dense_0`` / ``Dense_1`` go to
    ``to_time_hiddens.{0,1}`` / ``to_time_cond.0``. Raises ``KeyError`` on a
    parameter group the port has no module for."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    handled = set()

    def take(name):
        handled.add(name)
        return p[name]

    _conv(take("init_conv"), "init_conv", out)
    out["to_time_hiddens.0.weights"] = _t(take("LearnedSinusoidalPosEmb_0")["weights"])
    _dense(take("Dense_0"), "to_time_hiddens.1", out)
    _dense(take("Dense_1"), "to_time_cond.0", out)
    for name in sorted(p):
        if re.fullmatch(r"(down|up)\d+_(init|block\d+)|mid_block|final_res_block", name):
            _resnet_block_2d(take(name), name, out)
        elif re.fullmatch(r"down\d+_attn|mid_attn", name):
            attn = take(name)
            _chan_ln(attn["ChanLayerNorm_0"], f"{name}.norm", out)
            _conv(attn["Conv_0"], f"{name}.to_qkv", out)
            _conv(attn["Conv_1"], f"{name}.to_out", out)
            _chan_ln(attn["ChanLayerNorm_1"], f"{name}.out_norm", out)
        elif re.fullmatch(r"down\d+_post", name):
            post = take(name)  # the pixel-unshuffle's conv, or the last level's 1x1
            _conv(post.get("Conv_0", post), f"{name}.conv" if "Conv_0" in post else name, out)
        elif re.fullmatch(r"up\d+_upsample", name):
            _conv(take(name)["Conv_0"], f"{name}.conv", out)
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


# ---------------------------------------------------------------------------
# the video U-Net (models/unet_video.py)
# ---------------------------------------------------------------------------

class _Tree:
    """A flax parameter tree flattened to ``"a/b/kernel"`` paths, each
    marked as it is read, so a converter can fail on what it left unread."""

    def __init__(self, params: Dict[str, Any]):
        self.flat: Dict[str, Any] = {}
        self.read: set = set()

        def walk(tree, prefix):
            for name, sub in tree.items():
                if isinstance(sub, dict) or hasattr(sub, "items"):
                    walk(sub, f"{prefix}{name}/")
                else:
                    self.flat[f"{prefix}{name}"] = sub

        walk(params.get("params", params), "")

    def has(self, path: str) -> bool:
        return path in self.flat or any(k.startswith(path + "/") for k in self.flat)

    def count(self, path: str) -> int:
        """How many of ``path_0``, ``path_1``, ... the tree holds."""
        n = 0
        while self.has(f"{path}_{n}"):
            n += 1
        return n

    def get(self, path: str) -> np.ndarray:
        self.read.add(path)
        return np.asarray(self.flat[path])

    def conv(self, path: str, key: str, out) -> None:
        kernel = self.get(f"{path}/kernel")
        nd = kernel.ndim - 2
        out[f"{key}.weight"] = _t(kernel.transpose(nd + 1, nd, *range(nd)))
        if f"{path}/bias" in self.flat:
            out[f"{key}.bias"] = _t(self.get(f"{path}/bias"))

    def dense(self, path: str, key: str, out) -> None:
        out[f"{key}.weight"] = _t(self.get(f"{path}/kernel").T)
        if f"{path}/bias" in self.flat:
            out[f"{key}.bias"] = _t(self.get(f"{path}/bias"))

    def norm(self, path: str, key: str, out) -> None:
        """flax LayerNorm / GroupNorm ``scale`` / ``bias``."""
        out[f"{key}.weight"] = _t(self.get(f"{path}/scale"))
        out[f"{key}.bias"] = _t(self.get(f"{path}/bias"))

    def param(self, path: str, key: str, out) -> None:
        out[key] = _t(self.get(path))


def _v_attention(p: _Tree, path: str, key: str, out) -> None:
    """``VideoAttention``, its flax children in creation order: the input
    TokenLayerNorm, q and kv Denses, ``null_kv``, the context LayerNorm and
    Dense, the relative position bias and ``null_attn_bias``, the output
    Dense, then ``out_norm_zero`` + ``out_gate_zero`` or a TokenLayerNorm."""
    p.param(f"{path}/TokenLayerNorm_0/g", f"{key}.norm.g", out)
    p.dense(f"{path}/Dense_0", f"{key}.to_q", out)
    p.dense(f"{path}/Dense_1", f"{key}.to_kv", out)
    p.param(f"{path}/null_kv", f"{key}.null_kv", out)
    dense = 2
    if p.has(f"{path}/LayerNorm_0"):
        p.norm(f"{path}/LayerNorm_0", f"{key}.to_context.0", out)
        p.dense(f"{path}/Dense_2", f"{key}.to_context.1", out)
        dense = 3
    if p.has(f"{path}/DynamicPositionBias_0"):
        dpb = f"{path}/DynamicPositionBias_0"
        n = p.count(f"{dpb}/Dense")
        for i in range(n):  # Dense, TokenLayerNorm, SiLU per hidden layer
            p.dense(f"{dpb}/Dense_{i}", f"{key}.rel_pos_bias.mlp.{3 * i}", out)
            if i < n - 1:
                p.param(f"{dpb}/TokenLayerNorm_{i}/g", f"{key}.rel_pos_bias.mlp.{3 * i + 1}.g",
                        out)
        p.param(f"{path}/null_attn_bias", f"{key}.null_attn_bias", out)
    p.dense(f"{path}/Dense_{dense}", f"{key}.to_out", out)
    if p.has(f"{path}/out_gate_zero"):
        p.param(f"{path}/out_norm_zero/g", f"{key}.out_norm.g", out)
        p.param(f"{path}/out_gate_zero", f"{key}.out_gate", out)
    else:
        p.param(f"{path}/TokenLayerNorm_1/g", f"{key}.out_norm.g", out)


def _v_cross_attention(p: _Tree, path: str, key: str, out) -> None:
    for i, name in enumerate(("norm", "norm_context")):
        p.param(f"{path}/TokenLayerNorm_{i}/g", f"{key}.{name}.g", out)
    p.dense(f"{path}/Dense_0", f"{key}.to_q", out)
    p.dense(f"{path}/Dense_1", f"{key}.to_kv", out)
    p.param(f"{path}/null_kv", f"{key}.null_kv", out)
    p.dense(f"{path}/Dense_2", f"{key}.to_out", out)
    p.param(f"{path}/TokenLayerNorm_2/g", f"{key}.out_norm.g", out)


def _v_resnet(p: _Tree, path: str, key: str, out) -> None:
    """``VideoResnetBlock``: time Dense, VideoBlock_0, cross-attention,
    VideoBlock_1, GlobalContext, the 1x1 residual conv."""
    if p.has(f"{path}/Dense_0"):
        p.dense(f"{path}/Dense_0", f"{key}.time_mlp.1", out)
    for i in (0, 1):
        blk, k = f"{path}/VideoBlock_{i}", f"{key}.block{i + 1}"
        p.norm(f"{blk}/GroupNorm_0", f"{k}.groupnorm", out)
        p.conv(f"{blk}/PseudoConv3d_0/spatial", f"{k}.project.spatial", out)
        if p.has(f"{blk}/PseudoConv3d_0/temporal"):
            p.conv(f"{blk}/PseudoConv3d_0/temporal", f"{k}.project.temporal", out)
    if p.has(f"{path}/VideoCrossAttention_0"):
        _v_cross_attention(p, f"{path}/VideoCrossAttention_0", f"{key}.cross_attn", out)
    if p.has(f"{path}/GlobalContext_0"):
        for i, name in enumerate(("to_k", "net.0", "net.2")):
            p.conv(f"{path}/GlobalContext_0/Conv_{i}", f"{key}.gca.{name}", out)
    if p.has(f"{path}/Conv_0"):
        p.conv(f"{path}/Conv_0", f"{key}.res_conv", out)


def _v_transformer(p: _Tree, path: str, key: str, out) -> None:
    """``VideoTransformerBlock``: per depth d an attention (VideoAttention_d,
    or VideoCrossAttention_d when linear) and the feed-forward's
    ChanLayerNorm_{2d, 2d+1} and Dense_{2d, 2d+1}."""
    for d in range(max(p.count(f"{path}/VideoAttention"),
                       p.count(f"{path}/VideoCrossAttention"))):
        k = f"{key}.layers.{d}"
        if p.has(f"{path}/VideoAttention_{d}"):
            _v_attention(p, f"{path}/VideoAttention_{d}", f"{k}.0", out)
        else:
            _v_cross_attention(p, f"{path}/VideoCrossAttention_{d}", f"{k}.0", out)
        p.param(f"{path}/ChanLayerNorm_{2 * d}/g", f"{k}.1.0.g", out)
        p.dense(f"{path}/Dense_{2 * d}", f"{k}.1.1", out)
        p.param(f"{path}/ChanLayerNorm_{2 * d + 1}/g", f"{k}.1.3.g", out)
        p.dense(f"{path}/Dense_{2 * d + 1}", f"{k}.1.4", out)


def _v_perceiver(p: _Tree, path: str, key: str, out) -> None:
    """``PerceiverResampler``: ``pos_emb``, ``latents``, the mean-pooled
    latents' TokenLayerNorm_0 + Dense_0, then per layer d
    PerceiverAttention_d and its feed-forward (a TokenLayerNorm, two
    Denses)."""
    p.param(f"{path}/pos_emb", f"{key}.pos_emb", out)
    p.param(f"{path}/latents", f"{key}.latents", out)
    depth = p.count(f"{path}/PerceiverAttention")
    pooled = p.count(f"{path}/TokenLayerNorm") - depth  # 1 with mean-pooled latents
    if pooled:
        p.param(f"{path}/TokenLayerNorm_0/g", f"{key}.to_latents_from_mean_pooled.0.g", out)
        p.dense(f"{path}/Dense_0", f"{key}.to_latents_from_mean_pooled.1", out)
    for d in range(depth):
        att, k = f"{path}/PerceiverAttention_{d}", f"{key}.layers.{d}"
        for i, name in enumerate(("norm", "norm_latents")):
            p.norm(f"{att}/LayerNorm_{i}", f"{k}.0.{name}", out)
        for i, name in enumerate(("to_q", "to_kv", "to_out")):
            p.dense(f"{att}/Dense_{i}", f"{k}.0.{name}", out)
        p.norm(f"{att}/LayerNorm_2", f"{k}.0.out_norm", out)
        p.param(f"{path}/TokenLayerNorm_{pooled + d}/g", f"{k}.1.0.g", out)
        p.dense(f"{path}/Dense_{pooled + 2 * d}", f"{k}.1.1", out)
        p.dense(f"{path}/Dense_{pooled + 2 * d + 1}", f"{k}.1.3", out)


def video_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``Unet3DVideo`` variables (``{"params": ...}`` or the inner tree)
    -> port ``Unet3DVideo`` ``state_dict`` (fp32 CPU tensors).

    The JAX module names its stages (``down{i}_init``, ``mid_attn``, ...,
    which the port keeps) but leaves the rest to flax's automatic names,
    numbered per class in creation order: at the top ``Conv_{i}`` (the
    init conv, one per cross-embed kernel), ``TemporalPEG_0`` /
    ``TemporalAttention_0`` (the init temporal layers),
    ``LearnedSinusoidalPosEmb_{0,1}``, ``Dense_0..2`` (time hiddens, time
    tokens, time cond), ``Dense_3..5`` (their lowres counterparts), then
    the text Dense, ``PerceiverResampler_0``, ``LayerNorm_0`` and two
    Denses, and the conditioning ``LayerNorm``. This walks them in that
    order, and raises ``KeyError`` if any JAX parameter is left unread."""
    p = _Tree(params)
    out: Dict[str, torch.Tensor] = {}
    for i in range(p.count("Conv")):
        p.conv(f"Conv_{i}", f"init_conv.{i}", out)
    if p.has("TemporalPEG_0"):
        p.conv("TemporalPEG_0/Conv_0", "init_temporal_peg", out)
        _v_attention(p, "TemporalAttention_0/VideoAttention_0", "init_temporal_attn.attn", out)
    p.param("LearnedSinusoidalPosEmb_0/weights", "to_time_hiddens.0.weights", out)
    p.dense("Dense_0", "to_time_hiddens.1", out)
    p.dense("Dense_1", "to_time_tokens", out)
    p.dense("Dense_2", "to_time_cond", out)
    dense = 3
    if p.has("LearnedSinusoidalPosEmb_1"):
        p.param("LearnedSinusoidalPosEmb_1/weights", "to_lowres_time_hiddens.0.weights", out)
        p.dense("Dense_3", "to_lowres_time_hiddens.1", out)
        p.dense("Dense_4", "to_lowres_time_tokens", out)
        p.dense("Dense_5", "to_lowres_time_cond", out)
        dense = 6
    layer_norm = 0
    if p.has("null_text_embed"):
        p.dense(f"Dense_{dense}", "text_to_cond", out)
        p.param("null_text_embed", "null_text_embed", out)
        if p.has("PerceiverResampler_0"):
            _v_perceiver(p, "PerceiverResampler_0", "attn_pool", out)
        p.norm("LayerNorm_0", "to_text_non_attn_cond.0", out)
        p.dense(f"Dense_{dense + 1}", "to_text_non_attn_cond.1", out)
        p.dense(f"Dense_{dense + 2}", "to_text_non_attn_cond.3", out)
        p.param("null_text_hidden", "null_text_hidden", out)
        layer_norm = 1
    p.norm(f"LayerNorm_{layer_norm}", "norm_cond", out)

    names = sorted({path.split("/")[0] for path in p.flat})
    for name in names:
        if re.fullmatch(r"(down|up)\d+_(init|block\d+)|mid_block[12]|init_resnet_block"
                        r"|final_res_block", name):
            _v_resnet(p, name, name, out)
        elif re.fullmatch(r"(down|up)\d+_attn", name):
            _v_transformer(p, name, name, out)
        elif name == "mid_attn":
            _v_attention(p, name, name, out)
        elif re.fullmatch(r"(down|up|mid)\d*_peg", name):
            p.conv(f"{name}/Conv_0", name, out)
        elif re.fullmatch(r"(down|up|mid)\d*_tattn", name):
            _v_attention(p, f"{name}/VideoAttention_0", f"{name}.attn", out)
        elif re.fullmatch(r"down\d+_(pre|post|tdown)|up\d+_(tup|upsample)", name):
            p.conv(f"{name}/Conv_0", f"{name}.conv", out)
        elif re.fullmatch(r"down\d+_post_[ab]|final_conv", name):
            p.conv(name, name, out)

    unread = sorted(set(p.flat) - p.read)
    if unread:
        raise KeyError(f"JAX parameters the converter left unread: {unread}")
    return out
