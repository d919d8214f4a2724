"""The port's perceptual networks and loss terms (diffusioniqt_tpu_torch/
metrics/perceptual.py, lpips.py, medicalnet.py, the converters of
utils/convert.py and the ``lpips_fn`` term of diffusion/gaussian.py)
against the JAX package at fp32, on the CPU at small sizes: slices resized
to 32^2, volumes of 8-16^3, the config.yaml U-Net (SAME convs, x_start) at
dim 8.

Both packages get the same seeded numpy inputs and the same weights: the
JAX modules' parameters, converted; or, for the loaders, torch state dicts
in the torchvision / ``lpips`` / MedicalNet key layouts that both
packages' loaders read. Tolerances: ``volume_to_slices`` 1e-6 of the
largest value (linear resize weights summed in other orders); network
features and losses 1e-5 relative (fp32 convs of up to 13 layers summed in
other orders); the perceptual loss's U-Net gradients 1e-4 of each tensor's
largest entry, as tests/test_torch_train.py holds the plain loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.metrics import lpips as jlpips
from diffusioniqt_tpu.metrics import medicalnet as jmed
from diffusioniqt_tpu.metrics import perceptual as jperc
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.metrics import lpips as tlpips
from diffusioniqt_tpu_torch.metrics import medicalnet as tmed
from diffusioniqt_tpu_torch.metrics import perceptual as tperc
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.utils import convert

torch.set_num_threads(1)

SIZE = 32  # slice edge the VGG sees here (224 in training)
MIN_BOUND = (0.0 - 271.64814106698583) / 377.117173547721  # config.yaml z-score


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _unif(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()) + 1e-12,
                               err_msg=what)


def _cl(feat: torch.Tensor) -> torch.Tensor:
    """A port feature map (N, C, ...) channels-last, as JAX returns it."""
    return feat.movedim(1, -1)


@pytest.fixture(scope="module")
def jax_lpips():
    """A JAX LPIPS: a seeded VGG and random lin heads with negative entries
    (the clamp at 0)."""
    lin = [_rand((ch,), 40 + i, 0.02) for i, (ch, _) in enumerate(jlpips._VGG16_BLOCKS)]
    vgg = _random_params(jlpips.VGG16Features(), jnp.zeros((1, SIZE, SIZE, 3)), seed=4)
    return jlpips.LPIPS(vgg_params=vgg, lin_weights=lin)


def _port_lpips(jmodel) -> tlpips.LPIPS:
    return tlpips.LPIPS(vgg_state=convert.vgg16_state_dict_from_jax(jax.device_get(jmodel.vgg_params)),
                        lin_weights=convert.lin_heads_from_jax(jmodel.lin_weights))


# ---------------------------------------------------------------------------
# perceptual.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edge", [12, 20])
def test_volume_to_slices_matches_jax(edge):
    """Coronal then sagittal stacks every 9 voxels, min-max over the whole
    (B, X, Y, 3) stack, bilinear upsampling to 32^2."""
    vol = _rand((2, edge, edge, edge, 1), edge, 3.0)
    want = np.asarray(jperc.volume_to_slices(jnp.asarray(vol), target_size=SIZE))
    got = tperc.volume_to_slices(torch.from_numpy(vol), target_size=SIZE)
    assert got.shape == want.shape == (2 * 2 * len(range(0, edge - 2, 9)), SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def _random_params(module, x, seed):
    """flax variables of ``module`` at input ``x`` from numpy: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if str(path[-1].key) == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("edge", [8, 9])
def test_resnet10_features_and_med_perceptual_match_jax(edge):
    """flax SAME at stride 2 pads (0, 1) / (2, 3) on an even extent and
    symmetrically on an odd one; GroupNorm eps 1e-6. The loss with a Gram
    style term."""
    model = jperc.ResNet10Features()
    params = _random_params(model, jnp.zeros((1, edge, edge, edge, 1)), seed=3)
    port = tperc.ResNet10Features()
    port.load_state_dict(convert.resnet10_features_state_dict_from_jax(jax.device_get(params)))
    pred, target = _rand((2, edge, edge, edge, 1), 1), _rand((2, edge, edge, edge, 1), 2)
    want = model.apply(params, jnp.asarray(pred))
    got = port(torch.from_numpy(pred))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(_cl(g).shape) == w.shape
        _close(_cl(g), w, 1e-5, f"tap {i}")
    jloss = jperc.MedPerceptualLoss(params=params, style_weight=0.5)
    tloss = tperc.MedPerceptualLoss(state=port.state_dict(), style_weight=0.5)
    _close(tloss(torch.from_numpy(pred), torch.from_numpy(target)),
           jloss(jnp.asarray(pred), jnp.asarray(target)), 1e-5)


# ---------------------------------------------------------------------------
# lpips.py
# ---------------------------------------------------------------------------

def test_vgg16_taps_and_lpips_match_jax(jax_lpips):
    a, b = _unif((4, SIZE, SIZE, 3), 5), _unif((4, SIZE, SIZE, 3), 6)
    port = _port_lpips(jax_lpips)
    x = (jnp.asarray(a) * 2.0 - 1.0 - jnp.asarray(jlpips._SHIFT)) / jnp.asarray(jlpips._SCALE)
    want = jax_lpips.net.apply(jax_lpips.vgg_params, x)
    got = port.net(port._prep(torch.from_numpy(a)))
    assert [tuple(_cl(g).shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_cl(g), w, 1e-5, f"tap {i}")
    _close(port(torch.from_numpy(a), torch.from_numpy(b)),
           jax_lpips(jnp.asarray(a), jnp.asarray(b)), 1e-5)


def test_lpips_volume_metric_matches_jax(jax_lpips):
    """Central window of axis 1, every 10th slice, each min-max normalised
    on its own (eps 1e-12); 32 x 40 x 32 volumes give four 32^2 slices."""
    gt, pred = _rand((SIZE, 40, SIZE), 7), _rand((SIZE, 40, SIZE), 8)
    want = jlpips.lpips_volume_metric(gt, pred, jax_lpips)
    got = tlpips.lpips_volume_metric(gt, pred, _port_lpips(jax_lpips))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _torchvision_state(jmodel, form: str) -> dict:
    """The JAX model's VGG convs and lin heads as a torch state dict in one
    of the key forms the loaders read."""
    feats = convert.vgg16_state_dict_from_jax(jax.device_get(jmodel.vgg_params))
    sd = {}
    for key, v in feats.items():
        idx, part = key.split(".")[1:]
        block = next(bi for bi, idxs in enumerate(jlpips._TV_CONV_IDX) if int(idx) in idxs)
        prefix = {"torchvision": f"features.{idx}", "bare": idx,
                  "lpips": f"net.slice{block + 1}.{idx}"}[form]
        sd[f"{prefix}.{part}"] = v
    lin_key = {"torchvision": "lin{i}.model.1.weight", "bare": "lins.{i}.model.1.weight",
               "lpips": "net.lin{i}.model.1.weight"}[form]
    for i, w in enumerate(convert.lin_heads_from_jax(jmodel.lin_weights)):
        sd[lin_key.format(i=i)] = w.reshape(1, -1, 1, 1)
    return sd


@pytest.mark.parametrize("form", ["torchvision", "bare", "lpips"])
def test_lpips_loaders_read_every_key_form(jax_lpips, form, tmp_path):
    """Both loaders on a state dict in each key form; the checkpoint file
    gives both packages the same LPIPS."""
    sd = _torchvision_state(jax_lpips, form)
    vgg = tlpips.load_torch_vgg16(sd)
    want = convert.vgg16_state_dict_from_jax(jlpips.load_torch_vgg16(
        {k: v.numpy() for k, v in sd.items()}))
    assert vgg.keys() == want.keys() == tlpips.VGG16Features().state_dict().keys()
    assert all(torch.equal(vgg[k], want[k]) for k in want)
    lin = tlpips.load_torch_lpips(sd)
    for got, w in zip(lin, jlpips.load_torch_lpips({k: v.numpy() for k, v in sd.items()})):
        np.testing.assert_array_equal(got.numpy(), w)
    path = str(tmp_path / "lpips.pt")
    torch.save(sd, path)
    a, b = _unif((4, SIZE, SIZE, 3), 9), _unif((4, SIZE, SIZE, 3), 10)
    _close(tlpips.lpips_from_torch_checkpoint(path)(torch.from_numpy(a), torch.from_numpy(b)),
           jlpips.lpips_from_torch_checkpoint(path)(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    without_lin = {k: v for k, v in sd.items() if "lin" not in k}
    torch.save(without_lin, path)
    port = tlpips.lpips_from_torch_checkpoint(path)
    assert torch.equal(port.lin1, torch.full((128,), 1.0 / 128))
    with pytest.raises(KeyError, match="features.28"):
        tlpips.load_torch_vgg16({k: v for k, v in sd.items() if not k.endswith(("28.weight",))})


# ---------------------------------------------------------------------------
# medicalnet.py
# ---------------------------------------------------------------------------

def _medicalnet_checkpoint(seed: int) -> dict:
    """A MedicalNet ResNet-10 state dict in the checkpoint's own layout
    (``conv1``, ``bn1``, ``layer{i}.0.*``, ``downsample.{0,1}``) with
    seeded weights and BN statistics."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin) + (k,) * 3) * (cin * k ** 3) ** -0.5)
            .astype(np.float32))

    def bn(key, c):
        sd[f"{key}.weight"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
        sd[f"{key}.running_mean"] = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
        sd[f"{key}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 1, 7)
    bn("bn1", 64)
    cin = 64
    for i, c in enumerate((64, 128, 256, 512)):
        name = f"layer{i + 1}.0"
        conv(f"{name}.conv1", c, cin, 3)
        bn(f"{name}.bn1", c)
        conv(f"{name}.conv2", c, c, 3)
        bn(f"{name}.bn2", c)
        if c != cin:
            conv(f"{name}.downsample.0", c, cin, 1)
            bn(f"{name}.downsample.1", c)
        cin = c
    return sd


@pytest.mark.parametrize("wrap", ["plain", "module", "state_dict"])
def test_medicalnet_loader_and_features_match_jax(wrap):
    """The loader folds each BN from its running statistics (eps 1e-5),
    strips ``module.`` and unwraps ``state_dict``; the six block outputs
    of the folded trunk, and the converter of the JAX params, agree."""
    sd = _medicalnet_checkpoint(11)
    if wrap in ("module", "state_dict"):
        sd = {f"module.{k}": v for k, v in sd.items()}
    if wrap == "state_dict":
        sd = {"state_dict": sd, "epoch": 3}
    state = tmed.load_medicalnet_state_dict(sd)
    jparams = jmed.load_medicalnet_state_dict(
        {k: v.numpy() for k, v in sd["state_dict"].items()} if wrap == "state_dict"
        else {k: v.numpy() for k, v in sd.items()})
    assert state.keys() == tmed.MedicalNetResNet10().state_dict().keys()
    for k, v in convert.medicalnet_state_dict_from_jax(jparams).items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    port = tmed.MedicalNetResNet10()
    port.load_state_dict(state)
    x = _rand((2, 12, 12, 12, 1), 12)
    want = jmed.MedicalNetResNet10().apply(jparams, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(_cl(g).shape) == w.shape
        _close(_cl(g), w, 1e-5, f"block output {i}")


@pytest.mark.parametrize("resize,style", [(True, ()), (False, (0, 1))])
def test_medicalnet_perceptual_matches_jax(resize, style, tmp_path):
    """The loss on 8^3 volumes: 2x trilinear resize (jax.image.resize's
    weights), L1 taps at relu1 / layer1 / layer2, un-normalised Gram taps
    on request; and the same loss read from a checkpoint file."""
    sd = _medicalnet_checkpoint(13)
    jparams = jmed.load_medicalnet_state_dict({k: v.numpy() for k, v in sd.items()})
    pred, target = _rand((2, 8, 8, 8, 1), 14), _rand((2, 8, 8, 8, 1), 15)
    want = jmed.MedicalNetPerceptual(params=jparams, resize=resize, style_layers=style)(
        jnp.asarray(pred), jnp.asarray(target))
    port = tmed.MedicalNetPerceptual(state=tmed.load_medicalnet_state_dict(sd), resize=resize,
                                     style_layers=style)
    _close(port(torch.from_numpy(pred), torch.from_numpy(target)), want, 1e-5)
    path = str(tmp_path / "resnet_10.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    if not style:
        from_file = tmed.medicalnet_perceptual_from_checkpoint(path, resize=resize)
        _close(from_file(torch.from_numpy(pred), torch.from_numpy(target)),
               jmed.medicalnet_perceptual_from_checkpoint(path, resize=resize)(
                   jnp.asarray(pred), jnp.asarray(target)), 1e-5)


def test_perceptual_networks_are_frozen_and_seeded():
    """No parameter asks for a gradient; one seed gives one proxy, another
    seed another."""
    for net in (tlpips.LPIPS(), tmed.MedicalNetPerceptual(), tperc.MedPerceptualLoss()):
        assert not any(p.requires_grad for p in net.parameters())
    a, b = tlpips.VGG16Features(seed=0), tlpips.VGG16Features(seed=0)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    c = tlpips.VGG16Features(seed=1)
    assert not torch.equal(a.features[0].weight, c.features[0].weight)
    w = a.features[28].weight
    assert float(w.abs().max()) <= 2 * (512 * 9) ** -0.5 / 0.87962566103423978 + 1e-7


# ---------------------------------------------------------------------------
# the loss term in Imagen.p_losses, and its gradients
# ---------------------------------------------------------------------------

B, EDGE = 2, 8
SHAPE = (B, EDGE, EDGE, EDGE, 1)
# config/config.yaml's U-Net at dim 8: SAME convs (no boundary halo), SE
UNET_KW = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
               resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=False, batch_sample=False, img_size=EDGE)
G_KW = dict(image_sizes=(EDGE, EDGE), channels=1, timesteps=1000, dynamic_thresholding=False,
            min_bound=MIN_BOUND, norm="z-score", batch_sample=False,
            pred_objectives="x_start", p2_loss_weight_gamma=0.0)


def _unet_params(module, seed):
    """flax variables of ``module``: kernels N(0, 1/fan_in), biases and
    norm shifts N(0, 0.01), norm scales 1 + N(0, 0.01), the rest N(0, 1)."""
    x, t = jnp.zeros(SHAPE), jnp.zeros((B,))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, t, t,
                                                lowres_cond_img=x))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        if name in ("bias", "norm_bias"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "norm_scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def loss_terms(jax_lpips, tmp_path_factory):
    """The two terms as each package builds them: VGG-LPIPS through
    ``make_lpips_fn`` from one checkpoint file (slices at 32^2), MedicalNet
    from one seeded checkpoint."""
    path = str(tmp_path_factory.mktemp("lpips") / "vgg.pt")
    torch.save(_torchvision_state(jax_lpips, "torchvision"), path)
    sd = _medicalnet_checkpoint(17)
    jmed_params = jmed.load_medicalnet_state_dict({k: v.numpy() for k, v in sd.items()})
    return {
        "lpips": (jlpips.make_lpips_fn(weights_path=path, target_size=SIZE),
                  tlpips.make_lpips_fn(weights_path=path, target_size=SIZE)),
        "medlpips": (jmed.MedicalNetPerceptual(params=jmed_params),
                     tmed.MedicalNetPerceptual(state=tmed.load_medicalnet_state_dict(sd))),
    }


@pytest.mark.parametrize("term", ["lpips", "medlpips"])
def test_p_losses_with_perceptual_term_match_jax(loss_terms, term):
    """``loss + 0.1 * term(clamped pred, x_start)`` and its gradient with
    respect to every U-Net parameter, against ``jax.grad`` of the JAX
    p_losses; the term alone, on the same prediction."""
    jfn, tfn = loss_terms[term]
    junet = JUNet3D(**UNET_KW, att_type="linear", dtype=jnp.float32)
    params = _unet_params(junet, seed=21)
    x, low, noise = _rand(SHAPE, 22), _rand(SHAPE, 23), _rand(SHAPE, 24)
    times = np.asarray([0.3, 0.8], np.float32)
    jg = JImagen([JNullUnet(), junet], lpips_fn=jfn, cond_drop_prob=0.0, **G_KW)

    def jloss(p):
        loss, pred, _, _ = jg.p_losses(junet, p, jax.random.PRNGKey(0), jnp.asarray(x),
                                       jnp.asarray(times), noise_scheduler=jg.noise_schedulers[1],
                                       lowres_cond_img=jnp.asarray(low), noise=jnp.asarray(noise),
                                       pred_objective="x_start", p2_loss_weight_gamma=0.0)
        return loss, pred

    (want_loss, want_pred), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    unet = UNet3D(**UNET_KW)
    unet.load_state_dict(convert.state_dict_from_jax_params(jax.device_get(params)))
    imagen = Imagen([NullUnet(), unet], lpips_fn=tfn, **G_KW)
    loss, pred, _, _ = imagen.p_losses(unet, _t(x), _t(times),
                                       noise_scheduler=imagen.noise_schedulers[1],
                                       lowres_cond_img=_t(low), noise=_t(noise),
                                       pred_objective="x_start")
    _close(pred, want_pred, 1e-5)
    assert float(pred.detach().min()) >= MIN_BOUND
    _close(tfn(pred.detach(), _t(x)), jfn(jnp.asarray(want_pred), jnp.asarray(x)), 1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    plain = Imagen([NullUnet(), unet], **G_KW).p_losses(
        unet, _t(x), _t(times), noise_scheduler=imagen.noise_schedulers[1],
        lowres_cond_img=_t(low), noise=_t(noise), pred_objective="x_start")[0]
    assert float(loss.detach() - plain.detach()) > 0  # the term is in the loss
    unet.zero_grad(set_to_none=True)
    loss.backward()
    want = convert.state_dict_from_jax_params(jax.device_get(want_grads))
    got = {k: p.grad for k, p in unet.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-9, err_msg=k)


@pytest.mark.parametrize("flag", ["lpips", "medlpips"])
def test_train_entry_point_trains_config_yaml_with_the_term(flag, tmp_path, monkeypatch):
    """``python -m diffusioniqt_tpu_torch.train --config config/config.yaml
    --fake-data --device cpu`` with ``Train.lpips`` / ``Train.medlpips``
    (dim 8, 8^3 patches, batches of 2; the VGG sees 32^2 slices): two steps
    with finite losses, validation, and bundles that hold the U-Net only."""
    import yaml

    from diffusioniqt_tpu_torch.diffusion import gaussian
    from diffusioniqt_tpu_torch.train import __main__ as train_main

    make = gaussian.make_lpips_fn
    monkeypatch.setattr(gaussian, "make_lpips_fn", lambda **kw: make(target_size=SIZE, **kw))
    raw = yaml.safe_load(open("config/config.yaml"))
    raw["Train"].update(dim=8, init_dim=8, dim_mults=[1, 2], num_resnet_blocks=[1, 1],
                        resnet_groups=4, patch_size_sub=EDGE, compute_dtype="float32",
                        att_enc=[False, False], batch_size=2, **{flag: True})
    raw["Eval"].update(batch_size=2, repeat=1)
    raw["Results"] = str(tmp_path / "results")
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    train_main.main(["--config", str(cfg_path), "--fake-data", "--device", "cpu",
                     "--steps", "2", "--eval-every", "1"])
    project = tmp_path / "results" / raw["ProjectName"]
    losses = (project / "train_log" / "train_loss.csv").read_text().splitlines()
    assert len(losses) == 3 and all(np.isfinite(float(v)) for v in losses[1:])
    valid = (project / "train_log" / "valid_loss.csv").read_text().splitlines()
    assert valid[0] == "loss,ssim,psnr" and len(valid) == 3
    bundle = torch.load(project / "model" / "last_checkpoint.pt", map_location="cpu",
                        weights_only=True)
    unet_keys = {f"unets.1.{k}" for k in UNet3D(**UNET_KW).state_dict()}
    assert {k for k in bundle["model"] if k.startswith("unets.1.")} == unet_keys
    assert all(k.startswith(("unets.0.", "unets.1.")) for k in bundle["model"])


def test_config_wires_the_term(jax_lpips, tmp_path):
    """``perceptual_loss_from_config`` as JAX gaussian.py:629-647 chooses:
    MedicalNet wins over VGG-LPIPS; a weights path in the config is read;
    without one, the fixed-seed proxy; neither flag, no term."""
    from diffusioniqt_tpu_torch.config import load_config
    from diffusioniqt_tpu_torch.diffusion.gaussian import perceptual_loss_from_config

    cfg = load_config("config/config.yaml")
    assert perceptual_loss_from_config(cfg) is None
    cfg.train.lpips = True
    proxy = perceptual_loss_from_config(cfg)
    assert isinstance(proxy, tlpips.SliceLPIPS) and proxy.target_size == 224
    assert torch.equal(proxy.model.net.features[0].weight,
                       tlpips.VGG16Features(seed=0).features[0].weight)
    vgg_path = str(tmp_path / "vgg.pt")
    torch.save(_torchvision_state(jax_lpips, "bare"), vgg_path)
    cfg.train.lpips_weights = vgg_path
    loaded = perceptual_loss_from_config(cfg)
    want = convert.vgg16_state_dict_from_jax(jax.device_get(jax_lpips.vgg_params))
    assert all(torch.equal(loaded.model.net.state_dict()[k], v) for k, v in want.items())
    assert torch.equal(loaded.model.lin2, convert.lin_heads_from_jax(jax_lpips.lin_weights)[2])
    cfg.train.medlpips = True
    assert isinstance(perceptual_loss_from_config(cfg), tmed.MedicalNetPerceptual)
    sd = _medicalnet_checkpoint(19)
    med_path = str(tmp_path / "resnet_10_23dataset.pth")
    torch.save({"state_dict": sd}, med_path)
    cfg.train.medlpips_weights = med_path
    term = perceptual_loss_from_config(cfg)
    folded = tmed.load_medicalnet_state_dict(sd)
    assert all(torch.equal(term.model.state_dict()[k], v) for k, v in folded.items())
