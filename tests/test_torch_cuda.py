"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: the kernels have no CPU mode, so on a
machine without one each test skips with that reason. The file imports
only ``torch`` and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)
"""

import copy

import numpy as np
import pytest
import torch

from diffusioniqt_tpu_torch.data.stitching import VolumeStitcher, sliding_window_grid
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.ops.kernels import fused_block as tfb
from diffusioniqt_tpu_torch.ops.kernels.conv3d import pack_weight, pack_weight_small
from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher, gather_windows
from diffusioniqt_tpu_torch.train.ema import ema_update
from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

pytestmark = pytest.mark.cuda

# |kernel - plain| <= BF16_TOL * max|plain|: both round fp32 sums to bf16
# (2^-9 relative each) after summing in different orders
BF16_TOL = 2.0 ** -7
# gradients through the kernels against the plain path: the same plain VJPs
# fed by forwards that round to bf16 in other orders. Readings on an H100
# (torch 2.11) for the attention U-Net's train step below, which vary from
# run to run: worst tensor 0.999974 (a q projection behind the flash
# kernel) and 0.999865 (an SE gate's weight) in two runs; the limit leaves
# about 15x room in 1 - cosine above the worse one.
GRAD_TENSOR_COS_MIN = 0.998
# one Block's gradients, its backward against autograd through the table
# composition: the same function at fp32, with bf16 roundings at other places
GRAD_BLOCK_COS_MIN = 0.999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol_rel=BF16_TOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol_rel * want.float().abs().max().item(), err


# every vector width of the row-wise copy (1 to 16 bytes a vector, the
# interior run starting C elements into the row) at factor 1 and 3
_HALO_WIDTHS = [(2 * f ** 3, 8, c, f) for c in (1, 2, 3, 4, 8, 64, 192) for f in (1, 3)]


@pytest.mark.parametrize("n,s,c,factor", [(54, 8, 2, 3), (27, 4, 64, 3),
                                          (27, 8, 192, 3), (2, 6, 3, 1)] + _HALO_WIDTHS)
def test_halo_equals_plain(dev, n, s, c, factor):
    x = torch.randn((n, s, s, s, c), device=dev).to(torch.bfloat16)
    kernels.reset_launch_counts()
    got = kernels.halo_exchange(x, factor)
    assert kernels.launch_counts()["halo"] == 1
    torch.testing.assert_close(got, kernels.halo_exchange_plain(x, factor), rtol=0, atol=0)


@pytest.mark.parametrize("s,cin,cout", [(8, 2, 64), (16, 64, 64), (24, 64, 128),
                                        (8, 192, 128), (16, 128, 64)])
def test_conv_and_fused_match_plain(dev, s, cin, cout):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((27, s, s, s, cin), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (27 * cin) ** -0.5
    xh = kernels.halo_exchange(x, 3)
    _close(kernels.conv3d_valid(xh, w), kernels.conv3d_valid_plain(xh, w))
    groups = 8 if cin % 8 == 0 else 1
    ss = tuple(0.2 * torch.randn((27, 1, 1, 1, cin), generator=g, device=dev)
               for _ in range(2))
    a, b = tfb.groupnorm_affine(x, torch.ones(cin, device=dev),
                                torch.zeros(cin, device=dev), groups, scale_shift=ss)
    ta, tb = tfb.neighbor_tables(a, b, 3)
    _close(kernels.fused_conv(xh, ta, tb, w), kernels.fused_conv_plain(xh, ta, tb, w))


def _fused_case(dev, s, cin, cout, seed, n=27):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, s, s, s, cin), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (27 * cin) ** -0.5
    groups = 8 if cin % 8 == 0 else 1
    ss = tuple(0.2 * torch.randn((n, 1, 1, 1, cin), generator=g, device=dev)
               for _ in range(2))
    a, b = tfb.groupnorm_affine(x, 1.0 + 0.1 * torch.randn(cin, generator=g, device=dev),
                                0.1 * torch.randn(cin, generator=g, device=dev), groups,
                                scale_shift=ss)
    ta, tb = tfb.neighbor_tables(a, b, 3)
    return kernels.halo_exchange(x, 3), ta, tb, w


@pytest.mark.parametrize("cin,cout", [(2, 64), (16, 16), (64, 64), (128, 64), (192, 128),
                                      (256, 256)])
@pytest.mark.parametrize("s", [8, 16, 32])
def test_fused_kernel_matches_plain(dev, s, cin, cout):
    """The wgmma GEMM at both BN (64, 128; Cout 16 as padded columns), one
    to four 64-channel chunks (Cin 2 and 16 with zero-filled channels), the
    plain-load brick (Cin = 2) and the TMA brick, at every sub-volume edge
    of the path."""
    xh, ta, tb, w = _fused_case(dev, s, cin, cout, seed=s * 1000 + cin + cout)
    kernels.reset_launch_counts()
    got = kernels.fused_conv(xh, ta, tb, w)
    assert kernels.launch_counts()["fused_block"] == 1
    _close(got, kernels.fused_conv_plain(xh, ta, tb, w))


@pytest.mark.parametrize("s,cin,cout", [(16, 64, 64), (8, 72, 32), (8, 12, 16)])
def test_wide_conv_route_matches_plain(dev, s, cin, cout):
    """conv3d's implicit-GEMM route: the fused kernel's GEMM without Mish;
    Cin = 72 is one full and one partial 64-channel chunk, Cout = 32 half a
    BN = 64 tile; Cin = 12 takes the plain-load brick."""
    g = torch.Generator(device=dev).manual_seed(cin + cout)
    xh = torch.randn((27, s + 2, s + 2, s + 2, cin), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (27 * cin) ** -0.5
    _close(kernels.conv3d_valid(xh, w), kernels.conv3d_valid_plain(xh, w))


@pytest.mark.parametrize("cin", [16, 192])
def test_fused_kernel_after_nan(dev, cin):
    """A launch on NaN input, then a clean one: the channels past Cin of a
    64-channel chunk (Cin = 16) and the second brick buffer never carry
    stale NaN into the product."""
    xh, ta, tb, w = _fused_case(dev, 16, cin, 64, seed=cin)
    kernels.fused_conv(torch.full_like(xh, float("nan")), ta, tb, w)
    got = kernels.fused_conv(xh, ta, tb, w)
    assert torch.isfinite(got).all()
    _close(got, kernels.fused_conv_plain(xh, ta, tb, w))


@pytest.mark.parametrize("s,cin,cout", [(8, 1, 16), (8, 2, 16), (8, 3, 16), (8, 8, 16),
                                        (8, 1, 64), (8, 2, 64), (8, 3, 64), (8, 8, 64),
                                        (32, 2, 64)])
def test_small_cin_conv_matches_plain(dev, s, cin, cout):
    """The init conv's route (dense K) at the test widths and at the main
    path's sub-volume edge."""
    g = torch.Generator(device=dev).manual_seed(cin * 100 + cout)
    xh = torch.randn((27, s + 2, s + 2, s + 2, cin), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (27 * cin) ** -0.5
    kernels.reset_launch_counts()
    _close(kernels.conv3d_valid(xh, w), kernels.conv3d_valid_plain(xh, w))
    assert kernels.launch_counts()["conv3d"] == 1


def test_small_cin_conv_large_values_and_after_nan(dev):
    """|x| up to 1e4, then a launch after one whose input held NaN: the K
    padding never multiplies stale shared memory."""
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((64, 2, 3, 3, 3), generator=g, device=dev) * 0.1
    bad = torch.full((27, 10, 10, 10, 2), float("nan"), device=dev).to(torch.bfloat16)
    kernels.conv3d_valid(bad, w)
    xh = (1e4 * torch.rand((27, 10, 10, 10, 2), generator=g, device=dev) * 2 - 1e4)
    xh = xh.to(torch.bfloat16)
    got = kernels.conv3d_valid(xh, w)
    assert torch.isfinite(got).all()
    _close(got, kernels.conv3d_valid_plain(xh, w))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xh = torch.randn((27, 10, 10, 10, 64), device=dev)
    w = torch.randn((64, 64, 3, 3, 3), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.conv3d_valid(xh, w)
    xb = xh.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv3d_valid(xb.transpose(1, 2), w)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.conv3d_valid(xb[:, :6, :6, :6].contiguous(), w)
    with pytest.raises(ValueError, match="tables"):
        tab = torch.zeros((27, 27, 64), device=dev, dtype=torch.float64)
        kernels.fused_conv(xb, tab, tab, w)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [64, 100, 129, 1728])
def test_flash_attention_matches_plain(dev, n, d):
    """n = 64 and 100: one partial 128-row tile of queries and keys; 129:
    one full tile and one row; 1728: the main path's 13.5 tiles. B = 16
    with a ragged n catches rows of one head read as the next head's."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (torch.randn((16, n, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kernels.reset_launch_counts()
    got = kernels.flash_attention(q, k, v, d ** -0.5)
    assert kernels.launch_counts()["flash_attention"] == 1
    _close(got, kernels.attention_plain(q, k, v, d ** -0.5))


def test_flash_attention_more_keys_than_queries(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((16, 100, 64), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((16, 1728, 64), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    _close(kernels.flash_attention(q, k, v, 0.125), kernels.attention_plain(q, k, v, 0.125))


def test_flash_attention_refuses_what_the_kernel_does_not_take(dev):
    q = torch.randn((4, 64, 48), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        kernels.flash_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.flash_attention(q.float()[..., :32], q.float()[..., :32],
                                q.float()[..., :32], 0.1)


def test_small_attention_unet_runs_through_the_kernels(dev):
    torch.manual_seed(0)
    model = UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                   resnet_groups=4, img_size=48, att_type="softmax", attn_dim_head=32,
                   attend_at_enc=(True, True), attend_at_enc_heads=2, deep_feature=True,
                   attend_at_middle=True, attend_at_middle_heads=2,
                   dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn((54, 16, 16, 16, 1), device=dev)
    lowres = torch.randn_like(x)
    t = torch.full((54,), 0.5, device=dev)
    log_snr = torch.full((54,), -1.0, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = model(x, t, log_snr, lowres_cond_img=lowres)
        counts = kernels.launch_counts()
        want = model.use_ops(kernels.PLAIN)(x, t, log_snr, lowres_cond_img=lowres)
    # 2 levels x (init + 1 block) down and up, the mid block, the final block
    n_res = 2 * 2 + 1 + 2 * 2 + 1
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res,
                      "flash_attention": 3}
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


def test_small_unet_runs_through_the_kernels(dev):
    torch.manual_seed(0)
    model = UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(2, 2),
                   resnet_groups=4, dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn((27, 16, 16, 16, 1), device=dev)
    lowres = torch.randn_like(x)
    t = torch.full((27,), 0.5, device=dev)
    log_snr = torch.full((27,), -1.0, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = model(x, t, log_snr, lowres_cond_img=lowres)
        counts = kernels.launch_counts()
        want = model.use_ops(kernels.PLAIN)(x, t, log_snr, lowres_cond_img=lowres)
    # 2 levels x (init + 2 blocks) down and up, plus the final block
    n_res = 2 * 3 + 2 * 3 + 1
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res,
                      "flash_attention": 0}
    assert torch.isfinite(got).all()
    # bf16 rounding differences compound through the network
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


def test_edm_heun_step_through_the_kernels(dev):
    """One EDM sampler call of two steps (one corrected Heun step, one Euler
    step: 3 forwards) over a small U-Net, through the kernels and through
    the plain versions with the same noise."""
    torch.manual_seed(0)
    model = UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(2, 2),
                   resnet_groups=4, dtype=torch.bfloat16).to(dev).eval()
    imagen = ElucidatedImagen([NullUnet(), model], image_sizes=(16, 16), channels=1,
                              auto_normalize_img=False, dynamic_thresholding=False,
                              norm="z-score", min_bound=-0.72, num_sample_steps=2,
                              lowres_noise_aug=False)
    lowres = torch.randn((27, 16, 16, 16, 1), generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)

    def run():
        noise = gaussian_noise(torch.Generator(device=dev).manual_seed(2))
        return imagen.sample(batch_size=27, noise=noise, start_at_unet_number=2,
                             start_image_or_video=lowres)

    kernels.reset_launch_counts()
    got = run()
    counts = kernels.launch_counts()
    model.use_ops(kernels.PLAIN)
    want = run()
    n_res = 2 * 3 + 2 * 3 + 1
    assert counts == {"halo": 3 * (2 * n_res + 1), "conv3d": 3, "fused_block": 3 * 2 * n_res,
                      "flash_attention": 0}
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


@pytest.mark.parametrize("mode", ["trim", "gaussian"])
def test_device_stitcher_on_the_card_matches_host(dev, mode):
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((64, 64, 64)).astype(np.float32)
    starts = sliding_window_grid(vol.shape, 32, 16)
    host = VolumeStitcher(vol.shape, 32, 16, mode=mode, fill_value=-0.5)
    stitcher = DeviceVolumeStitcher(vol.shape, 32, 16, mode=mode, fill_value=-0.5, device=dev)
    windows = gather_windows(torch.from_numpy(vol).to(dev), starts, 32)
    assert windows.is_cuda
    preds = windows[..., 0] * 2.0 + 1.0
    for b in range(0, len(starts), 8):
        stitcher.add_batch(preds[b:b + 8], starts[b:b + 8])
    for p, idx in zip(preds.cpu().numpy(), starts):
        host.add(p, idx)
    got, want = stitcher.result(), host.result()
    if mode == "trim":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _small_unet(dev, seed=0, **kw):
    torch.manual_seed(seed)
    return UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                  resnet_groups=4, dtype=torch.bfloat16, **kw).to(dev)


def _inputs(dev, n=27, edge=16):
    g = torch.Generator(device=dev).manual_seed(1)
    x, lowres = (torch.randn((n, edge, edge, edge, 1), generator=g, device=dev) for _ in range(2))
    t = torch.full((n,), 0.5, device=dev)
    return x, lowres, t


def _assert_packs_fresh(model):
    """Every cached pack equals a fresh pack of its weight, and the kernel
    forward agrees with the plain one."""
    for m in model.modules():
        if not hasattr(m, "_packed"):
            continue
        assert torch.equal(m._packed._packed, pack_weight(m.project.weight)), m
    assert torch.equal(model._init_packed._packed, pack_weight_small(model.init_conv.weight))


def _kernel_vs_plain(model, x, lowres, t):
    with torch.no_grad():
        got = model.use_ops(kernels.KERNELS)(x, t, t, lowres_cond_img=lowres)
        _assert_packs_fresh(model)
        want = model.use_ops(kernels.PLAIN)(x, t, t, lowres_cond_img=lowres)
        model.use_ops(kernels.KERNELS)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2
    return got


@pytest.mark.parametrize("impl", ["foreach", "fused", "trainer"])
def test_no_stale_pack_after_optimizer_ema_and_load(dev, impl):
    """The packed-weight caches follow an optimizer step (a foreach or a
    fused Adam step followed by the version bump that
    ImagenTrainer.train_step makes, or a whole train_step), an EMA lerp and
    load_state_dict: after each, every cached pack equals a fresh pack of
    its weight and the kernel forward equals the plain one. The steps are
    large (lr 0.5) so that a stale pack would show."""
    model = _small_unet(dev)
    x, lowres, t = _inputs(dev)
    before = _kernel_vs_plain(model, x, lowres, t)
    if impl == "trainer":
        imagen = ElucidatedImagen([NullUnet(), model], image_sizes=(16, 16), channels=1,
                                  auto_normalize_img=False, dynamic_thresholding=False,
                                  norm="z-score", min_bound=-0.72, lowres_noise_aug=False)
        trainer = ImagenTrainer(None, imagen, lr=0.5, gradient_accumulation_steps=1)
        trainer.train_step(unet_number=2, batch=(x, lowres))
    else:
        params = list(model.parameters())
        opt = torch.optim.Adam(params, lr=0.5, foreach=impl == "foreach", fused=impl == "fused")
        model(x, t, t, lowres_cond_img=lowres).square().mean().backward()
        opt.step()
        torch.autograd.graph.increment_version(params)
    after = _kernel_vs_plain(model, x, lowres, t)
    assert not torch.equal(after, before)

    ema = copy.deepcopy(_small_unet(dev, seed=1)).eval()
    assert ema._init_packed._packed is None  # a copied module packs anew
    _kernel_vs_plain(ema, x, lowres, t)
    assert ema_update(ema, model, step=2, update_after_step=0) > 0
    _kernel_vs_plain(ema, x, lowres, t)

    model.load_state_dict(_small_unet(dev, seed=2).state_dict())
    _kernel_vs_plain(model, x, lowres, t)


def test_small_attention_unet_train_step_through_the_kernels(dev):
    """One training step (forward, backward, Adam) of a small softmax
    attention U-Net through all four kernels against the plain path, with
    the same dropout draws: exact launch counts, the loss within bf16
    tolerance, and each parameter's gradient (the attention projections
    behind the flash kernel's plain backward included) pointing the same
    way as the plain path's: per-tensor cosine >= GRAD_TENSOR_COS_MIN."""
    model = _small_unet(dev, img_size=48, att_type="softmax", attn_dim_head=32,
                        attend_at_enc=(True, True), attend_at_enc_heads=2, deep_feature=True,
                        attend_at_middle=True, attend_at_middle_heads=2).train()
    x, lowres, t = _inputs(dev, n=54)

    def step(ops):
        model.use_ops(ops).zero_grad(set_to_none=True)
        torch.manual_seed(3)  # the same dropout masks on both paths
        kernels.reset_launch_counts()
        loss = model(x, t, t, lowres_cond_img=lowres).float().square().mean()
        loss.backward()
        counts = kernels.launch_counts()
        return loss.item(), {k: p.grad.double() for k, p in model.named_parameters()}, counts

    loss_k, grads_k, counts = step(kernels.KERNELS)
    loss_p, grads_p, _ = step(kernels.PLAIN)
    n_res = 2 * 2 + 1 + 2 * 2 + 1
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res,
                      "flash_attention": 3}
    assert abs(loss_k - loss_p) <= 5e-2 * abs(loss_p)
    cos = {k: float((g.flatten() @ grads_p[k].flatten()) / (g.norm() * grads_p[k].norm()))
           for k, g in grads_k.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    print(f"per-tensor gradient cosine, worst {worst}")
    projections = [k for k in cos if any(f".to_{n}." in k for n in "qkv")]
    assert len(projections) == 3 * 2 * 3  # q, k, v (two convs each) of 3 flash slots
    assert min(cos.values()) >= GRAD_TENSOR_COS_MIN, worst
    assert all(torch.isfinite(g).all() for g in grads_k.values())
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    model.use_ops(kernels.KERNELS)
    step(kernels.KERNELS)
    opt.step()
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_block_backward_matches_plain_composition_without_scatter(dev):
    """One Block at the gate's microbatch, (108, 32^3, 64 -> 64) in bf16,
    forward through the kernels: its gradients (the backward of the one
    autograd Function, the JAX ``_reference_impl`` order) against autograd
    through the independent table composition (GroupNorm affine folded
    into per-region coefficients, the halo, ``fused_conv_plain``), each
    tensor's cosine >= GRAD_BLOCK_COS_MIN. Under the profiler the Block's
    backward runs no scatter kernel; the table composition's does (so the
    profiler sees one when it runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(0)
    n, s, c, groups = 108, 32, 64, 8
    x = torch.randn((n, s, s, s, c), generator=g, device=dev).to(torch.bfloat16)
    ns = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    nb = 0.1 * torch.randn(c, generator=g, device=dev)
    scale, shift = (0.2 * torch.randn((n, 1, 1, 1, c), generator=g, device=dev)
                    for _ in range(2))
    w = torch.randn((c, c, 3, 3, 3), generator=g, device=dev) * (27 * c) ** -0.5
    grad_out = torch.randn((n, s, s, s, c), generator=g, device=dev).to(torch.bfloat16)

    def block(x_, ns_, nb_, sc_, sh_, w_):
        return tfb.fused_boundary_block(x_, ns_, nb_, (sc_, sh_), w_, groups, 3)

    def tables(x_, ns_, nb_, sc_, sh_, w_):
        a, b = tfb.groupnorm_affine(x_, ns_, nb_, groups, scale_shift=(sc_, sh_))
        a_tab, b_tab = tfb.neighbor_tables(a, b, 3)
        return tfb.fused_conv_plain(kernels.halo_exchange_plain(x_, 3), a_tab, b_tab, w_)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (x, ns, nb, scale, shift, w)]
        out = fn(*leaves)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out.backward(grad_out)
            torch.cuda.synchronize()
        scatter = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and ("indexing_backward" in e.key or "index_put" in e.key))
        return [t.grad.double() for t in leaves], scatter

    kernels.reset_launch_counts()
    got, got_scatter = grads(block)
    assert kernels.launch_counts() == {"halo": 1, "conv3d": 0, "fused_block": 1,
                                       "flash_attention": 0}
    want, want_scatter = grads(tables)
    assert got_scatter == 0 and want_scatter > 0, (got_scatter, want_scatter)
    for name, a, b in zip(("x", "norm_scale", "norm_bias", "scale", "shift", "w"), got, want):
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert cos >= GRAD_BLOCK_COS_MIN, (name, cos)
