"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: the kernels have no CPU mode, so on a
machine without one each test skips with that reason. The file imports
only ``torch`` and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)
"""

import pytest
import torch

from diffusioniqt_tpu_torch.models.unet3d import UNet3D
from diffusioniqt_tpu_torch.ops import kernels
from diffusioniqt_tpu_torch.ops.kernels import fused_block as tfb

pytestmark = pytest.mark.cuda

# |kernel - plain| <= BF16_TOL * max|plain|: both round fp32 sums to bf16
# (2^-9 relative each) after summing in different orders
BF16_TOL = 2.0 ** -7


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
