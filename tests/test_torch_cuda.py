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


@pytest.mark.parametrize("n,s,c,factor", [(54, 8, 2, 3), (27, 4, 64, 3),
                                          (27, 8, 192, 3), (2, 6, 3, 1)])
def test_halo_equals_plain(dev, n, s, c, factor):
    x = torch.randn((n, s, s, s, c), device=dev).to(torch.bfloat16)
    torch.testing.assert_close(kernels.halo_exchange(x, factor),
                               kernels.halo_exchange_plain(x, factor), rtol=0, atol=0)


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
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res}
    assert torch.isfinite(got).all()
    # bf16 rounding differences compound through the network
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2
