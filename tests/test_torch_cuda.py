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
from diffusioniqt_tpu_torch.parallel import multihost, sharding
from diffusioniqt_tpu_torch.parallel.mesh import create_mesh
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
                                          (27, 8, 192, 3), (2, 6, 3, 1),
                                          # the small-edge levels: 4^3 and 2^3 at up to 1024
                                          (216, 4, 256, 3), (27, 4, 512, 1), (27, 2, 1024, 1),
                                          (54, 2, 128, 3)] + _HALO_WIDTHS)
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
                                      (256, 256), (64, 32), (64, 16), (128, 32)])
@pytest.mark.parametrize("s", [8, 16, 32])
def test_fused_kernel_matches_plain(dev, s, cin, cout):
    """The wgmma GEMM under each shape's plan (``brick_plan``): BN 64 and
    128, the narrow BN 32 at Cout 16 and 32 (the column shards of 64- and
    128-channel Blocks under tensor parallelism, Cout 16 a ragged n tile),
    whole- and half-tap commit groups, one to four 64-channel chunks (Cin
    2 and 16 with zero-filled channels), the plain-load brick (Cin = 2)
    and the TMA brick, at every sub-volume edge of the path."""
    xh, ta, tb, w = _fused_case(dev, s, cin, cout, seed=s * 1000 + cin + cout)
    kernels.reset_launch_counts()
    got = kernels.fused_conv(xh, ta, tb, w)
    assert kernels.launch_counts()["fused_block"] == 1
    _close(got, kernels.fused_conv_plain(xh, ta, tb, w))


@pytest.mark.parametrize("n,s,factor,cin,cout", [
    (54, 4, 3, 64, 64), (27, 4, 1, 72, 128), (216, 4, 3, 256, 256), (27, 4, 1, 512, 512),
    (27, 2, 3, 64, 128), (27, 2, 1, 1024, 1024), (8, 2, 1, 32, 64),
    (27, 4, 3, 256, 256), (27, 4, 1, 1024, 512), (27, 4, 3, 136, 192),
    (216, 4, 3, 256, 128), (27, 4, 3, 256, 64)])
def test_small_edge_route_matches_plain(dev, n, s, factor, cin, cout):
    """The fused kernel's small-edge kernel: tiles of whole sub-volumes of
    4^3 (two a tile, double-buffered) and 2^3 (16 a tile, one buffer) in CTA
    pairs, a ragged last m block (27 sub-volumes), an odd count of m blocks
    (27 and 1: the pair's second CTA has none), tiles split over several
    CTAs and summed from partials, BN 128 and 256 (Cout 64 and 192 in part;
    Cout 128 and 64: the efficient flagship's 4^3 Blocks under a column
    split over 2 and 4 ranks), Cin 32, 72 and 136 (partial chunks) to 1024.
    Two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(n + s + cin + cout)
    x = torch.randn((n, s, s, s, cin), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (27 * cin) ** -0.5
    ss = tuple(0.2 * torch.randn((n, 1, 1, 1, cin), generator=g, device=dev)
               for _ in range(2))
    a, b = tfb.groupnorm_affine(x, 1.0 + 0.1 * torch.randn(cin, generator=g, device=dev),
                                0.1 * torch.randn(cin, generator=g, device=dev), 8,
                                scale_shift=ss)
    ta, tb = tfb.neighbor_tables(a, b, factor)
    xh = kernels.halo_exchange(x, factor)
    kernels.reset_launch_counts()
    got = kernels.fused_conv(xh, ta, tb, w)
    counts = kernels.launch_counts()
    assert (counts["fused_block_small"], counts["fused_block"]) == (1, 0)
    _close(got, kernels.fused_conv_plain(xh, ta, tb, w))
    assert torch.equal(kernels.fused_conv(xh, ta, tb, w), got)


@pytest.mark.parametrize("s,cin,cout,bn,tap,split,kc", [
    (8, 64, 32, 32, True, False, 64), (16, 64, 16, 32, True, False, 64),
    (8, 2, 32, 32, False, False, 64), (8, 4, 128, 128, False, False, 64),
    (16, 128, 64, 64, True, False, 64), (32, 64, 64, 64, True, False, 64),
    (32, 64, 64, 64, False, False, 64),
    (8, 136, 96, 64, True, False, 64), (16, 64, 64, 32, True, False, 64),
    (8, 128, 128, 128, True, True, 64), (8, 136, 96, 64, True, True, 64),
    (8, 72, 32, 32, True, True, 64),
    # 32-channel chunks: Cin 32 at each width, Cin 16 and 40 (zeros past
    # Cin in a chunk), several chunks at BN 128, and two n tiles (the second
    # ragged)
    (32, 32, 128, 128, True, False, 32), (32, 32, 32, 32, True, False, 32),
    (16, 32, 64, 64, True, False, 32), (8, 16, 32, 32, True, False, 32),
    (8, 40, 64, 64, True, False, 32), (16, 128, 128, 128, True, False, 32),
    (8, 256, 256, 128, True, False, 32), (8, 64, 48, 32, True, False, 32),
    # BN 128 in whole-tap groups, A read from the brick by descriptor: two
    # n tiles, a ragged last chunk and Cout short of the unit, ranges
    (8, 256, 256, 128, True, False, 64), (8, 136, 96, 128, True, False, 64),
    (16, 192, 128, 128, True, True, 64), (32, 128, 128, 128, True, False, 64)])
def test_brick_plans_match_plain(dev, s, cin, cout, bn, tap, split, kc):
    """Each unit width, commit group and chunk width of the brick route
    under an explicit plan, launched through ``launch_brick`` (one launch
    counted): the narrow unit in whole-tap groups and, with the plain-load
    brick, half-tap ones (as BN 128 there), BN 64 in whole-tap groups and
    as the base unit (half taps) at a 64-channel Block, a ragged second n
    tile (Cout 96), Cout 64 in two narrow n tiles; ranges of chunks (54
    units of 2 chunks on one CTA per item, so every unit cut; 432 units of
    3 chunks; a ragged n tile; the narrow unit with one chunk, where
    nothing is cut); 32-channel chunks at every width; and BN 128 in
    whole-tap groups (A from shared memory). Two launches give the same
    bits."""
    xh, ta, tb, w = _fused_case(dev, s, cin, cout, seed=7 * s + cin + cout + bn + kc)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tfb.make_brick_plan(xh.shape[0], s, cin, cout, sms, bn, tap, split, kc=kc)
    kernels.reset_launch_counts()
    got = tfb.launch_brick(xh, ta, tb, pack_weight(w), plan)
    assert kernels.launch_counts()["fused_block"] == 1
    _close(got, kernels.fused_conv_plain(xh, ta, tb, w))
    assert torch.equal(tfb.launch_brick(xh, ta, tb, pack_weight(w), plan), got)


def test_brick_plans_the_build_refuses(dev):
    """Plans the port's build has no kernel for raise rather than run:
    whole-tap groups, ranges of chunks or 32-channel chunks beside the
    plain-load brick; where the brick comes by TMA, half-tap groups outside
    the base unit (BN 32 or 128, or ranges of chunks) and 32-channel chunks
    in half-tap groups or in ranges; and a grid larger than the units
    (whole units) or the items (ranges of chunks)."""
    xh, ta, tb, w = _fused_case(dev, 8, 2, 32, seed=3)
    plan = tfb.make_brick_plan(27, 8, 2, 32, 132, 32)
    for bad in (plan._replace(tap=True), plan._replace(split=True),
                plan._replace(kc=32, tap=True), plan._replace(ctas=plan.units + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tfb.launch_brick(xh, ta, tb, pack_weight(w), bad)
    xh, ta, tb, w = _fused_case(dev, 8, 64, 32, seed=5)
    plan = tfb.make_brick_plan(27, 8, 64, 32, 132, 32, tap=True, split=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfb.launch_brick(xh, ta, tb, pack_weight(w),
                         plan._replace(ctas=plan.units * plan.chunks + 1))
    xh, ta, tb, w = _fused_case(dev, 8, 128, 128, seed=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfb.launch_brick(xh, ta, tb, pack_weight(w),
                         tfb.make_brick_plan(27, 8, 128, 128, 132, 128, kc=32)._replace(tap=False))
    with pytest.raises(RuntimeError, match="launch failed"):
        tfb.launch_brick(xh, ta, tb, pack_weight(w),
                         tfb.make_brick_plan(27, 8, 128, 128, 132, 128, split=True, kc=32))
    # half taps where the brick comes by TMA, outside the base unit
    for s, cin, cout, bn, split in ((8, 256, 256, 128, False), (8, 128, 128, 128, True),
                                    (16, 192, 128, 128, True), (8, 64, 32, 32, False),
                                    (8, 64, 32, 32, True), (8, 128, 64, 64, True)):
        xh, ta, tb, w = _fused_case(dev, s, cin, cout, seed=s + cin + cout)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = tfb.make_brick_plan(xh.shape[0], s, cin, cout, sms, bn, split=split)
        assert not plan.tap
        with pytest.raises(RuntimeError, match="launch failed"):
            tfb.launch_brick(xh, ta, tb, pack_weight(w), plan)


def test_fused_kernel_refuses_edges_without_a_route(dev):
    w = torch.randn((64, 64, 3, 3, 3), device=dev)
    tab = torch.zeros((27, 27, 64), device=dev)
    with pytest.raises(ValueError, match="no route"):
        kernels.fused_conv(torch.zeros((27, 8, 8, 8, 64), device=dev, dtype=torch.bfloat16),
                           tab, tab, w)
    w12 = torch.randn((64, 12, 3, 3, 3), device=dev)
    tab12 = torch.zeros((27, 27, 12), device=dev)
    with pytest.raises(ValueError, match="small-edge"):
        kernels.fused_conv(torch.zeros((27, 6, 6, 6, 12), device=dev, dtype=torch.bfloat16),
                           tab12, tab12, w12)


def test_memory_efficient_unet_runs_through_the_kernels(dev):
    """memory_efficient at 27 x 16^3: the Blocks at 16^3 and 8^3 take the
    implicit GEMM, those at 4^3 the small-edge route; exact counts, and the
    plain path within 5e-2."""
    torch.manual_seed(0)
    model = UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                   resnet_groups=4, memory_efficient=True, dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn((27, 16, 16, 16, 1), device=dev)
    lowres = torch.randn_like(x)
    t = torch.full((27,), 0.5, device=dev)
    log_snr = torch.full((27,), -1.0, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = model(x, t, log_snr, lowres_cond_img=lowres)
        counts = kernels.launch_counts()
        want = model.use_ops(kernels.PLAIN)(x, t, log_snr, lowres_cond_img=lowres)
    # every level downsamples on entry and every up level upsamples first:
    # at 4^3 level 1 down (2 ResnetBlocks); at 8^3 level 0 down (2) and the
    # first up level (2); at 16^3 the last up level (2) and the final block
    assert counts == {"halo": 2 * 9 + 1, "conv3d": 1, "fused_block": 2 * 7,
                      "fused_block_small": 2 * 2, "flash_attention": 0, "group_norm": 2 * 9}
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


def test_remat_conv_backward_launches_no_kernel(dev):
    """remat_policy 'conv': a train step's backward launches no halo or
    fused kernel (the launches of forward + backward are the forward's),
    and its gradients equal no remat's bit for bit."""
    torch.backends.cudnn.deterministic = True
    try:
        torch.manual_seed(0)
        kw = dict(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                  resnet_groups=4, dtype=torch.bfloat16)
        plain = UNet3D(**kw).to(dev)
        conv = UNet3D(**kw, remat=True, remat_policy="conv").to(dev)
        conv.load_state_dict(plain.state_dict())
        x = torch.randn((27, 16, 16, 16, 1), device=dev)
        t = torch.full((27,), 0.5, device=dev)
        grads, counts = [], []
        for model in (plain, conv):
            kernels.reset_launch_counts()
            model(x, t, t, lowres_cond_img=x).float().square().mean().backward()
            torch.cuda.synchronize()
            counts.append(kernels.launch_counts())
            grads.append({k: p.grad for k, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    n_res = 2 * 2 + 2 * 2 + 1
    assert counts[0] == counts[1] == {"halo": 2 * n_res + 1, "conv3d": 1,
                                      "fused_block": 2 * n_res, "fused_block_small": 0,
                                      "flash_attention": 0, "group_norm": 2 * n_res}
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


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


# the group_norm kernels' tables against the plain composition, relative to
# each table's largest entry: the plain version's fp32 sums run over up to
# 2^18 values a group, the kernel's over short runs added in double
NORM_TOL = 1e-4
# (B, s, C) of every Block input of the iqt-sr-unet serve forward (rows cut
# to one or two 27-sub-volume windows), SRUnet256's first level (C 32, 4
# channels a group) and its small edges (C 1024 at 4^3 and 2^3)
_NORM_SHAPES = [(54, 32, 64), (27, 32, 128), (54, 16, 64), (54, 16, 128), (27, 16, 192),
                (54, 8, 128), (27, 32, 32), (27, 4, 1024), (27, 2, 1024)]


def _norm_case(dev, n, s, c, kind="per_sample", seed=0, mean=0.0):
    """x, the GroupNorm scale and bias, and the time scale and shift: none,
    one per sub-volume (the halves of one bf16 (n, 1, 1, 1, 2C) tensor, as
    the time MLP gives them) or one per 27-sub-volume window in fp32 (n < B)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (mean + torch.randn((n, s, s, s, c), generator=g, device=dev)).to(torch.bfloat16)
    ns = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    nb = 0.1 * torch.randn(c, generator=g, device=dev)
    if kind is None:
        return x, ns, nb, None, None
    rows = n if kind == "per_sample" else n // 27
    emb = 0.2 * torch.randn((rows, 1, 1, 1, 2 * c), generator=g, device=dev)
    scale, shift = (emb.to(torch.bfloat16) if kind == "per_sample" else emb).chunk(2, dim=-1)
    return x, ns, nb, scale, shift


def _tables_close(got, want, tol_rel=NORM_TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert g.data_ptr() % 16 == 0
        _close(g, w, tol_rel)


@pytest.mark.parametrize("n,s,c", _NORM_SHAPES)
def test_norm_tables_match_plain(dev, n, s, c):
    """The group_norm pair at every Block width and edge of the serve
    forward and SRUnet256's, factor 3, one launch counted."""
    x, ns, nb, scale, shift = _norm_case(dev, n, s, c, seed=n + s + c)
    kernels.reset_launch_counts()
    got = kernels.KERNELS.norm_tables(x, ns, nb, scale, shift, 8, 3)
    assert kernels.launch_counts()["group_norm"] == 1
    _tables_close(got, kernels.PLAIN.norm_tables(x, ns, nb, scale, shift, 8, 3))


@pytest.mark.parametrize("kind", [None, "per_sample", "per_group"])
@pytest.mark.parametrize("factor", [3, 1])
def test_norm_tables_factor_and_time_forms(dev, factor, kind):
    """Factor 3 and 1 (SAME convs: only the sub-volume's own region), with
    no time scale-shift, a per-sub-volume bf16 one and a per-window fp32 one."""
    x, ns, nb, scale, shift = _norm_case(dev, 54, 16, 64, kind=kind, seed=factor)
    got = tfb.norm_tables(x, ns, nb, scale, shift, 8, factor)
    _tables_close(got, tfb.norm_tables_plain(x, ns, nb, scale, shift, 8, factor))


def test_norm_tables_nan_and_identical_bits(dev):
    """NaN in one sub-volume reaches exactly the table entries the plain
    version makes NaN; two launches give the same bits; a clean launch after
    an all-NaN one is clean."""
    x, ns, nb, scale, shift = _norm_case(dev, 27, 16, 64, seed=5)
    args = (ns, nb, scale, shift, 8, 3)
    once = tfb.norm_tables(x, *args)
    assert all(torch.equal(a, b) for a, b in zip(once, tfb.norm_tables(x, *args)))
    bad = x.clone()
    bad[13, 3, 4, 5, 17] = float("nan")
    got, want = tfb.norm_tables(bad, *args), tfb.norm_tables_plain(bad, *args)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w)) and torch.isnan(w).any()
        keep = ~torch.isnan(w)
        _close(g[keep], w[keep])
    tfb.norm_tables(torch.full_like(x, float("nan")), *args)
    assert all(torch.equal(a, b) for a, b in zip(once, tfb.norm_tables(x, *args)))


def _tables_fp64(x, ns, nb, scale, shift, groups, factor, eps=1e-5):
    """The tables in fp64 throughout, the variance by two passes."""
    b, c = x.shape[0], x.shape[-1]
    xv = x.double().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xv, dim=(1, 3), unbiased=False)
    rstd = (var + eps).rsqrt().repeat_interleave(c // groups, dim=1)
    a = rstd * ns.double()
    bb = nb.double() - mean.repeat_interleave(c // groups, dim=1) * a
    sc, sh = (t.double().reshape(t.shape[0], c).repeat_interleave(b // t.shape[0], dim=0)
              for t in (scale, shift))
    return tfb.neighbor_tables(a * (sc + 1.0), bb * (sc + 1.0) + sh, factor)


def test_norm_tables_large_mean_against_fp64(dev):
    """|mean| >> std (100 against 1): both versions against the tables
    computed in fp64 from the same bf16 input; the kernel's error is no
    worse than twice the plain version's."""
    x, ns, nb, scale, shift = _norm_case(dev, 27, 32, 64, seed=9, mean=100.0)
    args = (ns, nb, scale, shift, 8, 3)
    exact = _tables_fp64(x, *args)
    for got, plain, want in zip(tfb.norm_tables(x, *args), tfb.norm_tables_plain(x, *args),
                                exact):
        err_k = (got.double() - want).abs().max().item()
        err_p = (plain.double() - want).abs().max().item()
        assert err_k <= 2.0 * err_p + 1e-6 * want.abs().max().item(), (err_k, err_p)


def test_norm_tables_refuse_what_the_kernels_do_not_take(dev):
    x, ns, nb, _, _ = _norm_case(dev, 27, 8, 64, kind=None)
    with pytest.raises(ValueError, match="bfloat16"):
        tfb.norm_tables(x.float(), ns, nb, None, None, 8, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.norm_tables(x.transpose(1, 2), ns, nb, None, None, 8, 3)
    x12 = torch.zeros((27, 8, 8, 8, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfb.norm_tables(x12, ns[:12], nb[:12], None, None, 4, 3)


def test_serve_forward_counts_one_group_norm_per_block(dev):
    """One forward of the served U-Net (``config/eval_config.yaml``) at one
    window: ``group_norm`` counts one launch per Block, and the output
    agrees with the plain path's."""
    from diffusioniqt_tpu_torch.config import load_config
    from diffusioniqt_tpu_torch.models.blocks import Block
    from diffusioniqt_tpu_torch.models.unet3d import iqt_unet_from_config

    torch.manual_seed(0)
    model = iqt_unet_from_config(load_config("config/eval_config.yaml"), device=dev).eval()
    blocks = sum(isinstance(m, Block) for m in model.modules())
    x, lowres = (torch.randn((27, 32, 32, 32, 1), device=dev) for _ in range(2))
    t = torch.full((27,), 0.5, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = model(x, t, t, lowres_cond_img=lowres)
        counts = kernels.launch_counts()
        want = model.use_ops(kernels.PLAIN)(x, t, t, lowres_cond_img=lowres)
    assert blocks == 38 and counts["group_norm"] == counts["fused_block"] == blocks
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


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
@pytest.mark.parametrize("n", [64, 100, 129, 1728, 3600])
def test_flash_attention_matches_plain(dev, n, d):
    """n = 64 and 100: one partial 128-row tile of queries and keys; 129:
    one full tile and one row; 1728: the main path's 13.5 tiles; 3600: the
    2D slice U-Net's 60^2 tokens, ragged in query and key tiles. B = 16
    with a ragged n catches rows of one head read as the next head's."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (torch.randn((16, n, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kernels.reset_launch_counts()
    got = kernels.flash_attention(q, k, v, d ** -0.5)
    assert kernels.launch_counts()["flash_attention"] == 1
    _close(got, kernels.attention_reference(q, k, v, d ** -0.5))


def test_unet2d_softmax_attention_through_the_kernel(dev):
    """A small softmax-attention UNet2D (bf16): its two attention slots
    launch the flash kernel once each per forward, and the forward agrees
    with the plain path's."""
    from diffusioniqt_tpu_torch.models.unet2d import UNet2D

    torch.manual_seed(0)
    unet = UNet2D(dim=32, dim_mults=(1, 2), num_resnet_blocks=1, lowres_cond=True,
                  att_type="softmax", layer_attns=(False, True), attend_at_middle=True,
                  dtype=torch.bfloat16).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(4)
    x, lowres = (torch.randn((4, 40, 40, 1), generator=g, device=dev) for _ in range(2))
    t = torch.full((4,), 0.5, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = unet(x, t, t, lowres_cond_img=lowres)
        assert kernels.launch_counts()["flash_attention"] == 2
        want = unet.use_ops(kernels.PLAIN)(x, t, t, lowres_cond_img=lowres)
    _close(got, want, 5e-2)


def test_flash_attention_more_keys_than_queries(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((16, 100, 64), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((16, 1728, 64), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    _close(kernels.flash_attention(q, k, v, 0.125), kernels.attention_reference(q, k, v, 0.125))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("nq,nk", [(1728, 1744), (1744, 1728), (100, 116), (116, 100),
                                   (3600, 3616)])
def test_flash_attention_with_other_key_counts(dev, nq, nk, d):
    """Nk != Nq both ways (a text context adds keys: 12^3 voxel tokens and
    16 text tokens), with ragged query and key tiles."""
    g = torch.Generator(device=dev).manual_seed(nq * 7 + nk + d)
    q = torch.randn((16, nq, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((16, nk, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    kernels.reset_launch_counts()
    got = kernels.flash_attention(q, k, v, d ** -0.5)
    assert kernels.launch_counts()["flash_attention"] == 1 and got.shape == q.shape
    _close(got, kernels.attention_reference(q, k, v, d ** -0.5))


def test_softmax_attention_with_text_context_through_the_kernel(dev):
    """A SoftMaxAttention slot given a text context launches flash once, at
    Nq = N voxel tokens against Nk = N + L keys, and agrees with the plain
    path."""
    from diffusioniqt_tpu_torch.models.attention import SoftMaxAttention

    torch.manual_seed(0)
    slot = SoftMaxAttention(32, dim_head=64, heads=4, patch_size=2, patch=True,
                            context_dim=48).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 24, 24, 24, 32), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 7, 48), generator=g, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = slot(x, context=ctx)
        assert kernels.launch_counts()["flash_attention"] == 1
        slot.ops = kernels.PLAIN
        want = slot(x, context=ctx)
    _close(got, want, 5e-2)


def test_video_unet_on_the_card_equals_its_cpu_forward(dev):
    """A small text-conditioned Unet3DVideo (every gate and the final conv
    drawn) in fp32 on the card, TF32 off, within 1e-4 of the largest entry
    of its CPU forward; it launches no hand-written kernel."""
    from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo

    torch.manual_seed(0)
    unet = Unet3DVideo(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, channels=1,
                       attn_dim_head=8, attn_heads=2, layer_attns=(False, True),
                       text_embed_dim=32, max_text_len=8, attn_pool_num_latents=4,
                       temporal_strides=(1, 2)).eval()
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith("out_gate") or name.startswith("final_conv"):
                p.normal_(0.0, 0.5)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 16, 16, 1), generator=g)
    t = torch.tensor([0.3, -1.0])
    text = torch.randn((2, 6, 32), generator=g)
    mask = torch.tensor([[True] * 6, [True] * 4 + [False] * 2])
    with torch.no_grad():
        want = unet(x, t, t, text_embeds=text, text_mask=mask)
        card = copy.deepcopy(unet).to(dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            torch.backends.cuda.matmul.allow_tf32 = False
            kernels.reset_launch_counts()
            got = card(x.to(dev), t.to(dev), t.to(dev), text_embeds=text.to(dev),
                       text_mask=mask.to(dev)).cpu()
    assert not any(kernels.launch_counts().values())
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


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
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res, "fused_block_small": 0,
                      "flash_attention": 3, "group_norm": 2 * n_res}
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-2


def test_flop_count_through_the_kernels_equals_the_plain_path(dev):
    """``utils/flops.py`` on the card: the attention U-Net's forward through
    the kernels (the fused Block, the init conv and flash attention report
    their work where they launch) counts what the plain path's aten convs
    and products count, and the kernels' share is reported by name."""
    from diffusioniqt_tpu_torch.utils.flops import FlopCounter

    torch.manual_seed(0)
    model = UNet3D(dim=16, init_dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                   resnet_groups=4, img_size=48, att_type="softmax", attn_dim_head=32,
                   attend_at_enc=(True, True), attend_at_enc_heads=2, deep_feature=True,
                   attend_at_middle=True, attend_at_middle_heads=2,
                   dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn((54, 16, 16, 16, 1), device=dev)
    t = torch.full((54,), 0.5, device=dev)
    counters = []
    for ops in (kernels.KERNELS, kernels.PLAIN):
        with torch.no_grad(), FlopCounter() as counter:
            model.use_ops(ops)(x, t, t, lowres_cond_img=x)
        counters.append(counter)
    card, plain = counters
    assert card.counts == plain.counts and card.counts["conv"] > 0
    assert {"fused_block", "conv3d", "flash_attention"} <= set(card.by_source)
    assert not {"fused_block", "conv3d", "flash_attention"} & set(plain.by_source)


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
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res, "fused_block_small": 0,
                      "flash_attention": 0, "group_norm": 2 * n_res}
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
    assert counts == {"halo": 3 * (2 * n_res + 1), "conv3d": 3, "fused_block": 3 * 2 * n_res, "fused_block_small": 0,
                      "flash_attention": 0, "group_norm": 3 * 2 * n_res}
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


def _broadcast_load_rank(device, path):
    """One of two gloo ranks (sharing a card where there is one): its own
    weights, packed by a kernel forward; then rank 0's, broadcast into the
    parameters, and a bundle's, loaded into a mesh trainer. After each the
    packs are fresh and the kernel forward agrees with the plain one."""
    rank = multihost.process_index()
    model = _small_unet(device, seed=10 + rank)
    x, lowres, t = _inputs(device)
    _kernel_vs_plain(model, x, lowres, t)
    mesh = create_mesh(("data",))
    sharding.broadcast_params(model, mesh)
    _kernel_vs_plain(model, x, lowres, t)
    want = _small_unet(device, seed=10).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())

    imagen = ElucidatedImagen([NullUnet(), model], image_sizes=(16, 16), channels=1,
                              auto_normalize_img=False, dynamic_thresholding=False,
                              norm="z-score", min_bound=-0.72, lowres_noise_aug=False)
    trainer = ImagenTrainer(None, imagen, mesh=mesh, gradient_accumulation_steps=1)
    other = ImagenTrainer(None, ElucidatedImagen(
        [NullUnet(), _small_unet(device, seed=12)], image_sizes=(16, 16), channels=1,
        auto_normalize_img=False, dynamic_thresholding=False, norm="z-score",
        min_bound=-0.72, lowres_noise_aug=False), mesh=mesh)
    other.prepare()
    other.save(path)
    trainer.load(path)
    _kernel_vs_plain(model, x, lowres, t)
    _kernel_vs_plain(trainer.ema_unets[1], x, lowres, t)
    return True


def test_no_stale_pack_after_broadcast_and_load(dev, tmp_path):
    """After ``broadcast_params`` (rank 1's own weights packed first, then
    rank 0's written over them) and after a mesh trainer's ``load``, the
    fused Block's and conv3d's packed weights are repacked: the kernel
    forward equals the plain one. Two gloo ranks, which may share one card
    (NCCL takes one card per rank)."""
    done = multihost.launch(_broadcast_load_rank, (str(tmp_path / "bundle.pt"),), nprocs=2,
                            device="cuda", backend="gloo", timeout_s=300)
    assert done == [True, True]


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
    assert counts == {"halo": 2 * n_res + 1, "conv3d": 1, "fused_block": 2 * n_res, "fused_block_small": 0,
                      "flash_attention": 3, "group_norm": 2 * n_res}
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
    assert kernels.launch_counts() == {"halo": 1, "conv3d": 0, "fused_block": 1, "fused_block_small": 0,
                                       "flash_attention": 0, "group_norm": 1}
    want, want_scatter = grads(tables)
    assert got_scatter == 0 and want_scatter > 0, (got_scatter, want_scatter)
    for name, a, b in zip(("x", "norm_scale", "norm_bias", "scale", "shift", "w"), got, want):
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert cos >= GRAD_BLOCK_COS_MIN, (name, cos)
