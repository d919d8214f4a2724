"""Kernel 3: the fused ResnetBlock ``Block`` unit (``csrc/fused_block.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block``:
[GroupNorm -> (scale+1, shift) -> Mish -> boundary halo -> VALID 3^3 conv].

As in the JAX package, the work splits in three:

* :func:`groupnorm_affine` and :func:`neighbor_tables` (plain torch, tiny
  arrays): single-pass fp32 GroupNorm statistics folded with the norm
  affine and the time scale-shift into per-(sub-volume, channel) A and B,
  then a 27-region table per sub-volume (itself and its 26 grid
  neighbours; A = B = 0 where a neighbour is missing, so mish(0) = 0 is the
  reference's zero padding);
* the halo exchange (kernel 1) on the raw activation;
* :func:`fused_conv` (this kernel): ``conv_valid(mish(A_r * xh + B_r), w)``
  with r the region of each halo voxel, bf16 out, fp32 accumulation. Mish
  uses the one-exp identity with the input clamped at 20, as the Pallas
  kernel does.

Bound on the H100: operations, ``2 * M * 27 * Cin * Cout`` FLOP (1.583 ms
at the main path's (216, 32^3, 64->64)). The first kernel (an 8-warp
``mma.sync`` implicit GEMM, both operands through ``ldmatrix``, a barrier on
every tap, the brick loaded and put through Mish by the same warps between
products, 3.4-5x halo overhead) reached 15% of it. The kernel now is the
``wgmma`` + TMA implicit GEMM of ``csrc/igemm.cuh``: persistent CTAs walk
4 x 8 x 8-voxel output bricks by BN output channels; one warp streams the
tap weight slices through an mbarrier ring; seven transform warps load
each halo'd brick by TMA and apply the affine + Mish in shared memory one
brick ahead of two consumer warpgroups, which gather their A fragments
from the brick by ``ldmatrix`` (a tap is a row shift) and read B from the
ring. The normalised activation never reaches device memory, and the Mish
runs beside the products rather than between them. Each launch's unit
comes from :func:`brick_plan`: BN 32 (the narrow unit of the column
shards, ``wgmma`` n32 on 64-byte-swizzled slices), 64 or 128; 64 input
channels a chunk, or 32 where Cin <= 32 (SRUnet256's first level, where a
64-channel chunk spent half of every product, brick byte and Mish on zero
channels; its unit's output goes out through a staging tile by TMA
stores); and for units up to 64 wide, or with 32-channel chunks, a whole
tap per commit group (the base unit commits half a tap, which leaves the
tensor cores waiting on the next gathers when the products are short);
:data:`BASE_SHAPES` keep the base unit, and BN 128 in whole taps reads A
from the brick through a matrix descriptor (both ``wgmma`` operands in
shared memory), so that its registers go to the transform.
Where whole units would leave the last round on the card part full
(the 8^3 levels: 432 units for 132 SMs), the plan spreads the last round's
units over all CTAs in contiguous ranges of 64-channel chunks instead, and
a second kernel sums the units that a range boundary cuts from their fp32
partials in the order of the CTAs. :mod:`.brick_trace` times every candidate plan with phase stamps
and ablations.

Two routes, chosen from the sub-volume edge by :func:`route` (a dispatch
by shape; neither stands in for the other, and an edge that neither takes
raises): ``"igemm"`` (the brick route) for edges that are multiples of 8, and
``"small_edge"`` for edges 4 and 2, where a ``memory_efficient`` U-Net's
deeper levels run (the flagship at 4^3, SRUnet256 at 4^3 and 2^3 with up
to 1024 channels). The small-edge route is its own kernel,
``csrc/fused_block_small.cu``: tiles of 128 output rows of whole
sub-volumes (2 x 4^3 or 16 x 2^3, their halo'd inputs one TMA box) by up
to 256 output channels, CTAs in pairs that share each weight slice by TMA
multicast, the pairs' K (64-channel chunks of 27 taps) cut into one wave
of ranges of whole chunks (:func:`small_edge_plan`), the tiles that a
range cuts summed from fp32 partials in a fixed order by a second kernel;
it needs Cin % 8 == 0.

Autograd sees the Block as one Function over ``(x, norm_scale, norm_bias,
scale, shift, w)``, as the JAX package puts one ``jax.custom_vjp`` over
``fused_boundary_block`` (fused_block.py:271-306): the forward runs the
steps above with autograd off and saves only its inputs; the backward
differentiates :func:`block_reference_plain`, the JAX ``_reference_impl``
order of operations, whose halo is the concatenation sweep and whose
statistics and affine are broadcasts: it recomputes the activation and
runs the conv's backward products on it, never the conv forward. No gather
over the activation (and so no accumulating scatter) is on the backward
path; the tables and the fused kernel are forward only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.utils import flops, profiling
from diffusioniqt_tpu_torch.ops.kernels.conv3d import (
    PackedWeight,
    check_igemm_args,
    conv3d_valid_plain,
    pack_weight,
)
from diffusioniqt_tpu_torch.ops.volume import halo_exchange

# encoder, xh, a_tab, b_tab, w, out, ws, B, s, Cin, Cout, BN, kc, tap, split, CTAs, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# encoder, xh, a_tab, b_tab, w, out, ws, B, s, Cin, Cout, BN / 2, CTAs, stream
_SMALL_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# sub-volume edges of the small-edge route
SMALL_EDGES = (4, 2)
# the small-edge kernel's tile: output rows (two m64 tiles), and input
# channels per K chunk (a slice is one tap of one chunk)
TILE_ROWS, CHUNK = 128, 64
# (B, s, Cin, Cout, factor) of every small-edge Block the presets launch, as
# the wrapper sees them in one forward: the efficient flagship at the serve
# batch (8 windows) and at one window, SRUnet256 at one window (35 at 4^3 x
# 512, one at 4^3 1024->512 on the up path, 20 at 2^3 x 1024); and the
# efficient flagship's 4^3 Blocks under a column split over 2 ranks (Cout / 2)
SMALL_EDGE_SHAPES = ((216, 4, 256, 256, 3), (27, 4, 256, 256, 3), (27, 4, 512, 512, 1),
                     (27, 4, 1024, 512, 1), (27, 2, 1024, 1024, 1), (216, 4, 256, 128, 3))


def route(s: int) -> str:
    """The fused kernel's route at sub-volume edge ``s``: ``"igemm"`` (4 x 8
    x 8 output bricks) for multiples of 8, ``"small_edge"`` (whole
    sub-volumes) for :data:`SMALL_EDGES`; raises for any other edge."""
    if s > 0 and s % 8 == 0:
        return "igemm"
    if s in SMALL_EDGES:
        return "small_edge"
    raise ValueError(f"fused_block kernel: no route for sub-volume edge {s} "
                     f"(multiples of 8, or {SMALL_EDGES})")


class SmallEdgePlan(NamedTuple):
    """How the small-edge kernel (``csrc/fused_block_small.cu``) cuts one
    shape. A tile is ``subs`` whole sub-volumes (:data:`TILE_ROWS` output
    rows: m block ``mb``) by ``bn`` output channels (n block), ``bn // 2``
    per consumer warpgroup; its K is ``k_slices`` = 27 taps x ceil(Cin /
    64) chunks, one brick (a TMA load of the tile's halo'd inputs, put
    through Mish) per chunk. CTAs come in pairs (a cluster) that take m
    blocks ``2 j`` and ``2 j + 1`` of pair tile ``u`` (n block ``u //
    m_pairs``, ``j = u % m_pairs``) with the same weight slices, each
    loading half of every slice into both. The pair tiles' bricks, tile
    after tile, are cut into ``ctas // 2`` contiguous ranges that differ by
    at most one brick, one per pair (:meth:`segments`); ``cut`` says
    whether a range starts inside a pair tile, whose sums then come from
    fp32 partials."""

    subs: int
    bn: int
    m_blocks: int
    n_blocks: int
    k_slices: int
    ctas: int
    cut: bool

    @property
    def m_pairs(self) -> int:
        return -(-self.m_blocks // 2)

    @property
    def bricks(self) -> int:
        """The pair tiles' bricks."""
        return self.m_pairs * self.n_blocks * (self.k_slices // 27)

    def range_lo(self, cluster: int) -> int:
        """First brick of pair ``cluster``'s range (the kernel's
        ``range_lo``)."""
        return cluster * self.bricks // (self.ctas // 2)

    def segments(self):
        """``(cta, tile, k_begin, k_end, slot)`` for every piece of a tile
        (``n block * m_blocks + m block``) that a CTA computes, in slices.
        A piece that is not the whole tile goes to the CTA's partial
        ``slot``: 0 if its pair tile is the first of the range, else 1."""
        chunks = self.k_slices // 27
        for cl in range(self.ctas // 2):
            lo, hi = self.range_lo(cl), self.range_lo(cl + 1)
            for u in range(lo // chunks, -(-hi // chunks)):
                kb, ke = max(lo, u * chunks) - u * chunks, min(hi, (u + 1) * chunks) - u * chunks
                for rank in (0, 1):
                    mb = 2 * (u % self.m_pairs) + rank
                    if mb < self.m_blocks:
                        yield (2 * cl + rank, u // self.m_pairs * self.m_blocks + mb, 27 * kb,
                               27 * ke, 0 if u == lo // chunks else 1)


@functools.lru_cache(maxsize=64)
def small_edge_plan(nb: int, s: int, cin: int, cout: int, sms: int) -> SmallEdgePlan:
    """The small-edge kernel's plan for ``nb`` sub-volumes of edge ``s`` on
    a card of ``sms`` SMs: 64 or 128 columns a consumer warpgroup (128
    where Cout is a multiple of 256), and one wave of CTA pairs: each pair
    takes ceil(bricks / (sms // 2)) bricks (the least any one wave allows),
    and there are as few pairs as that allows, so that as many ranges as
    can be are whole tiles, which need no partials."""
    subs = TILE_ROWS // s ** 3
    bn = 256 if cout % 256 == 0 else 128
    m_blocks, n_blocks = -(-nb // subs), -(-cout // bn)
    chunks = -(-cin // CHUNK)
    bricks = -(-m_blocks // 2) * n_blocks * chunks
    clusters = -(-bricks // -(-bricks // max(1, sms // 2)))
    ctas = 2 * clusters
    cut = any(c * bricks // clusters % chunks for c in range(1, clusters))
    return SmallEdgePlan(subs, bn, m_blocks, n_blocks, 27 * chunks, ctas, cut)


# the brick route's output brick (x, y, z), its narrow unit's width, and
# its narrow chunk: input channels per chunk where Cin <= 32 (64 elsewhere)
BRICK = (4, 8, 8)
NARROW = 32
NARROW_CHUNK = 32
# (s, Cin, Cout) of the flagship's Blocks that the brick route's base unit
# (BN 64, half-tap commit groups) was designed for, levels 0 and 1 at Cout
# 64: they keep it at every batch, the baseline of the headline's later
# redesign
BASE_SHAPES = ((32, 64, 64), (32, 128, 64), (16, 64, 64))
# (B, s, Cin, Cout) of every brick-route Block the presets launch, as the
# wrapper sees them: the flagship and the attention config at the serve
# batch (8 windows; the attention config adds 8^3 256->256 in its middle),
# the efficient flagship's 16^3 128->64 and 8^3 256->128, SRUnet256 at one
# window; then the column shards of tensor parallelism at the serve batch
# (Cout / 2 of the flagship's Blocks, and Cout / 4 of level 0's)
BRICK_SHAPES = ((216, 32, 64, 64), (216, 32, 128, 64), (216, 16, 64, 64), (216, 16, 192, 128),
                (216, 16, 128, 128), (216, 8, 128, 128), (216, 8, 256, 256),
                (216, 16, 128, 64), (216, 8, 256, 128),
                (27, 32, 32, 32), (27, 32, 32, 128), (27, 32, 128, 128), (27, 16, 128, 128),
                (27, 16, 256, 128), (27, 8, 256, 256), (27, 8, 512, 256),
                (216, 32, 64, 32), (216, 32, 64, 16), (216, 32, 128, 32), (216, 16, 64, 32),
                (216, 8, 128, 64), (216, 16, 192, 64))


class BrickPlan(NamedTuple):
    """How the brick route (``csrc/igemm.cuh``) cuts one shape. A unit of
    work is one 4 x 8 x 8 output brick of one sub-volume by ``bn`` output
    channels (n tile); ``units`` = B x bricks per sub-volume x ``n_tiles``,
    in the kernel's order: n tile by n tile, then sub-volume by sub-volume,
    bricks in x, y, z order. A unit runs ``chunks`` = ceil(Cin / ``kc``)
    chunks of 27 weight slices: ``kc`` 64 input channels a chunk (128-byte
    brick rows, 128-byte swizzle) or 32 (64-byte rows, 64-byte swizzle: at
    Cin 32 no product, brick byte or Mish is spent on zero channels).
    ``tap``: the consumers commit a whole tap (8 wgmmas at ``kc`` 64, 4 at
    32) per group, not half of one as in the base unit, so that each group's
    products cover the next group's A gathers; ``kc`` 32 always does. At
    ``bn`` 128 whole taps read A from the brick through a matrix descriptor
    (wgmma with both operands in shared memory), not by gathers into
    registers, and run a unit's chunks back to back. Where the brick comes
    by TMA (Cin % 8 == 0) the build runs half taps only in the base unit
    (``bn`` 64, ``kc`` 64, whole units); ``split`` needs whole taps; the
    launcher refuses every other plan. ``ctas``: the
    persistent grid. CTA ``c`` takes units ``c, c + ctas, ...`` whole; with
    ``split`` only the :attr:`rounds` that fill the grid, and the units left
    over (from :attr:`tail0`) are cut into their (unit, chunk) items, spread
    over all CTAs in contiguous ranges that differ by at most one item
    (:meth:`range_lo`); a unit that a range boundary cuts goes out as its
    pieces' fp32 sums, which a second kernel adds in the order of the
    CTAs."""

    bn: int
    kc: int
    tap: bool
    split: bool
    n_tiles: int
    units: int
    chunks: int
    ctas: int

    @property
    def rounds(self) -> int:
        """Rounds of whole units, one unit a CTA each."""
        return self.units // self.ctas if self.split else -(-self.units // self.ctas)

    @property
    def tail0(self) -> int:
        """With ``split``, the first unit left over after :attr:`rounds`."""
        return self.rounds * self.ctas

    def range_lo(self, cta: int) -> int:
        """With ``split``, the first of the left-over units' (unit, chunk)
        items, counted from :attr:`tail0`, in CTA ``cta``'s range (the
        kernel's ``range_lo``)."""
        return (self.units - self.tail0) * self.chunks * cta // self.ctas

    def pieces(self, cta: int):
        """``(unit, first chunk, end chunk)`` of every piece CTA ``cta``
        computes, in its order; a piece that is not the whole unit goes out
        as fp32 partials."""
        n = self.chunks
        if not self.split:
            return [(u, 0, n) for u in range(cta, self.units, self.ctas)]
        whole = [(u, 0, n) for u in range(cta, self.tail0, self.ctas)]
        lo, hi = self.range_lo(cta), self.range_lo(cta + 1)
        return whole + [(self.tail0 + u, max(lo - u * n, 0), min(hi - u * n, n))
                        for u in range(lo // n, -(-hi // n) if hi > lo else 0)]


def make_brick_plan(nb: int, s: int, cin: int, cout: int, sms: int, bn: int,
                    tap: bool = False, split: bool = False, kc: int = CHUNK) -> BrickPlan:
    """The brick plan of unit width ``bn`` and chunk width ``kc`` at one
    shape on a card of ``sms`` SMs: one CTA per SM, at most one per unit
    (with ``split``, per item). ``kc`` 32 commits whole taps."""
    units = nb * (s // BRICK[0]) * (s // BRICK[1]) * (s // BRICK[2]) * -(-cout // bn)
    chunks = -(-cin // kc)
    ctas = min(units * chunks if split else units, sms)
    return BrickPlan(bn, kc, tap or kc == NARROW_CHUNK, split, -(-cout // bn), units, chunks, ctas)


@functools.lru_cache(maxsize=64)
def brick_plan(nb: int, s: int, cin: int, cout: int, sms: int) -> BrickPlan:
    """The brick route's plan for ``nb`` sub-volumes of edge ``s`` (a
    multiple of 8), Cin -> Cout, on a card of ``sms`` SMs:

    * Cout <= 32 (the column shards of 64- and 128-channel Blocks under
      tensor parallelism, SRUnet256's 32-channel level): the narrow unit,
      BN 32, never more columns than Cout rounded up to 32;
    * Cout a multiple of 128: BN 128;
    * otherwise BN 64.
    Cin <= 32 with Cin % 8 == 0 (SRUnet256's first level) takes 32-channel
    chunks (:data:`NARROW_CHUNK`), every other shape 64-channel ones. Where
    the brick comes by TMA (Cin % 8 == 0) the units commit a whole tap per
    group, except at :data:`BASE_SHAPES`; at BN 128 that is the unit that
    reads A from the brick through a matrix descriptor (no A fragments in
    registers, which go to the transform instead). The plain-load brick
    (Cin % 8 != 0) commits half a tap.
    The units go whole to one CTA per SM unless they take more than one
    round and, where they commit whole taps, cutting the last round's units
    into ranges of chunks (``split``) shortens the busiest CTA's chunks by
    at least an eighth: at 8^3 x 128 channels, 432 units of 2 chunks on 132
    SMs, 3 rounds and the 36 units left over as 72 chunks on 72 CTAs, 7
    chunks and not 8. (With one round there is no last round to fill, and
    the partials cost more than the idle SMs; with one chunk a unit, as
    with 32-channel chunks, a cut never shortens the busiest CTA.) Raises
    for an edge the route does not take."""
    if s <= 0 or s % 8:
        raise ValueError(f"fused_block brick route: sub-volume edge {s} is not a multiple of 8")
    bn = NARROW if cout <= NARROW else (128 if cout % 128 == 0 else 64)
    kc = NARROW_CHUNK if cin <= NARROW_CHUNK and cin % 8 == 0 else CHUNK
    tap = cin % 8 == 0 and (s, cin, cout) not in BASE_SHAPES
    whole = make_brick_plan(nb, s, cin, cout, sms, bn, tap, kc=kc)
    split = make_brick_plan(nb, s, cin, cout, sms, bn, tap, split=True, kc=kc)
    busiest_whole = whole.rounds * whole.chunks
    busiest_split = (split.rounds * split.chunks
                     + -(-(split.units - split.tail0) * split.chunks // split.ctas))
    take = whole.units > sms and tap and 8 * busiest_split <= 7 * busiest_whole
    return split if take else whole


# ---------------------------------------------------------------------------
# coefficient construction (plain torch, tiny arrays)
# ---------------------------------------------------------------------------

def group_stats(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """Single-pass fp32 GroupNorm statistics per sample: E[x], and
    1/sqrt(E[x^2] - E[x]^2 + eps), each ``(B, C)`` (repeated over the
    channels of a group)."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xv = x.reshape(b, -1, groups, cg)
    mean = xv.mean(dim=(1, 3), dtype=torch.float32)
    sq = xv.float().square().mean(dim=(1, 3))
    var = torch.clamp(sq - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    # a broadcast, not repeat_interleave: its backward is a sum, not a scatter
    return (mean[:, :, None].expand(b, groups, cg).reshape(b, c),
            rstd[:, :, None].expand(b, groups, cg).reshape(b, c))


def _per_sample(t: torch.Tensor, b: int) -> torch.Tensor:
    """A time scale or shift ``(n, 1, 1, 1, C)`` as fp32 ``(b, 1, 1, 1, C)``:
    a per-group embedding (n dividing b) is broadcast to the b // n
    sub-volumes of its group, by expand (whose backward is a sum)."""
    t = t.float().reshape(t.shape[0], 1, 1, 1, 1, -1)
    n = t.shape[0]
    return t.expand(n, b // n, 1, 1, 1, t.shape[-1]).reshape(b, 1, 1, 1, -1)


def groupnorm_affine(x, norm_scale, norm_bias, groups: int,
                     scale_shift=None, eps: float = 1e-5):
    """Fold [GroupNorm + bias + optional time (scale+1, shift)] into
    per-(sample, channel) fp32 coefficients A, B with ``y = A*x + B``."""
    b = x.shape[0]
    mean, rstd = group_stats(x, groups, eps)
    a = rstd * norm_scale.float()[None, :]
    bb = norm_bias.float()[None, :] - mean * a
    if scale_shift is not None:
        scale, shift = (_per_sample(t, b).reshape(b, -1) for t in scale_shift)
        a = a * (scale + 1.0)
        bb = bb * (scale + 1.0) + shift
    return a, bb


@functools.lru_cache(maxsize=32)
def _neighbor_index(n: int, factor: int, device: torch.device):
    """For sub-volume b and region r: the batch index of its neighbour at
    grid offset (r1-1, r2-1, r3-1), and whether that neighbour exists.
    Both ``(n, 27)``; cached per shape (a handful of small tensors)."""
    f = factor
    b = torch.arange(n, device=device)
    rem = b % (f ** 3)
    g = (rem // (f * f), (rem // f) % f, rem % f)
    index, valid = [], []
    for d1 in (-1, 0, 1):
        for d2 in (-1, 0, 1):
            for d3 in (-1, 0, 1):
                ok = torch.ones(n, dtype=torch.bool, device=device)
                for gc, d in zip(g, (d1, d2, d3)):
                    ok &= (gc + d >= 0) & (gc + d < f)
                index.append((b + (d1 * f + d2) * f + d3) % n)
                valid.append(ok)
    return torch.stack(index, dim=1), torch.stack(valid, dim=1)


def neighbor_tables(a: torch.Tensor, bb: torch.Tensor, factor: int):
    """(B, C) coefficients -> (B, 27, C) region tables, region
    r = r1*9 + r2*3 + r3 for grid offsets (r1-1, r2-1, r3-1); zero where
    the neighbour is missing."""
    index, valid = _neighbor_index(a.shape[0], factor, a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    valid = valid[..., None]
    return (torch.where(valid, a[index], zero).contiguous(),
            torch.where(valid, bb[index], zero).contiguous())


# ---------------------------------------------------------------------------
# the kernel's function: plain version and wrapper
# ---------------------------------------------------------------------------

def mish_one_exp(v: torch.Tensor) -> torch.Tensor:
    """mish(v) = v * tanh(softplus(v)) = v * t / (t + 2), t = u^2 + 2u,
    u = exp(min(v, 20)) (the Pallas kernel's form, fused_block.py:160-167)."""
    u = torch.exp(torch.clamp(v, max=20.0))
    t = u * (u + 2.0)
    return v * t / (t + 2.0)


def _region_index(e: int, device) -> torch.Tensor:
    """(e, e, e) region index r of every halo'd voxel."""
    reg = torch.ones(e, dtype=torch.long, device=device)
    reg[0], reg[-1] = 0, 2
    return (reg[:, None, None] * 3 + reg[None, :, None]) * 3 + reg[None, None, :]


def fused_conv_plain(xh, a_tab, b_tab, w) -> torch.Tensor:
    """Plain version: ``conv_valid(mish(A_r * xh + B_r), w)``. xh
    ``(B, s+2, s+2, s+2, Cin)`` raw halo'd input; tables ``(B, 27, Cin)``
    fp32; w ``(Cout, Cin, 3, 3, 3)``. Output in ``xh.dtype``."""
    r = _region_index(xh.shape[1], xh.device)
    v = a_tab[:, r] * xh.float() + b_tab[:, r]
    return conv3d_valid_plain(mish_one_exp(v).to(xh.dtype), w)


def _launch(xh, a_tab, b_tab, w, packed):
    b, s, cin, cout = xh.shape[0], xh.shape[1] - 2, xh.shape[4], w.shape[0]
    sms = runtime.sm_count(xh.device)
    if route(s) == "small_edge":
        return launch_small_edge(xh, a_tab, b_tab, packed, small_edge_plan(b, s, cin, cout, sms))
    return launch_brick(xh, a_tab, b_tab, packed, brick_plan(b, s, cin, cout, sms))


def split_workspace(plan: BrickPlan, device: torch.device) -> Optional[torch.Tensor]:
    """With ``plan.split``, the kernel's ``(ctas, 2, 256, bn)`` fp32 slots
    (each CTA's pieces of the units its range starts and ends in); else
    None."""
    if not plan.split:
        return None
    rows = BRICK[0] * BRICK[1] * BRICK[2]
    return torch.empty((plan.ctas, 2, rows, plan.bn), dtype=torch.float32, device=device)


def launch_brick(xh, a_tab, b_tab, packed, plan: BrickPlan):
    """The brick route's kernel (and, where ``plan.split``, its reduction)
    on checked arguments under ``plan``, as :func:`fused_conv` calls it; one
    launch counted."""
    name = "fused_block"
    b, s, cin = xh.shape[0], xh.shape[1] - 2, xh.shape[4]
    cout = packed.shape[1]
    out = torch.empty((b, s, s, s, cout), dtype=xh.dtype, device=xh.device)
    ws = split_workspace(plan, xh.device)
    fn = runtime.c_function(name, "fused_block_launch", _ARGTYPES)
    err = fn(runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
             a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, b, s, cin, cout, plan.bn, plan.kc,
             int(plan.tap), int(plan.split), plan.ctas, runtime.stream_handle(xh.device))
    runtime.check_launch(name, err)
    profiling.launched("fused_block")
    flops.record("conv", flops.conv3d_valid_flops(out.shape, cin), "fused_block")
    return out


def launch_small_edge(xh, a_tab, b_tab, packed, plan: SmallEdgePlan):
    """The small-edge kernel (and, where ``plan.cut``, its reduction) on
    checked arguments, as :func:`fused_conv` calls it; one launch counted."""
    name = "fused_block_small"
    b, s, cin = xh.shape[0], xh.shape[1] - 2, xh.shape[4]
    cout = packed.shape[1]
    out = torch.empty((b, s, s, s, cout), dtype=xh.dtype, device=xh.device)
    ws = (torch.empty((plan.ctas, 2, TILE_ROWS, plan.bn), dtype=torch.float32,
                      device=xh.device) if plan.cut else None)
    fn = runtime.c_function(name, "fused_block_small_launch", _SMALL_ARGTYPES)
    err = fn(runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
             a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), b, s, cin, cout, plan.bn // 2, plan.ctas,
             runtime.stream_handle(xh.device))
    runtime.check_launch(name, err)
    profiling.launched("fused_block_small")
    flops.record("conv", flops.conv3d_valid_flops(out.shape, cin), "fused_block_small")
    return out


def fused_conv(xh, a_tab, b_tab, w, cache: PackedWeight = None) -> torch.Tensor:
    """The fused kernel for a CUDA tensor (bf16 xh, fp32 contiguous tables;
    the route by sub-volume edge, :func:`route`), the plain version for a
    CPU tensor. The kernel has no backward of its own: differentiate
    :func:`fused_boundary_block`, whose backward is the plain composition.
    Launches count as ``fused_block`` on the implicit-GEMM route and
    ``fused_block_small`` on the small-edge route (``ops.kernels.launch_counts``)."""
    if xh.device.type == "cpu":
        return fused_conv_plain(xh, a_tab, b_tab, w)
    if xh.device.type != "cuda":
        raise ValueError(f"fused_block kernel: unsupported device {xh.device}")
    start = profiling.launch_clock()
    name = "fused_block"
    runtime.require(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, a_tab, b_tab, w))), name,
        "no backward of its own; differentiate fused_boundary_block")
    small = route(xh.shape[1] - 2) == "small_edge"
    check_igemm_args(name, xh, w, small_edge=small)
    want = (xh.shape[0], 27, xh.shape[4])
    for tab in (a_tab, b_tab):
        runtime.require(tab.dtype == torch.float32 and tuple(tab.shape) == want
                        and tab.is_contiguous() and tab.device == xh.device
                        and tab.data_ptr() % 16 == 0,
                        name, f"tables must be contiguous, 16-byte aligned fp32 {want} "
                        f"on {xh.device}")
    packed = cache.get(w) if cache is not None else pack_weight(w)
    out = _launch(xh, a_tab, b_tab, w, packed)
    profiling.launch_timed("fused_block_small" if small else "fused_block", start)
    return out


def block_activation_plain(x, norm_scale, norm_bias, scale, shift,
                           groups: int, factor: int, eps: float = 1e-5) -> torch.Tensor:
    """Steps 1-5 of :func:`block_reference_plain`: the halo'd Mish
    activation that the conv reads, ``(B, s+2, s+2, s+2, C)`` in ``x.dtype``."""
    b, c = x.shape[0], x.shape[-1]
    mean, rstd = group_stats(x, groups, eps)
    xn = (x.float() - mean.reshape(b, 1, 1, 1, c)) * rstd.reshape(b, 1, 1, 1, c)
    xn = xn * norm_scale.float() + norm_bias.float()
    if scale is not None:
        xn = xn * (_per_sample(scale, b) + 1.0) + _per_sample(shift, b)
    act = mish_one_exp(xn).to(x.dtype)
    return halo_exchange(act, factor)


def block_reference_plain(x, norm_scale, norm_bias, scale, shift, w,
                          groups: int, factor: int, eps: float = 1e-5) -> torch.Tensor:
    """The Block in the JAX ``_reference_impl`` order of operations
    (fused_block.py:252-269), the function whose gradient the Block's
    backward is: (1) single-pass fp32 GroupNorm statistics
    (:func:`group_stats`), (2) ``x_norm * norm_scale + norm_bias``, (3) ``*
    (scale + 1) + shift`` when given, (4) :func:`mish_one_exp`, (5) the
    halo by the concatenation sweep of ``ops.volume.halo_exchange`` (its
    backward is slicing), (6) the VALID conv (:func:`conv3d_valid_plain`).

    Precision: steps 1-4 run in fp32, as the fused kernel computes its
    affine and Mish; the activation is then rounded to ``x.dtype`` (the
    compute dtype, bf16 on the card), which the halo and the conv run in,
    as the kernel feeds its tensor cores. At fp32 this is the JAX
    reference to rounding; in bf16 it differentiates what the kernel ran
    rather than the JAX non-Pallas Block's bf16 affine."""
    return conv3d_valid_plain(
        block_activation_plain(x, norm_scale, norm_bias, scale, shift, groups, factor, eps), w)


def conv3d_valid_vjp(xh, w, grad, need_x: bool, need_w: bool):
    """The backward products of :func:`conv3d_valid_plain` without its
    forward: the input gradient (a transposed conv) and the weight gradient,
    by the one ``convolution_backward`` call that autograd makes for the
    plain conv, on the same views. ``None`` for what is not needed."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        grad.permute(0, 4, 1, 2, 3), xh.permute(0, 4, 1, 2, 3), w.to(xh.dtype), None,
        [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1, [need_x, need_w, False])
    return (gx.permute(0, 2, 3, 4, 1) if need_x else None,
            gw.to(w.dtype) if need_w else None)


class _Block(torch.autograd.Function):
    """The whole Block unit: forward through ``ops`` (kernels or plain
    versions) with autograd off; saves only its inputs. The backward is the
    gradient of :func:`block_reference_plain`: it recomputes the GroupNorm /
    affine / Mish chain and the halo (:func:`block_activation_plain`, under
    autograd), runs the conv's two backward products on that activation
    (:func:`conv3d_valid_vjp`; never the conv forward), and pulls the
    activation's gradient back through the chain. That is what the JAX
    ``remat_policy='conv'`` recomputes, so the U-Net's ``'conv'`` policy
    needs no checkpoint around the ResnetBlocks."""

    @staticmethod
    def forward(ctx, x, norm_scale, norm_bias, scale, shift, w, groups, factor, cache, ops):
        ctx.consts = (groups, factor)
        ctx.save_for_backward(x, norm_scale, norm_bias, scale, shift, w)
        scale_shift = None if scale is None else (scale, shift)
        with profiling.span("block.norm", device=True):
            a, bb = groupnorm_affine(x, norm_scale, norm_bias, groups, scale_shift=scale_shift)
            a_tab, b_tab = neighbor_tables(a, bb, factor)
        return ops.fused_conv(ops.halo(x, factor), a_tab, b_tab, w, cache)

    @staticmethod
    def backward(ctx, grad):
        *inputs, w = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        chain = [bool(n) and t is not None for t, n in zip(inputs, needs[:5])]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) if t is not None else None
                      for t, n in zip(inputs, chain)]
            xh = block_activation_plain(*leaves, *ctx.consts)
        gxh, gw = conv3d_valid_vjp(xh.detach(), w.detach(), grad, any(chain), needs[5])
        wanted = [t for t, n in zip(leaves, chain) if n]
        grads = iter(torch.autograd.grad(xh, wanted, gxh) if wanted else ())
        return (*(next(grads) if n else None for n in chain), gw, None, None, None, None)


def fused_boundary_block(x, norm_scale, norm_bias, scale_shift, w,
                         groups: int, factor: int,
                         cache: Optional[PackedWeight] = None,
                         ops=None) -> torch.Tensor:
    """Fused [GN -> (scale, shift) -> Mish -> halo -> VALID conv] without
    the conv bias. x ``(B, s, s, s, C)`` raw split sub-volumes (B a multiple
    of factor^3) in the compute dtype; w ``(Cout, C, 3, 3, 3)``;
    ``scale_shift`` optional ``((B,1,1,1,C), (B,1,1,1,C))``. Returns
    ``(B, s, s, s, Cout)`` in ``x.dtype``. ``ops`` picks the kernels
    (default) or their plain versions (:data:`..PLAIN`) for the forward;
    the backward is :func:`block_reference_plain` either way."""
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS

    scale, shift = (None, None) if scale_shift is None else scale_shift
    return _Block.apply(x, norm_scale, norm_bias, scale, shift, w, groups, factor,
                        cache, ops or KERNELS)
