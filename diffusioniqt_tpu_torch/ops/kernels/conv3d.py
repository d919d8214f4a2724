"""Kernel 2: VALID 3x3x3 convolution of halo'd sub-volumes (``csrc/conv3d.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid``:
``(B, s+2, s+2, s+2, Cin) x w -> (B, s, s, s, Cout)``, fp32 accumulation,
output in the input dtype, no bias. On the main path it is the init conv
(Cin = 2: the noisy volume and the lowres conditioning).

Two hand-written routes, chosen from the shape by :func:`route`:

* ``"small_cin"`` (Cin <= :data:`SMALL_CIN_MAX`, the init conv). Bound by
  bytes: at the serve batch (216, 32^3, 2 -> 64) the bf16 output is 906 MB
  and the halo'd input 34 MB, 0.28 ms at 3.35 TB/s, while the real product
  (K = 27 * 2 = 54) is 49 GFLOP. K is packed densely (:func:`pack_weight_small`,
  row ``tap * Cin + c``, padded to a multiple of 16: 54 -> 64), so the
  tensor cores do 58 GFLOP and not the 783 GFLOP that padding Cin to a
  32-channel chunk costs. Persistent blocks own 256-voxel bricks and all of
  Cout; the A fragments come straight from the shared-memory input brick
  and the output leaves in coalesced 16-byte stores.
* ``"igemm"`` (Cin > 8): the implicit GEMM of ``csrc/igemm.cuh``, the
  fused Block kernel's GEMM without its Mish prologue (``wgmma`` over
  M = voxels, N = Cout, K = 27 * Cin; persistent CTAs, TMA loads of a
  halo'd 6 x 10 x 10 input brick per 4 x 8 x 8 outputs and of the tap
  weight slices, the 27 taps as row shifts of the brick), tiled as
  :func:`gemm_geometry` says; weight :func:`pack_weight`.

Weights stay in torch layout ``(Cout, Cin, 3, 3, 3)`` in the modules;
:class:`PackedWeight` reorders one once into the layout of the route that
runs it and keeps it until the parameter changes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.utils import flops, profiling

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the implicit GEMM's launcher also takes the TMA encoder first, and BN and
# the grid last
IGEMM_ARGTYPES = [ctypes.c_void_p, *_ARGTYPES[:-1], ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# widest input the small-Cin route takes; wider convs take the implicit GEMM
SMALL_CIN_MAX = 8
# the small-Cin kernel keeps all of Cout's weights in shared memory
SMALL_COUT_MAX = 256


def conv3d_valid_plain(xh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view (fp32
    accumulation), output in ``xh.dtype``, channels-last and contiguous."""
    out = F.conv3d(xh.permute(0, 4, 1, 2, 3), w.to(xh.dtype))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``(Cout, Cin, 3, 3, 3)`` -> ``(27*Cin, Cout)`` bf16, row
    ``((kx*3 + ky)*3 + kz)*Cin + c``. Not padded: the kernel's TMA loads
    fill the channels past Cin of a 64-channel chunk with zeros."""
    cout, cin = w.shape[0], w.shape[1]
    taps = w.detach().permute(2, 3, 4, 1, 0).reshape(27 * cin, cout)
    return taps.to(torch.bfloat16).contiguous()


class GemmGeometry(NamedTuple):
    """How the implicit-GEMM kernels (``csrc/igemm.cuh``) tile one shape."""

    brick: Tuple[int, int, int]   # output voxels (x, y, z) per unit of work
    chunk: int                    # input channels per K chunk (one 128-byte row)
    cin_pad: int                  # Cin rounded up to the chunk (zeros past Cin)
    bn: int                       # output channels per unit of work
    n_tiles: int                  # units per brick along Cout
    bricks: int                   # bricks per sub-volume
    tma_brick: bool               # the brick comes by TMA (Cin % 8 == 0), else plain loads


def gemm_geometry(s: int, cin: int, cout: int) -> GemmGeometry:
    """The tiling conv3d's implicit-GEMM route runs at sub-volume edge
    ``s``: the base unit, bricks of 4 x 8 x 8 output voxels (a halo'd 6 x 10
    x 10 input brick), Cin in 64-channel chunks, BN = 128 output channels
    where Cout is a multiple of 128, else 64 (columns past Cout computed and
    not stored), whole units on one CTA per SM (at most one per unit). The
    fused Block's brick route shares the kernel and picks its unit per launch
    (:func:`..fused_block.brick_plan`: also BN 32, whole-tap commit groups,
    32-channel chunks where Cin <= 32, and ranges of chunks summed from fp32
    partials); this route always takes 64-channel chunks. ``s`` must be a
    multiple of 8."""
    brick, chunk = (4, 8, 8), 64
    bn = 128 if cout % 128 == 0 else 64
    return GemmGeometry(brick=brick, chunk=chunk, cin_pad=-(-cin // chunk) * chunk, bn=bn,
                        n_tiles=-(-cout // bn),
                        bricks=(s // brick[0]) * (s // brick[1]) * (s // brick[2]),
                        tma_brick=cin % 8 == 0)


def pack_weight_small(w: torch.Tensor) -> torch.Tensor:
    """``(Cout, Cin, 3, 3, 3)`` -> ``(K_pad, Cout)`` bf16 for the small-Cin
    route: dense row ``k = ((kx*3 + ky)*3 + kz)*Cin + c``, K = 27 * Cin
    padded with zero rows to the next multiple of 16."""
    cout, cin = w.shape[0], w.shape[1]
    k = 27 * cin
    packed = torch.zeros((-(-k // 16) * 16, cout), dtype=torch.bfloat16, device=w.device)
    packed[:k] = w.detach().permute(2, 3, 4, 1, 0).reshape(k, cout)
    return packed


def route(cin: int) -> str:
    """The conv3d kernel for ``cin`` input channels: ``"small_cin"`` (dense
    K, the init conv) up to :data:`SMALL_CIN_MAX`, else ``"igemm"``. A
    dispatch by shape: each route is a hand-written kernel, and neither
    stands in for the other."""
    return "small_cin" if cin <= SMALL_CIN_MAX else "igemm"


class PackedWeight:
    """Cache of one conv weight in a kernel layout; repacks only when the
    layout asked for, or the parameter's storage or version counter, changes.
    ``load_state_dict`` and other in-place ops bump the version. Some
    in-place updates on CUDA do not: the fused Adam and
    ``torch._foreach_lerp_`` (torch 2.11 on an H100: versions 0 -> 0). Code
    that updates weights in place must bump their versions itself with
    ``torch.autograd.graph.increment_version``, as
    ``train/trainer.py::ImagenTrainer.train_step`` does after its optimizer
    step and ``train/ema.py::ema_update`` after its lerp; else the kernels
    run a stale pack.
    The pack is a plain tensor, made under ``no_grad``: it holds no autograd
    graph from one step to the next, and the kernels' backward
    differentiates the weight itself. A copied module (the EMA model is a
    ``deepcopy``) starts with an empty cache."""

    def __init__(self):
        self._key = None
        self._packed = None

    def __deepcopy__(self, memo):
        return PackedWeight()

    def get(self, w: torch.Tensor, pack=pack_weight) -> torch.Tensor:
        key = (pack, w.data_ptr(), w._version, w.device, w.dtype, tuple(w.shape))
        if key != self._key:
            with torch.no_grad():
                self._packed = pack(w)
            self._key = key
        return self._packed


def check_igemm_args(name: str, xh: torch.Tensor, w: torch.Tensor,
                     small_edge: bool = False) -> None:
    """Shapes, dtype, device and contiguity the implicit-GEMM kernels take:
    sub-volume edges that are multiples of 8, or with ``small_edge`` (the
    fused kernel's small-edge route) edges 4 and 2 at Cin % 8 == 0."""
    runtime.require(xh.dtype == torch.bfloat16, name,
                    f"input must be bfloat16, got {xh.dtype}")
    runtime.require(xh.dim() == 5 and xh.shape[1] == xh.shape[2] == xh.shape[3]
                    and xh.shape[1] >= 3, name,
                    f"expected (B, s+2, s+2, s+2, Cin), got {tuple(xh.shape)}")
    runtime.require(xh.is_contiguous(), name, "input must be contiguous")
    runtime.require(w.dim() == 5 and tuple(w.shape[2:]) == (3, 3, 3)
                    and w.shape[1] == xh.shape[4], name,
                    f"weight {tuple(w.shape)} is not (Cout, {xh.shape[4]}, 3, 3, 3)")
    runtime.require(w.shape[0] % 8 == 0, name,
                    f"Cout = {w.shape[0]} is not a multiple of 8")
    runtime.require(w.device == xh.device, name, "weight on another device")
    edge = xh.shape[1] - 2
    if small_edge:
        runtime.require(edge in (2, 4) and xh.shape[4] % 8 == 0, name,
                        f"the small-edge route takes edges 4 and 2 at Cin % 8 == 0, got "
                        f"edge {edge}, Cin {xh.shape[4]}")
    else:
        runtime.require(edge % 8 == 0, name, f"sub-volume edge {edge} is not a multiple of 8")
    runtime.require(xh.data_ptr() % 16 == 0, name, "input not 16-byte aligned")


def _launch(xh: torch.Tensor, w: torch.Tensor, packed: torch.Tensor):
    name = "conv3d"
    b, s, cin, cout = xh.shape[0], xh.shape[1] - 2, xh.shape[4], w.shape[0]
    out = torch.empty((b, s, s, s, cout), dtype=xh.dtype, device=xh.device)
    stream = runtime.stream_handle(xh.device)
    if route(cin) == "small_cin":
        fn = runtime.c_function(name, "conv3d_small_cin_launch", _ARGTYPES)
        err = fn(xh.data_ptr(), packed.data_ptr(), out.data_ptr(), b, s, cin, cout, stream)
    else:
        g = gemm_geometry(s, cin, cout)
        fn = runtime.c_function(name, "conv3d_valid_launch", IGEMM_ARGTYPES)
        err = fn(runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
                 packed.data_ptr(), out.data_ptr(), b, s, cin, cout, g.bn,
                 min(b * g.bricks * g.n_tiles, runtime.sm_count(xh.device)), stream)
    runtime.check_launch(name, err)
    profiling.launched("conv3d")
    flops.record("conv", flops.conv3d_valid_flops(out.shape, cin), "conv3d")
    return out


class _Conv3dValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w, packed):
        ctx.save_for_backward(xh, w)
        return _launch(xh, w, packed)

    @staticmethod
    def backward(ctx, grad):
        xh, w = ctx.saved_tensors
        gx, gw = runtime.plain_vjp(conv3d_valid_plain, [xh, w],
                                   ctx.needs_input_grad[:2], grad)
        return gx, gw, None


def conv3d_valid(xh: torch.Tensor, w: torch.Tensor,
                 cache: PackedWeight = None) -> torch.Tensor:
    """VALID 3^3 conv: the CUDA kernel for a CUDA tensor (bf16 only), the
    plain version for a CPU tensor. ``cache`` keeps the packed weight."""
    if xh.device.type == "cpu":
        return conv3d_valid_plain(xh, w)
    if xh.device.type != "cuda":
        raise ValueError(f"conv3d kernel: unsupported device {xh.device}")
    start = profiling.launch_clock()
    check_igemm_args("conv3d", xh, w)
    small = route(xh.shape[4]) == "small_cin"
    if small:
        runtime.require(w.shape[0] <= SMALL_COUT_MAX, "conv3d",
                        f"Cout = {w.shape[0]} > {SMALL_COUT_MAX} at Cin = {xh.shape[4]}")
    pack = pack_weight_small if small else pack_weight
    packed = cache.get(w, pack) if cache is not None else pack(w)
    out = _Conv3dValid.apply(xh, w, packed)
    profiling.launch_timed("conv3d", start)
    return out
