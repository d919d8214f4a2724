"""Where the small-edge kernel's time goes, CTA by CTA (needs a CUDA card).

    python -m diffusioniqt_tpu_torch.ops.kernels.small_edge_trace

Builds ``csrc/fused_block_small.cu`` with ``-DSMALL_EDGE_TRACE`` into
``build/torch_kernels/trace/``, which compiles in the source's ``TRACE``
stamps: each CTA writes the card's ``%globaltimer`` at its start, when its
first brick's TMA load has landed, when its transform warps have put their
share of that brick through Mish, when its consumers start multiplying,
when its last products finish and when its epilogue ends. For each shape
of :data:`SMALL_EDGE_SHAPES` (seeded inputs, the plan :func:`small_edge_plan`
picks) it prints the device ms of the conv kernel and of the reduction
(``torch.profiler``, 10 launches), the CTAs' median phase times in
microseconds, the main loop's microseconds per weight slice with its share
of the SM's bf16 tensor rate, and checks the output against the port's
build of the kernel at ``2^-7`` of its largest entry.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from diffusioniqt_tpu_torch.ops.kernels import fused_block as fm
from diffusioniqt_tpu_torch.ops.kernels import halo_exchange, runtime
from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight

_PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def build() -> ctypes.CDLL:
    out = runtime.BUILD_ROOT / "trace"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libfused_block_small_trace.so"
    subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-DSMALL_EDGE_TRACE",
                    "-I", str(runtime.CSRC), "-o", str(so),
                    str(runtime.CSRC / "fused_block_small.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.set_trace.argtypes = [ctypes.c_void_p]
    lib.fused_block_small_launch.argtypes = fm._SMALL_ARGTYPES
    lib.fused_block_small_launch.restype = ctypes.c_int
    return lib


def trace_shape(lib, shape, dev, gen) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, s, cin, cout, factor = shape
    x = torch.randn((n, s, s, s, cin), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
    ss = tuple(0.2 * torch.randn((n, 1, 1, 1, cin), generator=gen, device=dev)
               for _ in range(2))
    a, b = fm.groupnorm_affine(x, 1.0 + 0.1 * torch.randn(cin, generator=gen, device=dev),
                               0.1 * torch.randn(cin, generator=gen, device=dev), 8,
                               scale_shift=ss)
    a_tab, b_tab = fm.neighbor_tables(a, b, factor)
    xh = halo_exchange(x, factor)
    cache = PackedWeight()
    want = fm.fused_conv(xh, a_tab, b_tab, w, cache)
    packed = cache.get(w)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fm.small_edge_plan(n, s, cin, cout, sms)
    out = torch.empty_like(want)
    ws = (torch.empty((plan.ctas, 2, fm.TILE_ROWS, plan.bn), device=dev)
          if plan.cut else None)
    stamps = torch.zeros((plan.ctas, 8), dtype=torch.int64, device=dev)

    def launch(traced: bool):
        lib.set_trace(stamps.data_ptr() if traced else None)
        err = lib.fused_block_small_launch(
            runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
            a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), n, s, cin, cout, plan.bn // 2, plan.ctas,
            runtime.stream_handle(dev))
        runtime.check_launch("fused_block_small_trace", err)

    for _ in range(3):
        launch(False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            launch(False)
        torch.cuda.synchronize()
    device_ms = {e.key.split("<")[0].split("::")[-1]: e.self_device_time_total / 1e3 / 10
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "small_edge::" in e.key}
    launch(True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if err > 2.0 ** -7 * want.float().abs().max().item():
        raise AssertionError(f"small_edge_trace {shape}: the traced build disagrees")
    us = (stamps[:, :6].double() - stamps[:, 0].min().double()).cpu() / 1e3
    med = lambda v: float(v.median())  # noqa: E731
    slices = plan.k_slices * plan.m_blocks * plan.n_blocks / plan.ctas  # per CTA, on average
    loop_us = med(us[:, 4] - us[:, 3])
    per_slice_flop = 2.0 * fm.TILE_ROWS * plan.bn * 64  # 128 rows x BN x 64 channels
    return {
        "shape": shape, "ctas": plan.ctas, "cut": plan.cut,
        "device_ms": {k: round(v, 4) for k, v in device_ms.items()},
        "first_brick_loaded_us": med(us[:, 1] - us[:, 0]),
        "first_brick_mish_us": med(us[:, 2] - us[:, 1]),
        "first_products_us": med(us[:, 3] - us[:, 0]),
        "main_loop_us": loop_us,
        "epilogue_us": med(us[:, 5] - us[:, 4]),
        "last_cta_end_us": float(us[:, 5].max()),
        "us_per_slice": loop_us / slices,
        "tensor_rate_share": per_slice_flop / (loop_us / slices * 1e-6)
        / (_PEAK_BF16_FLOPS / sms),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("small_edge_trace needs a CUDA card")
    dev = torch.device("cuda", 0)
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for shape in fm.SMALL_EDGE_SHAPES:
        row = trace_shape(lib, shape, dev, gen)
        print({k: round(v, 3) if isinstance(v, float) else v for k, v in row.items()},
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
