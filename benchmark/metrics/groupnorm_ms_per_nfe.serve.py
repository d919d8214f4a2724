"""``groupnorm_ms_per_nfe.serve``: device milliseconds per denoiser forward
in the program's span ``block.norm`` (each Block's GroupNorm statistics,
affine coefficients and neighbour tables before its halo and fused conv,
``ops/kernels/fused_block.py::_Block.forward``), from the span's CUDA
events, in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "infer.volume")
    forwards = trace.counts.get("forwards", 0)
    if prog is None or not forwards:
        return None
    ms = _p.device_ms(prog.spans("block.norm"))
    return None if ms is None else ms / forwards
