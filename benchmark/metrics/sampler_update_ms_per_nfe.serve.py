"""``sampler_update_ms_per_nfe.serve``: device milliseconds per denoiser
forward in the program's span ``sampler.update`` (the ancestral step after
the denoiser: x0, the posterior, the noise draw, the next state;
``diffusion/gaussian.py::Imagen.p_sample``), from the span's CUDA events,
in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "infer.volume")
    forwards = trace.counts.get("forwards", 0)
    if prog is None or not forwards:
        return None
    ms = _p.device_ms(prog.spans("sampler.update"))
    return None if ms is None else ms / forwards
