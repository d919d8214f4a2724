"""``backward_ms_per_step.train``: device milliseconds per optimizer step in
the program's span ``trainer.backward`` (each microbatch's
``loss.backward()``: the Blocks' recompute, the conv gradients; idle time
inside it included), from the span's CUDA events, in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "trainer.step")
    if prog is None:
        return None
    ms = _p.device_ms(prog.spans("trainer.backward"))
    return None if ms is None else ms / len(prog.anchors)
