"""``volume_prep_ms.serve``: host milliseconds per served volume in the
program's span ``infer.prepare`` (``infer.py::infer_volume`` before its
first window: the dataset, the windows kept, the z-score, the copy to the
card, the stitcher's buffers), in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "infer.volume")
    if prog is None:
        return None
    ms = _p.host_ms(prog.spans("infer.prepare"))
    return None if ms is None else ms / len(prog.anchors)
