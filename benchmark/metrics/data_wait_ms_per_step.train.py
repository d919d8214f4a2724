"""``data_wait_ms_per_step.train``: host milliseconds per optimizer step that
the trainer waits for its next batch (the program's span
``trainer.data_wait`` around ``next`` on the loader's queue,
``train/trainer.py::ImagenTrainer.train_step``), in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "trainer.step")
    if prog is None:
        return None
    ms = _p.host_ms(prog.spans("trainer.data_wait"))
    return None if ms is None else ms / len(prog.anchors)
