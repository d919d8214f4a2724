"""``loader_ms_per_batch.train``: host milliseconds per batch that the
loader's prefetch thread takes to make it (the program's span
``loader.batch``: the items' crops, the collate, the cast, pin and copy to
the card, ``data/loader.py::DataLoader``), over the batches it started in
the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "trainer.step")
    if prog is None:
        return None
    spans = prog.spans("loader.batch")
    return _p.host_ms(spans) / len(spans) if spans else None
