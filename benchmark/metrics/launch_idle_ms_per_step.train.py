"""``launch_idle_ms_per_step.train``: milliseconds per optimizer step in which
no kernel ran on the card (the trace's idle gaps) while the trainer's
thread was in the program's spans ``trainer.forward``,
``trainer.backward`` or ``trainer.update``: the card waiting for the
host's launches, in the traced stretch."""

from pathlib import Path

from benchmark.harness import load_module

_p = load_module(Path(__file__).with_name("_program.py"))


def read(trace):
    prog = _p.read(trace, "trainer.step")
    if prog is None:
        return None
    threads = {s.thread for s in prog.anchors}
    host = _p.union(prog.interval(s) for s in
                    prog.spans("trainer.forward", "trainer.backward", "trainer.update")
                    if s.thread in threads)
    return _p.overlap_us(_p.idle(trace), host) / 1e3 / len(prog.anchors)
