"""Process groups: the port's counterpart of
``diffusioniqt_tpu/parallel/multihost.py`` (reference: the Accelerate
launcher over torch.distributed, trainer.py:296-303).

One process per rank. ``torchrun --nproc-per-node N`` starts them and sets
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``; :func:`launch` starts them itself (``spawn``), as
``python -m diffusioniqt_tpu_torch.infer --mesh N`` does. Each rank calls
:func:`initialize_multihost`, which joins the group over NCCL on the card
(one rank per card, ``cuda:LOCAL_RANK``) or gloo on the CPU, and
:func:`destroy` when it is done.

Imports torch and the standard library only.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this for a rank fails (gloo raises;
# NCCL's watchdog aborts the rank) instead of hanging its caller
COLLECTIVE_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(device="cuda", *, backend: Optional[str] = None,
                         init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         local_rank: Optional[int] = None) -> torch.device:
    """Join the process group and return the device this rank runs on.

    Arguments not given come from torchrun's environment. A no-op in a
    single process (no world size above 1 and no address), as the JAX
    function is: it returns ``device`` after checking that CUDA is there
    when asked for.

    The backend is NCCL for ``cuda`` and gloo for ``cpu`` unless
    ``backend`` names one. NCCL takes one card per rank: a host with more
    ranks than cards raises rather than putting two ranks on one card or
    falling back to fewer ranks or to the CPU. An explicit
    ``backend="gloo"`` on ``cuda`` may share cards (rank ``r`` on card
    ``r % count``): it measures correctness and overhead, not scaling."""
    device = torch.device(device)
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if world_size in (None, 1) and init_method is None:
        return _checked(device)
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if world_size is None or rank is None:
        raise ValueError("a process group needs its world size and this process's rank")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        _checked(device)
        if backend == "nccl":
            check_cards(max(_env_int("LOCAL_WORLD_SIZE") or world_size, local_rank + 1))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                            device_id=device if backend == "nccl" else None)
    return device


def _checked(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Main-process predicate (the reference's
    ``accelerator.is_main_process``, trainer.py:438-440): gate checkpoint
    writes and logging on it."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank; a no-op in a single process."""
    if dist.is_initialized():
        dist.barrier()


def local_batch_slice(global_batch: int, count: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The rows of a global batch that process ``index`` of ``count``
    (default: this process of the group) keeps. Raises on an indivisible
    batch instead of dropping the remainder rows, which would also give the
    ranks collectives of different shapes."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    if global_batch % count != 0:
        raise ValueError(f"global batch {global_batch} not divisible by process_count "
                         f"{count}; pad the batch or adjust batch_size")
    per = global_batch // count
    return slice(index * per, (index + 1) * per)


def check_cards(ranks: int) -> None:
    """Raise unless this host has a card for each of its ``ranks`` NCCL
    ranks: no two ranks on one card, no fallback to fewer ranks or to the
    CPU."""
    count = torch.cuda.device_count()
    if ranks > count:
        raise RuntimeError(
            f"{ranks} NCCL ranks on this host but {count} CUDA device(s): NCCL takes one "
            f"card per rank; start at most {count} rank(s) per host")


def _rank_main(fn, args, rank, world, init_method, device, backend, results):
    """One rank of :func:`launch`: join the group, run, leave, and report.
    The result crosses pickled to bytes, so no tensor is shared with a
    process that is about to exit."""
    try:
        device = initialize_multihost(device, backend=backend, world_size=world, rank=rank,
                                      local_rank=rank, init_method=init_method)
        try:
            out = fn(device, *args)
        finally:
            destroy()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, args: Sequence[Any] = (), *, nprocs: int, device="cuda",
           backend: Optional[str] = None, timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank_device, *args)`` on ``nprocs`` ranks, one spawned
    process each, in a process group of their own, and return every rank's
    result in rank order. The ranks meet through a file store (``file://``)
    in a fresh temporary directory that only this call knows, which gloo
    and NCCL both take: no port is picked and left open for another
    process to take before the ranks bind it. ``fn`` is a module-level
    function; ``args`` and the results are pickled (return CPU tensors).

    The parent fails if any rank fails (with that rank's traceback) or if
    the ranks are not done after ``timeout_s`` (None: no limit of the
    whole run; a collective still fails after :data:`COLLECTIVE_TIMEOUT_S`,
    and its rank with it); either way it terminates every rank it started,
    so a rank that died while the others wait in a collective does not hang
    the caller."""
    if nprocs < 1:
        raise ValueError("launch needs at least one rank")
    if torch.device(device).type == "cuda" and backend != "gloo":
        check_cards(nprocs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="rendezvous-")
    init_method = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, nprocs, init_method, str(device), backend,
                               results))
             for r in range(nprocs)]
    got, errors = {}, []
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        # read the queue while waiting: a rank exits only once what it put
        # there has been taken
        while len(got) < nprocs and not errors:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                errors = [(r, f"exited with code {p.exitcode}") for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0) and r not in got]
                if not errors and deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks not done after {timeout_s:.0f} s "
                                       f"(finished: {sorted(got)})")
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                errors.append((rank, out))
        if errors:
            # the other ranks' failures follow within moments (a collective
            # with a dead peer fails): report them all, the first one first
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if not ok:
                    errors.append((rank, out))
            raise RuntimeError("\n".join(f"rank {r} of {nprocs} failed:\n{msg}"
                                         for r, msg in errors))
        for p in procs:
            p.join(30)
        return [got[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:
                continue
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)


def run_ranks(fn: Callable, args: Sequence[Any] = (), *, nprocs: int = 0, device="cuda"):
    """``fn(device, *args)`` on every rank of the run an entry point was
    started in, and rank 0's result (each process's own under torchrun):

      * under torchrun (``WORLD_SIZE`` set), this process is one rank of
        that world, which must have ``nprocs`` ranks when ``nprocs`` > 1;
      * else with ``nprocs`` > 1, :func:`launch` spawns them, one card each
        on ``cuda`` (more than the cards raises);
      * else one process, no process group.

    The process group is left on success and on error."""
    world = _env_int("WORLD_SIZE")
    if world is None and nprocs > 1:
        return launch(fn, args, nprocs=nprocs, device=device)[0]
    if world is not None and nprocs > 1 and world != nprocs:
        raise ValueError(f"--mesh {nprocs} asked for in a torchrun world of {world} ranks")
    device = initialize_multihost(device)
    try:
        return fn(device, *args)
    finally:
        destroy()
