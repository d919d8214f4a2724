"""Opt-in NaN detection (counterpart of ``diffusioniqt_tpu/utils/debug.py``).

The reference turns ``torch.autograd.set_detect_anomaly(True)`` on for
every run (imagen_pytorch3D.py:34); that checks the backward only. The JAX
package's ``jax_debug_nans`` traps a NaN wherever an operation produces
one, in the forward too. The counterpart here is anomaly detection for the
backward plus :class:`NaNTrap`, a dispatch mode that checks the floating
outputs of every operation while it is on; neither is on unless asked for,
so a run that does not ask pays nothing.

Hand-written kernels launch outside the dispatcher: a NaN that a kernel
writes is trapped at the first operation that reads it and passes it on.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# operations whose output is uninitialised memory, not a computed value
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "set_"}


class NaNTrap(TorchDispatchMode):
    """Raise ``FloatingPointError`` naming the operation as soon as one
    returns a floating tensor holding a NaN (the forward counterpart of
    ``jax_debug_nans``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


_GLOBAL: List[Tuple[NaNTrap, bool]] = []


def enable_nan_checks(enable: bool = True) -> None:
    """Trap NaNs from now on (forward and backward) in this thread, or stop
    trapping them."""
    if enable and not _GLOBAL:
        trap = NaNTrap()
        trap.__enter__()
        _GLOBAL.append((trap, torch.is_anomaly_enabled()))
        torch.autograd.set_detect_anomaly(True)
    elif not enable and _GLOBAL:
        trap, anomaly = _GLOBAL.pop()
        trap.__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(anomaly)


@contextlib.contextmanager
def nan_check_scope() -> Iterator[None]:
    """NaNs trapped inside the block, forward and backward."""
    with NaNTrap(), torch.autograd.detect_anomaly():
        yield


def _walk(tree: Any, path: str):
    """``(path, tensor)`` of every tensor in nested dicts, lists, tuples and
    modules' state dicts (array leaves become tensors), paths written as
    ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        try:  # in key order, as a JAX pytree flattens a dict
            items = sorted(tree.items())
        except TypeError:
            items = list(tree.items())
        for k, v in items:
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        yield from _walk(tree.state_dict(), path)
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif tree is not None and not isinstance(tree, (str, bytes)):
        yield path, torch.as_tensor(tree)


def assert_tree_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first 8 paths of ``tree``
    (nested dicts, lists, tuples, modules' state dicts) whose values are
    not all finite."""
    bad: List[str] = []
    for path, t in _walk(tree, ""):
        if (t.is_floating_point() or t.is_complex()) and not bool(torch.isfinite(t).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:8]}")

