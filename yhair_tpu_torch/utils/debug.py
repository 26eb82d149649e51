"""NaN debugging and finite checks (``yhair_tpu/utils/debug.py``).

* ``enable_debug_nans()`` raises ``FloatingPointError`` at the first
  operation whose floating output holds a NaN, naming the operation:
  a ``TorchDispatchMode`` checks every output of every aten op, forward
  and backward, and ``torch.autograd.set_detect_anomaly(True)`` adds the
  forward traceback of a failing backward op. Every op then waits for
  the device, so it is for debugging. The CLIs' ``--debug-nans``.
* ``assert_finite(tensors, name)`` raises where a tensor holds a NaN or
  an inf, only when ``YHAIR_CHECK_FINITE=1`` (or after
  ``enable_finite_checks()``). ``train_step_fn`` calls it on the loss
  and the gradients, a cheap last-line check for long runs.
"""

from __future__ import annotations

import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_finite_checks = os.environ.get("YHAIR_CHECK_FINITE") == "1"
_nan_mode = None


class NanCheck(TorchDispatchMode):
    """Raises at the first aten op whose floating output holds a NaN.
    Allocations without values (``empty*``) are not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.startswith(("empty", "new_empty")):
            return out
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN produced by {func} (output {tuple(t.shape)})")
        return out


def enable_debug_nans() -> None:
    """Check every op for NaN outputs from now on, in this thread."""
    global _nan_mode
    if _nan_mode is None:
        _nan_mode = NanCheck()
        _nan_mode.__enter__()
        torch.autograd.set_detect_anomaly(True)


def disable_debug_nans() -> None:
    global _nan_mode
    if _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
        torch.autograd.set_detect_anomaly(False)


def enable_finite_checks(on: bool = True) -> None:
    global _finite_checks
    _finite_checks = on


def finite_checks_enabled() -> bool:
    return _finite_checks


def assert_finite(tensors, name: str) -> None:
    """Raise FloatingPointError if any tensor of ``tensors`` (a tensor or
    a dict, list or tuple of them) holds a NaN or an inf; a no-op unless
    the checks are on."""
    if not _finite_checks:
        return
    for t in tree_flatten(tensors)[0]:
        if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
