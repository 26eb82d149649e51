"""Spans and counters of the program, off unless ``enable()`` is called.

A span is a ``torch.profiler.record_function`` range named
``yhair.<layer>``. A profiler records it in the trace that holds the
device's events, on the same clock, so the device time launched inside
a span and the device's idle time under it can be read from one trace.
With tracing off, ``span`` returns one shared no-op context: a global
read and a ``with``. Spans open and close on the host only; they never
synchronize the device.

A counter sums values on the device without a sync: ``add(name,
value)`` takes an int64 tensor (or a Python int); ``counters()`` reads
every sum with one. The caller guards the work that makes a value
(``if trace.enabled(): trace.add(...)``), so with tracing off no
reduction runs.

    from yhair_tpu_torch.utils import trace
    trace.reset(); trace.enable()
    ...                       # under torch.profiler, or not
    counts = trace.counters(); trace.disable()
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

_ON = False
_OFF = nullcontext()
_SUMS = {}


def enable():
    """Open spans and count from now on."""
    global _ON
    _ON = True


def disable():
    global _ON
    _ON = False


def enabled():
    return _ON


def span(name):
    """A context around one layer's work: a profiler range when tracing
    is on, else the shared no-op context."""
    if _ON:
        return torch.profiler.record_function(name)
    return _OFF


def add(name, value):
    """Add value (an int64 tensor of one element, or an int) to the
    counter ``name``; no sync."""
    _SUMS[name] = _SUMS.get(name, 0) + value


def counters():
    """{name: int}: every counter's sum, read with one sync."""
    out = {k: int(v) for k, v in _SUMS.items()
           if not isinstance(v, torch.Tensor)}
    names = [k for k in _SUMS if k not in out]
    if names:
        dev = _SUMS[names[0]].device
        vals = torch.stack([_SUMS[k].reshape(()).to(dev, torch.int64)
                            for k in names]).tolist()
        out.update(zip(names, vals))
    return out


def reset():
    """Zero every counter."""
    _SUMS.clear()
