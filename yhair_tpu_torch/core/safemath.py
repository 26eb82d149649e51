"""Gradient-gated primitives (``yhair_tpu/core/safemath.py``).

Values are those of the plain forms; only the gradient is zeroed on the
degenerate set, where the plain form's derivative is inf or NaN and
``torch.where`` would turn it into NaN (its backward multiplies the
unselected branch's derivative by 0). Each gate is a ``.detach()`` of the
sub-expression the reference wraps in ``jax.lax.stop_gradient``.
"""

from __future__ import annotations

import torch


def sqrt_rn(x):
    """Correctly rounded square root of a float32 tensor on every device.

    torch's vectorised float32 sqrt on the CPU is off by one ulp on about
    1% of inputs; the float64 root rounded to float32 is the correctly
    rounded one (as XLA's and CUDA's float32 sqrt are)."""
    return torch.sqrt(x.double()).to(x.dtype)


def safe_normalize(v, eps=1e-12):
    """v / ||v|| where ||v|| > eps, else v / eps, along the last axis;
    the gradient is zero where ||v|| <= eps."""
    n2 = (v * v).sum(-1, keepdim=True)
    safe = n2 > eps * eps
    n = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    return torch.where(safe, v / n, v.detach() * (1.0 / eps))
