"""Elementwise arithmetic as XLA compiles it for the reference.

XLA rewrites a division by a constant into a product with the constant's
reciprocal, folds `x / c * n` into one product with `(1 / c) * n`, and
JAX's hypot is the overflow-safe `max * sqrt(1 + (min / max)^2)` with a
correctly rounded square root.  A point on a bin edge lands in the
reference's bin only when the port rounds the same way, so the binning
code of the port uses these forms.  Each constant is rounded in the
input's dtype, as XLA folds it.  torch's vectorised CPU square root is not
correctly rounded (one ulp off on some inputs); CUDA's is, and on the CPU
`sqrt` takes numpy's, which is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["div_const", "scale_const", "sqrt", "hypot"]


def _np_dtype(x: torch.Tensor):
    return np.float32 if x.dtype == torch.float32 else np.float64


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` for a Python constant c: x times the rounded 1 / c."""
    t = _np_dtype(x)
    return x * float(t(1) / t(c))


def scale_const(x: torch.Tensor, c: float, n: float) -> torch.Tensor:
    """`x / c * n` for Python constants c and n: x times the rounded
    (1 / c) * n."""
    t = _np_dtype(x)
    return x * float((t(1) / t(c)) * t(n))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (IEEE, as XLA's)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot: max * sqrt(1 + (min / max)^2), 0 where both are 0 and
    inf where either is."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    r = torch.where(hi == 0, hi, hi * sqrt(1 + (lo / safe) ** 2))
    return torch.where(torch.isinf(ax) | torch.isinf(ay),
                       torch.full_like(r, math.inf), r)
