"""Batched tridiagonal (Thomas) solve along one axis
(port of `cfdnn_tpu/ops/tridiag.py`).

A forward elimination and a back substitution over the solve axis, batched
over all other axes. The reference computes it with `lax.scan`, outside
any kernel; the port loops over the solve axis in plain torch, each
point of the axis a handful of elementwise launches over one batch plane
(4 forward, 1 back; `addcmul` forms each a - b c in one), and one stack.
"""

from __future__ import annotations

import torch


def thomas(lower, diag, upper, rhs, axis: int):
    """Solve tridiagonal systems along `axis`.

    lower/diag/upper broadcast against rhs (full-rank or scalar). A 1-D
    length-n vector is taken along the solve axis, never by trailing-dim
    alignment, which would lay the coefficients across the batch whenever
    a trailing dim equals n (axis=1 on a cube). Any other shape raises
    ValueError. lower[0] and upper[-1] along the solve axis are ignored.
    """
    n = rhs.shape[axis]
    r = torch.movedim(rhs, axis, 0)

    def prep(c):
        # broadcast along the solve axis only: batch dims of size 1 stay so
        # and broadcast inside the sweep arithmetic
        if not torch.is_tensor(c):
            # a device fill, not a host copy (a CUDA graph capture refuses
            # one)
            c = torch.full((), float(c), dtype=rhs.dtype, device=rhs.device)
        if c.ndim == 1 and c.shape[0] == n:
            s = [1] * rhs.ndim
            s[axis] = n
            c = c.reshape(s)
        elif c.ndim != rhs.ndim:
            if c.ndim != 0:
                raise ValueError(
                    f"thomas coefficient of shape {tuple(c.shape)} is "
                    f"ambiguous against rhs {tuple(rhs.shape)} (solve axis "
                    f"{axis}, n={n}); pass a scalar, a length-n vector, or "
                    f"a full-rank broadcastable array")
            c = c.expand(rhs.shape)
        c = torch.movedim(c, axis, 0)
        if c.shape[0] != n:
            c = c.expand((n,) + tuple(c.shape[1:]))
        return c

    l_, d_, u_ = prep(lower), prep(diag), prep(upper)
    cp = dp = torch.zeros_like(r[0])
    cps, dps = [], []
    for i in range(n):
        li = l_[i]
        denom = torch.addcmul(d_[i], li, cp, value=-1.0)
        cp = u_[i] / denom
        dp = torch.addcmul(r[i], li, dp, value=-1.0) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(r[0])
    xs = [None] * n
    for i in reversed(range(n)):
        x = torch.addcmul(dps[i], cps[i], x, value=-1.0)
        xs[i] = x
    # stacked along the solve axis: the result is contiguous
    return torch.stack(xs, dim=axis)
