"""Four-step fast Hartley transform, the "fht" Poisson transform (port of
`cfdnn_tpu/poisson/fht.py`), in plain torch: no kernel carries it.

The Hartley basis (cas = cos + sin) diagonalizes symmetric circulants, so
it replaces the dense periodic eigenbasis of the FDM solver, and it
factorizes: with N = N1*N2 (k = k1 + N1 k2, n = n1 N2 + n2)

  H[k] = sum_{n2} [ cos(2 pi k n2/N) t[k1,n2] + sin(2 pi k n2/N) t~[k1,n2] ]

with t the cas_{N1} transform over n1 and t~[k1] = t[(N1-k1) mod N1]. The
output is in DIGIT-PERMUTED order (position p = k1*N2 + k2 holds
wavenumber k1 + N1*k2; `lam_permuted` builds the symbol in that order).
The inverse is the adjoint divided by N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _split(N: int) -> Optional[Tuple[int, int]]:
    """N = N1*N2 with N1 >= N2, N2 the largest divisor <= sqrt(N)."""
    best = None
    for n2 in range(2, int(np.sqrt(N)) + 1):
        if N % n2 == 0:
            best = (N // n2, n2)
    return best


@dataclasses.dataclass(frozen=True, eq=False)
class FHTAxis:
    """Constants for one periodic axis of length N = N1*N2, on a device
    in the working dtype."""

    N: int
    N1: int
    N2: int
    H1: torch.Tensor       # (N1, N1) cas matrix
    C2: torch.Tensor       # (N2, N2) cos matrix
    S2: torch.Tensor       # (N2, N2) sin matrix
    cos_tw: torch.Tensor   # (N1, N2) twiddle cos(2 pi k1 n2 / N)
    sin_tw: torch.Tensor   # (N1, N2)

    @classmethod
    def make(cls, N: int, dtype, *, device) -> Optional["FHTAxis"]:
        sp = _split(N)
        if sp is None:
            return None
        N1, N2 = sp
        k1 = np.arange(N1)
        k2 = np.arange(N2)
        ang1 = 2 * np.pi * np.outer(k1, k1) / N1
        ang2 = 2 * np.pi * np.outer(k2, k2) / N2
        th = 2 * np.pi * np.outer(k1, k2) / N

        def dev(a):
            return torch.as_tensor(a, device=device).to(dtype)

        return cls(N=N, N1=N1, N2=N2,
                   H1=dev(np.cos(ang1) + np.sin(ang1)),
                   C2=dev(np.cos(ang2)), S2=dev(np.sin(ang2)),
                   cos_tw=dev(np.cos(th)), sin_tw=dev(np.sin(th)))

    def lam_permuted(self, lam: np.ndarray) -> np.ndarray:
        """out[k1*N2 + k2] = lam[k1 + N1*k2] (the transform's order)."""
        return lam.reshape(self.N2, self.N1).T.reshape(-1)


def _flip_k1(t):
    """t[(N1 - k1) mod N1] along dim 0."""
    return torch.cat([t[:1], t[1:].flip(0)], dim=0)


def _bcast(tab, ndim_rest):
    return tab.reshape(tab.shape + (1,) * ndim_rest)


def fht_forward(x: torch.Tensor, axis: int, t: FHTAxis) -> torch.Tensor:
    """Hartley transform along `axis` (output digit-permuted)."""
    x = torch.movedim(x, axis, 0)
    rest = x.shape[1:]
    xs = x.reshape((t.N1, t.N2) + rest)                     # [n1, n2, ...]
    tt = torch.einsum("ab,b...->a...", t.H1, xs)
    tf = _flip_k1(tt)
    c = _bcast(t.cos_tw, len(rest))
    s = _bcast(t.sin_tw, len(rest))
    u_c = c * tt + s * tf
    u_s = c * tf - s * tt
    X = (torch.einsum("kc,ac...->ak...", t.C2, u_c)
         + torch.einsum("kc,ac...->ak...", t.S2, u_s))
    return torch.movedim(X.reshape((t.N,) + rest), 0, axis)


def fht_inverse(X: torch.Tensor, axis: int, t: FHTAxis) -> torch.Tensor:
    """Adjoint of fht_forward divided by N (the exact inverse)."""
    X = torch.movedim(X, axis, 0)
    rest = X.shape[1:]
    Xs = X.reshape((t.N1, t.N2) + rest)                     # [k1, k2, ...]
    v_c = torch.einsum("kc,ak...->ac...", t.C2, Xs)
    v_s = torch.einsum("kc,ak...->ac...", t.S2, Xs)
    c = _bcast(t.cos_tw, len(rest))
    s = _bcast(t.sin_tw, len(rest))
    tt = (c * v_c - s * v_s) + _flip_k1(s * v_c + c * v_s)
    xs = torch.einsum("ab,b...->a...", t.H1, tt)
    out = xs.reshape((t.N,) + rest) / t.N
    return torch.movedim(out, 0, axis)
