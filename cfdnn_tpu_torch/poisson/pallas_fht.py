"""Four-step real Hartley transform, the "pallas_fft" Poisson transform
(port of `cfdnn_tpu/poisson/pallas_fht.py`): host-side constants, the
plain twins of the two kernels and the dense reference.

Along one periodic axis of length N = N1*N2 (digit split n = n1*N2 + n2,
N1 <= 8 and N2 in {32 ... 256}) the Hartley transform factorizes into

  1. a cas stage over the slow digit, tt[k1] = sum_n1 H1[k1, n1] x[n1, :],
     with H1 = cas(2 pi k1 n1 / N1) (all +-1 for N1 in {1, 2, 4});
  2. a twiddle with the k1 flip tf = tt[(N1 - k1) % N1]:
       u_c = c tt + s tf,  u_s = c tf - s tt,  (c, s) = cos/sin(2 pi k1 n2/N);
  3. a contraction over the fast digit,
       X[k1, k2] = sum_n2 C2[k2, n2] u_c[n2] + S2[k2, n2] u_s[n2]
                 = Re DFT_N2(u_c + i u_s)[k2]
     (the twins below contract densely; the kernels run it as an FFT).

The output stays in DIGIT-PERMUTED order: position p = k1*N2 + k2 holds
wavenumber k = k1 + N1*k2, and the modal symbol is built in the same order
(`lam_permuted`), so no reordering pass is ever needed. The inverse is the
unnormalized adjoint (a forward and an inverse pass give N times the
input); every 1/N goes into the modal pass's `norm`.

The kernels themselves are `ops.kernels.fht_pass` (one forward or inverse
pass along one axis) and `ops.kernels.fht_modal` (forward, the 1/lambda
scale with null modes pinned, and the inverse, along the last transformed
axis in one pass), in `csrc/fht.cuh`. Their twins below are the
exact-table algebra of the reference's `_fwd_groups` / `_inv_groups` /
`_kernel_modal` on whole tensors in the working dtype. The reference's
bf16 split tables (`csv`, `csr`) compensate a matrix unit that multiplies
in bf16 only; the port computes in the working dtype and has none.

Tables are built in float64 NumPy and cast. Each cos/sin entry of the N2
stage depends only on k2*n2 mod N2 and each twiddle on k1*n2 (< N), so the
kernel reads one N2-entry and one N-entry table (`PFHTAxis.table`); the
twin's C2/S2 are built from the same reduced angles, which are at least
as accurate as the reference's unreduced 2 pi k2 n2 / N2 (those differ by
<= ~2e-13 at N2 = 256).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# The largest slow digit the kernels and their tables take.
MAX_N1 = 8


def _split_mxu(N: int) -> Optional[Tuple[int, int]]:
    """N = N1*N2 with the reference's choice of N2 (the digit-permuted
    modal order depends on it) and N1 <= 8."""
    for n2 in (128, 256, 192, 64, 96, 160, 224, 32):
        if N % n2 == 0 and N // n2 <= MAX_N1:
            return N // n2, n2
    return None


def _cas_n1(N1: int) -> np.ndarray:
    """H1 = cas(2 pi k1 n1 / N1) with the +-1/0 entries snapped exactly."""
    k1 = np.arange(N1)
    ang = 2 * np.pi * np.outer(k1, k1) / N1
    H1 = np.cos(ang) + np.sin(ang)
    H1 = np.where(np.abs(H1) < 1e-12, 0.0, H1)
    H1 = np.where(np.abs(H1 - 1) < 1e-12, 1.0, H1)
    return np.where(np.abs(H1 + 1) < 1e-12, -1.0, H1)


@dataclasses.dataclass(frozen=True, eq=False)
class PFHTAxis:
    """Constants of one periodic axis of length N = N1*N2, on a device in
    the working dtype (the reference's PFHTAxis less its bf16 splits).

    H1 stays Python floats (scalar weights); C2, S2 (N2, N2) and the
    twiddles ctw, stw (N1, N2) are the twin's; `table` is the kernel's,
    flat: [cos, sin](2 pi m / N2) interleaved for m < N2, then [cos,
    sin](2 pi m / N) interleaved for m < N, then H1 and H1 with its rows
    flipped (row k1 is H1[(N1 - k1) % N1]), each padded to 8 x 8.
    """

    N: int
    N1: int
    N2: int
    H1: tuple
    C2: torch.Tensor
    S2: torch.Tensor
    ctw: torch.Tensor
    stw: torch.Tensor
    table: torch.Tensor

    @classmethod
    def make(cls, N: int, dtype, n2: Optional[int] = None, *,
             device) -> Optional["PFHTAxis"]:
        """The axis constants, or None where N has no split. `n2` forces
        the fast-digit size (N % n2 == 0 and N / n2 <= 8), as the
        reference's; `device` is required (the port has no default
        device)."""
        if n2 is not None:
            sp = ((N // n2, n2) if (N % n2 == 0 and N // n2 <= MAX_N1)
                  else None)
        else:
            sp = _split_mxu(N)
        if sp is None:
            return None
        N1, N2 = sp
        H1 = _cas_n1(N1)
        m2 = np.arange(N2)
        ang2 = 2 * np.pi * m2 / N2
        cos2, sin2 = np.cos(ang2), np.sin(ang2)
        red = np.outer(m2, m2) % N2
        ang = 2 * np.pi * np.arange(N) / N
        cosN, sinN = np.cos(ang), np.sin(ang)
        tw = np.outer(np.arange(N1), m2)               # k1*n2 < N
        h1 = np.zeros((MAX_N1, MAX_N1))
        h1f = np.zeros((MAX_N1, MAX_N1))
        h1[:N1, :N1] = H1
        h1f[:N1, :N1] = H1[(N1 - np.arange(N1)) % N1]
        table = np.concatenate([np.stack([cos2, sin2], 1).reshape(-1),
                                np.stack([cosN, sinN], 1).reshape(-1),
                                h1.reshape(-1), h1f.reshape(-1)])

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=device).to(dtype)

        return cls(N=N, N1=N1, N2=N2,
                   H1=tuple(tuple(float(w) for w in row) for row in H1),
                   C2=dev(cos2[red]), S2=dev(sin2[red]),
                   ctw=dev(cosN[tw]), stw=dev(sinN[tw]), table=dev(table))

    def lam_permuted(self, lam: np.ndarray) -> np.ndarray:
        """out[k1*N2 + k2] = lam[k1 + N1*k2] (the transform's order)."""
        return lam.reshape(self.N2, self.N1).T.reshape(-1)


def axis_supported(n: int) -> bool:
    """The reference's policy: the four-step where N splits and N >= 64
    (below that the dense eigenbasis is taken)."""
    return n >= 64 and _split_mxu(n) is not None


# ---------------------------------------------------------------------------
# The kernels' plain twins
# ---------------------------------------------------------------------------


def _scalar_comb(groups, weights):
    """sum_i w_i * groups[i], the 0 weights skipped and +-1 as adds."""
    acc = None
    for g, w in zip(groups, weights):
        if w == 0.0:
            continue
        term = g if w == 1.0 else (-g if w == -1.0 else g * w)
        acc = term if acc is None else acc + term
    return acc


def _lines(f, axis, t: PFHTAxis):
    """f with `axis` last, split into its N1 groups of N2 (views)."""
    x = f.movedim(axis, -1)
    if x.shape[-1] != t.N:
        raise ValueError(f"axis {axis} has length {x.shape[-1]}, the "
                         f"transform {t.N}")
    return x, [x[..., i * t.N2:(i + 1) * t.N2] for i in range(t.N1)]


def _fwd_groups(xs, t: PFHTAxis):
    """The N1 forward output groups (digit-permuted)."""
    N1 = t.N1
    cs = torch.cat([t.C2, t.S2], dim=0)                   # (2 N2, N2)
    tt = [_scalar_comb(xs, t.H1[k]) for k in range(N1)]
    out = []
    for k1 in range(N1):
        tf = tt[(N1 - k1) % N1]
        c, s = t.ctw[k1], t.stw[k1]
        u_c = c * tt[k1] + s * tf
        u_s = c * tf - s * tt[k1]
        out.append(torch.matmul(torch.cat([u_c, u_s], dim=-1), cs))
    return out


def _inv_groups(Xg, t: PFHTAxis):
    """The unnormalized inverse from the N1 modal groups (the adjoint)."""
    N1, N2 = t.N1, t.N2
    cs = torch.cat([t.C2, t.S2], dim=1)                   # (N2, 2 N2)
    a1, a2 = [], []
    for k1 in range(N1):
        vcs = torch.matmul(Xg[k1], cs)
        v_c, v_s = vcs[..., :N2], vcs[..., N2:]
        c, s = t.ctw[k1], t.stw[k1]
        a1.append(c * v_c - s * v_s)
        a2.append(s * v_c + c * v_s)
    out = []
    for n1 in range(N1):
        w2 = tuple(t.H1[n1][(N1 - k) % N1] for k in range(N1))
        out.append(_scalar_comb(a1, t.H1[n1]) + _scalar_comb(a2, w2))
    return out


def fht_pass_twin(f: torch.Tensor, axis: int, t: PFHTAxis,
                  inverse: bool = False) -> torch.Tensor:
    """Plain twin of `ops.kernels.fht_pass`: one forward (digit-permuted
    output) or unnormalized inverse Hartley pass along `axis` of a 3-D
    tensor, in its dtype."""
    x, groups = _lines(f, axis, t)
    out = _inv_groups(groups, t) if inverse else _fwd_groups(groups, t)
    return torch.cat(out, dim=-1).movedim(-1, axis).contiguous()


def fht_modal_twin(f: torch.Tensor, axis: int, t: PFHTAxis,
                   lam_axis: torch.Tensor, lam_rest: torch.Tensor, *,
                   thr: float, norm: float) -> torch.Tensor:
    """Plain twin of `ops.kernels.fht_modal` (the reference's
    `_kernel_modal`): the forward pass along `axis`, each mode times
    norm / (lam_axis + lam_rest) with |lam_axis + lam_rest| < thr pinned to
    0, then the unnormalized inverse. lam_axis: (N,) in the digit-permuted
    order; lam_rest: f's shape without `axis`."""
    x, groups = _lines(f, axis, t)
    Xg = _fwd_groups(groups, t)
    lr = lam_rest[..., None]
    scaled = []
    for k1, g in enumerate(Xg):
        denom = lam_axis[k1 * t.N2:(k1 + 1) * t.N2] + lr
        null = torch.abs(denom) < thr
        inv = torch.where(null, torch.zeros_like(denom),
                          norm / torch.where(null, torch.ones_like(denom),
                                             denom))
        scaled.append(g * inv)
    out = _inv_groups(scaled, t)
    return torch.cat(out, dim=-1).movedim(-1, axis).contiguous()


# ---------------------------------------------------------------------------
# Dense reference (the residual check of FDMPoissonSolver and the tests)
# ---------------------------------------------------------------------------


def reference_forward(x: torch.Tensor, axis: int,
                      t: PFHTAxis) -> torch.Tensor:
    """Dense-matrix Hartley transform along `axis` in the kernels'
    digit-permuted order (an observability path, not a hot one)."""
    N = t.N
    k1 = np.arange(t.N1)
    k2 = np.arange(t.N2)
    p = (k1[:, None] * t.N2 + k2[None, :]).reshape(-1)      # array order
    k = (k1[:, None] + t.N1 * k2[None, :]).reshape(-1)      # wavenumber
    n = np.arange(N)
    ang = 2 * np.pi * np.outer(k, n) / N
    H = np.cos(ang) + np.sin(ang)
    Hp = np.zeros_like(H)
    Hp[p, :] = H
    M = torch.as_tensor(Hp, device=x.device).to(x.dtype)
    sub = {0: "ab,byz->ayz", 1: "ab,xbz->xaz", 2: "ab,xyb->xya"}[axis]
    return torch.einsum(sub, M, x)
