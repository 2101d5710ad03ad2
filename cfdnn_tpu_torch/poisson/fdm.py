"""Fast-diagonalization pressure-Poisson solver
(port of `cfdnn_tpu/poisson/fdm.py`, the "fft" and "eig" axis kinds).

  L = Lx (+) Ly (+) Lz  (Kronecker sum of 1-D discrete Laplacians)

Per axis the transform that diagonalizes the 1-D operator is
  - periodic + uniform  -> real FFT, eigenvalues (2 cos(2 pi k/N) - 2)/h^2
    (`torch.fft`, cuFFT on the card); or, with transform="matmul", the
    dense real eigenbasis of the circulant
  - wall/inflow/outflow (uniform OR stretched) -> a dense eigenbasis of the
    symmetrized stretched operator, built in float64 NumPy on the host and
    applied as one (N, N) matmul.

The host-side construction (`_periodic_eig`, `_axis_transform`) is the
reference's NumPy code unchanged. The device apply is: eigenbasis matmuls
on the real array, rfftn over the periodic axes, scaling by 1/lambda with
the null mode pinned, irfftn, and the inverse eigenbasis matmuls. It is
exactly consistent with `ops.operators.laplacian`, so a projection drives
the discrete divergence to roundoff.

Not ported: the "fht" (ROADMAP A.13) and "pallas_fft" (ROADMAP B.11)
periodic transforms, which raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import BCType, Config, pressure_bc_kinds
from ..mesh import Mesh


@dataclasses.dataclass
class _AxisTransform:
    kind: str                      # 'fft' | 'eig' | 'none'
    lam: np.ndarray                # eigenvalues (modal Laplacian symbol)
    V: Optional[np.ndarray] = None     # eig: inverse-transform matrix
    Vinv: Optional[np.ndarray] = None  # eig: forward-transform matrix


def _periodic_eig(ax) -> _AxisTransform:
    """Real orthogonal eigenbasis of the periodic circulant O2 Laplacian
    (float64), applied as (N, N) matmuls: the same modal symbol as the FFT
    path to roundoff."""
    n, h = ax.n, ax.h
    L = np.zeros((n, n))
    idx = np.arange(n)
    L[idx, idx] = -2.0 / (h * h)
    L[idx, (idx + 1) % n] += 1.0 / (h * h)
    L[idx, (idx - 1) % n] += 1.0 / (h * h)
    lam, Q = np.linalg.eigh(L)
    return _AxisTransform(kind="eig", lam=lam, V=Q, Vinv=Q.T)


def _axis_transform(ax, bc: BCType, kinds: Tuple[str, str],
                    periodic_matmul: bool = False) -> _AxisTransform:
    n = ax.n
    if n == 1:
        return _AxisTransform(kind="none", lam=np.zeros(1))
    if bc == BCType.PERIODIC:
        if not ax.uniform:
            raise ValueError("FDM Poisson requires uniform spacing on periodic axes")
        if periodic_matmul:
            return _periodic_eig(ax)
        k = np.arange(n)
        lam = (2.0 * np.cos(2.0 * np.pi * k / n) - 2.0) / (ax.h * ax.h)
        return _AxisTransform(kind="fft", lam=lam)
    lo, hi = kinds
    aS, aP, aN = ax.laplacian_metrics(periodic=False, lo=lo, hi=hi)
    L1 = np.diag(aP) + np.diag(aN[:-1], 1) + np.diag(aS[1:], -1)
    d = ax.d
    Dh = np.sqrt(d)
    M = (Dh[:, None] * L1) / Dh[None, :]
    M = 0.5 * (M + M.T)  # clean symmetrization (roundoff)
    lam, Q = np.linalg.eigh(M)
    V = Q / Dh[:, None]            # L1 = V diag(lam) V^-1
    Vinv = Q.T * Dh[None, :]
    return _AxisTransform(kind="eig", lam=lam, V=V, Vinv=Vinv)


_PRECISIONS = ("default", "high", "highest")


class FDMPoissonSolver:
    """Direct tensor-product Poisson solver; `solve(rhs)` on tensors."""

    def __init__(self, mesh: Mesh, cfg: Config, dtype=None,
                 transform: str = None, geom=None, *, device):
        """`device`: the torch device of the operator and of the
        tensors `solve` takes (required: there is no default device).
        transform: 'fft' | 'matmul' | 'auto' for the periodic axes;
        None reads `cfg.poisson_transform`. 'auto' is 'fft': the
        reference picks the dense matmul only on a TPU. `geom`
        (ops.grid.Geometry) enables iterative refinement
        (cfg.poisson_refine) through the consistent stencil Laplacian."""
        if transform is None:
            transform = getattr(cfg, "poisson_transform", "auto")
        if transform in ("fht", "pallas_fft"):
            item = "A.13" if transform == "fht" else "B.11"
            raise NotImplementedError(
                f"transform={transform!r}: the Hartley transforms are not "
                f"ported (ROADMAP {item}); use 'fft' or 'matmul'")
        if transform not in ("fft", "matmul", "auto"):
            raise ValueError(f"transform={transform!r} — expected one of "
                             "'fft' | 'matmul' | 'auto'")
        if transform == "auto":
            transform = "fft"
        self.transform = transform
        self.dtype = getattr(torch, dtype or cfg.poisson_dtype or cfg.dtype)
        self.device = torch.device(device)
        self.geom = geom
        # TF32 keeps ~10 mantissa bits: it would cost the eigenbasis
        # matmuls about four digits of the post-projection divergence.
        # Every matmul here runs in the full working precision, which
        # meets or exceeds each of the reference's precision tiers
        # (cfg.poisson_matmul_precision names bf16 pass counts of the
        # TPU's matrix unit); the tier still decides refinement below.
        torch.backends.cuda.matmul.allow_tf32 = False
        prec = cfg.poisson_matmul_precision
        big = max(mesh.x.n, mesh.y.n, mesh.z.n) >= 384
        bench = bool(cfg.benchmark or cfg.perf_mode)
        if prec == "auto":
            prec = (("high" if bench else "highest")
                    if (big and self.dtype != torch.float64) else "high")
            bench_relaxed = bench and big
        else:
            bench_relaxed = False
        if prec not in _PRECISIONS:
            raise ValueError(
                f"poisson_matmul_precision={cfg.poisson_matmul_precision!r}"
                f" — expected one of {list(_PRECISIONS) + ['auto']}")
        self.refine = cfg.poisson_refine
        if self.refine < 0:
            if (self.dtype == torch.float64 or prec == "highest"
                    or bench_relaxed):
                self.refine = 0
            else:
                self.refine = 1 if big else 0
        if geom is None:
            self.refine = 0

        bcs = (cfg.bc_x, cfg.bc_y, cfg.bc_z)
        self.tr = [
            _axis_transform(axd, bc, pressure_bc_kinds(cfg, a),
                            periodic_matmul=(transform == "matmul"))
            for a, (axd, bc) in enumerate(zip((mesh.x, mesh.y, mesh.z), bcs))
        ]
        # rfft on the *last* FFT axis for the real-input saving
        self.fft_axes = tuple(i for i, t in enumerate(self.tr) if t.kind == "fft")
        self.eig_axes = tuple(i for i, t in enumerate(self.tr) if t.kind == "eig")
        shape = [mesh.x.n, mesh.y.n, mesh.z.n]
        self.all_neumann = all(
            t.kind != "eig" or pressure_bc_kinds(cfg, a) == ("neumann", "neumann")
            for a, t in enumerate(self.tr)
        )
        # every per-axis eigenvalue is <= 0, so the extreme of the
        # Kronecker-sum symbol is the sum of the per-axis extremes
        scale = sum(float(np.max(np.abs(t.lam))) for t in self.tr) or 1.0
        self._null_thr = float(1e-12 * scale)
        lam_vecs = []
        for i, t in enumerate(self.tr):
            v = t.lam
            if self.fft_axes and i == self.fft_axes[-1]:
                v = v[: shape[i] // 2 + 1]
            s = [1, 1, 1]
            s[i] = len(v)
            lam_vecs.append(self._dev(v.reshape(s)))
        # 1/L with (near-)null modes pinned to zero => mean-free solve.
        # The reference assembles it inside every solve so that XLA never
        # bakes an N^3 constant into the program; eagerly, one stored
        # tensor is a single read per solve instead of five passes.
        L = lam_vecs[0] + lam_vecs[1] + lam_vecs[2]
        null = torch.abs(L) < self._null_thr
        self._inv_lam = torch.where(
            null, torch.zeros_like(L),
            1.0 / torch.where(null, torch.ones_like(L), L))
        self.mats = {
            i: (self._dev(self.tr[i].Vinv), self._dev(self.tr[i].V))
            for i in self.eig_axes
        }
        self.name = "FDM(" + ",".join(
            t.kind for t in self.tr) + f",{self.transform})"

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=self.device).to(self.dtype)

    # -- solve ------------------------------------------------------------

    @staticmethod
    def _apply_mat(mat: torch.Tensor, f: torch.Tensor, axis: int) -> torch.Tensor:
        """(N, N) transform along `axis` of a real 3-D tensor."""
        if axis == 0:
            return (mat @ f.reshape(f.shape[0], -1)).reshape(f.shape)
        if axis == 1:
            return torch.matmul(mat, f)
        return (f.reshape(-1, f.shape[2]) @ mat.T).reshape(f.shape)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Direct solve + cfg.poisson_refine iterative-refinement passes
        (each re-applies the consistent stencil Laplacian,
        ops.operators.laplacian, and solves for the correction)."""
        p = self._solve_once(rhs)
        if self.refine:
            from ..ops import operators as _ops
            rhs0 = rhs - torch.mean(rhs) if self.all_neumann else rhs
            for _ in range(self.refine):
                r = rhs0 - _ops.laplacian(p, self.geom)
                p = p + self._solve_once(r)
        return p

    def _solve_once(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve L p = rhs; the solution is null-mode-free for singular BCs:
        the pinned zero entries of the inverse symbol annihilate the RHS's
        null-mode coefficient, so no mean subtraction pass is needed."""
        f = rhs.to(self.dtype)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][0], f, i)
        if self.fft_axes:
            f = torch.fft.rfftn(f, dim=self.fft_axes)
        f = f * self._inv_lam
        if self.fft_axes:
            sizes = [rhs.shape[a] for a in self.fft_axes]
            f = torch.fft.irfftn(f, s=sizes, dim=self.fft_axes)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][1], f, i)
        return f.to(rhs.dtype)
