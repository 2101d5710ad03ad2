"""Fast-diagonalization pressure-Poisson solver
(port of `cfdnn_tpu/poisson/fdm.py`).

  L = Lx (+) Ly (+) Lz  (Kronecker sum of 1-D discrete Laplacians)

Per axis the transform that diagonalizes the 1-D operator is
  - periodic + uniform  -> real FFT, eigenvalues (2 cos(2 pi k/N) - 2)/h^2
    at O2, -s^2 with s = (27 sin(pi k/N) - sin(3 pi k/N))/(12h) at O4 (the
    symbol of the O4 D(G), `order` = cfg.space_order, n >= 4)
    (`torch.fft`, cuFFT on the card); with transform="matmul", the dense
    real eigenbasis of the circulant; with "fht", the four-step Hartley
    transform in plain torch (poisson/fht.py) where N >= 32; with
    "pallas_fft", the four-step Hartley kernels (poisson/pallas_fht.py,
    ops.kernels.fht_pass / fht_modal) where `axis_supported`. An axis
    that the two Hartley transforms do not take gets the dense
    eigenbasis: the reference's own per-axis policy.
  - wall/inflow/outflow (uniform OR stretched) -> a dense eigenbasis of the
    symmetrized stretched operator, built in float64 NumPy on the host and
    applied as one (N, N) matmul.

The host-side construction (`_periodic_eig`, `_axis_transform`) is the
reference's NumPy code unchanged. The device apply is: eigenbasis matmuls
on the real array, the Hartley or rfftn transforms over the periodic axes,
scaling by 1/lambda with the null mode pinned, the inverses, and the
inverse eigenbasis matmuls. With "pallas_fft" the forward pass of the last
Hartley axis, the scaling and its inverse pass are one kernel (the modal
pass), so an all-periodic solve is five passes over the field. It is
exactly consistent with `ops.operators.laplacian`, so a projection drives
the discrete divergence to roundoff.

"auto" is "fft" (cuFFT on the card), as the reference resolves it off a
TPU; "pallas_fft" is the opt-in that runs the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import BCType, Config, pressure_bc_kinds
from ..mesh import Mesh
from ..ops import kernels
from .fht import FHTAxis, fht_forward, fht_inverse
from .pallas_fht import PFHTAxis, axis_supported


@dataclasses.dataclass(frozen=True)
class PoissonStats:
    """Per-solve observability (the reference's PoissonStats): cycle
    count, status string, relative residual."""

    cycles: int
    status: str                 # DIRECT | FIXED | TOL | MAX_CYCLES
    rel_residual: float


@dataclasses.dataclass
class _AxisTransform:
    kind: str                      # 'fft' | 'eig' | 'fht' | 'none'
    lam: np.ndarray                # eigenvalues (modal Laplacian symbol)
    V: Optional[np.ndarray] = None     # eig: inverse-transform matrix
    Vinv: Optional[np.ndarray] = None  # eig: forward-transform matrix
    fht: Optional[object] = None       # fht: FHTAxis or PFHTAxis


def _periodic_eig(ax, order: int) -> _AxisTransform:
    """Real orthogonal eigenbasis of the periodic circulant Laplacian
    (float64), applied as (N, N) matmuls: the same modal symbol as the FFT
    path to roundoff. At O4 (n >= 4, the operators' o4_ok gate) it is
    -G^T G of the O4 staggered gradient G (ops c2f_diff4), whose wrap
    collisions at n = 4, 5 accumulate."""
    n, h = ax.n, ax.h
    L = np.zeros((n, n))
    idx = np.arange(n)
    if order >= 4 and n >= 4:
        # G: [+1, -27, +27, -1]/(24h) at cell offsets (i-2, i-1, i, i+1);
        # the matching divergence is D = -G^T, so L = D G = -G^T G
        Gm = np.zeros((n, n))
        for i in range(n):
            Gm[i, (i - 2) % n] += 1.0 / (24.0 * h)
            Gm[i, (i - 1) % n] += -27.0 / (24.0 * h)
            Gm[i, i % n] += 27.0 / (24.0 * h)
            Gm[i, (i + 1) % n] += -1.0 / (24.0 * h)
        L = -(Gm.T @ Gm)
        L = 0.5 * (L + L.T)
    else:
        L[idx, idx] = -2.0 / (h * h)
        L[idx, (idx + 1) % n] += 1.0 / (h * h)
        L[idx, (idx - 1) % n] += 1.0 / (h * h)
    lam, Q = np.linalg.eigh(L)
    return _AxisTransform(kind="eig", lam=lam, V=Q, Vinv=Q.T)


def _axis_transform(ax, bc: BCType, kinds: Tuple[str, str],
                    order: int = 2, periodic_matmul: bool = False
                    ) -> _AxisTransform:
    n = ax.n
    if n == 1:
        return _AxisTransform(kind="none", lam=np.zeros(1))
    if bc == BCType.PERIODIC:
        if not ax.uniform:
            raise ValueError("FDM Poisson requires uniform spacing on periodic axes")
        if periodic_matmul:
            return _periodic_eig(ax, order)
        k = np.arange(n)
        if order >= 4 and n >= 4:
            # the symbol of the O4 staggered D(G): -s(k)^2 with
            # s = (27 sin(kh/2) - sin(3kh/2)) / (12 h)
            th = np.pi * k / n
            s = (27.0 * np.sin(th) - np.sin(3.0 * th)) / (12.0 * ax.h)
            lam = -(s * s)
        else:
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
        transform: 'fft' | 'matmul' | 'fht' | 'pallas_fft' | 'auto' for
        the periodic axes; None reads `cfg.poisson_transform`. 'auto' is
        'fft': the reference picks the dense matmul or its Pallas
        transform only on a TPU. `geom` (ops.grid.Geometry) enables
        iterative refinement (cfg.poisson_refine) through the consistent
        stencil Laplacian."""
        if transform is None:
            transform = getattr(cfg, "poisson_transform", "auto")
        if transform not in ("fft", "matmul", "fht", "pallas_fft", "auto"):
            raise ValueError(f"transform={transform!r} — expected one of "
                             "'fft' | 'matmul' | 'fht' | 'pallas_fft' | "
                             "'auto'")
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
            self._build_axis(axd, bc, pressure_bc_kinds(cfg, a), transform,
                             cfg.space_order)
            for a, (axd, bc) in enumerate(zip((mesh.x, mesh.y, mesh.z), bcs))
        ]
        # rfft on the *last* FFT axis for the real-input saving
        self.fft_axes = tuple(i for i, t in enumerate(self.tr) if t.kind == "fft")
        self.eig_axes = tuple(i for i, t in enumerate(self.tr) if t.kind == "eig")
        self.fht_axes = tuple(i for i, t in enumerate(self.tr) if t.kind == "fht")
        # the kernels' path: five passes on an all-periodic grid
        self._pallas = transform == "pallas_fft" and bool(self.fht_axes)
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
        self._lam_vecs = tuple(lam_vecs)
        self._inv_lam = None
        if self._pallas:
            # the modal pass's operands: the last Hartley axis's symbol in
            # its digit-permuted order, and the other two axes' symbols
            # summed in the working dtype (as the reference sums them),
            # each in its own order; every 1/N of the solve in `norm`
            last = self.fht_axes[-1]
            rest = [a for a in range(3) if a != last]
            self._lam_axis = self._dev(self.tr[last].lam)
            self._lam_rest = (lam_vecs[rest[0]]
                              + lam_vecs[rest[1]]).squeeze(last).contiguous()
            self._norm = 1.0
            for i in self.fht_axes:
                self._norm /= self.tr[i].fht.N
        else:
            # 1/L with (near-)null modes pinned to zero => mean-free
            # solve. The reference assembles it inside every solve so
            # that XLA never bakes an N^3 constant into the program;
            # eagerly, one stored tensor is a single read per solve
            # instead of five passes.
            L = self._lam_total()
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

    def _build_axis(self, axd, bc, kinds, transform,
                    order) -> _AxisTransform:
        """One axis's transform at space order `order`, by the reference's
        per-axis policy (cfdnn_tpu/poisson/fdm.py:250-289): with
        "pallas_fft" a periodic axis takes the Hartley kernels where
        `axis_supported`, with "fht" the plain four-step where N >= 32,
        and otherwise the dense periodic eigenbasis. The Hartley
        transforms take the order's symbol as an operand."""
        if transform in ("pallas_fft", "fht") and bc == BCType.PERIODIC \
                and axd.n > 1:
            if transform == "pallas_fft":
                fx = (PFHTAxis.make(axd.n, self.dtype, device=self.device)
                      if axis_supported(axd.n) else None)
            else:
                fx = (FHTAxis.make(axd.n, self.dtype, device=self.device)
                      if axd.n >= 32 else None)
            if fx is None:
                return _axis_transform(axd, bc, kinds, order=order,
                                       periodic_matmul=True)
            base = _axis_transform(axd, bc, kinds, order=order)
            return _AxisTransform(kind="fht", lam=fx.lam_permuted(base.lam),
                                  fht=fx)
        return _axis_transform(axd, bc, kinds, order=order,
                               periodic_matmul=(transform == "matmul"))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=self.device).to(self.dtype)

    def _lam_total(self) -> torch.Tensor:
        """The modal symbol L(kx, ky, kz), the broadcast sum of the three
        per-axis vectors."""
        a, b, c = self._lam_vecs
        return a + b + c

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
        if self._pallas:
            return self._solve_once_pallas(rhs)
        f = rhs.to(self.dtype)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][0], f, i)
        for i in self.fht_axes:
            f = fht_forward(f, i, self.tr[i].fht)
        if self.fft_axes:
            f = torch.fft.rfftn(f, dim=self.fft_axes)
        f = f * self._inv_lam
        if self.fft_axes:
            sizes = [rhs.shape[a] for a in self.fft_axes]
            f = torch.fft.irfftn(f, s=sizes, dim=self.fft_axes)
        for i in self.fht_axes:
            f = fht_inverse(f, i, self.tr[i].fht)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][1], f, i)
        return f.to(rhs.dtype)

    def _solve_once_pallas(self, rhs: torch.Tensor) -> torch.Tensor:
        """transform="pallas_fft": the eigenbasis matmuls of the wall axes
        around the Hartley kernels. For an all-periodic grid

            fht_x | fht_y | [fht_z + scale + ifht_z] | ifht_y | ifht_x

        is five passes over the field, the last axis's forward pass, the
        1/lambda scale and its inverse pass in one kernel (fht_modal);
        every per-axis 1/N is folded into that scale, so the inverse
        passes are pure adjoints. The reference picks its bf16
        compensation depth (3 or 6 products, `passes`) from the precision
        tier; the kernels compute in the working dtype with FMAs, which
        meets both tiers, so the tier has nothing to choose here."""
        f = rhs.to(self.dtype)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][0], f, i)
        f = f.contiguous()
        last = self.fht_axes[-1]
        for i in self.fht_axes[:-1]:
            f = kernels.fht_pass(f, i, self.tr[i].fht)
        f = kernels.fht_modal(f, last, self.tr[last].fht, self._lam_axis,
                              self._lam_rest, thr=self._null_thr,
                              norm=self._norm)
        for i in reversed(self.fht_axes[:-1]):
            f = kernels.fht_pass(f, i, self.tr[i].fht, inverse=True)
        for i in self.eig_axes:
            f = self._apply_mat(self.mats[i][1], f, i)
        return f.to(rhs.dtype)

    def solve_with_stats(self, rhs):
        """solve() and its relative residual (one more forward transform of
        the solution and of the rhs)."""
        p = self.solve(rhs)
        r = self._residual_norm(rhs, p)
        return p, PoissonStats(cycles=0, status="DIRECT", rel_residual=r)

    def _residual_norm(self, rhs, p) -> float:
        """|L p - rhs| / |rhs| in modal space over the non-null modes: the
        solver pins the null modes by design, so rhs's null component is
        masked too. Hartley-kernel axes go through the dense
        `reference_forward` in the same digit-permuted order."""
        from .fht import fht_forward
        from .pallas_fht import PFHTAxis, reference_forward

        def fwd(f):
            for i in self.eig_axes:
                f = self._apply_mat(self.mats[i][0], f, i)
            for i in self.fht_axes:
                t = self.tr[i].fht
                f = (reference_forward(f, i, t) if isinstance(t, PFHTAxis)
                     else fht_forward(f, i, t))
            if self.fft_axes:
                f = torch.fft.rfftn(f, dim=self.fft_axes)
            return f

        f = fwd(p.to(self.dtype))
        g = fwd(rhs.to(self.dtype))
        L = self._lam_total()
        null = torch.abs(L) < self._null_thr
        lam = torch.where(null, torch.zeros_like(L), L)
        g = torch.where(null, torch.zeros_like(g), g)
        num = torch.linalg.norm((lam * f - g).reshape(-1))
        den = torch.clamp(torch.linalg.norm(g.reshape(-1)), min=1e-300)
        return float(num / den)
