"""The port's operator library (ops/grid.py, ops/bc.py, ops/operators.py)
against the JAX reference's, at float64 on the CPU.

The same NumPy-seeded inputs go through `cfdnn_tpu.ops` and
`cfdnn_tpu_torch.ops` on a periodic 16^3 grid, a stretched-wall 16x24x8
channel grid, the same channel with a moving top wall, and an outflow-x
grid; every result agrees to atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.mesh import Mesh as RMesh
from cfdnn_tpu.ops import bc as rbc
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops.grid import Geometry as RGeometry
from cfdnn_tpu_torch.mesh import Mesh as TMesh
from cfdnn_tpu_torch.ops import bc as tbc
from cfdnn_tpu_torch.ops import operators as tops
from cfdnn_tpu_torch.ops.grid import Geometry as TGeometry

ATOL = 1e-12

GRIDS = {
    "periodic16": dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", y_min=0.0,
                       y_max=1.0, x_max=1.0, z_max=2.0),
    "wall16x24x8": dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0),
    "lid16x24x8": dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0,
                       lid_velocity=0.7),
    "outflow16x12x8": dict(Nx=16, Ny=12, Nz=8, bc_x="outflow", z_max=1.0),
}


def _cfgs(name):
    kw = dict(GRIDS[name], dtype="float64")
    out = []
    for pkg in (R, T):
        k = dict(kw)
        for b in ("bc_x", "bc_y"):
            if b in k:
                k[b] = pkg.BCType(k[b])
        out.append(pkg.Config(**k).finalize())
    return out


def _setup(name, seed=0):
    rcfg, tcfg = _cfgs(name)
    rg = RGeometry.make(RMesh.from_config(rcfg), rcfg)
    tg = TGeometry.make(TMesh.from_config(tcfg), tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    su, sv, sw = R.fields.velocity_shapes(rcfg)
    sc = (rcfg.Nx, rcfg.Ny, rcfg.Nz)
    arrs = {k: rng.standard_normal(s) for k, s in
            (("u", su), ("v", sv), ("w", sw), ("c", sc), ("p", sc))}
    rA = {k: jnp.asarray(a) for k, a in arrs.items()}
    tA = {k: torch.from_numpy(a.copy()) for k, a in arrs.items()}
    return (rops, rbc, rg, rA), (tops, tbc, tg, tA)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, f"{what}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)


def _vel(A):
    return (A["u"], A["v"], A["w"])


# name -> f(ops, bc, geom, arrays) with the same meaning in both packages
OPS = {
    "f2c_mean": lambda o, b, g, A: tuple(
        o.f2c_mean(c, a, g.axes[a]) for a, c in enumerate(_vel(A))),
    "f2c_diff": lambda o, b, g, A: tuple(
        o.f2c_diff(c, a, g.axes[a]) for a, c in enumerate(_vel(A))),
    "c2f_mean": lambda o, b, g, A: tuple(
        o.c2f_mean(A["c"], a, g.axes[a], kind=k, wall=(0.3, -0.2))
        for a in range(3) for k in ("vel", "scalar")),
    "c2f_diff": lambda o, b, g, A: tuple(
        o.c2f_diff(A["c"], a, g.axes[a], kind=k, wall=(0.3, -0.2))
        for a in range(3) for k in ("vel", "scalar")),
    "cc_central": lambda o, b, g, A: tuple(
        o.cc_central(A["c"], a, g.axes[a], wall=(0.3, -0.2))
        for a in range(3)),
    "ff_central": lambda o, b, g, A: tuple(
        o.ff_central(c, a, g.axes[a]) for a, c in enumerate(_vel(A))),
    "convective_skew": lambda o, b, g, A: o.convective(
        _vel(A), g, R.ConvectiveScheme.SKEW if o is rops
        else T.ConvectiveScheme.SKEW),
    "convective_central": lambda o, b, g, A: o.convective(
        _vel(A), g, R.ConvectiveScheme.CENTRAL if o is rops
        else T.ConvectiveScheme.CENTRAL),
    "diffusive": lambda o, b, g, A: o.diffusive(_vel(A), 3e-3, g),
    "diffusive_skip_y": lambda o, b, g, A: o.diffusive(_vel(A), 3e-3, g,
                                                       skip_y=True),
    "divergence": lambda o, b, g, A: o.divergence(_vel(A), g),
    "pressure_grad_face": lambda o, b, g, A: tuple(
        o.pressure_grad_face(A["p"], a, g) for a in range(3)),
    "correct_velocity": lambda o, b, g, A: o.correct_velocity(
        _vel(A), A["p"], 1e-2, g),
    "laplacian": lambda o, b, g, A: o.laplacian(A["p"], g),
    "apply_velocity_bc": lambda o, b, g, A: b.apply_velocity_bc(*_vel(A), g),
    "pads": lambda o, b, g, A: tuple(
        x for a in range(3) for x in (
            b.pad_center(A["c"], a, g.axes[a].bc),
            b.pad_center(A["c"], a, g.axes[a].bc, ng=2),
            b.pad_pressure(A["p"], a, g.axes[a]),
            b.pad_tangential(A["c"], a, g.axes[a].bc, wall=(0.3, -0.2)),
            b.pad_tangential(A["c"], a, g.axes[a].bc, ng=2),
            b.pad_normal(_vel(A)[a], a, g.axes[a].bc),
            b.pad_normal(_vel(A)[a], a, g.axes[a].bc, ng=2),
            *b.face_pair(_vel(A)[a], a, g.axes[a].bc))),
}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("op", list(OPS))
def test_operator_matches_reference(grid, op):
    (ro, rb, rg, rA), (to, tb, tg, tA) = _setup(grid)
    _assert_same(OPS[op](to, tb, tg, tA), OPS[op](ro, rb, rg, rA),
                 f"{op} on {grid}")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_geometry_matches_reference(grid):
    (_, _, rg, _), (_, _, tg, _) = _setup(grid)
    for ra, ta in zip(rg.axes, tg.axes):
        for f in ("n", "periodic", "uniform", "h", "length", "p_lo", "p_hi",
                  "tang"):
            assert getattr(ra, f) == getattr(ta, f), f
        assert ra.bc.value == ta.bc.value
        for f in ("d", "inv_d", "dc", "inv_dc", "centers", "faces",
                  "pos_c_pad2", "pos_f_pad2", "pos_c_pad", "pos_f_pad"):
            _assert_same(getattr(ta, f), getattr(ra, f), f)
            assert getattr(ta, f).dtype == torch.float64


def test_upwind_raises():
    """The upwind schemes, refused until ROADMAP A.2 was ported, are served:
    ops.convective with upwind and upwind2 equals the reference's on the
    periodic grid, and the advective form still refuses skew (convective
    routes skew to the skew form) with an error in place of the
    reference's assert."""
    (ro, rb, rg, rA), (to, _, tg, tA) = _setup("periodic16")
    for scheme in ("upwind", "upwind2"):
        _assert_same(to.convective(_vel(tA), tg, T.ConvectiveScheme(scheme)),
                     ro.convective(_vel(rA), rg, R.ConvectiveScheme(scheme)),
                     f"convective {scheme} on periodic16")
    with pytest.raises(ValueError, match="skew"):
        to._conv_advective(_vel(tA), 0, tg, T.ConvectiveScheme.SKEW)
