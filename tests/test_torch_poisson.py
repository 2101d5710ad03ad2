"""The port's FDMPoissonSolver against the reference's
FDMPoissonSolver(transform="fft"), float64 on the CPU.

The same NumPy-seeded right-hand side goes to both; the solutions and the
divergence left after projecting a random velocity agree to 1e-10
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.mesh import Mesh as RMesh
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops.grid import Geometry as RGeometry
from cfdnn_tpu.poisson.fdm import FDMPoissonSolver as RFDM
from cfdnn_tpu_torch.mesh import Mesh as TMesh
from cfdnn_tpu_torch.ops import operators as tops
from cfdnn_tpu_torch.ops.grid import Geometry as TGeometry
from cfdnn_tpu_torch.poisson.fdm import FDMPoissonSolver as TFDM

REL = 1e-10

GRIDS = {
    "periodic16": dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", y_min=0.0,
                       y_max=2 * np.pi, z_max=2 * np.pi),
    "channel16x24x8": dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0),
    "duct16x12x10": dict(Nx=16, Ny=12, Nz=10, stretch_y=True,
                         stretch_z=True, bc_z="wall"),
    "channel2d": dict(Nx=16, Ny=12, Nz=1, stretch_y=True),
}


def _setup(name, **extra):
    out = []
    for pkg, Mesh, Geometry in ((R, RMesh, RGeometry), (T, TMesh, TGeometry)):
        kw = dict(GRIDS[name], dtype="float64", **extra)
        for b in ("bc_y", "bc_z"):
            if b in kw:
                kw[b] = pkg.BCType(kw[b])
        cfg = pkg.Config(**kw).finalize()
        mesh = Mesh.from_config(cfg)
        geom = (Geometry.make(mesh, cfg) if pkg is R
                else Geometry.make(mesh, cfg, device="cpu"))
        out.append((cfg, mesh, geom))
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_fdm_solve_matches_reference(grid, transform):
    (rc, rm, rg), (tc, tm, tg) = _setup(grid)
    rs = RFDM(rm, rc, transform="fft", geom=rg)
    ts = TFDM(tm, tc, transform=transform, geom=tg, device="cpu")
    assert ts.fft_axes == (rs.fft_axes if transform == "fft" else ())
    rhs = np.random.default_rng(3).standard_normal((rc.Nx, rc.Ny, rc.Nz))
    p_r = rs.solve(jnp.asarray(rhs))
    p_t = ts.solve(torch.from_numpy(rhs.copy()))
    assert _rel(p_t.numpy(), p_r) <= REL
    # an exact inverse of the consistent Laplacian on the non-null
    # subspace: with Neumann ends the null mode is the constant, and the
    # solvable part of the rhs is the rhs less its volume-weighted mean
    lap = tops.laplacian(p_t, tg).numpy()
    vol = (tm.x.d[:, None, None] * tm.y.d[None, :, None]
           * tm.z.d[None, None, :])
    r0 = (rhs - np.sum(rhs * vol) / np.sum(vol) if ts.all_neumann
          else rhs)
    assert _rel(lap, r0) <= REL


@pytest.mark.parametrize("grid", ["periodic16", "channel16x24x8"])
def test_projection_divergence_matches_reference(grid):
    (rc, rm, rg), (tc, tm, tg) = _setup(grid)
    rng = np.random.default_rng(4)
    vel = [rng.standard_normal(s) for s in R.fields.velocity_shapes(rc)]
    if rc.bc_y == R.BCType.WALL:
        vel[1][:, 0] = vel[1][:, -1] = 0.0
    dt = 1e-2
    outs = []
    for ops_, solver, g, conv in (
            (rops, RFDM(rm, rc, transform="fft", geom=rg), rg, jnp.asarray),
            (tops, TFDM(tm, tc, geom=tg, device="cpu"), tg,
             lambda a: torch.from_numpy(a.copy()))):
        comps = tuple(conv(a) for a in vel)
        p = solver.solve(ops_.divergence(comps, g) / dt)
        new = ops_.correct_velocity(comps, p, dt, g)
        outs.append((p, new, ops_.divergence(new, g)))
    (p_r, new_r, div_r), (p_t, new_t, div_t) = outs
    assert _rel(p_t.numpy(), p_r) <= REL
    for a, b in zip(new_t, new_r):
        assert _rel(a.numpy(), b) <= REL
    # post-projection divergence: both at roundoff of the input's scale
    assert float(div_t.abs().max()) <= 1e-10
    np.testing.assert_allclose(div_t.numpy(), np.asarray(div_r), rtol=0,
                               atol=1e-10)


def test_refinement_pass_matches_reference():
    (rc, rm, rg), (tc, tm, tg) = _setup("channel16x24x8", poisson_refine=1)
    rs = RFDM(rm, rc, transform="fft", geom=rg)
    ts = TFDM(tm, tc, geom=tg, device="cpu")
    assert rs.refine == ts.refine == 1
    rhs = np.random.default_rng(5).standard_normal((rc.Nx, rc.Ny, rc.Nz))
    assert _rel(ts.solve(torch.from_numpy(rhs.copy())).numpy(),
                rs.solve(jnp.asarray(rhs))) <= REL


@pytest.mark.parametrize("transform", ["fht", "pallas_fft"])
def test_hartley_transforms_run(transform):
    """Both Hartley transforms build and solve (they raised until the port
    took them; tests/test_torch_fht.py holds them to the reference): on a
    64^3 periodic grid every axis takes the transform, and the solve
    equals the reference's "fft" solve to 1e-10."""
    (rc, rm, rg), (tc, tm, tg) = _setup("periodic16", Nx=64, Ny=64, Nz=64)
    ts = TFDM(tm, tc, transform=transform, geom=tg, device="cpu")
    assert ts.fht_axes == (0, 1, 2) and ts.transform == transform
    rhs = np.random.default_rng(6).standard_normal((64, 64, 64))
    want = RFDM(rm, rc, transform="fft", geom=rg).solve(jnp.asarray(rhs))
    assert _rel(ts.solve(torch.from_numpy(rhs)).numpy(), want) <= REL


def test_mixed_precision_poisson_dtype():
    """poisson_dtype='float64' under a float32 working dtype: the solve
    runs in float64 and hands back float32."""
    (_, _, _), (tc, tm, tg) = _setup("channel16x24x8")
    tc32 = tc.with_(dtype="float32", poisson_dtype="float64")
    ts = TFDM(tm, tc32, geom=tg, device="cpu")
    assert ts.dtype == torch.float64 and ts.mats[1][0].dtype == torch.float64
    rhs = torch.randn((16, 24, 8), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    assert ts.solve(rhs).dtype == torch.float32


def test_no_default_device():
    """The port has no default device: Geometry.make and FDMPoissonSolver
    take `device` as a required keyword, as Simulation and zero_state do."""
    (_, _, _), (tc, tm, tg) = _setup("periodic16")
    with pytest.raises(TypeError, match="device"):
        TGeometry.make(tm, tc)
    with pytest.raises(TypeError, match="device"):
        TFDM(tm, tc, geom=tg)
    with pytest.raises(TypeError):
        TGeometry.make(tm, tc, "cpu")   # keyword-only
