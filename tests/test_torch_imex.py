"""The port's implicit y-diffusion (ops/tridiag.py `thomas`, forcing.py
`implicit_y_diffusion` and `implicit_scalar_y_diffusion`), the IMEX
k-omega transport, the force ramp and bulk-velocity control against the
JAX reference at float64 on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Limits: thomas and the implicit solves 1e-13 of scale; 5-step
trajectories 1e-12 of each field's scale (u, v, w, p, and k, omega, nu_t
of the RANS runs), each step's dt to 1e-12 relative. The trajectories
start from the reference's perturbed_channel at amplitude 0.5, where the
star's divergence is large beside its roundoff (at 0.05 the two FDM
solves' different summation orders read ~1e-12 of p's scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu import forcing as RF
from cfdnn_tpu.ops.tridiag import thomas as r_thomas
from cfdnn_tpu_torch import forcing as TF
from cfdnn_tpu_torch.ops.tridiag import thomas
from cfdnn_tpu_torch.solver import KernelPlan

PHYS = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
CHANNEL = dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0)
KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
AMP = 0.5


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel),
                        ("time_integrator", pkg.TimeIntegrator)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k) is not None}, "cpu", torch.float64)


def _close(got, want, what, tol):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# thomas
# ---------------------------------------------------------------------------


def _coeff(kind, shape, axis, rng, base):
    n = shape[axis]
    if kind == "scalar":
        return base + 0.1 * float(rng.random())
    if kind == "vector":
        return base + 0.1 * rng.random(n)
    s = [1, 1, 1]
    s[axis] = n
    other = (axis + 1) % 3
    s[other] = shape[other]
    return base + 0.1 * rng.random(tuple(s))


@pytest.mark.parametrize("shape", [(6, 6, 6), (5, 7, 4)])
@pytest.mark.parametrize("kind", ["scalar", "vector", "full"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_thomas_matches_reference(axis, kind, shape):
    """Each solve axis, scalar / length-n / full-rank coefficients (the
    cube: a trailing dim equals n, where a vector must still lie along
    the solve axis), against the reference's thomas to 1e-13."""
    rng = np.random.default_rng(11 + axis)
    lo = _coeff(kind, shape, axis, rng, -0.3)
    di = _coeff(kind, shape, axis, rng, 2.0)
    up = _coeff(kind, shape, axis, rng, -0.4)
    rhs = rng.standard_normal(shape)
    want = np.asarray(r_thomas(*(jnp.asarray(c) for c in (lo, di, up)),
                               jnp.asarray(rhs), axis=axis))

    def t(c):
        return torch.as_tensor(c) if isinstance(c, np.ndarray) else c
    got = thomas(t(lo), t(di), t(up), torch.as_tensor(rhs), axis)
    assert got.is_contiguous()
    _close(got, want, "x", 1e-13)
    if kind == "vector":
        # a residual check: the vector lies along the solve axis
        x = np.moveaxis(got.numpy(), axis, 0)
        r = np.moveaxis(rhs, axis, 0)
        b = (di[:, None, None] * x
             + np.concatenate([np.zeros_like(x[:1]), lo[1:, None, None]
                               * x[:-1]])
             + np.concatenate([up[:-1, None, None] * x[1:],
                               np.zeros_like(x[:1])]))
        np.testing.assert_allclose(b, r, rtol=0, atol=1e-12)


@pytest.mark.parametrize("bad", [np.ones((6, 1)), np.ones(5)])
def test_thomas_refuses_an_ambiguous_shape(bad):
    """A 2-D coefficient on a 3-D rhs, or a vector of the wrong length,
    raises ValueError in both packages."""
    rhs = np.ones((6, 6, 6))
    with pytest.raises(ValueError, match="ambiguous"):
        r_thomas(jnp.asarray(bad), 2.0, -0.1, jnp.asarray(rhs), axis=1)
    with pytest.raises(ValueError, match="ambiguous"):
        thomas(torch.as_tensor(bad), 2.0, -0.1, torch.as_tensor(rhs), 1)


# ---------------------------------------------------------------------------
# the implicit solves
# ---------------------------------------------------------------------------


def _geoms(**kw):
    rs = R.Simulation(_cfg(R, **dict(CHANNEL, **kw), use_pallas="off"))
    ts = T.Simulation(_cfg(T, **dict(CHANNEL, **kw), use_pallas="off"),
                      device="cpu")
    return rs, ts


def _fields(ts, seed, cell_nu):
    rng = np.random.default_rng(seed)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(ts.cfg)]
    c = ts.cfg
    nu = (1e-3 + 1e-2 * rng.random((c.Nx, c.Ny, c.Nz)) if cell_nu
          else 2e-3)
    return comps, nu


@pytest.mark.parametrize("grid", ["channel", "wall_x", "open_y"])
@pytest.mark.parametrize("cell_nu", [False, True])
def test_implicit_y_diffusion_matches_reference(cell_nu, grid):
    """implicit_y_diffusion on a stretched walled y with scalar nu and a
    cell nu (averaged onto u's faces with the wrap on the periodic x of
    the channel, with the mirror on a wall x), and the no-op on a
    periodic y, against the reference to 1e-13 of scale."""
    kw = {"channel": {}, "wall_x": dict(bc_x="wall"),
          "open_y": dict(bc_y="periodic", stretch_y=False)}[grid]
    rs, ts = _geoms(**kw)
    comps, nu = _fields(ts, 3, cell_nu)
    dt = 0.02
    want = RF.implicit_y_diffusion(
        tuple(jnp.asarray(c) for c in comps),
        jnp.asarray(nu), jnp.asarray(dt), rs.geom)
    got = TF.implicit_y_diffusion(
        tuple(torch.as_tensor(c) for c in comps),
        torch.as_tensor(nu) if cell_nu else nu,
        torch.tensor(dt, dtype=torch.float64), ts.geom)
    for name, g, w, c in zip("uvw", got, want, comps):
        _close(g, w, name, 1e-13)
        if grid == "open_y":
            assert np.array_equal(g.numpy(), c)
        else:
            assert not np.allclose(g.numpy(), c)


@pytest.mark.parametrize("cell_nu", [False, True])
@pytest.mark.parametrize("wall_value", [0.0, 7.5])
def test_implicit_scalar_y_diffusion_matches_reference(wall_value,
                                                       cell_nu):
    """The cell-centred scalar solve with a Dirichlet wall value (k's 0,
    omega's omega_wall), against the reference to 1e-13 of scale."""
    rs, ts = _geoms()
    _, nu = _fields(ts, 4, cell_nu)
    rng = np.random.default_rng(5)
    f = 1.0 + rng.random((ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))
    dt = 0.05
    want = RF.implicit_scalar_y_diffusion(
        jnp.asarray(f), jnp.asarray(nu), jnp.asarray(dt), rs.geom,
        wall_value)
    got = TF.implicit_scalar_y_diffusion(
        torch.as_tensor(f), torch.as_tensor(nu) if cell_nu else nu,
        torch.tensor(dt, dtype=torch.float64), ts.geom, wall_value)
    _close(got, want, "f", 1e-13)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

CASES = {
    "imex-euler": dict(implicit_y_diffusion=True),
    "imex-rk2": dict(implicit_y_diffusion=True, time_integrator="rk2"),
    "imex-rk3-adaptive": dict(implicit_y_diffusion=True,
                              time_integrator="rk3", adaptive_dt=True,
                              nu=1e-4),
    "imex-sst": dict(implicit_y_diffusion=True, turb_model="sst", nu=1e-4),
    "imex-komega": dict(implicit_y_diffusion=True, turb_model="komega",
                        nu=1e-4),
    "imex-wale": dict(implicit_y_diffusion=True, turb_model="wale"),
    "ramp-rk2": dict(force_ramp_time=0.01, time_integrator="rk2"),
    "bulk": dict(bulk_velocity_target=1.0),
}
# the kernel plan each case takes under use_pallas="on" (the reference's:
# no predictor or projection kernel under implicit y-diffusion, the LES
# closure kernel by its own gate, no transport kernel; a plain predictor
# with the projection kernels under a ramp or bulk control)
PLANS_ON = {
    "imex-wale": KernelPlan(None, None, "nu_sgs"),
    "ramp-rk2": KernelPlan(None, "slab", None),
    "bulk": KernelPlan(None, "slab", None),
}
_REF = {}


def _reference(case):
    """(initial state, the reference's 5 states and dts), once a case."""
    if case not in _REF:
        rs = R.Simulation(_cfg(R, **CHANNEL, **CASES[case],
                               use_pallas="off"))
        r = R.perturbed_channel(rs.cfg, rs.mesh, amp=AMP)
        if CASES[case].get("turb_model") in ("sst", "komega"):
            r = rs.initialize(r)
        start, dts = r, []
        for _ in range(5):
            r, rd = rs.step(r)
            dts.append(float(rd.dt))
        _REF[case] = (start, r, dts)
    return _REF[case]


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case, mode):
    """5 steps on the stretched 16x24x8 channel: implicit y-diffusion
    under Euler, RK2 and RK3 with adaptive dt (the diffusion limit
    without its y term), the IMEX SST and Wilcox transport, WALE under
    implicit y; the force ramp under RK2 (t threaded through the stages)
    and bulk-velocity control. Each field to 1e-12 of its scale, each
    dt to 1e-12 relative; the plan is the reference's."""
    start, want, dts = _reference(case)
    ts = T.Simulation(_cfg(T, **CHANNEL, **CASES[case], use_pallas=mode),
                      device="cpu")
    plan = (PLANS_ON.get(case, KernelPlan(None, None)) if mode == "on"
            else KernelPlan(None, None))
    assert ts.kernels == plan
    if CASES[case].get("adaptive_dt"):
        # the explicit limit drops y: x and z only
        mesh = ts.mesh
        assert ts._dt_limits[3] == pytest.approx(
            1.0 / mesh.x.d[0] ** 2 + 1.0 / np.min(mesh.z.d) ** 2,
            rel=1e-14)
    t = _to_port(start)
    for i in range(5):
        t, td = ts.step(t)
        np.testing.assert_allclose(float(td.dt), dts[i], rtol=1e-12, atol=0)
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "p", "k", "omega", "nu_t"):
        if getattr(want, key) is not None:
            _close(out[key], getattr(want, key), key, 1e-12)
    np.testing.assert_allclose(float(t.t), float(want.t), rtol=1e-14)
    assert float(td.div_linf) < 1e-10


def test_the_ramp_reads_each_stage_time():
    """The body force under a ramp is fx (1 - exp(-t / T)) at the time
    it is given, a 0-d tensor: the RK stages' t, t + dt, t + dt/2; bulk
    control adds (target - bulk u)/dt with the area-weighted bulk."""
    ts = T.Simulation(_cfg(T, **CHANNEL, force_ramp_time=0.5),
                      device="cpu")
    st = ts.initial_state()
    for t in (0.0, 0.25, 1.0):
        tt = torch.tensor(t, dtype=torch.float64)
        f = ts._body_force(tt, st.velocity, ts._dt)
        assert float(f) == pytest.approx(1e-3 * (1.0 - np.exp(-t / 0.5)),
                                         rel=1e-14, abs=0)
    tb = T.Simulation(_cfg(T, **CHANNEL, bulk_velocity_target=2.0),
                      device="cpu")
    u = torch.ones(T.velocity_shapes(tb.cfg)[0], dtype=torch.float64)
    f = tb._body_force(None, (u, None, None), torch.tensor(0.5))
    assert float(f) == pytest.approx(1e-3 + (2.0 - 1.0) / 0.5, rel=1e-14)
