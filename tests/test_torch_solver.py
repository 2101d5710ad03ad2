"""The port's Simulation (Euler slice) against the JAX reference's, float64
on the CPU, plus its dispatch, its refusals and its import hygiene.

Trajectories: 16^3 Taylor-Green (all-periodic, skew) and a 16x24x8
stretched channel (central, the bench scheme), 5 steps with
use_pallas="on" (the reference in Pallas interpret mode, the port through
its kernels' CPU twins) and 20 steps with "off" (both operator chains),
from the same initial arrays handed across by state_from_numpy; u, v, w
and p agree to atol 1e-11.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu_torch import solver as TS
from cfdnn_tpu_torch.solver import KernelPlan

ATOL = 1e-11

TGV = dict(Nx=16, Ny=16, Nz=16, bc_x="periodic", bc_y="periodic",
           bc_z="periodic", y_min=0.0, y_max=2 * np.pi, z_max=2 * np.pi,
           nu=1e-3, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
           dt=1e-3, adaptive_dt=False, dtype="float64",
           convective_scheme="skew")
CHANNEL = dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0, nu=1e-3,
               nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True, dt=1e-3,
               adaptive_dt=False, dtype="float64")


def _cfg(pkg, base, **kw):
    k = dict(base, **kw)
    for name in ("bc_x", "bc_y", "bc_z"):
        if name in k:
            k[name] = pkg.BCType(k[name])
    if "convective_scheme" in k:
        k["convective_scheme"] = pkg.ConvectiveScheme(k["convective_scheme"])
    return pkg.Config(**k)


def _init(case, sim):
    if case == "tgv":
        return R.init_taylor_green(sim.cfg, sim.mesh)
    return R.perturbed_channel(sim.cfg, sim.mesh, amp=0.05)


def _to_port(state, sim):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in
         ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp")},
        "cpu", sim.dtype)


# each case's grid and its predictor under "on"; channel_xz is the
# channel with the slab cap of both packages lowered (the reference's
# tests/test_pallas_kernels.py:265), so it takes the "xz" plan
PREDICTORS = {"tgv": (TGV, "periodic"), "channel": (CHANNEL, "channel"),
              "channel_xz": (dict(CHANNEL, Nz=32), "general_xz")}


@pytest.mark.parametrize("case", sorted(PREDICTORS))
@pytest.mark.parametrize("mode,steps", [("on", 5), ("off", 20)])
def test_trajectory_matches_reference(case, mode, steps, monkeypatch):
    base, predictor = PREDICTORS[case]
    tiling = "xz" if case.endswith("_xz") else "slab"
    if tiling == "xz":
        from cfdnn_tpu.ops import pallas_kernels
        monkeypatch.setattr(pallas_kernels, "_SLAB_FIT_CELLS", 8)
        monkeypatch.setattr(T.solver, "SLAB_FIT_CELLS", 8)
    rsim = R.Simulation(_cfg(R, base, use_pallas=mode))
    tsim = T.Simulation(_cfg(T, base, use_pallas=mode), device="cpu")
    if mode == "on":
        assert rsim._pallas_predictor_ok == tiling
        assert tsim.kernels == KernelPlan(predictor, tiling)
        assert T.solver.tiling_mode(tsim.geom, tsim.cfg) == tiling
    else:
        assert tsim.kernels == KernelPlan(None, None)
    rs = _init(case, rsim)
    ts = _to_port(rs, tsim)
    for _ in range(steps):
        rs, rd = rsim.step(rs)
        ts, td = tsim.step(ts)
    out = T.state_to_numpy(ts)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(rs, k)),
                                   rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(out["t"], np.asarray(rs.t), rtol=0, atol=0)
    assert int(out["step"]) == int(rs.step) == steps
    for f in ("ke", "div_linf", "residual"):
        np.testing.assert_allclose(float(getattr(td, f)),
                                   float(getattr(rd, f)), rtol=0, atol=ATOL)
    assert float(td.div_linf) < 1e-10


@pytest.mark.parametrize("case", ["tgv", "channel"])
def test_benchmark_mode_run_matches_reference(case):
    """run(n) in benchmark mode: n-1 steps without diagnostics, then one
    with them (the reference's _nsteps_impl)."""
    base = dict(TGV if case == "tgv" else CHANNEL, benchmark=True)
    rsim = R.Simulation(_cfg(R, base, use_pallas="off"))
    tsim = T.Simulation(_cfg(T, base, use_pallas="off"), device="cpu")
    rs = _init(case, rsim)
    rs2, rd = rsim.run(rs, 6)
    ts2, td = tsim.run(_to_port(rs, tsim), 6)
    np.testing.assert_allclose(T.state_to_numpy(ts2)["u"], np.asarray(rs2.u),
                               rtol=0, atol=ATOL)
    for f in ("ke", "div_linf", "residual"):
        np.testing.assert_allclose(float(getattr(td, f)),
                                   float(getattr(rd, f)), rtol=0, atol=ATOL)
    assert float(td.ke) > 0.0


def test_kahan_time_float32():
    """t carries a Kahan compensation: 3000 float32 steps of 1e-3 land on
    3.0 to float32 roundoff, where plain summation drifts."""
    cfg = _cfg(T, TGV, Nx=4, Ny=4, Nz=4, dtype="float32")
    sim = T.Simulation(cfg, device="cpu")
    st = sim.initial_state()
    t, comp = st.t, st.t_comp
    dt = sim._dt
    naive = torch.zeros((), dtype=torch.float32)
    for _ in range(3000):
        y = dt - comp
        t_new = t + y
        comp = (t_new - t) - y
        t = t_new
        naive = naive + dt
    assert abs(float(t) - 3.0) <= 2.5e-7
    assert abs(float(naive) - 3.0) > abs(float(t) - 3.0)
    st2, _ = sim.run(st, 3)
    assert abs(float(st2.t) - 3e-3) <= 1e-9 and int(st2.step) == 3


@pytest.mark.parametrize("kw", [
    dict(space_order=4, convective_scheme="upwind2"),
    dict(convective_scheme="upwind"),
    dict(convective_scheme="upwind2"),
])
def test_upwind_schemes_are_served(kw):
    """The configs that raised until the upwind schemes were ported
    (ROADMAP A.2): the channel with upwind or upwind2, at O2 and O4, is
    built, plans the general predictor under "on" (its twin on the CPU)
    and steps to a finite, solenoidal state."""
    k = dict(CHANNEL, **kw, use_pallas="on")
    k["convective_scheme"] = T.ConvectiveScheme(k["convective_scheme"])
    sim = T.Simulation(T.Config(**k), device="cpu")
    assert sim.kernels.predictor == "general"
    assert sim.kernels.projection == "slab"
    st, d = sim.run(sim.initial_state(), 2)
    assert bool(torch.isfinite(st.u).all()) and float(d.div_linf) < 1e-10


@pytest.mark.parametrize("kw,item", [
    (dict(turb_model="nn_mlp"), "A.12"),
    (dict(trip_enabled=True), "A.14"),
    (dict(recycling_inflow=True), "A.14"),
    (dict(filter_strength=0.1), "A.14"),
    (dict(bc_y="outflow"), "B.3"),
    (dict(bc_z="outflow"), "B.3"),
    (dict(mesh_shape=(4,)), "A.17"),
    (dict(poisson_solver="mg"), "A.13"),
    (dict(poisson_transform="fht", stretch_z=True), "A.13"),
    (dict(poisson_transform="pallas_fft", poisson_solver="mg"), "A.13"),
    (dict(stretch_z=True), "A.13"),
    (dict(turb_model="nn_tbnn"), "A.12"),
    (dict(adaptive_dt=True, filter_strength=0.1), "A.14"),
])
def test_outside_the_slice_raises(kw, item):
    k = dict(CHANNEL, **kw)
    enums = {"time_integrator": T.TimeIntegrator,
             "convective_scheme": T.ConvectiveScheme,
             "turb_model": T.TurbulenceModel, "bc_x": T.BCType,
             "bc_y": T.BCType, "bc_z": T.BCType,
             "poisson_solver": T.PoissonSolverType}
    for name, enum_ in enums.items():
        if name in k:
            k[name] = enum_(k[name])
    with pytest.raises(NotImplementedError, match=item):
        T.Simulation(T.Config(**k), device="cpu")


def test_o4_xz_grid_takes_the_xz_kernels():
    """O4 on a grid whose plan is "xz" (2 Ny Nz > SLAB_FIT_CELLS, a
    periodic z of 32-cell blocks), which the port refused before it had
    the O4 xz variants, plans the xz kernels under use_pallas="on"; the
    eager chain under "auto" on the CPU."""
    kw = dict(CHANNEL, space_order=4, Nx=8, Ny=8, Nz=24608)
    sim = T.Simulation(T.Config(**kw, use_pallas="on"), device="cpu")
    assert sim.kernels == KernelPlan("general_xz", "xz")
    assert TS.tiling_mode(sim.geom, sim.cfg) == "xz"
    assert T.Simulation(T.Config(**kw), device="cpu").kernels == \
        KernelPlan(None, None)


def test_use_pallas_on_without_a_kernel_raises():
    """'on' with a predictor no ported kernel serves raises: a 2-D grid
    (Nz = 1, which the reference's kernel gate refuses too). The central
    Taylor-Green, which had none before, now plans the general predictor;
    'auto' on the CPU runs the eager path."""
    with pytest.raises(NotImplementedError, match="no ported kernel"):
        T.Simulation(_cfg(T, TGV, Nz=1, use_pallas="on"), device="cpu")
    kw = dict(TGV, convective_scheme="central")
    assert T.Simulation(_cfg(T, kw, use_pallas="on"), device="cpu").kernels \
        == KernelPlan("general", "slab")
    assert T.Simulation(_cfg(T, kw), device="cpu").kernels == \
        KernelPlan(None, None)
    with pytest.raises(ValueError):
        T.Simulation(_cfg(T, TGV, use_pallas="yes"), device="cpu")


def _lid_steps(mode):
    kw = dict(CHANNEL, lid_velocity=0.5)
    rsim = R.Simulation(_cfg(R, kw, use_pallas="off"))
    tsim = T.Simulation(_cfg(T, kw, use_pallas=mode), device="cpu")
    rs = R.init_poiseuille(rsim.cfg, rsim.mesh, fraction=0.5)
    ts = _to_port(rs, tsim)
    for _ in range(3):
        rs, _ = rsim.step(rs)
        ts, _ = tsim.step(ts)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(rs, k)), rtol=0,
                                   atol=ATOL, err_msg=k)
    return tsim


def test_lid_driven_wall_runs_eagerly():
    """A moving top wall under 'off' runs the eager operators, which honour
    AxisGeom.tang, and matches the reference."""
    assert _lid_steps("off").kernels == KernelPlan(None, None)


def test_lid_driven_wall_takes_the_general_kernel():
    """A moving top wall is outside the channel kernel's gate (it hardcodes
    no-slip) but inside the general predictor's: 'on' plans it and matches
    the reference."""
    assert _lid_steps("on").kernels == KernelPlan("general", "slab")


def test_state_round_trip_and_fields():
    sim = T.Simulation(_cfg(T, CHANNEL), device="cpu")
    gen = torch.Generator().manual_seed(7)
    st = T.perturbed_channel(sim.cfg, sim.mesh, gen, amp=0.05, device="cpu")
    assert [tuple(c.shape) for c in st.velocity] == \
        list(T.velocity_shapes(sim.cfg))
    assert float(st.v[:, 0].abs().max()) == float(st.v[:, -1].abs().max()) \
        == 0.0
    again = T.perturbed_channel(sim.cfg, sim.mesh,
                                torch.Generator().manual_seed(7), amp=0.05,
                                device="cpu")
    assert torch.equal(st.u, again.u)
    back = T.state_from_numpy(T.state_to_numpy(st), "cpu", torch.float64)
    for k in ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp"):
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    assert back.step.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="recycling"):
        T.state_from_numpy({"u": np.zeros(3), "inlet_u": np.zeros(3)},
                           "cpu", torch.float64)
    # the port's Poiseuille and TGV ICs equal the reference's
    rsim = R.Simulation(_cfg(R, CHANNEL))
    np.testing.assert_array_equal(
        T.init_poiseuille(sim.cfg, sim.mesh, 1.0, device="cpu").u.numpy(),
        np.asarray(R.init_poiseuille(rsim.cfg, rsim.mesh, 1.0).u))
    tsim = T.Simulation(_cfg(T, TGV), device="cpu")
    rtsim = R.Simulation(_cfg(R, TGV))
    rt = R.init_taylor_green(rtsim.cfg, rtsim.mesh)
    tt = T.init_taylor_green(tsim.cfg, tsim.mesh, device="cpu")
    for k in ("u", "v", "w", "p"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(rt, k)))


def test_import_loads_no_jax():
    code = ("import sys, cfdnn_tpu_torch, cfdnn_tpu_torch.bench, "
            "cfdnn_tpu_torch.turbulence.transport, "
            "cfdnn_tpu_torch.turbulence.earsm, "
            "cfdnn_tpu_torch.turbulence.algebraic, "
            "cfdnn_tpu_torch.turbulence.features, "
            "cfdnn_tpu_torch.turbulence.registry, cfdnn_tpu_torch.ibm, "
            "cfdnn_tpu_torch.ibm.geometry, cfdnn_tpu_torch.ibm.forcing, "
            "cfdnn_tpu_torch.sass_compare, cfdnn_tpu_torch.xz_variants, "
            "cfdnn_tpu_torch.cuda_tests, "
            "cfdnn_tpu_torch.poisson.pallas_fht, "
            "cfdnn_tpu_torch.poisson.fht; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m == 'cfdnn_tpu' or m.startswith('cfdnn_tpu.') "
            "for m in sys.modules), 'jax or cfdnn_tpu imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
