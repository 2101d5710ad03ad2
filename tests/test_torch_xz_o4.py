"""The port's (x, z)-tiled kernels at O4 (space_order=4: the O4 variants of
predictor_general_xz, divergence_xz and correct_xz, and nu_sgs_xz on an O4
grid), the O4 "xz" kernel plan and the steps it carries, against the JAX
reference at float64 on the CPU.

The grids of tests/test_torch_xz.py at space_order=4: 16x24x32 for the
kernels (a walled stretched y, O2 across it, and a periodic y, O4), and
the plan and the trajectories with the slab cap lowered in both packages
(the reference's `_SLAB_FIT_CELLS`, the port's `solver.SLAB_FIT_CELLS`),
so that a small grid takes "xz". Inputs from np.random.default_rng handed
across as NumPy arrays; the reference's Pallas kernels run in interpret
mode (at a halo of 2, as its xz plan runs them at O4), the port's
wrappers take their plain twins on CPU tensors. Limits: the kernels
1e-13, as the O2 xz tests; 4-step trajectories 1e-12 (p of the larger of
its own and the velocity's scale: it solves div(u*) / dt).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch import solver as TS
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan
from test_torch_xz import (CHANNEL, CLOSURES, KERNEL_GRID, TGV, Y_AXES, _cfg,
                           _close, _lower_caps, _rand, _t,
                           hold_xz_kernels_on_cuda)

O4 = dict(space_order=4)
O4_KERNEL_GRID = dict(KERNEL_GRID, **O4)


def _sims(**kw):
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _kernel_sims(y_axis, **kw):
    bc_y, stretch = Y_AXES[y_axis]
    return _sims(**O4_KERNEL_GRID, bc_y=bc_y, stretch_y=stretch, **kw)


@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("y_axis", sorted(Y_AXES))
def test_predictor_general_xz_o4_matches_pallas(y_axis, scheme, with_nut):
    """predictor_general_xz at O4 (its twin on the CPU) and
    predictor_general_twin against the reference's
    fused_predictor_general_xz at space_order=4 (ng = 2) in interpret
    mode, every star, to 1e-13: O4 along x, z and a periodic y, O2 across
    a walled y; skew with nu_t has no O4 term (the O2 xz kernel's work on
    the card)."""
    rs, ts = _kernel_sims(y_axis, convective_scheme=scheme)
    assert K.xz_eligible(ts.geom) and ts.geom.use_o4(0)
    assert ts.geom.use_o4(1) == (y_axis == "periodic")
    comps, cell = _rand(ts, 21, 0.1)
    nut = 0.01 * np.abs(cell) if with_nut else None
    dt, fx = 1e-3, 0.5
    want = PK.fused_predictor_general_xz(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    assert want is not None
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    kw = dict(geom=ts.geom, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_general_twin(u, v, w, dt_t, _t(nut), **kw), want,
           1e-13, "twin")
    _close(K.predictor_general_xz(u, v, w, dt_t, K.general_arrays(ts.geom),
                                  nu_t=_t(nut), **kw), want, 1e-13,
           "wrapper")


@pytest.mark.parametrize("closure", sorted(CLOSURES))
@pytest.mark.parametrize("y_axis", sorted(Y_AXES))
def test_nu_sgs_xz_o4_matches_pallas(y_axis, closure):
    """nu_sgs_xz on an O4 grid (its gate lifted at O4; the strain stays
    O2) against the reference's fused_nu_sgs_xz at space_order=4 in
    interpret mode with the closure's model_fn, to 1e-13."""
    rs, ts = _kernel_sims(y_axis, turb_model=closure)
    assert K.nu_sgs_xz_eligible(ts.geom) and ts.geom.use_o4(0)
    comps, _ = _rand(ts, 22)
    want = PK.fused_nu_sgs_xz(*(jnp.asarray(c) for c in comps),
                              geom=rs.geom, model_fn=rs.turb._model_fn,
                              interpret=True)
    assert want is not None
    u, v, w = (_t(c) for c in comps)
    _close(K.nu_sgs_xz(u, v, w, K.les_arrays(ts.geom), geom=ts.geom,
                       closure=closure, coeff=CLOSURES[closure]), want,
           1e-13)


@pytest.mark.parametrize("y_axis", sorted(Y_AXES))
def test_divergence_correct_xz_o4_match_pallas(y_axis):
    """divergence_xz and correct_xz at O4 (their twins on the CPU) against
    the reference's fused_divergence_xz and fused_correct_xz at
    space_order=4 (ng = 2) in interpret mode, to 1e-13."""
    rs, ts = _kernel_sims(y_axis)
    comps, p = _rand(ts, 23)
    dt = 1e-3
    jc = [jnp.asarray(c) for c in comps]
    u, v, w = (_t(c) for c in comps)
    _close(K.divergence_xz(u, v, w, geom=ts.geom),
           PK.fused_divergence_xz(*jc, geom=rs.geom, interpret=True), 1e-13,
           "divergence")
    _close(K.correct_xz(u, v, w, _t(p), torch.tensor(dt, dtype=torch.float64),
                        geom=ts.geom),
           PK.fused_correct_xz(*jc, jnp.asarray(p), dt, geom=rs.geom,
                               interpret=True),
           1e-13, "correct")


def test_xz_o4_gate_needs_o4_x_and_z():
    """At O4 the xz gate takes x and z that are O4 both (periodic,
    uniform, n >= 4): a periodic z of 3 cells, O2 at every order, is
    refused by each wrapper before it touches a tensor; the same grid at
    O2 is served."""
    _, ts = _sims(**dict(O4_KERNEL_GRID, Nz=3, bc_y="periodic"))
    assert not ts.geom.use_o4(2) and not K.xz_eligible(ts.geom)
    assert not K.nu_sgs_xz_eligible(ts.geom)
    u, v, w = (torch.zeros(s, dtype=torch.float64)
               for s in T.velocity_shapes(ts.cfg))
    with pytest.raises(NotImplementedError, match="divergence_xz"):
        K.divergence_xz(u, v, w, geom=ts.geom)
    with pytest.raises(NotImplementedError, match="nu_sgs_xz"):
        K.nu_sgs_xz(u, v, w, K.les_arrays(ts.geom), geom=ts.geom,
                    closure="smagorinsky", coeff=0.17)
    _, t2 = _sims(**dict(KERNEL_GRID, Nz=3, bc_y="periodic"))
    assert K.xz_eligible(t2.geom)


# the reference's predictor mode and LES mode on each O4 geometry, with the
# lowered cap: (grid, _pallas_eligible's mode, the LES's _fuse, the port's
# CUDA plan). "prime-nx": Nx = 11 has no divisor between 2 and the block
# cap, so the predictor (halo 2) finds no tiling while the LES gate (halo
# 1) tiles: no predictor kernel, nu_sgs_xz for the closure
PLANS_O4 = {
    "laminar-periodic": (dict(TGV, **O4), "xz", None,
                         KernelPlan("general_xz", "xz")),
    "walled-channel": (dict(CHANNEL, **O4), "xz", None,
                       KernelPlan("general_xz", "xz")),
    "les-smagorinsky": (dict(TGV, **O4, turb_model="smagorinsky"), "xz",
                        "xz", KernelPlan("general_xz", "xz", "nu_sgs_xz")),
    "les-wale-channel": (dict(CHANNEL, **O4, turb_model="wale"), "xz", "xz",
                         KernelPlan("general_xz", "xz", "nu_sgs_xz")),
    "dynamic-smagorinsky": (dict(CHANNEL, **O4,
                                 turb_model="dynamic_smagorinsky"),
                            "xz", "xz", KernelPlan("general_xz", "xz")),
    "komega": (dict(CHANNEL, **O4, turb_model="komega"), "xz", None,
               KernelPlan("general_xz", "xz")),
    "prime-nx": (dict(TGV, **O4, Nx=11), False, None, KernelPlan(None, None)),
    "les-prime-nx": (dict(TGV, **O4, Nx=11, turb_model="smagorinsky"), False,
                     "xz", KernelPlan(None, None, "nu_sgs_xz")),
    "dynamic-prime-nx": (dict(TGV, **O4, Nx=11,
                              turb_model="dynamic_smagorinsky"),
                         False, "xz", KernelPlan(None, None)),
    "les-nz-48": (dict(CHANNEL, **O4, Nz=48, turb_model="vreman"), False,
                  False, KernelPlan(None, None)),
    "les-walled-z": (dict(CHANNEL, **O4, bc_z="wall", stretch_z=True,
                          z_min=-1.0, z_max=1.0, turb_model="smagorinsky"),
                     False, False, KernelPlan(None, None)),
}


@pytest.mark.parametrize("name", sorted(PLANS_O4))
def test_xz_o4_plan_matches_reference(name, monkeypatch):
    """With the slab cap lowered, the port's CUDA plan at O4 takes what the
    reference takes: "xz" with the general_xz predictor and the xz
    projection where its predictor tiles at a halo of 2, nu_sgs_xz where
    its LES gate tiles at a halo of 1 (the prime Nx too, where the
    predictor has no kernel), the plain chains of dynamic Smagorinsky and
    k-omega, and no kernel on a walled z or at Nz = 48; use_pallas="on"
    gives the same plan where a predictor kernel serves and raises where
    none does."""
    _lower_caps(monkeypatch)
    grid, mode, les_mode, plan = PLANS_O4[name]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="on"))
    assert rs._pallas_predictor_ok == mode
    sim = T.Simulation(_cfg(T, **grid), device="cpu")
    if les_mode is not None:
        assert rs.turb._fuse == les_mode
        assert TS.les_tiling(sim.geom) == (les_mode or None)
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    assert sim._select_kernels() == plan
    assert TS.tiling_mode(sim.geom, sim.cfg) == (mode or None)
    if mode:
        assert T.Simulation(_cfg(T, **grid, use_pallas="on"),
                            device="cpu").kernels == plan
    else:
        with pytest.raises(NotImplementedError, match="no ported kernel"):
            T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")


TRAJECTORIES_O4 = {
    "tgv": (dict(TGV, **O4), R.init_taylor_green,
            KernelPlan("general_xz", "xz")),
    "channel": (dict(CHANNEL, **O4), R.perturbed_channel,
                KernelPlan("general_xz", "xz")),
    # central: the O4 variant with nu_t (skew + nu_t has no O4 term)
    "les_tgv": (dict(TGV, **O4, nu=1.0 / 1600.0, turb_model="smagorinsky",
                     convective_scheme="central"), R.init_taylor_green,
                KernelPlan("general_xz", "xz", "nu_sgs_xz")),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES_O4))
def test_xz_o4_trajectory_matches_reference(name, monkeypatch):
    """4 steps at O4 in forced "xz" (the slab cap lowered in both
    packages): the port under use_pallas="on" (its xz wrappers' twins)
    against the reference's xz kernels at a halo of 2 in interpret mode,
    from the same initial state: u, v, w and nu_t to 1e-12 of each one's
    scale, p to 1e-12 of the larger of its own and the velocity's; every
    step goes through the xz wrappers and no slab wrapper."""
    _lower_caps(monkeypatch)
    grid, init, plan = TRAJECTORIES_O4[name]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="on"))
    ts = T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")
    assert rs._pallas_predictor_ok == "xz" and ts.kernels == plan
    names = ("predictor_general_xz", "nu_sgs_xz", "divergence_xz",
             "correct_xz", "predictor_general", "nu_sgs", "divergence",
             "correct")
    calls = dict.fromkeys(names, 0)
    for n in names:
        def spy(*a, _fn=getattr(K, n), _name=n, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, n, spy)
    r = (init(rs.cfg, rs.mesh, amp=0.05) if init is R.perturbed_channel
         else init(rs.cfg, rs.mesh))
    keys = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
    t = T.state_from_numpy({k: np.asarray(getattr(r, k)) for k in keys
                            if getattr(r, k) is not None}, "cpu", ts.dtype)
    for _ in range(4):
        r, _ = rs.step(r)
        t, d = ts.step(t)
    out = T.state_to_numpy(t)
    scales = {k: float(np.max(np.abs(np.asarray(getattr(r, k)))))
              for k in ("u", "v", "w", "p")
              + (("nu_t",) if plan.closure else ())}
    vel = max(scales["u"], scales["v"], scales["w"])
    for k, scale in scales.items():
        lim = 1e-12 * (max(scale, vel) if k == "p" else scale)
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)), rtol=0,
                                   atol=lim, err_msg=k)
    assert float(d.div_linf) < 1e-10
    per_step = 1 if plan.closure else 0
    assert calls == {"predictor_general_xz": 4, "nu_sgs_xz": 4 * per_step,
                     "divergence_xz": 4, "correct_xz": 4,
                     "predictor_general": 0, "nu_sgs": 0, "divergence": 0,
                     "correct": 0}


# the grids of the on-card check at O4: the kernel grids of the CPU tests,
# nx = 8 (the smallest the tile takes: one wrap of a two-cell halo), a
# lid, ragged tiles over two y chunks and periodic y of 4 and 5 cells
CUDA_GRIDS_O4 = {
    "wall-stretched": dict(O4_KERNEL_GRID, bc_y="wall", stretch_y=True),
    "periodic": dict(O4_KERNEL_GRID, bc_y="periodic"),
    "nx8": dict(O4_KERNEL_GRID, Nx=8, Ny=5, Nz=6, stretch_y=True),
    "lid": dict(O4_KERNEL_GRID, Ny=12, y_min=0.0, y_max=1.0,
                lid_velocity=1.3),
    "ragged-periodic": dict(O4_KERNEL_GRID, Nx=20, Ny=67, Nz=44,
                            bc_y="periodic"),
    "periodic-y4": dict(O4_KERNEL_GRID, Nx=12, Ny=4, Nz=8, bc_y="periodic"),
    "periodic-y5": dict(O4_KERNEL_GRID, Nx=8, Ny=5, Nz=5, bc_y="periodic"),
}


@pytest.mark.cuda
def test_xz_o4_kernels_match_twins_and_slab_kernels_on_cuda():
    """On a CUDA card: each O4 xz kernel against its twin and against the
    O4 slab kernel of the same function, float64, to 1e-13 of each
    output's scale, on CUDA_GRIDS_O4 (`hold_xz_kernels_on_cuda`)."""
    hold_xz_kernels_on_cuda(CUDA_GRIDS_O4, 24)
