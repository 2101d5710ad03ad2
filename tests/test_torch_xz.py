"""The port's (x, z)-tiled kernels (predictor_general_xz, nu_sgs_xz,
divergence_xz, correct_xz), the "xz" kernel plan and the steps it carries,
against the JAX reference at float64 on the CPU.

Grids of the reference's own xz tests (tests/test_pallas_kernels.py
:179-301): 16x24x32 for the kernels, walled stretched and periodic y; the
plan and the trajectories with the slab cap lowered in both packages (the
reference's `_SLAB_FIT_CELLS`, the port's `solver.SLAB_FIT_CELLS`), so a
small grid takes "xz". Inputs from np.random.default_rng handed across as
NumPy arrays; the reference's Pallas kernels run in interpret mode, the
port's wrappers take their plain twins on CPU tensors. Limits: the kernels
1e-13 (the reference's xz tests hold theirs to 1e-13 / 1e-14), 4-step
trajectories 1e-12.
"""

from types import SimpleNamespace

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

KERNEL_GRID = dict(Nx=16, Ny=24, Nz=32, nu=0.01, nu_specified=True, dt=1e-3,
                   adaptive_dt=False, dtype="float64")
# (bc_y, stretch_y) of the reference's xz kernel tests
Y_AXES = {"wall-stretched": ("wall", True), "periodic": ("periodic", False)}
CLOSURES = {"smagorinsky": 0.17, "wale": 0.325, "vreman": 0.07}
PHYS = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
CHANNEL = dict(PHYS, Nx=16, Ny=12, Nz=32, stretch_y=True)
TGV = dict(PHYS, Nx=16, Ny=16, Nz=32, bc_y="periodic", y_min=0.0,
           y_max=2 * np.pi, z_max=2 * np.pi, dp_dx=0.0,
           convective_scheme="skew")


def _cfg(pkg, **kw):
    k = dict(kw)
    for name, enum_ in (("bc_y", pkg.BCType), ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _sims(**kw):
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _kernel_sims(y_axis, **kw):
    bc_y, stretch = Y_AXES[y_axis]
    return _sims(**KERNEL_GRID, bc_y=bc_y, stretch_y=stretch, **kw)


def _rand(sim, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    comps = [scale * rng.standard_normal(s)
             for s in T.velocity_shapes(sim.cfg)]
    cells = (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz)
    return comps, rng.standard_normal(cells)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("y_axis", sorted(Y_AXES))
def test_predictor_general_xz_matches_pallas(y_axis, scheme, with_nut):
    """predictor_general_xz (its twin on the CPU) and predictor_general_twin
    against the reference's fused_predictor_general_xz in interpret mode,
    every star, to 1e-13."""
    rs, ts = _kernel_sims(y_axis, convective_scheme=scheme)
    assert K.xz_eligible(ts.geom)
    comps, cell = _rand(ts, 11, 0.1)
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
def test_nu_sgs_xz_matches_pallas(y_axis, closure):
    """nu_sgs_xz (its twin on the CPU) against the reference's
    fused_nu_sgs_xz in interpret mode with the closure's model_fn, to
    1e-13."""
    rs, ts = _kernel_sims(y_axis, turb_model=closure)
    assert K.nu_sgs_xz_eligible(ts.geom)
    comps, _ = _rand(ts, 12)
    want = PK.fused_nu_sgs_xz(*(jnp.asarray(c) for c in comps),
                              geom=rs.geom, model_fn=rs.turb._model_fn,
                              interpret=True)
    assert want is not None
    u, v, w = (_t(c) for c in comps)
    _close(K.nu_sgs_xz(u, v, w, K.les_arrays(ts.geom), geom=ts.geom,
                       closure=closure, coeff=CLOSURES[closure]), want,
           1e-13)


@pytest.mark.parametrize("y_axis", sorted(Y_AXES))
def test_divergence_correct_xz_match_pallas(y_axis):
    """divergence_xz and correct_xz (their twins on the CPU) against the
    reference's fused_divergence_xz and fused_correct_xz in interpret
    mode, to 1e-13."""
    rs, ts = _kernel_sims(y_axis)
    comps, p = _rand(ts, 13)
    dt = 1e-3
    jc = [jnp.asarray(c) for c in comps]
    u, v, w = (_t(c) for c in comps)
    _close(K.divergence_xz(u, v, w, geom=ts.geom),
           PK.fused_divergence_xz(*jc, geom=rs.geom, interpret=True), 1e-13,
           "divergence")
    _close(K.correct_xz(u, v, w, _t(p), torch.tensor(dt, dtype=torch.float64),
                        geom=ts.geom),
           PK.fused_correct_xz(*jc, jnp.asarray(p), dt, geom=rs.geom,
                               interpret=True), 1e-13, "correct")


def test_xz_wrappers_refuse_a_walled_z():
    """The xz gate wants a periodic uniform z: each wrapper raises on the
    duct (walled, stretched z) before it touches a tensor."""
    _, ts = _sims(**dict(CHANNEL, bc_z="wall", stretch_z=True, z_min=-1.0,
                         z_max=1.0))
    assert not K.xz_eligible(ts.geom)
    u, v, w = (torch.zeros(s, dtype=torch.float64)
               for s in T.velocity_shapes(ts.cfg))
    with pytest.raises(NotImplementedError, match="divergence_xz"):
        K.divergence_xz(u, v, w, geom=ts.geom)
    with pytest.raises(NotImplementedError, match="nu_sgs_xz"):
        K.nu_sgs_xz(u, v, w, K.les_arrays(ts.geom), geom=ts.geom,
                    closure="smagorinsky", coeff=0.17)


def _lower_caps(monkeypatch):
    """Lower the slab cap of both packages, as the reference's own xz tests
    do (tests/test_pallas_kernels.py:265): every plane overflows it."""
    monkeypatch.setattr(PK, "_SLAB_FIT_CELLS", 8)
    monkeypatch.setattr(TS, "SLAB_FIT_CELLS", 8)


# the reference's tiling and closure routing on each geometry, with the
# lowered cap: (grid, the reference's mode, the port's CUDA plan)
PLANS = {
    "laminar-periodic": (TGV, "xz", KernelPlan("general_xz", "xz")),
    "walled-channel": (CHANNEL, "xz", KernelPlan("general_xz", "xz")),
    "les-smagorinsky": (dict(TGV, turb_model="smagorinsky"), "xz",
                        KernelPlan("general_xz", "xz", "nu_sgs_xz")),
    "les-vreman-channel": (dict(CHANNEL, turb_model="vreman"), "xz",
                           KernelPlan("general_xz", "xz", "nu_sgs_xz")),
    "dynamic-smagorinsky": (dict(CHANNEL, turb_model="dynamic_smagorinsky"),
                            "xz", KernelPlan("general_xz", "xz")),
    "sst": (dict(CHANNEL, turb_model="sst"), "xz",
            KernelPlan("general_xz", "xz")),
    "walled-z": (dict(CHANNEL, bc_z="wall", stretch_z=True, z_min=-1.0,
                      z_max=1.0), False, KernelPlan(None, None)),
    "nz-48": (dict(CHANNEL, Nz=48), False, KernelPlan(None, None)),
    "les-walled-z": (dict(CHANNEL, bc_z="wall", stretch_z=True, z_min=-1.0,
                          z_max=1.0, turb_model="smagorinsky"), False,
                     KernelPlan(None, None)),
    "les-nz-48": (dict(CHANNEL, Nz=48, turb_model="wale"), False,
                  KernelPlan(None, None)),
    "dynamic-nz-48": (dict(CHANNEL, Nz=48, turb_model="dynamic_smagorinsky"),
                      False, KernelPlan(None, None)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_xz_plan_matches_reference(name, monkeypatch):
    """With the slab cap lowered, the port's CUDA plan takes "xz" exactly
    where the reference's _pallas_eligible does: the general_xz predictor
    with the xz projection on a periodic z that tiles, nu_sgs_xz where the
    reference's LES fuses in "xz", the plain chains of dynamic Smagorinsky
    and SST, and no kernel, the closure's included, on a walled z or at
    Nz = 48 (no clean tiling), where use_pallas="on" raises."""
    _lower_caps(monkeypatch)
    grid, mode, plan = PLANS[name]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="on"))
    assert rs._pallas_predictor_ok == mode
    if hasattr(rs.turb, "_fuse"):
        assert rs.turb._fuse == mode
    sim = T.Simulation(_cfg(T, **grid), device="cpu")
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    got = sim._select_kernels()
    assert got == plan
    assert TS.tiling_mode(sim.geom, sim.cfg) == (mode or None)
    if mode:
        assert T.Simulation(_cfg(T, **grid, use_pallas="on"),
                            device="cpu").kernels == plan
    else:
        with pytest.raises(NotImplementedError, match="no ported kernel"):
            T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")


def test_xz_tiling_predicates_match_reference():
    """slab_fits and xz_tileable against the reference's slab_fits and
    _auto_bxz on the planes around the cap: 627^2 fits, 640^2 does not,
    and 640^3 tiles (the les_tgv640 cell); z lengths that only a 32-block
    or nothing divides; halo 2 on an odd nx."""
    for n in (627, 628, 640):
        # the predicates read the y and z cells and the order alone
        geom = SimpleNamespace(axes=(None, SimpleNamespace(n=n),
                                     SimpleNamespace(n=n)), space_order=2)
        assert TS.slab_fits(geom) == PK.slab_fits(geom) == (n == 627)
    for nx, ny, nz, ng in ((640, 640, 640, 1), (16, 12, 32, 1),
                           (16, 12, 48, 1), (9, 700, 96, 2), (8, 900, 160, 2),
                           (12, 4000, 512, 1)):
        assert TS.xz_tileable(nx, ny, nz, ng) == (
            PK._auto_bxz(nx, ny, nz, ng) is not None), (nx, ny, nz, ng)


TRAJECTORIES = {
    "channel": (CHANNEL, R.perturbed_channel, KernelPlan("general_xz", "xz")),
    "les_tgv": (dict(TGV, nu=1.0 / 1600.0, turb_model="smagorinsky"),
                R.init_taylor_green,
                KernelPlan("general_xz", "xz", "nu_sgs_xz")),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_xz_trajectory_matches_reference(name, monkeypatch):
    """4 steps in forced "xz" (the slab cap lowered in both packages): the
    port under use_pallas="on" (its xz wrappers' twins) against the
    reference's xz kernels in interpret mode, from the same initial state:
    u, v, w, p (and nu_t) to 1e-12; every step goes through the four xz
    wrappers (three without a closure) and no slab wrapper."""
    _lower_caps(monkeypatch)
    grid, init, plan = TRAJECTORIES[name]
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
    keys = ("u", "v", "w", "p") + (("nu_t",) if plan.closure else ())
    for k in keys:
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert float(d.div_linf) < 1e-10
    per_step = 1 if plan.closure else 0
    assert calls == {"predictor_general_xz": 4, "nu_sgs_xz": 4 * per_step,
                     "divergence_xz": 4, "correct_xz": 4,
                     "predictor_general": 0, "nu_sgs": 0, "divergence": 0,
                     "correct": 0}


# the grids of the on-card check: the kernel grids of the CPU tests, a lid
# (moving wall ghosts), ragged tiles (nx, nz not multiples of 8 x 32; ny
# over one 64-plane chunk) on a walled and a periodic y, and nx = 8, the
# smallest the gate serves, with nz < 32
CUDA_GRIDS = {
    "wall-stretched": dict(KERNEL_GRID, bc_y="wall", stretch_y=True),
    "periodic": dict(KERNEL_GRID, bc_y="periodic"),
    "lid": dict(KERNEL_GRID, Ny=12, y_min=0.0, y_max=1.0, lid_velocity=1.3),
    "ragged-wall": dict(KERNEL_GRID, Nx=12, Ny=70, Nz=40, stretch_y=True),
    "ragged-periodic": dict(KERNEL_GRID, Nx=20, Ny=67, Nz=44,
                            bc_y="periodic"),
    "nx8": dict(KERNEL_GRID, Nx=8, Ny=5, Nz=6, stretch_y=True),
}


def hold_xz_kernels_on_cuda(grids, seed):
    """Each xz kernel against its twin and against the slab kernel of the
    same function (at O4 the O4 variants of both), float64, to 1e-13 of
    each output's scale, on `grids` (name: Config fields), inputs drawn
    with numpy from `seed`: the predictor skew and central, with and
    without nu_t; nu_sgs_xz with the three closures (where its gate
    serves: not on a lid); divergence_xz and correct_xz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for name, grid in grids.items():
        for scheme in ("skew", "central"):
            cfg = _cfg(T, **grid, convective_scheme=scheme).finalize()
            sim = T.Simulation(cfg.with_(use_pallas="off"), device=dev)
            g = sim.geom
            assert K.xz_eligible(g), name
            comps, cell = _rand(sim, seed)
            u, v, w = (_t(c).to(dev) for c in comps)
            nut = _t(0.01 * np.abs(cell)).to(dev)
            p = _t(cell).to(dev)
            dt = torch.tensor(1e-3, dtype=torch.float64, device=dev)
            gen, les = K.general_arrays(g), K.les_arrays(g)
            kw = dict(geom=g, nu=cfg.nu, fx=0.5, scheme=cfg.convective_scheme)
            calls = [
                (f"predictor {n is not None}",
                 K.predictor_general_xz(u, v, w, dt, gen, nu_t=n, **kw),
                 K.predictor_general(u, v, w, dt, gen, nu_t=n, **kw),
                 K.predictor_general_twin(u, v, w, dt, n, **kw))
                for n in (None, nut)]
            if scheme == "skew":
                calls += [
                    ("divergence", K.divergence_xz(u, v, w, geom=g),
                     K.divergence(u, v, w, geom=g),
                     K.divergence_twin(u, v, w, geom=g)),
                    ("correct", K.correct_xz(u, v, w, p, dt, geom=g),
                     K.correct(u, v, w, p, dt, geom=g),
                     K.correct_twin(u, v, w, p, dt, geom=g))]
                for closure, coeff in CLOSURES.items():
                    if not K.nu_sgs_xz_eligible(g):
                        break
                    lk = dict(geom=g, closure=closure, coeff=coeff)
                    calls.append((closure, K.nu_sgs_xz(u, v, w, les, **lk),
                                  K.nu_sgs(u, v, w, les, **lk),
                                  K.nu_sgs_twin(u, v, w, **lk)))
            torch.cuda.synchronize()
            for what, got, slab, twin in calls:
                for outs in zip(*(o if isinstance(o, tuple) else (o,)
                                  for o in (got, slab, twin))):
                    scale = float(outs[2].abs().max())
                    for other in outs[1:]:
                        err = float((outs[0] - other).abs().max())
                        assert err <= 1e-13 * scale, (name, scheme, what, err)


@pytest.mark.cuda
def test_xz_kernels_match_twins_and_slab_kernels_on_cuda():
    """On a CUDA card: each xz kernel against its twin and against the slab
    kernel of the same function, float64, to 1e-13 of each output's scale,
    on CUDA_GRIDS (`hold_xz_kernels_on_cuda`)."""
    hold_xz_kernels_on_cuda(CUDA_GRIDS, 14)
