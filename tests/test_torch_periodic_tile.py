"""The two slab kernels redesigned onto a walked (x, z) tile after
predictor_channel and correct: predictor_periodic
(csrc/predictor_periodic_tile.cuh, on xz_tile.cuh's staged window) and
divergence (csrc/divergence.cu, one thread a cell reading each face once).

On the CPU: the wrappers (their twins here) against the JAX reference on
the shapes where the tiles can break, float64 to 1e-12: predictor_periodic
against `fused_predictor` in interpret mode at nx = 8 with ny = 1, 2, 3 and
nz = 6 (< 32), on a ragged 12 x 20 x 40 and below the tile's width (nx =
5, 3); divergence against `fused_divergence` in interpret mode where its
periodic-x slab serves and against the reference's operators on the
periodic box, the duct, a wall-x cavity, a 2-D channel and an nx = 5
channel; the wrappers' 32-bit offset gate (ValueError naming it); and 4
steps of a ragged Taylor-Green through both kernels' wrappers against the
reference's Pallas path.

On a CUDA card (`cuda`): each kernel against its twin on chip_smoke's edge
shapes (`_tile_cases`), float64 to 1e-14 and float32 to 1e-5 of each
output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

ATOL = 1e-12
PERIODIC = dict(bc_y="periodic", y_min=0.0, y_max=1.0)


def _sims(**kw):
    base = dict(nu=3e-3, nu_specified=True, dp_dx=-2e-3, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype="float64")
    base.update(kw)
    rkw, tkw = dict(base), dict(base)
    for k, v in base.items():
        if k.startswith("bc_"):
            rkw[k], tkw[k] = R.BCType(v), T.BCType(v)
        if k == "convective_scheme":
            rkw[k], tkw[k] = R.ConvectiveScheme(v), T.ConvectiveScheme(v)
    return (R.Simulation(R.Config(**rkw)),
            T.Simulation(T.Config(**tkw), device="cpu"))


def _fields(sim, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _close(got, want, what=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=what)


# the periodic predictor's edge shapes: nx = 8 (one x tile, its halo
# wrapped) with one, two and three y planes (the ring's wrapped planes are
# the plane itself or its one neighbour) and nz = 6 < 32; a ragged tile
# over several chunks; x below the tile's width (the staged x wrapped more
# than once)
EDGE_BOXES = [(8, 1, 6), (8, 2, 6), (8, 3, 6), (12, 20, 40), (5, 20, 33),
              (3, 9, 40)]


@pytest.mark.parametrize("shape", EDGE_BOXES,
                         ids=["x".join(map(str, s)) for s in EDGE_BOXES])
def test_predictor_periodic_edge_shapes_match_pallas(shape):
    nx, ny, nz = shape
    rs, ts = _sims(Nx=nx, Ny=ny, Nz=nz, **PERIODIC, z_max=2.0,
                   convective_scheme="skew")
    assert K.periodic_eligible(ts.geom)
    g = rs.geom
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=rs.cfg.nu, fx=0.7)
    arrs = _fields(ts, 21)
    want = PK.fused_predictor(*(jnp.asarray(a) for a in arrs), 1e-3,
                              interpret=True, **kw)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    _close(K.predictor_periodic(*_t(arrs), dt, **kw), want, str(shape))


# divergence's geometries: every mix of axis modes the wrapper takes
DIV_GRIDS = {
    "periodic": dict(Nx=12, Ny=20, Nz=40, **PERIODIC),
    "duct": dict(Nx=12, Ny=20, Nz=24, stretch_y=True, bc_z="wall",
                 z_min=-1.0),
    "wall-x": dict(Nx=10, Ny=18, Nz=16, bc_x="wall"),
    "2-D": dict(Nx=24, Ny=20, Nz=1, stretch_y=True),
    "nx5": dict(Nx=5, Ny=20, Nz=33, stretch_y=True),
    "channel": dict(Nx=12, Ny=70, Nz=40, stretch_y=True),
}


@pytest.mark.parametrize("grid", sorted(DIV_GRIDS))
def test_divergence_geometries_match_reference(grid):
    rs, ts = _sims(**DIV_GRIDS[grid])
    arrs = _fields(ts, 23)
    ja = [jnp.asarray(a) for a in arrs]
    got = K.divergence(*_t(arrs), geom=ts.geom)
    _close(got, rops.divergence(ja, rs.geom), grid)
    if rs.geom.axes[0].periodic and ts.cfg.Nz > 1:
        _close(got, PK.fused_divergence(*ja, geom=rs.geom, interpret=True),
               grid)


def test_wrappers_refuse_offsets_past_32_bits(monkeypatch):
    """Both tiles index with 32-bit offsets: a field past INT32_MAX
    elements raises ValueError naming the gate (here with the limit
    lowered, so that a small grid reaches it), on the CPU as on the card;
    the periodic predictor takes every nx (no x gate, unlike the channel
    predictor's)."""
    rs, ts = _sims(Nx=5, Ny=6, Nz=8, **PERIODIC, convective_scheme="skew")
    u, v, w = _t(_fields(ts, 25))
    dt = torch.tensor(1e-3, dtype=torch.float64)
    g = ts.geom
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=1e-3, fx=0.0)
    K.predictor_periodic(u, v, w, dt, **kw)
    K.divergence(u, v, w, geom=g)
    assert K.tile_refusal("predictor_periodic", 5, 5 * 6 * 8) is None
    monkeypatch.setattr(K, "INT32_MAX", 5 * 6 * 8 - 1)
    with pytest.raises(ValueError,
                       match=r"predictor_periodic: .*32-bit.*2\^31 - 1"):
        K.predictor_periodic(u, v, w, dt, **kw)
    with pytest.raises(ValueError, match=r"divergence: .*32-bit.*2\^31 - 1"):
        K.divergence(u, v, w, geom=g)


def test_ragged_taylor_green_through_both_wrappers_matches_reference():
    """4 steps of a 12x20x40 Taylor-Green (a ragged tile: neither x nor z
    a multiple of the 8 x 32 tile) with use_pallas="on": the port through
    predictor_periodic, divergence and correct (their twins on the CPU),
    the reference through its interpret-mode Pallas kernels, u, v, w and p
    to 1e-11."""
    base = dict(Nx=12, Ny=20, Nz=40, bc_x="periodic", bc_y="periodic",
                bc_z="periodic", y_min=0.0, y_max=2 * np.pi,
                z_max=2 * np.pi, convective_scheme="skew", use_pallas="on")
    rsim, tsim = _sims(**base)
    assert tsim.kernels == KernelPlan("periodic", "slab")
    assert rsim._pallas_predictor_ok == "slab"
    rs = R.init_taylor_green(rsim.cfg, rsim.mesh)
    ts = T.state_from_numpy(
        {k: np.asarray(getattr(rs, k)) for k in
         ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp")},
        "cpu", tsim.dtype)
    for _ in range(4):
        rs, _ = rsim.step(rs)
        ts, td = tsim.step(ts)
    out = T.state_to_numpy(ts)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(rs, k)),
                                   rtol=0, atol=1e-11, err_msg=k)
    assert float(td.div_linf) < 1e-10


@pytest.mark.cuda
def test_periodic_tile_kernels_match_twins_on_cuda():
    """On a CUDA card: predictor_periodic and divergence against their
    twins on the tiles' edge shapes (chip_smoke._tile_cases), float64 to
    1e-14 and float32 to 1e-5 of each output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for dtype in (torch.float64, torch.float32):
        cases = [c for c in chip_smoke._tile_cases(dtype, dev, seed=5)
                 if c.name in ("predictor_periodic", "divergence")]
        assert len(cases) == 13
        for case in cases:
            got, ref = case.kern(), case.twin()
            for out, err, lim, _ in chip_smoke.compare(
                    case.name, got, ref, dtype, case.f64_tol):
                assert err <= lim, f"{case.label} {out} {dtype}: {err}"
