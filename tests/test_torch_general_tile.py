"""The two kernels redesigned onto a walked (x, z) tile: predictor_general
(csrc/predictor_general_tile.cuh, xz_tile.cuh's window with a walled z
beside the walled y) and germano_pass1 (csrc/germano_tile.cuh, nu_sgs's
window with the test filter summed separably).

On the CPU: the wrappers (their twins here) against the JAX reference on
the shapes where the tiles can break, float64 to 1e-12 of each output's
scale: predictor_general against `fused_predictor_general` in interpret
mode at nx = 8 with ny = 2 and 3 (walled and periodic y), on a ragged
12 x 20 x 40, on ducts with nz = 31, 32 and 33 (w's wall face at a z
tile's edge), with a lid on y and on z, and through the xpad wrapper
against `fused_predictor_xpad`; germano_pass1 (|S|, <L:M>, <M:M>)
against `fused_germano_pass1` in interpret mode (its body's math on whole
arrays at an odd nx, which its slab cannot tile) at nx = 3, 5 and 8, ny =
2 and 3 (periodic and walled), on a stretched walled y, a ragged
12 x 20 x 40 and a duct (the filter truncated at the walls of z); both
wrappers' 32-bit offset gate; the chunk of y planes the two launchers
walk (csrc/tile_plan.cu, built by the host's C++ compiler); and 4 steps
of a ragged LES duct (WALE, central) and of ragged dynamic LES channels
and ducts through the wrappers against the reference's Pallas path in
interpret mode.

On a CUDA card (`cuda`): both kernels against their twins on chip_smoke's
edge shapes (`_general_tile_cases`), float64 to 1e-14 and float32 to 1e-5
of each output's scale, and germano_pass1's plane sums equal bit for bit
over two launches.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

RTOL = 1e-12    # of each output's scale
H100_SMS = 132
PHYS = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64", y_min=-1.0,
            y_max=1.0, z_min=-1.0, z_max=1.0)
PERIODIC_Y = dict(bc_y="periodic", y_min=0.0, y_max=1.0)
DUCT = dict(bc_z="wall", stretch_y=True, stretch_z=True)
# the predictor's edge shapes: (grid, scheme, with nu_t, the z walls'
# tangential velocities of u and v, or None)
LID_Z = ((0.4, -0.7), (0.0, 1.1))
PREDICTOR_GRIDS = {
    "8x2x6": (dict(Nx=8, Ny=2, Nz=6, stretch_y=True), "skew", True, None),
    "8x3x6": (dict(Nx=8, Ny=3, Nz=6, stretch_y=True), "central", True,
              None),
    "periodic-8x2x6": (dict(Nx=8, Ny=2, Nz=6, **PERIODIC_Y), "central",
                       True, None),
    "periodic-8x3x6": (dict(Nx=8, Ny=3, Nz=6, **PERIODIC_Y), "skew", False,
                       None),
    "ragged-12x20x40": (dict(Nx=12, Ny=20, Nz=40, stretch_y=True), "skew",
                        True, None),
    "duct-12x9x31": (dict(Nx=12, Ny=9, Nz=31, **DUCT), "central", True,
                     None),
    "duct-12x9x32": (dict(Nx=12, Ny=9, Nz=32, **DUCT), "skew", True, None),
    "duct-12x9x33": (dict(Nx=12, Ny=9, Nz=33, **DUCT), "central", False,
                     None),
    "lid-y-16x12x8": (dict(Nx=16, Ny=12, Nz=8, y_min=0.0, lid_velocity=1.3),
                      "skew", False, None),
    "lid-z-8x10x33": (dict(Nx=8, Ny=10, Nz=33, **PERIODIC_Y, bc_z="wall",
                           stretch_z=True), "central", True, LID_Z),
}
# germano's: overrides of a stretched walled-y channel
GERMANO_GRIDS = {
    "nx3-3x9x40": dict(Nx=3, Ny=9, Nz=40),
    "nx5-5x20x33": dict(Nx=5, Ny=20, Nz=33),
    "8x2x6": dict(Nx=8, Ny=2, Nz=6),
    "8x3x6": dict(Nx=8, Ny=3, Nz=6),
    "periodic-8x2x6": dict(Nx=8, Ny=2, Nz=6, **PERIODIC_Y),
    "periodic-8x3x6": dict(Nx=8, Ny=3, Nz=6, **PERIODIC_Y),
    "ragged-12x20x40": dict(Nx=12, Ny=20, Nz=40),
    "duct-12x9x33": dict(Nx=12, Ny=9, Nz=33, **DUCT),
}


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    if k.get("bc_y") != "periodic":
        k.setdefault("stretch_y", True)
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _sims(**kw):
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _with_z_lid(geom, tang):
    """`geom` with its walled z's walls moving: u and v at the (lo, hi)
    walls of z as `tang` gives them (the same dataclass in both
    packages)."""
    x, y, z = geom.axes
    z = dataclasses.replace(z, tang=tang + ((0.0, 0.0),))
    return dataclasses.replace(geom, axes=(x, y, z))


def _fields(sim, seed, with_nut=True):
    rng = np.random.default_rng(seed)
    vel = [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]
    cells = (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz)
    nut = 1e-2 * np.abs(rng.standard_normal(cells)) if with_nut else None
    return vel, nut


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("grid", sorted(PREDICTOR_GRIDS))
def test_predictor_general_edge_shapes_match_pallas(grid):
    kw, scheme, with_nut, lid_z = PREDICTOR_GRIDS[grid]
    rs, ts = _sims(**kw, convective_scheme=scheme)
    rg, tg = rs.geom, ts.geom
    if lid_z is not None:
        rg, tg = _with_z_lid(rg, lid_z), _with_z_lid(tg, lid_z)
    assert K.general_eligible(tg, ts.cfg)
    vel, nut = _fields(ts, 41, with_nut)
    dt, fx = 1e-2, 0.7
    want = PK.fused_predictor_general(
        *(jnp.asarray(c) for c in vel), dt, geom=rg,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    got = K.predictor_general(*(_t(c) for c in vel),
                              torch.tensor(dt, dtype=torch.float64),
                              K.general_arrays(tg), geom=tg, nu=ts.cfg.nu,
                              fx=fx, scheme=ts.cfg.convective_scheme,
                              nu_t=_t(nut))
    for name, g, w in zip(("u*", "v*", "w*"), got, want):
        _close(g, w, f"{grid} {name}")


def test_predictor_xpad_on_the_tile_matches_pallas():
    """The xpad wrapper (the predictor on nx + 2 padded planes) on a
    ragged no-slip-x grid with a periodic y, against
    fused_predictor_xpad."""
    kw = dict(Nx=10, Ny=7, Nz=36, bc_x="wall", x_max=1.5, **PERIODIC_Y,
              convective_scheme="skew")
    rs, ts = _sims(**kw)
    assert K.xpad_eligible(ts.geom, ts.cfg)
    vel, nut = _fields(ts, 42)
    dt, fx = 1e-3, 0.4
    want = PK.fused_predictor_xpad(
        *(jnp.asarray(c) for c in vel), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=jnp.asarray(nut), interpret=True)
    xg = K.xpad_geometry(ts.geom)
    got = K.predictor_xpad(*(_t(c) for c in vel),
                           torch.tensor(dt, dtype=torch.float64),
                           K.general_arrays(xg), geom=ts.geom, xgeom=xg,
                           nu=ts.cfg.nu, fx=fx,
                           scheme=ts.cfg.convective_scheme, nu_t=_t(nut))
    for name, g, w in zip(("u*", "v*", "w*"), got, want):
        _close(g, w, f"xpad {name}")


def _germano_math(vel, geom):
    """The body of the reference's _germano_pass1_kernel on whole arrays
    (x periodic: no slab halo), its plane sums unblocked: the reference's
    slab cannot tile an odd Nx into the germano kernel's two-plane halo
    blocks."""
    from cfdnn_tpu.turbulence import base as rbase
    from cfdnn_tpu.turbulence import les as rles
    comps = tuple(jnp.asarray(c) for c in vel)
    sr = rbase.strain_rotation(comps, geom)
    ucc = rbase.cell_center_velocity(comps, geom)
    delta = rbase.filter_width(geom)
    fac = 3.0 * delta * delta * sr.S_mag
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    filtered = rles._box_filter_batch(
        list(ucc) + [ucc[i] * ucc[j] for i, j in pairs], geom)
    lm = mm = jnp.zeros_like(sr.S_mag)
    for q, (i, j) in enumerate(pairs):
        wgt = 1.0 if i == j else 2.0
        lij = filtered[3 + q] - filtered[i] * filtered[j]
        mij = fac * sr.S[i][j]
        lm = lm + wgt * lij * mij
        mm = mm + wgt * mij * mij
    return (sr.S_mag, jnp.sum(lm, axis=(0, 2), keepdims=True),
            jnp.sum(mm, axis=(0, 2), keepdims=True))


@pytest.mark.parametrize("grid", sorted(GERMANO_GRIDS))
def test_germano_pass1_edge_shapes_match_pallas(grid):
    rs, ts = _sims(**GERMANO_GRIDS[grid], turb_model="dynamic_smagorinsky")
    assert K.germano_pass1_eligible(ts.geom)
    vel, _ = _fields(ts, 43, with_nut=False)
    if ts.cfg.Nx % 2:
        want = _germano_math(vel, rs.geom)
    else:
        want = PK.fused_germano_pass1(*(jnp.asarray(c) for c in vel),
                                      geom=rs.geom, interpret=True)
    got = K.germano_pass1(*(_t(c) for c in vel), K.les_arrays(ts.geom),
                          geom=ts.geom)
    assert got[1].shape == got[2].shape == (1, ts.cfg.Ny, 1)
    for name, g, w in zip(("|S|", "<L:M>", "<M:M>"), got, want):
        _close(g, w, f"{grid} {name}")


def test_wrappers_refuse_offsets_past_32_bits(monkeypatch):
    """Both tiles index with 32-bit offsets: a field past INT32_MAX
    elements raises ValueError naming the gate (the limit lowered here, so
    that a small grid reaches it), on the CPU as on the card; the limit
    counts the largest face array (w's nz + 1 columns on a duct)."""
    _, ts = _sims(Nx=8, Ny=5, Nz=6, **DUCT)
    vel, nut = _fields(ts, 44)
    u, v, w = (_t(c) for c in vel)
    g = ts.geom
    dt = torch.tensor(1e-3, dtype=torch.float64)
    pred = dict(geom=g, nu=ts.cfg.nu, fx=0.1,
                scheme=ts.cfg.convective_scheme, nu_t=_t(nut))
    gen, les = K.general_arrays(g), K.les_arrays(g)
    largest = 8 * 6 * 6    # v (8, 6, 6) and w (8, 5, 7): v's 288
    monkeypatch.setattr(K, "INT32_MAX", largest)
    K.predictor_general(u, v, w, dt, gen, **pred)
    K.germano_pass1(u, v, w, les, geom=g)
    monkeypatch.setattr(K, "INT32_MAX", largest - 1)
    with pytest.raises(ValueError,
                       match=r"predictor_general: .*32-bit.*2\^31 - 1"):
        K.predictor_general(u, v, w, dt, gen, **pred)
    with pytest.raises(ValueError, match=r"germano_pass1: .*32-bit.*2\^31"):
        K.germano_pass1(u, v, w, les, geom=g)


@pytest.fixture(scope="module")
def rule(tmp_path_factory):
    """cfdnn_tile_chunk of csrc/tile_plan.cu (plain C++), built by the
    host's C++ compiler: the rule both launchers take through
    cfdnn::walk_chunk."""
    lib = tmp_path_factory.mktemp("tile_plan") / "libtile_plan.so"
    subprocess.run([shutil.which("g++") or "c++", "-x", "c++", "-std=c++17",
                    "-shared", "-fPIC", "-o", str(lib),
                    str(K._CSRC / "tile_plan.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).cfdnn_tile_chunk
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


# (kernel, nx, rows walked, nz, the blocks an H100 holds at once, the
# chunk): in float32 the predictor is capped at three blocks an SM and
# germano_pass1 at four, in float64 both at two; the predictor walks nyf
# rows (les_tgv's 128^3, the duct's 128 x 97 x 96, the 640^3 cube of the
# xz comparison), germano ny (les_channel_dynamic's 128 x 64 x 128, and
# 256 x 64 x 256 in float64)
GENERAL_PLANS = [("predictor_general", 128, 128, 128, 3 * H100_SMS, 10),
                 ("predictor_general", 128, 97, 96, 3 * H100_SMS, 8),
                 ("predictor_general", 640, 640, 640, 3 * H100_SMS, 64),
                 ("germano_pass1", 128, 64, 128, 4 * H100_SMS, 8),
                 ("germano_pass1", 256, 64, 256, 2 * H100_SMS, 31)]


@pytest.mark.parametrize("plan", GENERAL_PLANS,
                         ids=[f"{p[0]}-{p[1]}x{p[2]}x{p[3]}@{p[4]}"
                              for p in GENERAL_PLANS])
def test_general_tile_launchers_chunk_plan(rule, plan):
    _, nx, rows, nz, resident, want = plan
    tiles = -(-nx // 8) * -(-nz // 32)
    chunk = rule(tiles, rows, resident)
    assert chunk == want
    blocks = tiles * -(-rows // chunk)
    assert blocks >= 2 * resident or chunk == 8


def _trajectory(base, keys, plan, steps=4):
    """`steps` steps of the reference (use_pallas="on": its Pallas kernels
    in interpret mode) and of the port (the wrappers' twins on the CPU)
    from the reference's initialize(perturbed_channel); each key to 1e-12
    of its scale."""
    rsim, tsim = _sims(**base, use_pallas="on")
    assert tsim.kernels == plan
    assert rsim._pallas_predictor_ok == "slab"
    r = rsim.initialize(R.perturbed_channel(rsim.cfg, rsim.mesh, amp=0.05))
    t = T.state_from_numpy(
        {k: np.asarray(getattr(r, k)) for k in
         ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
         if getattr(r, k) is not None}, "cpu", torch.float64)
    for _ in range(steps):
        r, _ = rsim.step(r)
        t, td = tsim.step(t)
    out = T.state_to_numpy(t)
    for key in keys:
        want = np.asarray(getattr(r, key))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        np.testing.assert_allclose(out[key], want, rtol=0,
                                   atol=RTOL * scale, err_msg=key)
    assert float(td.div_linf) < 1e-10
    return out


TRAJECTORIES = {
    # the general predictor with nu_sgs on a duct whose w wall face lies
    # at a z tile's edge (nz = 33)
    "duct-wale-12x20x33": (dict(Nx=12, Ny=20, Nz=33, **DUCT, nu=1e-3,
                                dp_dx=-1e-3, convective_scheme="central",
                                turb_model="wale"),
                           KernelPlan("general", "slab", "nu_sgs")),
    # germano_pass1 behind the channel predictor
    "channel-dynamic-12x20x40": (dict(Nx=12, Ny=20, Nz=40, nu=1e-3,
                                      dp_dx=-1e-3,
                                      turb_model="dynamic_smagorinsky"),
                                 KernelPlan("channel", "slab",
                                            "germano_pass1")),
    # both redesigned kernels: the dynamic model on a duct
    "duct-dynamic-12x10x20": (dict(Nx=12, Ny=10, Nz=20, **DUCT, nu=1e-3,
                                   dp_dx=-1e-3, convective_scheme="central",
                                   turb_model="dynamic_smagorinsky"),
                              KernelPlan("general", "slab",
                                         "germano_pass1")),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_ragged_les_trajectory_through_the_tiles_matches_reference(name):
    base, plan = TRAJECTORIES[name]
    out = _trajectory(base, ("u", "v", "w", "p", "nu_t"), plan)
    assert float(np.min(out["nu_t"])) >= 0


@pytest.mark.cuda
def test_general_tile_kernels_match_twins_on_cuda():
    """On a CUDA card: predictor_general and germano_pass1 against their
    twins on the tiles' edge shapes (chip_smoke._general_tile_cases,
    through chip_smoke._hold), float64 to 1e-14 and float32 to 1e-5 of
    each output's scale, with every input and output between NaN bands
    (nothing read or written past an array), and germano_pass1's plane
    sums equal bit for bit over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        cases = chip_smoke._general_tile_cases(dtype, dev, seed=5)
        assert len(cases) == len(chip_smoke._GENERAL_TILE_GRIDS) + len(
            chip_smoke._GERMANO_TILE_GRIDS)
        for case in cases:
            assert case.banded, case.label
            chip_smoke._hold(case, dtype, errs)
