"""The two predictor + divergence kernels redesigned onto a walked (x, z)
tile: predictor_periodic_div (csrc/predictor_periodic_div_tile.cuh) and
predictor_channel_div (csrc/predictor_channel_div_tile.cuh), each its
predictor's stars on xz_tile.cuh's window with a two-cell high x/z halo,
the divergence taken from the stored stars one plane behind
(csrc/div_tile.cuh).

On the CPU: both wrappers (their twins here) against the JAX reference at
float64 on the shapes where the new tile can break, the star to 1e-13 and
div to 1e-11 of each output's scale (the reference's own limits, there
absolute on fields of order one): predictor_periodic_div against
`fused_predictor_div` in interpret mode, or its body's math on whole
arrays at nx = 1, which the reference's slab cannot tile, at nx = 1, 2,
3, 8 and 9 (the high x halo wrapped more than once), nz = 6, 32, 33 and 35
(the far z column at and past a tile's edge), ny = 1, 2 and 3, and the
ragged 12 x 70 x 40 and 12 x 71 x 40 (the walk one plane behind across
chunks); predictor_channel_div against `fused_predictor_channel_div` in
interpret mode at nx = 8 and 9 with ny = 2 and 3 (every plane next to a
wall), the same z and ragged shapes, stretched and uniform y, skew and
central, scalar nu and nu_t; both wrappers' tile gate (32-bit offsets,
the channel's nx >= 8); the chunk of y planes the two launchers walk
(csrc/tile_plan.cu, built by the host's C++ compiler, floored at
csrc/div_tile.cuh's kDivChunkMin); and 4-step
CFDNN_FUSE_DIV=1 trajectories of a ragged Taylor-Green, channel and LES
channel against the reference, to 1e-12 of scale.

On a CUDA card (`cuda`): both kernels against their twins on chip_smoke's
edge shapes (`_div_tile_cases`, through `chip_smoke._hold`), float64 to
1e-14 and float32 to 1e-5 of each output's scale, div also against the
divergence kernel of the kernel's own star, every input and output
between NaN bands.
"""

import ctypes
import re
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

H100_SMS = 132
PHYS = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
PERIODIC_Y = dict(bc_y="periodic", y_min=0.0, y_max=1.0,
                  convective_scheme="skew")
# the periodic kernel's boxes (nx, ny, nz), chip_smoke's _DIV_TILE_BOXES
BOXES = [(1, 4, 6), (2, 3, 33), (3, 9, 32), (8, 1, 35), (9, 2, 6),
         (8, 3, 33), (12, 70, 40), (12, 71, 40)]
# the channel kernel's: (nx, ny, nz, stretched y, scheme, with nu_t)
CHANNELS = [(8, 2, 6, True, "skew", True), (9, 3, 32, False, "central", False),
            (8, 3, 33, True, "central", True), (9, 2, 35, True, "skew", False),
            (12, 70, 40, True, "central", True),
            (12, 71, 40, False, "skew", True),
            (12, 71, 40, False, "central", False),
            (12, 71, 40, True, "skew", False),
            (12, 71, 40, True, "central", True)]


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
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


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _check(got, want, what):
    """The star (u*, v*, w*) to 1e-13 and div to 1e-11 of each output's
    scale (a stretched y's 1/dy puts div in the thousands)."""
    for name, g, w, tol in zip(("u*", "v*", "w*", "div"), got, want,
                               (1e-13,) * 3 + (1e-11,)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=tol * float(np.max(np.abs(w))),
                                   err_msg=f"{what} {name}")


def _periodic_div_math(comps, dt, *, hx, hy, hz, nu, fx):
    """The body of the reference's _predictor_div_kernel on whole arrays (x
    periodic: the block its own left and right neighbour, the right one
    doubled so that its first two planes are planes 0 and 1 mod nx): its
    slab cannot tile nx = 1."""
    outs = [np.empty_like(comps[0]) for _ in range(4)]
    halos = []
    for c in comps:
        a = jnp.asarray(c)
        halos += [a, a, jnp.concatenate([a, a], axis=0)]
    PK._predictor_div_kernel(np.array([dt]), *halos, *outs, hx=hx, hy=hy,
                             hz=hz, nu=nu, fx=fx)
    return outs


@pytest.mark.parametrize("box", BOXES, ids=["x".join(map(str, b))
                                             for b in BOXES])
def test_predictor_periodic_div_edge_shapes_match_pallas(box):
    nx, ny, nz = box
    rs, ts = _sims(Nx=nx, Ny=ny, Nz=nz, **PERIODIC_Y, z_max=2.0)
    assert K.periodic_eligible(ts.geom)
    rng = np.random.default_rng(61)
    comps = [rng.standard_normal(box) for _ in range(3)]
    dt, fx = 1e-2, 0.7
    g = rs.geom
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=rs.cfg.nu, fx=fx)
    if nx == 1:
        want = _periodic_div_math(comps, dt, **kw)
    else:
        want = PK.fused_predictor_div(*(jnp.asarray(c) for c in comps), dt,
                                      interpret=True, **kw)
    got = K.predictor_periodic_div(*(_t(c) for c in comps),
                                   torch.tensor(dt, dtype=torch.float64),
                                   geom=ts.geom, nu=rs.cfg.nu, fx=fx)
    _check(got, want, str(box))


@pytest.mark.parametrize("grid", CHANNELS,
                         ids=[f"{g[0]}x{g[1]}x{g[2]}-"
                              f"{'stretched' if g[3] else 'uniform'}-{g[4]}"
                              + ("-nu_t" if g[5] else "") for g in CHANNELS])
def test_predictor_channel_div_edge_shapes_match_pallas(grid):
    nx, ny, nz, stretch, scheme, with_nut = grid
    rs, ts = _sims(Nx=nx, Ny=ny, Nz=nz, stretch_y=stretch,
                   convective_scheme=scheme)
    rng = np.random.default_rng(62)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(ts.cfg)]
    nut = (np.abs(rng.standard_normal((nx, ny, nz))) * 1e-2 if with_nut
           else None)
    dt, fx = 1e-2, 0.4
    want = PK.fused_predictor_channel_div(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom, nu=rs.cfg.nu,
        fx=fx, scheme=rs.cfg.convective_scheme,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    got = K.predictor_channel_div(
        *(_t(c) for c in comps), torch.tensor(dt, dtype=torch.float64),
        K.channel_y_arrays(ts.geom), geom=ts.geom, nu=ts.cfg.nu, fx=fx,
        scheme=ts.cfg.convective_scheme, nu_t=_t(nut))
    _check(got, want, str(grid))
    assert float(got[1][:, 0].abs().max()) == float(
        got[1][:, -1].abs().max()) == 0.0


def test_div_wrappers_refuse_what_their_tiles_refuse(monkeypatch):
    """Both tiles index with 32-bit offsets: a field past INT32_MAX
    elements raises ValueError naming the gate (the limit lowered here, so
    that a small grid reaches it), on the CPU as on the card; the
    periodic kernel takes every nx, the channel one nx >= 8 (its
    predictor's tile). The channel's largest field is v, nx (ny + 1) nz
    elements."""
    _, tp = _sims(Nx=3, Ny=4, Nz=6, **PERIODIC_Y)
    _, tc = _sims(Nx=8, Ny=4, Nz=6, stretch_y=True)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    up = [torch.zeros(s, dtype=torch.float64)
          for s in T.velocity_shapes(tp.cfg)]
    uc = [torch.zeros(s, dtype=torch.float64)
          for s in T.velocity_shapes(tc.cfg)]
    ys = K.channel_y_arrays(tc.geom)
    kc = dict(geom=tc.geom, nu=1e-3, fx=0.0, scheme=T.ConvectiveScheme.SKEW)

    def periodic():
        return K.predictor_periodic_div(*up, dt, geom=tp.geom, nu=1e-3,
                                        fx=0.0)

    def channel():
        return K.predictor_channel_div(*uc, dt, ys, **kc)

    monkeypatch.setattr(K, "INT32_MAX", 8 * 5 * 6)
    periodic()
    channel()
    monkeypatch.setattr(K, "INT32_MAX", 3 * 4 * 6 - 1)
    with pytest.raises(ValueError,
                       match=r"predictor_periodic_div: .*32-bit.*2\^31 - 1"):
        periodic()
    monkeypatch.setattr(K, "INT32_MAX", 8 * 5 * 6 - 1)
    with pytest.raises(ValueError,
                       match=r"predictor_channel_div: .*32-bit.*2\^31 - 1"):
        channel()
    monkeypatch.undo()
    _, t7 = _sims(Nx=7, Ny=4, Nz=6, stretch_y=True)
    u7 = [torch.zeros(s, dtype=torch.float64)
          for s in T.velocity_shapes(t7.cfg)]
    with pytest.raises(ValueError,
                       match=r"predictor_channel_div: .*nx >= 8.*nx = 7"):
        K.predictor_channel_div(*u7, dt, K.channel_y_arrays(t7.geom),
                                **dict(kc, geom=t7.geom))


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


# (kernel, nx, ny, nz, the blocks an H100 holds at once, tile_plan.cuh's
# chunk, the chunk walked): both kernels chunk the ny cell planes (tgv's
# and channel's 128^3, les_channel's 128 x 64 x 128, tgv512, channel512),
# the channel one walking the wall face ny after its last chunk, and walk
# at least csrc/div_tile.cuh's kDivChunkMin planes; in float32 the
# periodic kernel (47 registers, no cap) holds five blocks an SM and the
# channel one (capped) four, in float64 the channel one two, where its
# 58112 bytes of dynamic shared memory a block (with nu_t) would hold it
# too
DIV_PLANS = [("predictor_periodic_div", 128, 128, 128, 5 * H100_SMS, 8, 16),
             ("predictor_periodic_div", 512, 512, 512, 5 * H100_SMS, 64, 64),
             ("predictor_channel_div", 128, 128, 128, 4 * H100_SMS, 8, 16),
             ("predictor_channel_div", 128, 64, 128, 4 * H100_SMS, 8, 16),
             ("predictor_channel_div", 512, 512, 512, 4 * H100_SMS, 64, 64),
             ("predictor_channel_div", 128, 128, 128, 2 * H100_SMS, 15, 16)]


def _div_chunk_min():
    text = (K._CSRC / "div_tile.cuh").read_text()
    return int(re.search(r"constexpr int kDivChunkMin = (\d+);",
                         text).group(1))


@pytest.mark.parametrize("plan", DIV_PLANS,
                         ids=[f"{p[0]}-{p[1]}x{p[2]}x{p[3]}@{p[4]}"
                              for p in DIV_PLANS])
def test_div_tile_launchers_chunk_plan(rule, plan):
    _, nx, rows, nz, resident, planned, walked = plan
    tiles = -(-nx // 8) * -(-nz // 32)
    chunk = rule(tiles, rows, resident)
    assert chunk == planned
    assert tiles * -(-rows // chunk) >= 2 * resident or chunk == 8
    assert max(chunk, _div_chunk_min()) == walked


# the fused paths on ragged grids (x and z not multiples of the 8 x 32
# tile, y over several chunks): (grid, start, plan)
TRAJECTORIES = {
    "tgv-12x20x40": (dict(Nx=12, Ny=20, Nz=40, bc_x="periodic",
                          bc_y="periodic", bc_z="periodic", y_min=0.0,
                          y_max=2 * np.pi, z_max=2 * np.pi,
                          convective_scheme="skew", nu=1e-3, dp_dx=0.0),
                     "tgv", KernelPlan("periodic", "slab")),
    "channel-12x20x40": (dict(Nx=12, Ny=20, Nz=40, stretch_y=True,
                              nu=1e-3, dp_dx=-1e-3),
                         "channel", KernelPlan("channel", "slab")),
    "les_channel-12x20x40": (dict(Nx=12, Ny=20, Nz=40, stretch_y=True,
                                  nu=1e-3, dp_dx=-1e-3,
                                  turb_model="smagorinsky"),
                             "channel",
                             KernelPlan("channel", "slab", "nu_sgs")),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_ragged_fused_trajectory_matches_reference(name, monkeypatch):
    """CFDNN_FUSE_DIV=1: 4 Euler steps of the port under use_pallas="on"
    (its div wrapper's twin on the CPU, once a step, and no divergence)
    against the reference's operator chain, u, v, w, p (and nu_t) to
    1e-12 of each one's scale."""
    grid, start, plan = TRAJECTORIES[name]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="off"))
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    ts = T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")
    assert ts.kernels == plan
    assert ts._fuse_div == plan.predictor
    div_name = f"predictor_{plan.predictor}_div"
    calls = dict.fromkeys((div_name, "divergence"), 0)
    for key in calls:
        fn = getattr(K, key)

        def spy(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, key, spy)
    if start == "tgv":
        r = R.init_taylor_green(rs.cfg, rs.mesh)
    else:
        r = rs.initialize(R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05))
    keys = ("u", "v", "w", "p") + (("nu_t",) if r.nu_t is not None else ())
    t = T.state_from_numpy(
        {k: np.asarray(getattr(r, k)) for k in
         ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
         if getattr(r, k) is not None}, "cpu", torch.float64)
    for _ in range(4):
        r, _ = rs.step(r)
        t, td = ts.step(t)
    assert calls == {div_name: 4, "divergence": 0}
    out = T.state_to_numpy(t)
    for key in keys:
        want = np.asarray(getattr(r, key))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        np.testing.assert_allclose(out[key], want, rtol=0,
                                   atol=1e-12 * scale, err_msg=key)
    assert float(td.div_linf) < 1e-10


@pytest.mark.cuda
def test_div_tile_kernels_match_twins_on_cuda():
    """On a CUDA card: both div kernels against their twins on the tiles'
    edge shapes (chip_smoke._div_tile_cases, through chip_smoke._hold),
    float64 to 1e-14 and float32 to 1e-5 of each output's scale, div also
    against the divergence kernel of the kernel's own star, with every
    input and output between NaN bands (nothing read or written past an
    array)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        cases = chip_smoke._div_tile_cases(dtype, dev, seed=5)
        assert len(cases) == len(chip_smoke._DIV_TILE_BOXES) + 4 * len(
            chip_smoke._DIV_TILE_CHANNELS)
        for case in cases:
            assert case.banded and case.geom is not None, case.label
            chip_smoke._hold(case, dtype, errs)
