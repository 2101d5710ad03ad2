"""predictor_general_xz_o4_kernel's design (csrc/predictor_general_xz_o4.cuh
on the terms of csrc/xz_o4_tile.cuh and the window of
csrc/xz_o4_plan.cuh) on the grids where the tile can break.

On the CPU:
- the window's plan (xz_o4_plan.cu, plain C++ built with the host's
  compiler): its slots, its shared-memory bytes within the H100's 227 KB
  a block, and the blocks an SM that bytes leave at or above the blocks
  the kernel is built for, in float32 and float64, with and without nu_t,
  on both axis patterns (y O4, y O2);
- predictor_general_xz at O4 (its twin on the CPU) against the reference's
  fused_predictor_general_xz at space_order=4 (ng = 2) in interpret mode,
  every star to 1e-13, on the edge grids: ny 4 and 5 with a walled and a
  periodic y (O4 on a periodic y from 4 cells), a periodic y of 3 (O2),
  nz 32 and 64, nx 8 (a single x tile), and a walled y whose first chunk
  of 64 planes ends one plane before the wall face (ny = 64).
On the card (`cuda`), the kernel against its twin on the same grids and
on one of 65 planes (the wall's last EDGE plane in the second chunk), in
float64 to 1e-13 of each output's scale and in float32 to 1e-5, every
input and every tensor the wrapper allocates between NaN bands
(chip_smoke._banded_call), each scheme the kernel takes: skew (without
nu_t), central, upwind and upwind2, with and without nu_t.
"""

import ctypes
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
from test_torch_xz import _cfg, _close, _rand, _t

H100_SMEM_BLOCK = 232448        # 227 KB: the most a block can take
H100_SMEM_SM = 233472           # 228 KB an SM, 1 KB of it kept a block
PLANE = 12 * 40                 # the staged points of a plane

BASE = dict(nu=0.01, nu_specified=True, dt=1e-3, adaptive_dt=False,
            dtype="float64", space_order=4)
PERIODIC_Y = dict(bc_y="periodic", y_min=0.0, y_max=1.0)
# the edge grids of the kernel: (Config fields)
EDGE_GRIDS = {
    "wall-y4 nx8 nz32": dict(Nx=8, Ny=4, Nz=32, stretch_y=True),
    "wall-y5 nx8 nz64": dict(Nx=8, Ny=5, Nz=64, stretch_y=True),
    "periodic-y4 nx8 nz32": dict(Nx=8, Ny=4, Nz=32, **PERIODIC_Y),
    "periodic-y5 nx8 nz64": dict(Nx=8, Ny=5, Nz=64, **PERIODIC_Y),
    "periodic-y3 (O2 y)": dict(Nx=8, Ny=3, Nz=32, **PERIODIC_Y),
    "wall-y64 (a chunk ends before the wall face)": dict(
        Nx=8, Ny=64, Nz=32, stretch_y=True),
}
# on the card also a walled y whose last EDGE plane (64) opens the second
# chunk of the walk
CUDA_GRIDS = dict(EDGE_GRIDS, **{
    "wall-y65 (the last EDGE plane in the second chunk)": dict(
        Nx=8, Ny=65, Nz=32, stretch_y=True)})


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """The exports of csrc/xz_o4_plan.cu, built by the host's C++
    compiler."""
    lib = tmp_path_factory.mktemp("xz_o4_plan") / "libxz_o4_plan.so"
    subprocess.run([shutil.which("g++") or "c++", "-x", "c++", "-std=c++17",
                    "-shared", "-fPIC", "-o", str(lib),
                    str(K._CSRC / "xz_o4_plan.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    so.cfdnn_xz_o4_shared_bytes.argtypes = [ctypes.c_int] * 3
    so.cfdnn_xz_o4_shared_bytes.restype = ctypes.c_longlong
    so.cfdnn_xz_o4_slots.argtypes = [ctypes.c_int] * 2
    so.cfdnn_xz_o4_slots.restype = ctypes.c_int
    so.cfdnn_xz_o4_plane.restype = ctypes.c_int
    so.cfdnn_xz_o4_min_blocks.argtypes = [ctypes.c_int] * 2
    so.cfdnn_xz_o4_min_blocks.restype = ctypes.c_int
    return so


# (element bytes, nu_t, y O4): the planes staged (2 R + 1 with R = 2 on an
# O4 y, 1 on an O2 y) and in flight (two in float32, one in float64), and
# the blocks an SM the kernel is built for (three in float32 without nu_t,
# else two)
PLANS = [(b, nut, y4) for b in (4, 8) for nut in (False, True)
         for y4 in (True, False)]


@pytest.mark.parametrize("case", PLANS, ids=[
    f"{'f32' if b == 4 else 'f64'}-{'nut' if n else 'nu'}-"
    f"{'y4' if y else 'y2'}" for b, n, y in PLANS])
def test_xz_o4_window_fits_the_occupancy_it_is_built_for(plan, case):
    size, nut, y4 = case
    slots = (5 if y4 else 3) + (2 if size == 4 else 1)
    assert plan.cfdnn_xz_o4_plane() == PLANE
    assert plan.cfdnn_xz_o4_slots(size, int(y4)) == slots
    smem = plan.cfdnn_xz_o4_shared_bytes(size, int(nut), int(y4))
    assert smem == slots * (4 if nut else 3) * PLANE * size
    assert smem <= H100_SMEM_BLOCK
    blocks = plan.cfdnn_xz_o4_min_blocks(size, int(nut))
    assert blocks == (3 if size == 4 and not nut else 2)
    # the shared memory leaves room for the blocks the registers allow
    assert H100_SMEM_SM // (smem + 1024) >= blocks


def test_xz_o4_window_main_paths_bytes(plan):
    """The ring of the main paths' float32 instantiations: the box (y O4,
    seven slots of u, v, w) 40320 bytes, the channel (y O2, five slots)
    28800; the box with nu_t 53760 and float64 with nu_t on the box (six
    slots) 92160, past 48 KB: the launcher raises the kernel's dynamic
    limit for them."""
    assert plan.cfdnn_xz_o4_shared_bytes(4, 0, 1) == 40320
    assert plan.cfdnn_xz_o4_shared_bytes(4, 0, 0) == 28800
    assert plan.cfdnn_xz_o4_shared_bytes(4, 1, 1) == 53760
    assert plan.cfdnn_xz_o4_shared_bytes(8, 1, 1) == 92160


def _sims(grid, scheme):
    kw = dict(BASE, **grid, convective_scheme=scheme)
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


@pytest.mark.parametrize("run", ["skew", "central", "central+nu_t"])
@pytest.mark.parametrize("grid", sorted(EDGE_GRIDS))
def test_predictor_general_xz_o4_edge_grids_match_pallas(grid, run):
    scheme = run.split("+")[0]
    rs, ts = _sims(EDGE_GRIDS[grid], scheme)
    g = ts.geom
    assert K.xz_eligible(g) and g.use_o4(0) and g.use_o4(2)
    assert g.use_o4(1) == ("periodic" in grid and ts.cfg.Ny >= 4)
    comps, cell = _rand(ts, 24, 0.1)
    nut = 0.01 * np.abs(cell) if run.endswith("nu_t") else None
    want = PK.fused_predictor_general_xz(
        *(jnp.asarray(c) for c in comps), 1e-3, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=0.5,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    assert want is not None
    u, v, w = (_t(c) for c in comps)
    got = K.predictor_general_xz(
        u, v, w, torch.tensor(1e-3, dtype=torch.float64),
        K.general_arrays(g), geom=g, nu=ts.cfg.nu, fx=0.5,
        scheme=ts.cfg.convective_scheme, nu_t=_t(nut))
    _close(got, want, 1e-13, f"{grid} {run}")


@pytest.mark.cuda
def test_predictor_general_xz_o4_kernel_on_edge_grids_on_cuda():
    """On a CUDA card: the O4 xz kernel against its twin on CUDA_GRIDS,
    each scheme it takes, with and without nu_t (skew without), float64 to
    1e-13 and float32 to 1e-5 of each output's scale, between NaN bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import functools
    import chip_smoke as CS
    dev = torch.device("cuda", 0)
    held = 0
    for dtype in (torch.float64, torch.float32):
        dts = str(dtype)[6:]
        for name, grid in CUDA_GRIDS.items():
            for scheme in ("skew", "central", "upwind", "upwind2"):
                cfg = _cfg(T, **dict(BASE, **grid, dtype=dts),
                           convective_scheme=scheme).finalize()
                sim = T.Simulation(cfg.with_(use_pallas="off"), device=dev)
                g = sim.geom
                assert K.xz_eligible(g), name
                comps, cell = _rand(sim, 25)

                def put(a):
                    return CS._band(torch.from_numpy(np.array(a)).to(
                        dev, dtype))

                u, v, w = (put(c) for c in comps)
                dt = put(np.float64(1e-3))
                gs = tuple(map(CS._band, K.general_arrays(g)))
                kw = dict(geom=g, nu=cfg.nu, fx=0.5,
                          scheme=cfg.convective_scheme)
                for nut in ((None,) if scheme == "skew"
                            else (None, put(0.01 * np.abs(cell)))):
                    case = CS.Case(
                        f"{name} {scheme}", "predictor_general_xz",
                        functools.partial(K.predictor_general_xz, u, v, w,
                                          dt, gs, nu_t=nut, **kw),
                        functools.partial(K.predictor_general_twin, u, v, w,
                                          dt, nut, **kw),
                        (u, v, w), banded=True)
                    before = K.predictor_general_xz.launches
                    got = CS._banded_call(case)
                    assert K.predictor_general_xz.launches == before + 1
                    ref = case.twin()
                    for out, err, lim, _ in CS.compare(
                            case.name, got, ref, dtype, CS.XZ_F64_TOL):
                        assert err <= lim, (f"{case.label} nu_t "
                                            f"{nut is not None} {out} "
                                            f"{dtype}: {err} > {lim}")
                    held += 1
    assert held == 2 * len(CUDA_GRIDS) * 7


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::predictor_general_xz_o4_kernel<float, "
    "false, 1, true>(x)",
    "_ZN59_GLOBAL__N__0c1d2e3f_26_predictor_general_xz_o4_cu_a1b2c3d430"
    "predictor_general_xz_o4_kernelIfLb1ELi0ELb0EEEvN5cfdnn7general4GridIT_E",
    "void (anonymous namespace)::predictor_general_xz_wide_kernel<double, "
    "true, 3>(x)",
])
def test_device_launches_names_the_o4_xz_kernels(symbol):
    """A CUDA graph's node or a profiler record of the O4 xz kernel (its
    axis pattern a template argument) or of its upwind kernel counts for
    predictor_general_xz."""
    assert K.device_launches([(symbol, 3)]) == {"predictor_general_xz": 3}
