"""The port's hand-written Hopper kernels, their plain twins and launch counts
(counterpart of `cfdnn_tpu/ops/pallas_kernels.py`).

Sixteen CUDA C++ kernels, in `cfdnn_tpu_torch/csrc/`, carry the main-path
steps of the benchmark grids:

  predictor_periodic  <- pallas_kernels.fused_predictor (all-periodic TGV)
  predictor_periodic_div
                      <- pallas_kernels.fused_predictor_div (the same, plus
                         the divergence of its star in the same pass)
  predictor_channel   <- pallas_kernels.fused_predictor_channel (wall-y,
                         scalar nu or the cell nu_t of an LES closure)
  predictor_channel_div
                      <- pallas_kernels.fused_predictor_channel_div (the
                         same with v's wall faces zeroed, plus the
                         divergence of its star)
  predictor_general   <- pallas_kernels.fused_predictor_general (periodic
                         x, periodic or wall y and z, moving walls, scalar
                         nu or nu_t, skew, central, upwind or upwind2:
                         SCHEME_CODES); `predictor_xpad` wraps it for a
                         no-slip, inflow/outflow or outflow x, as
                         fused_predictor_xpad wraps the reference's
  divergence          <- pallas_kernels.fused_divergence
  correct             <- pallas_kernels.fused_correct
  nu_sgs              <- pallas_kernels.fused_nu_sgs (Smagorinsky, WALE,
                         Vreman)
  germano_pass1       <- pallas_kernels.fused_germano_pass1 (dynamic
                         Smagorinsky)
  transport           <- pallas_kernels.fused_transport_advance (the
                         k-omega advance of SST, with or without its nu_t,
                         and of Wilcox)
  fht_pass            <- poisson/pallas_fht.fht_pallas (one forward or
                         inverse four-step Hartley pass along one axis)
  fht_modal           <- poisson/pallas_fht.fht_pallas_modal (forward,
                         the Poisson symbol's inverse, inverse, along the
                         last Hartley axis in one pass)
  predictor_general_xz, nu_sgs_xz, divergence_xz, correct_xz
                      <- pallas_kernels.fused_predictor_general_xz,
                         fused_nu_sgs_xz, fused_divergence_xz,
                         fused_correct_xz: the functions of
                         predictor_general, nu_sgs, divergence and correct
                         on an (x, z) tile staged in shared memory and
                         walked along y (csrc/xz_tile.cuh), the kernels of
                         the reference's "xz" plan, at O2 and O4 (the
                         predictor's O4 variant in
                         csrc/predictor_general_xz_o4.cuh)

Each source file's head says what bounds the kernel on the H100 and what
its design does about it. Each kernel computes what its TPU kernel
computes, not the TPU kernel's x-slab structure, in float and double
instantiations: most run one thread per output point, z fastest within a
warp, periodic wrap by index arithmetic. Kernels of one function share
their grid and term code through a reader type (csrc/les.cuh,
projection.cuh; the general predictor's grid in csrc/predictor_terms.cuh,
its terms over offsets in each of its two kernels): a reader of device
memory or of a shared-memory tile. Ten slab
kernels walk an (x, z) tile along y themselves: predictor_channel,
predictor_periodic, predictor_general and nu_sgs
(csrc/predictor_channel_tile.cuh, csrc/predictor_periodic_tile.cuh,
csrc/predictor_general_tile.cuh, csrc/nu_sgs_tile.cuh, on the xz
kernels' staged window, each with its own term code over offsets),
predictor_channel_div and predictor_periodic_div (the two predictors'
term code on that window with a two-cell high halo, the divergence
taken from the stored stars: csrc/predictor_channel_div_tile.cuh,
csrc/predictor_periodic_div_tile.cuh, csrc/div_tile.cuh),
germano_pass1 (csrc/germano_tile.cuh: nu_sgs's window, the test filter
summed separably), correct and divergence (csrc/correct.cu,
csrc/divergence.cu, one thread a cell, each face read once) and transport
(csrc/transport_tile.cuh, SST's per-point coefficients formed once a point
into a ring of planes); their launchers pick the chunk of planes a block
walks (csrc/tile_plan.cuh), and a grid their tile refuses raises
ValueError (`tile_refusal`).

Beside each kernel stand:
  - its plain PyTorch twin (`*_twin`), the eager form of the same math.
    For the periodic and channel predictors that is the reference's slab
    math on whole arrays (torch.roll in place of the x halo); for the
    general predictor, divergence and correct it is the operator library
    itself (`ops.operators`), and for the LES
    kernels the turbulence algebra (`turbulence/base.py`, `les.py`,
    `transport.py`): the single sources of truth the TPU kernels also ran;
  - a launch count, the integer attribute `launches` of the public
    wrapper, raised by one where the CUDA kernel is launched and nowhere
    else; a replay of a captured CUDA graph, which launches the kernels
    without calling their wrappers, adds what its capture recorded
    (`add_launches`).

The public wrappers check device, dtype, shape and contiguity, then take
the twin for CPU tensors (the CPU tests run that path, as the reference's
tests run the Pallas kernels in interpret mode) and launch the kernel for
CUDA tensors, raising on any other device and on any CUDA error. There is
no fallback from a kernel to its twin. Each call goes through a
`torch.autograd.Function` whose backward differentiates the twin, as the
reference's `vjp_via` (solver.py) differentiates the jnp path; the two
Hartley kernels' backward raises instead, as the reference has no
gradient through its Pallas transform.

Build: at first use, `nvcc` compiles every `csrc/*.cu` for sm_90a, one
process per source, all started together, and links them into one shared
library with a plain C interface, loaded with ctypes. The library goes to
`build/cfdnn_tpu_torch/<hash of the sources and flags>/` beside the
package (listed in `.gitignore`), so a fresh checkout builds it itself.
Nothing is compiled or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..config import BCType, ConvectiveScheme
from ..mesh import Axis1D
from ..turbulence import base as turb_base
from . import operators as ops
from .grid import AxisGeom, Geometry

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cfdnn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libcfdnn_kernels.so"


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library() -> Tuple[Path, float]:
    """Build (or find) the kernels' shared library.

    Returns its path and the seconds spent compiling (0 when a library of
    the same sources and flags was already there). `-Xptxas=-v` reports
    each kernel's registers and spills into `build.log` beside it.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cuh")) + sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, failed = [], []
        for src, _, proc in procs:
            out = proc.communicate()[0].decode(errors="replace")
            # (the sources compile together: a file's seconds are those
            # until it and the files waited on before it were done)
            log.append(f"== {src.name} (done {time.perf_counter() - t0:.1f} "
                       f"s)\n{out}")
            if proc.returncode:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    "predictor_periodic": [_P] * 7 + [_I] * 3 + [_D] * 5 + [_P],
    "predictor_periodic_div": [_P] * 8 + [_I] * 3 + [_D] * 5 + [_P],
    "predictor_channel": [_P] * 13 + [_I] * 3 + [_D] * 4 + [_I, _P],
    "predictor_channel_div": [_P] * 14 + [_I] * 3 + [_D] * 4 + [_I, _P],
    "predictor_general": [_P] * 10 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # the O4 variants' entries: predictor_general's and its O4 constants
    "predictor_general_o4": [_P] * 10 + [_I] * 5 + [_D] * 2 + [_I, _P, _P],
    "predictor_general_xz_o4": [_P] * 10 + [_I] * 5 + [_D] * 2
                               + [_I, _P, _P],
    "divergence": [_P] * 7 + [_I] * 6 + [_P],
    "correct": [_P] * 11 + [_I] * 6 + [_P],
    "nu_sgs": [_P] * 11 + [_I] * 6 + [_D, _P],
    "germano_pass1": [_P] * 14 + [_I] * 6 + [_P],
    "transport": [_P] * 15 + [_I] * 6 + [_P],
    "fht_pass": [_P] * 3 + [_I] * 2 + [_L] * 2 + [_I, _P],
    "fht_modal": [_P] * 5 + [_I] * 2 + [_L] * 2 + [_D] * 2 + [_P],
}
# the xz kernels take their slab kernels' C interfaces
for _name in ("predictor_general", "nu_sgs", "divergence", "correct"):
    _SIGNATURES[_name + "_xz"] = _SIGNATURES[_name]
_lib: Optional[ctypes.CDLL] = None


def _bind(path) -> ctypes.CDLL:
    """Load the library at `path` and declare every entry point's C
    signature (pointers and the stream as c_void_p)."""
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"cfdnn_{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.cfdnn_error_string.argtypes = [ctypes.c_int]
    lib.cfdnn_error_string.restype = ctypes.c_char_p
    lib.cfdnn_germano_pass1_blocks.argtypes = [_I, _I]
    lib.cfdnn_germano_pass1_blocks.restype = ctypes.c_int
    lib.cfdnn_fht_tile.argtypes = [_I, _I, _I]
    lib.cfdnn_fht_tile.restype = ctypes.c_int
    lib.cfdnn_tile_chunk.argtypes = [_L, _I, _I]
    lib.cfdnn_tile_chunk.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        _lib = _bind(build_library()[0])
    return _lib


def _launch(name: str, like: torch.Tensor, *args) -> None:
    lib = library()
    suffix = "f32" if like.dtype == torch.float32 else "f64"
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = getattr(lib, f"cfdnn_{name}_{suffix}")(*args, stream)
    if err:
        msg = lib.cfdnn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Checks and the autograd bridge
# ---------------------------------------------------------------------------


def _check(name: str, tensors, shapes) -> None:
    """Same device, float32/float64 of one dtype, contiguous, and each
    tensor of its expected shape (None: any shape)."""
    for t in tensors:
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected tensors (dt as a 0-d tensor), "
                            f"got {type(t).__name__}")
    t0 = tensors[0]
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t0.dtype}; float32 or float64 only")
    for t, shape in zip(tensors, shapes):
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {t0.device}; the kernels run on "
                         "CUDA and their twins on the CPU")


class _ViaTwin(torch.autograd.Function):
    """Forward: `launch` (the kernel on CUDA, the twin on the CPU).
    Backward: autograd through the plain twin, which computes the same
    function."""

    @staticmethod
    def forward(ctx, launch, twin, kw, *tensors):
        ctx.twin, ctx.kw = twin, kw
        ctx.save_for_backward(*tensors)
        return launch(*tensors, **kw)

    @staticmethod
    def backward(ctx, *grads):
        xs = [t.detach().requires_grad_(t.requires_grad)
              for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.twin(*xs, **ctx.kw)
        outs = out if isinstance(out, tuple) else (out,)
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads,
                                       allow_unused=True))
        return (None, None, None) + tuple(
            next(got) if x.requires_grad else None for x in xs)


# ---------------------------------------------------------------------------
# The grids refused by the slab kernels that walk an (x, z) tile along y:
# predictor_channel, predictor_periodic, their div kernels,
# predictor_general, nu_sgs and germano_pass1 (on csrc/xz_tile.cuh's
# window), correct, divergence and transport (csrc/correct.cu,
# csrc/divergence.cu, csrc/transport_tile.cuh)
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1    # the tiles' offsets are 32-bit


def tile_refusal(name: str, nx: int, largest: int,
                 min_nx: int = 1) -> Optional[str]:
    """Why the walked tile of kernel `name` refuses a grid (None where it
    takes it): nx x-points below `min_nx` (the channel predictor stages
    its x halo with one periodic wrap: xz::fits; the periodic predictor
    stages a full wrap and takes every nx) or a field of `largest`
    elements past the tile's 32-bit offsets."""
    if nx < min_nx:
        return (f"{name}: the (x, z) tile needs nx >= {min_nx} (its x halo "
                f"is staged with one periodic wrap: xz::fits), got nx = "
                f"{nx}")
    if largest > INT32_MAX:
        return (f"{name}: the tile's offsets are 32-bit, and a field of "
                f"{largest} elements is past 2^31 - 1")
    return None


def _modes(geom: Geometry):
    """The divergence and correct kernels' mode of each axis: 0 one cell
    (skipped), 1 periodic (N faces), 2 bounded (N+1), 3 periodic at O4
    (Geometry.use_o4)."""
    return tuple(0 if ax.n == 1 else 3 if geom.use_o4(a)
                 else 1 if ax.periodic else 2
                 for a, ax in enumerate(geom.axes))


def _nfaces(ax) -> int:
    return ax.n if ax.periodic else ax.n + 1


# ---------------------------------------------------------------------------
# predictor_periodic  <-  pallas_kernels.fused_predictor
# ---------------------------------------------------------------------------


def _X(f, n):
    return torch.roll(f, -n, dims=0)


def _Ry(f, n):
    return torch.roll(f, -n, dims=1)


def _Rz(f, n):
    return torch.roll(f, -n, dims=2)


def predictor_periodic_twin(u, v, w, dt, *, hx, hy, hz, nu, fx):
    """Plain twin of `predictor_periodic`: the reference's
    predictor_slab_math on whole arrays, x wrapped like y and z.

    Math = the operators' periodic-uniform path: skew form
    0.5*(adv_hi*phi_{+1} - adv_lo*phi_{-1})/h per axis + nu * second
    differences + the body force fx on u, then the Euler star update.
    """
    ihx, ihy, ihz = 1.0 / hx, 1.0 / hy, 1.0 / hz

    # ---- u component (x-face staggered) -------------------------------
    hi_n = _X(u, 1)
    lo_n = _X(u, -1)
    conv_u = 0.5 * ((0.5 * (u + hi_n)) * hi_n
                    - (0.5 * (lo_n + u)) * lo_n) * ihx
    Ue = 0.5 * (_X(v, -1) + v)                 # v at (xf_i, yf_j)
    conv_u = conv_u + 0.5 * (_Ry(Ue, 1) * _Ry(u, 1) - Ue * _Ry(u, -1)) * ihy
    We = 0.5 * (_X(w, -1) + w)                 # w at (xf_i, zf_k)
    conv_u = conv_u + 0.5 * (_Rz(We, 1) * _Rz(u, 1) - We * _Rz(u, -1)) * ihz
    lap_u = ((_X(u, 1) - 2.0 * u + _X(u, -1)) * ihx * ihx
             + (_Ry(u, 1) - 2.0 * u + _Ry(u, -1)) * ihy * ihy
             + (_Rz(u, 1) - 2.0 * u + _Rz(u, -1)) * ihz * ihz)
    star_u = u + dt * (-conv_u + nu * lap_u + fx)

    # ---- v component (y-face staggered) -------------------------------
    hi_n = _Ry(v, 1)
    lo_n = _Ry(v, -1)
    conv_v = 0.5 * ((0.5 * (v + hi_n)) * hi_n
                    - (0.5 * (lo_n + v)) * lo_n) * ihy
    Ue = 0.5 * (_Ry(u, -1) + u)                # u at (xf_i, yf_j)
    conv_v = conv_v + 0.5 * (_X(Ue, 1) * _X(v, 1) - Ue * _X(v, -1)) * ihx
    We = 0.5 * (_Ry(w, -1) + w)                # w at (yf_j, zf_k)
    conv_v = conv_v + 0.5 * (_Rz(We, 1) * _Rz(v, 1) - We * _Rz(v, -1)) * ihz
    lap_v = ((_X(v, 1) - 2.0 * v + _X(v, -1)) * ihx * ihx
             + (_Ry(v, 1) - 2.0 * v + _Ry(v, -1)) * ihy * ihy
             + (_Rz(v, 1) - 2.0 * v + _Rz(v, -1)) * ihz * ihz)
    star_v = v + dt * (-conv_v + nu * lap_v)

    # ---- w component (z-face staggered) -------------------------------
    hi_n = _Rz(w, 1)
    lo_n = _Rz(w, -1)
    conv_w = 0.5 * ((0.5 * (w + hi_n)) * hi_n
                    - (0.5 * (lo_n + w)) * lo_n) * ihz
    Ue = 0.5 * (_Rz(u, -1) + u)                # u at (xf_i, zf_k)
    conv_w = conv_w + 0.5 * (_X(Ue, 1) * _X(w, 1) - Ue * _X(w, -1)) * ihx
    Ve = 0.5 * (_Rz(v, -1) + v)                # v at (yf_j, zf_k)
    conv_w = conv_w + 0.5 * (_Ry(Ve, 1) * _Ry(w, 1) - Ve * _Ry(w, -1)) * ihy
    lap_w = ((_X(w, 1) - 2.0 * w + _X(w, -1)) * ihx * ihx
             + (_Ry(w, 1) - 2.0 * w + _Ry(w, -1)) * ihy * ihy
             + (_Rz(w, 1) - 2.0 * w + _Rz(w, -1)) * ihz * ihz)
    star_w = w + dt * (-conv_w + nu * lap_w)

    return star_u, star_v, star_w


def _predictor_periodic_launch(u, v, w, dt, *, hx, hy, hz, nu, fx):
    if u.device.type == "cpu":
        return predictor_periodic_twin(u, v, w, dt, hx=hx, hy=hy, hz=hz,
                                       nu=nu, fx=fx)
    return _predictor_periodic_cuda(u, v, w, dt, hx=hx, hy=hy, hz=hz,
                                    nu=nu, fx=fx)


def _predictor_periodic_cuda(u, v, w, dt, *, hx, hy, hz, nu, fx):
    su, sv, sw = (torch.empty_like(a) for a in (u, v, w))
    nx, ny, nz = u.shape
    _launch("predictor_periodic", u,
            *(t.data_ptr() for t in (u, v, w, dt, su, sv, sw)), nx, ny, nz,
            1.0 / hx, 1.0 / hy, 1.0 / hz, float(nu), float(fx))
    predictor_periodic.launches += 1
    return su, sv, sw


def predictor_periodic(u, v, w, dt, *, hx, hy, hz, nu, fx):
    """Euler star (u*, v*, w*) of the all-periodic uniform O2 skew
    predictor with scalar nu and body force fx on u. u, v, w: (Nx, Ny, Nz);
    dt: a 0-d tensor of the same device and dtype. The kernel runs on an
    (x, z) tile walked along y: a field past 2^31 - 1 elements raises
    ValueError (`tile_refusal`), on the CPU as on the card."""
    _check("predictor_periodic", (u, v, w, dt),
           (None, u.shape, u.shape, ()))
    if u.ndim != 3:
        raise ValueError(f"predictor_periodic: u has shape {tuple(u.shape)}")
    why = tile_refusal("predictor_periodic", u.shape[0], u.numel())
    if why:
        raise ValueError(why)
    kw = dict(hx=hx, hy=hy, hz=hz, nu=nu, fx=fx)
    return _ViaTwin.apply(_predictor_periodic_launch, predictor_periodic_twin,
                          kw, u, v, w, dt)


predictor_periodic.launches = 0


def periodic_eligible(geom: Geometry) -> bool:
    """All three axes periodic and uniform, 3-D: the periodic predictors'
    grid."""
    return geom.axes[2].n > 1 and all(ax.periodic and ax.uniform
                                      for ax in geom.axes)


def predictor_periodic_div_twin(u, v, w, dt, *, geom, nu, fx):
    """Plain twin of `predictor_periodic_div`: predictor_periodic_twin, then
    ops.divergence of its star (the all-periodic BC pass is a no-op), as
    the reference's star_jnp with fuse_div (cfdnn_tpu/solver.py:693-705)."""
    star = predictor_periodic_twin(u, v, w, dt, hx=geom.x.h, hy=geom.y.h,
                                   hz=geom.z.h, nu=nu, fx=fx)
    return star + (ops.divergence(star, geom),)


def _predictor_periodic_div_launch(u, v, w, dt, *, geom, nu, fx):
    if u.device.type == "cpu":
        return predictor_periodic_div_twin(u, v, w, dt, geom=geom, nu=nu,
                                           fx=fx)
    return _predictor_periodic_div_cuda(u, v, w, dt, geom=geom, nu=nu, fx=fx)


def _predictor_periodic_div_cuda(u, v, w, dt, *, geom, nu, fx):
    su, sv, sw, dv = (torch.empty_like(u) for _ in range(4))
    nx, ny, nz = u.shape
    _launch("predictor_periodic_div", u,
            *(t.data_ptr() for t in (u, v, w, dt, su, sv, sw, dv)),
            nx, ny, nz, 1.0 / geom.x.h, 1.0 / geom.y.h, 1.0 / geom.z.h,
            float(nu), float(fx))
    predictor_periodic_div.launches += 1
    return su, sv, sw, dv


def predictor_periodic_div(u, v, w, dt, *, geom: Geometry, nu, fx):
    """predictor_periodic's star (u*, v*, w*) and, from the same pass, its
    staggered cell divergence div(u*) (Nx, Ny, Nz), on the all-periodic
    uniform 3-D `geom`. dt: a 0-d tensor of the fields' device and
    dtype. The kernel runs on an (x, z) tile walked along y: a field past
    2^31 - 1 elements raises ValueError (`tile_refusal`), on the CPU as
    on the card."""
    if not periodic_eligible(geom) or geom.space_order != 2:
        raise NotImplementedError(
            "predictor_periodic_div: the kernel serves an all-periodic "
            "uniform 3-D grid at O2")
    _check("predictor_periodic_div", (u, v, w, dt),
           _face_shapes(geom) + ((),))
    _check_geom("predictor_periodic_div", geom, (u,))
    why = tile_refusal("predictor_periodic_div", u.shape[0], u.numel())
    if why:
        raise ValueError(why)
    return _ViaTwin.apply(_predictor_periodic_div_launch,
                          predictor_periodic_div_twin,
                          dict(geom=geom, nu=nu, fx=fx), u, v, w, dt)


predictor_periodic_div.launches = 0


# ---------------------------------------------------------------------------
# predictor_channel  <-  pallas_kernels.fused_predictor_channel
# ---------------------------------------------------------------------------


def channel_slab_eligible(geom: Geometry, cfg) -> bool:
    """Structural gate of the channel predictor (the reference's
    pallas_kernels.channel_slab_eligible)."""
    x, y, z = geom.axes
    return (x.periodic and x.uniform and z.periodic and z.uniform
            and y.bc == BCType.WALL and z.n > 1
            and cfg.space_order == 2
            and cfg.convective_scheme in (ConvectiveScheme.SKEW,
                                          ConvectiveScheme.CENTRAL)
            and not cfg.implicit_y_diffusion
            # the wall ghosts hardcode stationary no-slip
            and cfg.lid_velocity == 0.0)


def channel_y_arrays(geom: Geometry):
    """The five y-geometry vectors of the channel predictor, (1, n, 1):
      inv_dy  (Ny)    1/cell width
      inv_dyc (Ny+1)  1/center-to-center distance at faces (boundary:
                      half-cell, the folded Poisson metric)
      inv_dgy (Ny+1)  1/ghost-aware center spacing (mirror ghosts) for
                      wall-tangential gradients (operators._inv_dpos_c)
      inv2_cy (Ny)    1/(2-apart ghost-aware center distance): cc_central
      inv2_fy (Ny+1)  1/(2-apart face distance, odd-reflection ghosts)
    """
    y = geom.axes[1]
    p = y.pos_c_pad
    inv_dgy = 1.0 / (p[:, 1:] - p[:, :-1])
    inv2_cy = 1.0 / (p[:, 2:] - p[:, :-2])
    pf = y.pos_f_pad
    inv2_fy = 1.0 / (pf[:, 2:] - pf[:, :-2])
    return (y.inv_d.contiguous(), y.inv_dc.contiguous(), inv_dgy.contiguous(),
            inv2_cy.contiguous(), inv2_fy.contiguous())


# The predictor kernels' convective scheme as their C entries take it
# (csrc/predictor_terms.cuh `Scheme`): the channel kernels read 1 as skew
# and 0 as central, the general kernels all four codes.
SCHEME_CODES = {ConvectiveScheme.CENTRAL: 0, ConvectiveScheme.SKEW: 1,
                ConvectiveScheme.UPWIND: 2, ConvectiveScheme.UPWIND2: 3}
# the schemes of the channel and periodic predictors, as the reference's
# channel_slab_eligible and fused_predictor take them
SKEW_CENTRAL = (ConvectiveScheme.SKEW, ConvectiveScheme.CENTRAL)


def _scheme_code(scheme, served=tuple(SCHEME_CODES)) -> int:
    """The C entries' code of `scheme`; NotImplementedError for a scheme
    the kernel does not take."""
    if scheme not in served:
        raise NotImplementedError(
            f"scheme {scheme}: this predictor kernel takes "
            + " and ".join(s.value for s in served)
            + " only, as the reference's")
    return SCHEME_CODES[scheme]


def predictor_channel_twin(u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy,
                           inv2_fy, nu_t=None, *, hx, hz, nu, fx, scheme):
    """Plain twin of `predictor_channel`: the reference's
    predictor_slab_math_channel on whole arrays.

    u, w: (Nx, Ny, Nz); v: (Nx, Ny+1, Nz) with the wall faces stored;
    the y vectors as `channel_y_arrays` gives them; nu_t: None (scalar nu)
    or the cell eddy viscosity (Nx, Ny, Nz), added to nu. Math identical
    to ops._conv_skew / _conv_advective(CENTRAL) + ops.diffusive for this
    BC set: with nu_t, nu + nu_t is taken at the cells along each
    component's own axis and averaged to the transverse faces, flux
    direction first, as ops.diffusive averages it.
    """
    skew = (_scheme_code(scheme, SKEW_CENTRAL)
            == SCHEME_CODES[ConvectiveScheme.SKEW])
    ihx, ihz = 1.0 / hx, 1.0 / hz

    def wall_pad_t(f):
        # pad_tangential WALL: ghosts = -interior (no-slip value 0)
        return torch.cat([-f[:, :1], f, -f[:, -1:]], dim=1)

    def mirror_pad_c(f):
        # pad_center neumann: mirror values
        return torch.cat([f[:, :1], f, f[:, -1:]], dim=1)

    # ---- u component (x-face, y-center, z-center) ---------------------
    hi_n = _X(u, 1)
    lo_n = _X(u, -1)
    Ve = 0.5 * (_X(v, -1) + v)                   # (Nx, Ny+1, Nz)
    up = wall_pad_t(u)                           # (Nx, Ny+2, Nz)
    We = 0.5 * (_X(w, -1) + w)
    if skew:
        conv_u = 0.5 * ((0.5 * (u + hi_n)) * hi_n
                        - (0.5 * (lo_n + u)) * lo_n) * ihx
        conv_u = conv_u + 0.5 * (Ve[:, 1:] * up[:, 2:]
                                 - Ve[:, :-1] * up[:, :-2]) * inv_dy
        conv_u = conv_u + 0.5 * (_Rz(We, 1) * _Rz(u, 1)
                                 - We * _Rz(u, -1)) * ihz
    else:
        conv_u = u * (hi_n - lo_n) * (0.5 * ihx)
        V_at_u = 0.5 * (Ve[:, :-1] + Ve[:, 1:])
        conv_u = conv_u + V_at_u * (up[:, 2:] - up[:, :-2]) * inv2_cy
        W_at_u = 0.5 * (We + _Rz(We, 1))
        conv_u = conv_u + W_at_u * (_Rz(u, 1) - _Rz(u, -1)) * (0.5 * ihz)
    g_uy = (up[:, 1:] - up[:, :-1]) * inv_dgy    # (Nx, Ny+1, Nz) faces
    if nu_t is None:
        F = nu * g_uy
        lap_u = (nu * (_X(u, 1) - 2.0 * u + _X(u, -1)) * ihx * ihx
                 + (F[:, 1:] - F[:, :-1]) * inv_dy
                 + nu * (_Rz(u, 1) - 2.0 * u + _Rz(u, -1)) * ihz * ihz)
    else:
        ne = nu + nu_t                           # (Nx, Ny, Nz) cells
        # x (own axis): the two neighbour cells of face i
        Fx_hi = ne * (_X(u, 1) - u) * ihx
        Fx_lo = _X(ne, -1) * (u - _X(u, -1)) * ihx
        # y: nu at (x-face, y-face): y mirror-average, then x-average
        nmp = mirror_pad_c(ne)
        n_yf = 0.5 * (nmp[:, :-1] + nmp[:, 1:])  # (Nx, Ny+1, Nz)
        Fy = 0.5 * (_X(n_yf, -1) + n_yf) * g_uy
        # z: nu at (x-face, z-face): z-average, then x-average
        n_zf = 0.5 * (_Rz(ne, -1) + ne)
        Fz = 0.5 * (_X(n_zf, -1) + n_zf) * (u - _Rz(u, -1)) * ihz
        lap_u = ((Fx_hi - Fx_lo) * ihx
                 + (Fy[:, 1:] - Fy[:, :-1]) * inv_dy
                 + (_Rz(Fz, 1) - Fz) * ihz)
    star_u = u + dt * (-conv_u + lap_u + fx)

    # ---- v component (y-face staggered: Ny+1 values incl. walls) ------
    npad = torch.cat([2.0 * v[:, :1] - v[:, 1:2], v,
                      2.0 * v[:, -1:] - v[:, -2:-1]], dim=1)
    ue_yf = 0.5 * (up[:, :-1] + up[:, 1:])       # u at (x-face, y-face)
    wp = wall_pad_t(w)
    w_yf = 0.5 * (wp[:, :-1] + wp[:, 1:])        # w at (y-face, z-face)
    if skew:
        phi_c = 0.5 * (v[:, :-1] + v[:, 1:])     # (Nx, Ny, Nz)
        cpad = mirror_pad_c(phi_c)               # (Nx, Ny+2, Nz)
        conv_v = 0.5 * (cpad[:, 1:] * npad[:, 2:]
                        - cpad[:, :-1] * npad[:, :-2]) * inv_dyc
        conv_v = conv_v + 0.5 * (_X(ue_yf, 1) * _X(v, 1)
                                 - ue_yf * _X(v, -1)) * ihx
        conv_v = conv_v + 0.5 * (_Rz(w_yf, 1) * _Rz(v, 1)
                                 - w_yf * _Rz(v, -1)) * ihz
    else:
        conv_v = v * (npad[:, 2:] - npad[:, :-2]) * inv2_fy
        U_at_v = 0.5 * (ue_yf + _X(ue_yf, 1))
        conv_v = conv_v + U_at_v * (_X(v, 1) - _X(v, -1)) * (0.5 * ihx)
        W_at_v = 0.5 * (w_yf + _Rz(w_yf, 1))
        conv_v = conv_v + W_at_v * (_Rz(v, 1) - _Rz(v, -1)) * (0.5 * ihz)
    g_vy = (v[:, 1:] - v[:, :-1]) * inv_dy       # (Nx, Ny, Nz) cells
    if nu_t is None:
        Fp = mirror_pad_c(nu * g_vy)
        lap_v = (nu * (_X(v, 1) - 2.0 * v + _X(v, -1)) * ihx * ihx
                 + (Fp[:, 1:] - Fp[:, :-1]) * inv_dyc
                 + nu * (_Rz(v, 1) - 2.0 * v + _Rz(v, -1)) * ihz * ihz)
    else:
        ne = nu + nu_t
        Fp = mirror_pad_c(ne * g_vy)
        # x: nu at (x-face, y-face): x-average, then y mirror-average
        nxm = mirror_pad_c(0.5 * (_X(ne, -1) + ne))
        n_vx = 0.5 * (nxm[:, :-1] + nxm[:, 1:])  # x-face i, (Nx, Ny+1, Nz)
        Fx = n_vx * ((v - _X(v, -1)) * ihx)
        # z: nu at (y-face, z-face): z-average, then y mirror-average
        nzm = mirror_pad_c(0.5 * (_Rz(ne, -1) + ne))
        n_vz = 0.5 * (nzm[:, :-1] + nzm[:, 1:])
        Fz = n_vz * (v - _Rz(v, -1)) * ihz
        lap_v = ((_X(Fx, 1) - Fx) * ihx
                 + (Fp[:, 1:] - Fp[:, :-1]) * inv_dyc
                 + (_Rz(Fz, 1) - Fz) * ihz)
    star_v = v + dt * (-conv_v + lap_v)

    # ---- w component (z-face staggered; y-center like u) --------------
    hi_n = _Rz(w, 1)
    lo_n = _Rz(w, -1)
    Ue = 0.5 * (_Rz(u, -1) + u)                  # u at (x-face, z-face)
    Ve_w = 0.5 * (_Rz(v, -1) + v)                # (Nx, Ny+1, Nz)
    if skew:
        conv_w = 0.5 * ((0.5 * (w + hi_n)) * hi_n
                        - (0.5 * (lo_n + w)) * lo_n) * ihz
        conv_w = conv_w + 0.5 * (_X(Ue, 1) * _X(w, 1)
                                 - Ue * _X(w, -1)) * ihx
        conv_w = conv_w + 0.5 * (Ve_w[:, 1:] * wp[:, 2:]
                                 - Ve_w[:, :-1] * wp[:, :-2]) * inv_dy
    else:
        conv_w = w * (hi_n - lo_n) * (0.5 * ihz)
        U_at_w = 0.5 * (Ue + _X(Ue, 1))
        conv_w = conv_w + U_at_w * (_X(w, 1) - _X(w, -1)) * (0.5 * ihx)
        V_at_w = 0.5 * (Ve_w[:, :-1] + Ve_w[:, 1:])
        conv_w = conv_w + V_at_w * (wp[:, 2:] - wp[:, :-2]) * inv2_cy
    g_wy = (wp[:, 1:] - wp[:, :-1]) * inv_dgy
    if nu_t is None:
        Fw = nu * g_wy
        lap_w = (nu * (_X(w, 1) - 2.0 * w + _X(w, -1)) * ihx * ihx
                 + (Fw[:, 1:] - Fw[:, :-1]) * inv_dy
                 + nu * (_Rz(w, 1) - 2.0 * w + _Rz(w, -1)) * ihz * ihz)
    else:
        ne = nu + nu_t
        # z (own axis): cell nu on the cell fluxes; Fz_c of cell k
        Fz_c = ne * (_Rz(w, 1) - w) * ihz
        # x: nu at (x-face, z-face): x-average, then z-average
        nxf = 0.5 * (_X(ne, -1) + ne)
        Fx = 0.5 * (_Rz(nxf, -1) + nxf) * ((w - _X(w, -1)) * ihx)
        # y: nu at (y-face, z-face): y mirror-average, then z-average
        nmp = mirror_pad_c(ne)
        n_yf = 0.5 * (nmp[:, :-1] + nmp[:, 1:])
        Fy = 0.5 * (_Rz(n_yf, -1) + n_yf) * g_wy
        lap_w = ((_X(Fx, 1) - Fx) * ihx
                 + (Fy[:, 1:] - Fy[:, :-1]) * inv_dy
                 + (Fz_c - _Rz(Fz_c, -1)) * ihz)
    star_w = w + dt * (-conv_w + lap_w)

    return star_u, star_v, star_w


def _predictor_channel_launch(u, v, w, dt, inv_dy, inv_dyc, inv_dgy,
                              inv2_cy, inv2_fy, nu_t=None, *, hx, hz, nu, fx,
                              scheme):
    ys = (inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy)
    if u.device.type == "cpu":
        return predictor_channel_twin(u, v, w, dt, *ys, nu_t, hx=hx, hz=hz,
                                      nu=nu, fx=fx, scheme=scheme)
    return _predictor_channel_cuda(u, v, w, dt, ys, nu_t, hx=hx, hz=hz, nu=nu,
                                   fx=fx, scheme=scheme)


def _predictor_channel_cuda(u, v, w, dt, ys, nu_t, *, hx, hz, nu, fx,
                            scheme):
    code = _scheme_code(scheme, SKEW_CENTRAL)
    su, sv, sw = (torch.empty_like(a) for a in (u, v, w))
    nx, ny, nz = u.shape
    _launch("predictor_channel", u,
            *(t.data_ptr() for t in (u, v, w, dt, *ys)),
            None if nu_t is None else nu_t.data_ptr(),
            *(t.data_ptr() for t in (su, sv, sw)),
            nx, ny, nz, 1.0 / hx, 1.0 / hz, float(nu), float(fx), code)
    predictor_channel.launches += 1
    return su, sv, sw


def predictor_channel(u, v, w, dt, ys, *, hx, hz, nu, fx, scheme, nu_t=None):
    """Euler star (u*, v*, w*) of the wall-y channel predictor (periodic
    uniform x/z, stretched no-slip y, O2 skew or central, body force fx on
    u). `ys` = channel_y_arrays(geom). The viscosity is the scalar nu, or
    nu + nu_t with `nu_t` a cell field (Nx, Ny, Nz). Star v is produced at
    the wall faces too; the caller's BC pass zeroes them. The kernel runs
    on an (x, z) tile walked along y: a grid it refuses (`tile_refusal`:
    Nx < 8, a field past 2^31 - 1 elements) raises ValueError, on the CPU
    as on the card."""
    nx, ny, nz = u.shape
    if ny < 2:
        raise ValueError("predictor_channel: needs Ny >= 2")
    why = tile_refusal("predictor_channel", nx, nx * (ny + 1) * nz,
                       min_nx=8)      # xz::kTx
    if why:
        raise ValueError(why)
    extra = () if nu_t is None else (nu_t,)
    _check("predictor_channel", (u, v, w, dt, *ys, *extra),
           ((nx, ny, nz), (nx, ny + 1, nz), (nx, ny, nz), (),
            (1, ny, 1), (1, ny + 1, 1), (1, ny + 1, 1), (1, ny, 1),
            (1, ny + 1, 1), (nx, ny, nz)))
    kw = dict(hx=hx, hz=hz, nu=nu, fx=fx, scheme=scheme)
    # launch and twin take nu_t in its own parameter, after the five ys
    return _ViaTwin.apply(_predictor_channel_launch, predictor_channel_twin,
                          kw, u, v, w, dt, *ys, *extra)


predictor_channel.launches = 0


def predictor_channel_div_twin(u, v, w, dt, inv_dy, inv_dyc, inv_dgy,
                               inv2_cy, inv2_fy, nu_t=None, *, geom, nu, fx,
                               scheme):
    """Plain twin of `predictor_channel_div`: predictor_channel_twin, v's
    wall faces zeroed (the BC pass), then ops.divergence of that star, as
    the reference's star_jnp with fuse_div (cfdnn_tpu/solver.py:693-705)."""
    su, sv, sw = predictor_channel_twin(
        u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, nu_t,
        hx=geom.x.h, hz=geom.z.h, nu=nu, fx=fx, scheme=scheme)
    wall = torch.zeros_like(sv[:, :1])
    sv = torch.cat([wall, sv[:, 1:-1], wall], dim=1)
    return su, sv, sw, ops.divergence((su, sv, sw), geom)


def _predictor_channel_div_launch(u, v, w, dt, inv_dy, inv_dyc, inv_dgy,
                                  inv2_cy, inv2_fy, nu_t=None, *, geom, nu,
                                  fx, scheme):
    ys = (inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy)
    if u.device.type == "cpu":
        return predictor_channel_div_twin(u, v, w, dt, *ys, nu_t, geom=geom,
                                          nu=nu, fx=fx, scheme=scheme)
    return _predictor_channel_div_cuda(u, v, w, dt, ys, nu_t, geom=geom,
                                       nu=nu, fx=fx, scheme=scheme)


def _predictor_channel_div_cuda(u, v, w, dt, ys, nu_t, *, geom, nu, fx,
                                scheme):
    code = _scheme_code(scheme, SKEW_CENTRAL)
    su, sv, sw = (torch.empty_like(a) for a in (u, v, w))
    dv = torch.empty_like(u)
    nx, ny, nz = u.shape
    _launch("predictor_channel_div", u,
            *(t.data_ptr() for t in (u, v, w, dt, *ys)),
            None if nu_t is None else nu_t.data_ptr(),
            *(t.data_ptr() for t in (su, sv, sw, dv)),
            nx, ny, nz, 1.0 / geom.x.h, 1.0 / geom.z.h, float(nu), float(fx),
            code)
    predictor_channel_div.launches += 1
    return su, sv, sw, dv


def predictor_channel_div(u, v, w, dt, ys, *, geom: Geometry, nu, fx, scheme,
                          nu_t=None):
    """predictor_channel's star with v's wall faces set to 0 (what the BC
    pass gives), and, from the same pass, its staggered cell divergence
    div(u*) (Nx, Ny, Nz), on the wall-y channel `geom` (periodic uniform x
    and z). `ys` = channel_y_arrays(geom); nu_t as predictor_channel's.
    The kernel runs on predictor_channel's walked (x, z) tile: a grid it
    refuses (`tile_refusal`: Nx < 8, a field past 2^31 - 1 elements)
    raises ValueError, on the CPU as on the card."""
    x, y, z = geom.axes
    if not (x.periodic and x.uniform and z.periodic and z.uniform
            and z.n > 1 and y.bc == BCType.WALL and geom.space_order == 2):
        raise NotImplementedError(
            "predictor_channel_div: the kernel serves periodic uniform x "
            "and z with no-slip y walls, 3-D, O2")
    if y.n < 2:
        raise ValueError("predictor_channel_div: needs Ny >= 2")
    nx, ny, nz = x.n, y.n, z.n
    why = tile_refusal("predictor_channel_div", nx, nx * (ny + 1) * nz,
                       min_nx=8)      # xz::kTx
    if why:
        raise ValueError(why)
    extra = () if nu_t is None else (nu_t,)
    _check("predictor_channel_div", (u, v, w, dt, *ys, *extra),
           _face_shapes(geom) + ((), (1, ny, 1), (1, ny + 1, 1),
                                 (1, ny + 1, 1), (1, ny, 1), (1, ny + 1, 1),
                                 (nx, ny, nz)))
    _check_geom("predictor_channel_div", geom, (u,))
    _scheme_code(scheme, SKEW_CENTRAL)
    kw = dict(geom=geom, nu=nu, fx=fx, scheme=scheme)
    return _ViaTwin.apply(_predictor_channel_div_launch,
                          predictor_channel_div_twin, kw, u, v, w, dt, *ys,
                          *extra)


predictor_channel_div.launches = 0


# ---------------------------------------------------------------------------
# predictor_general  <-  pallas_kernels.fused_predictor_general
# predictor_xpad     <-  pallas_kernels.fused_predictor_xpad (a wrapper)
# ---------------------------------------------------------------------------


def _yz_ok(ax) -> bool:
    """A y or z axis the general and LES kernels serve: more than one
    cell, periodic uniform or WALL at any stretching."""
    return ax.n > 1 and ((ax.periodic and ax.uniform)
                         or ax.bc == BCType.WALL)


# the non-periodic x kinds predictor_xpad pads (the reference's xpad mode,
# cfdnn_tpu/solver.py:379-382): no-slip, the inflow/outflow pair, outflow
XPAD_BCS = (BCType.WALL, BCType.INFLOW, BCType.OUTFLOW)


def _general_geom_ok(geom: Geometry, x_pad: bool = False) -> bool:
    """The grids the general predictor kernel serves: periodic uniform x
    (or, through predictor_xpad, a uniform no-slip, inflow/outflow or
    outflow x) with x.n >= 8, y and z as `_yz_ok`, O2 or O4 (O4 on the
    periodic axes of n >= 4, x among them; a non-periodic x is O2 at every
    order, so its padded periodic clone would not be: xpad_eligible takes
    O2 only)."""
    x, y, z = geom.axes
    x_ok = x.bc in XPAD_BCS if x_pad else x.periodic
    return x_ok and x.uniform and x.n >= 8 and _yz_ok(y) and _yz_ok(z)


def _general_cfg_ok(cfg) -> bool:
    return not cfg.implicit_y_diffusion


def general_eligible(geom: Geometry, cfg) -> bool:
    """Gate of the general predictor: the reference's shared gate
    (cfdnn_tpu/solver.py:335-347) less its TPU memory fits, for what the
    port's operators express (O2 or O4, each of the four convective
    schemes, no implicit y-diffusion). Moving walls are served."""
    return _general_geom_ok(geom) and _general_cfg_ok(cfg)


def xpad_eligible(geom: Geometry, cfg) -> bool:
    """Gate of predictor_xpad: the general gate with a uniform no-slip,
    inflow/outflow or outflow x in place of the periodic one, O2, and not
    upwind2, whose stencil reaches past the one ghost plane of the pad
    (the reference's xpad mode, cfdnn_tpu/solver.py:363-385)."""
    return (_general_geom_ok(geom, x_pad=True) and _general_cfg_ok(cfg)
            and geom.space_order == 2
            and cfg.convective_scheme != ConvectiveScheme.UPWIND2)


def general_arrays(geom: Geometry):
    """The 21 1-D metric vectors of the general predictor, seven per axis
    (x, y, z), as the operator library forms them:
      inv_d  (n)    1/cell width
      inv_dc (n+1)  1/centre distance at the faces (periodic wrap, half
                    cell at a wall): the own-axis skew width and
                    _bdiff_stored's spacing
      inv_dg (n+1)  1/ghost-aware centre spacing (operators._inv_dpos_c)
      den_c  (n)    2-apart centre distance, mirror ghosts (cc_central)
      den_f  (nf)   2-apart face distance, odd ghosts (ff_central)
      dg_c   (n+1)  ghost-aware centre spacing: at cell c the upwind
                    schemes' backward divisor is dg_c[c], the forward one
                    dg_c[c + 1] (operators._upwind_pair's den_b, den_f and
                    _upwind2_pair's h_b, h_f: the same differences)
      dg_f   (nf+1) the same of the faces, odd ghosts
    """
    out = []
    for ax in geom.axes:
        pc = ax.pos_c_pad.reshape(-1)
        pf = ax.pos_f_pad.reshape(-1)
        out += [ax.inv_d.reshape(-1), ax.inv_dc.reshape(-1),
                1.0 / (pc[1:] - pc[:-1]), pc[2:] - pc[:-2], pf[2:] - pf[:-2],
                pc[1:] - pc[:-1], pf[1:] - pf[:-1]]
    return tuple(t.contiguous() for t in out)


def _general_array_shapes(geom: Geometry):
    return tuple(s for ax in geom.axes
                 for s in ((ax.n,), (ax.n + 1,), (ax.n + 1,), (ax.n,),
                           (_nfaces(ax),), (ax.n + 1,), (_nfaces(ax) + 1,)))


def predictor_general_twin(u, v, w, dt, nu_t=None, *, geom, nu, fx, scheme):
    """Plain twin of `predictor_general`: the operator library itself,
    ops.convective + ops.diffusive (scalar nu or nu + nu_t) + fx on u,
    then the Euler star: the body of the reference's _general_kernel
    (pallas_kernels.py:276-307)."""
    comps = (u, v, w)
    conv = ops.convective(comps, geom, scheme)
    diff = ops.diffusive(comps, nu if nu_t is None else nu + nu_t, geom)
    return (u + dt * (-conv[0] + diff[0] + fx),
            v + dt * (-conv[1] + diff[1]),
            w + dt * (-conv[2] + diff[2]))


def _predictor_general_twin_gs(u, v, w, dt, nu_t=None, *, gs, **kw):
    # the twin as _ViaTwin's backward calls it: the metric vectors are the
    # kernel's, the twin reads `geom`
    return predictor_general_twin(u, v, w, dt, nu_t, **kw)


def _predictor_general_launch(u, v, w, dt, nu_t=None, *, gs, geom, nu, fx,
                              scheme):
    if u.device.type == "cpu":
        return predictor_general_twin(u, v, w, dt, nu_t, geom=geom, nu=nu,
                                      fx=fx, scheme=scheme)
    return _predictor_general_cuda(u, v, w, dt, nu_t, gs=gs, geom=geom,
                                   nu=nu, fx=fx, scheme=scheme)


def _wide_constants(geom: Geometry, with_nut: bool, scheme):
    """The constants of the general predictor's wide variant (the O4
    kernel's two-cell window), a host array (ctypes) of (12 h, 12 h^2) a
    axis, 0 on an O2 axis, as the reference's same_diff4 and same_diff2_4
    divide; None where the one-cell kernel computes the step: at O2 but
    for upwind2 (its stencil reaches two cells: the wide kernel with every
    axis O2), and for skew convection with nu_t, which has no O4 term."""
    if ((geom.space_order == 2 and scheme != ConvectiveScheme.UPWIND2)
            or (with_nut and scheme == ConvectiveScheme.SKEW)):
        return None
    return (ctypes.c_double * 6)(*(
        t for a, ax in enumerate(geom.axes)
        for t in ((12.0 * ax.h, 12.0 * ax.h**2) if geom.use_o4(a)
                  else (0.0, 0.0))))


def _general_call(name, u, v, w, dt, nu_t, gs, geom, nu, fx, scheme):
    """Launch `name` (predictor_general or predictor_general_xz: one C
    interface; at O4, and for upwind2, its wide variant,
    predictor_general_o4 or predictor_general_xz_o4, with the O4 constants
    after it) and return its three stars."""
    code = _scheme_code(scheme)
    su, sv, sw = (torch.empty_like(a) for a in (u, v, w))
    x, y, z = geom.axes
    # host arrays, read by the launcher: the 21 metric pointers and the
    # (lo, hi) tangential wall velocities of u, v, w on y, then on z
    metrics = (ctypes.c_void_p * len(gs))(*(t.data_ptr() for t in gs))
    tang = (ctypes.c_double * 12)(*(float(t) for ax in (y, z)
                                    for pair in ax.tang for t in pair))
    o4 = _wide_constants(geom, nu_t is not None, scheme)
    if o4 is not None:
        name += "_o4"
    _launch(name, u,
            *(t.data_ptr() for t in (u, v, w, dt)),
            None if nu_t is None else nu_t.data_ptr(),
            *(t.data_ptr() for t in (su, sv, sw)),
            ctypes.cast(metrics, ctypes.c_void_p),
            ctypes.cast(tang, ctypes.c_void_p),
            x.n, y.n, z.n, int(y.bc == BCType.WALL), int(z.bc == BCType.WALL),
            float(nu), float(fx), code,
            *(() if o4 is None else (ctypes.cast(o4, ctypes.c_void_p),)))
    return su, sv, sw


def _predictor_general_cuda(u, v, w, dt, nu_t, *, gs, geom, nu, fx, scheme):
    out = _general_call("predictor_general", u, v, w, dt, nu_t, gs, geom, nu,
                        fx, scheme)
    predictor_general.launches += 1
    return out


def predictor_general(u, v, w, dt, gs, *, geom: Geometry, nu, fx, scheme,
                      nu_t=None):
    """Euler star (u*, v*, w*) of the predictor on a periodic uniform x
    with periodic or no-slip (moving or not) y and z at any stretching,
    O2 or O4, skew, central, upwind or upwind2, body force fx on u. `gs`
    = general_arrays(geom). At O4 the kernel's O4 variant runs the O4
    stencils on each O4 axis (Geometry.use_o4), as the operators do;
    upwind2, whose stencil reaches two cells, runs on that variant's
    window at every order.
    The viscosity is the scalar nu, or nu + nu_t with `nu_t` a cell field.
    Star values at the wall faces are produced as the operators produce
    them; the caller's BC pass overwrites them. The kernel walks an (x, z)
    tile along y with 32-bit offsets: a face array past 2^31 - 1 elements
    raises ValueError (`tile_refusal`)."""
    if not _general_geom_ok(geom):
        raise NotImplementedError(
            "predictor_general: the kernel serves a periodic uniform x "
            "(x.n >= 8) with y and z periodic uniform or walls; a "
            "no-slip, inflow/outflow or outflow x goes through "
            "predictor_xpad, other geometries are ROADMAP B.3/A.13")
    x, y, z = geom.axes
    extra = () if nu_t is None else (nu_t,)
    _check("predictor_general", (u, v, w, dt, *extra, *gs),
           _face_shapes(geom) + ((),) + ((x.n, y.n, z.n),) * len(extra)
           + _general_array_shapes(geom))
    _check_geom("predictor_general", geom, (u,))
    _scheme_code(scheme)
    why = tile_refusal("predictor_general", x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    kw = dict(gs=gs, geom=geom, nu=nu, fx=fx, scheme=scheme)
    return _ViaTwin.apply(_predictor_general_launch,
                          _predictor_general_twin_gs, kw, u, v, w, dt, *extra)


predictor_general.launches = 0


def xpad_geometry(geom: Geometry) -> Geometry:
    """Periodic uniform clone of a uniform non-periodic x with one ghost
    cell per side (Nx+2 cells), the reference's _xpad_geometry: the ghost
    planes carry the bc.py pad values, so the periodic kernel reproduces
    the operators on the kept interior."""
    x = geom.axes[0]
    ax = Axis1D.make(x.n + 2, 0.0, (x.n + 2) * x.h)
    xs = AxisGeom.make(ax, BCType.PERIODIC, 0, geom.dtype, x.inv_d.device)
    return dataclasses.replace(geom, axes=(xs,) + tuple(geom.axes[1:]))


def _xpad_fields(u, v, w, nu_t, geom):
    """u, v, w (and nu_t) padded by one ghost plane per side of a uniform
    non-periodic x with the bc.py values, the reference's ghost rules
    (pallas_kernels.py:374-391): u's low ghost the odd reflection
    2 u_0 - u_1 at a wall or an inflow, the zero-gradient copy u_0 at an
    outflow (no ghost above face Nx: the wrap feeds only u's face Nx,
    which the BC pass or the convective outlet overwrites); v and w the
    mirror, with the no-slip sign flip at a wall; nu_t the mirror."""
    x = geom.axes[0]
    if x.bc not in XPAD_BCS or not x.uniform:
        raise NotImplementedError(
            f"predictor_xpad: x is {x.bc.value}"
            f"{'' if x.uniform else ', stretched'}; the port pads a "
            "uniform no-slip, inflow/outflow or outflow x")
    u_lo = u[:1] if x.bc == BCType.OUTFLOW else 2.0 * u[:1] - u[1:2]
    u_pad = torch.cat([u_lo, u])
    s = -1.0 if x.bc == BCType.WALL else 1.0
    v_pad, w_pad = (torch.cat([s * f[:1], f, s * f[-1:]]) for f in (v, w))
    nut_pad = (None if nu_t is None
               else torch.cat([nu_t[:1], nu_t, nu_t[-1:]]))
    return u_pad, v_pad, w_pad, nut_pad


def predictor_xpad_twin(u, v, w, dt, nu_t=None, *, geom, xgeom, nu, fx,
                        scheme):
    """Plain twin of `predictor_xpad`: the same padding around
    predictor_general_twin."""
    u_pad, v_pad, w_pad, nut_pad = _xpad_fields(u, v, w, nu_t, geom)
    su, sv, sw = predictor_general_twin(u_pad, v_pad, w_pad, dt, nut_pad,
                                        geom=xgeom, nu=nu, fx=fx,
                                        scheme=scheme)
    return su[1:], sv[1:-1], sw[1:-1]


def predictor_xpad(u, v, w, dt, gs, *, geom: Geometry, xgeom: Geometry, nu,
                   fx, scheme, nu_t=None):
    """The general predictor on a uniform non-periodic x, no-slip,
    inflow/outflow or outflow (the reference's fused_predictor_xpad, a
    wrapper, not a kernel): pad x by one ghost
    plane per side (`_xpad_fields`), run predictor_general on the
    fake-periodic (Nx+2)-cell axis `xgeom` = xpad_geometry(geom) (`gs` =
    general_arrays(xgeom)), and keep the interior. O2 only, as the
    reference's (a non-periodic x is O2 at every order), and not upwind2,
    whose stencil reaches past the one ghost plane (the reference's xpad
    gate refuses it)."""
    if geom.space_order != 2:
        raise NotImplementedError(
            f"predictor_xpad: space_order={geom.space_order}; the padded x "
            "is O2 only, as the reference's fused_predictor_xpad")
    if scheme == ConvectiveScheme.UPWIND2:
        raise NotImplementedError(
            "predictor_xpad: upwind2 reaches two cells, past the one ghost "
            "plane of the pad; the reference's xpad mode refuses it too")
    u_pad, v_pad, w_pad, nut_pad = _xpad_fields(u, v, w, nu_t, geom)
    su, sv, sw = predictor_general(u_pad, v_pad, w_pad, dt, gs, geom=xgeom,
                                   nu=nu, fx=fx, scheme=scheme, nu_t=nut_pad)
    return su[1:], sv[1:-1], sw[1:-1]


# ---------------------------------------------------------------------------
# divergence  <-  pallas_kernels.fused_divergence
# correct     <-  pallas_kernels.fused_correct
# ---------------------------------------------------------------------------


def _check_geom(name: str, geom: Geometry, fields) -> None:
    f0 = fields[0]
    for ax in geom.axes:
        for t in (ax.inv_d, ax.inv_dc):
            if t.device != f0.device or t.dtype != f0.dtype:
                raise ValueError(
                    f"{name}: geometry on {t.device}/{t.dtype}, fields on "
                    f"{f0.device}/{f0.dtype}")


def _face_shapes(geom: Geometry):
    x, y, z = geom.axes
    return ((_nfaces(x), y.n, z.n), (x.n, _nfaces(y), z.n),
            (x.n, y.n, _nfaces(z)))


def divergence_twin(u, v, w, *, geom):
    """Plain twin of `divergence`: ops.operators.divergence."""
    return ops.divergence((u, v, w), geom)


def _divergence_launch(u, v, w, *, geom):
    if u.device.type == "cpu":
        return divergence_twin(u, v, w, geom=geom)
    return _divergence_cuda(u, v, w, geom=geom)


def _divergence_call(name, u, v, w, geom):
    """Launch `name` (divergence or divergence_xz: one C interface)."""
    x, y, z = geom.axes
    out = torch.empty((x.n, y.n, z.n), dtype=u.dtype, device=u.device)
    # an O4 axis (mode 3) passes its divisor 24 h in place of inv_d
    modes = _modes(geom)
    dens = [ax.o4_den if m == 3 else ax.inv_d
            for ax, m in zip(geom.axes, modes)]
    _launch(name, u,
            *(t.data_ptr() for t in (u, v, w, *dens, out)), x.n, y.n, z.n,
            *modes)
    return out


def _divergence_cuda(u, v, w, *, geom):
    out = _divergence_call("divergence", u, v, w, geom)
    divergence.launches += 1
    return out


def divergence(u, v, w, *, geom: Geometry):
    """Staggered cell divergence of (u, v, w) on `geom`, O4 (f2c_diff4)
    along each Geometry.use_o4 axis and O2 elsewhere. The kernel
    walks an (x, z) tile along y with 32-bit offsets: a face array past
    2^31 - 1 elements raises ValueError (`tile_refusal`)."""
    _check("divergence", (u, v, w), _face_shapes(geom))
    _check_geom("divergence", geom, (u,))
    why = tile_refusal("divergence", geom.x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    return _ViaTwin.apply(_divergence_launch, divergence_twin,
                          dict(geom=geom), u, v, w)


divergence.launches = 0


def correct_twin(u, v, w, p, dt, *, geom):
    """Plain twin of `correct`: ops.operators.correct_velocity."""
    return ops.correct_velocity((u, v, w), p, dt, geom)


def _correct_launch(u, v, w, p, dt, *, geom):
    if u.device.type == "cpu":
        return correct_twin(u, v, w, p, dt, geom=geom)
    return _correct_cuda(u, v, w, p, dt, geom=geom)


def _correct_call(name, u, v, w, p, dt, geom):
    """Launch `name` (correct or correct_xz: one C interface)."""
    ou, ov, ow = (torch.empty_like(a) for a in (u, v, w))
    x, y, z = geom.axes
    # an O4 axis (mode 3) passes its divisor 24 h in place of inv_dc
    modes = _modes(geom)
    dens = [ax.o4_den if m == 3 else ax.inv_dc
            for ax, m in zip(geom.axes, modes)]
    _launch(name, u,
            *(t.data_ptr() for t in (u, v, w, p, dt, *dens, ou, ov, ow)),
            x.n, y.n, z.n, *modes)
    return ou, ov, ow


def _correct_cuda(u, v, w, p, dt, *, geom):
    out = _correct_call("correct", u, v, w, p, dt, geom)
    correct.launches += 1
    return out


def correct(u, v, w, p, dt, *, geom: Geometry):
    """(u, v, w) - dt * grad(p) at the stored faces, O4 (c2f_diff4) along
    each Geometry.use_o4 axis and O2 elsewhere, with the Neumann
    pressure ghost at bounded axes (zero gradient at the boundary faces).
    The kernel walks an (x, z) tile along y with 32-bit offsets: a face
    array past 2^31 - 1 elements raises ValueError (`tile_refusal`)."""
    for ax in geom.axes:
        if not ax.periodic and "dirichlet" in (ax.p_lo, ax.p_hi):
            raise NotImplementedError(
                "correct: a Dirichlet pressure end (an OUTFLOW y or z on "
                "a periodic x) is not served by the kernel; ROADMAP B.3")
    x, y, z = geom.axes
    _check("correct", (u, v, w, p, dt),
           _face_shapes(geom) + ((x.n, y.n, z.n), ()))
    _check_geom("correct", geom, (u,))
    why = tile_refusal("correct", x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    return _ViaTwin.apply(_correct_launch, correct_twin, dict(geom=geom),
                          u, v, w, p, dt)


correct.launches = 0


# ---------------------------------------------------------------------------
# nu_sgs         <-  pallas_kernels.fused_nu_sgs
# germano_pass1  <-  pallas_kernels.fused_germano_pass1
# ---------------------------------------------------------------------------


def les_refusal(name: str, geom: Geometry) -> Optional[str]:
    """The gates of the LES kernels (a key of LES_GATES): why the kernel
    `name` does not serve `geom`, the first of its conditions that fails,
    or None where it does.
      nu_sgs         the reference's LES gate (cfdnn_tpu/turbulence/
                     les.py:37-39): periodic uniform x, y and z each
                     periodic uniform or a stationary no-slip wall at any
                     stretching (y.n, z.n > 1), at any order (the strain is
                     O2 at every order, as the reference's);
      germano_pass1  nu_sgs's (its box filter truncates at a wall of y or
                     z, as the reference's fuses it on any slab geometry);
      nu_sgs_xz      nu_sgs's on the xz kernels' grid (xz_eligible), at
                     any order too."""
    x, y, z = geom.axes
    if not (x.periodic and x.uniform and x.n > 1):
        return f"{name} needs a periodic uniform x"
    if not (_yz_ok(y) and _yz_ok(z)):
        return (f"{name} needs y and z each periodic uniform or a no-slip "
                "wall")
    if any(t != (0.0, 0.0) for ax in (y, z) for t in ax.tang):
        return (f"{name} needs stationary walls (its wall ghosts are "
                "no-slip at rest; a lid or a moving wall is not served)")
    if name == "nu_sgs_xz" and not xz_eligible(geom):
        return ("nu_sgs_xz needs the (x, z) tile's grid (x.n >= 8, a "
                "periodic z; at O4 x and z of 4 cells or more)")
    return None


def nu_sgs_eligible(geom: Geometry) -> bool:
    """Structural gate of the nu_sgs kernel (`les_refusal`)."""
    return les_refusal("nu_sgs", geom) is None


def germano_pass1_eligible(geom: Geometry) -> bool:
    """Structural gate of the germano_pass1 kernel (`les_refusal`)."""
    return les_refusal("germano_pass1", geom) is None


LES_GATES = {"nu_sgs": nu_sgs_eligible,
             "germano_pass1": germano_pass1_eligible}


def les_arrays(geom: Geometry):
    """The seven geometry vectors of the LES kernels: inv_d per axis (Nx,
    Ny, Nz), the 2-apart ghost-aware center distance per axis (the
    denominators ops.cc_central divides by) and the filter width Delta
    over the (y, z) plane (Ny * Nz, z fastest; it varies in z on a
    stretched z)."""
    def den(ax):
        p = ax.pos_c_pad.reshape(-1)
        return (p[2:] - p[:-2]).contiguous()

    y, z = geom.axes[1:]
    delta = turb_base.filter_width(geom).expand(1, y.n, z.n)
    return (*(ax.inv_d.reshape(-1).contiguous() for ax in geom.axes),
            *(den(ax) for ax in geom.axes),
            delta.reshape(-1).contiguous())


def _closure_id(closure: str) -> int:
    """The nu_sgs kernel's CLOSURE template id: the closure's place in
    turbulence.les.CLOSURES."""
    from ..turbulence import les   # les imports this module
    if closure not in les.CLOSURES:
        raise ValueError(f"nu_sgs: closure {closure!r}; one of "
                         f"{sorted(les.CLOSURES)}")
    return list(les.CLOSURES).index(closure)


def _check_les(name, u, v, w, gs, geom):
    if not LES_GATES[name](geom):
        raise NotImplementedError(
            f"{name}: the kernel serves a periodic uniform x with y and z "
            "periodic uniform or stationary walls; a moving wall is "
            "ROADMAP §B")
    x, y, z = geom.axes
    _check(name, (u, v, w, *gs),
           _face_shapes(geom) + ((x.n,), (y.n,), (z.n,), (x.n,), (y.n,),
                                 (z.n,), (y.n * z.n,)))


def nu_sgs_twin(u, v, w, *gs, geom, closure, coeff):
    """Plain twin of `nu_sgs`: strain_rotation, filter_width and the
    closure's algebra (turbulence/les.py), as the reference's
    fused_nu_sgs runs its model_fn."""
    from ..turbulence import les   # les imports this module
    sr = turb_base.strain_rotation((u, v, w), geom)
    return les.CLOSURES[closure](sr, turb_base.filter_width(geom), coeff)


def _nu_sgs_launch(u, v, w, *gs, geom, closure, coeff):
    if u.device.type == "cpu":
        return nu_sgs_twin(u, v, w, geom=geom, closure=closure, coeff=coeff)
    return _nu_sgs_cuda(u, v, w, *gs, geom=geom, closure=closure,
                        coeff=coeff)


def _nu_sgs_call(name, u, v, w, gs, geom, closure, coeff):
    """Launch `name` (nu_sgs or nu_sgs_xz: one C interface)."""
    x, y, z = geom.axes
    out = torch.empty((x.n, y.n, z.n), dtype=u.dtype, device=u.device)
    _launch(name, u, *(t.data_ptr() for t in (u, v, w, *gs, out)),
            x.n, y.n, z.n, int(y.bc == BCType.WALL), int(z.bc == BCType.WALL),
            _closure_id(closure), float(coeff))
    return out


def _nu_sgs_cuda(u, v, w, *gs, geom, closure, coeff):
    out = _nu_sgs_call("nu_sgs", u, v, w, gs, geom, closure, coeff)
    nu_sgs.launches += 1
    return out


def nu_sgs(u, v, w, gs, *, geom: Geometry, closure: str, coeff: float):
    """Cell nu_sgs (Nx, Ny, Nz) of an algebraic LES closure from the
    nine-component velocity gradient, in one pass over u, v, w.
    `closure`: "smagorinsky" | "wale" | "vreman", with its constant
    `coeff`; `gs` = les_arrays(geom). The kernel walks an (x, z) tile along
    y with 32-bit offsets: a face array past 2^31 - 1 elements raises
    ValueError (`tile_refusal`)."""
    _closure_id(closure)   # raises on an unknown closure
    _check_les("nu_sgs", u, v, w, gs, geom)
    why = tile_refusal("nu_sgs", geom.x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    kw = dict(geom=geom, closure=closure, coeff=coeff)
    return _ViaTwin.apply(_nu_sgs_launch, nu_sgs_twin, kw, u, v, w, *gs)


nu_sgs.launches = 0


def germano_pass1_twin(u, v, w, *gs, geom):
    """Plain twin of `germano_pass1`: the Germano products of
    turbulence/les.py, then the (x, z)-plane sums taken in float64 and
    cast to the field dtype, as the kernel takes them."""
    from ..turbulence import les   # les imports this module
    smag, LM, MM = les.germano_products((u, v, w), geom)
    lm = LM.double().sum(dim=(0, 2), keepdim=True).to(LM.dtype)
    mm = MM.double().sum(dim=(0, 2), keepdim=True).to(MM.dtype)
    return smag, lm, mm


def _germano_pass1_launch(u, v, w, *gs, geom):
    if u.device.type == "cpu":
        return germano_pass1_twin(u, v, w, geom=geom)
    return _germano_pass1_cuda(u, v, w, *gs, geom=geom)


def _germano_pass1_cuda(u, v, w, *gs, geom):
    x, y, z = geom.axes
    smag = torch.empty((x.n, y.n, z.n), dtype=u.dtype, device=u.device)
    lm, mm = (torch.empty((1, y.n, 1), dtype=u.dtype, device=u.device)
              for _ in range(2))
    # float64 partial plane sums of L:M and M:M, one a (plane, tile); the
    # kernel's source decides the tile count and checks the buffer against
    # it
    blocks = library().cfdnn_germano_pass1_blocks(x.n, z.n)
    partial = torch.empty((2, y.n, blocks), dtype=torch.float64,
                          device=u.device)
    _launch("germano_pass1", u,
            *(t.data_ptr() for t in (u, v, w, *gs, smag, partial, lm, mm)),
            x.n, y.n, z.n, int(y.bc == BCType.WALL), int(z.bc == BCType.WALL),
            blocks)
    germano_pass1.launches += 1
    return smag, lm, mm


def germano_pass1(u, v, w, gs, *, geom: Geometry):
    """Pass 1 of the dynamic Smagorinsky model: (|S| (Nx, Ny, Nz), the
    (x, z)-plane sums of L:M and M:M (1, Ny, 1)) with L_ij the
    test-filtered Leonard stress and M_ij = 3 Delta^2 |S| S_ij. The plane
    sums are taken in float64 in a fixed order, so a run repeats bit for
    bit. `gs` = les_arrays(geom). The kernel walks an (x, z) tile along y
    with 32-bit offsets: a face array past 2^31 - 1 elements raises
    ValueError (`tile_refusal`)."""
    _check_les("germano_pass1", u, v, w, gs, geom)
    why = tile_refusal("germano_pass1", geom.x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    return _ViaTwin.apply(_germano_pass1_launch, germano_pass1_twin,
                          dict(geom=geom), u, v, w, *gs)


germano_pass1.launches = 0


# ---------------------------------------------------------------------------
# predictor_general_xz  <-  pallas_kernels.fused_predictor_general_xz
# nu_sgs_xz             <-  pallas_kernels.fused_nu_sgs_xz
# divergence_xz         <-  pallas_kernels.fused_divergence_xz
# correct_xz            <-  pallas_kernels.fused_correct_xz
# ---------------------------------------------------------------------------
#
# The functions of predictor_general, nu_sgs, divergence and correct on an
# (x, z) tile walked along y (csrc/xz_tile.cuh), for the grids whose y-z
# planes the reference's TPU slab cannot hold (its "xz" plan; the
# Simulation's plan routes them as the reference does, solver.py). Their
# twins are the slab kernels' twins, the same functions, O2 or O4. Each
# shares its slab kernel's C interface and argument builder
# (`_general_call`, `_nu_sgs_call`, `_divergence_call`, `_correct_call`):
# at O4 the predictor launches its O4 variant (predictor_general_xz_o4,
# the O4 constants after the xz entry's arguments) and the projection
# kernels take mode 3 on each O4 axis, as the slab kernels do.


def xz_eligible(geom: Geometry) -> bool:
    """Gate of the xz kernels: the general predictor's grid with a
    periodic z (periodic uniform x with x.n >= 8 and z, y periodic
    uniform or no-slip walls at any stretching), O2 or O4; at O4 x and z
    O4 both (AxisGeom.o4_ok: periodic, uniform, n >= 4), as the O4
    variants take them."""
    return (_general_geom_ok(geom) and geom.axes[2].periodic
            and (geom.space_order == 2
                 or (geom.use_o4(0) and geom.use_o4(2))))


def nu_sgs_xz_eligible(geom: Geometry) -> bool:
    """Gate of nu_sgs_xz (`les_refusal`): the xz gate with stationary
    walls (the LES kernels' wall ghosts hardcode stationary no-slip)."""
    return les_refusal("nu_sgs_xz", geom) is None


LES_GATES["nu_sgs_xz"] = nu_sgs_xz_eligible



def _check_xz(name, geom, gate=xz_eligible):
    if not gate(geom):
        raise NotImplementedError(
            f"{name}: the (x, z)-tiled kernel serves a periodic uniform x "
            "(x.n >= 8) and z with y periodic uniform or walls, O2 or O4 "
            "(O4 on an x and a z of 4 cells or more); other grids take the "
            "slab kernels or the operators")


def _predictor_general_xz_launch(u, v, w, dt, nu_t=None, *, gs, geom, nu, fx,
                                 scheme):
    if u.device.type == "cpu":
        return predictor_general_twin(u, v, w, dt, nu_t, geom=geom, nu=nu,
                                      fx=fx, scheme=scheme)
    out = _general_call("predictor_general_xz", u, v, w, dt, nu_t, gs, geom,
                        nu, fx, scheme)
    predictor_general_xz.launches += 1
    return out


def predictor_general_xz(u, v, w, dt, gs, *, geom: Geometry, nu, fx, scheme,
                         nu_t=None):
    """`predictor_general` (the same function, arguments and twin) on the
    (x, z) tile: periodic uniform x and z, y periodic or no-slip (moving
    or not) at any stretching, O2 or O4, each of the four schemes (the O4
    variant's kernel, csrc/predictor_general_xz_o4.cuh, where
    predictor_general runs its own: at O4 and for upwind2). `gs` =
    general_arrays(geom)."""
    _check_xz("predictor_general_xz", geom)
    x, y, z = geom.axes
    extra = () if nu_t is None else (nu_t,)
    _check("predictor_general_xz", (u, v, w, dt, *extra, *gs),
           _face_shapes(geom) + ((),) + ((x.n, y.n, z.n),) * len(extra)
           + _general_array_shapes(geom))
    _check_geom("predictor_general_xz", geom, (u,))
    _scheme_code(scheme)
    kw = dict(gs=gs, geom=geom, nu=nu, fx=fx, scheme=scheme)
    return _ViaTwin.apply(_predictor_general_xz_launch,
                          _predictor_general_twin_gs, kw, u, v, w, dt, *extra)


predictor_general_xz.launches = 0


def _nu_sgs_xz_launch(u, v, w, *gs, geom, closure, coeff):
    if u.device.type == "cpu":
        return nu_sgs_twin(u, v, w, geom=geom, closure=closure, coeff=coeff)
    out = _nu_sgs_call("nu_sgs_xz", u, v, w, gs, geom, closure, coeff)
    nu_sgs_xz.launches += 1
    return out


def nu_sgs_xz(u, v, w, gs, *, geom: Geometry, closure: str, coeff: float):
    """`nu_sgs` (the same function, arguments and twin) on the (x, z) tile:
    periodic uniform x and z, y periodic or stationary walls. `gs` =
    les_arrays(geom)."""
    _closure_id(closure)   # raises on an unknown closure
    _check_xz("nu_sgs_xz", geom, nu_sgs_xz_eligible)
    _check_les("nu_sgs_xz", u, v, w, gs, geom)
    kw = dict(geom=geom, closure=closure, coeff=coeff)
    return _ViaTwin.apply(_nu_sgs_xz_launch, nu_sgs_twin, kw, u, v, w, *gs)


nu_sgs_xz.launches = 0


def _divergence_xz_launch(u, v, w, *, geom):
    if u.device.type == "cpu":
        return divergence_twin(u, v, w, geom=geom)
    out = _divergence_call("divergence_xz", u, v, w, geom)
    divergence_xz.launches += 1
    return out


def divergence_xz(u, v, w, *, geom: Geometry):
    """`divergence` (the same function and twin) on the (x, z) tile,
    O4 (f2c_diff4) along each Geometry.use_o4 axis."""
    _check_xz("divergence_xz", geom)
    _check("divergence_xz", (u, v, w), _face_shapes(geom))
    _check_geom("divergence_xz", geom, (u,))
    return _ViaTwin.apply(_divergence_xz_launch, divergence_twin,
                          dict(geom=geom), u, v, w)


divergence_xz.launches = 0


def _correct_xz_launch(u, v, w, p, dt, *, geom):
    if u.device.type == "cpu":
        return correct_twin(u, v, w, p, dt, geom=geom)
    out = _correct_call("correct_xz", u, v, w, p, dt, geom)
    correct_xz.launches += 1
    return out


def correct_xz(u, v, w, p, dt, *, geom: Geometry):
    """`correct` (the same function and twin) on the (x, z) tile, O4
    (c2f_diff4) along each Geometry.use_o4 axis."""
    _check_xz("correct_xz", geom)
    x, y, z = geom.axes
    _check("correct_xz", (u, v, w, p, dt),
           _face_shapes(geom) + ((x.n, y.n, z.n), ()))
    _check_geom("correct_xz", geom, (u,))
    return _ViaTwin.apply(_correct_xz_launch, correct_twin, dict(geom=geom),
                          u, v, w, p, dt)


correct_xz.launches = 0


# ---------------------------------------------------------------------------
# transport  <-  pallas_kernels.fused_transport_advance
# ---------------------------------------------------------------------------

# The kernel's three instantiations, by its MODEL template id
# (csrc/transport.cu): the SST advance (k_new, om_new), the same with the
# SST nu_t as a third output, and the Wilcox advance.
TRANSPORT_MODELS = {"sst": 0, "sst_nut": 1, "komega": 2}
# The kernel's structural gate is nu_sgs_eligible: both take the strain of
# csrc/les.cuh, whose wall ghosts hardcode stationary no-slip walls.


def transport_arrays(geom: Geometry):
    """The twelve 1-D metric vectors of the transport kernel, four per
    axis (x, y, z), as transport.py forms them from pos_c_pad:
      inv_d    (n)    1/cell width
      den_c    (n)    2-apart centre distance (central gradient, strain)
      dpos     (n+1)  centre spacing, ghost-aware (the upwind den_b and
                      den_f)
      inv_dpos (n+1)  1/dpos (operators._inv_dpos_c: the diffusion)
    """
    out = []
    for ax in geom.axes:
        pc = ax.pos_c_pad.reshape(-1)
        dpos = pc[1:] - pc[:-1]
        out += [ax.inv_d.reshape(-1), pc[2:] - pc[:-2], dpos, 1.0 / dpos]
    return tuple(t.contiguous() for t in out)


def _transport_array_shapes(geom: Geometry):
    return tuple(s for ax in geom.axes
                 for s in ((ax.n,), (ax.n,), (ax.n + 1,), (ax.n + 1,)))


def _transport_params(model, c, nu, om_wall):
    """The kernel's constants (csrc/transport.cu, enum P_*), each product
    formed here in double as the twin forms it in Python. Wilcox's
    constants take the SST slots of the first set (sigma_k1, sigma_omega1,
    alpha1, beta1)."""
    two_om_wall = 0.0 if om_wall is None else 2.0 * om_wall
    if model == "komega":
        blend = (0.0, c.beta_star, 0.0, 0.0, 0.0, c.beta, 0.0, c.alpha, 0.0,
                 c.sigma_k, 0.0, c.sigma_omega, 0.0)
        closure = (0.0, 0.0)
    else:
        blend = (c.CD_omega_min, c.beta_star, 2.0 * c.sigma_omega2,
                 500.0 * nu, 4.0 * c.sigma_omega2, c.beta1, c.beta2,
                 c.alpha1, c.alpha2, c.sigma_k1, c.sigma_k2, c.sigma_omega1,
                 c.sigma_omega2)
        closure = (c.a1, 1000.0 * nu)
    return ((nu, two_om_wall, c.k_min, c.omega_min) + blend
            + (10.0 * c.beta_star, c.k_max, c.omega_max) + closure)


def transport_twin(u, v, w, k, om, nu_t, dt, *consts, geom, model, c, nu,
                   om_wall):
    """Plain twin of `transport`: the port's turbulence/transport.py math
    on whole arrays (sst_advance_math, sst_with_nut_math,
    komega_advance_math), the constants as the kernel takes them, (1, Ny,
    Nz): y_wall [, pin mask, om_visc]."""
    from ..turbulence import transport as tr   # transport imports this module
    comps, y_wall = (u, v, w), consts[0]
    if model == "komega":
        return tr.komega_advance_math(comps, k, om, nu_t, geom, nu, c,
                                      y_wall, om_wall, dt)[:2]
    if model == "sst":
        return tr.sst_advance_math(comps, k, om, nu_t, geom, nu, c, y_wall,
                                   om_wall, dt)[:2]
    pin, om_visc = consts[1:] if len(consts) == 3 else (None, None)
    return tr.sst_with_nut_math(comps, k, om, nu_t, geom, nu, c, y_wall,
                                om_wall, dt, pin, om_visc)


def _transport_twin_gs(*tensors, gs, **kw):
    # the twin as _ViaTwin's backward calls it: the metric vectors are the
    # kernel's, the twin reads `geom`
    return transport_twin(*tensors, **kw)


def _transport_launch(u, v, w, k, om, nu_t, dt, *consts, gs, **kw):
    if u.device.type == "cpu":
        return transport_twin(u, v, w, k, om, nu_t, dt, *consts, **kw)
    return _transport_cuda(u, v, w, k, om, nu_t, dt, *consts, gs=gs, **kw)


def _transport_cuda(u, v, w, k, om, nu_t, dt, *consts, gs, geom, model, c,
                    nu, om_wall):
    outs = [torch.empty_like(k) for _ in range(3 if model == "sst_nut"
                                               else 2)]
    pin, om_visc = consts[1:] if len(consts) == 3 else (None, None)
    x, y, z = geom.axes
    # host arrays, read by the launcher: the twelve metric pointers and the
    # constants
    metrics = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in gs))
    vals = _transport_params(model, c, nu, om_wall)
    params = (ctypes.c_double * len(vals))(*vals)
    nut_out = outs[2] if len(outs) == 3 else None
    _launch("transport", k,
            *(t.data_ptr() for t in (u, v, w, k, om, nu_t, dt, consts[0])),
            *(None if t is None else t.data_ptr()
              for t in (pin, om_visc, outs[0], outs[1], nut_out)),
            ctypes.cast(metrics, ctypes.c_void_p),
            ctypes.cast(params, ctypes.c_void_p),
            x.n, y.n, z.n, int(y.bc == BCType.WALL), int(z.bc == BCType.WALL),
            TRANSPORT_MODELS[model])
    transport.launches += 1
    return tuple(outs)


def transport(u, v, w, k, om, nu_t, dt, consts, gs, *, geom: Geometry,
              model: str, c, nu: float, om_wall: Optional[float]):
    """The k-omega point-implicit advance (k_new, om_new), before the clip
    and pin epilogue, of SST (`model` "sst"), of SST with its eddy
    viscosity as a third output ("sst_nut": nu_t of the clipped and
    pinned values) or of Wilcox ("komega"), from the cell fields k, om,
    nu_t (Nx, Ny, Nz) and the velocity. `consts`: the per-cell constants
    (1, Ny, Nz), y_wall, and with a wall the pin mask and om_visc; `c`:
    SSTConstants or KOmegaConstants; `om_wall`: omega's wall value (None
    without a wall); dt: a 0-d tensor; `gs` = transport_arrays(geom). The
    kernel walks an (x, z) tile along y with 32-bit offsets: a face array
    past 2^31 - 1 elements raises ValueError (`tile_refusal`)."""
    if model not in TRANSPORT_MODELS:
        raise ValueError(f"transport: model {model!r}; one of "
                         f"{sorted(TRANSPORT_MODELS)}")
    if not nu_sgs_eligible(geom):
        raise NotImplementedError(
            "transport: the kernel serves a periodic uniform x with y and z "
            "periodic uniform or stationary walls, 3-D (a moving wall is "
            "queued under ROADMAP B.4; the reference fuses no transport on "
            "a 2-D grid)")
    if len(consts) not in (1, 3):
        raise ValueError(f"transport: {len(consts)} constants; y_wall, or "
                         "y_wall, the pin mask and om_visc")
    x, y, z = geom.axes
    cell, plane = (x.n, y.n, z.n), (1, y.n, z.n)
    _check("transport", (u, v, w, k, om, nu_t, dt, *consts, *gs),
           _face_shapes(geom) + (cell,) * 3 + ((),) + (plane,) * len(consts)
           + _transport_array_shapes(geom))
    why = tile_refusal("transport", x.n,
                       max(math.prod(s) for s in _face_shapes(geom)))
    if why:
        raise ValueError(why)
    kw = dict(gs=gs, geom=geom, model=model, c=c, nu=nu, om_wall=om_wall)
    return _ViaTwin.apply(_transport_launch, _transport_twin_gs, kw,
                          u, v, w, k, om, nu_t, dt, *consts)


transport.launches = 0


# ---------------------------------------------------------------------------
# fht_pass   <-  poisson/pallas_fht.fht_pallas
# fht_modal  <-  poisson/pallas_fht.fht_pallas_modal
# ---------------------------------------------------------------------------


class _NoGrad(torch.autograd.Function):
    """Forward: `launch` (the kernel on CUDA, the twin on the CPU).
    Backward: raises. The reference has no gradient through its Hartley
    transform (a grad "fails loudly with 'no AD rule for pallas_call'",
    cfdnn_tpu/ml/adjoint.py:50-53), so neither has the port."""

    @staticmethod
    def forward(ctx, launch, name, kw, *tensors):
        ctx.name = name
        return launch(*tensors, **kw)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.name}: no gradient through the Hartley transform (the "
            "reference has no AD rule for its pallas_call either); solve "
            "with poisson_transform 'fft' or 'matmul' to differentiate")


def _fht_check(name, f, axis, t, extra=(), extra_shapes=()):
    """Shape, axis, dtype, device and contiguity of a Hartley pass, and on
    CUDA the kernel's own limits (raising where it refuses the split)."""
    if axis not in (0, 1, 2) or f.ndim != 3:
        raise ValueError(f"{name}: axis {axis} of a tensor of shape "
                         f"{tuple(f.shape)}; a 3-D tensor and axis 0, 1 or 2")
    if f.shape[axis] != t.N:
        raise ValueError(f"{name}: axis {axis} has length {f.shape[axis]}, "
                         f"the transform {t.N}")
    _check(name, (f, t.table, *extra),
           (None, (2 * t.N2 + 2 * t.N + 128,), *extra_shapes))
    if f.device.type == "cuda" and not library().cfdnn_fht_tile(
            t.N1, t.N2, f.element_size()):
        raise NotImplementedError(
            f"{name}: the kernel takes N1 <= 8 and N2 = r * 2^m with r in "
            f"(1, 3, 5, 7), m >= 3 and N2 <= 4096 (every split the solver "
            f"chooses: N2 in 32 ... 256), whose block fits (N1 = {t.N1}, "
            f"N2 = {t.N2})")


def _fht_lines(f, axis, t):
    """(inner, nlines): the stride between a line's points and the number
    of lines of a pass along `axis` of the contiguous `f`."""
    inner = 1
    for s in f.shape[axis + 1:]:
        inner *= s
    return inner, f.numel() // t.N


def _fht_pass_launch(f, *, axis, t, inverse):
    from ..poisson.pallas_fht import fht_pass_twin
    if f.device.type == "cpu":
        return fht_pass_twin(f, axis, t, inverse)
    return _fht_pass_cuda(f, axis=axis, t=t, inverse=inverse)


def _fht_pass_cuda(f, *, axis, t, inverse):
    out = torch.empty_like(f)
    inner, nlines = _fht_lines(f, axis, t)
    _launch("fht_pass", f, f.data_ptr(), out.data_ptr(), t.table.data_ptr(),
            t.N1, t.N2, inner, nlines, int(inverse))
    fht_pass.launches += 1
    return out


def fht_pass(f, axis: int, t, *, inverse: bool = False):
    """One four-step Hartley pass along `axis` of the contiguous 3-D `f`:
    the forward transform in the digit-permuted order, or the
    unnormalized inverse (forward then inverse gives N times f). `t`: a
    poisson.pallas_fht.PFHTAxis of f's length along `axis`, dtype and
    device."""
    _fht_check("fht_pass", f, axis, t)
    return _NoGrad.apply(_fht_pass_launch, "fht_pass",
                         dict(axis=axis, t=t, inverse=bool(inverse)), f)


fht_pass.launches = 0


def _fht_modal_launch(f, lam_axis, lam_rest, *, axis, t, thr, norm):
    from ..poisson.pallas_fht import fht_modal_twin
    if f.device.type == "cpu":
        return fht_modal_twin(f, axis, t, lam_axis, lam_rest, thr=thr,
                              norm=norm)
    return _fht_modal_cuda(f, lam_axis, lam_rest, axis=axis, t=t, thr=thr,
                           norm=norm)


def _fht_modal_cuda(f, lam_axis, lam_rest, *, axis, t, thr, norm):
    out = torch.empty_like(f)
    inner, nlines = _fht_lines(f, axis, t)
    _launch("fht_modal", f,
            *(a.data_ptr() for a in (f, out, t.table, lam_axis, lam_rest)),
            t.N1, t.N2, inner, nlines, float(thr), float(norm))
    fht_modal.launches += 1
    return out


def fht_modal(f, axis: int, t, lam_axis, lam_rest, *, thr: float,
              norm: float):
    """The Poisson solve's modal pass along `axis` (the last Hartley axis)
    of the contiguous 3-D `f`: the forward pass, each mode times
    norm / (lam_axis + lam_rest) with |lam_axis + lam_rest| < thr pinned to
    0, then the unnormalized inverse. lam_axis: (N,) in the
    digit-permuted order; lam_rest: f's shape without `axis`, the other
    axes' symbols summed in their own orders; `norm` carries every 1/N of
    the solve."""
    rest = tuple(s for a, s in enumerate(f.shape) if a != axis)
    _fht_check("fht_modal", f, axis, t, (lam_axis, lam_rest),
               ((t.N,), rest))
    return _NoGrad.apply(_fht_modal_launch, "fht_modal",
                         dict(axis=axis, t=t, thr=float(thr),
                              norm=float(norm)),
                         f, lam_axis, lam_rest)


fht_modal.launches = 0


KERNELS = (predictor_periodic, predictor_channel, predictor_general,
           divergence, correct, nu_sgs, germano_pass1, transport,
           predictor_periodic_div, predictor_channel_div, fht_pass,
           fht_modal, predictor_general_xz, nu_sgs_xz, divergence_xz,
           correct_xz)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def add_launches(counts: dict, times: int = 1, nodes: int = 0) -> None:
    """Add `times` x counts[name] to each named kernel's count, and times x
    nodes to the kernel nodes replayed (`replayed_nodes`): a replay of a
    captured CUDA graph launches the kernels the graph holds without
    calling their wrappers (solver.Simulation._capture counts them by name
    in the graph, `device_launches`; times=-1 takes a capture's wrapper
    counts off, since a capture launches nothing)."""
    for k in KERNELS:
        k.launches += times * counts.get(k.__name__, 0)
    _REPLAYED[0] += times * nodes


_REPLAYED = [0]


def replayed_nodes() -> int:
    """Kernel nodes (the port's and the libraries') of the CUDA graphs
    replayed so far: what a profiler window over those replays must
    record (bench.profiled)."""
    return _REPLAYED[0]


# Each wrapper's device kernels by symbol, one launch of each a call: the
# name in the mangled symbol a CUDA graph lists (`_ZN..17divergence_kernelI
# fE...`) and in the demangled one torch.profiler records (`void (anonymous
# namespace)::divergence_kernel<float>(...)`). fht_pass and fht_modal share
# fht_kernel<T, MODE, N2C>, told apart by MODE (fht.cuh: kForward 0,
# kInverse 1, kModal 2); germano_pass1 launches two kernels a call.
_FHT = r"fht_kernel(?:I[fd]Li|<(?:float|double), ?)"
_SYMBOLS = tuple((name, re.compile(r"(?<![A-Za-z_])" + pattern))
                 for name, pattern in (
    ("predictor_periodic", r"predictor_periodic_tile_kernel"),
    ("predictor_periodic_div", r"predictor_periodic_div_tile_kernel"),
    ("predictor_channel", r"predictor_channel_tile_kernel"),
    ("predictor_channel_div", r"predictor_channel_div_tile_kernel"),
    ("predictor_general", r"predictor_general(?:_o4)?_kernel"),
    ("divergence", r"divergence_kernel"),
    ("correct", r"correct_kernel"),
    ("nu_sgs", r"nu_sgs_tile_kernel"),
    ("germano_pass1", r"germano_cells_kernel"),
    ("germano_pass1", r"germano_rows_kernel"),
    ("transport", r"transport_tile_kernel"),
    ("fht_pass", _FHT + r"[01](?!\d)"),
    ("fht_modal", _FHT + r"2(?!\d)"),
    ("predictor_general_xz", r"predictor_general_xz(?:_o4|_wide)?_kernel"),
    ("nu_sgs_xz", r"nu_sgs_xz_kernel"),
    ("divergence_xz", r"divergence_xz_kernel"),
    ("correct_xz", r"correct_xz_kernel")))


def device_launches(records) -> dict:
    """{wrapper name: launches} of the port's kernels among device kernel
    records, an iterable of (symbol, count): a CUDA graph's kernel nodes
    (count 1 each) or a profiler window's kernels. A wrapper that launches
    several kernels a call counts the calls whose every kernel is there
    (the fewest of its kernels' counts); every other symbol (library and
    torch kernels) counts for none."""
    per = {}
    for symbol, count in records:
        for i, (_, pattern) in enumerate(_SYMBOLS):
            if pattern.search(symbol):
                per[i] = per.get(i, 0) + count
                break
    out = {}
    for i, (name, _) in enumerate(_SYMBOLS):
        n = per.get(i, 0)
        out[name] = min(out.get(name, n), n)
    return {k: n for k, n in out.items() if n}


# a kernel node of a CUDA graph's DOT dump (cudaGraphDebugDotPrint,
# verbose): its label's type and, for a kernel, its mangled symbol
_DOT_KERNEL = re.compile(r'label="\{\s*KERNEL\s*\|\s*\{\s*ID\s*\|[^|]*\|\s*'
                         r'([^\s\\<|]+)')


def dot_kernel_symbols(dot: str) -> list:
    """The symbols of a CUDA graph's kernel nodes, one a node, from the
    graph's DOT dump (torch.cuda.CUDAGraph.debug_dump); copy and memset
    nodes are not kernels."""
    return _DOT_KERNEL.findall(dot)
