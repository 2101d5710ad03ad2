"""Fractional-step incompressible Navier-Stokes solver (port of
`cfdnn_tpu/solver.py`).

One step is the turbulence closure's advance (the k-omega transport of
the RANS closures, its y diffusion implicit under implicit y-diffusion)
and nu_t -> dt (fixed, or the adaptive CFL and diffusion limit) -> the
time integrator: forward Euler, or RK2/RK3 (SSP) with a projection after
every stage. A stage is predictor (the body force -dp/dx, with the force
ramp and the bulk-velocity controller) -> the convective outlet -> BC
(the inflow pin) -> implicit y-diffusion (batched Thomas solves) and BC ->
IBM forcing -> the outlet's flux anchor -> divergence -> direct FDM
Poisson solve (rhs masked in the solid with IBM) -> pressure correction
-> IBM forcing -> BC. The per-step
work on CUDA goes through the hand-written kernels of `ops/kernels.py`.
dt is a 0-d tensor on the device, the kernels read it through a pointer,
and nothing in a step reads it (or any other device value) on the host.
Where the reference jits the step and scans n of them (`lax.scan`), the
port's `run` on a CUDA device replays the step captured in CUDA graphs
(`torch.cuda.CUDAGraph`, chunks of GRAPH_CHUNK steps); on the CPU, for a
state that requires grad and with CFDNN_POISSON_DIAGNOSTICS it runs the
same step in a plain Python loop (`run`).

Kernel dispatch is explicit (`Simulation.kernels`). On CUDA with
use_pallas "auto" or "on" the plan first takes the reference's tiling mode
(`tiling_mode`, its _pallas_eligible): "slab" where its TPU slab block
holds a y-z plane (`slab_fits`), "xz" above that on a periodic uniform z
that tiles (`xz_tileable`; at a halo of 2 at O4 and under upwind2), and
no kernel at all where neither holds or where x is not uniform with
x.n >= 8 on a 3-D grid. Every convective scheme takes the same modes, but
for a non-periodic x under upwind2 (the reference's xpad gate refuses
it). In "xz" the step runs predictor_general_xz (laminar or LES,
periodic or walled y), divergence_xz and correct_xz, O2 or O4 (their O4
variants at space_order=4, as the reference runs its xz kernels at a halo
of 2), and nu_sgs_xz for
Smagorinsky, WALE and Vreman; dynamic Smagorinsky and the k-omega
transport run their plain chains there, as in the reference. The LES
closures follow the reference's own LES gate (turbulence/les.py:37-64,
`les_tiling`), which tiles at a halo of 1 at every order: at O4 an x with
no divisor between 2 and the block cap (a prime Nx) gives the predictor no
tiling and no kernel, while nu_sgs_xz still serves the closure. In "slab",
in the reference's order (cfdnn_tpu/solver.py :783-827),
  - predictor_periodic when the grid is all-periodic uniform, 3-D, O2
    skew with no turbulence closure (the reference's fused_predictor; an
    O4 grid takes predictor_general);
  - else predictor_channel when `channel_slab_eligible` holds, with the
    closure's nu_t as its cell-viscosity operand;
  - else predictor_general when `general_eligible` holds: any periodic or
    wall y and z, moving walls, the closure's nu_t, every scheme (an
    all-periodic LES run, the duct, the lid channel, every O4 slab grid,
    every upwind and upwind2 grid); predictor_xpad, the same kernel on a
    ghost-padded axis, for a uniform no-slip, inflow/outflow or outflow x
    at O2, upwind2 excepted (`xpad_eligible`);
  - divergence and correct whenever x is periodic and uniform (a
    non-periodic x runs the eager projection);
  - nu_sgs for Smagorinsky, WALE and Vreman, germano_pass1 for dynamic
    Smagorinsky, each where its own gate (`ops.kernels.LES_GATES`) holds
    behind the reference's LES gate (`les_tiling`: a periodic x; Sigma
    runs plain, as in the reference);
  - transport for the k-omega advance of SST (with its nu_t), Wilcox and
    the EARSM trio, where `nu_sgs_eligible` holds and the predictor is
    "channel" or "general" (the reference's single-device slab mode: never
    with "xpad"). The mixing-length and GEP closures run plain.
Under implicit y-diffusion there is no mode, so no predictor or projection
kernel (the LES closures keep their own gate; transport runs plain); under
a force ramp or bulk-velocity control the predictor runs plain and the
projection keeps its kernels, as the reference's.
With CFDNN_FUSE_DIV=1 in the environment at construction (the reference's
opt-in, solver.py:116-159), the first predictor of each step is the
predictor + divergence kernel of the plan's predictor, predictor_periodic_div
or predictor_channel_div, and that stage's projection launches no
divergence (`Simulation._fuse_div`); every other plan, and any plan with an
immersed body, runs unfused.
use_pallas="off" runs the eager operator chain, "auto" off CUDA too (the
reference's "auto" resolves to its operators off an accelerator), and
"on" runs the kernels' wrappers on any device (on the CPU they take the
plain twins, as the reference's "on" runs Pallas in interpret mode). "on"
raises when no ported kernel serves the config's predictor (a 2-D grid,
for one; not where the reference's predictor is plain by design:
implicit y-diffusion, a force ramp, bulk control) or a closure that the
reference's own closure gate would fuse.

Everything outside the port so far raises NotImplementedError naming the
ROADMAP item that brings it (`_check_supported`); no Config field is
ignored.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import warnings
import weakref
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .config import (BCType, Config, ConvectiveScheme, PoissonSolverType,
                     TimeIntegrator, TurbulenceModel)
from .fields import _STATE_KEYS, State, velocity_shapes, zero_state
from .forcing import implicit_y_diffusion
from .mesh import Mesh
from .ops import kernels
from .ops import operators as ops
from .ops.bc import apply_velocity_bc
from .ops.grid import Geometry
from .poisson.fdm import FDMPoissonSolver
from .turbulence import create_turbulence_model


@dataclasses.dataclass(frozen=True)
class StepDiagnostics:
    """Per-step scalars returned alongside the new state (0-d tensors on
    the state's device; zeros for the steps a benchmark-mode run takes
    without diagnostics)."""

    residual: torch.Tensor     # max |u - u_old|
    div_linf: torch.Tensor     # post-projection max |div u| (IBM: fluid)
    dt: torch.Tensor
    ke: torch.Tensor           # volume-averaged kinetic energy
    nan_flag: torch.Tensor
    fx: torch.Tensor           # the immersed body's force sums of the
    fy: torch.Tensor           # step (IBMForcing.apply, weighted by each
    fz: torch.Tensor           # stage's share); 0 with no body


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Which hand-written kernels a Simulation's step launches."""

    # "periodic" | "channel" | "general" | "xpad" | "general_xz" | None
    # (eager)
    predictor: Optional[str]
    # "slab" (divergence + correct) | "xz" (divergence_xz + correct_xz) |
    # None (eager)
    projection: Optional[str]
    # "nu_sgs" | "nu_sgs_xz" | "germano_pass1" | "transport" | None
    closure: Optional[str] = None


# The reference plans its TPU kernels around VMEM: its slab kernels hold
# whole y-z planes, so above a plane size it tiles x and z instead ("xz"),
# and where neither fits it runs no kernel. The port's kernels have no
# such limit (its slab kernels run on any plane), but the port routes as
# the reference does, so that a config launches the counterparts of the
# reference's kernels. These copies of the reference's fit and tiling
# predicates exist only for that routing: no kernel of the port reads a
# block size, a VMEM budget or a compiler parameter.

# cfdnn_tpu/ops/pallas_kernels.py _SLAB_FIT_CELLS: the cells of the
# smallest slab block (ng planes) the raised VMEM cap holds
SLAB_FIT_CELLS = 6 * 256 * 256
# pallas_kernels.py _XZ_BUDGET_CELLS: the xz block budget of _auto_bxz
_XZ_BUDGET_CELLS = 2 * 512 * 128

# Steps one captured CUDA graph holds. The graph reads its input State from
# fixed buffers and ends with one copy of its last step's State back into
# them, so `run` replays chunks of this many steps and copies the state
# once a chunk (u, v, w, p read and written: 67 MB at 128^3 float32, ~11%
# of a step's device time at every width). Two buffers taking turns would
# not save the copy: the step allocates its outputs, so no graph can write
# its last State into the other buffer. Timed on the H100 against 1, 2 and
# 8 steps (PERF.md: `python -m cfdnn_tpu_torch.path_ab` on two copies of
# the package that differ only here).
GRAPH_CHUNK = 16


def graph_kernel_symbols(graph) -> list:
    """The symbols of an instantiated torch.cuda.CUDAGraph's kernel nodes
    (one a node), from its DOT dump (`debug_dump`, which needs a graph
    made with keep_graph=True and frees the graph's node list after it;
    the instantiated graph replays on)."""
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        # debug_dump announces itself with a warning
        warnings.simplefilter("ignore")
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            return kernels.dot_kernel_symbols(f.read())


def _identity(state: State, members) -> tuple:
    """(weak reference, version) of each of `state`'s member tensors, for
    `_same_tensors`."""
    return tuple((weakref.ref(t), t._version)
                 for t in (getattr(state, k) for k in members))


def _same_tensors(identity, state: State, members) -> bool:
    """Whether `state`'s members are the tensors `identity` was taken of,
    none of them written since (torch bumps a tensor's version at every
    in-place write)."""
    return identity is not None and all(
        ref() is t and t._version == version
        for (ref, version), t in zip(identity,
                                     (getattr(state, k) for k in members)))


def slab_fits(geom) -> bool:
    """The reference's slab_fits (pallas_kernels.py:229-235): whether its
    smallest slab block, ng y-z planes (ng = 2 at O4, else 1), fits under
    SLAB_FIT_CELLS. Read at each call, so a test may lower the cap."""
    ng = 2 if geom.space_order >= 4 else 1
    return ng * geom.axes[1].n * geom.axes[2].n <= SLAB_FIT_CELLS


def xz_tileable(nx: int, ny: int, nz: int, ng: int = 1) -> bool:
    """Whether the reference's _auto_bxz (pallas_kernels.py:772-789) finds
    an (x, z) tiling of an (nx, ny, nz) grid with halo ng: a z block of
    128, 256, 64, 512 or 32 that divides nz, and an x block between ng and
    8, within the block budget, that divides nx."""
    bz = next((b for b in (128, 256, 64, 512, 32) if nz % b == 0 and b <= nz),
              0)
    if bz == 0:
        return False
    cap = max(ng, _XZ_BUDGET_CELLS // max(ny * bz, 1))
    bx = min(8, cap)
    while bx > ng and nx % bx != 0:
        bx -= 1
    return nx % bx == 0


def tiling_mode(geom: Geometry, cfg: Config) -> Optional[str]:
    """The reference's single-device tiling mode (its _pallas_eligible,
    cfdnn_tpu/solver.py:297-411) for what the port serves (O2 or O4, each
    of the four convective schemes): None under implicit y-diffusion (its
    shared gate, :342) and unless x is uniform with x.n >= 8 and the grid
    is 3-D; then on a non-periodic x (wall, or the inflow/outflow pair, or
    outflow) "slab" at O2 but under upwind2 where the slab block fits (the
    reference's ghost-padded "xpad" slab, :363-385: its one-cell ghost
    ring is short of upwind2's reach); on a periodic x "slab" where the
    slab block fits (slab_fits), else "xz" where z is periodic uniform and
    the grid tiles (xz_tileable at a halo of 2 at O4 or under upwind2,
    else 1: :405-410), else None. A force ramp and bulk-velocity control
    leave the mode as it is: the step then runs its predictor plain and
    keeps the projection kernels, as the reference's _euler_substep
    (:688-690)."""
    x, y, z = geom.axes
    if cfg.implicit_y_diffusion or not (x.uniform and z.n > 1
                                        and x.n >= 8):
        return None
    upwind2 = cfg.convective_scheme == ConvectiveScheme.UPWIND2
    if not x.periodic:
        return ("slab" if x.bc in (BCType.WALL, BCType.INFLOW,
                                   BCType.OUTFLOW)
                and cfg.space_order == 2 and not upwind2
                and slab_fits(geom) else None)
    if slab_fits(geom):
        return "slab"
    ng = 2 if cfg.space_order >= 4 or upwind2 else 1
    if z.periodic and z.uniform and xz_tileable(x.n, y.n, z.n, ng):
        return "xz"
    return None


def les_tiling(geom: Geometry) -> Optional[str]:
    """The reference's LES tiling mode (its LESModelBase._fuse,
    cfdnn_tpu/turbulence/les.py:37-64, single device): None unless x is
    periodic and uniform with x.n >= 8 on a 3-D grid; then "slab" where the
    slab block fits (slab_fits), else "xz" on a periodic uniform z that
    tiles at a halo of 1 (xz_tileable: its nu_sgs_xz reaches one cell at
    every order), else None. On a periodic x it differs from
    `tiling_mode` only at O4, where the predictor's tiling takes a halo
    of 2."""
    x, y, z = geom.axes
    if not (x.periodic and x.uniform and x.n >= 8 and z.n > 1):
        return None
    if slab_fits(geom):
        return "slab"
    if z.periodic and z.uniform and xz_tileable(x.n, y.n, z.n):
        return "xz"
    return None


def _check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for every config the port does not serve
    yet, naming the ROADMAP item that brings it."""
    n_dev = 1
    for d in (cfg.mesh_shape or (1,)):
        n_dev *= int(d)
    unsupported = [
        (cfg.trip_enabled, "trip_enabled=True", "A.14 (trip forcing)"),
        (cfg.recycling_inflow, "recycling_inflow=True",
         "A.14 (recycling inflow)"),
        (cfg.filter_strength > 0.0, f"filter_strength={cfg.filter_strength}",
         "A.14 (velocity filter)"),
        # the inflow/outflow pair is an x boundary; an open y or z runs
        # OUTFLOW ghosts that no kernel of the port has
        (any(b in (BCType.INFLOW, BCType.OUTFLOW)
             for b in (cfg.bc_y, cfg.bc_z)),
         "an inflow or outflow y or z boundary",
         "B.3 (an OUTFLOW y or z on a periodic x)"),
        (n_dev > 1, f"mesh_shape={tuple(cfg.mesh_shape)}",
         "A.17 (multi-device)"),
        (cfg.poisson_solver == PoissonSolverType.MG, "poisson_solver=mg",
         "A.13 (multigrid)"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what}: not in the port yet; ROADMAP {item}")
    if cfg.use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"use_pallas={cfg.use_pallas!r} — expected "
                         "'auto' | 'on' | 'off'")


class Simulation:
    """Owns mesh/config/geometry/Poisson operator and the step, on one
    explicit torch device."""

    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None, *, device):
        cfg = cfg.finalize()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh or Mesh.from_config(cfg)
        self.geom = Geometry.make(self.mesh, cfg, device=self.device)
        self.dtype = self.geom.dtype
        self.poisson = self._make_poisson()
        self.poisson_selection_reason = self.poisson.name
        self.turb = create_turbulence_model(cfg, self.mesh, self.geom)
        self._dt = torch.full((), cfg.dt, dtype=self.dtype, device=self.device)
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)
        self._fx = float(-cfg.dp_dx / cfg.rho)
        # the reference's _yz_area_weights (solver.py:229-237): the
        # normalized (y, z) cell areas, the measure of the bulk velocity
        # and of the inflow/outflow pair's plane fluxes
        wy = self.geom.y.d.reshape(-1, 1)
        wz = self.geom.z.d.reshape(1, -1)
        w = wy * wz
        self._yz_w = w / torch.sum(w)
        # the inflow/outflow pair: the convective outlet (an opt-in, the
        # reference's _convective_out) and the inflow profile that
        # `initialize` captures (u, v, w at the inlet; None before it)
        self._inflow = cfg.bc_x == BCType.INFLOW
        self._convective_out = self._inflow and cfg.convective_outflow
        self._inflow_profile = None
        self.ibm = None
        # the reference reads its fused-divergence opt-in at construction
        self._fuse_div_requested = os.environ.get("CFDNN_FUSE_DIV") == "1"
        # and its per-solve residual print (cfdnn_tpu/solver.py:632-640)
        self._poisson_diagnostics = bool(
            os.environ.get("CFDNN_POISSON_DIAGNOSTICS"))
        # the CUDA graphs of `run`: one capture stream and memory pool
        # (made at the first capture), the graphs' fixed input buffers by
        # the State members present, the graphs by (members, diagnostics,
        # steps)
        self._graph_stream = self._graph_pool = None
        self._graph_io = {}
        self._graphs = {}
        # by members: the _identity of the State the buffers hold (the last
        # graphed run's result)
        self._graph_holds = {}
        self._plan()
        self._dt_limits = self._adaptive_dt_limits() if cfg.adaptive_dt \
            else None

    def _plan(self) -> None:
        """Select the kernel plan, the fused-divergence mode and the
        kernels' geometry vectors (again after an immersed body is
        attached, which also drops the CUDA graphs captured before)."""
        self._graphs.clear()
        self.kernels = self._select_kernels()
        self._fuse_div = self._fuse_div_mode()
        pred = self.kernels.predictor
        self._channel_ys = (kernels.channel_y_arrays(self.geom)
                            if pred == "channel" else None)
        # the general kernel's grid (xpad: the ghost-padded periodic x)
        # and its metric vectors
        self._gen_geom = self._gen_arrays = None
        if pred in ("general", "xpad", "general_xz"):
            self._gen_geom = (kernels.xpad_geometry(self.geom)
                              if pred == "xpad" else self.geom)
            self._gen_arrays = kernels.general_arrays(self._gen_geom)
        # the closure kernel's geometry vectors (ops.kernels.les_arrays,
        # transport_arrays)
        closure = self.kernels.closure
        self.les_arrays = (kernels.les_arrays(self.geom)
                           if closure in kernels.LES_GATES else None)
        self.transport_arrays = (kernels.transport_arrays(self.geom)
                                 if closure == "transport" else None)

    def _fuse_div_mode(self):
        """The reference's _fuse_div_eligible (solver.py:116-159) keyed to
        this Simulation's own kernel plan: with CFDNN_FUSE_DIV=1 at
        construction, "periodic" or "channel" where the plan's predictor is
        that kernel (with or without nu_t), False otherwise and always
        with an immersed body. The reference's gate also excludes the
        inflow/outflow pair, its convective outlet and implicit
        y-diffusion (solver.py:144-147); keyed to the plan, these are off
        the fused paths by the plan's gates: an inflow or outflow x has no
        periodic or channel predictor (the xpad predictor has no div
        kernel), and implicit y-diffusion has no predictor kernel at all
        (`tiling_mode` gives no mode), nor has a force ramp or
        bulk-velocity control (the reference's plain predictor, whose
        projection takes its divergence). Trip and recycling are refused
        by _check_supported. (The reference's gate also says "periodic"
        for an all-periodic LES run, whose predictor has no div kernel,
        and then fails its assert; keyed to the plan, the port runs that
        case unfused.) Each div
        kernel walks its predictor's tile and refuses what that tile
        refuses (`kernels.tile_refusal`: nx < 8 for the channel, 32-bit
        offsets), so the fused mode takes every grid the plan's predictor
        takes (a plan needs x.n >= 8: `tiling_mode`)."""
        if not self._fuse_div_requested or self.ibm is not None:
            return False
        pred = self.kernels.predictor
        return pred if pred in ("periodic", "channel") else False

    def _adaptive_dt_limits(self):
        """The geometric factors of the adaptive dt as host floats, once:
        CFL times the x spacing and the minimum y and z spacings (the
        spacings in the working dtype, as the device vectors hold them),
        the explicit diffusion limit's sum of 1/h^2, and that limit for
        the scalar nu as a 0-d device tensor."""
        cfg, mesh = self.cfg, self.mesh
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype

        def d_min(ax):
            return float(np.min(np.asarray(ax.d).astype(np_dtype)))

        x_h = self.geom.x.h
        cfl_z = cfg.CFL_xz * d_min(mesh.z) if mesh.Nz > 1 else None
        inv_h2 = 1.0 / x_h ** 2
        # implicit y-diffusion takes y out of the explicit diffusion limit
        # (the reference's solver.py:943-947)
        if not cfg.implicit_y_diffusion:
            inv_h2 = inv_h2 + 1.0 / d_min(mesh.y) ** 2
        if mesh.Nz > 1:
            inv_h2 = inv_h2 + 1.0 / d_min(mesh.z) ** 2
        # the diffusion limit of scalar nu, a device constant
        dt_visc = torch.full((), 0.25 / (cfg.nu * inv_h2), dtype=self.dtype,
                             device=self.device)
        return (cfg.CFL_xz * x_h, cfg.CFL_max * d_min(mesh.y), cfl_z, inv_h2,
                dt_visc)

    def _make_poisson(self):
        cfg = self.cfg
        try:
            return FDMPoissonSolver(self.mesh, cfg, geom=self.geom,
                                    device=self.device)
        except ValueError as e:
            if cfg.poisson_solver != PoissonSolverType.AUTO:
                raise
            raise NotImplementedError(
                f"{e}: this mesh needs the multigrid Poisson solver, "
                "ROADMAP A.13") from e

    def _select_kernels(self) -> KernelPlan:
        cfg, geom = self.cfg, self.geom
        if cfg.use_pallas == "off" or (cfg.use_pallas == "auto"
                                       and self.device.type != "cuda"):
            return KernelPlan(None, None)
        # The reference's mode gates every kernel. Above SLAB_FIT_CELLS the
        # port's slab kernels would run as well (they have no plane limit);
        # the port takes the xz kernels there as the reference does, so
        # that the launches match it. Should measurements favour the slab
        # kernels there (PERF.md), this is the one place to change.
        tiling = tiling_mode(geom, cfg)
        x = geom.x
        laminar = cfg.turb_model == TurbulenceModel.NONE
        predictor = None
        if tiling == "xz":
            # the reference's xz branch comes before its periodic and
            # channel ones (solver.py:777-782): laminar or not, walled y
            # or not
            if kernels.general_eligible(geom, cfg):
                predictor = "general_xz"
        elif tiling == "slab":
            # the periodic kernel has no nu_t operand (nor has the
            # reference's fused_predictor): an LES run never takes it
            # (O2 only, as the reference's fused_predictor, solver.py:789)
            if (laminar and kernels.periodic_eligible(geom)
                    and cfg.space_order == 2
                    and cfg.convective_scheme == ConvectiveScheme.SKEW):
                predictor = "periodic"
            elif kernels.channel_slab_eligible(geom, cfg):
                predictor = "channel"
            elif kernels.general_eligible(geom, cfg):
                predictor = "general"
            elif kernels.xpad_eligible(geom, cfg):
                predictor = "xpad"
        # a non-periodic x runs the eager projection, as the reference's
        # xpad mode (its use_fused needs a periodic x, solver.py:601-602)
        projection = tiling if x.periodic else None
        # under a force ramp or bulk-velocity control the reference's
        # predictor is plain (its _euler_substep, solver.py:688-690: the
        # kernels take a constant fx) while its projection keeps its
        # kernels; implicit y-diffusion has no predictor kernel (no mode)
        plain_predictor = (cfg.force_ramp_time > 0
                           or cfg.bulk_velocity_target > 0)
        if (cfg.use_pallas == "on" and predictor is None
                and not (plain_predictor or cfg.implicit_y_diffusion)):
            raise NotImplementedError(
                "use_pallas='on': no ported kernel serves this config's "
                "predictor (the kernels need a 3-D grid with a periodic, "
                "no-slip, inflow/outflow or outflow uniform x, x.n >= 8, "
                "periodic or no-slip y and z, and a y-z plane the "
                "reference's slab or (x, z) tiling serves); use 'auto' or "
                "'off'")
        # each closure kernel behind the reference's own gate: its LES
        # closures' (les.py:37-64: a periodic uniform x, which tiles at a
        # halo of 1, so at O4 it may give "xz" where the predictor's halo
        # of 2 gives no mode; no implicit-y condition), its transport's
        # (transport.py:375-377: the single-device "slab" mode of a
        # periodic x, never "xpad" or "xz")
        kernel = self.turb.kernel
        if kernel in ("nu_sgs", "germano_pass1"):
            closure_tiling = les_tiling(geom)
        elif kernel == "transport":
            closure_tiling = ("slab" if tiling == "slab" and x.periodic
                              else None)
        else:
            closure_tiling = None
        closure = kernel if closure_tiling is not None else None
        if closure_tiling == "xz":
            # the static LES closures take nu_sgs_xz (the reference's
            # les.py:57-62, :93-96); dynamic Smagorinsky and the k-omega
            # transport run their plain chains there (les.py:316-324,
            # transport.py:375-378)
            closure = "nu_sgs_xz" if closure == "nu_sgs" else None
        if closure == "transport":
            # the strain stencil is nu_sgs's; the predictor's grid (before
            # a force ramp or bulk control makes the step's plain)
            ok = (predictor in ("channel", "general")
                  and kernels.nu_sgs_eligible(geom))
            why = ("the transport kernel serves a channel or general "
                   "predictor's grid with stationary walls (ROADMAP B.4)")
        else:
            why = None if closure is None else kernels.les_refusal(closure,
                                                                   geom)
            ok = why is None
        if not ok:
            if cfg.use_pallas == "on":
                raise NotImplementedError(
                    f"use_pallas='on': {why}; use 'auto' or 'off'")
            closure = None
        return KernelPlan(None if plain_predictor else predictor,
                          projection, closure)

    def set_ibm_forcing(self, body) -> None:
        """Attach an immersed body (the reference's set_ibm_forcing,
        solver.py:273-291): an IBMBody, wrapped in an IBMForcing on this
        Simulation's device, or a ready IBMForcing. The kernel plan is
        selected again; with a body the step takes no fused divergence."""
        from .ibm import IBMBody, IBMForcing
        if isinstance(body, IBMBody):
            body = IBMForcing(self.mesh, body, self.cfg, device=self.device)
        self.ibm = body
        self._plan()

    def initial_state(self) -> State:
        return zero_state(self.cfg, device=self.device)

    def initialize(self, state: State) -> State:
        """The closure's initialisation of a state (the k and omega
        estimates of the transport models; the identity otherwise) and, on
        the inflow/outflow pair, the capture of the inflow profile (the
        reference's initialize, solver.py:495-505): the initial state's
        inlet u face and first v and w cells, which `_apply_bc` pins from
        then on. The profile is held in buffers that the captured CUDA
        graphs read: the first capture drops the graphs captured before it
        (they pin nothing), a later one is copied into the buffers in
        place, so a replayed graph pins the new profile."""
        state = self.turb.initialize(state, self)
        if self._inflow:
            planes = tuple(c[0].detach() for c in state.velocity)
            held = self._inflow_profile
            if held is not None and all(
                    (h.shape, h.dtype, h.device) == (p.shape, p.dtype,
                                                     p.device)
                    for h, p in zip(held, planes)):
                for h, p in zip(held, planes):
                    h.copy_(p)
            else:
                self._inflow_profile = tuple(p.clone() for p in planes)
                self._graphs.clear()
        return state

    def project_initial_velocity(self, state: State) -> State:
        """One-time divergence cleanup of an initial or perturbed field
        without advancing time (the reference's project_initial_velocity,
        cfdnn_tpu/solver.py:511-521): one projection at dt = 1 through the
        step's own projection (its kernels where the plan has them); p is
        left as it was."""
        one = torch.ones((), dtype=self.dtype, device=self.device)
        comps, _ = self._project((state.u, state.v, state.w), one)
        return state.replace(u=comps[0], v=comps[1], w=comps[2])

    # ------------------------------------------------------------------
    # Physics pieces
    # ------------------------------------------------------------------

    def _apply_bc(self, comps, pin_tangential=True):
        """The velocity BCs (the convective outlet's face left as the
        outlet set it) and, once `initialize` captured an inflow profile,
        u's inlet face pinned to it (the reference's _apply_bc,
        solver.py:200-227); with `pin_tangential` (the predictor stages)
        v's and w's first cells too. After a projection the pin leaves v
        and w alone: their small tangential pressure correction stands."""
        comps = apply_velocity_bc(*comps, self.geom,
                                  convective_outlet=self._convective_out)
        profile = self._inflow_profile
        if profile is None:
            return comps
        n = 3 if pin_tangential else 1
        return tuple(torch.cat((p.unsqueeze(0), c[1:]))
                     for p, c in zip(profile[:n], comps[:n])) + comps[n:]

    def _body_force(self, t, comps, dt):
        """The driving force on u (the reference's _body_force,
        solver.py:523-541): -dp_dx/rho, times 1 - exp(-t/T) under a force
        ramp of time T, plus (target - bulk u)/dt under bulk-velocity
        control, the bulk the (y, z)-area-weighted mean of u. A host float
        without either, else a 0-d tensor."""
        cfg = self.cfg
        fx = self._fx
        if cfg.force_ramp_time > 0:
            fx = fx * (1.0 - torch.exp(-t / cfg.force_ramp_time))
        if cfg.bulk_velocity_target > 0:
            u = comps[0]
            u_bulk = torch.sum(u * self._yz_w[None, :, :]) / u.shape[0]
            fx = fx + (cfg.bulk_velocity_target - u_bulk) / dt
        return fx

    def _momentum_rhs(self, comps, nu_t, t, dt):
        cfg, geom = self.cfg, self.geom
        conv = ops.convective(comps, geom, cfg.convective_scheme)
        nu_eff = cfg.nu if nu_t is None else cfg.nu + nu_t
        diff = ops.diffusive(comps, nu_eff, geom,
                             skip_y=cfg.implicit_y_diffusion)
        ru = -conv[0] + diff[0] + self._body_force(t, comps, dt)
        rv = -conv[1] + diff[1]
        rw = -conv[2] + diff[2]
        return ru, rv, rw

    def _convective_outlet(self, star, old, dt):
        """The time-discrete convective outlet on the inflow/outflow
        pair's high-x face (the reference's _convective_outlet,
        solver.py:247-271): u*|out = u^n|out - U_c dt (u^n|out -
        u^n|out-1) / dx for each component, U_c = cfg.outflow_u_c, or
        else the area-weighted outlet-plane bulk of u^n, clipped at 0."""
        cfg = self.cfg
        if cfg.outflow_u_c > 0:
            uc = torch.full((), cfg.outflow_u_c, dtype=self.dtype,
                            device=self.device)
        else:
            uc = torch.clamp(torch.sum(old[0][-1] * self._yz_w), min=0.0)
        lam = uc * dt / self.geom.x.h
        return tuple(torch.cat((s[:-1], (o[-1] - lam * (o[-1] - o[-2]))
                                .unsqueeze(0)))
                     for s, o in zip(star, old))

    def _anchor_outlet_flux(self, comps):
        """u's outlet face shifted by a uniform offset so that its
        area-weighted flux equals the inlet face's (the reference's
        _project, solver.py:567-599): it keeps the Poisson rhs solvable
        and anchors the through-flow."""
        u = comps[0]
        q_out = torch.sum(u[-1] * self._yz_w)
        q_in = torch.sum(u[0] * self._yz_w)
        u = torch.cat((u[:-1], (u[-1] + (q_in - q_out)).unsqueeze(0)))
        return (u, comps[1], comps[2])

    def _euler_substep(self, comps, nu_t, dt, forces=None, t=None,
                       want_div=False, fw=1.0):
        """One Euler predictor substep, in the reference's order
        (solver.py:680-744): predictor (at time t, which only a force
        ramp reads) -> convective outlet -> BC with the inflow pin ->
        implicit y-diffusion and BC again -> IBM forcing (its force sums,
        weighted by `fw`, appended to `forces`). With want_div, returns
        (star, div): div is div(u*) where the plan's predictor +
        divergence kernel produced it (`_fuse_div`), else None and the
        projection takes it."""
        cfg, geom = self.cfg, self.geom
        fuse = self._fuse_div if want_div else False
        pred = self.kernels.predictor
        div = None
        if fuse == "periodic":
            *star, div = kernels.predictor_periodic_div(
                *comps, dt, geom=geom, nu=float(cfg.nu), fx=self._fx)
        elif fuse == "channel":
            *star, div = kernels.predictor_channel_div(
                *comps, dt, self._channel_ys, geom=geom, nu=float(cfg.nu),
                fx=self._fx, scheme=cfg.convective_scheme, nu_t=nu_t)
        elif pred == "periodic":
            star = kernels.predictor_periodic(
                *comps, dt, hx=geom.x.h, hy=geom.y.h, hz=geom.z.h,
                nu=float(cfg.nu), fx=self._fx)
        elif pred == "channel":
            star = kernels.predictor_channel(
                *comps, dt, self._channel_ys, hx=geom.x.h, hz=geom.z.h,
                nu=float(cfg.nu), fx=self._fx, scheme=cfg.convective_scheme,
                nu_t=nu_t)
        elif pred == "general":
            star = kernels.predictor_general(
                *comps, dt, self._gen_arrays, geom=geom, nu=float(cfg.nu),
                fx=self._fx, scheme=cfg.convective_scheme, nu_t=nu_t)
        elif pred == "general_xz":
            star = kernels.predictor_general_xz(
                *comps, dt, self._gen_arrays, geom=geom, nu=float(cfg.nu),
                fx=self._fx, scheme=cfg.convective_scheme, nu_t=nu_t)
        elif pred == "xpad":
            star = kernels.predictor_xpad(
                *comps, dt, self._gen_arrays, geom=geom, xgeom=self._gen_geom,
                nu=float(cfg.nu), fx=self._fx, scheme=cfg.convective_scheme,
                nu_t=nu_t)
        else:
            rhs = self._momentum_rhs(comps, nu_t, t, dt)
            star = tuple(c + dt * r for c, r in zip(comps, rhs))
        if fuse and div is None:
            # the reference asserts here (solver.py:833); keyed to the plan,
            # the gate makes this unreachable
            raise RuntimeError(f"fused divergence {fuse!r} requested, but "
                               f"the {pred!r} predictor produced none")
        if self._convective_out:
            star = self._convective_outlet(star, comps, dt)
        # the div kernels' star is BC-applied already (v's wall faces are
        # zeroed in the channel kernel): the BC pass is idempotent on it
        star = self._apply_bc(tuple(star))
        if cfg.implicit_y_diffusion:
            star = implicit_y_diffusion(
                star, cfg.nu if nu_t is None else cfg.nu + nu_t, dt, geom)
            star = self._apply_bc(star)
        if self.ibm is not None:
            star, f = self.ibm.apply(star, dt, accumulate=forces is not None)
            if forces is not None:
                forces.append(tuple(fw * c for c in f))
        return (star, div) if want_div else star

    def _project(self, comps, dt, forces=None, div=None, fw=1.0):
        """Divergence (unless the predictor produced it) -> Poisson (rhs
        masked in the solid) -> correction -> IBM forcing -> BC (the
        inflow pin without v's and w's cells), on the inflow/outflow pair
        after the outlet's flux anchor (`_anchor_outlet_flux`). `fw`
        weighs this stage's IBM force sums (see _advance_velocity)."""
        geom = self.geom
        if self._inflow:
            comps = self._anchor_outlet_flux(comps)
        xz = self.kernels.projection == "xz"
        div_kernel = kernels.divergence_xz if xz else kernels.divergence
        correct_kernel = kernels.correct_xz if xz else kernels.correct
        if div is None:
            div = (div_kernel(*comps, geom=geom) if self.kernels.projection
                   else ops.divergence(comps, geom))
        rhs = div / dt
        if self.ibm is not None:
            rhs = self.ibm.mask_rhs(rhs)
        if self._poisson_diagnostics:
            # the residual is read on the host, a sync per solve
            p_corr, stats = self.poisson.solve_with_stats(rhs)
            print(f"[poisson] {stats.status} "
                  f"rel_residual={stats.rel_residual}")
        else:
            p_corr = self.poisson.solve(rhs)
        if self.kernels.projection:
            comps = correct_kernel(*comps, p_corr, dt, geom=geom)
        else:
            comps = ops.correct_velocity(comps, p_corr, dt, geom)
        if self.ibm is not None:
            comps, f = self.ibm.apply(comps, dt,
                                      accumulate=forces is not None)
            if forces is not None:
                forces.append(tuple(fw * c for c in f))
        return self._apply_bc(comps, pin_tangential=False), p_corr

    def _advance_velocity(self, comps, nu_t, dt, forces=None, t=None):
        """One step of the velocity with a projection after each stage:
        Euler, RK2 or SSP-RK3 (the reference's _advance_velocity,
        solver.py:860-926), the stages' predictors at t, t + dt and (RK3)
        t + dt/2. The predictor is pressure-free, so the last
        projection's correction IS the pressure: it replaces p, rescaled by
        the last blend's weight (2 for RK2, 1.5 for RK3). Only the first
        stage may take the fused divergence. The stage times are formed
        only where a force ramp reads them."""
        ti = self.cfg.time_integrator
        ramp = self.cfg.force_ramp_time > 0
        t2 = t + dt if ramp else None
        if ti == TimeIntegrator.EULER:
            star, div = self._euler_substep(comps, nu_t, dt, forces, t,
                                            want_div=True)
            return self._project(star, dt, forces, div=div)

        def blend(a, ca, b, cb):
            return tuple(ca * x + cb * y for x, y in zip(a, b))

        # IBM force weights: each stage's impulse counts with the product of
        # the blend coefficients between it and the step's output
        if ti == TimeIntegrator.RK2:
            s1, d1 = self._euler_substep(comps, nu_t, dt, forces, t,
                                         want_div=True, fw=0.5)
            s1, _ = self._project(s1, dt, forces, div=d1, fw=0.5)
            s2 = self._euler_substep(s1, nu_t, dt, forces, t2, fw=0.5)
            s2 = self._apply_bc(blend(comps, 0.5, s2, 0.5))
            s2, pc2 = self._project(s2, dt, forces)
            return s2, 2.0 * pc2
        s1, d1 = self._euler_substep(comps, nu_t, dt, forces, t,
                                     want_div=True, fw=1.0 / 6.0)
        s1, _ = self._project(s1, dt, forces, div=d1, fw=1.0 / 6.0)
        s2 = self._euler_substep(s1, nu_t, dt, forces, t2, fw=1.0 / 6.0)
        s2 = self._apply_bc(blend(comps, 0.75, s2, 0.25))
        s2, _ = self._project(s2, dt, forces, fw=2.0 / 3.0)
        s3 = self._euler_substep(s2, nu_t, dt, forces,
                                 t + 0.5 * dt if ramp else None,
                                 fw=2.0 / 3.0)
        s3 = self._apply_bc(blend(comps, 1.0 / 3.0, s3, 2.0 / 3.0))
        s3, pc3 = self._project(s3, dt, forces)
        return s3, 1.5 * pc3

    def _adaptive_dt(self, comps, nu_t):
        """Directional CFL and explicit-diffusion limit (the reference's
        _adaptive_dt, solver.py:928-951) as a 0-d device tensor, from
        device reductions (max |u|, |v|, |w| and max nu_t) and the host
        factors of `_adaptive_dt_limits`; no host sync."""
        cfg = self.cfg
        cfl_x, cfl_y, cfl_z, inv_h2, dt_visc = self._dt_limits
        eps = 1e-30

        def vmax(c):
            return torch.clamp(torch.linalg.vector_norm(c, float("inf")),
                               min=eps)

        dt = torch.minimum(cfl_x / vmax(comps[0]), cfl_y / vmax(comps[1]))
        if cfl_z is not None:
            dt = torch.minimum(dt, cfl_z / vmax(comps[2]))
        if nu_t is not None:
            dt_visc = 0.25 / ((cfg.nu + torch.max(nu_t)) * inv_h2)
        return cfg.dt_safety * torch.minimum(dt, dt_visc)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _step_impl(self, state: State,
                   with_diags: bool = True) -> Tuple[State, StepDiagnostics]:
        comps = (state.u, state.v, state.w)
        # the closure's advance (k, omega) and nu_t from the pre-step
        # velocity; SST emits both from one transport kernel launch
        state, nu_t = self.turb.advance_and_nu_t(state, self, state.dt_prev)
        dt = (self._adaptive_dt(comps, nu_t) if self.cfg.adaptive_dt
              else self._dt)
        forces = [] if self.ibm is not None else None
        new_comps, p = self._advance_velocity(comps, nu_t, dt, forces,
                                              state.t)
        zero = self._zero
        if with_diags:
            div = ops.divergence(new_comps, self.geom)
            if self.ibm is not None:
                # direct forcing puts divergence into the forced cells by
                # design: report the fluid region's
                div = div * self.ibm.fluid_interior
            res = torch.maximum(
                torch.max(torch.abs(new_comps[0] - comps[0])),
                torch.maximum(torch.max(torch.abs(new_comps[1] - comps[1])),
                              torch.max(torch.abs(new_comps[2] - comps[2]))))
            ke = 0.5 * (torch.mean(new_comps[0] ** 2)
                        + torch.mean(new_comps[1] ** 2)
                        + torch.mean(new_comps[2] ** 2))
            div_linf = torch.max(torch.abs(div))
            nan_flag = ~torch.isfinite(ke)
        else:
            # benchmark/throughput mode: skip the extra reduction passes
            res = ke = div_linf = zero
            nan_flag = torch.zeros((), dtype=torch.bool, device=self.device)
        fx = fy = fz = zero
        if forces:
            fx, fy, fz = (sum(f[i] for f in forces) for i in range(3))
        # Kahan-compensated t += dt (fields.State.t_comp)
        t_comp = state.t_comp if state.t_comp is not None else zero
        y = dt - t_comp
        t_new = state.t + y
        new_state = state.replace(
            u=new_comps[0], v=new_comps[1], w=new_comps[2], p=p,
            t=t_new, t_comp=(t_new - state.t) - y,
            step=state.step + 1, dt_prev=dt,
            nu_t=nu_t if state.nu_t is not None else None,
        )
        diags = StepDiagnostics(residual=res, div_linf=div_linf, dt=dt,
                                ke=ke, nan_flag=nan_flag, fx=fx, fy=fy,
                                fz=fz)
        return new_state, diags

    # ------------------------------------------------------------------
    # The step captured in CUDA graphs
    # ------------------------------------------------------------------

    def _graphed(self, state: State) -> bool:
        """Whether `run` replays CUDA graphs for `state` (the rules in its
        docstring)."""
        return (self.device.type == "cuda" and not self._poisson_diagnostics
                and not any(getattr(state, k) is not None
                            and getattr(state, k).requires_grad
                            for k in _STATE_KEYS))

    def _graph_buffers(self, state: State):
        """(members, (input State, diagnostics)): the graphs' fixed buffers
        for the State members `state` carries, made once from a copy of it.
        A member of another shape, dtype or device than this Simulation's
        raises ValueError: a graph replays what it captured."""
        cfg = self.cfg
        members = tuple(k for k in _STATE_KEYS
                        if getattr(state, k) is not None)
        cells = (cfg.Nx, cfg.Ny, cfg.Nz)
        shapes = dict(zip(("u", "v", "w"), velocity_shapes(cfg)), p=cells,
                      k=cells, omega=cells, nu_t=cells)
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for name in members:
            t = getattr(state, name)
            want = (shapes.get(name, ()),
                    torch.int32 if name == "step" else self.dtype, dev)
            got = (tuple(t.shape), t.dtype, t.device)
            if got != want:
                raise ValueError(
                    f"run: state.{name} has (shape, dtype, device) {got}; "
                    f"this Simulation's graphs take {want}")
        io = self._graph_io.get(members)
        if io is None:
            zero = self._zero
            io = self._graph_io[members] = (
                State(**{k: getattr(state, k).detach().clone()
                         for k in members}),
                StepDiagnostics(
                    residual=zero.clone(), div_linf=zero.clone(),
                    dt=zero.clone(), ke=zero.clone(),
                    nan_flag=torch.zeros((), dtype=torch.bool,
                                         device=self.device),
                    fx=zero.clone(), fy=zero.clone(), fz=zero.clone()))
        return members, io

    def _graph(self, members, diags: bool, steps: int):
        """(graph, launches, nodes) of `steps` steps (with or without the
        diagnostics reductions) from the fixed input State of `members`:
        the graph ends by copying its last State, and its diagnostics,
        into the fixed buffers. Captured once a Simulation (`_capture`),
        after one uncaptured warm-up step of the same kind, whose result
        is dropped: the step writes none of its inputs, so the buffers stay
        as they were."""
        key = (members, diags, steps)
        if key not in self._graphs:
            S, D = self._graph_io[members]

            def warm():
                self._step_impl(S, with_diags=diags)

            def body():
                st = S
                for _ in range(steps):
                    st, d = self._step_impl(st, with_diags=diags)
                for k in members:
                    getattr(S, k).copy_(getattr(st, k))
                if diags:
                    for f in dataclasses.fields(StepDiagnostics):
                        getattr(D, f.name).copy_(getattr(d, f.name))

            self._graphs[key] = self._capture(warm, body)
        return self._graphs[key]

    def _capture(self, warm: Callable, body: Callable):
        """(torch.cuda.CUDAGraph of body(), launches, nodes), on this
        Simulation's capture stream and memory pool (made at the first
        capture), after warm() ran uncaptured on the same stream: the first
        launches do host work that a capture must not see (building the
        kernel library, function attributes, occupancy queries, cuFFT
        plans, cuBLAS handles). `launches` are the port's kernels the graph
        holds, by wrapper: its kernel nodes counted by name
        (`graph_kernel_symbols`, `kernels.device_launches`), which must
        equal the wrappers' launches during the capture; `nodes` are all its
        kernel nodes, library kernels included. A capture launches nothing,
        so the wrappers' counts of it are taken off, and each replay adds
        the graph's (ops.kernels.add_launches). A failed capture, or a graph
        that holds other kernels than its capture launched, raises."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._graph_stream
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), torch.no_grad():
            warm()
        current.wait_stream(stream)
        before = kernels.launch_counts()
        # keep_graph: the graph's nodes stay readable after instantiation
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.no_grad(), torch.cuda.graph(graph, pool=self._graph_pool,
                                               stream=stream):
            body()
        after = kernels.launch_counts()
        called = {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}
        kernels.add_launches(called, -1)
        graph.instantiate()
        symbols = graph_kernel_symbols(graph)
        held = kernels.device_launches((s, 1) for s in symbols)
        if held != called:
            raise RuntimeError(f"a captured graph holds the kernels {held}; "
                               f"its capture launched {called}")
        return graph, held, len(symbols)

    def _run_graphed(self, state: State, n: int, fast: bool):
        """`run` by graph replays: the state copied into the fixed buffers
        (unless they hold it already: `state` is what the last graphed run
        of these members returned, unwritten since), chunks of GRAPH_CHUNK
        steps (then single steps) replayed, and the result cloned out once,
        so the returned State and diagnostics are the caller's own."""
        members, (S, D) = self._graph_buffers(state)
        # (steps, diagnostics) of the call; the graphs all captured before
        # the state is copied in
        parts = ((n - 1, False), (1, True)) if fast else ((n, True),)
        replays = []
        for m, diags in parts:
            chunks, rest = divmod(m, GRAPH_CHUNK)
            for steps, reps in ((GRAPH_CHUNK, chunks), (1, rest)):
                if reps:
                    replays.append((self._graph(members, diags, steps), reps))
        if not _same_tensors(self._graph_holds.get(members), state, members):
            for k in members:
                getattr(S, k).copy_(getattr(state, k))
        for (graph, launches, nodes), reps in replays:
            for _ in range(reps):
                graph.replay()
            kernels.add_launches(launches, reps, nodes)
        out = State(**{k: getattr(S, k).clone() for k in members})
        self._graph_holds[members] = _identity(out, members)
        return out, StepDiagnostics(**{
            f.name: getattr(D, f.name).clone()
            for f in dataclasses.fields(StepDiagnostics)})

    # ------------------------------------------------------------------
    # Public API (the reference's, cfdnn_tpu/solver.py:1042-1159)
    # ------------------------------------------------------------------

    def step(self, state: State) -> Tuple[State, StepDiagnostics]:
        """One step with its diagnostics (`run` of one step)."""
        return self.run(state, 1)

    def run(self, state: State, n: int) -> Tuple[State, StepDiagnostics]:
        """n steps. In benchmark or perf mode the first n-1 skip the
        diagnostics reductions and the last computes them, so the returned
        diagnostics are always real (the reference's _nsteps_impl);
        otherwise every step computes them. The returned State and
        diagnostics are the caller's own: no later call changes them.

        On a CUDA device the steps replay CUDA graphs captured once a
        Simulation (`_graph`), the counterpart of the reference's
        lax.scan; a failed capture raises. A call copies `state` into the
        graphs' fixed buffers, unless it is what the last call returned,
        unwritten since (a step-by-step caller such as advance_unsteady
        then pays only the clone out), and clones the result out. Three
        cases run the plain Python loop of the same step instead, by rule:
          - a CPU device (the tests);
          - a state with a tensor that requires grad (autograd through the
            step records each launch; a graph would replay none);
          - CFDNN_POISSON_DIAGNOSTICS at construction, whose per-solve
            residual is read on the host, a sync no capture may hold.
        A state of another shape, dtype or device than this Simulation's
        raises ValueError on the graph path."""
        if n < 1:
            raise ValueError(f"run: n={n}, need n >= 1")
        fast = self.cfg.benchmark or self.cfg.perf_mode
        if self._graphed(state):
            return self._run_graphed(state, n, fast)
        return self._run_loop(state, n, fast)

    def _run_loop(self, state: State, n: int, fast: bool):
        """`run` as a plain Python loop of the step."""
        for _ in range(n - 1):
            state, _ = self._step_impl(state, with_diags=not fast)
        return self._step_impl(state, with_diags=True)

    def solve_steady(self, state: State, tol: Optional[float] = None,
                     max_steps: Optional[int] = None,
                     callback: Optional[Callable] = None):
        """Iterate to steady state (the reference's solve_steady,
        cfdnn_tpu/solver.py:1086-1134): `run` chunks of
        max(1, diag_interval) steps, the residual read on the host after
        each, until residual < tol * dt. The reference's recycling
        telemetry is left out: the port refuses recycling
        (_check_supported, ROADMAP A.14)."""
        cfg = self.cfg
        tol = cfg.tol if tol is None else tol
        max_steps = cfg.max_steps if max_steps is None else max_steps
        check = max(1, cfg.diag_interval)
        diags = None
        it = 0
        while it < max_steps:
            n = min(check, max_steps - it)
            state, diags = self.run(state, n)
            it += n
            res = float(diags.residual)
            dtv = float(diags.dt)
            if callback:
                callback(it, state, diags)
            if not np.isfinite(res):
                raise FloatingPointError(f"NaN/Inf detected at step {it}")
            # projection watchdog: alert on poor post-projection divergence
            if (cfg.projection_watchdog
                    and float(diags.div_linf) > cfg.div_threshold
                    and cfg.verbose):
                print(f"[watchdog] step {it}: post-projection "
                      f"div_linf = {float(diags.div_linf):.3e} > "
                      f"{cfg.div_threshold:g}")
            if res < tol * max(dtv, 1e-30):
                break
        return state, diags

    def solve_steady_with_snapshots(self, state: State,
                                    snapshot_cb: Optional[Callable] = None,
                                    snapshot_every: int = 0, **kw):
        """solve_steady with a snapshot hook, called once at least
        `snapshot_every` steps have passed since the last (">=", not a
        modulo: solve_steady calls back every diag_interval steps, which a
        modulo could alias)."""
        last = [0]

        def cb(it, st, d):
            if (snapshot_every and snapshot_cb
                    and it - last[0] >= snapshot_every):
                last[0] = it
                snapshot_cb(it, st, d)
        return self.solve_steady(state, callback=cb, **kw)

    def advance_unsteady(self, state: State, n_steps: int,
                         callback: Optional[Callable] = None):
        """n_steps steps: one `run` without a callback, else `step` by step
        with callback(it, state, diags) after each."""
        if callback is None:
            return self.run(state, n_steps)
        diags = None
        for it in range(n_steps):
            state, diags = self.step(state)
            callback(it + 1, state, diags)
        return state, diags
