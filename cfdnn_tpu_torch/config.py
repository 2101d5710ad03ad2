"""Simulation configuration of the PyTorch port.

A copy of `cfdnn_tpu/config.py`, so that the port never imports the JAX
package (whose `__init__` pulls in JAX). Every field, default and parser
is the reference's; `tests/test_torch_config_mesh.py` holds the two equal
field by field. Fields the port's Simulation cannot honour yet make it
raise `NotImplementedError` (solver.py `_check_supported`), never go
ignored. `use_pallas` keeps its values and means "use the port's
hand-written CUDA kernels" (ops/kernels.py).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class TurbulenceModel(str, enum.Enum):
    """Turbulence closure selection (reference: include/config.hpp:11-30)."""

    NONE = "none"
    BASELINE = "baseline"            # algebraic mixing length
    GEP = "gep"                      # Weatheritt-Sandberg GEP algebraic
    NN_MLP = "nn_mlp"                # NN scalar eddy viscosity
    NN_TBNN = "nn_tbnn"              # TBNN anisotropy model
    SST = "sst"                      # SST k-omega transport
    KOMEGA = "komega"                # Wilcox 1988 k-omega
    EARSM_WJ = "earsm_wj"            # Wallin-Johansson EARSM
    EARSM_GS = "earsm_gs"            # Gatski-Speziale EARSM
    EARSM_POPE = "earsm_pope"        # Pope quadratic EARSM
    SMAGORINSKY = "smagorinsky"      # static Smagorinsky LES
    DYNAMIC_SMAGORINSKY = "dynamic_smagorinsky"
    WALE = "wale"
    VREMAN = "vreman"
    SIGMA = "sigma"


class ConvectiveScheme(str, enum.Enum):
    """Advection scheme (reference: include/config.hpp:33-39)."""

    CENTRAL = "central"
    UPWIND = "upwind"
    SKEW = "skew"
    UPWIND2 = "upwind2"


class TimeIntegrator(str, enum.Enum):
    """Time integration scheme (reference: include/config.hpp:59-64)."""

    EULER = "euler"
    RK2 = "rk2"
    RK3 = "rk3"


class PoissonSolverType(str, enum.Enum):
    """Poisson backend (reference: include/config.hpp:46-55).

    The TPU build collapses FFT/FFT2D/FFT1D/HYPRE into the fast-diagonalization
    (FDM) solver: FFT over periodic axes + precomputed 1-D eigenbasis matmuls
    over wall axes on the MXU. MG remains as the general fallback.
    """

    AUTO = "auto"
    FDM = "fdm"          # fast diagonalization (covers FFT/FFT2D/FFT1D/HYPRE roles)
    FFT = "fft"          # alias of FDM, accepted for reference parity
    FFT2D = "fft2d"      # alias of FDM
    FFT1D = "fft1d"      # alias of FDM
    MG = "mg"            # geometric multigrid (general BCs)


class SimulationMode(str, enum.Enum):
    STEADY = "steady"
    UNSTEADY = "unsteady"


class BCType(str, enum.Enum):
    """Per-axis boundary condition type for the velocity field."""

    PERIODIC = "periodic"
    WALL = "wall"          # no-slip
    INFLOW = "inflow"      # Dirichlet inlet (recycling or fixed profile)
    OUTFLOW = "outflow"    # convective/zero-gradient outlet


def pressure_bc_kinds(cfg: "Config", axis: int) -> Tuple[str, str]:
    """(lo, hi) pressure BC kind for an axis: 'neumann' | 'dirichlet'.

    wall/inflow => dp/dn = 0; outflow => p = 0 at the face. Recycling mode
    flips the x axis to (dirichlet@inlet, neumann@outlet) so the projection
    can adjust the inlet face velocity for continuity (reference:
    src/solver_recycling.cpp:205-208).
    """
    bc = (cfg.bc_x, cfg.bc_y, cfg.bc_z)[axis]
    if bc == BCType.OUTFLOW:
        return ("dirichlet", "dirichlet")
    if bc == BCType.INFLOW and axis == 0:
        # bc_x=INFLOW means the inflow/outflow pair: inflow at x_lo,
        # convective outflow at x_hi.
        if cfg.recycling_inflow:
            return ("dirichlet", "neumann")
        return ("neumann", "dirichlet")
    return ("neumann", "neumann")


@dataclasses.dataclass(frozen=True)
class Config:
    """Full simulation configuration (reference: include/config.hpp:65-234).

    Frozen and hashable, as the reference's.
    """

    # --- Domain and mesh -------------------------------------------------
    Nx: int = 64
    Ny: int = 64
    Nz: int = 1                      # 1 => 2D simulation
    x_min: float = 0.0
    x_max: float = 2.0 * math.pi
    y_min: float = -1.0
    y_max: float = 1.0
    z_min: float = 0.0
    z_max: float = 1.0
    stretch_y: bool = False
    stretch_beta: float = 2.0
    stretch_z: bool = False
    stretch_beta_z: float = 2.0

    # --- Physical parameters --------------------------------------------
    Re: float = 1000.0
    nu: float = 0.001
    rho: float = 1.0
    dp_dx: float = -1.0              # driving pressure gradient / body force
    bulk_velocity_target: float = 0.0  # bulk-velocity controller target (0=off)
    Re_specified: bool = False
    nu_specified: bool = False
    dp_dx_specified: bool = False

    # --- Time stepping ---------------------------------------------------
    dt: float = 0.001
    force_ramp_time: float = -1.0    # >0: dp/dx ramps as 1-exp(-t/T)
    CFL_max: float = 0.5
    CFL_xz: float = -1.0             # -1 => use CFL_max
    dt_safety: float = 1.0
    adaptive_dt: bool = True
    implicit_y_diffusion: bool = False
    max_steps: int = 10000
    T_final: float = -1.0
    tol: float = 1e-6                # steady-state convergence tolerance
    time_integrator: TimeIntegrator = TimeIntegrator.EULER
    filter_strength: float = 0.0     # explicit velocity filter (0=off)
    filter_interval: int = 10

    # --- Numerical schemes ----------------------------------------------
    convective_scheme: ConvectiveScheme = ConvectiveScheme.CENTRAL
    space_order: int = 2             # 2 or 4

    # --- Simulation mode -------------------------------------------------
    simulation_mode: SimulationMode = SimulationMode.STEADY
    perturbation_amplitude: float = 1e-2

    # --- Boundary conditions (TPU build: explicit per-axis) --------------
    bc_x: BCType = BCType.PERIODIC
    bc_y: BCType = BCType.WALL
    bc_z: BCType = BCType.PERIODIC
    # Tangential x-velocity of the y_max wall (lid-driven cavity / moving
    # belt). First-class here; the reference only reaches this physics by
    # rewriting the u ghost row every step in its cavity test
    # (tests/test_physics_validation_advanced.cpp:500-505).
    lid_velocity: float = 0.0

    # --- Turbulence model ------------------------------------------------
    turb_model: TurbulenceModel = TurbulenceModel.NONE
    nu_t_max: float = 1.0
    pope_C1: float = 0.1
    pope_C2: float = 0.1
    nn_weights_path: str = ""
    nn_scaling_path: str = ""
    nn_preset: str = ""

    # --- Output ----------------------------------------------------------
    output_dir: str = "output/"
    # Checkpoint/resume (exceeds the reference — SURVEY 5.4: it has no
    # restart path). checkpoint_interval=0 disables periodic saves.
    checkpoint_dir: str = ""
    checkpoint_interval: int = 0
    resume: bool = False
    output_freq: int = 100
    num_snapshots: int = 10
    verbose: bool = True
    diag_interval: int = 1
    postprocess: bool = True
    write_fields: bool = True
    vtk_binary: bool = True
    warmup_steps: int = 0

    # --- Poisson solver --------------------------------------------------
    poisson_solver: PoissonSolverType = PoissonSolverType.AUTO
    poisson_tol: float = 1e-6
    poisson_max_vcycles: int = 20
    poisson_abs_tol_floor: float = 1e-8
    poisson_tol_abs: float = 0.0
    poisson_tol_rhs: float = 1e-6
    poisson_tol_rel: float = 1e-3
    poisson_check_interval: int = 3
    poisson_use_l2_norm: bool = True
    poisson_linf_safety: float = 10.0
    poisson_fixed_cycles: int = 8
    poisson_adaptive_cycles: bool = True
    poisson_check_after: int = 4
    poisson_nu1: int = 0             # 0 = auto
    poisson_nu2: int = 0
    poisson_chebyshev_degree: int = 4
    # Iterative refinement of the FDM direct solve: each pass re-applies the
    # stencil Laplacian and solves for the correction. The eigenbasis-matmul
    # transforms concentrate a smooth RHS into few O(N^1.5 ||rhs||)
    # coefficients, so f32/bf16 roundoff there costs ~3 digits of the
    # post-projection divergence; one pass restores the f32 floor
    # (measured 128^3 TGV: 1.8e-3 -> 1.8e-6 with "high" matmuls, ~37% step
    # cost). -1 = auto: 0 in float64 (already 1e-14) and in f32 below 384^3
    # ("high" matmuls alone reach ~8e-6 at 128^3 / ~1.8e-5 at 256^3), 1 on
    # larger f32 grids.
    poisson_refine: int = -1
    # MXU precision of the eigenbasis matmuls: "default" (1-pass bf16,
    # fastest, ~1.8e-3 div at 128^3), "high" (3-pass, ~8e-6 div, ~2% step
    # cost), "highest" (6-pass ~f32)
    poisson_matmul_precision: str = "auto"  # "auto" | "default" | "high" | "highest"
    # Periodic-axis modal transform of the FDM solver (poisson/fdm.py):
    # "auto" picks per device/size/precision-tier (dense MXU eigenbasis
    # matmuls on TPU, pocketfft/cuFFT elsewhere, the in-VMEM Pallas
    # four-step Hartley at >=384^3 f32 where it wins); force/disable from
    # the CLI like every other solver knob (reference analogue: the
    # Poisson tuning fields of config.hpp:65-234).
    poisson_transform: str = "auto"  # "auto" | "matmul" | "fft" | "fht" | "pallas_fft"

    # --- Guards / watchdogs ----------------------------------------------
    turb_guard_enabled: bool = True
    turb_guard_interval: int = 5
    div_threshold: float = 1e-5
    div_tol_acceptable: float = 1e-6
    projection_watchdog: bool = True
    adaptive_projection: bool = True
    div_target: float = 1e-4
    projection_max_cycles: int = 60
    projection_extra_chunk: int = 5

    # --- Modes -----------------------------------------------------------
    benchmark: bool = False
    perf_mode: bool = False
    gpu_only_mode: bool = False      # retained for CLI parity (no-op on TPU)

    # --- Trip forcing (DNS transition) -----------------------------------
    trip_enabled: bool = False
    trip_x_start: float = -1.0
    trip_x_end: float = -1.0
    trip_amplitude: float = 3.0
    trip_duration: float = 2.0
    trip_ramp_off_start: float = 1.5
    trip_n_modes_z: int = 8
    trip_force_w: bool = True
    trip_w_scale: float = 1.0

    # --- Outflow ---------------------------------------------------------
    # Convective (wake-transparent) outlet du/dt + U_c du/dx = 0 on the
    # high-x face of the inflow/outflow pair (reference apply_velocity_bc
    # outflow family, src/solver_operators.cpp:43). Off = zero-gradient
    # outlet hardened by the uniform outlet flux offset (both modes keep
    # the flux offset for Poisson solvability).
    convective_outflow: bool = False
    outflow_u_c: float = 0.0     # 0 => auto: outlet-plane bulk velocity

    # --- Recycling inflow -------------------------------------------------
    recycling_inflow: bool = False
    recycle_x: float = -1.0
    recycle_shift_z: int = -1
    recycle_shift_interval: int = 0   # steps between shift-AMOUNT updates; 0 = constant shift (reference behavior)
    recycle_filter_tau: float = -1.0
    recycle_fringe_length: float = -1.0
    # Mass-flux controller target for the recycled inlet u plane.
    # -1 (default) = auto-capture the IC inlet plane's bulk at
    # initialize() — reference parity: solver_recycling.cpp:784-785
    # ("If target Q not set, use current bulk velocity as target").
    # Without this anchor the inlet u is slaved to interior continuity
    # and a body-forced developing channel accelerates without bound
    # (measured: bulk 15.7 -> 18+ and climbing under dp_dx=-1).
    # 0 = disabled; >0 = explicit target.
    recycle_target_bulk_u: float = -1.0
    recycle_remove_transverse_mean: bool = True
    recycle_diag_interval: int = 0
    # Lund-type statistical rescaling of the recycled inlet (Lund, Wu &
    # Squires 1998): pin the inlet z-mean profile and rescale the
    # fluctuations to the reference RMS captured at initialize() from
    # the IC's recycle plane. Pins the recycle-loop gain at 1: in the
    # full-mode periodic-vs-recycling study the undamped loop sits
    # slightly hot (Re_tau 192 vs the periodic 182) while the AR1
    # filter laminarizes (163); rescaling centers it (178.6, U within
    # 1.1%). Beyond the reference's shift/filter/mass-flux machinery.
    recycle_rescale: bool = False
    recycle_rescale_clip: float = 2.0   # max per-y amplification factor

    # --- TPU-specific -----------------------------------------------------
    use_pallas: str = "auto"         # "auto" | "on" | "off": hand-written kernels
    dtype: str = "float32"           # "float32" | "float64" (x64 validation runs)
    poisson_dtype: str = ""          # "" => same as dtype; "float64" for mixed
    # JAX backend pin ("" = environment default). The f64 physics-gate
    # configs (examples/, verify recipes) set "cpu": the TPU has no f64
    # datapath, so a float64 run on the default TPU backend crawls
    # through emulation. Applied by apps/runner.run_case before the first
    # jax op (no effect on an already-initialized backend — library users
    # set JAX_PLATFORMS / jax.config themselves).
    platform: str = ""               # "" | "cpu" | "tpu"
    mesh_axes: Tuple[str, ...] = ("z",)  # device-mesh axis names for sharding
    mesh_shape: Tuple[int, ...] = (1,)   # device-mesh shape (1 = single chip)

    # ---------------------------------------------------------------------

    @property
    def is_2d(self) -> bool:
        return self.Nz == 1

    @property
    def Lx(self) -> float:
        return self.x_max - self.x_min

    @property
    def Ly(self) -> float:
        return self.y_max - self.y_min

    @property
    def Lz(self) -> float:
        return self.z_max - self.z_min

    def finalize(self) -> "Config":
        """Resolve the (Re, nu, dp_dx) triad from any two specified members.

        Mirrors reference Config::finalize (src/config.cpp:636): the channel
        relations used are u_tau = sqrt(-dp_dx * delta / rho) and
        Re_tau-style closure Re = u_ref * delta / nu with u_ref = 1. Errors on
        a three-way inconsistency.
        """
        delta = 0.5 * self.Ly
        updates = {}
        re_s, nu_s, dp_s = self.Re_specified, self.nu_specified, self.dp_dx_specified
        if re_s and nu_s and dp_s:
            # all three given: check consistency of Re = 1/nu convention loosely
            if abs(self.Re * self.nu - delta) / delta > 1e-6 and abs(
                self.Re * self.nu - 1.0
            ) > 1e-6:
                raise ValueError(
                    "Config: Re, nu and dp_dx all specified but inconsistent "
                    f"(Re*nu={self.Re * self.nu:g})"
                )
        elif re_s and not nu_s:
            updates["nu"] = delta / self.Re if delta != 1.0 else 1.0 / self.Re
        elif nu_s and not re_s:
            updates["Re"] = delta / self.nu
        if self.poisson_transform not in (
                "auto", "matmul", "fft", "fht", "pallas_fft"):
            raise ValueError(
                f"Config: poisson_transform={self.poisson_transform!r} — "
                "expected 'auto' | 'matmul' | 'fft' | 'fht' | 'pallas_fft'")
        if self.lid_velocity != 0.0 and self.bc_y != BCType.WALL:
            raise ValueError("Config: lid_velocity requires bc_y=WALL "
                             "(it is the y_max wall's tangential speed)")
        if self.lid_velocity != 0.0 and self.implicit_y_diffusion:
            raise ValueError("Config: lid_velocity with implicit_y_diffusion "
                             "is not supported (the Thomas y-solve's "
                             "boundary rows assume stationary no-slip walls)")
        if self.CFL_xz < 0:
            updates["CFL_xz"] = self.CFL_max
        if self.benchmark:
            updates.update(
                postprocess=False,
                write_fields=False,
                verbose=False,
                adaptive_dt=False,
                diag_interval=50,
                turb_guard_interval=50,
                num_snapshots=0,
                adaptive_projection=False,
            )
        elif self.perf_mode:
            updates.update(diag_interval=50, poisson_check_interval=5)
        return dataclasses.replace(self, **updates)

    def with_(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    # ------------------------------------------------------------------
    # File / CLI parsing (reference: src/config.cpp:108 load, :333 parse_args)
    # ------------------------------------------------------------------

    _ENUM_FIELDS = {
        "turb_model": TurbulenceModel,
        "convective_scheme": ConvectiveScheme,
        "time_integrator": TimeIntegrator,
        "poisson_solver": PoissonSolverType,
        "simulation_mode": SimulationMode,
        "bc_x": BCType,
        "bc_y": BCType,
        "bc_z": BCType,
    }

    @classmethod
    def _coerce(cls, name: str, raw: str):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        if name not in fields:
            raise KeyError(f"Config: unknown option '{name}'")
        if name in cls._ENUM_FIELDS:
            return cls._ENUM_FIELDS[name](raw.lower())
        ftype = fields[name].type
        if ftype in ("int", int):
            return int(raw)
        if ftype in ("float", float):
            return float(raw)
        if ftype in ("bool", bool):
            return raw.lower() in ("1", "true", "yes", "on")
        ft = str(ftype)
        if ft.startswith(("Tuple[int", "tuple[int")):
            return tuple(int(x) for x in raw.split(","))
        if ft.startswith(("Tuple[str", "tuple[str")):
            return tuple(raw.split(","))
        return raw

    @classmethod
    def usage(cls) -> str:
        """CLI usage text: every option with its type, default, and (for
        enums) the accepted values (reference Config::print_help)."""
        lines = [
            "Usage: <app> [--key value | --key=value | --flag] ...",
            "",
            "  --config FILE   load `key = value` config file first "
            "(later CLI flags win)",
            "  --model NAME    alias for --turb_model",
            "",
            "Options (CLI > file > defaults):",
        ]
        for f in dataclasses.fields(cls):
            if f.name.endswith("_specified"):
                continue  # internal triad-resolution markers
            default = getattr(cls(), f.name)
            if f.name in cls._ENUM_FIELDS:
                choices = "|".join(e.value for e in cls._ENUM_FIELDS[f.name])
                lines.append(f"  --{f.name} {{{choices}}}"
                             f"  (default: {getattr(default, 'value', default)})")
            else:
                tname = f.type if isinstance(f.type, str) else \
                    getattr(f.type, "__name__", str(f.type))
                lines.append(f"  --{f.name} <{tname}>  (default: {default!r})")
        return "\n".join(lines)

    @classmethod
    def from_file(cls, path: str, base: Optional["Config"] = None) -> "Config":
        """Load `key = value` config file (reference src/config.cpp:108)."""
        cfg = base or cls()
        updates = {}
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if "=" in line:
                    key, val = line.split("=", 1)
                else:
                    parts = line.split(None, 1)
                    if len(parts) != 2:
                        continue
                    key, val = parts
                key, val = key.strip(), val.strip()
                updates[key] = cls._coerce(key, val)
                if key in ("Re", "nu", "dp_dx"):
                    updates[f"{key}_specified"] = True
        return dataclasses.replace(cfg, **updates)

    def parse_args(self, argv) -> "Config":
        """Apply `--key value` / `--key=value` / `--flag` CLI overrides.

        Mirrors reference Config::parse_args (src/config.cpp:333); `--config
        FILE` loads a file first (CLI wins).
        """
        cfg = self
        updates = {}
        i = 0
        argv = list(argv)
        while i < len(argv):
            arg = argv[i]
            if arg in ("-h", "help"):  # short/bare help, before '--' check
                print(self.usage())
                raise SystemExit(0)
            if not arg.startswith("--"):
                raise ValueError(f"Config: unexpected argument '{arg}'")
            body = arg[2:]
            if "=" in body:
                key, val = body.split("=", 1)
                i += 1
            else:
                key = body
                if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                    val = argv[i + 1]
                    i += 2
                else:
                    val = "true"  # bare flag
                    i += 1
            key = key.replace("-", "_")
            if key in ("help", "h"):
                print(self.usage())
                raise SystemExit(0)
            if key == "config":
                cfg = Config.from_file(val, base=cfg)
                continue
            if key == "model":  # reference alias: --model sst
                key = "turb_model"
            updates[key] = self._coerce(key, val)
            if key in ("Re", "nu", "dp_dx"):
                updates[f"{key}_specified"] = True
        return dataclasses.replace(cfg, **updates)
