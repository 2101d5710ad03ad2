"""Flow state as a dataclass of tensors (port of `cfdnn_tpu/fields.py`).

Unique-DOF staggered shapes (see mesh.py docstring): a normal-velocity
component has N faces on a periodic axis and N+1 faces (boundary faces
stored) on a wall/inflow/outflow axis. Arrays are (x, y, z) with z
contiguous, exactly the reference's layout, so a reference state crosses
into the port and back with no reshaping (`state_from_numpy`,
`state_to_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .config import BCType, Config, TurbulenceModel
from .mesh import Mesh


def _nfaces(n: int, bc: BCType) -> int:
    return n if bc == BCType.PERIODIC else n + 1


def velocity_shapes(cfg: Config) -> Tuple[Tuple[int, ...], ...]:
    """(u, v, w) array shapes for the unique-DOF staggered layout."""
    Nx, Ny, Nz = cfg.Nx, cfg.Ny, cfg.Nz
    u = (_nfaces(Nx, cfg.bc_x), Ny, Nz)
    v = (Nx, _nfaces(Ny, cfg.bc_y), Nz)
    w = (Nx, Ny, _nfaces(Nz, cfg.bc_z))
    return u, v, w


@dataclasses.dataclass(frozen=True)
class State:
    """Carried simulation state: one State in, one State out of `step`.

    `t`, `t_comp` and `dt_prev` are 0-d tensors of the working dtype and
    `step` a 0-d int32 tensor, all on the state's device, so a step never
    waits for the host. `nu_t` is the cell eddy viscosity of the last
    step, present whenever a turbulence closure is on; `k` and `omega`
    are the two-equation transport variables, present for the k-omega
    family (`needs_transport`). The reference's recycling members
    (inlet_*) are not carried: their slice (ROADMAP A.14) is not ported.
    """

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor                   # scalar physical time
    step: torch.Tensor                # scalar int step counter
    dt_prev: torch.Tensor             # last dt used
    # Kahan carry for t: in float32, plain t += dt loses the low bits of
    # dt once t/dt > ~2^24; the compensated sum keeps t exact to O(eps).
    t_comp: Optional[torch.Tensor] = None
    # turbulence transport variables, (Nx, Ny, Nz) each
    k: Optional[torch.Tensor] = None
    omega: Optional[torch.Tensor] = None
    nu_t: Optional[torch.Tensor] = None   # (Nx, Ny, Nz) eddy viscosity

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def velocity(self):
        return self.u, self.v, self.w


_STATE_KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k",
               "omega", "nu_t")
_NOT_CARRIED = ("inlet_u", "inlet_v", "inlet_w")


def state_from_numpy(d, device, dtype) -> State:
    """A State from a mapping of NumPy arrays, e.g. a JAX `State`'s members
    taken as `np.asarray(...)`. No reshape: the layouts are the same.

    Float members take `dtype`; `step` stays an int32 counter. A missing
    `t_comp` (older reference states) starts at zero; a missing or None
    `k`, `omega` or `nu_t` stays None. The recycling members must be
    absent or None: the port does not carry them.
    """
    for name in _NOT_CARRIED:
        if d.get(name) is not None:
            raise NotImplementedError(
                f"state member {name!r}: the port carries no recycling "
                "(inlet_*; ROADMAP A.14) state yet")
    out = {}
    for name in _STATE_KEYS:
        a = d.get(name)
        if a is None:
            continue
        kind = torch.int32 if name == "step" else dtype
        out[name] = torch.as_tensor(np.array(a), device=device).to(kind)
    if "t_comp" not in out:
        out["t_comp"] = torch.zeros((), dtype=dtype, device=device)
    return State(**out)


def state_to_numpy(state: State) -> dict:
    """The State's members as NumPy arrays on the host, keyed as
    `state_from_numpy` takes them."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in _STATE_KEYS if getattr(state, name) is not None}


def needs_transport(model: TurbulenceModel) -> bool:
    """Models whose state carries (k, omega): the two-equation transport
    family, and TBNN, which keeps an algebraic k/omega estimate for its
    time scale."""
    return model in (
        TurbulenceModel.SST,
        TurbulenceModel.KOMEGA,
        TurbulenceModel.EARSM_WJ,
        TurbulenceModel.EARSM_GS,
        TurbulenceModel.EARSM_POPE,
        TurbulenceModel.NN_TBNN,
    )


def zero_state(cfg: Config, *, device) -> State:
    dtype = getattr(torch, cfg.dtype)
    su, sv, sw = velocity_shapes(cfg)
    sc = (cfg.Nx, cfg.Ny, cfg.Nz)

    def z(s):
        return torch.zeros(s, dtype=dtype, device=device)

    def full(value):
        return torch.full(sc, value, dtype=dtype, device=device)

    transport = needs_transport(cfg.turb_model)
    return State(
        u=z(su), v=z(sv), w=z(sw), p=z(sc),
        t=z(()), t_comp=z(()),
        step=torch.zeros((), dtype=torch.int32, device=device),
        dt_prev=torch.full((), cfg.dt, dtype=dtype, device=device),
        k=full(1e-4) if transport else None,
        omega=full(1.0) if transport else None,
        nu_t=z(sc) if cfg.turb_model != TurbulenceModel.NONE else None,
    )


# ---------------------------------------------------------------------------
# Initial conditions
# ---------------------------------------------------------------------------


def poiseuille_exact(cfg: Config, y: np.ndarray) -> np.ndarray:
    """Analytic steady Poiseuille profile u(y) = -dp_dx/(2 nu) * (delta^2-y^2).

    y measured from the channel centerline; delta = half height.
    """
    delta = 0.5 * cfg.Ly
    yc = y - (cfg.y_min + delta)
    return (-cfg.dp_dx) / (2.0 * cfg.nu * cfg.rho) * (delta**2 - yc**2)


def init_poiseuille(cfg: Config, mesh: Mesh, fraction: float = 0.0, *,
                    device) -> State:
    """Channel IC: `fraction` of the analytic parabola (0 = rest start)."""
    st = zero_state(cfg, device=device)
    if fraction != 0.0:
        prof = fraction * poiseuille_exact(cfg, mesh.y.centers)
        u = torch.as_tensor(prof, device=device).to(st.u.dtype)
        st = st.replace(u=u[None, :, None].expand(st.u.shape).contiguous())
    return st


def init_taylor_green(cfg: Config, mesh: Mesh, V0: float = 1.0, *,
                      device) -> State:
    """3D Taylor-Green vortex IC on the staggered grid.

    u =  V0 sin(x) cos(y) cos(z); v = -V0 cos(x) sin(y) cos(z); w = 0,
    with each component sampled at its own face locations.
    """
    st = zero_state(cfg, device=device)
    xf, xc = mesh.x.faces[: st.u.shape[0]], mesh.x.centers
    yf, yc = mesh.y.faces[: st.v.shape[1]], mesh.y.centers
    zc = mesh.z.centers
    # scale factors so the box maps to one TGV period
    kx = 2.0 * np.pi / cfg.Lx
    ky = 2.0 * np.pi / cfg.Ly
    kz = 2.0 * np.pi / cfg.Lz

    def A(a):
        return torch.as_tensor(a, device=device).to(st.u.dtype)

    u = V0 * (
        np.sin(kx * (xf - cfg.x_min))[:, None, None]
        * np.cos(ky * (yc - cfg.y_min))[None, :, None]
        * np.cos(kz * (zc - cfg.z_min))[None, None, :]
    )
    v = -V0 * (
        np.cos(kx * (xc - cfg.x_min))[:, None, None]
        * np.sin(ky * (yf - cfg.y_min))[None, :, None]
        * np.cos(kz * (zc - cfg.z_min))[None, None, :]
    )
    p0 = (V0**2 / 16.0) * (
        (np.cos(2 * kx * (xc - cfg.x_min))[:, None, None]
         + np.cos(2 * ky * (yc - cfg.y_min))[None, :, None])
        * (np.cos(2 * kz * (zc - cfg.z_min))[None, None, :] + 2.0)
    )
    return st.replace(u=A(u), v=A(v), p=A(p0))


def perturbed_channel(cfg: Config, mesh: Mesh,
                      generator: Optional[torch.Generator] = None,
                      amp: Optional[float] = None, *, device) -> State:
    """Laminar parabola + uniform random perturbations for DNS trips.

    The noise comes from `generator` (a fresh one seeded with 0 when None),
    a `torch.Generator` on `device`. Its bits differ from the reference's
    `jax.random` draws for the same seed: the distribution is the same, the
    values are not. Tests that compare the two packages therefore make the
    state once and hand the arrays across (`state_from_numpy`).
    """
    st = init_poiseuille(cfg, mesh, fraction=1.0, device=device)
    amp = cfg.perturbation_amplitude if amp is None else amp
    if amp == 0.0:
        return st
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = st.u.dtype
    umax = float(np.max(np.abs(poiseuille_exact(cfg, mesh.y.centers)))) or 1.0
    scale = amp * umax

    def noise(shape):
        r = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return scale * (2.0 * r - 1.0)

    nu_, nv_, nw_ = noise(st.u.shape), noise(st.v.shape), noise(st.w.shape)
    if cfg.bc_y == BCType.WALL:
        # keep wall-normal faces at zero on walls
        nv_[:, 0, :] = 0.0
        nv_[:, -1, :] = 0.0
    return st.replace(u=st.u + nu_, v=nv_, w=st.w + nw_)
