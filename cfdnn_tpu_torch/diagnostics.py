"""Diagnostics: energy budget, channel turbulence statistics, Stage-F
realism gates, turbulence presence classification (port of
`cfdnn_tpu/diagnostics.py`).

The reductions run on the state's device in torch; each public function
returns host floats and NumPy arrays, as the reference's do. The strain
algebra and the cell-centred velocity are the closures' own
(`turbulence/base.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .turbulence.base import cell_center_velocity, strain_rotation


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Energy budget
# ---------------------------------------------------------------------------


def volume_mean(f, geom):
    """Volume-weighted mean over cell centres (a plain mean would
    overweight the clustered near-wall cells on stretched meshes)."""
    V = None
    for a in range(3):
        ax = geom.axes[a]
        if ax.n > 1:
            V = ax.d if V is None else V * ax.d
    if V is None:
        return torch.mean(f)
    return torch.sum(f * V) / torch.sum(V.expand(f.shape))


def kinetic_energy(comps, geom):
    """Volume-weighted mean kinetic energy 0.5 <|u|^2> (cell-centred)."""
    u, v, w = cell_center_velocity(comps, geom)
    return 0.5 * volume_mean(u**2 + v**2 + w**2, geom)


def dissipation_rate(comps, nu, geom):
    """epsilon = <nu 2 S_ij S_ij>_V from the cell-centred gradient tensor;
    `nu` may be a scalar or a full nu_eff field (LES/RANS)."""
    sr = strain_rotation(comps, geom)
    return volume_mean(nu * sr.S_mag**2, geom)


def energy_budget(sim, state) -> Dict[str, float]:
    """KE, power input P = <f u>, dissipation; for a statistically steady
    channel P ~ epsilon."""
    comps = (state.u, state.v, state.w)
    geom, cfg = sim.geom, sim.cfg
    ke = kinetic_energy(comps, geom)
    fx = -cfg.dp_dx / cfg.rho
    ucc = cell_center_velocity(comps, geom)[0]
    power = fx * volume_mean(ucc, geom)
    nu_t = sim.turb.nu_t(state, sim)
    nu_eff = cfg.nu if nu_t is None else cfg.nu + nu_t
    eps = dissipation_rate(comps, nu_eff, geom)
    return {
        "ke": float(ke),
        "power_input": float(power),
        "dissipation": float(eps),
        "balance_residual": float(torch.abs(power - eps)
                                  / torch.clamp(torch.abs(power), min=1e-30)),
    }


# ---------------------------------------------------------------------------
# Channel statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChannelStats:
    """Plane-averaged (x-z) channel statistics."""

    y: np.ndarray
    U: np.ndarray            # mean streamwise velocity
    u_rms: np.ndarray
    v_rms: np.ndarray
    w_rms: np.ndarray
    uv: np.ndarray           # Reynolds shear stress <u'v'>
    u_tau: float
    Re_tau: float
    y_plus_1: float          # first-cell centre in wall units
    dx_plus: float
    dz_plus: float


def channel_statistics(sim, state) -> ChannelStats:
    """Single-snapshot statistics (average ChannelStats over snapshots, or
    use StatsAccumulator, for time statistics)."""
    cfg, geom, mesh = sim.cfg, sim.geom, sim.mesh
    u, v, w = cell_center_velocity((state.u, state.v, state.w), geom)
    U = torch.mean(u, dim=(0, 2))
    Vm = torch.mean(v, dim=(0, 2))
    Wm = torch.mean(w, dim=(0, 2))
    up = u - U[None, :, None]
    vp = v - Vm[None, :, None]
    wp = w - Wm[None, :, None]
    u_rms = torch.sqrt(torch.mean(up**2, dim=(0, 2)))
    v_rms = torch.sqrt(torch.mean(vp**2, dim=(0, 2)))
    w_rms = torch.sqrt(torch.mean(wp**2, dim=(0, 2)))
    uv = torch.mean(up * vp, dim=(0, 2))

    # u_tau from both walls, averaged; the y_max wall may move
    # (Config.lid_velocity), so its shear is taken relative to the wall
    y = mesh.y.centers
    d_lo = y[0] - mesh.y.lo
    d_hi = mesh.y.hi - y[-1]
    dudy_lo = float(U[0]) / d_lo
    dudy_hi = (cfg.lid_velocity - float(U[-1])) / d_hi
    u_tau = float(np.sqrt(cfg.nu * 0.5 * (abs(dudy_lo) + abs(dudy_hi))))
    delta = 0.5 * cfg.Ly
    Re_tau = u_tau * delta / cfg.nu
    lv = cfg.nu / max(u_tau, 1e-30)   # viscous length
    return ChannelStats(
        y=np.asarray(y), U=_np(U),
        u_rms=_np(u_rms), v_rms=_np(v_rms), w_rms=_np(w_rms), uv=_np(uv),
        u_tau=u_tau, Re_tau=float(Re_tau),
        y_plus_1=float(d_lo / lv),
        dx_plus=float(mesh.x.h / lv),
        dz_plus=float(mesh.z.h / lv) if mesh.Nz > 1 else 0.0,
    )


def _closure_defect(st: ChannelStats, cfg, nu_eff_y) -> float:
    """Max relative defect of tau(y) = nu_eff dU/dy - <u'v'> against the
    exact linear total stress tau = u_tau^2 (1 - y/delta)."""
    dUdy = np.gradient(st.U, st.y)
    tau_tot = nu_eff_y * dUdy - st.uv
    delta = 0.5 * cfg.Ly
    ymid = 0.5 * (cfg.y_min + cfg.y_max)
    tau_exact = st.u_tau**2 * (-(st.y - ymid) / delta)
    scale = max(st.u_tau**2, 1e-30)
    # exclude the few near-wall cells where gradients are least resolved
    sl = slice(2, -2)
    return float(np.max(np.abs(tau_tot[sl] - tau_exact[sl])) / scale)


def momentum_balance_closure(sim, state, st: ChannelStats = None) -> float:
    """Channel momentum balance: the max relative defect of the total
    stress nu_eff dU/dy - <u'v'> against u_tau^2 (1 - y/delta) (gate
    < 10%). With a closure on, the plane-averaged nu_t joins nu."""
    cfg = sim.cfg
    if st is None:
        st = channel_statistics(sim, state)
    nu_t = sim.turb.nu_t(state, sim)
    nu_eff_y = (cfg.nu if nu_t is None
                else cfg.nu + np.mean(_np(nu_t), axis=(0, 2)))
    return _closure_defect(st, cfg, nu_eff_y)


# ---------------------------------------------------------------------------
# Time-averaged statistics
# ---------------------------------------------------------------------------


class StatsAccumulator:
    """Running time average of the plane-averaged channel statistics:
    first and second moments of the cell-centred velocity over snapshots;
    `finalize()` returns a ChannelStats of the time-averaged fields."""

    def __init__(self, sim):
        self.sim = sim
        self.n = 0
        self.sums = None   # [U, V, W, uu, vv, ww, uv] plane profiles

    def update(self, state):
        u, v, w = cell_center_velocity((state.u, state.v, state.w),
                                       self.sim.geom)
        prof = [torch.mean(x, dim=(0, 2)) for x in (u, v, w)]
        prof += [torch.mean(u * u, dim=(0, 2)), torch.mean(v * v, dim=(0, 2)),
                 torch.mean(w * w, dim=(0, 2)), torch.mean(u * v, dim=(0, 2))]
        prof = [_np(p) for p in prof]
        if self.sums is None:
            self.sums = prof
        else:
            self.sums = [a + b for a, b in zip(self.sums, prof)]
        self.n += 1

    def finalize(self) -> ChannelStats:
        if self.n == 0:
            raise ValueError("StatsAccumulator: no snapshots accumulated")
        U, V, W, uu, vv, ww, uv = [s / self.n for s in self.sums]
        u_rms = np.sqrt(np.maximum(uu - U**2, 0.0))
        v_rms = np.sqrt(np.maximum(vv - V**2, 0.0))
        w_rms = np.sqrt(np.maximum(ww - W**2, 0.0))
        uv_f = uv - U * V
        cfg, mesh = self.sim.cfg, self.sim.mesh
        y = mesh.y.centers
        d_lo = y[0] - mesh.y.lo
        d_hi = mesh.y.hi - y[-1]
        u_tau = float(np.sqrt(cfg.nu * 0.5 * (
            abs(U[0]) / d_lo
            + abs(cfg.lid_velocity - U[-1]) / d_hi)))
        lv = cfg.nu / max(u_tau, 1e-30)
        return ChannelStats(
            y=np.asarray(y), U=U, u_rms=u_rms, v_rms=v_rms, w_rms=w_rms,
            uv=uv_f, u_tau=u_tau,
            Re_tau=float(u_tau * 0.5 * cfg.Ly / cfg.nu),
            y_plus_1=float(d_lo / lv), dx_plus=float(mesh.x.h / lv),
            dz_plus=float(mesh.z.h / lv) if mesh.Nz > 1 else 0.0)

    def momentum_balance_closure(self) -> float:
        """Closure defect from the time-averaged total stress (DNS path:
        no modelled stress, nu_eff = nu)."""
        return _closure_defect(self.finalize(), self.sim.cfg,
                               self.sim.cfg.nu)


# ---------------------------------------------------------------------------
# Log-law profile-shape fit
# ---------------------------------------------------------------------------

#: Centreline U+ from the MKM (Moser-Kim-Mansour 1999) channel DNS.
MKM_CENTERLINE_U_PLUS = {180.0: 18.30, 395.0: 20.13, 590.0: 21.26}

#: Bulk mean velocity U_b+ from the MKM channel DNS.
MKM_BULK_U_PLUS = {180.0: 15.63, 395.0: 17.54, 590.0: 18.65}


def log_law_fit(st: ChannelStats) -> Dict[str, float]:
    """Fit U+ = (1/kappa) ln y+ + B over the log region of a channel mean
    profile: kappa, B, the centreline U+ (against `MKM_CENTERLINE_U_PLUS`)
    and the number of fitted points. Both channel halves are folded onto
    one wall first; the window is y+ in [30, max(0.35 Re_tau, 55)]."""
    u_tau = max(st.u_tau, 1e-30)
    # the wall positions from ChannelStats: centres are symmetric about the
    # midplane ym, and y_plus_1 = (y[0] - y_lo) / lv with
    # lv = (ym - y_lo) / Re_tau, so y_lo = (y[0] - a ym) / (1 - a) with
    # a = y_plus_1 / Re_tau
    ym = 0.5 * (st.y[0] + st.y[-1])
    a = st.y_plus_1 / max(st.Re_tau, 1e-30)
    y_lo = (st.y[0] - a * ym) / (1.0 - a)
    lv = (ym - y_lo) / max(st.Re_tau, 1e-30)
    dist = np.minimum(st.y - y_lo, (2.0 * ym - y_lo) - st.y)
    y_plus = dist / lv
    u_plus = st.U / u_tau
    n = len(y_plus)
    half = n // 2
    yp = 0.5 * (y_plus[:half] + y_plus[::-1][:half])
    up = 0.5 * (u_plus[:half] + u_plus[::-1][:half])
    hi = max(0.35 * st.Re_tau, 55.0)
    sel = (yp >= 30.0) & (yp <= hi)
    out = {"centerline_u_plus": float(0.5 * (u_plus[n // 2]
                                             + u_plus[(n - 1) // 2])),
           "n_fit_points": int(sel.sum())}
    if sel.sum() >= 3:
        slope, intercept = np.polyfit(np.log(yp[sel]), up[sel], 1)
        out["kappa"] = float(1.0 / slope)
        out["B"] = float(intercept)
    else:
        out["kappa"] = float("nan")
        out["B"] = float("nan")
    return out


# ---------------------------------------------------------------------------
# Spectra
# ---------------------------------------------------------------------------


def spanwise_spectrum(sim, state, j: Optional[int] = None) -> np.ndarray:
    """1-D spanwise (z) energy spectrum of u at y-index j (default mid)."""
    u = cell_center_velocity((state.u, state.v, state.w), sim.geom)[0]
    j = u.shape[1] // 2 if j is None else j
    plane = u[:, j, :]
    hat = torch.fft.rfft(plane - torch.mean(plane), dim=-1)
    return _np(torch.mean(torch.abs(hat) ** 2, dim=0))


def spectrum_pileup_ratio(E: np.ndarray) -> float:
    """Energy at the Nyquist tail relative to the peak: a high-wavenumber
    pile-up marks an under-resolved or aliased field."""
    peak = float(np.max(E[1:])) if len(E) > 2 else 1.0
    tail = float(np.mean(E[-2:]))
    return tail / max(peak, 1e-300)


def energy_spectrum_3d(sim, state):
    """Shell-averaged 3-D kinetic-energy spectrum E(k) on an all-periodic
    box: (k, E) with integer wavenumber shells; Parseval: sum(E) is the
    mean KE density 0.5 <|u|^2>."""
    if not all(ax.periodic for ax in sim.geom.axes):
        raise ValueError("energy_spectrum_3d requires an all-periodic box")
    comps = cell_center_velocity((state.u, state.v, state.w), sim.geom)
    shape = comps[0].shape
    n_total = int(np.prod(shape))
    # rfft on the last axis: the interior k of the half spectrum count
    # twice (the conjugate half), the zero and (even n) Nyquist planes once
    w2 = torch.full((shape[-1] // 2 + 1,), 2.0, dtype=comps[0].dtype,
                    device=comps[0].device)
    w2[0] = 1.0
    if shape[-1] % 2 == 0:
        w2[-1] = 1.0
    e = None
    for c in comps:
        p = torch.abs(torch.fft.rfftn(c) / n_total) ** 2 * w2
        e = p if e is None else e + p
    e3 = _np(0.5 * e)
    ks = [np.fft.fftfreq(n, 1.0 / n) for n in shape[:-1]]
    ks.append(np.arange(shape[-1] // 2 + 1))
    K = np.sqrt(sum(np.square(k)[s] for k, s in
                    zip(ks, ((slice(None), None, None),
                             (None, slice(None), None),
                             (None, None, slice(None))))))
    shells = np.rint(K).astype(int)
    kmax = shells.max()
    E = np.bincount(shells.ravel(), weights=e3.ravel(), minlength=kmax + 1)
    return np.arange(kmax + 1), E


# ---------------------------------------------------------------------------
# Stage-F realism report
# ---------------------------------------------------------------------------


def _stage_f_gates(sim, state, st: ChannelStats, closure: float
                   ) -> Dict[str, object]:
    """The Stage-F gates: y+ <= 1, dx+ <= 15, dz+ <= 8, closure < 10%,
    u' > w' > v' in the core, and (3-D) the spectrum pile-up of the given
    snapshot (aliasing is an instantaneous property)."""
    checks = {}
    checks["y_plus_ok"] = st.y_plus_1 <= 1.0
    checks["dx_plus_ok"] = st.dx_plus <= 15.0
    checks["dz_plus_ok"] = st.dz_plus <= 8.0
    core = slice(len(st.y) // 4, 3 * len(st.y) // 4)
    checks["stress_ordering_ok"] = bool(
        np.mean(st.u_rms[core]) >= np.mean(st.w_rms[core]) - 1e-12
        and np.mean(st.w_rms[core]) >= np.mean(st.v_rms[core]) - 1e-12)
    checks["momentum_closure"] = closure
    checks["momentum_closure_ok"] = closure < 0.10
    if sim.mesh.Nz > 1:
        ratio = spectrum_pileup_ratio(spanwise_spectrum(sim, state))
        checks["spectrum_pileup"] = ratio
        checks["spectrum_ok"] = ratio < 0.1
    checks["u_tau"] = st.u_tau
    checks["Re_tau"] = st.Re_tau
    checks["all_ok"] = all(v for k, v in checks.items()
                           if k.endswith("_ok"))
    return checks


def realism_report(sim, state) -> Dict[str, object]:
    """The Stage-F gates on an instantaneous snapshot."""
    st = channel_statistics(sim, state)
    return _stage_f_gates(sim, state, st,
                          momentum_balance_closure(sim, state, st=st))


def realism_report_averaged(sim, state, acc: StatsAccumulator
                            ) -> Dict[str, object]:
    """The Stage-F gates on time-averaged statistics, the form they are
    defined for (an instantaneous closure can sit a few points above the
    10% gate in a healthy run)."""
    checks = _stage_f_gates(sim, state, acc.finalize(),
                            acc.momentum_balance_closure())
    checks["n_snapshots"] = acc.n
    return checks


# ---------------------------------------------------------------------------
# Turbulence presence classifier
# ---------------------------------------------------------------------------


class TurbulencePresenceClassifier:
    """Rolling-window fluctuation-level classifier with hysteresis:
    'laminar' -> 'turbulent' once the rms transverse velocity exceeds `hi`
    over a whole window, back once it stays below `lo`."""

    def __init__(self, window: int = 10, hi: float = 1e-3, lo: float = 1e-4):
        self.window = window
        self.hi = hi
        self.lo = lo
        self.history: List[float] = []
        self.state = "laminar"

    def update(self, sim, state) -> str:
        w_int = float(torch.sqrt(torch.mean(state.w**2)))
        v_int = float(torch.sqrt(torch.mean(state.v**2)))
        level = max(w_int, v_int)
        self.history.append(level)
        if len(self.history) > self.window:
            self.history.pop(0)
        if len(self.history) == self.window:
            if self.state == "laminar" and min(self.history) > self.hi:
                self.state = "turbulent"
            elif self.state == "turbulent" and max(self.history) < self.lo:
                self.state = "laminar"
        return self.state
