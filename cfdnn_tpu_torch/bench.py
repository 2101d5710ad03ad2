"""Headline benchmark of the PyTorch port on one CUDA card.

Runs the exact configurations of the reference's `bench.py` `bench_tgv`
(128^3 all-periodic Taylor-Green, skew, dt 1e-3), `bench_channel` (128^3
channel, stretched no-slip y, central, dt 2e-4) and `bench_les_channel`
(the same channel at 128x64x128 with the static Smagorinsky closure),
two LES grids of the port's own: `les_tgv` (bench_tgv with static
Smagorinsky) and `les_duct` (the square duct of the reference's
apps/duct.py, stretched walls in y and z, at 128x96x96 with WALE and the
LES channel's physics), and `rans_channel`, bench_channel with the SST
closure started from the closure's k/omega estimate: the RANS
configuration the reference measured its transport kernel on
(scripts/measure_upwind.py:58-68). Forward Euler in float32 and benchmark
mode. Two more rows: `tgv_re1600`, the 128^3 Re 1600 Taylor-Green of
examples/09_taylor_green_3d/tgv_re1600.cfg (RK3, adaptive dt, CFL 0.6,
float32; in perf mode, since benchmark mode turns adaptive dt off), and
`les_ibm256`, bench.py's `bench_les_ibm` (bench.py:110-128): the LES
channel's physics at 256x128x256 with a cylinder (IBM). Four rows at
bench.py's production width, 512^3 (bench.py:185-186, over 100 steps):
`tgv512` and `channel512` with the Poisson transform left at "auto"
(cuFFT on the card, as the reference resolves it off a TPU), and
`tgv512_pfht` and `channel512_pfht`, the same with
poisson_transform="pallas_fft", the reference's large-grid transform on
a TPU: the hand-written Hartley kernels. One row at 640^3, `les_tgv640`
(les_tgv's configuration, dt 1e-4 as bench_tgv takes it above 128, over
100 steps as the 512^3 rows): the smallest cube whose y-z plane the
reference's TPU slab cannot hold (solver.slab_fits) and whose z tiles
(solver.xz_tileable), so it runs the (x, z)-tiled kernels, as the
reference's "xz" plan does. One row of the inflow/outflow pair,
`les_cylinder3900`: the LES cylinder at Re 3900 of
validation/run_les_cylinder3900.py (256x192x32, WALE, RK3, adaptive dt,
the convective outlet, an immersed cylinder; perf mode), which runs the
general predictor on the ghost-padded x. It prints one JSON line with
bench.py's headline keys: ms/step and Mcells/s of each grid, the
wall-bounded grids' float32 post-projection divergence, and the card.
Every row runs unfused (CFDNN_FUSE_DIV unset), as the reference's
default.

The `*_vs_baseline` ratios of bench.py are left out: they divide by
published H200 and RTX 6000 figures, not by a measurement on this card.

    python -m cfdnn_tpu_torch.bench

A card is required; there is no CPU fallback for a measurement.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from . import (BCType, Config, ConvectiveScheme, Simulation, TimeIntegrator,
               TurbulenceModel, init_taylor_green, perturbed_channel)
from .ibm import CylinderBody
from .utils.timing import marginal_step_seconds


def tgv_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_tgv's configuration. `kw` overrides any field
    (another grid, another Poisson transform)."""
    base = dict(
        Nx=n, Ny=n, Nz=n,
        bc_x=BCType.PERIODIC, bc_y=BCType.PERIODIC, bc_z=BCType.PERIODIC,
        y_min=0.0, y_max=2 * np.pi, z_min=0.0, z_max=2 * np.pi,
        nu=1.0 / 1600.0, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=1e-3 if n <= 128 else 1e-4, adaptive_dt=False,
        time_integrator=TimeIntegrator.EULER,
        convective_scheme=ConvectiveScheme.SKEW,
        benchmark=True, dtype=dtype)
    base.update(kw)
    return Config(**base)


def channel_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_channel's configuration. `kw` overrides any field
    (another Ny)."""
    base = dict(
        Nx=n, Ny=n, Nz=n, stretch_y=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4 if n <= 128 else 5e-5, adaptive_dt=False,
        benchmark=True, dtype=dtype)
    base.update(kw)
    return Config(**base)


def les_channel_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_les_channel's configuration: Nx = Nz = n, Ny = n/2
    (128x64x128), the channel's physics with static Smagorinsky. `kw`
    overrides any field (another closure, another Ny)."""
    base = dict(
        Nx=n, Ny=n // 2, Nz=n, stretch_y=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype=dtype,
        turb_model=TurbulenceModel.SMAGORINSKY)
    base.update(kw)
    return Config(**base)


def les_tgv_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench_tgv's configuration with the static Smagorinsky closure (Cs
    0.17): the reference's LES Taylor-Green (tests/test_les_validation.py
    :15-26) at the width of examples/09_taylor_green_3d/tgv_re1600.cfg, on
    bench.py's integrator (Euler, fixed dt). `kw` overrides any field."""
    return tgv_config(n, dtype, **{"turb_model": TurbulenceModel.SMAGORINSKY,
                                   **kw})


def les_duct_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """The square duct of the reference's apps/duct.py (x in [0, 4]
    periodic; y, z in [-1, 1], no-slip walls on both; central) at the LES
    channel's density, Nx = n and Ny = Nz = 3n/4 (128x96x96), both walls
    stretched (beta 2), with bench_les_channel's physics (nu 1e-4, dp_dx
    -1e-3, dt 2e-4) and the WALE closure, which needs no wall damping.
    `kw` overrides any field."""
    base = dict(
        Nx=n, Ny=3 * n // 4, Nz=3 * n // 4,
        x_min=0.0, x_max=4.0, y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
        bc_x=BCType.PERIODIC, bc_y=BCType.WALL, bc_z=BCType.WALL,
        stretch_y=True, stretch_z=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype=dtype,
        turb_model=TurbulenceModel.WALE)
    base.update(kw)
    return Config(**base)


def rans_channel_config(n: int = 128, dtype: str = "float32",
                        **kw) -> Config:
    """bench.py bench_channel's configuration with the SST k-omega closure
    (scripts/measure_upwind.py:58-68). `kw` overrides any field (another
    RANS closure, another Ny)."""
    return channel_config(n, dtype).with_(
        **{"turb_model": TurbulenceModel.SST, **kw})


TGV_RE1600_CFG = (Path(__file__).resolve().parents[1] / "examples"
                  / "09_taylor_green_3d" / "tgv_re1600.cfg")


def tgv_re1600_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """examples/09_taylor_green_3d/tgv_re1600.cfg (128^3 all-periodic,
    skew, RK3, adaptive dt at CFL 0.6, nu 6.25e-4, float32) in perf mode:
    benchmark mode would turn adaptive dt off (Config.finalize). `n`
    resizes the grid, `kw` overrides any field."""
    cfg = Config.from_file(str(TGV_RE1600_CFG))
    return cfg.with_(**{"Nx": n, "Ny": n, "Nz": n, "dtype": dtype,
                        "perf_mode": True, **kw})


def les_ibm_config(n: int = 256, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_les_ibm's configuration (bench.py:118-123): Nx = Nz
    = n, Ny = n/2 (256x128x256), x in [0, 4], z in [0, 2], the LES
    channel's physics (nu 1e-4, dp_dx -1e-3, dt 2e-4, Smagorinsky),
    float32, benchmark mode; the cylinder is attached by
    `les_ibm_case`. `kw` overrides any field."""
    base = dict(
        Nx=n, Ny=n // 2, Nz=n, x_max=4.0, z_max=2.0,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype=dtype,
        turb_model=TurbulenceModel.SMAGORINSKY)
    base.update(kw)
    return Config(**base)


def les_cylinder_config(n: int = 256, dtype: str = "float32",
                        **kw) -> Config:
    """The LES cylinder at Re 3900 of validation/run_les_cylinder3900.py
    (:36-51; the reference's scripts/les_cylinder_re3900.sh): Nx = n, Ny =
    3n/4, Nz = n/8 (256x192x32) over [0, 25] x [-8, 8] x [0, pi], the
    inflow/outflow pair in x with the convective outlet, periodic y and
    z, nu 1/3900, WALE, RK3, skew, adaptive dt at CFL 0.4 (safety 0.9),
    float32; in perf mode (benchmark mode turns adaptive dt off). The
    cylinder is attached by `les_cylinder_case`. `kw` overrides any
    field."""
    base = dict(
        Nx=n, Ny=3 * n // 4, Nz=max(n // 8, 1),
        x_min=0.0, x_max=25.0, y_min=-8.0, y_max=8.0,
        z_min=0.0, z_max=float(np.pi),
        bc_x=BCType.INFLOW, bc_y=BCType.PERIODIC, bc_z=BCType.PERIODIC,
        nu=1.0 / 3900.0, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=1e-3, adaptive_dt=True, CFL_max=0.4, dt_safety=0.9,
        time_integrator=TimeIntegrator.RK3,
        convective_scheme=ConvectiveScheme.SKEW,
        turb_model=TurbulenceModel.WALE, convective_outflow=True,
        perf_mode=True, dtype=dtype)
    base.update(kw)
    return Config(**base)


def les_cylinder_case(n=256, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES cylinder: the unit cylinder
    CylinderBody(5, 0, 0.5) attached, the validation script's start
    (:60-66: u = 1, the wake seed v = 1e-2 exp(-y^2) sin(x) (1 + 0.5
    sin(4 z)), in float64 then cast) through `Simulation.initialize`,
    which captures the inflow profile."""
    sim = Simulation(les_cylinder_config(n, dtype, **kw), device=device)
    sim.set_ibm_forcing(CylinderBody(5.0, 0.0, 0.5))
    st = sim.initial_state()
    mesh, f64 = sim.mesh, dict(dtype=torch.float64, device=sim.device)
    x = torch.as_tensor(mesh.x.centers, **f64)[:, None, None]
    yc = torch.as_tensor(mesh.y.centers, **f64)[None, :, None]
    zc = torch.as_tensor(mesh.z.centers, **f64)[None, None, :]
    v0 = 1e-2 * torch.exp(-(yc ** 2)) * torch.sin(x) * (
        1.0 + 0.5 * torch.sin(4 * zc))
    st = st.replace(u=torch.full_like(st.u, 1.0),
                    v=torch.broadcast_to(v0, st.v.shape).to(st.v.dtype)
                    .contiguous())
    return sim, sim.initialize(st)


def tgv_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the TGV benchmark."""
    sim = Simulation(tgv_config(n, dtype, **kw), device=device)
    return sim, init_taylor_green(sim.cfg, sim.mesh, device=device)


def les_tgv_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES Taylor-Green."""
    sim = Simulation(les_tgv_config(n, dtype, **kw), device=device)
    return sim, init_taylor_green(sim.cfg, sim.mesh, device=device)


def tgv_re1600_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the Re 1600 Taylor-Green
    (init_taylor_green)."""
    sim = Simulation(tgv_re1600_config(n, dtype, **kw), device=device)
    return sim, init_taylor_green(sim.cfg, sim.mesh, device=device)


def _noisy_case(config, n, device, dtype, kw):
    """A wall-bounded grid started from perturbed_channel(amp=0.05), the
    noise from a torch.Generator seeded with kw's `seed` (default 0)."""
    seed = kw.pop("seed", 0)
    sim = Simulation(config(n, dtype, **kw), device=device)
    gen = torch.Generator(device=sim.device).manual_seed(seed)
    return sim, perturbed_channel(sim.cfg, sim.mesh, gen, amp=0.05,
                                  device=device)


def channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the channel benchmark."""
    return _noisy_case(channel_config, n, device, dtype, kw)


def les_channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES channel benchmark."""
    return _noisy_case(les_channel_config, n, device, dtype, kw)


def les_duct_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES duct; the first step's BC
    pass zeroes the noise on w's z-wall faces."""
    return _noisy_case(les_duct_config, n, device, dtype, kw)


def rans_channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the RANS channel: perturbed_channel
    (amp 0.05) through `Simulation.initialize`, which sets k and omega to
    the closure's channel estimate (scripts/measure_upwind.py:43)."""
    sim, st = _noisy_case(rans_channel_config, n, device, dtype, kw)
    return sim, sim.initialize(st)


def les_ibm_case(n=256, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES + IBM row: the cylinder
    CylinderBody(1.0, 0.0, 0.25) attached (bench.py:124), then
    perturbed_channel(amp=0.05) from a seeded torch.Generator."""
    sim, st = _noisy_case(les_ibm_config, n, device, dtype, kw)
    sim.set_ibm_forcing(CylinderBody(1.0, 0.0, 0.25))
    return sim, st


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(sim, state, steps=1000, reps=3, run=None):
    """Differential best-of-reps seconds/step of `sim.run` (or of `run`,
    a callable (state, n) -> (state, diagnostics) of the same steps; the
    constant per-call cost, including the final diagnostics step, cancels)
    and the diagnostics of the first run. The first runs, untimed, capture
    the CUDA graphs that sim.run replays."""
    run_n = sim.run if run is None else run
    short = max(steps // 5, 1)
    state, d = run_n(state, steps)
    run_n(state, short)
    _sync(sim.device)
    if not math.isfinite(float(d.ke)):
        raise FloatingPointError("NaN in benchmark run")

    def run(n):
        run_n(state, n)
        _sync(sim.device)

    s = marginal_step_seconds(lambda: run(steps), lambda: run(short),
                              steps, short, reps)
    return s, d


def device_events(prof):
    """The device-side entries (kernels, copies, fills) of a finished
    torch.profiler run's key_averages()."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def _window(fn, n, spin):
    """(profile, host seconds, gated, device span in seconds, launched) of
    `fn(n)` under torch.profiler (CPU and CUDA activities), behind a spin
    kernel of `spin` cycles when it is nonzero; gated: the spin was still
    running when the host had enqueued all of fn, so the card ran fn back
    to back; launched: ({kernel: launches} of the port's kernels,
    CUDA-graph kernel nodes replayed) over fn(n), for `window_complete`.

    The profiler has been seen to drop the records of the first kernels
    after the spin (one to five a window), so SPIN_PAD one-cycle spin
    kernels, which `_recorded` leaves out, run between the spin and the
    window."""
    from torch.profiler import ProfilerActivity, profile
    from .ops import kernels
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    counts, nodes = kernels.launch_counts(), kernels.replayed_nodes()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if spin:
            torch.cuda._sleep(spin)
            for _ in range(SPIN_PAD):
                torch.cuda._sleep(1)
        start.record()
        fn(n)
        stop.record()
        host = time.perf_counter() - t0
        gated = not start.query()
        torch.cuda.synchronize()
    launched = ({k: c - counts[k] for k, c in kernels.launch_counts().items()
                 if c != counts[k]}, kernels.replayed_nodes() - nodes)
    return prof, host, gated, start.elapsed_time(stop) / 1e3, launched


# Spin-kernel cycles a second (~ the SM's top clock, so a slower clock only
# spins longer); the short spin kernels after it (`_window`); the least
# share of a profiler window's device span (less launch gaps) its recorded
# kernels must fill, and the windows tried.
SPIN_CYCLES_PER_S = 2e9
# (32 pads still lost the window's first two kernels, three windows of
# three, on one loop window on an H100: 128)
SPIN_PAD = 128
MIN_DEVICE_SHARE = 0.8
# (three windows of one kernel call on an H100 recorded no device event in
# two and 13 of its 20 launches in the third: five)
PROFILE_WINDOWS = 5


def _spin_for(seconds):
    """Spin-kernel cycles that outlast `seconds` of host time by half."""
    return int((1.5 * seconds + 0.01) * SPIN_CYCLES_PER_S)


def _recorded(prof):
    """(device events less the spin kernel, their device seconds, their
    count) of a window."""
    events = [e for e in device_events(prof) if "spin_kernel" not in e.key]
    return (events, sum(e.self_device_time_total for e in events) / 1e6,
            sum(e.count for e in events))


def is_copy(key):
    """Whether a device record is a copy or a fill, not a kernel."""
    return "memcpy" in key.lower() or "memset" in key.lower()


def window_complete(events, launched):
    """(whether a window recorded every launch it must hold, what it
    recorded of them): the port's kernels by name exactly their launches
    (`ops.kernels.device_launches` of the records), and at least as many
    kernel records (copies and fills left out) as the CUDA-graph kernel
    nodes it replayed. The profiler has been seen to drop a tenth of a
    window's records after graph replays had been traced."""
    from .ops import kernels
    port = kernels.device_launches((e.key, e.count) for e in events)
    n = sum(e.count for e in events if not is_copy(e.key))
    return port == launched[0] and n >= launched[1], (port, n)


_LAUNCH_GAP = []


def launch_gap():
    """Seconds the card leaves between two back-to-back kernels, measured
    once: a gated window of 256 one-element launches, its span less their
    recorded device time, per launch."""
    if not _LAUNCH_GAP:
        x = torch.ones(1, device="cuda")

        def fn(n):
            for _ in range(n):
                x.add_(1.0)

        fn(8)
        prof, host, _, _, _ = _window(fn, 256, 0)
        prof, _, gated, span, _ = _window(fn, 256, _spin_for(host))
        _, busy, count = _recorded(prof)
        if not gated or count != 256:
            raise RuntimeError(f"launch_gap: gated {gated}, {count} of 256 "
                               "launches recorded")
        _LAUNCH_GAP.append(max(span - busy, 0.0) / count)
    return _LAUNCH_GAP[0]


def profiled(fn, reps):
    """(device events, reps, device span in seconds) of `fn(reps)` under
    torch.profiler (CPU and CUDA activities).

    Each window starts behind a spin kernel that outlasts the host's
    enqueueing of fn, so the card then runs fn's work back to back, and
    CUDA events around it give the window's device span. The card queues
    only so many launches before the host blocks: where the spin had ended
    by the time the host finished enqueueing, the window ran at the host's
    pace and its span says nothing, so it is measured again with half the
    reps. The span holds the card's gap between back-to-back kernels
    (`launch_gap`) once per kernel besides the kernels' own time. The
    profiler has been seen to drop part of a window's events (a kernel read
    0 ms, another 60% of its time): a window whose recorded device time
    falls under MIN_DEVICE_SHARE of its span less those gaps, or that lacks
    a record of a launch it must hold (`window_complete`: each of the
    port's kernels by name, and every kernel node of the CUDA graphs it
    replayed), is measured again, and after PROFILE_WINDOWS such windows,
    or with the host ahead even at one rep, this raises."""
    gap = launch_gap()
    spin = _spin_for(_window(fn, reps, 0)[1])
    shares = []
    while len(shares) < PROFILE_WINDOWS:
        prof, _, gated, span, launched = _window(fn, reps, spin)
        if not gated:
            if reps == 1:
                raise RuntimeError("profiled: the spin ended before the host "
                                   "had enqueued one rep")
            reps //= 2
            continue
        events, busy, count = _recorded(prof)
        share = busy / max(span - count * gap, 1e-12)
        whole, got = window_complete(events, launched)
        if share >= MIN_DEVICE_SHARE and whole:
            return events, reps, span
        shares.append((round(share, 4), count, got, launched))
    raise RuntimeError(f"profiled: {PROFILE_WINDOWS} windows of {reps} reps "
                       f"each recorded under {MIN_DEVICE_SHARE} of their "
                       "device span less launch gaps, or without a launch "
                       "((share, records, (port kernels, kernel records), "
                       f"(port launches, graph kernel nodes)) {shares})")


def profile_steps(sim, state, steps=20, run=None):
    """Device time of a window of up to `steps` steps (fewer where the
    host's launches outrun the card's queue, `profiled`), by kernel, from
    torch.profiler (CUPTI): {"device_ms_per_step": total kernel time per
    step, "span_ms_per_step": the window's device span per step (its
    kernels back to back, the gaps between them included), "steps": the
    window's steps, "kernels": [(name, ms per step, launches per step),
    ...] longest first}. The window is one `sim.run` (or `run`, as
    time_steps takes it), so its last step carries the diagnostics
    reductions."""
    run = sim.run if run is None else run
    run(state, steps)
    _sync(sim.device)
    events, steps, span = profiled(lambda n: run(state, n), steps)
    rows = sorted(((e.key, e.self_device_time_total / steps / 1e3,
                    e.count / steps) for e in events),
                  key=lambda r: -r[1])
    return {"device_ms_per_step": sum(r[1] for r in rows),
            "span_ms_per_step": span * 1e3 / steps, "steps": steps,
            "kernels": rows}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("cfdnn_tpu_torch.bench: no CUDA device; the "
                         "benchmark measures the card and has no CPU path")
    s_tgv, _ = time_steps(*tgv_case())
    s_ch, d_ch = time_steps(*channel_case())
    # the reference times its LES row over 400 steps, and so are the
    # port's LES rows
    s_les, d_les = time_steps(*les_channel_case(), steps=400)
    s_ltgv, _ = time_steps(*les_tgv_case(), steps=400)
    s_duct, d_duct = time_steps(*les_duct_case(), steps=400)
    # 400/80 steps, as scripts/measure_upwind.py:37 times its RANS row
    s_rans, d_rans = time_steps(*rans_channel_case(), steps=400)
    s_re, _ = time_steps(*tgv_re1600_case(), steps=400)
    # 150/30 steps, as bench.py:110 times its LES + IBM row
    s_ibm, d_ibm = time_steps(*les_ibm_case(), steps=150)
    # the 512^3 rows over 100/20 steps, as bench.py:185-186 times them
    rows_512 = {}
    for key, case in (("tgv512", lambda: tgv_case(512)),
                      ("channel512", lambda: channel_case(512)),
                      ("tgv512_pfht",
                       lambda: tgv_case(512, poisson_transform="pallas_fft")),
                      ("channel512_pfht",
                       lambda: channel_case(512,
                                            poisson_transform="pallas_fft"))):
        s, d = time_steps(*case(), steps=100)
        rows_512[f"{key}_ms_per_step"] = s * 1e3
        rows_512[f"{key}_mcells_per_s"] = 512 ** 3 / s / 1e6
        if key.startswith("channel"):
            rows_512[f"{key}_div_linf_f32"] = float(d.div_linf)
    # 640^3, the "xz" plan, over 100/20 steps as the 512^3 rows
    s_640, _ = time_steps(*les_tgv_case(640), steps=100)
    # the LES cylinder (the inflow/outflow pair), 400/80 steps as the LES
    # rows
    s_cyl, d_cyl = time_steps(*les_cylinder_case(), steps=400)
    cyl_cells = 256 * 192 * 32
    cells = 128 ** 3
    ibm_cells = 256 * 128 * 256
    les_cells = 128 * 64 * 128
    duct_cells = 128 * 96 * 96
    print(json.dumps({
        "tgv_ms_per_step": s_tgv * 1e3,
        "tgv_mcells_per_s": cells / s_tgv / 1e6,
        "channel_ms_per_step": s_ch * 1e3,
        "channel_mcells_per_s": cells / s_ch / 1e6,
        "channel_div_linf_f32": float(d_ch.div_linf),
        "les_channel_ms_per_step": s_les * 1e3,
        "les_channel_mcells_per_s": les_cells / s_les / 1e6,
        "les_channel_div_linf_f32": float(d_les.div_linf),
        "les_tgv_ms_per_step": s_ltgv * 1e3,
        "les_tgv_mcells_per_s": cells / s_ltgv / 1e6,
        "les_duct_ms_per_step": s_duct * 1e3,
        "les_duct_mcells_per_s": duct_cells / s_duct / 1e6,
        "les_duct_div_linf_f32": float(d_duct.div_linf),
        "rans_channel_ms_per_step": s_rans * 1e3,
        "rans_channel_mcells_per_s": cells / s_rans / 1e6,
        "rans_channel_div_linf_f32": float(d_rans.div_linf),
        "tgv_re1600_ms_per_step": s_re * 1e3,
        "tgv_re1600_mcells_per_s": cells / s_re / 1e6,
        "les_ibm256_ms_per_step": s_ibm * 1e3,
        "les_ibm256_mcells_per_s": ibm_cells / s_ibm / 1e6,
        "les_ibm256_div_linf_f32": float(d_ibm.div_linf),
        **rows_512,
        "les_tgv640_ms_per_step": s_640 * 1e3,
        "les_tgv640_mcells_per_s": 640 ** 3 / s_640 / 1e6,
        "les_cylinder3900_ms_per_step": s_cyl * 1e3,
        "les_cylinder3900_mcells_per_s": cyl_cells / s_cyl / 1e6,
        "les_cylinder3900_div_linf_f32": float(d_cyl.div_linf),
        "device": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
