#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfdnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card's name and power limit (nvidia-smi); build the four CUDA
     kernels from cfdnn_tpu_torch/csrc and report the build seconds;
  2. each kernel against its plain PyTorch twin on the card, float64 at
     32^3 (channel 32x48x32, stretched) to 1e-12 * max(1, max|twin|), and
     float32 at the 128^3 main-path shapes to 1e-5 * max|twin|;
  3. the main path: Simulation.run of the 128^3 Taylor-Green and channel
     benchmark configurations (float32, 200 steps, use_pallas="auto"),
     each with the launch counts set to 0 just before and read just after;
     every kernel of the path must have launched once per step, the fields
     must be finite and of their shapes, the TGV's kinetic energy must have
     decayed and the channel's post-projection divergence be <= 1e-3;
  4. the same configurations at 32^3 in float64 for 20 steps, kernels on
     against use_pallas="off" on the card and against the eager operators
     on the CPU (which the CPU tests hold to the JAX reference), <= 1e-11;
  5. timing: ms/step and Mcells/s of both 128^3 steps (marginal step time,
     as the port's bench.py) and each kernel against its twin at the 128^3
     shapes with CUDA events.
It prints the `kernels` JSON line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}. Without a CUDA device it exits nonzero
before printing any result.
"""

import json
import math
import subprocess
import sys
import time

import torch

F64_TOL = 1e-12
F32_TOL = 1e-5
TRAJ_TOL = 1e-11
MAIN_STEPS = 200
KERNEL_REPLACES = {
    "predictor_periodic": "cfdnn_tpu/ops/pallas_kernels.py:1373",
    "predictor_channel": "cfdnn_tpu/ops/pallas_kernels.py:1330",
    "divergence": "cfdnn_tpu/ops/pallas_kernels.py:707",
    "correct": "cfdnn_tpu/ops/pallas_kernels.py:717",
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from cfdnn_tpu_torch.ops import kernels
    path, seconds = kernels.build_library()
    kernels.library()
    print(f"[build] {path} in {seconds:.1f} s")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _cases(n, dtype, device, seed):
    """(name, kernel call, twin call) for the four kernels on random fields
    at the main path's shapes: n^3, the channel stretched with Ny = n
    (3n/2 for the float64 check)."""
    from cfdnn_tpu_torch import bench
    from cfdnn_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    dts = "float64" if dtype == torch.float64 else "float32"
    tgv = bench.tgv_config(n, dts).finalize()
    ch = bench.channel_config(n, dts).with_(
        Ny=n if dtype == torch.float32 else 3 * n // 2).finalize()
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops.grid import Geometry
    g_t = Geometry.make(Mesh.from_config(tgv), tgv, device)
    g_c = Geometry.make(Mesh.from_config(ch), ch, device)
    from cfdnn_tpu_torch.fields import velocity_shapes
    ut, vt, wt = (rnd(s) for s in velocity_shapes(tgv))
    uc, vc, wc = (rnd(s) for s in velocity_shapes(ch))
    pc, pt = rnd((ch.Nx, ch.Ny, ch.Nz)), rnd((tgv.Nx, tgv.Ny, tgv.Nz))
    dt_t = torch.full((), tgv.dt, dtype=dtype, device=device)
    dt_c = torch.full((), ch.dt, dtype=dtype, device=device)
    ys = K.channel_y_arrays(g_c)
    kp = dict(hx=g_t.x.h, hy=g_t.y.h, hz=g_t.z.h, nu=tgv.nu, fx=0.0)
    kc = dict(hx=g_c.x.h, hz=g_c.z.h, nu=ch.nu, fx=-ch.dp_dx,
              scheme=ch.convective_scheme)
    return [
        ("predictor_periodic",
         lambda: K.predictor_periodic(ut, vt, wt, dt_t, **kp),
         lambda: K.predictor_periodic_twin(ut, vt, wt, dt_t, **kp)),
        ("predictor_channel",
         lambda: K.predictor_channel(uc, vc, wc, dt_c, ys, **kc),
         lambda: K.predictor_channel_twin(uc, vc, wc, dt_c, *ys, **kc)),
        ("divergence",
         lambda: K.divergence(uc, vc, wc, geom=g_c),
         lambda: K.divergence_twin(uc, vc, wc, geom=g_c)),
        ("correct",
         lambda: K.correct(uc, vc, wc, pc, dt_c, geom=g_c),
         lambda: K.correct_twin(uc, vc, wc, pc, dt_c, geom=g_c)),
        # the all-periodic grid of the TGV path (no bounded axis)
        ("divergence",
         lambda: K.divergence(ut, vt, wt, geom=g_t),
         lambda: K.divergence_twin(ut, vt, wt, geom=g_t)),
        ("correct",
         lambda: K.correct(ut, vt, wt, pt, dt_t, geom=g_t),
         lambda: K.correct_twin(ut, vt, wt, pt, dt_t, geom=g_t)),
    ]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(_as_tuple(a), _as_tuple(b)))


def _max_abs(a):
    return max(float(x.abs().max()) for x in _as_tuple(a))


def phase_kernels(device):
    """Each kernel against its twin on each grid of the main path; returns
    {name: [largest float64 error, largest float32 error]}."""
    errs = {}
    for dtype, n, rel in ((torch.float64, 32, F64_TOL),
                          (torch.float32, 128, F32_TOL)):
        for name, kern, twin in _cases(n, dtype, device, seed=1):
            got = kern()
            torch.cuda.synchronize()
            ref = twin()
            err, scale = _max_err(got, ref), _max_abs(ref)
            lim = rel * (max(1.0, scale) if dtype == torch.float64 else scale)
            shape = tuple(_as_tuple(ref)[-1].shape)
            print(f"[kernels] {name} {str(dtype)[6:]} {shape}: max|d|={err:.3e}"
                  f" (limit {lim:.3e}, max|twin|={scale:.3e})")
            check(err <= lim, f"{name} {dtype}: {err} > {lim}")
            pair = errs.setdefault(name, [0.0, 0.0])
            k = 0 if dtype == torch.float64 else 1
            pair[k] = max(pair[k], err)
    return errs


def _ke(st):
    return 0.5 * sum(float(torch.mean(c.double() ** 2)) for c in st.velocity)


def phase_main_path(device):
    """Drive both 128^3 benchmark steps through Simulation.run; returns
    the launch counts of the kernels summed over both runs and the
    channel's divergence."""
    from cfdnn_tpu_torch import bench, velocity_shapes
    from cfdnn_tpu_torch.ops import kernels as K
    total = {k.__name__: 0 for k in K.KERNELS}
    out = {}
    for name, case, predictor in (("tgv", bench.tgv_case, "periodic"),
                                  ("channel", bench.channel_case, "channel")):
        sim, st = case(128, device=device)
        check(sim.kernels.predictor == predictor and sim.kernels.projection,
              f"{name}: kernel plan {sim.kernels}")
        ke0 = _ke(st)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        st, d = sim.run(st, MAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        want = {f"predictor_{predictor}": MAIN_STEPS,
                "divergence": MAIN_STEPS, "correct": MAIN_STEPS}
        for k, c in counts.items():
            check(c == want.get(k, 0),
                  f"{name}: {k} launched {c} times in {MAIN_STEPS} steps")
            total[k] += c
        for comp, shape in zip(st.velocity, velocity_shapes(sim.cfg)):
            check(tuple(comp.shape) == shape, f"{name}: shape {comp.shape}")
            check(bool(torch.isfinite(comp).all()), f"{name}: non-finite")
        ke, div = float(d.ke), float(d.div_linf)
        check(math.isfinite(ke), f"{name}: KE {ke}")
        check(div <= 1e-3, f"{name}: div_linf {div} > 1e-3")
        if name == "tgv":
            check(ke < ke0, f"tgv: KE {ke} did not decay from {ke0}")
        print(f"[main] {name} 128^3 float32 {MAIN_STEPS} steps in "
              f"{wall:.2f} s: launches {counts}, KE {ke0:.6e} -> {ke:.6e}, "
              f"div_linf {div:.3e}, t {float(st.t):.6f}")
        out[name] = div
    return total, out["channel"]


def phase_trajectories(device):
    """32^3 float64, 20 steps from one initial state: kernels on the card
    vs the eager operators on the card and on the CPU."""
    import numpy as np
    from cfdnn_tpu_torch import State, bench, state_to_numpy
    from cfdnn_tpu_torch.ops import kernels as K
    for name, case in (("tgv", bench.tgv_case),
                       ("channel", bench.channel_case)):
        sim_k, st0 = case(32, device=device, dtype="float64")
        check(sim_k.kernels.predictor is not None, f"{name}: no kernels")
        finals = {}
        for label, dev, mode in (("kernels", device, "auto"),
                                 ("off", device, "off"),
                                 ("cpu", "cpu", "off")):
            sim = sim_k if label == "kernels" else case(
                32, device=dev, dtype="float64", use_pallas=mode)[0]
            st = State(**{k: v.to(dev) for k, v in vars(st0).items()})
            K.reset_launch_counts()
            fin, _ = sim.run(st, 20)
            n = sum(K.launch_counts().values())
            check(n == (60 if label == "kernels" else 0),
                  f"{name} {label}: launches {K.launch_counts()}")
            finals[label] = state_to_numpy(fin)
        for label in ("off", "cpu"):
            err = max(float(np.max(np.abs(finals["kernels"][k]
                                          - finals[label][k])))
                      for k in ("u", "v", "w", "p"))
            print(f"[traj] {name} 32^3 float64 20 steps, kernels vs {label}:"
                  f" max|d| = {err:.3e}")
            check(err <= TRAJ_TOL, f"{name} vs {label}: {err}")


def _event_ms(fn, reps=50):
    """Milliseconds per call by CUDA events around `reps` calls: the time
    a caller waits, host-side wrapper work included where it is longer
    than the device's."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps=20):
    """Device milliseconds per call: the kernels' own time, summed over
    every kernel the call launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    from cfdnn_tpu_torch.bench import device_events
    return sum(e.self_device_time_total for e in device_events(prof)) \
        / reps / 1e3


def phase_timing(device):
    from cfdnn_tpu_torch import bench
    rows = {}
    for name, case in (("tgv", bench.tgv_case),
                       ("channel", bench.channel_case)):
        sim, st = case(128, device=device)
        s, d = bench.time_steps(sim, st)
        rows[f"{name}_ms_per_step"] = s * 1e3
        rows[f"{name}_mcells_per_s"] = 128 ** 3 / s / 1e6
        if name == "channel":
            rows["channel_div_linf_f32"] = float(d.div_linf)
        prof = bench.profile_steps(sim, st)
        busy = prof["device_ms_per_step"]
        check(busy > 0, f"{name}: the profiler recorded no device time")
        print(f"[profile] {name} 128^3: device {busy:.4f} ms/step of "
              f"{s * 1e3:.4f} ms/step (idle share {1 - busy / (s * 1e3):.3f};"
              f" profiled window {prof['wall_ms_per_step']:.4f} ms/step)")
        for kname, ms, count in prof["kernels"][:12]:
            print(f"[profile]   {ms:9.5f} ms/step  x{count:g}  {kname[:110]}")
    rows["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rows))
    times = {}
    with torch.no_grad():
        for name, kern, twin in _cases(128, torch.float32, device, seed=2):
            if name in times:   # timed on the channel grid, the larger
                continue
            times[name] = (_event_ms(kern), _event_ms(twin),
                           _device_ms(kern), _device_ms(twin))
            print(f"[timing] {name} 128^3 float32: per call kernel "
                  f"{times[name][0]:.4f} ms, twin {times[name][1]:.4f} ms; "
                  f"device kernel {times[name][2]:.4f} ms, twin "
                  f"{times[name][3]:.4f} ms")
    return rows, times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        return 1
    # the port itself, before anything is printed: a copy of this script
    # alone fails here
    import cfdnn_tpu_torch  # noqa: F401
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    phase_build()
    errs = phase_kernels(device)
    launches, div = phase_main_path(device)
    phase_trajectories(device)
    rows, times = phase_timing(device)
    from cfdnn_tpu_torch.ops import kernels as K
    entries = []
    for k in K.KERNELS:
        name = k.__name__
        entries.append({
            "name": name, "route": "cuda",
            "source": f"cfdnn_tpu_torch/csrc/{name}.cu",
            "replaces": KERNEL_REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name][1],
            "max_abs_err_f64": errs[name][0],
            "ms": times[name][0], "plain_ms": times[name][1],
            "device_ms": times[name][2], "plain_device_ms": times[name][3],
        })
    print(f"[main] channel_div_linf_f32 (200 steps) = {div:.3e}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
