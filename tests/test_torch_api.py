"""The port's public solver API (solver.py: project_initial_velocity,
solve_steady, solve_steady_with_snapshots, advance_unsteady, run and step)
against the JAX reference at float64 on the CPU, and `run`'s CUDA-graph
replay logic.

States start in the reference and cross as NumPy arrays. Limits: fields
1e-12 of each one's scale; residuals 1e-10 relative; iteration counts and
callback sequences exactly. The graph replay is held to the plain loop bit
for bit: on the CPU with an eager stand-in for the capture
(`Simulation._capture`, whose replay runs the captured body again), and on
a CUDA card with real graphs (the `cuda` test).
"""

import dataclasses

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch.solver import Simulation

KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
# the perturbed stretched channel of the projection and benchmark-mode tests
CHANNEL = dict(Nx=16, Ny=24, Nz=16, stretch_y=True, nu=0.05, nu_specified=True,
               dp_dx=-1e-3, dp_dx_specified=True, dt=1e-3, adaptive_dt=False,
               dtype="float64")
# the steady Poiseuille: rest start, 2-D, converging in a few hundred steps
POISEUILLE = dict(Nx=8, Ny=16, Nz=1, nu=0.05, nu_specified=True, dp_dx=-1.0,
                  dp_dx_specified=True, dt=0.05, adaptive_dt=False,
                  diag_interval=10, max_steps=2000, tol=0.1,
                  dtype="float64", verbose=False)


def _pair(**kw):
    """(reference Simulation, port Simulation) of one config."""
    rs = R.Simulation(R.Config(**kw))
    return rs, Simulation(T.Config(**kw), device="cpu")


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k, None) is not None}, "cpu", torch.float64)


def _close_scaled(got, want, what, tol=1e-12):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _close_states(got, want, keys=("u", "v", "w", "p", "t")):
    for k in keys:
        _close_scaled(getattr(got, k).numpy(), getattr(want, k), k)
    assert int(got.step) == int(want.step)


def _same(a, b):
    """Whether two States (or StepDiagnostics) are equal bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x, y):
            return False
    return True


def test_project_initial_velocity_matches_reference():
    """One projection at dt = 1 of a perturbed stretched channel: the
    velocity to 1e-12 of its scale, divergence-free, p and t untouched."""
    rs, ps = _pair(**CHANNEL)
    r0 = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.3)
    want = rs.project_initial_velocity(r0)
    p0 = _to_port(r0)
    got = ps.project_initial_velocity(p0)
    _close_states(got, want)
    assert got.p is p0.p and got.t is p0.t
    div = T.ops.operators.divergence(got.velocity, ps.geom)
    before = T.ops.operators.divergence(p0.velocity, ps.geom)
    assert float(div.abs().max()) < 1e-10 * float(before.abs().max())


@pytest.mark.parametrize("tol,max_steps", [(0.1, 2000), (0.0, 60)],
                         ids=["converged", "capped"])
def test_solve_steady_matches_reference(tol, max_steps):
    """solve_steady of a rest-start Poiseuille (residual read every
    diag_interval = 10 steps): the same step count, converged or at the
    cap, the final residual to 1e-10 relative, the fields to 1e-12."""
    rs, ps = _pair(**POISEUILLE)
    r0 = R.init_poiseuille(rs.cfg, rs.mesh)
    want, dw = rs.solve_steady(r0, tol=tol, max_steps=max_steps)
    got, dg = ps.solve_steady(_to_port(r0), tol=tol, max_steps=max_steps)
    assert int(got.step) == int(want.step)
    if tol:
        assert int(want.step) < max_steps
    else:
        assert int(want.step) == max_steps
    np.testing.assert_allclose(float(dg.residual), float(dw.residual),
                               rtol=1e-10)
    _close_states(got, want)


def test_solve_steady_raises_on_nan():
    """A non-finite residual raises FloatingPointError, as the reference's."""
    ps = Simulation(T.Config(**dict(POISEUILLE, dt=10.0)), device="cpu")
    with pytest.raises(FloatingPointError):
        ps.solve_steady(ps.initial_state(), tol=0.0, max_steps=400)


def test_solve_steady_with_snapshots_matches_reference():
    """The snapshot callback's iterations (">= snapshot_every" since the
    last, checked every diag_interval steps) and states are the
    reference's."""
    rs, ps = _pair(**POISEUILLE)
    r0 = R.init_poiseuille(rs.cfg, rs.mesh)
    seen_r, seen_p = [], []
    rs.solve_steady_with_snapshots(
        r0, lambda it, st, d: seen_r.append((it, np.asarray(st.u))),
        snapshot_every=25, tol=0.0, max_steps=120)
    ps.solve_steady_with_snapshots(
        _to_port(r0), lambda it, st, d: seen_p.append((it, st.u.numpy())),
        snapshot_every=25, tol=0.0, max_steps=120)
    assert [i for i, _ in seen_p] == [i for i, _ in seen_r] == [30, 60, 90,
                                                                120]
    for (_, a), (_, b) in zip(seen_p, seen_r):
        _close_scaled(a, b, "u")


@pytest.mark.parametrize("with_callback", [False, True])
def test_advance_unsteady_matches_reference(with_callback):
    """advance_unsteady: one run without a callback, step by step with one;
    the same callback iterations and states as the reference."""
    rs, ps = _pair(**dict(CHANNEL, Nz=8))
    r0 = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    its_r, its_p = [], []
    cb_r = (lambda it, st, d: its_r.append((it, float(d.residual)))
            if with_callback else None)
    cb_p = (lambda it, st, d: its_p.append((it, float(d.residual)))
            if with_callback else None)
    want, dw = rs.advance_unsteady(r0, 5, callback=cb_r)
    got, dg = ps.advance_unsteady(_to_port(r0), 5, callback=cb_p)
    _close_states(got, want)
    np.testing.assert_allclose(float(dg.residual), float(dw.residual),
                               rtol=1e-10)
    assert [i for i, _ in its_p] == [i for i, _ in its_r]
    assert [i for i, _ in its_p] == ([1, 2, 3, 4, 5] if with_callback
                                     else [])
    np.testing.assert_allclose([r for _, r in its_p], [r for _, r in its_r],
                               rtol=1e-10)


def test_benchmark_mode_run_reports_real_residual():
    """In benchmark mode run() skips the reductions on all but its last
    step, which returns the reference's residual (not the fast path's 0),
    so solve_steady runs every requested step."""
    rs, ps = _pair(**dict(CHANNEL, Nz=8, benchmark=True))
    r0 = R.perturbed_channel(rs.cfg, rs.mesh)
    want, dw = rs.run(r0, 5)
    got, dg = ps.run(_to_port(r0), 5)
    assert float(dg.residual) > 0.0 and int(got.step) == 5
    np.testing.assert_allclose(float(dg.residual), float(dw.residual),
                               rtol=1e-10)
    _close_states(got, want)
    st2, _ = ps.solve_steady(_to_port(r0), tol=0.0, max_steps=12)
    assert int(st2.step) == 12


class _Replay:
    """An eager stand-in for a captured graph: replay runs the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _eager_capture(self, warm, body):
    warm()
    return _Replay(body), {}, 0


@pytest.mark.parametrize("case,mode", [
    ("tgv", "benchmark"), ("tgv_re1600", "perf"), ("les_channel", "every"),
    ("rans_channel", "benchmark")])
def test_graph_replay_matches_the_loop(monkeypatch, case, mode):
    """run's graph path (buffers, chunks of GRAPH_CHUNK and single steps,
    the last step with diagnostics in benchmark or perf mode, every step
    with them otherwise) with an eager stand-in for the capture and
    chunks of 4 steps: bit for bit the plain loop for 1, 2, 9 and 21
    steps, a returned State left
    as it was by the next run, the caller's state never written, the
    graphs captured once a kind."""
    monkeypatch.setattr(Simulation, "_capture", _eager_capture)
    monkeypatch.setattr(Simulation, "_graphed", lambda self, st: True)
    # chunks of 4: 9 and 21 steps replay two and five of them
    monkeypatch.setattr(T.solver, "GRAPH_CHUNK", 4)
    kw = dict(Ny=12) if case in ("les_channel", "rans_channel") else {}
    sim, st = getattr(bench, case + "_case")(16, device="cpu",
                                             dtype="float64", **kw)
    if mode == "every":
        sim = Simulation(sim.cfg.with_(benchmark=False, perf_mode=False),
                         device="cpu")
    fast = sim.cfg.benchmark or sim.cfg.perf_mode
    assert fast == (mode != "every")
    st0 = T.State(**{k: (None if v is None else v.clone())
                     for k, v in vars(st).items()})
    for n in (1, 2, 9, 21):
        ref, dref = sim._run_loop(st, n, fast)
        got, dgot = sim.run(st, n)
        assert _same(ref, got) and _same(dref, dgot), n
    kept = T.State(**{k: (None if v is None else v.clone())
                      for k, v in vars(got).items()})
    sim.run(got, 3)
    assert _same(got, kept) and _same(st, st0)
    kinds = sorted(k[1:] for k in sim._graphs)
    assert kinds == ([(False, 1), (False, 4), (True, 1)] if fast
                     else [(True, 1), (True, 4)])


def test_run_copies_in_only_what_the_buffers_lack(monkeypatch):
    """run skips the copy into the graphs' buffers for the State the last
    graphed run returned, unwritten since, and copies any other in (one
    written in place, an older one, a fresh one): each run bit for bit
    the loop from the state it was given."""
    from cfdnn_tpu_torch.solver import _same_tensors
    monkeypatch.setattr(Simulation, "_capture", _eager_capture)
    monkeypatch.setattr(Simulation, "_graphed", lambda self, st: True)
    monkeypatch.setattr(T.solver, "GRAPH_CHUNK", 4)
    sim, st = bench.tgv_case(16, device="cpu", dtype="float64")
    fast = sim.cfg.benchmark or sim.cfg.perf_mode
    members = tuple(k for k in KEYS if getattr(st, k, None) is not None)

    def holds(state):
        return _same_tensors(sim._graph_holds.get(members), state, members)

    a, _ = sim.run(st, 5)
    assert holds(a) and not holds(st)
    b, _ = sim.run(a, 3)          # held: no copy
    assert _same(b, sim._run_loop(sim._run_loop(st, 5, fast)[0], 3, fast)[0])
    a.u.mul_(1.5)                 # written in place since: copied in
    assert not holds(a)
    c, _ = sim.run(a, 2)
    assert _same(c, sim._run_loop(a, 2, fast)[0])
    d, _ = sim.run(b, 2)          # an older result: copied in
    assert _same(d, sim._run_loop(b, 2, fast)[0])
    e, _ = sim.advance_unsteady(st, 6, callback=lambda *args: None)
    assert _same(e, sim._run_loop(st, 6, fast)[0])


def test_graph_buffers_refuse_another_state(monkeypatch):
    """The graph path raises ValueError for a member of another shape or
    dtype than the Simulation's (a graph replays what it captured), and an
    immersed body drops the graphs captured before it."""
    monkeypatch.setattr(Simulation, "_capture", _eager_capture)
    monkeypatch.setattr(Simulation, "_graphed", lambda self, st: True)
    sim, st = bench.tgv_case(16, device="cpu", dtype="float64")
    sim.run(st, 2)
    assert sim._graphs
    with pytest.raises(ValueError, match="state.u"):
        sim.run(st.replace(u=st.u[:8].contiguous()), 1)
    with pytest.raises(ValueError, match="state.p"):
        sim.run(st.replace(p=st.p.float()), 1)
    sim._plan()
    assert not sim._graphs


def test_graph_rules():
    """run replays graphs on a CUDA device only, never for a state that
    requires grad or with CFDNN_POISSON_DIAGNOSTICS (the loop's rules)."""
    sim, st = bench.tgv_case(8, device="cpu", dtype="float64")
    assert not sim._graphed(st)
    sim.device = torch.device("cuda")
    assert sim._graphed(st)
    assert not sim._graphed(st.replace(u=st.u.clone().requires_grad_()))
    sim._poisson_diagnostics = True
    assert not sim._graphed(st)


@pytest.mark.cuda
def test_captured_run_matches_the_loop_on_cuda():
    """On a CUDA card: run (CUDA graphs) against the plain loop on a
    32^3 Taylor-Green and a 32x24x32 LES channel, float64, bit for bit,
    with the kernels' launch counts those of the loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from cfdnn_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    for case, kw in ((bench.tgv_case, {}), (bench.les_channel_case,
                                            dict(Ny=24))):
        sim, st = case(32, device=dev, dtype="float64", **kw)
        fast = sim.cfg.benchmark or sim.cfg.perf_mode
        K.reset_launch_counts()
        ref, dref = sim._run_loop(st, 21, fast)
        loop = K.launch_counts()
        sim.run(st, 21)
        K.reset_launch_counts()
        got, dgot = sim.run(st, 21)
        assert K.launch_counts() == loop
        assert _same(ref, got) and _same(dref, dgot)


# a CUDA graph's DOT dump (cudaGraphDebugDotPrint, verbose) as CUDA 12.8
# writes it on the H100: two kernel nodes of the port, one of torch's, a copy
_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 54) | _ZN59_GLOBAL__N__4fc18437_26_predictor_periodic_tile_cu_5b39ba4d30predictor_periodic_tile_kernelIfEEvPKT_S3_S3_S3_PS1_S4_S4_iiiS1_S1_S1_S1_S1_i\<\<\<\{4,4\},256,0\>\>\>}
| {{node handle | func handle} | {0x0000000013B6A6B0 | 0x000000000E196650}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 53) | _ZN46_GLOBAL__N__35a9c929_13_divergence_cu_27bdac6217divergence_kernelIfEEvPKT_S3_S3_S3_S3_S3_PS1_iiiiiii\<\<\<\{4,4\},256,0\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 52) | _ZN2at6native18elementwise_kernelILi128ELi2EZNS0_22gpu_kernel_impl_nocastINS0_13BinaryFunctorIfffNS0_15binary_internal10DivFunctorIfEEEEEEvRNS_18TensorIteratorBaseERKT_EUliE_EEviT1_\<\<\<128,128,0\>\>\>}
}"];

"graph_1_node_3"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {3 (topoId: 51) | 0x0000000013B96DB0}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];
"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


def test_dot_kernel_symbols_read_a_dot_dump():
    """The kernel nodes of a CUDA graph's DOT dump, one symbol a kernel
    node (copies are not kernels), and the port's among them by wrapper."""
    from cfdnn_tpu_torch.ops import kernels as K
    symbols = K.dot_kernel_symbols(_DOT)
    assert len(symbols) == 3
    assert symbols[1].startswith("_ZN46_GLOBAL__N__35a9c929_13_divergence")
    assert K.device_launches((s, 1) for s in symbols) == {
        "predictor_periodic": 1, "divergence": 1}


@pytest.mark.parametrize("symbol,name", [
    ("_ZN49_GLOBAL__N__e24f5095_16_germano_pass1_cu_2facbb2d20germano_cells_"
     "kernelIfEEvN5cfdnn7LesGridIT_EEPKS3_PS3_Pdi", None),
    ("_ZN12_GLOBAL__N_110fht_kernelIfLi0ELi128EEvPKT_", "fht_pass"),
    ("void (anonymous namespace)::fht_kernel<double, 1, 0>(double const*)",
     "fht_pass"),
    ("void (anonymous namespace)::fht_kernel<float, 2, 128>(float const*)",
     "fht_modal"),
    ("void (anonymous namespace)::divergence_xz_kernel<float>(float const*)",
     "divergence_xz"),
    ("void (anonymous namespace)::divergence_kernel<float>(float const*)",
     "divergence"),
    ("void (anonymous namespace)::predictor_channel_div_tile_kernel<float, "
     "true, false>(float const*)", "predictor_channel_div"),
    ("void (anonymous namespace)::predictor_general_kernel<double>(x)",
     "predictor_general"),
    ("void (anonymous namespace)::predictor_general_xz_kernel<float>(x)",
     "predictor_general_xz"),
    ("_Z14vector_fft_r2cILj32E3EPTIJLj32EEELj32ELj16EL9padding_t14E", None),
])
def test_device_launches_names_each_wrapper(symbol, name):
    """A kernel symbol, mangled (a graph's node) or demangled (a profiler
    record), counts for its wrapper; germano_pass1 counts a call only with
    both of its kernels; library kernels count for none."""
    from cfdnn_tpu_torch.ops import kernels as K
    assert K.device_launches([(symbol, 2)]) == ({name: 2} if name else {})


def test_device_launches_germano_needs_both_kernels():
    from cfdnn_tpu_torch.ops import kernels as K
    cells = "void (anonymous namespace)::germano_cells_kernel<float>(x)"
    rows = "void (anonymous namespace)::germano_rows_kernel<float>(x)"
    assert K.device_launches([(cells, 3), (rows, 2)]) == {"germano_pass1": 2}
    assert K.device_launches([(cells, 3)]) == {}


class _Event:
    def __init__(self, key, count):
        self.key, self.count = key, count


def test_profiler_window_must_hold_every_launch():
    """bench.window_complete: a window's records hold each of the port's
    kernels exactly as often as it launched, and at least as many kernel
    records (copies and fills left out) as the graph kernel nodes it
    replayed."""
    div = "void (anonymous namespace)::divergence_kernel<float>(float const*)"
    lib = "void at::native::reduce_kernel<512, 1>(x)"
    copy = "Memcpy DtoD (Device -> Device)"
    events = [_Event(div, 4), _Event(lib, 8), _Event(copy, 5)]
    assert bench.window_complete(events, ({"divergence": 4}, 12))[0]
    assert not bench.window_complete(events, ({"divergence": 5}, 12))[0]
    assert not bench.window_complete(events, ({"divergence": 4}, 13))[0]
    assert not bench.window_complete(events, ({}, 0))[0]
