"""A/B of predictor_general_xz_o4 (`csrc/predictor_general_xz_o4.cuh`)
against an older copy's and against textual variants of this one, on one
card.

For each copy (`--parent DIR`, an older commit's `cfdnn_tpu_torch/csrc`;
this copy, "kernel"; and each variant named on the command line, this
copy's sources with the substitutions of `SUBS`) it builds the O4 xz
predictor's two entry sources with the library's flags into a library of
their own, and prints for each instantiation of the kernel:
- ptxas's registers and spills (`-Xptxas=-v`);
- its blocks an SM (libcuda's cuOccupancyMaxActiveBlocksPerMultiprocessor
  with the kernel's dynamic shared memory: the copy's
  `cfdnn_xz_o4_shared_bytes`, or xz::Wide's six slots in a copy without
  it);
- the SASS instructions of its walk loop (the longest backward branch
  whose span holds a barrier: the plane body once for each kind of
  plane, and the next plane's copies) by kind:
  shared loads (LDS), FFMA, FADD, FMUL, the division sequences (MUFU.RCP
  and the CALL to the slow path), barriers, cp.async (LDGSTS), and all.
Then it holds each copy's kernel to the twin and to this copy's kernel on
chip_smoke's 512^3 O4 xz predictor calls (tgv_re1600_o4_512's skew box,
its central box with nu_t, channel512_o4's central walled y; float32,
1e-5 of scale) and times each call by the profiler's device time (5
calls) and CUDA events (20 calls) in turns: parent, kernel, variants,
kernel, parent; with the bytes the call must move over its device time.
With `--steps` it also times tgv_re1600_o4_512 and channel512_o4 a step
(bench.time_steps over 100 steps, the graphs replayed) with the parent's
kernel and this copy's, in the same turns.

Run on a machine with the CUDA toolkit, from the repository's root:

    mkdir -p build/parent
    git archive <old commit> cfdnn_tpu_torch/csrc | tar -x -C build/parent
    python -m cfdnn_tpu_torch.xz_o4_ab --parent build/parent/cfdnn_tpu_torch/csrc \\
        [--steps] [--listing] [--out DIR] [variant ...]

It writes a JSON of the numbers (xz_o4_ab.json) and, with --listing,
each kernel's walk loop (sass/) under --out (build/xz_o4_ab by default).
"""

import argparse
import concurrent.futures
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .ops import kernels as K

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "xz_o4_ab"
SOURCES = ("predictor_general_xz_o4.cu", "predictor_general_xz_o4_f64.cu")
# textual variants of this copy's sources (file, pattern, replacement)
SUBS = {
    # the blocks an SM the float32 kernel is built for (three without
    # nu_t, two with it, as it stands)
    "blocks2": [("xz_o4_plan.cuh", r"bytes == 4 && !nut \? 3 : 2", "2")],
    "blocks3": [("xz_o4_plan.cuh", r"bytes == 4 && !nut \? 3 : 2",
                 "bytes == 4 ? 3 : 2")],
    "blocks4": [("xz_o4_plan.cuh", r"bytes == 4 && !nut \? 3 : 2",
                 "bytes == 4 ? 4 : 2")],
    # one plane in flight in float32 (two as it stands)
    "ahead1": [("xz_o4_plan.cuh", r"bytes == 4 \? 2 : 1", "bytes == 4 ? 1 : 1")],
    # one point a copy (the copies' fallback for unaligned rows) where the
    # ring copies 16 bytes a copy
    "novec": [("predictor_general_xz_o4.cuh", r"wall_y, nyf, vec != 0\);",
               "wall_y, nyf, false);")],
    # divisions by 12 h, 12 h^2, den_f and den_c where the kernel
    # multiplies by their reciprocals (the reference's and the parent's
    # arithmetic)
    "div": [("xz_o4_tile.cuh", r"\* q\.r1\[A\]", "/ q.r1[A]"),
            ("xz_o4_tile.cuh", r"\* q\.r2\[A\]\);", "/ q.r2[A]);"),
            ("xz_o4_tile.cuh", r"\* met<S>\(kDenF, 0\)", "/ met<S>(kDenF, 0)"),
            ("xz_o4_tile.cuh", r"\* met<D>\(kDenC, 0\)", "/ met<D>(kDenC, 0)"),
            ("xz_o4_tile.cuh", r"m >= kDenC \? T\(1\) / vec\[row\] : vec\[row\]",
             "vec[row]"),
            ("predictor_general_xz_o4.cuh", r"T\(1\.0 / (o4\[2 \* a(?: \+ 1)?\])\)",
             r"T(\1)")],
}
WIDE_SLOTS = 6   # xz::Wide's ring, the kernel's before xz_o4_plan.cuh


def _variant(name: str) -> Path:
    """This copy's csrc with the variant's substitutions."""
    d = OUT / name / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(K._CSRC, d)
    for fname, pat, rep in SUBS[name]:
        f = d / fname
        text, n = re.subn(pat, rep, f.read_text())
        if not n:
            raise ValueError(f"variant {name}: {pat!r} not in {fname}")
        f.write_text(text)
    return d


def _build(tag: str, csrc: Path) -> dict:
    """Build the copy's O4 xz entries (and its plan exports, where it has
    them) into a library, and a cubin of each entry source; returns the
    paths and ptxas's report."""
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    nvcc = K._nvcc()
    srcs = [csrc / s for s in SOURCES] + [csrc / "error.cu"]
    if (csrc / "xz_o4_plan.cu").exists():
        srcs.append(csrc / "xz_o4_plan.cu")
    lib = out / "lib.so"
    cmds = [[nvcc, *K.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o", str(lib),
             *map(str, srcs)]]
    cubins = [out / (Path(s).stem + ".cubin") for s in SOURCES]
    cmds += [[nvcc, *K.NVCC_FLAGS, "-cubin", "-o", str(c), str(csrc / s)]
             for c, s in zip(cubins, SOURCES)]
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(lambda c: subprocess.run(
            c, capture_output=True, text=True), cmds))
    for cmd, r in zip(cmds, runs):
        if r.returncode:
            raise RuntimeError(f"{tag}: {' '.join(cmd)}\n{r.stderr}")
    return dict(lib=lib, cubins=cubins, ptxas=runs[0].stderr + runs[0].stdout)


def _demangle(names):
    tools = Path(K._nvcc()).parent
    out = subprocess.run([str(tools / "cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return [n.split(">(")[0].replace("void <unnamed>::", "")
            .replace("(bool)0", "false").replace("(bool)1", "true") + ">"
            for n in out.splitlines()]


def _ptxas(text: str) -> dict:
    """{mangled: (registers, spill stores, spill loads)}."""
    res, cur, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            res[cur] = (int(m.group(1)), *spill)
            cur, spill = None, (0, 0)
    return res


KINDS = {"LDS": r"^LDS\b", "FFMA": r"^FFMA\b", "FADD": r"^FADD\b",
         "FMUL": r"^FMUL\b", "DFMA": r"^DFMA\b", "DADD": r"^DADD\b",
         "DMUL": r"^DMUL\b", "MUFU.RCP": r"^MUFU\.RCP", "CALL": r"^CALL\b",
         "BAR": r"^BAR\b", "LDGSTS": r"^LDGSTS\b", "LDG": r"^LDG\b",
         "STG": r"^STG\b"}


def _sass(cubin: Path) -> dict:
    """{mangled: ({kind: count in the walk loop, "loop": its
    instructions, "all": the kernel's}, the loop's instructions)} from
    cuobjdump's listing."""
    tools = Path(K._nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(?:@!?U?P\w+\s+)?(.*?);",
                     line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    res = {}
    for name, ins in funcs.items():
        span = (0, len(ins))
        best = -1
        for n, (addr, op) in enumerate(ins):
            m = re.match(r"BRA\b.*0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                lo = next(q for q, (a, _) in enumerate(ins)
                          if a >= int(m.group(1), 16))
                walk = any(o.startswith("BAR") for _, o in ins[lo:n])
                if walk and n - lo > best:
                    best, span = n - lo, (lo, n + 1)
        loop = [op for _, op in ins[span[0]:span[1]]]
        counts = {k: sum(1 for op in loop if re.match(p, op))
                  for k, p in KINDS.items()}
        counts.update(loop=len(loop), all=len(ins))
        res[name] = (counts, loop)
    return res


def _occupancy(cubin: Path, mangled: str, smem: int) -> int:
    cuda = ctypes.CDLL("libcuda.so.1")
    mod, fn, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    for call in (lambda: cuda.cuModuleLoad(ctypes.byref(mod),
                                           str(cubin).encode()),
                 lambda: cuda.cuModuleGetFunction(ctypes.byref(fn), mod,
                                                  mangled.encode()),
                 # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
                 lambda: cuda.cuFuncSetAttribute(fn, 8, ctypes.c_int(smem)),
                 lambda: cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                     ctypes.byref(n), fn, ctypes.c_int(256),
                     ctypes.c_size_t(smem))):
        err = call()
        if err:
            raise RuntimeError(f"libcuda error {err} ({mangled})")
    cuda.cuModuleUnload(mod)
    return n.value


class _Lib:
    """The kernel library with the O4 xz entries of another build."""

    def __init__(self, base, path):
        self._base = base
        self._own = ctypes.CDLL(str(path))
        for sfx in ("f32", "f64"):
            fn = getattr(self._own, f"cfdnn_predictor_general_xz_o4_{sfx}")
            fn.argtypes = K._SIGNATURES["predictor_general_xz_o4"]
            fn.restype = ctypes.c_int
        self._own.cfdnn_error_string.argtypes = [ctypes.c_int]
        self._own.cfdnn_error_string.restype = ctypes.c_char_p
        self.plan = getattr(self._own, "cfdnn_xz_o4_shared_bytes", None)
        if self.plan is not None:
            self.plan.argtypes = [ctypes.c_int] * 3
            self.plan.restype = ctypes.c_longlong

    def __getattr__(self, name):
        if (name.startswith("cfdnn_predictor_general_xz_o4_")
                or self._base is None):
            return getattr(self._own, name)
        return getattr(self._base, name)


def _describe(tag, build, lib, rows, listing):
    """Print and record each kernel of a copy's build; with `listing` (a
    directory) write each kernel's walk loop there."""
    regs = _ptxas(build["ptxas"])
    for cubin in build["cubins"]:
        for mangled, (counts, loop) in _sass(cubin).items():
            name = _demangle([mangled])[0]
            m = re.search(r"<(float|double), (true|false), \(int\)(\d)"
                          r"(?:, (true|false))?>", name)
            if not m or "xz_o4_kernel" not in name and "wide" not in name:
                continue
            size = 4 if m.group(1) == "float" else 8
            nut = m.group(2) == "true"
            y4 = m.group(4) == "true"
            if lib.plan is not None and "xz_o4_kernel" in name:
                smem = lib.plan(size, int(nut), int(y4))
            else:
                smem = WIDE_SLOTS * (4 if nut else 3) * 432 * size
            r, st, ld = regs.get(mangled, (-1, -1, -1))
            row = dict(copy=tag, kernel=name, registers=r, spill_stores=st,
                       spill_loads=ld, smem=smem,
                       blocks_per_sm=_occupancy(cubin, mangled, smem),
                       **counts)
            rows.append(row)
            if listing:
                d = listing / tag
                d.mkdir(parents=True, exist_ok=True)
                (d / (re.sub(r"\W+", "_", name) + ".sass")).write_text(
                    "\n".join(loop) + "\n")
            print(f"[ab] {tag} {name}: {r} registers, spills {st}/{ld} B, "
                  f"{smem} B shared, {row['blocks_per_sm']} blocks an SM; "
                  f"walk loop {counts['loop']} instructions (kernel "
                  f"{counts['all']}): " + ", ".join(
                      f"{k} {counts[k]}" for k in KINDS if counts[k]),
                  flush=True)


def _steps(libs, order, results):
    """ms a step of the two 512^3 O4 cells with each copy's kernel."""
    from cfdnn_tpu_torch import bench
    cells = {"tgv_re1600_o4_512": bench.tgv_re1600_case,
             "channel512_o4": bench.channel_case}
    for cell, case in cells.items():
        for tag in order:
            K._lib = libs[tag]
            sim, st = case(512, space_order=4)
            ms = bench.time_steps(sim, st, steps=100, reps=1)[0] * 1e3
            results.setdefault(cell, {}).setdefault(tag, []).append(ms)
            print(f"[ab] {cell} {tag}: {ms:.4f} ms/step", flush=True)
            del sim, st
            torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--listing", action="store_true",
                    help="write each kernel's walk loop under OUT/sass")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("variants", nargs="*", choices=sorted(SUBS))
    args = ap.parse_args(argv)
    import chip_smoke as CS
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)
    # the whole library only for the steps (the calls need the O4 xz
    # entries alone, and error.cu beside them)
    base = K.library() if args.steps else None
    copies = {"kernel": K._CSRC}
    if args.parent:
        copies = {"parent": args.parent.resolve(), **copies}
    for v in args.variants:
        copies[v] = _variant(v)
    with concurrent.futures.ThreadPoolExecutor(len(copies)) as pool:
        builds = dict(zip(copies, pool.map(lambda kv: _build(*kv),
                                           copies.items())))
    libs = {tag: _Lib(base, b["lib"]) for tag, b in builds.items()}
    rows = []
    for tag in copies:
        _describe(tag, builds[tag], libs[tag], rows,
                  args.out / "sass" if args.listing else None)
    # the turns: parent, kernel, variants, kernel, parent
    first = [t for t in ("parent", "kernel") if t in copies]
    order = first + list(args.variants) + first[::-1]
    times = {}
    for case in CS._xz_o4_cases(torch.float32, dev, seed=2, nx=512,
                                small=False):
        if case.name != "predictor_general_xz":
            continue
        ref = case.twin()
        bound, _ = CS._bound(case, ref)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*case.inputs, *ref))
        outs = {}
        for tag in copies:
            K._lib = libs[tag]
            outs[tag] = case.kern()
            torch.cuda.synchronize()
            for out, err, lim, _ in CS.compare(case.name, outs[tag], ref,
                                               torch.float32):
                CS.check(err <= lim, f"{tag} {case.label} {out}: {err}")
            d = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(outs[tag], outs["kernel"])) \
                if tag != "kernel" and "kernel" in outs else 0.0
            print(f"[ab] {case.label} {tag}: within 1e-5 of the twin; "
                  f"max|d| / scale against kernel {d:.3e}", flush=True)
        del outs
        row = times.setdefault(case.label, dict(bound_ms=bound,
                                                bytes=nbytes))
        for tag in order:
            K._lib = libs[tag]
            dms = CS._device_ms(case.kern, 5)
            ems = CS._event_ms(case.kern, 20)
            row.setdefault(tag, []).append((dms, ems))
            print(f"[ab] {case.label} {tag}: device {dms:.4f} ms, events "
                  f"{ems:.4f} ms, bound {bound:.4f} ms, "
                  f"{nbytes / dms / 1e6:.0f} GB/s ({dms / bound:.2f}x the "
                  f"bound)", flush=True)
        del case, ref
        torch.cuda.empty_cache()
    steps = {}
    if args.steps:
        _steps(libs, [t for t in order if t in ("parent", "kernel")],
               steps)
    K._lib = None
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "xz_o4_ab.json").write_text(json.dumps(
        dict(card=smi, builds=rows, calls=times, steps=steps), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
