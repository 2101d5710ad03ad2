"""Time variants of the float32 kernels that walk an (x, z) tile along y
side by side on one card: the xz kernels (`csrc/xz_tile.cuh`,
`csrc/predictor_general_xz.cuh`, `csrc/xz.cu`) on chip_smoke's 640^3
calls of predictor_general_xz (with and without nu_t), nu_sgs_xz,
divergence_xz and correct_xz, and the four slab kernels on a walked tile
(`csrc/predictor_channel_tile.cuh`, `csrc/predictor_periodic_tile.cuh`,
`csrc/correct.cu`, `csrc/divergence.cu`) on its 512^3 calls of
predictor_channel (channel512), predictor_periodic (tgv512), correct and
divergence (tgv512, channel512), and on the main paths' smaller calls of
the four (device ms by the profiler); and the two closure kernels on a
walked tile (`csrc/nu_sgs_tile.cuh`, `csrc/transport_tile.cuh`) on the
main paths' calls of nu_sgs (les_ibm256's 256x128x256, the LES channel
128x64x128 and the duct 128x96x96, each closure) and transport
(rans_channel's 128^3, each model), device ms by the profiler; and the
general predictor and germano_pass1 on their walked tiles
(`csrc/predictor_general_tile.cuh`, `csrc/germano_tile.cuh`) on the main
paths' calls (les_tgv's 128^3 and les_duct's 128x96x96 predictor with
nu_t, les_channel_dynamic's 128x64x128 germano_pass1), device ms by the
profiler, and the predictor at 640^3 beside predictor_general_xz (the
xz kernels' cases hold it as their `slab`); and the two predictor +
divergence kernels on their walked tiles
(`csrc/predictor_periodic_div_tile.cuh`,
`csrc/predictor_channel_div_tile.cuh`) on tgv512's and channel512's
inputs and on the main paths' calls (tgv's 128^3, channel's 128^3 and
les_channel's 128x64x128 with nu_t), device ms by the profiler there.

Each variant is the kernels' sources with a few textual substitutions,
built with the library's flags into its own shared library:
- "kernel": the sources as they are;
- "sync": each plane copied by plain loads and stores where the tile
  issues cp.async (what the asynchronous copy buys; the xz kernels, the
  channel and periodic predictors and nu_sgs);
- "pow": transport's F1 through pow(arg1, 4) where it forms arg1^4 as
  (arg1 * arg1) * (arg1 * arg1) (what the squared square buys);
- "l1": transport's k and omega (the blend's neighbours and the cell's)
  by plain loads from device memory, through L1, where float32 stages
  them on a window with a two-point x/z halo (what the window buys);
- "one_block": `__launch_bounds__` without its minimum of blocks an SM
  (what the register cap buys; the xz, channel and general predictors
  and germano_pass1: the periodic predictor has no cap);
- "germano_three_blocks": germano_pass1's register cap at three blocks
  an SM (four in float32 as it stands);
- "edge_warp": the stars of the next tiles' first x row and z column
  formed by the last x row's warp (the row) and lane 31 of every warp
  (its row's column entry), where a div kernel's block forms them by
  warp 0 (the row) and lanes 0-7 of warp 1 (the column) as it stands
  (div_tile.cuh's edge_stars);
- "div_three_blocks", "div_five_blocks": the channel div kernel's
  register cap at three or five blocks an SM (four in float32 as it
  stands); "periodic_div_six_blocks": the periodic div kernel capped at
  six blocks an SM (no cap as it stands); "div_chunk8": both div
  kernels' chunk at least 8 planes, tile_plan.cuh's own floor (16 as
  it stands);
- "ahead1", "ahead3": the channel and periodic predictors' walks with
  one or three planes in flight (two in float32 as they stand);
  "three_blocks", "five_blocks": the channel predictor's register cap at
  three or five blocks an SM (four as it stands; the launcher's chunk
  follows the occupancy it gets);
- "parent": the sources of another copy, with `--parent DIR` (an older
  commit's `cfdnn_tpu_torch/csrc`, which keeps the C interfaces; a copy
  from before a walked tile, without `predictor_channel_tile.cu` or
  `predictor_periodic_tile.cu`, has that predictor's slab kernel, and
  its correct and divergence may be slab kernels too; a copy from before
  germano_pass1 took a walled z has its entry without `wall_z`, which the
  binding drops for it; a copy from before the div kernels' walked tiles
  has their slab kernels, in `predictor_periodic.cu` and
  `predictor_channel.cu`).
Every variant computes the function: each call of an xz kernel is held to
the slab kernel of its function on the same inputs, each call of a slab
kernel on a walked tile to the kernel of this copy (the library's), 1e-5
of scale, and the difference is printed (the parent's slab predictors
differ by FMA contraction only, its correct and divergence by nothing);
each is timed by CUDA events over 20 calls, in two turns, the second in
the reverse order. ptxas's registers and spills and the SASS instruction
mix of each variant's tile kernels (cuobjdump) are printed first.

Run on a machine with the CUDA toolkit, from the repository's root:

    python -m cfdnn_tpu_torch.xz_variants [--parent DIR] [--cases S,...]
        [variant ...]

`--cases` times only the cases whose label holds one of the comma-
separated strings (`--cases _div`: the two div kernels).
"""

import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .ops import kernels as K

SUBS = {
    "kernel": [],
    "sync": [(r"(void copy_async\(T\* dst, const T\* src\) \{).*?\n\}",
              r"\1 *dst = *src; }"),
             (r'asm volatile\("cp\.async\.[a-z_]+[^"]*"[^;]*;', "")],
    "one_block": [(r"sizeof\(T\) == 4 \? \d : 2", "1")],
    # the channel and periodic predictors' planes in flight, the channel
    # predictor's blocks an SM (float32)
    "ahead1": [(r"(k(?:Channel|Periodic)Ahead) = sizeof\(T\) == 4 \? \d",
                r"\1 = sizeof(T) == 4 ? 1")],
    "ahead3": [(r"(k(?:Channel|Periodic)Ahead) = sizeof\(T\) == 4 \? \d",
                r"\1 = sizeof(T) == 4 ? 3")],
    "three_blocks": [(r"kChannelMinBlocks = sizeof\(T\) == 4 \? \d",
                      "kChannelMinBlocks = sizeof(T) == 4 ? 3")],
    "five_blocks": [(r"kChannelMinBlocks = sizeof\(T\) == 4 \? \d",
                     "kChannelMinBlocks = sizeof(T) == 4 ? 5")],
    "pow": [(r"safe_tanh\(pow4\(arg1\)\)", "safe_tanh(pow(arg1, T(4)))")],
    "l1": [(r"constexpr bool kStageKOm = true;",
            "constexpr bool kStageKOm = false;")],
    "germano_three_blocks": [(r"kGermanoMinBlocks = sizeof\(T\) == 4 \? \d",
                              "kGermanoMinBlocks = sizeof(T) == 4 ? 3")],
    # the div kernels' far stars (div_tile.cuh), the channel one's cap
    "edge_warp": [(r"(EdgeStars edge_stars\(int tx, int tz\) \{\n"
                   r"    EdgeStars s\{\};\n).*?(\n    return s;)",
                   r"\1    s.u = tx == kTx - 1;\n    s.uz = tz;\n"
                   r"    s.du = Pz;\n    s.w = tz == kTz - 1;\n"
                   r"    s.wx = tx;\n    s.dw = 1;\2")],
    "div_three_blocks": [(r"kChannelDivMinBlocks = sizeof\(T\) == 4 \? \d",
                          "kChannelDivMinBlocks = sizeof(T) == 4 ? 3")],
    "div_five_blocks": [(r"kChannelDivMinBlocks = sizeof\(T\) == 4 \? \d",
                         "kChannelDivMinBlocks = sizeof(T) == 4 ? 5")],
    "periodic_div_six_blocks": [
        (r"__launch_bounds__\(cfdnn::xz::kThreads\)"
         r"(\npredictor_periodic_div_tile_kernel)",
         r"__launch_bounds__(cfdnn::xz::kThreads, 6)\1")],
    "div_chunk8": [(r"kDivChunkMin = \d+;", "kDivChunkMin = 8;")],
}
SOURCES = ("xz.cu", "predictor_general_xz.cu", "correct.cu", "divergence.cu",
           "nu_sgs.cu", "transport.cu", "predictor_general.cu",
           "germano_pass1.cu", "error.cu")
# the float source of the channel and of the periodic predictor and of
# their div kernels: the walked tile, or a copy's slab kernel from before
# it (one source may hold a predictor and its div kernel)
PREDICTOR_SOURCES = (("predictor_channel_tile.cu", "predictor_channel.cu"),
                     ("predictor_periodic_tile.cu", "predictor_periodic.cu"),
                     ("predictor_channel_div_tile.cu",
                      "predictor_channel.cu"),
                     ("predictor_periodic_div_tile.cu",
                      "predictor_periodic.cu"))
NAMES = ("predictor_general_xz", "nu_sgs_xz", "divergence_xz", "correct_xz",
         "predictor_channel", "correct", "predictor_periodic", "divergence",
         "nu_sgs", "transport", "predictor_general", "germano_pass1",
         "predictor_periodic_div", "predictor_channel_div")
# the float32 kernels whose registers and SASS mix are printed (mangled)
TILE_KERNELS = re.compile(r"(xz_kernel|predictor_channel_tile_kernel"
                          r"|predictor_channel_kernel|correct_kernel"
                          r"|predictor_periodic_tile_kernel"
                          r"|predictor_periodic_kernel|divergence_kernel"
                          r"|nu_sgs_tile_kernel|nu_sgs_kernel"
                          r"|transport_tile_kernel|transport_kernel"
                          r"|predictor_general_kernel"
                          r"|germano_cells_kernel"
                          r"|predictor_(?:periodic|channel)_div_tile_kernel)"
                          r"If")
OUT = Path(__file__).resolve().parents[1] / "build" / "xz_variants"


def build(name: str, src_dir: Path):
    """Start nvcc on the variant's sources; returns (library path,
    process)."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    hits = dict.fromkeys(p for p, _ in SUBS.get(name, []))
    for f in src_dir.iterdir():
        if f.suffix not in (".cu", ".cuh"):
            continue
        text = f.read_text()
        for pattern, repl in SUBS.get(name, []):
            text, n = re.subn(pattern, repl, text, flags=re.S)
            hits[pattern] = (hits[pattern] or 0) + n
        (d / f.name).write_text(text)
    missing = [p for p, n in hits.items() if not n]
    if missing:
        raise RuntimeError(f"{name}: {missing} not in the sources")
    lib = d / "lib.so"
    predictors = tuple(dict.fromkeys(
        next(f for f in pair if (d / f).exists())
        for pair in PREDICTOR_SOURCES))
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o", str(lib),
           *(str(d / f) for f in SOURCES + predictors)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)


def registers(log: str):
    """ptxas's lines for the float32 tile kernels: (entry, registers
    line)."""
    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = "; " + line.strip()
        elif entry and "registers" in line and TILE_KERNELS.search(entry):
            rows.append((entry, line.strip() + spill))
            entry = None
    return rows


def mix(path: Path):
    """{kernel: Counter of SASS opcode classes} of the tile kernels in a
    library (cuobjdump -sass)."""
    tools = Path(K._nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if TILE_KERNELS.search(m.group(1)) else None
            if cur:
                out[cur] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and cur:
            out[cur][m.group(1)] += 1
    return out


# SASS opcode classes: shared-memory loads, device-memory loads (LDGSTS:
# cp.async), floating point, and integer arithmetic with moves
CLASSES = (("LDS", ("LDS",)), ("LDG", ("LDG", "LDGSTS")),
           ("float", ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "MUFU",
                      "FSEL", "FSETP", "DSETP")),
           ("integer/move", ("IMAD", "IADD3", "LEA", "SHF", "LOP3", "ISETP",
                             "SEL", "IABS", "PRMT", "IMNMX", "MOV", "S2R",
                             "ULDC")))


class _NoWallZ:
    """A library whose germano_pass1 entry predates its `wall_z`
    argument: the calls drop it (the 19th argument; the copy's gate took
    a periodic z only)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "cfdnn_germano_pass1_f32":
            return lambda *a: fn(*a[:18], *a[19:])
        return fn


def bind(path: Path):
    lib = ctypes.CDLL(str(path))
    old_germano = "int wall_z" not in (path.parent
                                       / "germano_pass1.cu").read_text()
    for name in NAMES:
        fn = getattr(lib, f"cfdnn_{name}_f32")
        fn.argtypes = K._SIGNATURES[name]
        if name == "germano_pass1" and old_germano:
            fn.argtypes = fn.argtypes[:18] + fn.argtypes[19:]
        fn.restype = ctypes.c_int
    lib.cfdnn_error_string.argtypes = [ctypes.c_int]
    lib.cfdnn_error_string.restype = ctypes.c_char_p
    lib.cfdnn_germano_pass1_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cfdnn_germano_pass1_blocks.restype = ctypes.c_int
    return _NoWallZ(lib) if old_germano else lib


def main(argv) -> int:
    import chip_smoke as C
    parent, only = None, None
    while argv[:1] in (["--parent"], ["--cases"]):
        if argv[0] == "--parent":
            parent = Path(argv[1])
        else:
            only = argv[1].split(",")
        argv = argv[2:]

    def wanted(label):
        return only is None or any(s in label for s in only)

    names = argv or list(SUBS) + (["parent"] if parent else [])
    print(C.card_line())
    procs = {name: build(name, parent if name == "parent" else K._CSRC)
             for name in names}
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for entry, line in registers(log):
            print(f"[ptxas] {name} {entry[:70]}: {line}")
        for kern, ops in mix(path).items():
            if not TILE_KERNELS.search(kern):     # the float32 kernels
                continue
            cls = {c: sum(ops[o] for o in group) for c, group in CLASSES}
            print(f"[sass] {name} {kern[:70]}: {sum(ops.values())} "
                  "instructions, " + ", ".join(f"{c} {n}"
                                               for c, n in cls.items()))
        libs[name] = bind(path)
    device = torch.device("cuda", 0)
    main_lib = K.library()
    cases, seen = [], set()
    # (the 640^3 cubes are made only where an xz kernel is wanted)
    xz = ("predictor_general_xz", "nu_sgs_xz", "divergence_xz", "correct_xz")
    for case in (C._xz_cases(torch.float32, device, seed=2, nx=640,
                             small=False)
                 if any(map(wanted, xz)) else ()):
        if case.label not in seen and wanted(case.label):
            seen.add(case.label)
            cases.append(case)
    cases += [case for case in C._tile_cases_512(device, seed=2)
              if wanted(case.label)]
    # and at the main paths' smaller shapes (the channel and the periodic
    # box 128^3, the LES channel 128x64x128, the duct 128x96x96,
    # les_ibm256's 256x128x256; nu_sgs, transport, the general predictor
    # and germano_pass1 only there), timed by the profiler's device ms: a
    # call there takes less than the host's launch
    small = [case for case in C._cases(128, torch.float32, device, seed=2)
             + C._div_cases(128, torch.float32, device, seed=2)
             if case.name in ("predictor_channel", "correct",
                              "predictor_periodic", "divergence", "nu_sgs",
                              "transport", "predictor_general",
                              "germano_pass1", "predictor_periodic_div",
                              "predictor_channel_div")
             and wanted(case.label)
             and case.label not in seen and not seen.add(case.label)]
    cases += small
    with torch.no_grad():
        K._lib = main_lib
        # the xz kernels against their slab kernels, the walked slab
        # kernels against this copy's
        refs = {case.label: (case.slab or case.kern)() for case in cases}
        slab = {case.label: C._event_ms(case.slab, 20) for case in cases
                if case.slab}
        print("[variant] slab kernels: " + ", ".join(
            f"{label} {ms:.4f}" for label, ms in slab.items()), flush=True)
        for turn in (0, 1):
            order = list(libs.items())
            for name, lib in (order if turn == 0 else order[::-1]):
                K._lib = lib
                row = []
                for case in cases:
                    errs = []
                    for got, ref in zip(C._as_tuple(case.kern()),
                                        C._as_tuple(refs[case.label])):
                        err = float((got - ref).abs().max()
                                    / ref.abs().max())
                        C.check(err <= C.F32_TOL,
                                f"{name} {case.label}: {err}")
                        errs.append(err)
                    if turn == 0 and case.slab is None:
                        print(f"[variant] {name} {case.label}: max|d| / "
                              f"max|this copy| = "
                              + ", ".join(f"{e:.3e}" for e in errs))
                    ms = (C._device_ms(case.kern, 20)
                          if any(case is c for c in small)
                          else C._event_ms(case.kern, 20))
                    row.append(f"{case.label} {ms:.4f}")
                print(f"[variant] {name} turn {turn + 1}: " + ", ".join(row),
                      flush=True)
        K._lib = main_lib
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
