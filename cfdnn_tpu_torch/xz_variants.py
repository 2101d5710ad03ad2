"""Time variants of the float32 (x, z)-tiled kernels (`csrc/xz_tile.cuh`,
`csrc/predictor_general_xz.cuh`, `csrc/xz.cu`) side by side on one card,
on chip_smoke's 640^3 calls of predictor_general_xz (with and without
nu_t), nu_sgs_xz, divergence_xz and correct_xz.

Each variant is the kernels' sources with a few textual substitutions,
built with the library's flags into its own shared library:
- "kernel": the sources as they are;
- "sync": each plane copied by plain loads and stores where the kernels
  issue cp.async (what the asynchronous copy buys);
- "one_block": `__launch_bounds__` without its minimum of blocks an SM
  (what the register cap buys);
- "parent": the sources of another copy, with `--parent DIR` (an older
  commit's `cfdnn_tpu_torch/csrc`, which keeps the C interface).
Every variant computes the function: each call is held to the slab
kernel of its function on the same inputs (1e-5 of scale) and timed by
CUDA events over 20 calls, in two turns, the second in the reverse
order. ptxas's registers and spills and the SASS instruction mix of each
variant's xz kernels (cuobjdump) are printed first.

Run on a machine with the CUDA toolkit, from the repository's root:

    python -m cfdnn_tpu_torch.xz_variants [--parent DIR] [variant ...]
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
             (r'asm volatile\("cp\.async\.[a-z_]+;\\n"[^;]*;', "")],
    "one_block": [(r"sizeof\(T\) == 4 \? 3 : 2", "1")],
}
SOURCES = ("xz.cu", "predictor_general_xz.cu", "error.cu")
NAMES = ("predictor_general_xz", "nu_sgs_xz", "divergence_xz", "correct_xz")
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
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o", str(lib),
           *(str(d / f) for f in SOURCES)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)


def registers(log: str):
    """ptxas's lines for the float32 xz kernels: (entry, registers line)."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "registers" in line and "xz_kernelIf" in entry:
            rows.append((entry, line.strip()))
            entry = None
    return rows


def mix(path: Path):
    """{kernel: Counter of SASS opcode classes} of the xz kernels in a
    library (cuobjdump -sass)."""
    tools = Path(K._nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if "xz" in m.group(1) else None
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


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in NAMES:
        fn = getattr(lib, f"cfdnn_{name}_f32")
        fn.argtypes = K._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.cfdnn_error_string.argtypes = [ctypes.c_int]
    lib.cfdnn_error_string.restype = ctypes.c_char_p
    return lib


def main(argv) -> int:
    import chip_smoke as C
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = Path(argv[1]), argv[2:]
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
            if "xz_kernelIf" not in kern:     # the float32 kernels
                continue
            cls = {c: sum(ops[o] for o in group) for c, group in CLASSES}
            print(f"[sass] {name} {kern[:70]}: {sum(ops.values())} "
                  "instructions, " + ", ".join(f"{c} {n}"
                                               for c, n in cls.items()))
        libs[name] = bind(path)
    device = torch.device("cuda", 0)
    main_lib = K.library()
    cases, seen = [], set()
    for case in C._xz_cases(torch.float32, device, seed=2, nx=640,
                            small=False):
        if case.label not in seen:
            seen.add(case.label)
            cases.append(case)
    with torch.no_grad():
        K._lib = main_lib
        refs = {case.label: case.slab() for case in cases}
        slab = {case.label: C._event_ms(case.slab, 20) for case in cases}
        print("[variant] slab kernels: " + ", ".join(
            f"{label} {ms:.4f}" for label, ms in slab.items()), flush=True)
        for turn in (0, 1):
            order = list(libs.items())
            for name, lib in (order if turn == 0 else order[::-1]):
                K._lib = lib
                row = []
                for case in cases:
                    for got, ref in zip(C._as_tuple(case.kern()),
                                        C._as_tuple(refs[case.label])):
                        err = float((got - ref).abs().max()
                                    / ref.abs().max())
                        C.check(err <= C.F32_TOL,
                                f"{name} {case.label}: {err}")
                    ms = C._event_ms(case.kern, 20)
                    row.append(f"{case.label} {ms:.4f}")
                print(f"[variant] {name} turn {turn + 1}: " + ", ".join(row),
                      flush=True)
        K._lib = main_lib
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
