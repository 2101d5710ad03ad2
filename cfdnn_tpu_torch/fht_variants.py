"""Time variants of the float32 Hartley kernels (`csrc/fht.cuh`) side by
side on one card, on chip_smoke's 512^3 main-path calls of fht_pass and
fht_modal.

Each variant is the kernel's source with a few textual substitutions,
built with the library's flags into its own shared library:
- "kernel": the source as it is;
- "ieee_div": the modal pass's scale by an IEEE division (the float64
  form) instead of `__fdividef`;
- "no_stage1": without the FFT stages before the last (wrong results:
  what the rest of the kernel costs);
- "no_dft": that, and without the butterflies' DFTs (the loads, the
  cas stage, the shared-memory passes and the stores alone).
The variants that compute the function are held to the twins (1e-5 of
scale); each call is timed by CUDA events over 20 calls, in two turns,
the second in the reverse order.

Run on a machine with the CUDA toolkit, from the repository's root:

    python -m cfdnn_tpu_torch.fht_variants [variant ...]
"""

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
    "ieee_div": [(r"if constexpr \(sizeof\(T\) == 4\) "
                  r"q = __fdividef\(t\.norm, d\);\s*else ", "")],
    "no_stage1": [(r"run_stage<kFwd, N2C>\(t, radix\(i\), M\);", ";"),
                  (r"run_stage<kAdj, N2C>\(t, radix\(i\), M\);", ";")],
}
SUBS["no_dft"] = SUBS["no_stage1"] + [(r"dft<R, T>\(x, c, s\);", ";")]
CHECKED = ("kernel", "ieee_div")
OUT = Path(__file__).resolve().parents[1] / "build" / "fht_variants"


def build(name: str):
    """Start nvcc on the variant's sources; returns (library path, process)."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("fht.cuh", "fht.cu", "fht_modal.cu", "error.cu"):
        text = (K._CSRC / f).read_text()
        if f == "fht.cuh":
            for pattern, repl in SUBS[name]:
                text, n = re.subn(pattern, repl, text)
                if not n:
                    raise RuntimeError(f"{name}: {pattern!r} not in fht.cuh")
        (d / f).write_text(text)
    lib = d / "lib.so"
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(d / f) for f in ("fht.cu", "fht_modal.cu", "error.cu"))]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ("fht_pass", "fht_modal"):
        fn = getattr(lib, f"cfdnn_{name}_f32")
        fn.argtypes = K._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.cfdnn_error_string.argtypes = [ctypes.c_int]
    lib.cfdnn_error_string.restype = ctypes.c_char_p
    lib.cfdnn_fht_tile.argtypes = [ctypes.c_int] * 3
    lib.cfdnn_fht_tile.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import chip_smoke as C
    names = argv or list(SUBS)
    print(C.card_line())
    procs = {name: build(name) for name in names}
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = bind(path)
    device = torch.device("cuda", 0)
    cases, seen = [], set()
    for case in C._fht_cases(torch.float32, device, seed=2):
        if case.label not in seen:      # each label's main-path call
            seen.add(case.label)
            cases.append(case)
    with torch.no_grad():
        refs = {case.label: case.twin() for case in cases}
        for turn in (0, 1):
            order = list(libs.items())
            for name, lib in (order if turn == 0 else order[::-1]):
                K._lib = lib
                row = []
                for case in cases:
                    if name in CHECKED:
                        got, ref = case.kern(), refs[case.label]
                        err = float((got - ref).abs().max() / ref.abs().max())
                        C.check(err <= C.F32_TOL,
                                f"{name} {case.label}: {err}")
                    ms = C._event_ms(case.kern, 20)
                    row.append(f"{case.label} {ms:.4f}")
                print(f"[variant] {name} turn {turn + 1}: " + ", ".join(row),
                      flush=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
