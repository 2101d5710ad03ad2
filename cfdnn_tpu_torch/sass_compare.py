"""Compare the machine code (SASS) of kernels with the kernels of an earlier
copy of their sources, instruction for instruction.

Changes to the sources must leave the kernels of before as they were,
except the ones a change redesigns on purpose:
- every source file of the old copy (`csrc/*.cu`) is compiled in both
  copies, so every kernel of the old copy is held to the new copy's
  kernel of the same name: the slab, xz, walked-tile and Hartley kernels
  alike, including those that share a header with a redesigned kernel
  (`xz_tile.cuh`, `predictor_terms.cuh`, `les.cuh`, `projection.cuh`);
- REDESIGNED names the kernels a change rewrites on purpose (now every
  instantiation of predictor_general_xz_o4_kernel: its skew and central
  instantiations on xz_o4_tile.cuh's terms with the axis pattern a
  template argument, its upwind ones under the name
  predictor_general_xz_wide_kernel, which an old copy lacks). An old
  copy's kernel of those names is reported as REDESIGNED and not
  compared; an old source the new copy lacks is compiled in the old copy
  alone, each of its kernels REDESIGNED or MISSING. A change that
  redesigns kernels names them there;
- SCHEMED names the general predictor's four kernels, whose bool SKEW
  became the int SCHEME of the upwind schemes
  (`predictor_general_kernel`, `predictor_general_o4_kernel`,
  `predictor_general_xz_kernel`, `predictor_general_xz_o4_kernel`): an
  old kernel X<T, NUT, true|false, ...> of those names is held to the
  new copy's X<T, NUT, (int)1|(int)0, ...> (skew 1, central 0, as
  cu++filt prints an int template argument), which must be the old
  kernel instruction for instruction; the upwind instantiations (2, 3),
  in sources the old copy lacks, have no old counterpart;
- GAINED_O4 names the kernels that gained the O4 template argument as
  their last (`divergence_kernel`, `correct_kernel` and their xz
  kernels `divergence_xz_kernel`, `correct_xz_kernel`): an old kernel
  X<args> of those names is held to the new copy's O2 instantiation
  X<args, false>, which must be the old kernel instruction for
  instruction (from a copy that has them already, the name is held as
  it is); their O4 instantiations (and every other new kernel, such as
  predictor_general_o4_kernel and predictor_general_xz_o4_kernel, whose
  source the old copy lacks) have no old counterpart and are not
  listed.
This compiles each file of both copies to a cubin with the library's
flags, disassembles it with cuobjdump, and holds every kernel of the old
copy to the new copy's kernel of the same name.

Run on a machine with the CUDA toolkit, from the repository's root:

    mkdir -p build/parent
    git archive <old commit> cfdnn_tpu_torch/csrc | tar -x -C build/parent
    python -m cfdnn_tpu_torch.sass_compare build/parent/cfdnn_tpu_torch/csrc

It prints SAME, DIFF or REDESIGNED and the instruction counts for each
kernel, writes the listings under build/sass, and exits 1 if any kernel
outside REDESIGNED differs or is missing.
"""

import concurrent.futures
import difflib
import re
import subprocess
import sys
from pathlib import Path

from .ops.kernels import NVCC_FLAGS, _CSRC, _nvcc

# the kernels redesigned on purpose (demangled names of the old copy):
# every instantiation of the O4 xz predictor
REDESIGNED = re.compile(r"predictor_general_xz_o4_kernel<.*>")
# the kernels that gained the O4 template argument (demangled names of
# the old copy): each held to its new O2 instantiation
GAINED_O4 = re.compile(
    r"(?:divergence|correct)(?:_xz)?_kernel<(?![^<>]*, (?:false|true)>)"
    r"[^<>]*>")
# the kernels whose bool SKEW (their third template argument) became the
# int SCHEME: each held to its instantiation of the same value
SCHEMED = re.compile(
    r"(predictor_general(?:_o4|_xz|_xz_o4)?_kernel<[^<>,]*, [^<>,]*, )"
    r"(true|false)((?:, [^<>,]*)?>)")
OUT = Path(__file__).resolve().parents[1] / "build" / "sass"


def sass(src: Path, tag: str) -> dict:
    """{demangled kernel name: [instruction, ...]} of `src`'s cubin."""
    tools = Path(_nvcc()).parent
    cubin = OUT / f"{tag}.cubin"
    subprocess.run([str(tools / "nvcc"), *NVCC_FLAGS, "-cubin", "-o",
                    str(cubin), str(src)], check=True)
    # a source without kernels (a host-only file) gives an empty listing
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True).stdout
    (OUT / f"{tag}.sass").write_text(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = subprocess.run([str(tools / "cu++filt"), m.group(1)],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip()
            name = name.split(">(")[0].replace("void <unnamed>::", "") + ">"
            # a bool template argument as cu++filt may print it
            name = name.replace("(bool)0", "false").replace("(bool)1",
                                                            "true")
            cur = funcs.setdefault(name, [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return funcs


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir = Path(argv[0])
    OUT.mkdir(parents=True, exist_ok=True)
    # every source of the old copy, in both copies where the new one has it
    stems = sorted(f.stem for f in old_dir.glob("*.cu"))
    ok = True
    # every cubin at once (nvcc is one process a source)
    with concurrent.futures.ThreadPoolExecutor(len(stems) * 2) as pool:
        listings = {(stem, tag): pool.submit(sass, d / f"{stem}.cu",
                                             f"{stem}_{tag}")
                    for stem in stems
                    for tag, d in (("old", old_dir), ("new", _CSRC))
                    if (d / f"{stem}.cu").exists()}
    for stem in stems:
        old = listings[stem, "old"].result()
        gone = (stem, "new") not in listings
        new = {} if gone else listings[stem, "new"].result()
        for name, ins in sorted(old.items()):
            if REDESIGNED.fullmatch(name):
                print(f"REDESIGNED {len(ins)} instructions: {name}")
                continue
            schemed = SCHEMED.fullmatch(name)
            if schemed:
                new_name = (schemed.group(1)
                            + ("(int)1" if schemed.group(2) == "true"
                               else "(int)0")
                            + schemed.group(3))
            elif GAINED_O4.fullmatch(name):
                new_name = name[:-1] + ", false>"
            else:
                new_name = name
            new_ins = new.get(new_name)
            if new_ins is None:
                where = f"{stem}.cu gone from" if gone else "not in"
                near = [n for n in new if n.split("<")[0] == name.split("<")[0]]
                print(f"MISSING {name}: {where} {_CSRC} (of that name there: "
                      f"{near})")
                ok = False
                continue
            same = ins == new_ins
            ok &= same
            print(f"{'SAME' if same else 'DIFF'} {len(ins)} vs {len(new_ins)} "
                  f"instructions: {name}"
                  + ("" if new_name == name else f" (as {new_name})"))
            if not same:
                print("\n".join(list(difflib.unified_diff(
                    ins, new_ins, lineterm="", n=0))[:40]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
