"""Compare the machine code (SASS) of kernels with the kernels of an earlier
copy of their sources, instruction for instruction.

Changes to the sources must leave the kernels of before as they were,
except the ones a change redesigns on purpose:
- every source file of the old copy (`csrc/*.cu`) is compiled in both
  copies, so every kernel of the old copy is held to the new copy's
  kernel of the same name: the slab, xz, walked-tile and Hartley kernels
  alike, including those that share a header with a redesigned kernel
  (`xz_tile.cuh`, `predictor_terms.cuh`, `les.cuh`, `projection.cuh`);
- `csrc/predictor_periodic.cu` and `csrc/predictor_channel.cu` carry a
  `bool DIV` template parameter, last among each kernel's template
  arguments, whose false instantiations were the kernels of before it: an
  old copy's `K<T>` (`K<T, NUT>`) that the new copy lacks is held to the
  new copy's `K<T, false>` (`K<T, NUT, false>`); both files now compile
  only DIV = true, whose code must stay;
- REDESIGNED names the kernels this change rewrites on purpose: the slab
  `predictor_general_kernel` (now on xz_tile.cuh's window with a walled
  z, `csrc/predictor_general_tile.cuh`, under the same name) and
  germano_pass1's `germano_cells_kernel` and `germano_rows_kernel` (now
  on nu_sgs's walked window with the test filter summed separably,
  `csrc/germano_tile.cuh`), every instantiation of each. An old copy's
  kernel of those names is reported as REDESIGNED and not compared. A
  later change that redesigns other kernels names them here in place of
  these.
This compiles each file of both copies to a cubin with the library's
flags, disassembles it with cuobjdump, and holds every kernel of the old
copy to the new copy's kernel of the same name, else to its DIV = false
instantiation.

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
# the general predictor (each dtype, nu_t and scheme) and germano_pass1's
# two kernels (each dtype)
REDESIGNED = re.compile(r"predictor_general_kernel<[^<>]*>"
                        r"|germano_(?:cells|rows)_kernel<\w+>")
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
    # every source of the old copy; one the new copy lacks is MISSING
    stems = sorted(f.stem for f in old_dir.glob("*.cu"))
    gone = [s for s in stems if not (_CSRC / f"{s}.cu").exists()]
    ok = not gone
    for stem in gone:
        print(f"MISSING {stem}.cu in {_CSRC}")
    stems = [s for s in stems if s not in gone]
    # every cubin at once (nvcc is one process a source)
    with concurrent.futures.ThreadPoolExecutor(len(stems) * 2) as pool:
        listings = {(stem, tag): pool.submit(sass, d / f"{stem}.cu",
                                             f"{stem}_{tag}")
                    for stem in stems
                    for tag, d in (("old", old_dir), ("new", _CSRC))}
    for stem in stems:
        old = listings[stem, "old"].result()
        new = listings[stem, "new"].result()
        for name, ins in sorted(old.items()):
            if REDESIGNED.fullmatch(name):
                print(f"REDESIGNED {len(ins)} instructions: {name}")
                continue
            # the same name, else the DIV = false instantiation
            new_name = (name if name in new
                        else name[:-1] + ", (bool)0>")
            new_ins = new.get(new_name)
            if new_ins is None:
                print(f"MISSING {new_name} among {sorted(new)}")
                ok = False
                continue
            same = ins == new_ins
            ok &= same
            print(f"{'SAME' if same else 'DIFF'} {len(ins)} vs {len(new_ins)} "
                  f"instructions: {name} / {new_name}")
            if not same:
                print("\n".join(list(difflib.unified_diff(
                    ins, new_ins, lineterm="", n=0))[:40]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
