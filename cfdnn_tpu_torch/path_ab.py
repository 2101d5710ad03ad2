"""Time main paths of two copies of the repository side by side on one
card: each turn runs one copy's chip_smoke paths in a fresh process from
that copy's root (its `build_case`, `bench.time_steps` and
`bench.profile_steps`), and the copies take turns A B B A, `--pairs`
times over, so that drift in the host or the card falls on both.

Each turn prints, for each path, the marginal ms/step over `--steps`
steps (best of three), the device ms/step of a profiled window and the
idle share 1 - device / step; the summary lists each copy's turns.

Run on a machine with a CUDA card, from the repository's root, with two
unpacked copies (`git archive` of each commit):

    python -m cfdnn_tpu_torch.path_ab A_DIR B_DIR [--pairs N] [--steps S]
        path ...

(paths by chip_smoke's names: les_channel_dynamic, les_tgv, les_duct, ...)
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# a turn: the copy's own chip_smoke, each path built and timed as
# chip_smoke's phase_timing does, over the given window
CHILD = r"""
import json, sys
import torch
import chip_smoke as C
from cfdnn_tpu_torch import bench
names, steps = sys.argv[1].split(","), int(sys.argv[2])
paths = {p.name: p for p in C._paths()}
dev = torch.device("cuda", 0)
for name in names:
    path = paths[name]
    sim, st = C.build_case(path, path.n, device=dev)
    s, _ = bench.time_steps(sim, st, steps=steps, reps=3)
    busy = bench.profile_steps(sim, st)["device_ms_per_step"]
    print(json.dumps({"path": name, "ms": s * 1e3, "device_ms": busy}),
          flush=True)
"""


def turn(root: Path, names, steps):
    """[{path, ms, device_ms}, ...] of one turn in `root`."""
    out = subprocess.run([sys.executable, "-c", CHILD, ",".join(names),
                          str(steps)], cwd=root, capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(f"{root}: rc {out.returncode}\n{out.stderr}")
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args(argv)
    copies = {"A": args.a.resolve(), "B": args.b.resolve()}
    rows = {}
    for n in range(args.pairs):
        for tag in "ABBA":
            for r in turn(copies[tag], args.paths, args.steps):
                idle = 1 - r["device_ms"] / r["ms"]
                print(f"[path_ab] pair {n + 1} {tag} {r['path']}: "
                      f"{r['ms']:.4f} ms/step, device {r['device_ms']:.4f} "
                      f"ms/step, idle share {idle:.3f}", flush=True)
                rows.setdefault((r["path"], tag), []).append(r)
    for (path, tag), rs in sorted(rows.items()):
        print(f"[path_ab] {path} {tag} ({copies[tag]}): ms/step "
              + ", ".join(f"{r['ms']:.4f}" for r in rs) + "; device "
              + ", ".join(f"{r['device_ms']:.4f}" for r in rs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
