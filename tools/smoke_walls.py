"""Times each phase of ``chip_smoke.py`` from the stamps of its output lines.

Runs ``python3 chip_smoke.py`` in each checkout given (default: this one),
one after the other, stamps every line of its output (standard error
merged) with the seconds since the start, and writes the stamped output
to ``OUT/smoke_walls_<i>.log`` (default ``build/smoke_walls``).  A phase's wall is the time from the
previous tagged line (``[tag] ...``) to each of its own lines, summed
over its lines, so the work before a line counts to that line's tag.

    python3 tools/smoke_walls.py [CHECKOUT ...] [--out DIR]

It prints one row per tag with each run's wall and, last, one JSON object
of them.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = re.compile(r"^\[([a-z0-9_]+)\]")


def run(checkout: Path, log: Path) -> tuple[dict, int, float]:
    walls: dict = {}
    t0 = last = time.perf_counter()
    with open(log, "w") as out, subprocess.Popen(
            [sys.executable, "chip_smoke.py"], cwd=checkout, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            now = time.perf_counter()
            out.write(f"{now - t0:8.1f} {line}")
            m = TAG.match(line)
            if m:
                walls[m.group(1)] = walls.get(m.group(1), 0.0) + now - last
                last = now
    return walls, proc.returncode, time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    parser.add_argument("--out", default=str(ROOT / "build" / "smoke_walls"))
    args = parser.parse_args()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    runs = []
    for i, checkout in enumerate(args.checkouts):
        walls, rc, total = run(Path(checkout).resolve(), Path(args.out) / f"smoke_walls_{i}.log")
        runs.append({"checkout": checkout, "rc": rc, "total_s": total, "walls_s": walls})
        print(f"{checkout}: exit {rc}, {total:.1f} s", flush=True)
    tags = list(dict.fromkeys(t for r in runs for t in r["walls_s"]))
    for tag in tags:
        print(f"{tag:>12} " + " ".join(f"{r['walls_s'].get(tag, 0.0):8.1f}" for r in runs))
    print(json.dumps({"runs": runs}))
    return max(r["rc"] for r in runs)


if __name__ == "__main__":
    sys.exit(main())
