"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is the result (one JSON object);
the last lines of standard error are the numbers the check compared,
each beside its limit.  A cell on one card runs in this process
(``harness.run_local``); a cell on more runs one rank process a card
(``ranks.run_ranks``), and a rank that fails ends the run with no result.
See ``portbench/README.md``.
"""

import time

T_START = time.time()  # noqa: E402  (set-up is timed from here)

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        line, log = harness.run_local(cell, args.seed, args.seconds, bool(args.trace),
                                      T_START)
    else:
        from portbench import ranks

        try:
            line, log = ranks.run_ranks(cell, args.seed, args.seconds, bool(args.trace),
                                        T_START)
        except ranks.RankFailure as err:
            print(f"portbench: {cell.name}: {err}", file=sys.stderr)
            return 4
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: modules that may not be loaded are loaded: {foreign}",
              file=sys.stderr)
        return 3
    for text in log:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
