"""The control: the reference put in the program's place, its values summed
in int16, one precision below the int32 sums the configurations state.

    python3 portbench/control.py --workload <cell>[,<cell>...] --seeds <n>[,<n>...]

For each cell and seed it makes the cell's corpus on the card, works out
every job of the cell's mix with the reference, and prints one JSON line:
the slots in which the control's output differs from the exact one, which
is the reading the check compares (``mismatched_slots``).  The benchmark's runs do not run it.  It needs no
program: the reference alone, at the cell's own size.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, tokens=None) -> dict:
    """The control's mismatched slots for every job of the cell's mix.  A
    sum in 16-bit integers is the exact sum wrapped at 2**16, so the
    control's values come from the exact reference's own pass."""
    import torch

    from portbench import gen
    from portbench.reference import Output, expected, mismatches, wrap

    tokens = int(cell.config["tokens"] if tokens is None else tokens)
    corpus = gen.corpus(cell.config, seed, device, tokens)
    per_job = []
    for job in dict.fromkeys(cell.jobs()):
        want = expected(corpus, cell.shape(job, tokens))
        control = dict(vars(want), vals=wrap(torch.from_numpy(want.vals), 16).numpy())
        per_job.append(mismatches(want, Output(**control, dead_nonzero=0)))
    return {"cell": cell.name, "seed": seed, "tokens": tokens,
            "control_mismatched_slots": sum(per_job), "per_job": per_job}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)

    import torch

    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for name in args.workload.split(","):
        cell = load_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            line = readings(cell, seed, "cuda")
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
