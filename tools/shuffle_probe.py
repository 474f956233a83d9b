"""Times the port's all-to-all shuffle on one CUDA card.

Both applications at 2**26 tokens (``make_app``, seed 0) at the smoke's
(M, R, W) settings, reduce backend ``cuda``: the fused job's wall and the
traced mode's shuffle wall with the ``lexsort`` shuffle and with the
emulated ``all_to_all`` shuffle, the latter twice over in the order
full, cut, cut, full: "cut" is the port's exchange, whose send blocks are
cut to their longest live prefix (``AllToAllShuffle.live_width``); "full"
sends and sorts every slot of the (W, W, shuf_cap) blocks.  Both give the
same outputs, which the probe checks.  Walls are medians of three warm
calls, fenced by ``torch.cuda.synchronize``.

    python3 tools/shuffle_probe.py [--src OTHER/src]

It prints one line per reading and, last, one JSON object of them.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TOKENS = 1 << 26
CONFIGS = ((20, 5, 1), (7, 3, 2), (37, 40, 4))


def walls(job, corpus, n=3):
    job(corpus)
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        job(corpus)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("shuffle_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.mapreduce import ExecutionPlan, JobConfig
    from repro_torch.mapreduce.backends import AllToAllShuffle
    from repro_torch.runner import make_app
    from repro_torch.telemetry import PhaseRecorder

    cut = AllToAllShuffle.live_width

    def full(cfg, send_r, group=None):
        return send_r.shape[-1]

    readings = []
    for name in ("wordcount", "eximparse"):
        app, corpus = make_app(name, TOKENS)
        corpus = torch.as_tensor(corpus, device="cuda")
        for M, R, W in CONFIGS:
            row = {"app": name, "config": [M, R, W]}
            outs = {}
            for tag, width in (("lexsort", cut), ("full", full), ("cut", cut),
                               ("cut2", cut), ("full2", full)):
                AllToAllShuffle.live_width = staticmethod(width)
                sb = "lexsort" if tag == "lexsort" else "all_to_all"
                plan = ExecutionPlan(app, JobConfig(M, R, W, reduce_backend="cuda",
                                                    shuffle_backend=sb), len(corpus))
                row[f"{tag}_job_ms"] = walls(plan.fused(), corpus) * 1e3
                recorder = PhaseRecorder()
                job = plan.traced(recorder)
                job(corpus)
                outs[tag] = job(corpus)
                row[f"{tag}_shuffle_ms"] = recorder.last.phase("shuffle").wall_s * 1e3
            AllToAllShuffle.live_width = cut
            if not all(torch.equal(a, b) for tag in ("full", "cut2", "full2")
                       for a, b in zip(outs[tag], outs["cut"])):
                raise AssertionError(f"{name} {(M, R, W)}: full and cut widths differ")
            del outs
            readings.append(row)
            print(f"{name} M={M} R={R} W={W}: job ms lexsort {row['lexsort_job_ms']:.2f}, "
                  f"all_to_all full {row['full_job_ms']:.2f} / {row['full2_job_ms']:.2f}, "
                  f"cut {row['cut_job_ms']:.2f} / {row['cut2_job_ms']:.2f}; traced shuffle ms "
                  f"lexsort {row['lexsort_shuffle_ms']:.2f}, full {row['full_shuffle_ms']:.2f} / "
                  f"{row['full2_shuffle_ms']:.2f}, cut {row['cut_shuffle_ms']:.2f} / "
                  f"{row['cut2_shuffle_ms']:.2f}; outputs equal", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
