"""Quickstart: the paper's three-phase loop on the port, on the card.

Profile a WordCount job under 16 (mappers, reducers) settings, fit the
multivariate cubic regression (Eqn. 6), and predict the execution time of
unseen settings.  The engine reduces with the hand-written CUDA kernels
(``reduce_backend="cuda"``).

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ModelDatabase, fit, grid, profile_experiments
from repro_torch.runner import JobRunner
from repro_torch.mapreduce import wordcount, wordcount_corpus


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=1 << 15)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- the application (black box to the modeling pipeline) -------------
    corpus = wordcount_corpus(args.tokens, vocab_size=2048, seed=0)
    run_job = JobRunner(wordcount(2048), corpus, device=dev,
                        reduce_backend="cuda")
    platform = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    # --- phase 1: profiling (paper Fig. 2a; 5 repeats, mean) ---------------
    configs = grid([(5, 40, 12), (5, 40, 12)])  # 16 experiments
    prof = profile_experiments(run_job, configs, repeats=5,
                               param_names=("mappers", "reducers"),
                               verbose=True)

    # --- phase 2: modeling (Eqn. 6: A = (P^T P)^-1 P^T T) ------------------
    model = fit(prof.params, prof.times, device=dev)
    print(f"\nfit: train MAPE {model.train_mape:.2f}%  R^2 {model.r2:.3f}")
    print("coefficients:", dict(zip(model.spec.column_names(),
                                    np.round(model.coef, 6))))

    # --- phase 3: prediction (paper Fig. 2b) -------------------------------
    db = ModelDatabase()
    db.put("wordcount", platform, model)
    for m, r in [(10, 10), (24, 7), (37, 30)]:
        pred = db.predict("wordcount", platform, [m, r], device=dev)
        actual = np.mean([run_job((m, r)) for _ in range(3)])
        print(f"M={m:2d} R={r:2d}: predicted {pred * 1e3:7.2f}ms  "
              f"actual {actual * 1e3:7.2f}ms  "
              f"err {abs(pred - actual) / actual * 100:5.1f}%")


if __name__ == "__main__":
    main()
