"""Beyond-paper closure: the paper's config->time model autotunes the MESH
(counterpart of ``examples/autotune_mesh.py``; host only).

The paper's configuration parameters are (#mappers, #reducers); the exact
analogue for a distributed workload is the mesh factorization
(data_parallel x model_parallel).  This example:

1. enumerates (data, model) factorizations of a 32-rank world (a ``fake``
   process group: no device, nothing sent);
2. "profiles" a llama-style train step under a SAMPLE of them with the
   dry run's analytic roofline (``cells.analyze_cell_extrapolated``: one
   rank's flops, bytes and collective bytes on fake shards, turned into
   time by the H100 cost model, ``core/costmodel.py``);
3. fits the paper's regression on log2(data_axis) as the parameter (at
   degree 2: three samples determine no cubic, and ``core.fit`` refuses
   an underdetermined fit, as the reference's does);
4. predicts the best factorization and validates against the exhaustive
   sweep.

    PYTHONPATH=src python -m repro_torch.autotune_mesh

The terms come from the H100 cost model, so the factorization chosen here
need not be the reference's (whose terms are the TPU's).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

import repro_torch.configs as C
from repro_torch.core import fit, mesh_factorizations
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh

N_RANKS = 32


def analytic_step_time(arch_cfg, shape_name, shape, data_ax, model_ax) -> float:
    mesh = make_mesh((data_ax, model_ax), ("data", "model"))
    r = cells.analyze_cell_extrapolated(
        arch_cfg.name, shape_name, mesh, cfg=arch_cfg, shape=shape
    )
    return r["roofline"]["step_time_no_overlap"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    import torch.distributed as dist

    from repro_torch.launch.dryrun import init_fake_world

    if dist.is_initialized():
        raise RuntimeError("autotune_mesh starts its own fake world; a process "
                           "group is already initialised in this process")
    init_fake_world(N_RANKS)
    try:
        return _tune()
    finally:
        dist.destroy_process_group()


def _tune() -> dict:
    # scaled-down llama so a cell's dry run stays quick on the host
    cfg = dataclasses.replace(
        C.smoke_config("llama3-8b"),
        name="llama3-8b", d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, n_layers=4, vocab_size=8192, param_dtype="bfloat16",
    )
    shape_name = "train_4k"
    shape = dataclasses.replace(C.SHAPES[shape_name], seq_len=512, global_batch=32)
    space = mesh_factorizations(N_RANKS, min_axis=1)  # (1,32) ... (32,1)
    print(f"config space: {[tuple(map(int, r)) for r in space]}")
    measured: dict = {}

    def step_time(d, m):
        if (d, m) not in measured:
            measured[(d, m)] = analytic_step_time(cfg, shape_name, shape, d, m)
        return measured[(d, m)]

    # profile a sample (every other factorization)
    sample = space[::2]
    times = []
    for d, m in sample:
        t = step_time(int(d), int(m))
        times.append(t)
        print(f"profiled data={int(d):2d} model={int(m):2d}: "
              f"{t * 1e3:8.2f}ms (analytic)")
    # model on log2(data) — the natural smooth parameterization
    x = np.log2(sample[:, :1])
    model = fit(x, np.asarray(times), degree=2, scale=True, lam=1e-9, device="cpu")
    pred = np.asarray(model.predict(np.log2(space[:, :1]), device="cpu"))
    best = int(np.argmin(pred))
    print(f"\npredicted best: data={int(space[best][0])} "
          f"model={int(space[best][1])} "
          f"({float(pred[best]) * 1e3:.2f}ms predicted)")

    # validate against exhaustive
    full = [step_time(int(d), int(m)) for d, m in space]
    true_best = int(np.argmin(full))
    regret = (full[best] - full[true_best]) / full[true_best] * 100
    print(f"exhaustive best: data={int(space[true_best][0])} "
          f"model={int(space[true_best][1])} "
          f"({full[true_best] * 1e3:.2f}ms)")
    print(f"tuner regret: {regret:.2f}% using {len(sample)}/{len(space)} "
          f"profiles")
    return {"space": space, "sample": sample, "profiled": times, "predicted": pred,
            "chosen": best, "exhaustive": full, "regret_pct": regret}


if __name__ == "__main__":
    main()
