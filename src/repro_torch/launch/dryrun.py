"""Multi-pod dry-run entrypoint; counterpart of ``repro.launch.dryrun``.

Run as its own process (``python -m repro_torch.launch.dryrun``): ``main``
initialises a fake world (PyTorch's ``fake`` process-group backend, no
device, nothing sent) of 512 ranks, or of 256 with ``--mesh single``, and
builds the 16x16 single-pod mesh (its first 256 ranks) and the 2x16x16
multi-pod mesh from it.  Importing this module touches no process group.

For every (architecture x applicable input shape x mesh) the cell's step
runs once on DTensors over fake local shards (``launch.cells``), counting
one rank's flops, bytes, collective bytes and peak live bytes; the record
goes to ``<out>/<mesh>/<arch>__<shape>.json`` with the reference's keys::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_production_mesh


def run_cell(arch: str, shape_name: str, mesh, out_path: str,
             cell_cfg=None) -> dict:
    t0 = time.time()
    result = cells.analyze_cell_extrapolated(
        arch, shape_name, mesh, cell=cell_cfg
    )
    result["compile_seconds"] = time.time() - t0
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, out_path)
    return result


def init_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape cell name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    init_fake_world(256 if args.mesh == "single" else 512)
    try:
        meshes = []
        if args.mesh in ("single", "both"):
            meshes.append(("single_pod_16x16", make_production_mesh()))
        if args.mesh in ("multi", "both"):
            meshes.append(("multi_pod_2x16x16",
                           make_production_mesh(multi_pod=True)))
        n_ok, n_fail, n_skip, failures = _run(args, meshes)
    finally:
        dist.destroy_process_group()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    for tag, err in failures:
        print(f"  FAILED: {tag}: {err}")
    if n_fail:
        raise SystemExit(1)


def _run(args, meshes):
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    n_ok = n_fail = n_skip = 0
    failures = []
    for mesh_name, mesh in meshes:
        for arch in archs:
            cfg = get_config(arch)
            shapes = (
                applicable_shapes(cfg)
                if args.shape == "all"
                else [args.shape]
            )
            for shape_name in shapes:
                out_path = os.path.join(
                    args.out, mesh_name, f"{arch}__{shape_name}.json"
                )
                if args.skip_existing and os.path.exists(out_path):
                    n_skip += 1
                    continue
                tag = f"[{mesh_name}] {arch} x {shape_name}"
                try:
                    r = run_cell(arch, shape_name, mesh, out_path)
                    roof = r["roofline"]
                    print(
                        f"OK   {tag}: dominant={roof['dominant']} "
                        f"compute={roof['compute_s']:.4f}s "
                        f"memory={roof['memory_s']:.4f}s "
                        f"collective={roof['collective_s']:.4f}s "
                        f"peak={r['memory']['peak_bytes'] / 2**30:.2f}GiB/dev "
                        f"(dry run {r['compile_seconds']:.0f}s)",
                        flush=True,
                    )
                    n_ok += 1
                except Exception as e:  # noqa: BLE001
                    n_fail += 1
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
                    if args.fail_fast:
                        raise
    return n_ok, n_fail, n_skip, failures


if __name__ == "__main__":
    main()
