"""The port stands alone: importing every module of ``src/repro_torch/``
(the examples and the rank world included) loads neither ``jax`` nor any
module of the reference package ``repro``.  Run in a fresh interpreter,
since this test session imports both."""

import json
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch

names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    for name in ("mapreduce.ranks", "mapreduce_wordcount", "phase_breakdown", "cluster_sim",
                 "elastic_preempt", "serve_lm", "service_overload", "autotune_mesh",
                 "quickstart", "train_lm", "launch.cluster", "cluster.oracle"):
        assert f"repro_torch.{name}" in report["modules"], name
