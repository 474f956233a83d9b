"""The port's dry run (``launch.cells`` on a fake world) against the
reference's small-mesh dry run (``tests/test_dryrun_and_sharding.py``'s
``_DRYRUN_SCRIPT``).

Each (arch, applicable shape) cell runs in its own process: a fake world
of 8 ranks (PyTorch's ``fake`` process-group backend) and a (2, 2, 2)
("pod", "data", "model") mesh, the reference's cut shapes, the smoke
configs in bf16.  The reference's own per-device ``cost_analysis`` flops
of llama3-8b's ``train_4k`` cell (8 placeholder devices) run in one more.
All start together when the module's first test asks (DTensor's first
sharding propagation of each op dominates a cell's wall on a
three-axis mesh).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3-8b", "granite-moe-1b-a400m", "rwkv6-3b")
#: the port's per-device matrix-product flops over the reference's
#: ``cost_analysis`` flops (which also count elementwise work) of
#: llama3-8b's cut ``train_4k`` cell; measured 1.04 when this test was written
FLOPS_RATIO_BAND = (0.9, 1.1)

_SMALL = r"""
import dataclasses
small = {
    "train_4k": dataclasses.replace(C.SHAPES["train_4k"], seq_len=128, global_batch=8),
    "prefill_32k": dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=256, global_batch=4),
    "decode_32k": dataclasses.replace(C.SHAPES["decode_32k"], seq_len=256, global_batch=8),
    "long_500k": dataclasses.replace(C.SHAPES["long_500k"], seq_len=1024, global_batch=1),
}
C.SHAPES.clear(); C.SHAPES.update(small)
"""

_PORT_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
import repro_torch.configs as C
""" + _SMALL + r"""
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
arch, shape = sys.argv[1:3]
cfg = dataclasses.replace(C.smoke_config(arch), param_dtype="bfloat16")
r = cells.analyze_cell_extrapolated(arch, shape, mesh, cfg=cfg)
e = cells.estimate_step_time(arch, shape, mesh, cfg=cfg)
dist.destroy_process_group()
print("RESULT " + json.dumps({"roofline": r["roofline"], "memory": r["memory"], "estimate": e,
                              "probe_group_cost": r["probe_group_cost"]}))
"""

_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import repro.configs as C
""" + _SMALL + r"""
from repro.launch import cells
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = dataclasses.replace(C.smoke_config("llama3-8b"), param_dtype="bfloat16")
r = cells.analyze_cell_extrapolated("llama3-8b", "train_4k", mesh, cfg=cfg)
print("RESULT " + json.dumps({"flops": r["roofline"]["flops"]}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every process at once; {(arch, shape) or "reference": parsed RESULT}."""
    home = tmp_path_factory.mktemp("dryrun_home")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(home), "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    import repro_torch.configs as C

    cmds = {(arch, shape): [sys.executable, "-c", _PORT_SCRIPT, arch, shape]
            for arch in ARCHS for shape in C.applicable_shapes(C.smoke_config(arch))}
    cmds["reference"] = [sys.executable, "-c", _REF_SCRIPT]
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=ROOT) for k, c in cmds.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
            out[name] = json.loads(lines[-1][7:]) if lines and proc.returncode == 0 else \
                RuntimeError(f"{name} exited {proc.returncode}: {stderr[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _result(runs, name):
    r = runs[name]
    if isinstance(r, Exception):
        raise r
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_small_multipod_dryrun(runs, arch):
    """Every applicable shape: positive compute, a valid dominant term, a
    positive peak, collectives counted, and the shallow probes' secant
    extrapolation within 1 % of the full-depth flops."""
    import repro_torch.configs as C

    for shape in C.applicable_shapes(C.smoke_config(arch)):
        r = _result(runs, (arch, shape))
        roof = r["roofline"]
        assert roof["compute_s"] > 0, (arch, shape)
        assert roof["dominant"] in ("compute", "memory", "collective")
        assert r["memory"]["peak_bytes"] > 0
        assert roof["collective_bytes"] > 0, (arch, shape)
        assert sum(roof["collective_bytes_by_kind"].values()) == roof["collective_bytes"]
        assert r["probe_group_cost"]["flops"] > 0
        est_flops = r["estimate"]["compute_s"] * 989e12
        assert est_flops == pytest.approx(roof["flops"], rel=0.01), (arch, shape)


def test_flops_against_the_reference_cost_analysis(runs):
    """llama3-8b's cut ``train_4k`` cell: the port's per-device flops over
    the reference's per-device ``cost_analysis`` flops."""
    port = _result(runs, ("llama3-8b", "train_4k"))["roofline"]["flops"]
    ref = _result(runs, "reference")["flops"]
    lo, hi = FLOPS_RATIO_BAND
    assert lo <= port / ref <= hi, (port, ref, port / ref)
