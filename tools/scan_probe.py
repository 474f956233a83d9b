"""Times two forms of the Mamba chunk scan on one CUDA card.

The port's ``models.ssm._scan_chunk`` follows ``jax.lax.associative_scan``'s
odd/even recursion (O(n) work in 2 log2(n) levels).  The log-step
(Hillis-Steele) form below is shorter: log2(n) steps, each combining every
position t with t - k, O(n log n) work.  Both take jamba-v0.1-52b's chunk,
(8, 256, 8192, 16) float32 (batch 8, a 256-step chunk, d_in 8192,
d_state 16), and ``_selective_scan_chunked`` takes one Mamba layer of the
smoke's prefill, (8, 2048) tokens, with each form.  Order: recursion,
log-step, log-step, recursion; times are means of CUDA-event-fenced calls.
The two forms' outputs are compared.  The bytes bound reads a and b and
writes A and B once.

    python3 tools/scan_probe.py

It prints one line per reading and, last, one JSON object of them.
Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
B, C, D_IN, D_STATE, S = 8, 256, 8192, 16, 2048


def log_step_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 under ``(a_x a_y, a_y b_x + b_y)``, in
    log2(n) Hillis-Steele steps; out of place, so autograd can follow."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return a, b


def device_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import ssm

    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        a = torch.rand((B, C, D_IN, D_STATE), generator=g, device="cuda") * 0.5 + 0.5
        b = torch.randn((B, C, D_IN, D_STATE), generator=g, device="cuda")
        recursion = ssm._scan_chunk
        forms = {"recursion": recursion, "log_step": log_step_scan}
        ra, rb = recursion(a, b)
        la, lb = log_step_scan(a, b)
        err = max(float(((ra - la).abs().max() / ra.abs().max())),
                  float(((rb - lb).abs().max() / rb.abs().max())))
        del ra, rb, la, lb
        bound_ms = 4 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        readings = {"shape": [B, C, D_IN, D_STATE], "max_rel_diff": err,
                    "chunk_bound_ms": bound_ms}
        for name in ("recursion", "log_step", "log_step", "recursion"):
            readings.setdefault(f"{name}_chunk_ms", []).append(
                device_ms(lambda: forms[name](a, b)))
        del a, b
        torch.cuda.empty_cache()

        dt = torch.rand((B, S, D_IN), generator=g, device="cuda") * 0.1 + 1e-3
        dtx = dt * torch.randn((B, S, D_IN), generator=g, device="cuda")
        A = -torch.exp(torch.randn((D_IN, D_STATE), generator=g, device="cuda"))
        Bs, Cs = (torch.randn((B, S, D_STATE), generator=g, device="cuda") for _ in range(2))
        h0 = torch.zeros((B, D_IN, D_STATE), device="cuda")
        try:
            for name in ("recursion", "log_step", "log_step", "recursion"):
                ssm._scan_chunk = forms[name]
                readings.setdefault(f"{name}_layer_ms", []).append(
                    device_ms(lambda: ssm._selective_scan_chunked(h0, dt, dtx, A, Bs, Cs)))
        finally:
            ssm._scan_chunk = recursion
    print(f"chunk {tuple(readings['shape'])} float32: recursion "
          f"{', '.join(f'{t:.3f}' for t in readings['recursion_chunk_ms'])} ms, log-step "
          f"{', '.join(f'{t:.3f}' for t in readings['log_step_chunk_ms'])} ms (bytes bound "
          f"{bound_ms:.3f} ms); outputs differ by {err:.3e} of the largest", flush=True)
    print(f"one Mamba layer's scan at ({B}, {S}) tokens: recursion "
          f"{', '.join(f'{t:.2f}' for t in readings['recursion_layer_ms'])} ms, log-step "
          f"{', '.join(f'{t:.2f}' for t in readings['log_step_layer_ms'])} ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
