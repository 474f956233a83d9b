"""Two measurements of the port's qwen3-0.6b attention path on one CUDA card.

``prefill`` serves 8 prompts of 2048 tokens through ``BatchedServer`` at
the full width of qwen3-0.6b (weights drawn on the card from seed 0,
``max_len`` 4096), as ``chip_smoke.py`` does: after a 64-token warm-up it
times the prefill's first call, three more calls, and one call under
``torch.profiler`` (device busy time and the time of each kernel), then
one warm-up and three timed 2048-token scoring calls (eval step).
``--src`` names the ``src`` directory whose ``repro_torch`` is measured,
so that two commits can be compared in one run:

    python3 tools/attention_probe.py prefill                    # this checkout
    python3 tools/attention_probe.py prefill --src OTHER/src    # another tree

``splits`` times the bfloat16 ``decode_attention`` kernel at the decode
serving shape, q (B, 1, 16, 128) over a full (B, 32768, 8, 128) cache at
B = 8 and B = 1, with the keys cut into a range of split counts (the
``target_blocks`` that ``split_plan`` divides among the row blocks),
beside one ``scaled_dot_product_attention`` call and the HBM bound:

    python3 tools/attention_probe.py splits

Each mode prints one line per reading and, last, one JSON object of them.
Times are CUDA-event means (kernels) or wall times fenced by
``torch.cuda.synchronize`` (prefill, scoring).  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import unittest.mock
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def device_ms(fn, iters: int = 50, warmup: int = 10) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events."""
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


def fenced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled(fn, top: int = 12) -> dict:
    """``fn()`` once under torch.profiler: wall ms, device busy ms, launches
    and the ``top`` kernels by device time, as (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fenced_ms(fn)
    by_kernel: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_kernel.setdefault(evt.name, [0.0, 0])
            entry[0] += evt.time_range.elapsed_us() / 1e3
            entry[1] += 1
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall, "busy_ms": sum(ms for ms, _ in by_kernel.values()),
            "launches": sum(c for _, c in by_kernel.values()),
            "attention_ms": sum(ms for name, (ms, _) in by_kernel.items()
                                if "attention" in name),
            "kernels": [[name[:90], ms, c] for name, (ms, c) in ranked[:top]]}


def mode_prefill() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_eval_step

    cfg = get_config("qwen3-0.6b")
    model = tf.init_params(cfg, seed=0, device="cuda")
    server = BatchedServer(cfg, model, max_len=4096)
    g = torch.Generator(device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=g.manual_seed(7),
                            device="cuda")
    server.serve(prompts[:, :64], 4)  # warm-up
    decode_attention.launches = 0
    prefill_ms = []
    for _ in range(4):  # the first call, then three more
        server.serve(prompts, 1)
        prefill_ms.append(server.last_prefill_s * 1e3)
    if decode_attention.launches != 4 * cfg.n_layers:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times, "
                             f"want {4 * cfg.n_layers}")
    print(f"prefill 8 x 2048 tokens: first {prefill_ms[0]:.1f} ms, then "
          f"{', '.join(f'{t:.1f}' for t in prefill_ms[1:])} ms", flush=True)
    prof = profiled(lambda: server.serve(prompts, 1))
    print(f"prefill under torch.profiler: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, {prof['launches']} launches, attention kernels "
          f"{prof['attention_ms']:.3f} ms", flush=True)
    for name, ms, c in prof["kernels"]:
        print(f"  {ms:8.3f} ms  {c:4d}x  {name}", flush=True)
    del server
    torch.cuda.empty_cache()
    seq = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g.manual_seed(11),
                        device="cuda")
    score = build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))
    score_ms = [fenced_ms(lambda: score(model, {"tokens": seq})) for _ in range(4)][1:]
    print(f"2048-token scoring (eval step, after a warm-up): "
          f"{', '.join(f'{t:.2f}' for t in score_ms)} ms", flush=True)
    return {"prefill_ms": prefill_ms, "profiled": prof, "scoring_ms": score_ms}


def mode_splits() -> dict:
    import importlib

    ops = importlib.import_module("repro_torch.kernels.decode_attention.ops")
    S, Hq, n_kv, hd = 32768, 16, 8, 128
    out = {}
    for B in (8, 1):
        g = torch.Generator(device="cuda").manual_seed(10)
        q = torch.randn((B, 1, Hq, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, n_kv, hd), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        row_blocks = B * n_kv  # one 128-row block per (batch, kv head) at G * Sq = 2
        bound = (2 * B * Hq * hd + 2 * B * S * n_kv * hd) * 2 / HBM_BYTES_PER_S * 1e3
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True))
        plan = ops.split_plan(B, 1, Hq, n_kv, S, S, ops.target_blocks(q.device.index))
        readings = []
        for rnd in range(3):  # three rounds, to show the spread
            for n in (1, 2, 3, 4, 8, 9, 16, 32, 64):
                target = n * row_blocks
                with unittest.mock.patch.object(ops, "target_blocks", lambda _i, t=target: t):
                    got = ops.split_plan(B, 1, Hq, n_kv, S, S, target)
                    ms = device_ms(lambda: ops.decode_attention(q, k, v, S))
                readings.append({"round": rnd, "target": target, "splits": got[0],
                                 "split_keys": got[1], "ms": ms})
                print(f"decode B={B} kv_len=S_max={S}: target {target} blocks -> "
                      f"{got[0]} splits of {got[1]} keys: {ms:.4f} ms "
                      f"({bound / ms:.0%} of the {bound:.4f} ms bound)", flush=True)
        print(f"decode B={B}: SDPA {sdpa:.4f} ms; the wrapper's plan {plan}", flush=True)
        out[f"B{B}"] = {"bound_ms": bound, "sdpa_ms": sdpa, "plan": list(plan),
                        "readings": readings}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("prefill", "splits"))
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="directory holding the repro_torch package to measure")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src {args.src}", flush=True)
    result = mode_prefill() if args.mode == "prefill" else mode_splits()
    print(json.dumps({"mode": args.mode, "card": card, "src": str(args.src), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
