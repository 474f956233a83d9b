"""Measurements of the port's attention and WKV6 paths on one CUDA card.

``prefill`` serves 8 prompts of 2048 tokens through ``BatchedServer`` at
the full width of qwen3-0.6b, or of rwkv6-3b with ``--arch rwkv6-3b``
(weights drawn on the card from seed 0; qwen's ``max_len`` 4096), as
``chip_smoke.py`` does: after a 64-token warm-up it times the prefill's
first call, three more calls, and one call under ``torch.profiler``
(device busy time, the time of each kernel, and of the attention or
``wkv6`` kernels), then one warm-up, three timed 2048-token scoring
calls (eval step) and one under ``torch.profiler``.  ``--src`` names the ``src`` directory whose
``repro_torch`` is measured, so that two commits can be compared in one
run:

    python3 tools/attention_probe.py prefill                    # this checkout
    python3 tools/attention_probe.py prefill --src OTHER/src    # another tree
    python3 tools/attention_probe.py prefill --arch rwkv6-3b --src OTHER/src

``wkv6`` times the WKV6 kernel (bf16 r, k, v with a non-zero float32 state,
float32 out) at rwkv6-3b's serving shapes with 40 heads of 64
(``WKV6_SHAPES``: (8, 2048), (1, 2048), (1, 32768), and the short calls the
serving path makes most, 8 tokens at batch 1-32 and 64 at batch 8), gives
its largest error against the plain chunked version elementwise and per
row (and at (1, 2048) against this checkout's chunked form in float64),
the mean time of a call back to back, and the device time of each kernel
it launches under ``torch.profiler``:

    python3 tools/attention_probe.py wkv6 [--src OTHER/src]

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
import functools
import importlib.util
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


def profiled(fn, top: int = 12, key: str = "attention") -> dict:
    """``fn()`` once under torch.profiler: wall ms, device busy ms, launches,
    the ms of kernels whose name holds ``key``, and the ``top`` kernels by
    device time, as (name, ms, calls)."""
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
            f"{key}_ms": sum(ms for name, (ms, _) in by_kernel.items() if key in name),
            "kernels": [[name[:90], ms, c] for name, (ms, c) in ranked[:top]]}


def mode_prefill(arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_eval_step

    cfg = get_config(arch)
    if arch == "rwkv6-3b":
        from repro_torch.kernels.rwkv6 import wkv6 as kernel
        key, server_kw, step_kw = "wkv6", {}, {}
    else:
        from repro_torch.kernels.decode_attention import decode_attention as kernel
        key, server_kw, step_kw = "attention", {"max_len": 4096}, {"use_flash": True}
    model = tf.init_params(cfg, seed=0, device="cuda")
    server = BatchedServer(cfg, model, **server_kw)
    g = torch.Generator(device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=g.manual_seed(7),
                            device="cuda")
    server.serve(prompts[:, :64], 4)  # warm-up
    kernel.launches = 0
    prefill_ms = []
    for _ in range(4):  # the first call, then three more
        server.serve(prompts, 1)
        prefill_ms.append(server.last_prefill_s * 1e3)
    if kernel.launches != 4 * cfg.n_layers:
        raise AssertionError(f"{key} kernel launched {kernel.launches} times, "
                             f"want {4 * cfg.n_layers}")
    print(f"{arch} prefill 8 x 2048 tokens: first {prefill_ms[0]:.1f} ms, then "
          f"{', '.join(f'{t:.1f}' for t in prefill_ms[1:])} ms", flush=True)
    prof = profiled(lambda: server.serve(prompts, 1), key=key)
    print(f"prefill under torch.profiler: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, {prof['launches']} launches, {key} kernels "
          f"{prof[f'{key}_ms']:.3f} ms", flush=True)
    for name, ms, c in prof["kernels"]:
        print(f"  {ms:8.3f} ms  {c:4d}x  {name}", flush=True)
    del server
    torch.cuda.empty_cache()
    seq = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g.manual_seed(11),
                        device="cuda")
    score = build_eval_step(cfg, StepConfig(logits_chunk=512, **step_kw))
    score_ms = [fenced_ms(lambda: score(model, {"tokens": seq})) for _ in range(4)][1:]
    print(f"2048-token scoring (eval step, after a warm-up): "
          f"{', '.join(f'{t:.2f}' for t in score_ms)} ms", flush=True)
    score_prof = profiled(lambda: score(model, {"tokens": seq}), key=key)
    print(f"scoring under torch.profiler: wall {score_prof['wall_ms']:.3f} ms, device busy "
          f"{score_prof['busy_ms']:.3f} ms, {score_prof['launches']} launches, {key} kernels "
          f"{score_prof[f'{key}_ms']:.3f} ms", flush=True)
    for name, ms, c in score_prof["kernels"]:
        print(f"  {ms:8.3f} ms  {c:4d}x  {name}", flush=True)
    return {"prefill_ms": prefill_ms, "profiled": prof, "scoring_ms": score_ms,
            "scoring_profiled": score_prof}


def mode_splits() -> dict:
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
        plan = ops.split_plan(B, 1, Hq, n_kv, S, S, ops.target_blocks(q.device.index), hd)
        readings = []
        for rnd in range(3):  # three rounds, to show the spread
            for n in (1, 2, 3, 4, 8, 9, 16, 32, 64):
                target = n * row_blocks
                with unittest.mock.patch.object(ops, "target_blocks", lambda _i, t=target: t):
                    got = ops.split_plan(B, 1, Hq, n_kv, S, S, target, hd)
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


def yardstick():
    """This checkout's chunked plain version, whatever ``--src`` names (an
    older tree's may lack ``precision``): in float64 it is the yardstick
    both float32 versions are measured against."""
    spec = importlib.util.spec_from_file_location(
        "wkv6_yardstick", ROOT / "src" / "repro_torch" / "kernels" / "rwkv6" / "ref.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return functools.partial(module.wkv6_chunked_ref, out_dtype=torch.float32,
                             precision=torch.float64)


#: (B, T) of the wkv6 mode: the serving long-prompt batch, one scoring
#: sequence, one long sequence, then the short calls the serving path makes
#: most (8-token prompts at batch 1-32, a 64-token warm-up at batch 8)
WKV6_SHAPES = ((8, 2048), (1, 2048), (1, 32768), (1, 8), (4, 8), (8, 8), (16, 8), (32, 8),
               (8, 64))


def mode_wkv6() -> dict:
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    H, hs, out = 40, 64, {}
    exact_of = yardstick()
    for B, T in WKV6_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * T)
        shape = (B, T, H, hs)
        r, v = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(2))
        k = (torch.randn(shape, generator=g, device="cuda") * 0.5).bfloat16()
        w = torch.rand(shape, generator=g, device="cuda") * 0.949 + 0.05
        u = torch.randn((H, hs), generator=g, device="cuda") * 0.3
        S0 = torch.randn((B, H, hs, hs), generator=g, device="cuda") * 0.5
        call = lambda: wkv6(r, k, v, w, u, state=S0, out_dtype=torch.float32)
        errs = []
        for got, want in zip(call(), wkv6_chunked_ref(r, k, v, w, u, state=S0,
                                                       out_dtype=torch.float32)):
            diff = (got - want).float()
            rows = diff.reshape(-1, hs).norm(dim=-1) / want.reshape(-1, hs).norm(dim=-1).clamp_min(1e-30)
            errs.append((float(diff.abs().max()), float(rows.max())))
        if (B, T) == (1, 2048):  # both float32 versions against float64, and at the w clamp
            for what, w_ in (("", w), (", w = 1e-8", torch.full_like(w, 1e-8))):
                exact = exact_of(r, k, v, w_, u, state=S0)[0]
                got = wkv6(r, k, v, w_, u, state=S0, out_dtype=torch.float32)[0]
                plain = wkv6_chunked_ref(r, k, v, w_, u, state=S0, out_dtype=torch.float32)[0]
                print(f"wkv6 {shape}{what}: out against float64, max abs err: kernel "
                      f"{float((got - exact).abs().max()):.3e}, plain version (float32) "
                      f"{float((plain - exact).abs().max()):.3e}", flush=True)
                del exact, got, plain
        ms = device_ms(call, iters=20 if T > 4096 else 50)
        prof = profiled(call, key="wkv6")
        err, row_err = max(e for e, _ in errs), max(r_ for _, r_ in errs)
        print(f"wkv6 {shape} bf16, state, float32 out: {ms:.4f} ms a call back to back; "
              f"device {prof['wkv6_ms']:.4f} ms in wkv6 kernels of {prof['busy_ms']:.4f} ms "
              f"busy; max abs err {err:.3e}, row err {row_err:.3e} against the plain version; "
              "by kernel: " + ", ".join(f"{name} {kms:.4f} ms" for name, kms, _ in
                                        prof["kernels"]), flush=True)
        out[f"{B}x{T}"] = {"ms": ms, "device_wkv6_ms": prof["wkv6_ms"],
                           "busy_ms": prof["busy_ms"], "max_abs_err": err,
                           "row_err": row_err, "kernels": prof["kernels"]}
        del r, k, v, w, u, S0
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("prefill", "splits", "wkv6"))
    parser.add_argument("--arch", default="qwen3-0.6b", choices=("qwen3-0.6b", "rwkv6-3b"),
                        help="model of the prefill mode")
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
    result = {"prefill": lambda: mode_prefill(args.arch), "splits": mode_splits,
              "wkv6": mode_wkv6}[args.mode]()
    print(json.dumps({"mode": args.mode, "card": card, "src": str(args.src), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
