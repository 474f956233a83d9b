"""Batched serving loop; counterpart of ``repro.launch.serve``.

A continuous decode loop with request batching and KV-cache management,
and SLO-aware batch sizing driven by the paper's config->time model: the
server profiles decode latency at a few batch sizes, fits the regression
(degree 2), and picks the largest batch whose *predicted* per-token
latency meets the SLO.  Attention runs through the hand-written kernels
(``StepConfig(use_flash=True)``); Mamba layers carry their recurrent
state and conv tail in the decode state, MoE layers route each call's
tokens with the capacity of that call.

    PYTHONPATH=src python -m repro_torch.launch.serve                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --requests 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import fit
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import StepConfig, build_decode_step


class BatchedServer:
    def __init__(self, cfg, model, *, max_len: int = 256):
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.step_cfg = StepConfig(use_flash=True)
        self.device = model.embed.device
        self.decode = build_decode_step(cfg, self.step_cfg)
        self.last_prefill_s = 0.0  # prefill time of the last ``serve`` call
        self.profiled: dict[int, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def serve(self, prompts: torch.Tensor, new_tokens: int):
        """prompts (B, P) int -> ((B, new_tokens) int64, seconds per token).

        Greedy decoding.  Seconds per token cover the decode steps after the
        first token, fenced by ``torch.cuda.synchronize`` on the card; the
        prefill's time is kept in ``last_prefill_s``.
        """
        B = prompts.shape[0]
        state = tf.init_decode_state(self.cfg, B, self.max_len,
                                     getattr(torch, self.step_cfg.cache_dtype), self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, state = self.decode(self.model, state, {"tokens": prompts.to(self.device)})
        tok = torch.argmax(logits[:, -1:], -1)
        self._sync()
        t1 = time.perf_counter()
        self.last_prefill_s = t1 - t0
        out = [tok]
        for _ in range(new_tokens - 1):
            logits, state = self.decode(self.model, state, {"tokens": tok})
            tok = torch.argmax(logits[:, -1:], -1)
            out.append(tok)
        self._sync()
        dt = (time.perf_counter() - t1) / max(new_tokens - 1, 1)
        return torch.cat(out, dim=1), dt

    def token_latency(self, batch: int, prompt_len: int = 8, repeats: int = 2) -> float:
        """Mean seconds per decoded token at ``batch``, after a warm-up serve."""
        prompts = torch.zeros((batch, prompt_len), dtype=torch.int64, device=self.device)
        self.serve(prompts, 4)  # warm-up
        return float(np.mean([self.serve(prompts, 8)[1] for _ in range(repeats)]))

    def profile_latency_model(self, sizes=(1, 2, 4, 8), prompt_len=8, repeats=2):
        """Paper phase 1+2 on the serving knob: batch size -> s/token.

        The measured points are kept in ``profiled`` (batch -> s/token).
        """
        self.profiled = {b: self.token_latency(b, prompt_len, repeats) for b in sizes}
        rows = [[float(b)] for b in sizes]
        times = [self.profiled[b] for b in sizes]
        return fit(np.asarray(rows), np.asarray(times), degree=2, scale=True,
                   lam=1e-9, device=self.device)

    def pick_batch_for_slo(self, model, slo_s: float, candidates=range(1, 65)) -> int:
        preds = model.predict(np.asarray([[float(b)] for b in candidates]),
                              device=self.device).cpu().numpy().ravel()
        ok = [b for b, p in zip(candidates, preds) if p <= slo_s]
        return max(ok) if ok else min(candidates)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = tf.init_params(cfg, seed=0, device=dev)
    server = BatchedServer(cfg, model)
    print("profiling decode latency vs batch size ...")
    latency = server.profile_latency_model()
    batch = server.pick_batch_for_slo(latency, args.slo_ms / 1e3)
    print(f"SLO {args.slo_ms}ms/token -> predicted max batch {batch}")
    done = 0
    while done < args.requests:
        b = min(batch, args.requests - done)
        g = torch.Generator(device=dev).manual_seed(done)
        prompts = torch.randint(0, cfg.vocab_size, (b, 8), generator=g, device=dev)
        _, per_tok = server.serve(prompts, args.new_tokens)
        done += b
        print(f"served {b} requests ({per_tok * 1e3:.2f}ms/token, "
              f"{done}/{args.requests} done)")


if __name__ == "__main__":
    main()
