"""Batched serving example: prefill + decode loop with a KV cache, plus the
paper's model predicting decode latency as a function of batch size (the
serving-side scheduling use case from the paper's conclusion); counterpart
of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.serve_lm            # on the card
    PYTHONPATH=src python -m repro_torch.serve_lm --device cpu

The llama3-8b smoke config, with weights from the port's seeded init.
Prefill and decode run through ``decode_attention``; the served logits are
then held against a teacher-forced forward over the same tokens through
``flash_attention`` (rtol and atol 2e-2, the reference's decode-vs-forward
tolerance).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import fit
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import StepConfig, build_decode_step

#: decode vs the teacher-forced forward: rtol and atol, as ``tests/test_models_smoke.py``
TOL = 2e-2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config("llama3-8b")
    model = tf.init_params(cfg, seed=0, device=dev)
    decode = build_decode_step(cfg, StepConfig(use_flash=True))
    max_len = 128

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def serve_batch(batch_size: int, prompt_len: int = 16, new_tokens: int = 32):
        """(tokens (B, prompt_len + new_tokens), the logits that chose each
        new token (B, new_tokens, V), seconds per decoded token)."""
        gen = torch.Generator().manual_seed(batch_size)
        prompts = torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                                generator=gen).to(dev)
        state = tf.init_decode_state(cfg, batch_size, max_len, device=dev)
        logits, state = decode(model, state, {"tokens": prompts})
        seen = [logits[:, -1]]
        toks = logits[:, -1:].argmax(-1)
        outs = [prompts, toks]
        fence()
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            logits, state = decode(model, state, {"tokens": toks})
            seen.append(logits[:, 0])
            toks = logits[:, -1:].argmax(-1)
            outs.append(toks)
        fence()
        dt = time.perf_counter() - t0
        return torch.cat(outs, 1), torch.stack(seen, 1), dt / (new_tokens - 1)

    # warm + serve a batch, then hold it against the teacher-forced forward
    generated, served, per_tok = serve_batch(4)
    print(f"served batch of 4, 32 new tokens, {per_tok * 1e3:.2f}ms/token on "
          f"{dev.type}: sample {generated[0, 16:24].tolist()}")
    with torch.no_grad():
        full, _ = tf.forward(model, cfg, {"tokens": generated[:, :-1]}, use_flash=True)
    want = full[:, 15:].float()
    diff = (served.float() - want).abs()
    err = float(diff.max())
    if not bool((diff <= TOL + TOL * want.abs()).all()):
        raise AssertionError(f"decode differs from the forward pass by up to {err}")
    print(f"decode vs teacher-forced forward: max |diff| {err:.2e} "
          f"(limit {TOL:g} + {TOL:g} |logit|)")

    # paper technique: decode-latency model over the batch-size knob
    sizes, times = [], []
    for b in (1, 2, 4, 8):
        serve_batch(b, new_tokens=4)  # warm this shape
        _, _, t = serve_batch(b, new_tokens=16)
        sizes.append([b])
        times.append(t)
        print(f"batch={b}: {t * 1e3:.2f}ms/token")
    model_ = fit(np.asarray(sizes, float), np.asarray(times),
                 degree=2, scale=True, lam=1e-9, device=dev)
    pred6 = float(model_.predict(np.array([6.0]), device=dev).reshape(-1)[0])
    print(f"predicted ms/token at unprofiled batch=6: {pred6 * 1e3:.2f}ms "
          f"-> a scheduler can now pick batch size against an SLO")
    return {"decode_vs_forward": err, "ms_per_token": dict(zip((1, 2, 4, 8), times)),
            "predicted_batch6_s": pred6, "generated": generated.cpu()}


if __name__ == "__main__":
    main()
