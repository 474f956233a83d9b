"""Train an LM with checkpointing and failure recovery, then apply the
paper's profile -> fit -> predict loop to the trainer's own step time;
counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.train_lm                   # ~100M, on the card
    PYTHONPATH=src python -m repro_torch.train_lm --tiny --device cpu

After training, ms/step is profiled at microbatch 1, 2, 4 and 8, fit with
the paper's regression (degree 2) against the microbatch count, and
predicted at the unprofiled microbatch 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fit
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainLoopConfig, run_training
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import StepConfig, build_train_step

#: the default checkpoint directory, under the repository's gitignored build/
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "train_lm"


def model_100m() -> ModelConfig:
    """~100M params: 12L d=768 12H GQA kv=4, llama-style."""
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32000, ffn_type="swiglu", rope_theta=10000.0,
    )


def model_tiny() -> ModelConfig:
    return dataclasses.replace(
        model_100m(), name="repro-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )


def profile_microbatch(cfg, data: DataConfig, knob_values, *, device, repeats: int = 3,
                       lr: float = 1e-3) -> list[float]:
    """Mean seconds per train step at each microbatch count, after a warm-up
    step, fenced by ``torch.cuda.synchronize`` on the card."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    optim_cfg = adamw.AdamWConfig(lr=lr)
    batch = TokenPipeline(data, device=dev).batch_at(0)
    times = []
    for mb in knob_values:
        step = build_train_step(cfg, optim_cfg, StepConfig(microbatch=mb))
        model = tf.init_params(cfg, seed=0, device=dev)
        state = adamw.init_state(optim_cfg, dict(model.named_parameters()))
        state, _ = step(model, state, batch)  # warm-up
        sync()
        reps = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            state, metrics = step(model, state, batch)
            sync()
            reps.append(time.perf_counter() - t0)
        times.append(float(np.mean(reps)))
        del model, state
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = model_tiny() if args.tiny else model_100m()
    steps = args.steps or (60 if args.tiny else 300)
    batch = args.batch or (8 if args.tiny else 16)
    seq = args.seq or (64 if args.tiny else 512)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                      structure=0.9)
    print(f"training {cfg.name} for {steps} steps (batch {batch} x seq {seq}) on {args.device}")
    out = run_training(
        cfg, data,
        TrainLoopConfig(steps=steps, ckpt_dir=args.ckpt_dir, ckpt_every=max(10, steps // 10),
                        fail_at_step=args.fail_at, lr=1e-3),
        StepConfig(remat="none"), device=args.device,
    )
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.4f} -> {losses[-1]:.4f} ({len(losses)} recorded steps)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce the loss")

    # The paper's technique on the trainer itself: step time against the
    # microbatch knob, and a prediction at an unprofiled setting.
    knob_values = [1, 2, 4, 8]
    times = profile_microbatch(cfg, data, knob_values, device=args.device)
    for mb, t in zip(knob_values, times):
        print(f"microbatch={mb}: {t * 1e3:.1f}ms/step")
    model = fit(np.asarray([[float(mb)] for mb in knob_values]), np.asarray(times),
                degree=2, scale=True, lam=1e-9, device=args.device)
    pred3 = float(model.predict(np.array([[3.0]]), device=args.device).cpu().numpy().ravel()[0])
    print(f"predicted step time at unprofiled microbatch=3: {pred3 * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
