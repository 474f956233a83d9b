"""Step factories: the train steps (plain routes, microbatching, remat,
chunked loss, int8-compressed data parallelism) and the serving steps
(prefill, decode, forward-only evaluation)."""

from repro_torch.train.step import (
    StepConfig,
    build_compressed_dp_train_step,
    build_decode_step,
    build_eval_step,
    build_prefill_step,
    build_train_step,
)

__all__ = [
    "StepConfig",
    "build_compressed_dp_train_step",
    "build_decode_step",
    "build_eval_step",
    "build_prefill_step",
    "build_train_step",
]
