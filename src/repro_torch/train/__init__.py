"""Step factories.  This slice has the serving half: prefill, decode and
forward-only evaluation; the train steps come with the training slice."""

from repro_torch.train.step import (
    StepConfig,
    build_decode_step,
    build_eval_step,
    build_prefill_step,
)

__all__ = ["StepConfig", "build_decode_step", "build_eval_step", "build_prefill_step"]
