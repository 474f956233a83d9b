"""Train and serve step factories; counterpart of ``repro.train.step``.

Each ``build_*`` function returns a plain function over the model and a
batch; PyTorch runs the steps eagerly (there is no jit).  The train steps
update the model's weights in place and take gradients through the plain
routes (``_sdpa`` attention, the chunked WKV6 form), as the reference trains
through its plain paths: its Pallas kernels have no gradient, so the port's
kernels have no backward.  The serving and scoring steps run without
autograd and may take the kernels (``use_flash=True``).

Distribution is DTensor's: a model whose parameters are DTensors laid
out by ``repro_torch.sharding.rules.param_specs`` (FSDP included) trains
through the same steps, under ``sharding.context.use_mesh``; the
optimizer lays each gradient out as its parameter (ZeRO's reduce-scatter)
and its state mirrors the parameters' placements.  The compressed
data-parallel step is the explicit form: parameters replicated, the
batch split over one mesh axis (or a process group), int8 error-feedback
gradients summed across it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, grad_compress
from repro_torch.sharding.context import is_dtensor


@dataclasses.dataclass(frozen=True)
class StepConfig:
    remat: str = "none"            # none | dots | full
    logits_chunk: int = 0          # 0 = full logits
    microbatch: int = 1            # gradient-accumulation chunks
    use_flash: bool = False        # attention through the hand-written kernels
    cache_dtype: str = "bfloat16"  # KV cache dtype
    # The reference unrolls its layer scan and its microbatch scan for the
    # dry run's flop accounting; the port's layers and microbatches are
    # Python loops, always unrolled, so the knob changes no result.
    unroll_layers: bool = False


def _train_loss(cfg: ModelConfig, step_cfg: StepConfig):
    if step_cfg.use_flash:
        raise NotImplementedError(
            "a train step with use_flash=True: the reference's Pallas kernels have no "
            "gradient (jax.grad through them fails), so the port's kernels have no "
            "backward; train with use_flash=False (the plain _sdpa route) and score "
            "through the kernels with build_eval_step")

    def loss_of(model, batch):
        return tf.loss_fn(model, cfg, batch, remat=step_cfg.remat, wkv_kernel=False,
                          logits_chunk=step_cfg.logits_chunk)

    return loss_of


def _apply(optim_cfg, model, grads: dict, opt_state: dict):
    """AdamW at the schedule's scale, written into the model's weights (a
    DTensor parameter through its local shard: ``apply_updates`` returns
    each new weight laid out as its parameter)."""
    params = dict(model.named_parameters())
    lr_scale = adamw.cosine_schedule(opt_state["step"])
    new, opt_state, metrics = adamw.apply_updates(
        optim_cfg, {n: p.detach() for n, p in params.items()}, grads, opt_state, lr_scale)
    with torch.no_grad():
        torch._foreach_copy_([_local(p) for p in params.values()],
                             [_local(new[n]) for n in params])
    return opt_state, metrics


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def build_train_step(cfg: ModelConfig, optim_cfg: adamw.AdamWConfig,
                     step_cfg: StepConfig = StepConfig()):
    """(model, opt_state, batch) -> (opt_state, metrics), the weights updated
    in place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as tensors.

    With ``microbatch = k > 1`` the batch is cut into k slices along its
    first axis; each slice's gradients are summed in float32 buffers and
    divided by k, as the reference accumulates (at k = 1 the gradients stay
    in the parameter dtype).
    """
    loss_of = _train_loss(cfg, step_cfg)

    def grads_of(model, batch):
        names, leaves = zip(*model.named_parameters())
        k = step_cfg.microbatch
        if k <= 1:
            loss = loss_of(model, batch)
            return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
        for key, leaf in batch.items():
            if leaf.shape[0] % k:
                raise ValueError(f"batch {leaf.shape[0]} not divisible by microbatch {k}")
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(k):
            mb = {key: leaf.reshape(k, leaf.shape[0] // k, *leaf.shape[1:])[i]
                  for key, leaf in batch.items()}
            loss = loss_of(model, mb)
            torch._foreach_add_(g_sum, [g.float() for g in torch.autograd.grad(loss, leaves)])
            loss_sum = loss_sum + loss.detach()
        return loss_sum / k, dict(zip(names, torch._foreach_div(g_sum, k)))

    def train_step(model, opt_state, batch):
        loss, grads = grads_of(model, batch)
        opt_state, metrics = _apply(optim_cfg, model, grads, opt_state)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def build_eval_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """(model, batch) -> forward-only loss (scoring), without autograd."""

    @torch.no_grad()
    def eval_step(model, batch):
        return tf.loss_fn(model, cfg, batch, use_flash=step_cfg.use_flash,
                          logits_chunk=step_cfg.logits_chunk)

    return eval_step


def build_prefill_step(cfg: ModelConfig, max_len: int,
                       step_cfg: StepConfig = StepConfig()):
    """(model, batch) -> (last-token logits, decode state); for an encoder
    (``cfg.causal`` false) -> the logits of every frame, a forward without
    autograd and without a cache."""
    if not cfg.causal:

        @torch.no_grad()
        def encode_step(model, batch):
            return tf.forward(model, cfg, batch, use_flash=step_cfg.use_flash)[0]

        return encode_step
    cache_dtype = getattr(torch, step_cfg.cache_dtype)

    def prefill_step(model, batch):
        return tf.prefill(model, cfg, batch, max_len, use_flash=step_cfg.use_flash,
                          cache_dtype=cache_dtype)

    return prefill_step


def build_decode_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """(model, state, batch (B, S)) -> (logits, state); the state is updated in place."""

    def decode(model, state, batch):
        return tf.decode_step(model, cfg, state, batch, use_flash=step_cfg.use_flash)

    return decode


def build_compressed_dp_train_step(cfg: ModelConfig, optim_cfg: adamw.AdamWConfig,
                                   group=None, step_cfg: StepConfig = StepConfig(), *,
                                   mesh=None, axis: str = "data"):
    """Data-parallel train step with int8 error-feedback gradient compression.

    Returns ``(model, opt_state, err_state, batch) -> (opt_state, err_state,
    metrics)``: each rank of ``group`` (the default group when None), or of
    ``mesh``'s ``axis`` (the reference's form), holds the whole model and
    its slice of the batch (a DTensor batch sharded on ``axis`` gives its
    local shard), takes its gradients, sums them across the ranks through
    ``grad_compress.psum_compressed`` and divides by the world size; the
    loss is the ranks' mean.  The weights are updated in place, the same on
    every rank.  ``err_state`` starts as
    ``grad_compress.init_error_state(dict(model.named_parameters()))``.
    """
    loss_of = _train_loss(cfg, step_cfg)
    if mesh is not None:
        if group is not None:
            raise ValueError("pass a group or a mesh, not both")
        group = mesh.get_group(axis)

    def step(model, opt_state, err_state, batch):
        batch = {k: _local(v) for k, v in batch.items()}
        names, leaves = zip(*model.named_parameters())
        loss = loss_of(model, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        n = dist.get_world_size(group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        grads, err_state = grad_compress.psum_compressed(grads, err_state, group)
        opt_state, metrics = _apply(optim_cfg, model, {k: g / n for k, g in grads.items()},
                                    opt_state)
        metrics["loss"] = loss / n
        return opt_state, err_state, metrics

    return step
