"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (counterpart of ``repro.optim.grad_compress``).

Each tensor is quantized to int8 with one float32 scale before the
reduction; the quantization residual stays local and is added to the next
step's gradient, so the compression error does not pile up over steps.
``torch.round`` and ``jnp.round`` both round half to even, so
:func:`quantize` gives the reference's values bit for bit.  Trees are dicts
of tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor, bits: int = 8):
    """Per-tensor symmetric quantization. Returns (q int8, scale float32)."""
    g32 = g.float()
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(g32.abs().max() / qmax, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress_tree(grads: dict, error_state: dict):
    """Error feedback, then quantize every tensor.

    Returns ({name: (q, scale)}, new error state)."""
    qtree, etree = {}, {}
    for n, g in grads.items():
        g32 = g.float() + error_state[n]
        q, scale = quantize(g32)
        qtree[n] = (q, scale)
        etree[n] = g32 - dequantize(q, scale)
    return qtree, etree


def decompress_tree(qtree: dict) -> dict:
    return {n: dequantize(q, scale) for n, (q, scale) in qtree.items()}


@torch.no_grad()
def psum_compressed(grads: dict, error_state: dict, group=None):
    """Quantize, sum as int32 across ``group``'s ranks, dequantize.

    Returns (the sum over ranks, new error state).  Every rank quantizes
    with the largest of the ranks' scales (all-reduced with MAX) so that
    dequantization agrees; the int8 payloads are summed as int32, since
    int8 sums overflow.  The scales travel in one all-reduce and the
    payloads, concatenated, in another: two collectives a step, whatever
    the number of tensors.  NCCL on the card, gloo for CPU tensors.
    """
    names = list(grads)
    g32 = [grads[n].float() + error_state[n] for n in names]
    scales = torch.clamp(torch.stack(torch._foreach_norm(g32, ord=float("inf"))) / 127.0,
                         min=1e-12)
    dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    qs = [torch.clamp(torch.round(g / scales[i]), -127, 127).to(torch.int8)
          for i, g in enumerate(g32)]
    total = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    summed, errors, offset = {}, {}, 0
    for i, n in enumerate(names):
        q, size = qs[i], qs[i].numel()
        summed[n] = total[offset:offset + size].reshape(q.shape).float() * scales[i]
        errors[n] = g32[i] - dequantize(q, scales[i])
        offset += size
    return summed, errors


__all__ = ["compress_tree", "decompress_tree", "dequantize", "init_error_state",
           "psum_compressed", "quantize"]
