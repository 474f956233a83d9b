"""RWKV6 (Finch) blocks: the time-mix and the channel-mix.

Counterpart of the RWKV half of ``repro.models.ssm`` (Mamba is still to
port).  Per head, S in R^{hs x hs}:

    out_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent decay w_t = exp(-exp(w0 + tanh(x_t A) B)).  A call
of S > 1 tokens runs the chunked recurrence through the hand-written WKV6
kernel (``kernels.rwkv6.wkv6``, one launch per layer, starting from the
carried state; its plain version for CPU tensors), or, with
``wkv_kernel=False``, through that kernel's plain chunked form
(``wkv6_chunked_ref``, the reference's ``lax.scan`` of chunks), which is the
training route: the kernel has no backward, as the reference's Pallas
kernel has no gradient.  A decode step (S = 1) is one recurrence step of
plain einsums, as in the reference.  Numerics follow
the reference: the lerps and projections in the compute dtype, the decay
LoRA, the recurrence and the per-head norm in float32.  The reference's
sharding pins have no counterpart on one card.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref
from repro_torch.models.layers import dense_weight, rmsnorm, sigmoid

#: rank of the decay LoRA (``repro.models.ssm.init_rwkv``)
LORA = 32


def rwkv_shapes(cfg) -> dict:
    """Parameter name -> shape of one RWKV block (``init_rwkv``'s names)."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    H = d // hs
    return {"mix": (5, d), "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
            "wo": (d, d), "w0": (d,), "wA": (d, LORA), "wB": (LORA, d), "u": (H, hs),
            "ln_w": (H, hs), "cm_mix": (2, d), "cm_k": (d, cfg.d_ff), "cm_v": (cfg.d_ff, d),
            "cm_r": (d, d)}


class RWKV(nn.Module):
    """The parameters of one RWKV block, drawn as ``init_rwkv`` draws them
    (same distributions, not the same numbers), or left uninitialised for
    ``load_state_dict`` without a generator."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator | None = None):
        super().__init__()
        for name, shape in rwkv_shapes(cfg).items():
            if generator is None:
                w = torch.empty(shape, dtype=dtype, device=device)
            elif name in ("mix", "cm_mix"):
                w = torch.rand(shape, generator=generator, device=device) * 0.5 + 0.25
            elif name == "w0":
                w = torch.full(shape, -0.6, device=device)
            elif name == "wB":
                w = torch.randn(shape, generator=generator, device=device) * 0.01
            elif name == "u":
                w = torch.randn(shape, generator=generator, device=device) * 0.1
            elif name == "ln_w":
                w = torch.ones(shape, device=device)
            else:
                w = dense_weight(generator, *shape, dtype, device)
            self.register_parameter(name, nn.Parameter(w.to(dtype)))


def rwkv_state_init(cfg, batch: int, dtype=torch.float32, device="cuda") -> dict:
    """S (batch, H, hs, hs) float32; the carried tokens in ``dtype``."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {"S": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32, device=device),
            "x_prev_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "x_prev_cm": torch.zeros((batch, d), dtype=dtype, device=device)}


def _shifted(xc, x_prev):
    """x_{t-1} for each t: the carried token, then x without its last."""
    return torch.cat([x_prev.to(xc.dtype)[:, None], xc[:, :-1]], dim=1)


def rwkv_time_mix(x, p: RWKV, cfg, state: dict, chunk: int = 64, *, wkv_kernel: bool = True):
    """x (B, S, D): S > 1 runs the chunked recurrence (the kernel, or its
    plain chunked form with ``wkv_kernel=False``), S = 1 one step.
    Returns (out (B, S, D) in the compute dtype, new state)."""
    B, S, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    dx = _shifted(xc, state["x_prev_tm"]) - xc
    mix = p.mix.to(cdt)
    xr, xk, xv, xg = (xc + dx * mix[i] for i in range(4))
    # The reference's compiled step leaves the last op before a float32
    # convert unrounded (XLA's excess precision): xw's add here, the gate's
    # x * sigmoid(x) below; every earlier op rounds to the compute dtype.
    xw = xc.float() + (dx * mix[4]).float()
    r = (xr @ p.wr.to(cdt)).reshape(B, S, H, hs)
    k = (xk @ p.wk.to(cdt)).reshape(B, S, H, hs)
    v = (xv @ p.wv.to(cdt)).reshape(B, S, H, hs)
    g = xg @ p.wg.to(cdt)
    # data-dependent decay, float32
    dd = torch.tanh(xw @ p.wA.float()) @ p.wB.float()
    w = torch.exp(-torch.exp(p.w0.float() + dd)).reshape(B, S, H, hs)
    u = p.u.float()

    if S == 1:
        S0 = state["S"]
        r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
        kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
        out = torch.einsum("bhk,bhkv->bhv", r1, S0 + u[None, :, :, None] * kv)[:, None]
        S_new = S0 * w1[..., None] + kv
    else:
        recurrence = wkv6 if wkv_kernel else wkv6_chunked_ref
        out, S_new = recurrence(r, k, v, w, u, chunk=chunk, state=state["S"],
                                out_dtype=torch.float32)

    # per-head norm, then the gate
    out = rmsnorm(out, p.ln_w, cfg.norm_eps)
    out = out.reshape(B, S, D) * (g.float() * sigmoid(g).float())
    out = out.to(cdt) @ p.wo.to(cdt)
    return out, dict(state, S=S_new, x_prev_tm=x[:, -1].to(state["x_prev_tm"].dtype))


def rwkv_channel_mix(x, p: RWKV, cfg, state: dict):
    """x (B, S, D) -> (out (B, S, D) float32, new state).

    The output is the exact float32 product of two compute-dtype tensors:
    the reference's compiled block converts it to the residual's dtype
    without rounding it first, and rounding it to bfloat16 gives the
    rounded product."""
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    dx = _shifted(xc, state["x_prev_cm"]) - xc
    mix = p.cm_mix.to(cdt)
    xk, xr = xc + dx * mix[0], xc + dx * mix[1]
    k = torch.relu(xk @ p.cm_k.to(cdt)) ** 2
    v = k @ p.cm_v.to(cdt)
    r = sigmoid(xr @ p.cm_r.to(cdt))
    return r.float() * v.float(), dict(state, x_prev_cm=x[:, -1].to(state["x_prev_cm"].dtype))


__all__ = ["LORA", "RWKV", "rwkv_channel_mix", "rwkv_shapes", "rwkv_state_init",
           "rwkv_time_mix"]
