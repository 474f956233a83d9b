"""State-space blocks: RWKV6 (Finch) and Mamba; counterpart of ``repro.models.ssm``.

RWKV6, per head, S in R^{hs x hs}:

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
LoRA, the recurrence and the per-head norm in float32.

Mamba (selective SSM, per channel c, state h[c] in R^{d_state}):

    h_t[c] = exp(A[c] dt_t[c]) h_{t-1}[c] + dt_t[c] B_t x_t[c]
    y_t[c] = C_t . h_t[c] + D[c] x_t[c]

after a causal depthwise conv seeded by the carried tail of the previous
call, with dt = softplus(dt_raw + dt_bias) from one shared ``dt_raw``
column broadcast over the channels, a float32 recurrence and a silu(z)
gate.  A call of S > 1 tokens scans chunks of 256 steps, an associative
scan inside each chunk (``jax.lax.associative_scan``'s recursion) and the
carry across them, building the
(B, chunk, d_in, d_state) tensors one chunk at a time, as the reference
does.  A decode step (S = 1) is one recurrence step: the reference pads it
to a whole chunk of identity steps, which leave the state as it is.  The
reference's scan is plain ``jnp`` (no Pallas kernel), so this one is torch
ops.

On a mesh (DTensor weights and inputs) the recurrences run on each rank's
local shards (``sharding.context.local_region``, the reference's pins made
explicit): RWKV's batch on dp and heads on ``model`` where they divide
(rwkv6-3b's 40 heads do not divide a 16-way axis, so ``u`` stays
replicated), the WKV6 kernel taking the local shards; Mamba's batch on dp
and channels on ``model``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref
from repro_torch.models.layers import (
    dense_weight,
    grad_as_forward,
    merge_heads,
    rmsnorm,
    sigmoid,
    silu,
    split_heads,
)
from repro_torch.sharding.context import constraint, is_dtensor, local_region

_DP = ("pod", "data")

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
    """x_{t-1} for each t: the carried token, then x without its last (on a
    mesh in the hidden layout: the carried token's channels, sharded on
    ``model`` in the state, are gathered)."""
    x_prev = constraint(x_prev.to(xc.dtype), _DP, None)
    return torch.cat([x_prev[:, None], xc[:, :-1]], dim=1)


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
    r = split_heads(xr @ p.wr.to(cdt), H, hs)
    k = split_heads(xk @ p.wk.to(cdt), H, hs)
    v = split_heads(xv @ p.wv.to(cdt), H, hs)
    g = xg @ p.wg.to(cdt)
    # data-dependent decay, float32
    dd = torch.tanh(grad_as_forward(xw @ p.wA.float())) @ p.wB.float()
    w = split_heads(torch.exp(-torch.exp(p.w0.float() + dd)), H, hs)
    u = p.u.float()

    if S == 1:
        def recurrence(r, k, v, w, u, S0):
            r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
            kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
            out = torch.einsum("bhk,bhkv->bhv", r1, S0 + u[None, :, :, None] * kv)[:, None]
            return out, S0 * w1[..., None] + kv
    else:
        def recurrence(r, k, v, w, u, S0):
            fn = wkv6 if wkv_kernel else wkv6_chunked_ref
            return fn(r, k, v, w, u, chunk=chunk, state=S0, out_dtype=torch.float32)
    heads = (_DP, None, "model", None)
    out, S_new = local_region(recurrence, (r, k, v, w, u, state["S"]),
                              (heads, heads, heads, heads, ("model", None),
                               (_DP, "model", None, None)), outs=(0, 5))

    # per-head norm, then the gate (on a mesh laid out as the heads, so
    # that DTensor does not lay the product out along the sequence)
    out = merge_heads(rmsnorm(out, p.ln_w, cfg.norm_eps))
    gate = g.float() * sigmoid(g).float()
    if is_dtensor(out) and tuple(gate.placements) != tuple(out.placements):
        gate = gate.redistribute(out.device_mesh, out.placements)
    out = out * gate
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


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def mamba_shapes(cfg) -> dict:
    """Parameter name -> shape of one Mamba block (``init_mamba``'s names)."""
    d = cfg.d_model
    d_in, ds = cfg.mamba_expand * d, cfg.mamba_d_state
    return {"in_proj": (d, 2 * d_in), "conv_w": (cfg.mamba_d_conv, d_in), "conv_b": (d_in,),
            "x_proj": (d_in, 2 * ds + 1), "dt_bias": (d_in,), "A_log": (d_in, ds),
            "D": (d_in,), "out_proj": (d_in, d)}


def init_mamba(cfg, dtype, generator: torch.Generator, device=None) -> dict:
    """The reference's ``init_mamba`` (same distributions, not the same
    numbers), drawn from ``generator`` on ``device``: the projections at
    ``d_in ** -0.5``, ``conv_w`` normal at 0.2, ``conv_b`` 0, ``dt_bias``
    -4.6 (softplus^-1(0.01)), ``D`` 1, and ``A_log`` = log(1..d_state) per
    channel in float32 whatever ``dtype``."""
    dev = generator.device if device is None else torch.device(device)
    if dev != generator.device:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    shapes = mamba_shapes(cfg)
    d_in, ds = shapes["A_log"]
    out = {}
    for name, shape in shapes.items():
        if name == "conv_w":
            w = torch.randn(shape, generator=generator, device=dev) * 0.2
        elif name == "conv_b":
            w = torch.zeros(shape, device=dev)
        elif name == "dt_bias":
            w = torch.full(shape, -4.6, device=dev)
        elif name == "A_log":
            a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
            out[name] = torch.log(a).expand(d_in, ds).clone()
            continue
        elif name == "D":
            w = torch.ones(shape, device=dev)
        else:
            w = dense_weight(generator, *shape, dtype, dev)
        out[name] = w.to(dtype)
    return out


class Mamba(nn.Module):
    """The parameters of one Mamba block (``init_mamba``), or uninitialised
    for ``load_state_dict`` without a generator; ``A_log`` stays float32."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator | None = None):
        super().__init__()
        if generator is not None:
            weights = init_mamba(cfg, dtype, generator, device)
        else:
            weights = {name: torch.empty(shape, device=device,
                                         dtype=torch.float32 if name == "A_log" else dtype)
                       for name, shape in mamba_shapes(cfg).items()}
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w))


def mamba_state_init(cfg, batch: int, dtype=torch.float32, device="cuda") -> dict:
    """h (batch, d_in, d_state) float32; the conv tail (batch, d_conv - 1,
    d_in) in ``dtype``."""
    d_in = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((batch, d_in, cfg.mamba_d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in), dtype=dtype,
                                device=device)}


def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under the
    reference's combine ``(a_x, b_x) . (a_y, b_y) = (a_x a_y, a_y b_x + b_y)``.

    The recursion of ``jax.lax.associative_scan``, so the float32 products
    and sums pair up as in the reference: combine neighbouring pairs, scan
    those (the odd positions), then fold each even position into the scan
    just before it; O(n) work in 2 log2(n) levels, where the shorter
    log-step (Hillis-Steele) form does O(n log n) and takes 3.3x as long
    on an H100 (``tools/scan_probe.py``).  Returns (A_t, B_t), so that
    h_t = A_t h_0 + B_t."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_odd, b_odd = _scan_chunk(a[:, 0:-1:2] * a[:, 1::2],
                               a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    if n % 2 == 0:
        a_prev, b_prev = a_odd[:, :-1], b_odd[:, :-1]
    else:
        a_prev, b_prev = a_odd, b_odd
    a_even = torch.cat([a[:, :1], a_prev * a[:, 2::2]], dim=1)
    b_even = torch.cat([b[:, :1], a[:, 2::2] * b_prev + b[:, 2::2]], dim=1)

    def interleave(even, odd):
        out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
        out[:, 0::2] = even
        out[:, 1::2] = odd
        return out

    return interleave(a_even, a_odd), interleave(b_even, b_odd)


def _selective_scan_chunked(h0, dt, dtx, A, B_seq, C_seq, chunk: int = 256):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t.

    dt, dtx (B, S, d_in); A (d_in, ds); B_seq, C_seq (B, S, ds); h0
    (B, d_in, ds), all float32.  The (B, c, d_in, ds) decay, input and
    state tensors exist one chunk at a time.  S = 1 is one step.  Returns
    (y (B, S, d_in), h_S (B, d_in, ds)).
    """
    S = dt.shape[1]
    if S == 1:
        h = torch.exp(dt[:, 0, :, None] * A) * h0 + dtx[:, 0, :, None] * B_seq[:, 0, None, :]
        return torch.einsum("bdn,bn->bd", h, C_seq[:, 0])[:, None], h
    h, ys = h0, []
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        a = torch.exp(dt[:, s0:s1, :, None] * A)
        b = dtx[:, s0:s1, :, None] * B_seq[:, s0:s1, None, :]
        aa, bb = _scan_chunk(a, b)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_seq[:, s0:s1]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_block(x, p: Mamba, cfg, state: dict, chunk: int = 256):
    """x (B, S, D); state {"h", "conv"} -> (out (B, S, D) in the compute
    dtype, new state)."""
    B, S, D = x.shape
    cdt = getattr(torch, cfg.compute_dtype)
    ds = cfg.mamba_d_state
    xz = x.to(cdt) @ p.in_proj.to(cdt)
    xs, z = xz.chunk(2, dim=-1)                          # (B, S, d_in)
    # causal depthwise conv over time, seeded by the carried tail
    xpad = torch.cat([state["conv"].to(cdt), xs], dim=1)
    kw = p.conv_w.to(cdt)
    dconv = kw.shape[0]
    xconv = xpad[:, 0:S] * kw[0]
    for i in range(1, dconv):
        xconv = xconv + xpad[:, i:i + S] * kw[i]
    xconv = xconv + p.conv_b.to(cdt)
    # The reference's compiled block leaves the silu's last op, x * sigmoid(x),
    # unrounded where it feeds the float32 recurrence; the projection takes
    # it rounded to the compute dtype.
    xf = xconv.float() * sigmoid(xconv).float()
    xconv = silu(xconv)
    # data-dependent SSM parameters, float32 for the recurrence
    proj = (xconv @ p.x_proj.to(cdt)).float()
    B_ssm, C_ssm, dt_raw = proj[..., :ds], proj[..., ds:2 * ds], proj[..., 2 * ds:]
    # dt_raw (B, S, 1) is shared, broadcast over the channels
    dt = torch.nn.functional.softplus(dt_raw + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    chan, seq = (_DP, None, "model"), (_DP, None, None)
    y, h_S = local_region(
        lambda h0, dt, dtx, A, Bs, Cs: _selective_scan_chunked(h0, dt, dtx, A, Bs, Cs, chunk),
        (state["h"], dt, dt * xf, A, B_ssm, C_ssm),
        ((_DP, "model", None), chan, chan, ("model", None), seq, seq), outs=(1, 0))
    y = y + p.D.float() * xf
    out = (y.to(cdt) * silu(z)) @ p.out_proj.to(cdt)
    conv = xpad[:, xpad.shape[1] - (dconv - 1):] if dconv > 1 else state["conv"]
    return out, {"h": h_S, "conv": conv.to(state["conv"].dtype)}


__all__ = ["LORA", "RWKV", "Mamba", "init_mamba", "mamba_block", "mamba_shapes",
           "mamba_state_init", "rwkv_channel_mix", "rwkv_shapes", "rwkv_state_init",
           "rwkv_time_mix"]
