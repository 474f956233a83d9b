"""Public wrapper of the Hopper WKV6 kernel pair (``csrc/wkv6.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.ref import DEFAULT_CHUNK, KERNEL_CHUNK, wkv6_chunked_ref

#: dtype codes of the kernel's C entry point
WKV6_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HS = MAX_CHUNK = 64


def _check(r, k, v, w, u, state, chunk, out_dtype) -> None:
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if state is not None:
        tensors["state"] = state
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors.values()):
        raise ValueError("wkv6: all operands must be on one CUDA device, got "
                         + ", ".join(f"{n} {t.device}" for n, t in tensors.items()))
    if r.dtype not in WKV6_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k and v must share one dtype, float32 or bfloat16; got "
                        f"{r.dtype}, {k.dtype} and {v.dtype}")
    if any(t.dtype != torch.float32 for n, t in tensors.items() if n in ("w", "u", "state")):
        raise TypeError("wkv6: w, u and state must be float32")
    if out_dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv6: out_dtype must be float32 or r's dtype, got {out_dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: want r, k, v, w of one (B, T, H, hs) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, hs = r.shape
    if tuple(u.shape) != (H, hs) or (state is not None and tuple(state.shape) != (B, H, hs, hs)):
        raise ValueError(f"wkv6: want u {(H, hs)} and state {(B, H, hs, hs)}; got "
                         f"{tuple(u.shape)} and {None if state is None else tuple(state.shape)}")
    if not 1 <= hs <= MAX_HS or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: head size {hs} and chunk {chunk} must be in [1, 64]")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("wkv6: operands must be contiguous")
    if B * H * max(-(-T // KERNEL_CHUNK), 4) > 2**31 - 1:  # blocks of either kernel
        raise ValueError(f"wkv6: shape {tuple(r.shape)} is too large")


def wkv6(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK, state=None, out_dtype=None):
    """r, k, v, w (B, T, H, hs); u (H, hs) -> (out (B, T, H, hs), S_T (B, H, hs, hs)).

    ``state`` (float32, (B, H, hs, hs)) is the initial state, zeros when
    None; ``out`` is in ``out_dtype``, default r's dtype (the Pallas
    contract; the model asks for float32).  S_T is float32.  CPU tensors
    take the plain version (``wkv6_chunked_ref``); CUDA tensors (r, k, v
    float32 or bfloat16, w, u and state float32, contiguous, hs and chunk at
    most 64) launch the kernel pair on the current stream, or raise (also
    under autograd with an operand that requires grad: no backward): first
    ``wkv6_states``, which writes the state entering each 64-step chunk to a
    float32 scratch of (B, H, ceil(T / 64), hs, hs), then ``wkv6_outputs``.
    The kernels tile by 64 steps whatever ``chunk`` is; the value does not
    depend on it, apart from rounding.  ``wkv6.launches`` counts wrapper
    calls that launched the pair (one per call; each launches two kernels).
    """
    out_dtype = out_dtype or r.dtype
    if all(t.device.type == "cpu" for t in (r, k, v, w, u)) and (
            state is None or state.device.type == "cpu"):
        return wkv6_chunked_ref(r, k, v, w, u, chunk=chunk, state=state, out_dtype=out_dtype)
    _check(r, k, v, w, u, state, chunk, out_dtype)
    _build.refuse_autograd("wkv6", "wkv_kernel=False: wkv6_chunked_ref", r, k, v, w, u, state)
    lib = _build.load()
    B, T, H, hs = r.shape
    out = torch.empty(r.shape, dtype=out_dtype, device=r.device)
    s_out = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    states = torch.empty((B, H, -(-T // KERNEL_CHUNK), hs, hs), dtype=torch.float32,
                         device=r.device)
    with torch.cuda.device(r.device), _build.launch_range("wkv6"):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(), s_out.data_ptr(),
            states.data_ptr(), states.shape[2], WKV6_DTYPES[r.dtype], WKV6_DTYPES[out_dtype], B, T, H, hs,
            stream,
        )
    _build.raise_on_error(lib, "wkv6", code)
    wkv6.launches += 1
    return out, s_out


wkv6.launches = 0
