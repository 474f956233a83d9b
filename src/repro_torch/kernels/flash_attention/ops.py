"""Public wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


#: dtype codes of the attention kernels' C entry points
ATTENTION_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head the kernels take (their largest instance, kMaxHD)
MAX_HEAD_DIM = 256


def check_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """Validate the CUDA operands of an attention kernel: q (B, Sq, Hq, hd),
    k and v (B, Sk, n_kv, hd), one dtype (float32 or bfloat16), contiguous,
    hd a multiple of 16 up to 256, Hq a multiple of n_kv.  The kernels run
    hd in instances of 64, 128 and 256 head dims, zeros past hd."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"{name}: q, k and v must be on one CUDA device, got {q.device}, "
            f"{k.device} and {v.device}"
        )
    if q.dtype not in ATTENTION_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: q, k and v must share one dtype, float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype} and {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: want q (B, Sq, Hq, hd) and k, v (B, Sk, n_kv, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}"
        )
    B, Sq, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(
            f"{name}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(batch, head_dim, or Hq not a multiple of n_kv)"
        )
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head_dim {hd} must be a multiple of 16 up to {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    if B * k.shape[2] > 65535 or max(q.numel(), k.numel()) >= 2**62:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)} are too large")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k, v (B, Sk, n_kv, hd) -> (B, Sq, Hq, hd).

    Query head h reads kv head h // (Hq // n_kv).  CPU tensors take the
    plain version; CUDA tensors (float32 or bfloat16, contiguous, hd a
    multiple of 16 up to 256) launch the kernel on the current stream, or
    raise, also under autograd with an operand that requires grad (the
    kernel has no backward).  ``flash_attention.launches`` counts kernel
    launches.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    check_attention("flash_attention", q, k, v)
    _build.refuse_autograd("flash_attention", "use_flash=False: models.attention._sdpa",
                           q, k, v)
    lib = _build.load()
    B, Sq, Hq, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else hd**-0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device), _build.launch_range("flash_attention"):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ATTENTION_DTYPES[q.dtype], B, Sq, Sk, Hq, n_kv, hd,
            int(causal), scale, stream,
        )
    _build.raise_on_error(lib, "flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
