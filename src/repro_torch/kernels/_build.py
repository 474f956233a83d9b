"""Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and loads them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (all sources at once,
one process each) and links one shared library with a plain C interface,
named by a hash of the sources and flags, into ``build/repro_torch/`` at
the repository root.  The build happens at first use; a library already
built from the same sources is reused.  ``ctypes`` loads it.  There is no
fallback: a missing ``nvcc`` or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's CUDA "
        "kernels are built from source and need the CUDA toolkit"
    )


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile and link the kernels unless already built.

    Returns (library path, compiler output); the output is empty when the
    library was already there.
    """
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        logs, failed = [], []
        for src, _, proc in jobs:
            stdout, stderr = proc.communicate()
            logs.append(f"== {src.name}\n{stdout}{stderr}")
            if proc.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        linked = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(linked),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(linked, out)
    return out, log


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.segment_reduce_scratch.argtypes = [i32, i32]
    lib.segment_reduce_scratch.restype = i64
    lib.segment_reduce_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.segment_reduce_launch.restype = i32
    lib.row_key_sums_launch.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.row_key_sums_launch.restype = i32
    lib.local_reduce_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.local_reduce_launch.restype = i32
    lib.local_reduce_tiles.argtypes = [i32]
    lib.local_reduce_tiles.restype = i32
    f32 = ctypes.c_float
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                           i32, i32, i32, i32, f32, ptr]
    lib.flash_attention_launch.restype = i32
    lib.decode_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                            i32, i32, i32, i32, i32, i32, i32, i32,
                                            f32, ptr]
    lib.decode_attention_launch.restype = i32
    lib.wkv6_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                i32, i32, i32, i32, ptr]
    lib.wkv6_launch.restype = i32
    lib.shuffle_merge_scratch.argtypes = [i32, i32, i32]
    lib.shuffle_merge_scratch.restype = i64
    lib.shuffle_merge_max_reducers.argtypes = []
    lib.shuffle_merge_max_reducers.restype = i32
    for stage in (lib.shuffle_split_launch, lib.shuffle_merge_launch):
        stage.argtypes = [ptr, i64, ptr, i64, ptr, i64, i32, i32, i32, i32, i32, ptr, ptr,
                          ptr, ptr, ptr]
        stage.restype = i32
    lib.spill_sort_scratch.argtypes = [i32, i32]
    lib.spill_sort_scratch.restype = i64
    lib.spill_sort_launch.argtypes = [ptr, i64, ptr, i64, ptr, i64, i32, i32, ptr, ptr, i64,
                                      ptr, i64, ptr, i64, ptr, ptr, ptr]
    lib.spill_sort_launch.restype = i32
    lib.kernel_error_string.argtypes = [i32]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


MAX_ROWS = 65535  # grid.y limit: one grid row per tensor row


def check_rows(name: str, keys: torch.Tensor, values: torch.Tensor) -> None:
    """Validate the (N, C) int32 CUDA operands of a sorted-run kernel."""
    if keys.device.type != "cuda" or values.device != keys.device:
        raise ValueError(
            f"{name}: keys and values must be on one CUDA device, got "
            f"{keys.device} and {values.device}"
        )
    if keys.dtype != torch.int32 or values.dtype != torch.int32:
        raise TypeError(
            f"{name}: keys and values must be int32, got {keys.dtype} and "
            f"{values.dtype}"
        )
    if keys.dim() != 2 or keys.shape != values.shape:
        raise ValueError(
            f"{name}: keys and values must share one (N, C) shape, got "
            f"{tuple(keys.shape)} and {tuple(values.shape)}"
        )
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{name}: keys and values must be contiguous")
    if keys.shape[0] > MAX_ROWS or keys.shape[1] >= 2**31:
        raise ValueError(f"{name}: shape {tuple(keys.shape)} is too large")


_NO_RANGE = contextlib.nullcontext()


def launch_range(name: str):
    """``repro_torch::<name>``, a host operation around a kernel's ctypes
    launch while a ``torch.profiler`` records; a shared ``nullcontext``
    otherwise.  The profiler ties a device kernel to the host operation
    open at its launch, never to a ``record_function`` range, and a ctypes
    call is no operation: without this range the kernel's device time
    belongs to none of the ranges around it."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_RANGE
    return torch._C._profiler._RecordFunctionFast(f"repro_torch::{name}")


def raise_on_error(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({code})")



def refuse_autograd(name: str, plain_route: str, *tensors) -> None:
    """Raise when autograd would record a kernel call.

    The kernels write into fresh outputs through raw pointers, so their
    results carry no ``grad_fn``: a call under autograd would silently cut
    the gradient through it.  The reference's Pallas kernels have no
    gradient either, so the kernels have no backward; training takes the
    plain route ``plain_route`` instead.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: called under autograd with an operand that requires grad; the "
            f"kernel has no backward (the reference's Pallas kernel has no gradient), "
            f"so its output would silently cut the gradient. Training takes the plain "
            f"route ({plain_route}); run the kernel under torch.no_grad() or "
            f"torch.inference_mode()"
        )
