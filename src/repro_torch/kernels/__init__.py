"""Hand-written Hopper kernels of the port.

Each kernel has a subpackage with ``ops.py`` (the wrapper: validates,
launches on the current stream, counts launches) and ``ref.py`` (its plain
PyTorch version, which the wrapper takes for CPU tensors and the tests and
``chip_smoke.py`` hold the kernel against).  The CUDA sources live in
``src/repro_torch/csrc/`` and ``_build.py`` compiles them at first use.

* ``segment_reduce`` replaces ``repro/kernels/segment_reduce`` (Pallas),
  writing a reduce wave's rows straight into the outputs; beside it
  ``row_key_sums``, the wave's per-task key sums from the live prefixes;
* ``local_reduce``   replaces ``repro/kernels/local_reduce`` (Pallas);
* ``flash_attention`` replaces ``repro/kernels/flash_attention`` (Pallas);
* ``decode_attention`` replaces ``repro/kernels/decode_attention`` (Pallas);
* ``rwkv6``           replaces ``repro/kernels/rwkv6`` (Pallas);
* ``shuffle_merge``   replaces no Pallas kernel: the lexsort shuffle's
  global sort, gathers and scatter (the reference's ``jnp.lexsort``), as a
  split of the map's sorted task rows and a merge of their runs.  It has
  no ``ref.py`` and takes CUDA tensors only: its plain version is the
  engine's own, ``mapreduce.backends.lexsort_partition``, which
  ``LexsortShuffle.partition`` calls for CPU and meta tensors.
"""

from repro_torch.kernels import (  # noqa: F401
    decode_attention,
    flash_attention,
    local_reduce,
    rwkv6,
    segment_reduce,
    shuffle_merge,
)

__all__ = ["decode_attention", "flash_attention", "local_reduce", "rwkv6",
           "segment_reduce", "shuffle_merge"]
