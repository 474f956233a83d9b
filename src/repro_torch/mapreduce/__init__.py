"""MapReduce substrate of the port: phase primitives, pluggable backends,
the execution plan and its modes, and the paper's two applications.

    phases.py   — the shared implementation of each phase
    backends.py — swappable shuffle/reduce strategies + registries
    plan.py     — ExecutionPlan: per-grant wave steppers; fused, pipelined,
                  traced, sharded and resumable modes
    spans.py    — named profiler ranges inside a job (phase, wave, shuffle
                  step), opened only while a profiler records
    engine.py   — JobConfig/MapReduceApp + build_job / build_job_sharded
    apps.py     — WordCount and Exim mainlog parsing
    datagen.py  — synthetic corpora (same RNG draws as the reference)
"""

from repro_torch.mapreduce.engine import (
    JobConfig,
    MapReduceApp,
    PAD_KEY,
    build_job,
    build_job_sharded,
    collect_results,
)
from repro_torch.mapreduce.plan import ExecutionPlan
from repro_torch.mapreduce.backends import (
    REDUCE_BACKENDS,
    SHUFFLE_BACKENDS,
    ReduceBackend,
    ShuffleBackend,
    get_reduce_backend,
    get_shuffle_backend,
    register_reduce_backend,
    register_shuffle_backend,
)
from repro_torch.mapreduce.apps import eximparse, wordcount, RECORD_WIDTH
from repro_torch.mapreduce.datagen import exim_mainlog, wordcount_corpus

__all__ = [
    "ExecutionPlan",
    "JobConfig",
    "MapReduceApp",
    "PAD_KEY",
    "build_job",
    "build_job_sharded",
    "collect_results",
    "REDUCE_BACKENDS",
    "SHUFFLE_BACKENDS",
    "ReduceBackend",
    "ShuffleBackend",
    "get_reduce_backend",
    "get_shuffle_backend",
    "register_reduce_backend",
    "register_shuffle_backend",
    "eximparse",
    "wordcount",
    "RECORD_WIDTH",
    "exim_mainlog",
    "wordcount_corpus",
]
