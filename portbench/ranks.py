"""One run of a cell on several cards: a rank process a card, each running
the program's sharded mode on one ``torch.distributed`` group.

:func:`run_ranks` is :func:`portbench.harness.run_local` for a cell whose
``chips`` is above 1.  The calling process builds the program's kernel
library once (so that no two ranks build it at the same time) and touches
no card.  It then starts one process a rank (``spawn``, ``file://`` init
in a temporary directory it owns; NCCL with rank r on card r, or gloo on
the CPU) and waits for them all.

Every rank makes the same corpus from the seed on its own card, and the
ranks compare its checksums.  Each builds the cell's jobs with the
program's ``build_job_sharded`` and warms them.  Then every rank runs the
same closed loop: after each job's fence rank 0 decides whether another
job follows and tells the others with one small broadcast, which lies
between jobs and so inside the window.  A job's wall is rank 0's, from
its call to its fence; the output all-gather that ends a sharded job ends
it on every rank together.  Rank 0 reads back the outputs the check
samples, between jobs and outside the window, as ``run_local`` does; every
rank keeps its own ``dropped`` of the same jobs.  ``tokens_per_s`` counts
the corpus once a job, not once a rank.

Rank 0 then checks its read-back outputs against the reference, holds
every rank's ``dropped`` to its own and the corpora's checksums to one
another, and hands the result line to this process, which prints nothing
unless every rank has ended cleanly.  A rank that raises, dies or does
not answer within ``--seconds`` and :data:`MARGIN_S` ends every rank and
fails the run (:class:`RankFailure`).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import threading
import time
import traceback

import torch

from portbench import gen, harness, profiling, spans
from portbench.spec import HERE, Cell

#: seconds a run's ranks may take beyond ``--seconds``: imports, the
#: group, the corpus, the warm-up, the traced extras and the check
MARGIN_S = 300.0
#: seconds the ranks have to end once rank 0 has answered
EXIT_S = 60.0
#: corpus tokens a checksum call reads at a time
CHUNK = 1 << 26
#: the ranks' CUDA allocator: a sharded job's buffers of several GiB
#: change size from phase to phase, and in fixed segments the freed ones
#: left a 2**29-token rank short of 18 GiB with 34 GiB reserved but free
ALLOC_CONF = "expandable_segments:True"


class RankFailure(RuntimeError):
    """A rank raised, died or did not answer: the run has no result."""


def run_ranks(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
              device="cuda", tokens: int | None = None, hook=None,
              margin: float = MARGIN_S):
    """One run of a cell on ``cell.chips`` ranks.  Returns (result line,
    lines for standard error, the checked numbers last).  ``hook(rank,
    corpus)``, a function each rank calls once it has made its corpus,
    may break the program underneath (tests)."""
    world = cell.chips
    for job in cell.jobs():
        if job.workers != world or job.shuffle_backend != "all_to_all":
            raise ValueError(f"{cell.name}: a cell on {world} cards runs the "
                             f"all-to-all shuffle on {world} workers, not {job}")
    kind = torch.device(device).type
    cold = _build(kind)
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for rank in range(world):
            reader, writer = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=rank_main, name=f"portbench-rank-{rank}", daemon=True,
                args=(rank, writer, os.getpid(), f"file://{tmp}/pg", kind, cell, seed,
                      seconds, trace, t_start, tokens, hook, seconds + margin + EXIT_S))
            proc.start()
            writer.close()
            procs.append(proc)
            conns.append(reader)
        replies = _collect(procs, conns, time.monotonic() + seconds + margin)
        for proc in procs:
            proc.join(EXIT_S)
        codes = [proc.exitcode for proc in procs]
        if any(code != 0 for code in codes):
            raise RankFailure(f"ranks ended with exit codes {codes}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(10.0)
        for conn in conns:
            conn.close()
        shutil.rmtree(tmp, ignore_errors=True)
    line, log = replies[0]["result"]
    foreign = sorted({m for r in replies for m in r["foreign"]})
    if foreign:
        raise RankFailure(f"modules that may not be loaded are loaded in a rank: "
                          f"{foreign}")
    log.insert(1, "portbench: kernel library "
               + (f"built cold in {cold:.1f} s" if cold else "already built"))
    return line, log


def _build(kind: str) -> float:
    """Build the program's kernel library (once per checkout), without
    loading it: this process uses no card.  The seconds a cold build took."""
    if kind != "cuda":
        return 0.0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _, log = _build.build()
    return time.perf_counter() - t0 if log else 0.0


def _collect(procs, conns, deadline: float) -> list:
    """Every rank's reply, in rank order.  Raises on a rank's error, death
    or silence past ``deadline``."""
    replies = [None] * len(procs)
    pending = dict(enumerate(conns))
    while pending:
        sentinels = {procs[r].sentinel: r for r in pending}
        ready = mpc.wait([*pending.values(), *sentinels],
                         max(0.0, deadline - time.monotonic()))
        if not ready:
            raise RankFailure(f"ranks {sorted(pending)} of {len(procs)} did not "
                              "answer in time")
        for obj in ready:
            r = sentinels.get(obj)
            if r is None:
                r = next(r for r, c in pending.items() if c is obj)
            elif r not in pending or pending[r].poll():
                continue  # its answer is read below, or was read
            try:
                status, payload = pending[r].recv()
            except (EOFError, OSError):
                procs[r].join(5.0)
                raise RankFailure(f"rank {r} of {len(procs)} ended with exit code "
                                  f"{procs[r].exitcode} before answering") from None
            if status != "ok":
                raise RankFailure(f"rank {r} of {len(procs)} failed:\n{payload}")
            replies[r] = payload
            del pending[r]
    return replies


# ---------------------------------------------------------------- the ranks


def _exit_with_parent(parent_pid: int) -> None:
    """A rank blocked in a collective reads nothing, so a thread ends the
    process once the process that started it is gone."""

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _pin(rank: int, world: int) -> None:
    """This process on its share of the cores it may use, the r-th of
    ``world`` contiguous blocks, so that no rank's host work waits on
    another's or moves between cores mid-job."""
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // world
    if share:
        os.sched_setaffinity(0, cores[rank * share:(rank + 1) * share])


def rank_main(rank, conn, parent_pid, init, kind, cell, seed, seconds, trace,
              t_start, tokens, hook, timeout) -> None:
    """A rank process: its part of the run, then its reply (``("ok",
    {"result": ..., "foreign": ...})`` or ``("error", traceback)``)."""
    started = time.time()
    _exit_with_parent(parent_pid)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    try:
        result = _Rank(rank, init, kind, cell, timeout, started).run(
            seed, seconds, trace, t_start, tokens, hook)
        reply = ("ok", {"result": result, "foreign": harness.foreign_modules()})
    except Exception:
        reply = ("error", traceback.format_exc())
    conn.send(reply)
    conn.close()


class _Rank:
    def __init__(self, rank: int, init: str, kind: str, cell: Cell, timeout: float,
                 started: float):
        import torch.distributed as dist

        self.rank, self.cell, self.world = rank, cell, cell.chips
        #: when each step of set-up ended, time.time()
        self.marks = {"started": started}
        _pin(rank, self.world)
        if kind == "cuda":
            torch.cuda.set_device(rank)
            self.device, backend = torch.device("cuda", rank), "nccl"
        else:
            torch.set_num_threads(1)
            self.device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=self.world,
                                timeout=datetime.timedelta(seconds=timeout))
        self.marks["group"] = time.time()

    def run(self, seed, seconds, trace, t_start, tokens, hook):
        """This rank's part of one run; rank 0's (result line, log)."""
        import torch.distributed as dist

        from repro_torch.mapreduce import build_job_sharded

        cell, dev, rank = self.cell, self.device, self.rank
        tokens = int(cell.config["tokens"] if tokens is None else tokens)
        harness.kernels_ready(dev)
        self.marks["library"] = time.time()
        corpus = gen.corpus(cell.config, seed, dev, tokens)
        if hook is not None:
            hook(rank, corpus)
        corpus_differing = self.ranks_differing(checksum(corpus))
        self.marks["corpus"] = time.time()
        mix = cell.jobs()
        app = cell.app(tokens)
        jobs = [build_job_sharded(app, m.job_config(), tokens, None, device=dev)
                for m in mix]
        harness.run_rounds(jobs, corpus, dev, int(cell.traffic.get("warmup_rounds", 1)))
        self.marks["warm-up"] = time.time()
        self.barrier()
        window, dropped = self.closed_loop(
            lambda i: jobs[i](corpus), len(mix), seconds,
            harness.checked(seed, int(cell.traffic["check_every"])))
        peak = self.reduce_max(harness.memory_peak(dev))
        records = {"enqueue_s": window.enqueue}
        if trace:
            records.update(self.trace_extras(mix, jobs, corpus, tokens))
        dropped_differing = self.ranks_differing(dropped)
        del jobs
        harness.free(dev)
        dist.destroy_process_group()
        if rank != 0:
            return None
        return self.report(seed, trace, t_start, tokens, corpus, mix, window,
                           records, peak, corpus_differing, dropped_differing)

    # ---------------------------------------------------------- collectives

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def reduce_max(self, value: int) -> int:
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def mean(self, value: float) -> float:
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return float(t.item()) / self.world

    def ranks_differing(self, values) -> int:
        """Ranks whose ``values`` (a list of ints, the same length on every
        rank) differ from rank 0's anywhere."""
        import torch.distributed as dist

        mine = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return sum(not torch.equal(p, parts[0]) for p in parts[1:])

    # ---------------------------------------------------------- the window

    def closed_loop(self, call, n_mix: int, seconds: float, keep):
        """``harness.closed_loop`` on every rank in step: rank 0's clock
        decides when the window closes.  Returns rank 0's window (walls,
        read-backs) and this rank's ``dropped`` of the kept jobs."""
        import torch.distributed as dist

        dev = self.device
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        walls, enqueue, outputs, dropped = [], [], [], []
        first, begin = time.time(), time.perf_counter()
        deadline = begin + seconds
        end, readback, pending = begin, 0.0, 0.0
        i, last = 0, False
        while not last:
            # a read-back lies inside the window only when a job follows it
            readback, pending = readback + pending, 0.0
            t0 = time.perf_counter()
            out = call(i % n_mix)
            t1 = time.perf_counter()
            harness.sync(dev)
            end = time.perf_counter()
            walls.append(end - t0)
            enqueue.append(t1 - t0)
            if self.rank == 0:
                last = end >= deadline
                if keep(i, last):
                    r0 = time.perf_counter()
                    outputs.append((i, i % n_mix, harness.read_output(out)))
                    pending = time.perf_counter() - r0
                flag.fill_(int(last))
            dist.broadcast(flag, 0)
            last = bool(flag.item())
            if keep(i, last):
                dropped.append(int(out[2]))
            del out
            i += 1
        window = harness.Window(walls, enqueue, begin, end, outputs, first, readback)
        return window, dropped

    def trace_extras(self, mix, jobs, corpus, tokens: int) -> dict:
        """The traced run's records, read on rank 0: the sharded jobs under
        the profiler on every rank, started together (the device's busy
        seconds and the profiled window's, each averaged over the ranks),
        and the sharded traced mode's ``JobTrace``."""
        from repro_torch.mapreduce import build_job_sharded
        from repro_torch.telemetry import PhaseRecorder

        cell, dev = self.cell, self.device
        rounds = int(cell.traffic.get("trace_rounds", 1))
        self.barrier()
        with profiling.traced(dev) as box:
            harness.run_rounds(jobs, corpus, dev, rounds)
        recorder = PhaseRecorder()
        app = cell.app(tokens)
        for m in mix:
            traced_job = build_job_sharded(app, m.job_config(), tokens, None,
                                           recorder=recorder, device=dev)
            for _ in range(rounds):
                out = traced_job(corpus)
                del out
        summary = profiling.summary(box)
        return {
            **spans.records(box),
            "traces": [t.to_dict() for t in recorder.traces],
            "link_bytes_per_s": link_bytes_per_s(dev),
            # each rank's busy share of its own profiled window: the means
            # of both keep busy_s within window_s
            "busy_s": self.mean(summary["busy_s"]),
            "window_s": self.mean(summary["window_s"]),
            "breakdown": {"device_ops": summary["device_ops"],
                          "idle_gaps": summary["idle_gaps"]},
        }

    # ---------------------------------------------------------- the result

    def report(self, seed, trace, t_start, tokens, corpus, mix, window, records,
               peak, corpus_differing, dropped_differing):
        """Rank 0's check and result line, once the program's state is
        freed."""
        cell, dev = self.cell, self.device
        wrong, bad_jobs = harness.check(cell, mix, corpus, window.outputs, tokens)
        log = [f"portbench: {cell.name} seed {seed}: {len(window.walls)} jobs on "
               f"{self.world} ranks in {window.seconds:.3f} s (read-backs "
               f"{window.readback:.3f} s apart)",
               f"info memory_peak_gib {peak / 2**30:.3f} (the fullest rank)",
               "info setup_s by step on rank 0, from the start of the run: " + " ".join(
                   f"{k} {v - t_start:.2f}" for k, v in self.marks.items())
               + f" first-job {window.first_job_wall - t_start:.2f}"]
        breakdown = None
        if trace:
            records["exchange_bytes"] = exchange_bytes(cell, mix, corpus, tokens)
            breakdown = records.pop("breakdown")
            log.append(f"info power_limit {harness.power_limit()} (exchange against "
                       f"{records['link_bytes_per_s']} B/s a direction)")
            values = harness.layer_values(cell, records)
            dev_info = harness.device_info(dev, self.world, peak)
            dev_info.update(busy_s=records["busy_s"], window_s=records["window_s"])
        else:
            measured = harness.end_to_end(window, tokens,
                                          window.first_job_wall - t_start)
            values = {m["name"]: measured[harness.base_name(m["name"])]
                      for m in harness.metrics_for(cell, trace=False)}
            dev_info = harness.device_info(dev, self.world, peak)
        log.append(f"info jobs_checked {len(window.outputs)} jobs_wrong {bad_jobs}")
        checks = {"mismatched_slots": wrong,
                  "rank_dropped_differing": dropped_differing,
                  "corpus_ranks_differing": corpus_differing}
        log += [f"check {k} {v} limit 0" for k, v in checks.items()]
        correct = not any(checks.values()) and len(window.outputs) > 0
        line = harness.result(cell, values, trace, correct, len(window.walls),
                              bad_jobs, dev_info, wrong, breakdown)
        line["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
        return line, log


def checksum(corpus: torch.Tensor) -> list:
    """Two int64 sums of the corpus (the second weighted by position mod
    2**16, wrapping as int64 sums do), read a chunk at a time."""
    plain = weighted = 0
    for lo in range(0, corpus.shape[0], CHUNK):
        x = corpus[lo:lo + CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + x.shape[0], device=x.device) % 65536
        plain += int(x.sum())
        weighted += int((x * w).sum())
    return [plain, (weighted + 2**63) % 2**64 - 2**63]


def link_bytes_per_s(device) -> float | None:
    """The card's published NVLink bandwidth a direction, from
    ``peaks.json``."""
    if torch.device(device).type != "cuda":
        return None
    import json

    entry = json.loads((HERE / "peaks.json").read_text()).get(
        torch.cuda.get_device_name(torch.device(device)))
    return None if entry is None or "nvlink_bytes_per_s" not in entry \
        else float(entry["nvlink_bytes_per_s"])


def exchange_bytes(cell: Cell, mix, corpus, tokens: int) -> float:
    """Bytes of the live pairs rank 0 sends the other ranks in one job,
    8 B a pair, from the corpus and the hash (``reference.sent_pairs``),
    averaged over the jobs of the mix."""
    from portbench.readers import PAIR_BYTES
    from portbench.reference import sent_pairs

    total = 0
    for m in mix:
        sent = sent_pairs(corpus, cell.shape(m, tokens))
        total += int(sent[0].sum() - sent[0, 0])
    return float(PAIR_BYTES * total / len(mix))


__all__ = ["MARGIN_S", "RankFailure", "checksum", "run_ranks"]
