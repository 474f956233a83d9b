"""A world of W rank processes that run the plan's sharded mode.

The reference's sharded mode is one controller driving a mesh of W
devices.  The port's (:meth:`ExecutionPlan.sharded`) runs one rank of a
``torch.distributed`` process group, and one process cannot be W ranks;
this module has no reference counterpart.  A :class:`RankWorld` starts W
processes (``spawn``), joined by NCCL with rank r on card r when the
device is ``cuda``, and by gloo on the CPU.  It stays up until
:meth:`RankWorld.close` (or a ``with`` block, or interpreter exit) ends
it; a rank exits by itself when its controller goes away.

The controller sends a :class:`RankRequest` to every rank over a pipe.
Each rank builds the corpus (``runner.make_app``, seed 0) and the plan
(shuffle ``all_to_all``, the sharded mode's collective) itself, cached by
request, runs ``plan.sharded(recorder=...)`` ``warmup``
times when it first builds it, then times one run that starts after a
barrier and ends in ``torch.cuda.synchronize`` on the card.  The
:class:`RankReply` carries the largest rank wall, rank 0's ``JobTrace``
(traced requests), the kernel launches every rank made while serving the
request, and rank 0's outputs when asked.

Nothing falls back: a world larger than the visible devices raises
``ValueError`` before any process starts (NCCL puts no two ranks on one
card), and a rank that raises, dies or does not answer within ``timeout``
seconds raises in the controller, with the rank's traceback, and ends the
world.

Ranks start with ``spawn``, which imports the controller's main module
in every rank: a script that starts a world keeps its work under
``if __name__ == "__main__"``.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import threading
import time
import traceback
import weakref

import torch

#: seconds a rank may take to answer one request (and its collectives' timeout)
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class RankRequest:
    """One sharded job, as every rank runs it: (app, size) names the
    corpus, and (backend, mappers, reducers, combiner) the plan at W =
    the world's size.  ``traced`` runs the traced sharded mode;
    ``outputs`` asks rank 0 for ``(out_keys, out_vals, dropped)``."""

    app: str
    size: int
    backend: str
    mappers: int
    reducers: int
    combiner: bool = False
    traced: bool = False
    warmup: int = 1
    outputs: bool = False


@dataclasses.dataclass
class RankReply:
    """``wall_s``: the largest rank's wall of the timed run.  ``trace``:
    rank 0's ``JobTrace`` (traced requests).  ``launches``: the
    ``segment_reduce`` / ``local_reduce`` launches all ranks made for the
    request, warmups included.  ``outputs``: rank 0's numpy ``(out_keys,
    out_vals, dropped)`` when asked."""

    wall_s: float
    trace: object | None
    launches: dict
    outputs: tuple | None


class RankWorld:
    """W rank processes on ``device`` (``cuda``: NCCL, rank r on card r;
    ``cpu``: gloo), each serving :class:`RankRequest` s until closed.

    Timing: ``RankReply.wall_s`` is the largest rank's wall of one run,
    each rank's starting after a barrier; the pipe's round trip to the
    controller is outside it (the reference times the controller's call
    of its mesh program instead).
    """

    def __init__(self, world_size: int, device="cuda", *,
                 timeout: float = DEFAULT_TIMEOUT_S):
        W = int(world_size)
        dev = torch.device(device)
        # One rank a card (NCCL puts no two ranks on one card), one a core on gloo.
        ceiling = torch.cuda.device_count() if dev.type == "cuda" else os.cpu_count() or 1
        if not 1 <= W <= ceiling:
            kind = "CUDA" if dev.type == "cuda" else "CPU"
            raise ValueError(
                f"a world of {W} ranks needs {W} devices but only {ceiling} "
                f"{kind} devices are visible")
        self.world_size, self.device_type, self.timeout = W, dev.type, float(timeout)
        self._dir = tempfile.mkdtemp(prefix="repro_ranks_")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._conns, self._dir)
        init = f"file://{self._dir}/pg"
        for rank in range(W):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, name=f"repro-rank-{rank}", daemon=True,
                args=(rank, W, dev.type, init, child, os.getpid(), self.timeout))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._collect("start")  # every rank joined the process group

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    def run(self, request: RankRequest) -> RankReply:
        """Run ``request`` on every rank; rank 0's reply, with the
        launches summed over ranks."""
        if self.closed:
            raise RuntimeError("the rank world is closed")
        for rank, conn in enumerate(self._conns):
            try:
                conn.send(request)
            except OSError:  # the rank is gone
                self._died(rank, f"{request}")
        replies = self._collect(f"{request}")
        launches = {k: sum(r["launches"][k] for r in replies)
                    for k in replies[0]["launches"]}
        head = replies[0]
        trace = None
        if head["trace"] is not None:
            from repro_torch.telemetry import JobTrace

            trace = JobTrace.from_json(head["trace"])
        return RankReply(head["wall_s"], trace, launches, head["outputs"])

    def _collect(self, what: str) -> list:
        """Every rank's answer, in rank order; ends the world and raises
        on a rank's error, death or silence past the timeout."""
        replies = [None] * self.world_size
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            sentinels = {self._procs[r].sentinel: r for r in pending}
            ready = mpc.wait(list(pending.values()) + list(sentinels), max(0.0, left))
            if not ready:
                self._abort()
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {self.world_size} did not answer "
                    f"within {self.timeout:.0f} s ({what})")
            for obj in ready:
                if obj in sentinels:
                    r = sentinels[obj]
                    if r not in pending or pending[r].poll():
                        continue  # read below: an answer, or the end of the pipe
                    self._died(r, what)
                r = next(r for r, c in pending.items() if c is obj)
                try:
                    status, payload = obj.recv()
                except (EOFError, OSError):  # the rank's end of the pipe is gone
                    self._died(r, what)
                if status != "ok":
                    self._abort()
                    raise RuntimeError(
                        f"rank {r} of {self.world_size} failed ({what}):\n{payload}")
                replies[r] = payload
                del pending[r]
        return replies

    def _died(self, rank: int, what: str):
        self._procs[rank].join(5.0)
        code = self._procs[rank].exitcode
        self._abort()
        raise RuntimeError(
            f"rank {rank} of {self.world_size} exited with code {code} ({what})")

    def _abort(self) -> None:
        """End the world at once: its other ranks may be waiting in a
        collective for the one that failed."""
        for proc in self._procs:
            proc.kill()
        self.close()

    def close(self) -> None:
        """End every rank process (idempotent)."""
        self._finalizer()

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _shutdown(procs, conns, tmpdir) -> None:
    for conn in conns:
        try:
            conn.send(None)
        except (BrokenPipeError, OSError):
            pass
    deadline = time.monotonic() + 10.0
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)
    for conn in conns:
        conn.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------- the ranks


def _exit_with_parent(parent_pid: int) -> None:
    """A rank blocked in a collective cannot read its pipe, so a thread
    ends the process once the controller is gone."""

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank, world_size, device_type, init, conn, parent_pid, timeout) -> None:
    _exit_with_parent(parent_pid)
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            dev, backend = torch.device("cuda", rank), "nccl"
        else:
            # One thread a rank: gloo ranks stand in for cards on a host
            # whose cores other work (test workers, the controller) shares.
            torch.set_num_threads(1)
            dev, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ok", None))
    server = _RankServer(rank, world_size, dev)
    try:
        while True:
            try:
                request = conn.recv()
            except EOFError:
                break
            if request is None:
                break
            try:
                conn.send(("ok", server.run(request)))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class _RankServer:
    """One rank's corpora and sharded jobs, cached by request."""

    def __init__(self, rank: int, world_size: int, device: torch.device):
        self.rank, self.world_size, self.device = rank, world_size, device
        self._corpora: dict = {}
        self._jobs: dict = {}

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _corpus(self, app: str, size: int):
        key = (app, size)
        if key not in self._corpora:
            from repro_torch.runner import make_app

            mr_app, tokens = make_app(app, size)
            self._corpora[key] = (mr_app, torch.as_tensor(tokens, device=self.device))
        return self._corpora[key]

    def _job(self, req: RankRequest):
        key = dataclasses.replace(req, warmup=0, outputs=False)
        if key not in self._jobs:
            from repro_torch.mapreduce import ExecutionPlan, JobConfig
            from repro_torch.telemetry import PhaseRecorder

            mr_app, corpus = self._corpus(req.app, int(req.size))
            plan = ExecutionPlan(
                mr_app,
                JobConfig(num_mappers=int(req.mappers), num_reducers=int(req.reducers),
                          num_workers=self.world_size, combiner=bool(req.combiner),
                          reduce_backend=req.backend, shuffle_backend="all_to_all"),
                len(corpus), device=self.device,
            )
            recorder = PhaseRecorder(max_traces=1) if req.traced else None
            job = plan.sharded(recorder=recorder)
            for _ in range(int(req.warmup)):
                job(corpus)
                self._fence()
            self._jobs[key] = (job, corpus, recorder)
        return self._jobs[key]

    def run(self, req: RankRequest) -> dict:
        import torch.distributed as dist

        from repro_torch.kernels.local_reduce import local_reduce
        from repro_torch.kernels.segment_reduce import segment_reduce

        counters = {"segment_reduce": segment_reduce, "local_reduce": local_reduce}
        before = {k: fn.launches for k, fn in counters.items()}
        job, corpus, recorder = self._job(req)
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()
        t0 = time.perf_counter()
        ok, ov, dropped = job(corpus)
        self._fence()
        wall = torch.tensor(time.perf_counter() - t0, dtype=torch.float64,
                            device=self.device)
        dist.all_reduce(wall, op=dist.ReduceOp.MAX)
        reply = {"launches": {k: fn.launches - before[k] for k, fn in counters.items()}}
        if self.rank == 0:
            reply["wall_s"] = float(wall.item())
            reply["trace"] = recorder.last.to_json() if recorder is not None else None
            reply["outputs"] = (
                (ok.cpu().numpy(), ov.cpu().numpy(), int(dropped)) if req.outputs else None)
        return reply


__all__ = ["DEFAULT_TIMEOUT_S", "RankReply", "RankRequest", "RankWorld"]
