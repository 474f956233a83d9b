"""Runtime oracles: the "true" job execution time the scheduler observes
(counterpart of ``repro.cluster.oracle``).

The paper's loop is profile → model → predict against a *real* cluster.  In
the port the real thing is the MapReduce engine on the card, but an
event-driven scheduling study needs thousands of job executions per trace,
so two interchangeable time sources implement one interface
(``time(app, backend, size, mappers, reducers, workers, job_id)``):

* :class:`AnalyticOracle` — a Hadoop-shaped closed-form cost with wave
  quantization, per-task startup, shuffle imbalance, and backend
  throughput/launch-overhead tradeoffs, plus deterministic-per-job
  multiplicative noise.  Interior optima in both M and R (more tasks
  amortize the spill sort but pay more startup — the paper's observed
  non-monotonicity) make configuration choice genuinely matter.
* :class:`EngineOracle` — wall-clocks the port's
  :class:`repro_torch.mapreduce.ExecutionPlan` on the live engine (plans
  cached, one warmup), fenced by ``torch.cuda.synchronize`` on the card,
  for traces where the simulated cluster IS the real engine; with
  ``sharded=True`` each grant W runs the sharded mode on a world of W rank
  processes (:mod:`repro_torch.mapreduce.ranks`).

Backends carry the port's names (``torch``, ``scatter_reduce``, ``cuda``
for the reference's ``jnp``, ``xla``, ``pallas``); the analytic oracle keeps
the reference's numbers and noise streams under them, so a seeded run here
equals the reference's once the names are mapped.

Policies never see oracle internals: they only get profiled samples and
completed-job observations, exactly the paper's black-box treatment.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

#: stable small ints for seeding noise streams (strings don't hash stably).
_APP_IDS = {"wordcount": 1, "eximparse": 2}
#: the reference's ids for its backends of the same role (jnp 1, pallas 2,
#: xla 3), so that a seeded analytic run draws the reference's noise.
_BACKEND_IDS = {"torch": 1, "cuda": 2, "scatter_reduce": 3}

#: job_ids at/above this mark bootstrap-profiling runs, not trace jobs —
#: policies allocate ``PROFILE_JOB_ID + seq`` for their profiling calls,
#: and injected platform shifts (``AnalyticOracle(shift_after_job=...)``)
#: never apply to them: profiling always happened *before* the shift.
PROFILE_JOB_ID = 1_000_000

#: map-output pairs emitted per input token (wordcount: one pair per word;
#: eximparse: one pair per 3-token record) — sizes the shuffle traffic.
_PAIRS_PER_TOKEN = {"wordcount": 1.0, "eximparse": 1.0 / 3.0}

#: key-space size per application — must match the corpora the
#: :class:`EngineOracle` builds (wordcount vocab 4096, eximparse 1024
#: transactions), because the analytic combined-bytes term is a
#: distinct-keys expectation over exactly this space.
_KEY_SPACE = {"wordcount": 4096, "eximparse": 1024}


def expected_combined_pairs(app: str, size: int, mappers: int) -> float:
    """Closed-form post-combine shuffle pairs for one job.

    A map task emits ``s = pairs_per_token * size / M`` pairs drawn from a
    key space of ``V`` keys; after map-side combining it ships one pair
    per *distinct* key, whose expectation under uniform draws is the
    coupon-collector occupancy ``V * (1 - (1 - 1/V)^s)``.  Clamped by the
    emitted count (a combiner never expands the stream), summed over the
    M tasks.  Real corpora are Zipf-skewed, not uniform, so this is an
    upper bound on the true combined traffic — the model error the
    heldout bench measures.
    """
    V = float(_KEY_SPACE[app])
    s = _PAIRS_PER_TOKEN[app] * float(size) / max(1, int(mappers))
    distinct = V * (1.0 - (1.0 - 1.0 / V) ** s)
    return int(mappers) * min(s, distinct)


def _analytic_trace(app, backend, size, M, R, W, phase_s, noise_factor,
                    depth: int = 1, overlap_s: float = 0.0,
                    cpu_s: dict | None = None,
                    combined_pairs: float | None = None):
    """Build a JobTrace-shaped record from closed-form phase components.

    The analytic oracle has no real arrays to count, so the counters are
    the closed-form expectations (shuffle bytes = pairs x PAIR_BYTES, no
    overflow); the *shape* matches the engine's traces exactly, which is
    what lets the online per-phase refit path treat both oracles alike.
    ``cpu_s`` carries the closed-form CPU task-seconds per phase (scaled
    by the same noise factor as the walls, with ``cpu_workers = W`` as
    the parallelism ceiling — the simulated cluster grants W workers).

    With ``depth > 1`` the trace gains a fourth ``"pipeline"`` phase
    whose wall is the (negative) overlap saving ``-overlap_s`` — the
    serial phase components stay intact and the four walls still sum
    exactly to the overlapped total, so the timing conservation law
    closes on pipelined analytic traces too.

    ``combined_pairs`` (combiner jobs) inserts a ``combine`` phase between
    map and shuffle and contracts the shuffle/fabric counters to the
    combined stream — the same counter flow the engine's traced modes
    record, so conservation laws close identically on both oracles.
    """
    from repro_torch.telemetry.trace import PAIR_BYTES, JobTrace

    pairs = _PAIRS_PER_TOKEN[app] * float(size)
    shuffle_pairs = pairs if combined_pairs is None else float(combined_pairs)
    nbytes = shuffle_pairs * PAIR_BYTES
    cpu_s = cpu_s or {}

    def cpu(phase):
        if phase not in cpu_s:
            return {}
        return {
            "cpu_s": cpu_s[phase] * noise_factor,
            "cpu_workers": float(W),
        }

    trace = JobTrace(
        app=app,
        config={
            "num_mappers": M, "num_reducers": R, "num_workers": W,
            "reduce_backend": backend, "input_len": int(size),
            "overlap_depth": int(depth),
        },
    )
    trace.record_phase(
        "map", phase_s["map"] * noise_factor,
        tasks=M, waves=math.ceil(M / W), records_in=size,
        pairs_emitted=pairs, **cpu("map"),
    )
    if combined_pairs is not None:
        trace.record_phase(
            "combine", phase_s["combine"] * noise_factor,
            tasks=M, pairs_in=pairs, pairs_out=shuffle_pairs,
            bytes_in=pairs * PAIR_BYTES, bytes_out=nbytes,
            net_bytes=0.0, **cpu("combine"),
        )
    trace.record_phase(
        "shuffle", phase_s["shuffle"] * noise_factor,
        pairs_in=shuffle_pairs, pairs_out=shuffle_pairs, pairs_dropped=0,
        bytes_in=nbytes, bytes_out=nbytes, bytes_dropped=0,
        partitions=R,
        net_bytes=nbytes, net_s=phase_s["shuffle"] * noise_factor,
        **cpu("shuffle"),
    )
    trace.record_phase(
        "reduce", phase_s["reduce"] * noise_factor,
        tasks=R, waves=math.ceil(R / W), **cpu("reduce"),
    )
    if depth > 1:
        trace.record_phase(
            "pipeline", -overlap_s,
            overlap_depth=depth, overlap_s=overlap_s,
            net_bytes=0.0,
        )
    trace.finish(sum(p.wall_s for p in trace.phases))
    return trace


class SharedFabric:
    """Deterministic fair-share model of one shared shuffle fabric.

    Each admission prices one transfer — ``nbytes`` over a nominal
    window ``[start, start + nominal_s)`` at its own uncontended rate
    ``nbytes / nominal_s`` — by integrating it piecewise against the
    transfers already committed: wherever aggregate demand D exceeds
    ``capacity`` C, every byte drains at the fair share ``C / D`` of its
    nominal rate, so the newcomer's window stretches.  Earlier
    admissions are never retro-stretched: pricing is causal in dispatch
    order, single-pass, and deterministic.  Transfers whose uncontended
    windows don't overlap therefore never interact — contention can
    delay a job, but it cannot reorder jobs with disjoint lifetimes.

    Over-capacity admissions are logged as contention *episodes* (job,
    window, peak demand, stretch) for the cluster-wide report.
    """

    def __init__(self, capacity: float):
        cap = float(capacity)
        if not cap > 0:
            raise ValueError(f"net capacity must be > 0, got {capacity!r}")
        self.capacity = cap
        #: committed transfers as (t0, t1, bytes_per_s) — byte-conserving
        #: average rates over each transfer's *actual* window.
        self._transfers: list[tuple[float, float, float]] = []
        self.episodes: list[dict] = []
        self.contention_s_total = 0.0
        self.n_contended = 0

    def demand_at(self, t: float) -> float:
        """Aggregate committed fabric demand (bytes/s) at time ``t``."""
        return sum(r for (t0, t1, r) in self._transfers if t0 <= t < t1)

    def admit(self, job_id: int, start: float, nominal_s: float,
              nbytes: float) -> float:
        """Price one transfer; return its stretch (contention seconds)."""
        if nbytes <= 0 or nominal_s <= 0:
            return 0.0
        rate = float(nbytes) / float(nominal_s)
        # Piecewise-constant integration: within each segment between
        # committed-transfer breakpoints the fair share is constant.
        edges = sorted(
            {p for (t0, t1, _) in self._transfers for p in (t0, t1)
             if p > start}
        )
        remaining = float(nbytes)
        t = float(start)
        peak = rate
        for edge in edges + [math.inf]:
            demand = self.demand_at(t) + rate
            peak = max(peak, demand)
            thru = rate * min(1.0, self.capacity / demand)
            if edge == math.inf or remaining <= thru * (edge - t):
                t += remaining / thru
                break
            remaining -= thru * (edge - t)
            t = edge
        end = t
        stretch = (end - start) - float(nominal_s)
        if stretch < 1e-9:  # integration round-off is not contention
            stretch = 0.0
            end = start + float(nominal_s)
        self._transfers.append(
            (float(start), end, float(nbytes) / (end - start))
        )
        if stretch > 0.0:
            self.n_contended += 1
            self.contention_s_total += stretch
            self.episodes.append({
                "job_id": int(job_id),
                "t0": float(start),
                "t1": float(end),
                "peak_bytes_per_s": float(peak),
                "capacity": self.capacity,
                "contention_s": float(stretch),
            })
        return stretch

    def prune(self, now: float) -> None:
        """Drop transfers that ended at/before ``now`` (they can no
        longer overlap any future admission)."""
        self._transfers = [x for x in self._transfers if x[1] > now]


class AnalyticOracle:
    """Closed-form Hadoop-shaped job time; deterministic per (job, config).

    Terms (seconds; ``n`` = input tokens, ``S = n/M`` split size):

    * map:     ``ceil(M/W) * (setup_b + c_map_app*S + c_sort*S*log2(S))``
    * shuffle: ``c_shuf * n * (1 + 0.5/sqrt(R) + c_part*R)``
    * reduce:  ``ceil(R/W) * (setup_b + c_red * thr_b * n/R)``

    Backend ``b`` trades fixed launch overhead against throughput (cuda:
    high setup, best throughput — wins big jobs; torch: the reverse), so the
    optimal (backend, M, R) shifts with job size, which is what gives a
    prediction-driven policy something to exploit.
    """

    platform = "sim-analytic-v1"
    #: analytic traces always carry per-phase walls + net counters, so a
    #: cluster with a finite ``net_capacity`` can price shared-fabric
    #: contention against this oracle's jobs.
    prices_contention = True

    #: per-token map cost by application (eximparse parses records: pricier).
    MAP_COST = {"wordcount": 8.0e-6, "eximparse": 1.2e-5}
    #: backend -> (per-wave launch overhead s, reduce throughput multiplier)
    BACKENDS = {"torch": (0.05, 1.0), "scatter_reduce": (0.065, 0.72),
                "cuda": (0.13, 0.5)}
    C_SORT = 4.0e-7     # map-side spill sort, per token per log2(split)
    C_SHUF = 2.0e-6     # shuffle bytes moved, per token
    C_PART = 0.004      # per-reducer partition/merge overhead
    C_RED = 6.0e-6      # reduce aggregation, per token
    C_PIPE = 0.012      # per-extra-depth pipeline fill/drain overhead
    C_COMB = 6.0e-7     # map-side combine, per emitted pair
    COMB_SETUP = 0.01   # combine barrier launch overhead, per job

    def __init__(
        self,
        *,
        noise: float = 0.02,
        seed: int = 0,
        shift_after_job: int | None = None,
        shift_factor: float = 1.0,
    ):
        self.noise = float(noise)
        self.seed = int(seed)
        #: injected mid-trace platform shift: every trace job with
        #: ``shift_after_job <= job_id < PROFILE_JOB_ID`` runs
        #: ``shift_factor`` x slower (same platform string — the point is
        #: that the *models* don't know).  Profiling job_ids are exempt:
        #: the bootstrap ran before the platform drifted.  This is the
        #: drift-alarm bench's ground truth (see ``repro_torch.obs.drift``).
        self.shift_after_job = (
            None if shift_after_job is None else int(shift_after_job)
        )
        self.shift_factor = float(shift_factor)
        if self.shift_factor <= 0:
            raise ValueError("shift_factor must be > 0")
        self._last_call: tuple | None = None

    def _shift(self, job_id: int) -> float:
        if self.shift_after_job is None:
            return 1.0
        jid = int(job_id)
        if jid < self.shift_after_job or jid >= PROFILE_JOB_ID:
            return 1.0
        return self.shift_factor

    def backends(self) -> tuple[str, ...]:
        return tuple(self.BACKENDS)

    def _phase_components(
        self, app: str, backend: str, size: int,
        mappers: int, reducers: int, workers: int,
        combiner: bool = False,
    ) -> dict[str, float]:
        """Noise-free per-phase seconds — the closed-form decomposition.

        With ``combiner=True`` the dict gains a ``combine`` entry (the
        barrier pays ``C_COMB`` per emitted pair plus a fixed launch) and
        the shuffle term contracts by the expected combined-pairs ratio
        (:func:`expected_combined_pairs`) — pre-aggregation buys smaller
        fabric transfers at the price of extra map-side compute, so the
        knob has a genuine interior tradeoff for a policy to learn.
        """
        if app not in _APP_IDS:
            raise ValueError(f"unknown app {app!r}")
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        M, R, W = int(mappers), int(reducers), int(workers)
        if M < 1 or R < 1 or W < 1:
            raise ValueError(f"bad config M={M} R={R} W={W}")
        n = float(size)
        setup, thr = self.BACKENDS[backend]
        S = n / M
        map_waves = math.ceil(M / W)
        red_waves = math.ceil(R / W)
        t_map = map_waves * (
            setup
            + self.MAP_COST[app] * S
            + self.C_SORT * S * math.log2(max(S, 2.0))
        )
        t_shuffle = self.C_SHUF * n * (
            1.0 + 0.5 / math.sqrt(R) + self.C_PART * R
        )
        t_reduce = red_waves * (setup + self.C_RED * thr * n / R)
        out = {"map": t_map, "shuffle": t_shuffle, "reduce": t_reduce}
        if combiner:
            pairs = _PAIRS_PER_TOKEN[app] * n
            ratio = expected_combined_pairs(app, size, M) / max(pairs, 1.0)
            out["combine"] = self.COMB_SETUP + self.C_COMB * pairs
            out["shuffle"] = t_shuffle * min(1.0, ratio)
        return out

    def _cpu_components(
        self, phase_s: dict[str, float], size: int,
        mappers: int, reducers: int, workers: int,
    ) -> dict[str, float]:
        """Closed-form CPU task-seconds per phase (noise-free).

        Map and reduce burn one core per task: CPU = wall x tasks/waves
        (the busy-core count of the wave schedule, <= W by construction).
        The shuffle's ``c_shuf * n`` term is pure wire time; the
        imbalance and partition/merge terms are host CPU work, so
        shuffle CPU is the wall minus the wire term (single-threaded
        merge: always <= wall).  The combine barrier (if present) is
        pure local compute — no wire time — so its CPU equals its wall.
        """
        M, R, W = int(mappers), int(reducers), int(workers)
        wire = self.C_SHUF * float(size)
        out = {
            "map": phase_s["map"] * M / math.ceil(M / W),
            "shuffle": max(0.0, phase_s["shuffle"] - wire),
            "reduce": phase_s["reduce"] * R / math.ceil(R / W),
        }
        if "combine" in phase_s:
            out["combine"] = phase_s["combine"]
        return out

    def _overlapped_total(self, phase_s: dict[str, float], depth: int
                          ) -> float:
        """Closed-form total at overlap depth D.

        D=1 is the serial sum.  For D>1 the steady state runs map
        against shuffle+reduce concurrently: the longer side is fully
        exposed, the shorter side's exposure shrinks as 1/D (deeper
        pipelines hide more of it behind the critical path), and each
        extra stage pays a fill/drain cost ``C_PIPE`` — so the optimum
        depth is interior and config-dependent, exactly like M and R.
        """
        total = sum(phase_s.values())
        if depth <= 1:
            return total
        # The combine barrier (if present) rides the compute half of the
        # pipeline: it overlaps with the fabric side like the map does.
        t_map = phase_s["map"] + phase_s.get("combine", 0.0)
        t_sr = phase_s["shuffle"] + phase_s["reduce"]
        return (
            max(t_map, t_sr)
            + min(t_map, t_sr) / depth
            + self.C_PIPE * (depth - 1)
        )

    def _noise_factor(
        self, app, backend, M, R, W, job_id
    ) -> float:
        if self.noise <= 0.0:
            return 1.0
        ss = np.random.SeedSequence(
            [self.seed, int(job_id), int(M), int(R), int(W),
             _APP_IDS[app], _BACKEND_IDS[backend]]
        )
        rng = np.random.default_rng(ss)
        return float(np.exp(rng.normal(0.0, self.noise)))

    def time(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        job_id: int = 0,
        depth: int = 1,
        combiner: bool = False,
        _noiseless: bool = False,
    ) -> float:
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        phase_s = self._phase_components(
            app, backend, size, mappers, reducers, workers,
            combiner=bool(combiner),
        )
        t = self._overlapped_total(phase_s, int(depth))
        self._last_call = (
            app, backend, int(size), int(mappers), int(reducers),
            int(workers), int(job_id), int(depth), bool(combiner),
            bool(_noiseless),
        )
        if not _noiseless:
            t *= self._noise_factor(
                app, backend, mappers, reducers, workers, job_id
            )
        return t * self._shift(job_id)

    def take_trace(self):
        """Per-phase trace of the most recent :meth:`time` call (or None).

        Computed lazily from the stored call signature so the hot path
        (thousands of bootstrap-profiling calls per trace) pays one tuple
        assignment, not a trace construction.
        """
        if self._last_call is None:
            return None
        app, backend, size, M, R, W, job_id, depth, combiner, noiseless = \
            self._last_call
        phase_s = self._phase_components(
            app, backend, size, M, R, W, combiner=combiner
        )
        factor = (1.0 if noiseless else self._noise_factor(
            app, backend, M, R, W, job_id
        )) * self._shift(job_id)
        overlap = (
            sum(phase_s.values()) - self._overlapped_total(phase_s, depth)
        ) * factor
        return _analytic_trace(
            app, backend, size, M, R, W, phase_s, factor,
            depth=depth, overlap_s=overlap,
            cpu_s=self._cpu_components(phase_s, size, M, R, W),
            combined_pairs=(
                expected_combined_pairs(app, size, M) if combiner else None
            ),
        )

    # ---- partial execution (elastic layer) ------------------------------

    def remaining_segments(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        *,
        map_tasks_done: int = 0,
        shuffled: bool = False,
        reduce_tasks_done: int = 0,
        job_id: int = 0,
        combiner: bool = False,
        combined: bool = False,
        _noiseless: bool = False,
    ) -> list[tuple[str, float]]:
        """Per-wave-boundary segment costs of the *remaining* work.

        Returns ``[(kind, seconds), ...]`` with kind in
        ``{"map", "combine", "shuffle", "reduce"}`` — one entry per
        remaining map wave, one for the combine barrier (combiner jobs
        that have not passed it), one for the shuffle barrier (if not yet
        passed), one per remaining reduce wave, all under grant
        ``workers``.  The closed
        form is the exact per-wave decomposition of :meth:`time`: each map
        wave costs ``setup + c_map*S + c_sort*S*log2(S)``, the shuffle its
        full closed-form term, each reduce wave ``setup + c_red*thr*n/R``,
        scaled by the same per-(job, config) noise factor — so with zero
        progress the segment walls sum to :meth:`time` (modulo float
        associativity).  This is what prices partial execution for the
        elastic scheduler: regrants requantize the remaining tasks into
        waves of the *new* grant.
        """
        phase_s = self._phase_components(
            app, backend, size, mappers, reducers, workers,
            combiner=bool(combiner),
        )
        M, R, W = int(mappers), int(reducers), int(workers)
        factor = (1.0 if _noiseless else self._noise_factor(
            app, backend, M, R, W, job_id
        )) * self._shift(job_id)
        segs: list[tuple[str, float]] = []
        map_waves_left = math.ceil(max(0, M - int(map_tasks_done)) / W)
        per_map_wave = phase_s["map"] / math.ceil(M / W)
        segs += [("map", per_map_wave * factor)] * map_waves_left
        if combiner and not combined and not shuffled:
            segs.append(("combine", phase_s["combine"] * factor))
        if not shuffled:
            segs.append(("shuffle", phase_s["shuffle"] * factor))
        red_waves_left = math.ceil(max(0, R - int(reduce_tasks_done)) / W)
        per_red_wave = phase_s["reduce"] / math.ceil(R / W)
        segs += [("reduce", per_red_wave * factor)] * red_waves_left
        return segs

    def remaining_time(self, *args, **kwargs) -> float:
        """Total remaining seconds (sum of :meth:`remaining_segments`)."""
        return sum(t for _, t in self.remaining_segments(*args, **kwargs))

    def phase_profile(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        combiner: bool = False,
    ) -> dict:
        """Noise-free per-phase times, CPU seconds, and shuffle/fabric
        bytes for one config — the profiling source for decomposed
        (per-phase, per-resource) models.  With ``combiner=True`` the
        byte counters are the expected *combined* stream."""
        phase_s = self._phase_components(
            app, backend, size, mappers, reducers, workers,
            combiner=bool(combiner),
        )
        from repro_torch.telemetry.trace import PAIR_BYTES

        pairs = _PAIRS_PER_TOKEN[app] * float(size)
        if combiner:
            pairs = min(pairs, expected_combined_pairs(app, size, mappers))
        nbytes = pairs * PAIR_BYTES
        return {
            "time_s": dict(phase_s),
            "shuffle_bytes": nbytes,
            "cpu_s": self._cpu_components(
                phase_s, size, mappers, reducers, workers
            ),
            "net_bytes": nbytes,
        }

    def nominal_time(self, app: str, size: int) -> float:
        """Noise-free time at a nominal mid-range config — the service-time
        estimate :func:`repro_torch.cluster.workload.assign_deadlines` needs."""
        return self.time(app, "torch", size, 16, 16, 4, _noiseless=True)


class EngineOracle:
    """Wall-clock the port's MapReduce engine (plans cached, one warmup).

    Every distinct (app, size, backend, M, R, W) builds one plan and pays
    one warmup run, so bootstrap profiling costs two runs a configuration.
    Sizes are snapped down to multiples of ``size_quantum`` (at least one
    quantum) to bound the number of corpora and plans.  Corpora are built
    per (app, size) on ``device``: WordCount over a 4096-word vocabulary,
    Exim over 1024 transactions (the key spaces :class:`AnalyticOracle`'s
    combined-pairs term assumes).

    Every execution path is a mode of one
    :class:`repro_torch.mapreduce.ExecutionPlan` per (app, size, backend,
    M, R): ``time`` wall-clocks the fused mode (the pipelined one at depth
    D > 1, the traced one with ``traced=True``), ``remaining_segments``
    wall-clocks the resumable mode's wave steppers, and ``phase_profile``
    the traced mode — so the scheduled path and the priced path can never
    drift.  Each wall ends in ``torch.cuda.synchronize`` on the card.

    ``sharded=True`` (platform ``engine-sharded``) schedules the sharded
    mode: each grant W runs on a :class:`repro_torch.mapreduce.ranks.RankWorld`
    of W rank processes on ``device`` (NCCL, rank r on card r; gloo on the
    CPU), started the first time W is asked for and kept until
    :meth:`close`.  A grant above the visible devices raises
    ``ValueError``; a rank that fails raises here.  ``time`` returns the
    largest rank's wall (the pipe's round trip to the ranks is outside
    it), and with ``traced=True`` rank 0's per-phase trace lands in
    ``recorder``.  ``remaining_segments`` and ``regrant_overhead`` step
    the one-worker resumable job in this process in both modes, as the
    reference's do.
    """

    def __init__(
        self, *, warmup: int = 1, size_quantum: int = 1024,
        traced: bool = False, sharded: bool = False,
        pipelined: bool = False, device="cuda",
    ):
        from repro_torch.device import resolve_device

        self.device = resolve_device(device)
        self.warmup = warmup
        self.size_quantum = size_quantum
        self.sharded = bool(sharded)
        #: with pipelined=True, ``time(..., depth=D)`` with D > 1
        #: wall-clocks the plan's pipelined mode — the knob a depth-aware
        #: predictive policy profiles and chooses per job.  Off by
        #: default so depth requests can't silently hit the fused path.
        self.pipelined = bool(pipelined)
        if self.pipelined and self.sharded:
            raise ValueError(
                "pipelined=True is a single-controller mode; it does not "
                "compose with sharded=True"
            )
        self.platform = "engine-sharded" if sharded else "engine-wallclock"
        #: with traced=True, jobs run through the phase-split telemetry
        #: path: every execution appends a JobTrace to ``recorder`` and
        #: ``take_trace`` exposes the latest to the cluster, so completed
        #: jobs carry per-phase observations (the online per-phase refit
        #: loop).  Timing then includes per-phase fencing overhead —
        #: consistent across configs, so models stay comparable.
        self.traced = bool(traced)
        #: contention pricing needs per-phase walls + net counters on
        #: every completed job — only the traced path records them.  An
        #: untraced engine oracle cannot price a shared fabric, and the
        #: cluster refuses ``net_capacity`` against it rather than
        #: silently skipping the charge.
        self.prices_contention = self.traced
        self.recorder = None
        if traced:
            from repro_torch.telemetry import PhaseRecorder

            # Consumers only read recent traces (``take_trace``); bound
            # retention so bootstrap profiling (thousands of runs) doesn't
            # grow the recorder without limit over a long simulation.
            self.recorder = PhaseRecorder(max_traces=64)
        self._corpora: dict = {}
        self._jobs: dict = {}
        self._traced_jobs: dict = {}
        self._warmed: set = set()   # (resumable id, grant) stepper warmups
        self._overheads: dict = {}  # measured (save_s, restore_s) cache
        self._worlds: dict = {}     # grant -> RankWorld (sharded mode)
        #: kernel launches the rank processes made (sharded mode)
        self.rank_launches = {"segment_reduce": 0, "local_reduce": 0}

    def close(self) -> None:
        """End the rank processes of the sharded mode (idempotent)."""
        for world in self._worlds.values():
            world.close()
        self._worlds.clear()

    def __enter__(self) -> "EngineOracle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _run_sharded(self, app, backend, size, mappers, reducers, workers,
                     traced: bool, combiner: bool = False):
        """One job on the world of ``workers`` ranks -> its RankReply."""
        from repro_torch.mapreduce.ranks import RankRequest, RankWorld

        W = int(workers)
        if W not in self._worlds:
            self._worlds[W] = RankWorld(W, self.device)
        reply = self._worlds[W].run(RankRequest(
            app, int(size), backend, int(mappers), int(reducers),
            combiner=bool(combiner), traced=bool(traced), warmup=int(self.warmup),
        ))
        for name, n in reply.launches.items():
            self.rank_launches[name] += n
        return reply

    def backends(self) -> tuple[str, ...]:
        """The counterparts of the reference's default arms (jnp, xla);
        the ``cuda`` backend enters through a policy's ``backends=``."""
        return ("torch", "scatter_reduce")

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _snap(self, size: int) -> int:
        q = self.size_quantum
        return max(q, (int(size) // q) * q)

    def _corpus(self, app: str, size: int):
        key = (app, size)
        if key not in self._corpora:
            from repro_torch.runner import make_app

            mr_app, tokens = make_app(app, size)
            self._corpora[key] = (
                mr_app, torch.as_tensor(tokens, device=self.device)
            )
        return self._corpora[key]

    def _build_mode(self, app, backend, size, mappers, reducers, workers,
                    recorder, depth: int = 1, combiner: bool = False):
        """One ExecutionPlan, lowered in this oracle's scheduling mode."""
        from repro_torch.mapreduce import ExecutionPlan, JobConfig

        mr_app, corpus = self._corpus(app, size)
        plan = ExecutionPlan(
            mr_app,
            JobConfig(
                num_mappers=int(mappers),
                num_reducers=int(reducers),
                num_workers=int(workers),
                combiner=bool(combiner),
                reduce_backend=backend,
                overlap_depth=int(depth),
            ),
            len(corpus),
            device=self.device,
        )
        if recorder is not None:
            job = plan.traced(recorder)  # depth from the config
        elif int(depth) > 1:
            job = plan.pipelined()
        else:
            job = plan.fused()
        return job, corpus

    def _get_job(self, app, backend, size, mappers, reducers, workers,
                 depth: int = 1, combiner: bool = False):
        # The combiner flag is part of the cache identity: a combined and
        # an uncombined job at the same (M, R, W, depth) are different
        # pipelines.
        key = (app, size, backend, int(mappers), int(reducers),
               int(workers), int(depth), bool(combiner))
        if key not in self._jobs:
            job, corpus = self._build_mode(
                app, backend, size, mappers, reducers, workers,
                self.recorder, depth, combiner=bool(combiner),
            )
            for _ in range(self.warmup):
                job(corpus)
                self._fence()
            self._jobs[key] = (job, corpus)
        return self._jobs[key]

    def time(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        job_id: int = 0,
        depth: int = 1,
        combiner: bool = False,
    ) -> float:
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if int(depth) > 1 and not self.pipelined:
            raise ValueError(
                "depth > 1 requires EngineOracle(pipelined=True)"
            )
        if self.sharded:
            reply = self._run_sharded(app, backend, self._snap(size), mappers,
                                      reducers, workers, self.traced, combiner)
            if reply.trace is not None:
                self.recorder.add(reply.trace)
            return reply.wall_s
        job, corpus = self._get_job(
            app, backend, self._snap(size), mappers, reducers, workers,
            int(depth), combiner=bool(combiner),
        )
        t0 = time.perf_counter()
        job(corpus)
        self._fence()
        return time.perf_counter() - t0

    def take_trace(self):
        """JobTrace of the most recent execution (traced mode), else None."""
        if self.recorder is None or not len(self.recorder):
            return None
        return self.recorder.last

    def phase_profile(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        combiner: bool = False,
    ) -> dict:
        """Measured per-phase times + shuffle bytes for one config.

        Runs the real engine through the telemetry path (one plan and one
        warmup per distinct config — same cost caveat as :meth:`time`).
        Available regardless of ``traced``: an untraced oracle keeps a
        separate traced-job cache so :meth:`time` stays on the fused path.
        """
        if self.recorder is not None:
            self.time(app, backend, size, mappers, reducers, workers,
                      combiner=bool(combiner))
            return self._profile_from(self.recorder.last)

        size = self._snap(size)
        if self.sharded:
            return self._profile_from(self._run_sharded(
                app, backend, size, mappers, reducers, workers, True,
                combiner).trace)

        from repro_torch.telemetry import PhaseRecorder

        key = (app, size, backend, int(mappers), int(reducers),
               int(workers), bool(combiner))
        if key not in self._traced_jobs:
            rec = PhaseRecorder(max_traces=4)
            job, corpus = self._build_mode(
                app, backend, size, mappers, reducers, workers, rec,
                combiner=bool(combiner),
            )
            for _ in range(self.warmup):
                job(corpus)
            self._traced_jobs[key] = (job, corpus, rec)
        job, corpus, rec = self._traced_jobs[key]
        job(corpus)  # the traced mode fences every phase itself
        return self._profile_from(rec.last)

    @staticmethod
    def _profile_from(trace) -> dict:
        times = trace.phase_times()
        return {
            "time_s": times,
            "shuffle_bytes": trace.counter("shuffle", "bytes_out"),
            "cpu_s": {
                ph: trace.counter(ph, "cpu_s", 0.0) for ph in times
            },
            "net_bytes": trace.counter(
                "shuffle", "net_bytes",
                trace.counter("shuffle", "bytes_in", 0.0),
            ),
        }

    def nominal_time(self, app: str, size: int) -> float:
        return self.time(app, "torch", size, 8, 8, 4)

    # ---- partial execution (elastic layer) ------------------------------

    def _get_resumable(self, app, backend, size, mappers, reducers,
                       combiner: bool = False):
        from repro_torch.elastic.resumable import ResumableJob
        from repro_torch.mapreduce import JobConfig

        key = ("resumable", app, size, backend, int(mappers),
               int(reducers), bool(combiner))
        if key not in self._jobs:
            mr_app, corpus = self._corpus(app, size)
            job = ResumableJob(
                mr_app,
                JobConfig(
                    num_mappers=int(mappers),
                    num_reducers=int(reducers),
                    num_workers=1,
                    combiner=bool(combiner),
                    reduce_backend=backend,
                ),
                len(corpus),
                device=self.device,
            )
            self._jobs[key] = (job, corpus)
        return self._jobs[key]

    def remaining_segments(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        workers: int,
        *,
        map_tasks_done: int = 0,
        shuffled: bool = False,
        reduce_tasks_done: int = 0,
        job_id: int = 0,
        combiner: bool = False,
        combined: bool = False,
    ) -> list[tuple[str, float]]:
        """Wave-step the *real* engine over the remaining work, wall-
        clocking each step — the engine-backed twin of
        :meth:`AnalyticOracle.remaining_segments`.

        A fresh resumable state is advanced (untimed) to the cursor, then
        each remaining wave-boundary step is executed and fenced.  A done
        count that is not a multiple of ``workers`` is snapped *down* to
        the last reachable boundary, so the partially-covered wave is
        priced as a full remaining wave — the same conservative wave
        quantization as :meth:`AnalyticOracle.remaining_segments`, and
        never an under-estimate.  The first call per (job, grant) runs
        the whole job once, untimed, to warm its steppers.
        """
        job, corpus = self._get_resumable(
            app, backend, self._snap(size), mappers, reducers,
            combiner=bool(combiner),
        )
        # Warm the steppers for this grant once, untimed.
        warm_key = (id(job), int(workers))
        if warm_key not in self._warmed:
            job.run(corpus, state=job.regrant(job.initial_state(),
                                              int(workers)))
            self._fence()
            self._warmed.add(warm_key)
        state = job.regrant(job.initial_state(), int(workers))
        # Advance untimed to the cursor, never past it: only take a step
        # whose (clamped) endpoint still lies within the done counts.
        W = int(workers)
        M, R = int(mappers), int(reducers)
        target_m = min(int(map_tasks_done), M)
        target_r = min(int(reduce_tasks_done), R)
        while not state.cursor.done:
            c = state.cursor
            if not c.map_done:
                if min(M, c.map_tasks_done + W) > target_m:
                    break
            elif combiner and not c.combined and not c.shuffled:
                if not (combined or shuffled):
                    break
            elif not c.shuffled:
                if not shuffled:
                    break
            elif min(R, c.reduce_tasks_done + W) > target_r:
                break
            state = job.step(state, corpus)
        self._fence()
        segs: list[tuple[str, float]] = []
        while not state.cursor.done:
            before = state.cursor
            t0 = time.perf_counter()
            state = job.step(state, corpus)
            self._fence()
            dt = time.perf_counter() - t0
            if before.map_tasks_done != state.cursor.map_tasks_done:
                segs.append(("map", dt))
            elif before.combined != state.cursor.combined:
                segs.append(("combine", dt))
            elif before.shuffled != state.cursor.shuffled:
                segs.append(("shuffle", dt))
            else:
                segs.append(("reduce", dt))
        return segs

    def remaining_time(self, *args, **kwargs) -> float:
        """Total remaining seconds (sum of :meth:`remaining_segments`)."""
        return sum(t for _, t in self.remaining_segments(*args, **kwargs))

    def regrant_overhead(
        self,
        app: str,
        backend: str,
        size: int,
        mappers: int,
        reducers: int,
        *,
        map_tasks_done: int = 0,
        shuffled: bool = False,
        reduce_tasks_done: int = 0,
        combiner: bool = False,
    ) -> tuple[float, float]:
        """Measured ``(save_s, restore_s)`` walls of a real wave-boundary
        snapshot round-trip at this cursor — what a preemption *actually*
        costs on this engine, fed to
        :meth:`repro_torch.elastic.regrant.RegrantCostModel.record_overhead`
        (and charged by the elastic simulator) in place of configured
        estimates.

        The snapshot layout changes at the shuffle barrier (map
        accumulators before, partitions after), so measurements are
        cached per (job, phase-of-life) bucket; within a bucket the cost
        is cursor-independent (canonical task-major buffers have static
        shapes).  The snapshot is written under the process's temporary
        directory and restored onto the oracle's device.
        """
        import tempfile

        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.elastic.snapshot import load_snapshot, save_snapshot

        job, corpus = self._get_resumable(
            app, backend, self._snap(size), mappers, reducers,
            combiner=bool(combiner),
        )
        # The snapshot layout flips only once the shuffle barrier has
        # *executed* (map accumulators swap for partitions + outputs); a
        # map-complete-but-unshuffled cursor still carries the pre-shuffle
        # buffers, so it prices in the pre-shuffle bucket.
        post_shuffle = bool(shuffled)
        key = (id(job), post_shuffle)
        if key not in self._overheads:
            state = job.initial_state()
            if post_shuffle:
                # Advance through the barrier so the snapshot carries the
                # post-shuffle (partitions + output) layout.
                while not state.cursor.shuffled:
                    state = job.step(state, corpus)
            self._fence()
            with tempfile.TemporaryDirectory() as d:
                mgr = CheckpointManager(d, keep=1)
                _, save_s = save_snapshot(mgr, state)
                del state
                _, _, restore_s = load_snapshot(mgr, device=self.device)
            self._overheads[key] = (float(save_s), float(restore_s))
        return self._overheads[key]
