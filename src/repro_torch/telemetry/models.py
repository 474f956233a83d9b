"""Decomposed per-(phase, resource) cost models, composed back to a total
(counterpart of ``repro.telemetry.models``, a copy over the port's
``core.regression`` and ``core.predictor.ModelDatabase``).

The paper fits one monolithic (config -> total time) polynomial.  Its
companion papers model the signals underneath — total CPU usage
(arXiv:1203.4054) and shuffle/network load (arXiv:1206.2016) — against the
same configuration knobs.  This module does both at once on top of the
telemetry layer: one :class:`~repro_torch.core.regression.RegressionModel` per
(phase, resource) target, all sharing the paper's feature basis, plus a
composed total-time prediction (sum over per-phase time models).

Because ordinary least squares is linear in the regression target, fitting
each phase's time on the same design matrix and summing the fits is
algebraically identical to fitting the summed total directly — so the
composed prediction can never be worse than the monolithic one on the same
basis (the ``phases`` benchmark section verifies this numerically), while
additionally exposing *where* the time goes and per-resource predictions
(e.g. shuffle bytes) that a resource-aware scheduler can act on (the
reference's ``predict-resource`` cluster policy; the port's cluster layer
is ROADMAP.md queue 1, item 9).

Storage: models live in the shared :class:`~repro_torch.core.predictor.
ModelDatabase` under resource-qualified keys ``"<phase>:<resource>"``
(``phase_resource_key``), next to the monolithic model at resource ``""``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import regression
from repro_torch.core.predictor import ModelDatabase
from repro_torch.telemetry.trace import JobTrace

#: the engine's phase order (combine only appears on combiner-enabled
#: traces; collect is host-side and usually negligible, but it is part of
#: the job and therefore part of the composed total).
PHASE_ORDER = ("map", "combine", "shuffle", "reduce", "collect")

#: the per-phase wall-time resource name.
TIME_RESOURCE = "time_s"

#: counters worth modeling per phase, beyond wall time.  Each is a
#: deterministic function of (config, corpus), so these regressions are
#: near-noise-free — the shuffle bytes model is what the network-aware
#: scheduling policy consumes.
DEFAULT_COUNTER_TARGETS = (
    ("map", "pairs_emitted"),
    ("shuffle", "bytes_out"),
    ("shuffle", "bytes_dropped"),
    ("reduce", "segments_out"),
    # Resource counters: per-phase CPU seconds against the same
    # (M, R) basis — the arXiv:1203.4054 companion target — and the
    # shuffle's on-wire bytes (arXiv:1206.2016), which the fabric-aware
    # scheduler prices against ``net_capacity``.  Traces that predate the
    # resource counters simply contribute 0.0 (``JobTrace.counter``'s
    # default), so fitting on mixed trace vintages stays well-defined.
    ("map", "cpu_s"),
    ("shuffle", "cpu_s"),
    ("reduce", "cpu_s"),
    ("shuffle", "net_bytes"),
    # Combine counters (map-side combining): pairs surviving the local
    # pre-aggregation — the contraction that shrinks shuffle net_bytes —
    # and the stage's CPU cost.  Combiner-off traces have no combine
    # phase, so these fit only on combiner-enabled trace sets.
    ("combine", "pairs_out"),
    ("combine", "cpu_s"),
)


def phase_resource_key(phase: str, resource: str = TIME_RESOURCE) -> str:
    """The ModelDatabase ``resource`` key for one (phase, resource)."""
    if not phase or ":" in phase:
        raise ValueError(f"bad phase name {phase!r}")
    if not resource or ":" in resource:
        raise ValueError(f"bad resource name {resource!r}")
    return f"{phase}:{resource}"


def split_resource_key(key: str) -> tuple[str, str]:
    phase, sep, resource = key.partition(":")
    if not sep or not phase or not resource:
        raise ValueError(f"not a phase-resource key: {key!r}")
    return phase, resource


@dataclasses.dataclass
class PhaseModelSet:
    """A bundle of fitted per-(phase, resource) models for one
    (application, platform[, backend])."""

    models: dict[tuple[str, str], regression.RegressionModel]

    def __len__(self) -> int:
        return len(self.models)

    def __contains__(self, key: tuple[str, str]) -> bool:
        return key in self.models

    def time_phases(self) -> list[str]:
        """Phases with a fitted wall-time model, in engine order."""
        got = {p for (p, r) in self.models if r == TIME_RESOURCE}
        ordered = [p for p in PHASE_ORDER if p in got]
        return ordered + sorted(got.difference(PHASE_ORDER))

    def model(self, phase: str, resource: str = TIME_RESOURCE):
        try:
            return self.models[(phase, resource)]
        except KeyError:
            raise KeyError(
                f"no model for phase={phase!r} resource={resource!r}; "
                f"fitted: {sorted(self.models)}"
            ) from None

    def predict(
        self, phase: str, resource: str, params, device="cuda"
    ) -> np.ndarray:
        """One model's predictions, evaluated on ``device`` (the port's
        models evaluate where the caller asks: the card unless told)."""
        pred = self.model(phase, resource).predict(np.asarray(params),
                                                   device=device)
        return pred.cpu().numpy().astype(np.float64).reshape(-1)

    def predict_phase_times(self, params, device="cuda") -> dict[str, np.ndarray]:
        return {
            p: self.predict(p, TIME_RESOURCE, params, device)
            for p in self.time_phases()
        }

    def predict_total(self, params, device="cuda") -> np.ndarray:
        """Composed total-time prediction: sum of the per-phase models."""
        per_phase = self.predict_phase_times(params, device)
        if not per_phase:
            raise ValueError("no per-phase time models fitted")
        return np.sum(list(per_phase.values()), axis=0)

    # ---- ModelDatabase round trip ---------------------------------------

    def publish(
        self,
        db: ModelDatabase,
        application: str,
        platform: str,
        backend: str = "",
    ) -> None:
        for (phase, resource), model in self.models.items():
            db.put(
                application, platform, model, backend=backend,
                resource=phase_resource_key(phase, resource),
            )

    @staticmethod
    def load(
        db: ModelDatabase,
        application: str,
        platform: str,
        backend: str = "",
    ) -> "PhaseModelSet":
        models = {}
        for res_key in db.resources_for(application, platform, backend):
            try:
                phase, resource = split_resource_key(res_key)
            except ValueError:
                continue  # not a telemetry key; leave it alone
            models[(phase, resource)] = db.get(
                application, platform, backend, resource=res_key
            )
        return PhaseModelSet(models=models)


def targets_from_traces(
    traces_per_config: Sequence[Sequence[JobTrace]],
    counter_targets: Sequence[tuple[str, str]] = DEFAULT_COUNTER_TARGETS,
) -> dict[tuple[str, str], np.ndarray]:
    """Aggregate raw traces into fit-ready (phase, resource) -> targets.

    ``traces_per_config[i]`` holds the repeat traces of experiment ``i``
    (the paper's pruning-by-averaging, per phase): wall times are averaged
    over repeats; counters are deterministic per config so averaging is a
    no-op that still smooths any accounting surprise.
    """
    if not traces_per_config or not traces_per_config[0]:
        raise ValueError("need at least one trace per config")
    phases = traces_per_config[0][0].phase_names()
    out: dict[tuple[str, str], list[float]] = {
        (p, TIME_RESOURCE): [] for p in phases
    }
    for phase, counter in counter_targets:
        if phase in phases:
            out[(phase, counter)] = []
    for reps in traces_per_config:
        if not reps:
            raise ValueError("empty repeat list for a config")
        for p in phases:
            out[(p, TIME_RESOURCE)].append(
                float(np.mean([t.phase(p).wall_s for t in reps]))
            )
        for phase, counter in counter_targets:
            if phase in phases:
                out[(phase, counter)].append(
                    float(np.mean([t.counter(phase, counter) for t in reps]))
                )
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def fit_phase_models(
    params,
    targets: Mapping[tuple[str, str], np.ndarray],
    **fit_kwargs,
) -> PhaseModelSet:
    """One regression per (phase, resource) on the shared parameter rows.

    ``params`` is the same (M, N) experiment matrix the monolithic fit
    uses; ``targets`` maps (phase, resource) to its (M,) measurement
    vector (see :func:`targets_from_traces`).  ``fit_kwargs`` forward to
    :func:`repro_torch.core.regression.fit` (``device=`` included) — use
    the same kwargs as the monolithic model so composed-vs-monolithic
    comparisons share a basis.
    """
    params = np.asarray(params, dtype=np.float64)
    models = {}
    for (phase, resource), values in targets.items():
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (params.shape[0],):
            raise ValueError(
                f"target {(phase, resource)} has shape {values.shape}, "
                f"expected ({params.shape[0]},)"
            )
        models[(phase, resource)] = regression.fit(
            params, values, **fit_kwargs
        )
    return PhaseModelSet(models=models)


def composed_vs_monolithic(
    phase_models: PhaseModelSet,
    monolithic: regression.RegressionModel,
    params,
    totals,
    device="cuda",
) -> dict:
    """Paper-Table-1-style error stats for both predictors on one set.

    ``totals`` should be the sum of the per-phase times for each row (the
    quantity both predictors target).  Returns mean/max absolute percent
    error for the composed and monolithic predictions plus their gap.
    Both predictors evaluate on ``device``.
    """
    totals = np.asarray(totals, dtype=np.float64)
    composed = phase_models.predict_total(params, device)
    mono = monolithic.predict(np.asarray(params), device=device)
    mono = mono.cpu().numpy().astype(np.float64).reshape(-1)
    denom = np.maximum(np.abs(totals), 1e-12)
    err_c = np.abs(composed - totals) / denom * 100.0
    err_m = np.abs(mono - totals) / denom * 100.0
    return {
        "composed_mean_pct": float(err_c.mean()),
        "composed_max_pct": float(err_c.max()),
        "monolithic_mean_pct": float(err_m.mean()),
        "monolithic_max_pct": float(err_m.max()),
        "composed_minus_monolithic_mean_pct": float(
            err_c.mean() - err_m.mean()
        ),
        # OLS linearity makes the two predictors algebraically identical on
        # a shared basis; the tolerance (in percentage points) absorbs the
        # float64 solver rounding between solve(G, sum b) and sum solve(G, b),
        # while staying far below any real modeling difference.
        "composed_le_monolithic": bool(
            err_c.mean() <= err_m.mean() + 1e-3
        ),
    }
