"""Online model refinement: the paper's profiling phase made continuous
(counterpart of ``repro.cluster.online``).

The paper profiles, fits, predicts — once.  A running cluster gets a free
profiling experiment with *every completed job*: the (config, observed
runtime) pair is exactly one row of the paper's experiment set.
``OnlineRefiner`` accumulates those rows per (application, backend), refits
the regression incrementally, and republishes the model into the shared
:class:`~repro_torch.core.predictor.ModelDatabase` — so the very next scheduling
decision uses a model trained on everything the cluster has seen so far,
and prediction error shrinks over the trace (measured by
``TraceResult.metrics()['pred_mae_pct_first_half' / '_second_half']``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import regression
from repro_torch.core.features import fit_feature_spec
from repro_torch.core.predictor import ModelDatabase

#: fit options shared with ``core.tuner.tune`` defaults: the refiner must be
#: robust unattended, so scaling + tiny ridge + cross terms are on.
DEFAULT_FIT_KWARGS = dict(degree=3, scale=True, lam=1e-6, cross_terms=True)

#: per-phase time models use a leaner basis: each phase is individually
#: smoother than the total (the non-monotonic wave-quantization kinks live
#: mostly in map/reduce, not in every phase), and live traces accumulate
#: slowly — a quadratic no-cross basis (9 features for 4 params) reaches
#: the 2x determinacy margin within a realistic trace.
DEFAULT_PHASE_FIT_KWARGS = dict(degree=2, scale=True, lam=1e-6,
                                cross_terms=False)

#: where the scheduler fits its models: on the host.  Its design matrices
#: are at most a few hundred rows of 35 features, and its predictions are
#: evaluated in numpy (``policies._np_predict``), so the card would add a
#: copy to every fit and speed up nothing.
FIT_DEVICE = "cpu"


class OnlineRefiner:
    """Accumulate per-(app, backend) observations; refit into the shared db.

    ``seed_profiles`` installs the bootstrap profiling set (the offline
    phase); ``observe`` appends one completed job and refits every
    ``refit_every`` observations once the running total can determine the
    feature count.  ``max_points`` optionally keeps only the most recent
    window (bootstrap rows are never evicted — they anchor the fit in
    regions the live workload hasn't visited yet).
    """

    def __init__(
        self,
        db: ModelDatabase,
        platform: str,
        *,
        refit_every: int = 1,
        max_points: int | None = None,
        fit_kwargs: dict | None = None,
        phase_fit_kwargs: dict | None = None,
        phase_refit_every: int | None = None,
    ):
        if refit_every < 1:
            raise ValueError("refit_every must be >= 1")
        self.db = db
        self.platform = platform
        self.refit_every = refit_every
        self.max_points = max_points
        self.fit_kwargs = dict(fit_kwargs or DEFAULT_FIT_KWARGS)
        self.phase_fit_kwargs = dict(
            phase_fit_kwargs or DEFAULT_PHASE_FIT_KWARGS
        )
        # Phase models never drive plan selection, so they refit at a
        # slower cadence than the dispatch-critical total-time model —
        # one fit per phase per cadence, on the full history, is the cost.
        self.phase_refit_every = (
            max(5, refit_every) if phase_refit_every is None
            else phase_refit_every
        )
        if self.phase_refit_every < 1:
            raise ValueError("phase_refit_every must be >= 1")
        # (app, backend) -> [bootstrap rows (np.ndarray), ...], observations
        self._seed: dict[tuple[str, str], tuple[np.ndarray, np.ndarray]] = {}
        self._obs: dict[tuple[str, str], list[tuple[np.ndarray, float]]] = {}
        self._since_refit: dict[tuple[str, str], int] = {}
        self.n_refits = 0
        self.n_drift_refits = 0
        # (app, backend, phase) -> per-phase time observations (telemetry).
        self._phase_obs: dict[
            tuple[str, str, str], list[tuple[np.ndarray, float]]
        ] = {}
        self._phase_since_refit: dict[tuple[str, str], int] = {}
        self.n_phase_refits = 0

    def seed_profiles(
        self, app: str, backend: str, params: np.ndarray, times: np.ndarray
    ) -> None:
        self._seed[(app, backend)] = (
            np.asarray(params, dtype=np.float64),
            np.asarray(times, dtype=np.float64),
        )
        self._obs.setdefault((app, backend), [])

    def training_set(
        self, app: str, backend: str
    ) -> tuple[np.ndarray, np.ndarray]:
        """Bootstrap profiles + live observations, as fit-ready arrays."""
        key = (app, backend)
        obs = self._obs.get(key, [])
        if self.max_points is not None:
            obs = obs[-self.max_points:]
        rows = [row for row, _ in obs]
        times = [t for _, t in obs]
        if key in self._seed:
            seed_p, seed_t = self._seed[key]
            rows = list(seed_p) + rows
            times = list(seed_t) + times
        return np.asarray(rows, dtype=np.float64), np.asarray(
            times, dtype=np.float64
        )

    def n_observations(self, app: str, backend: str) -> int:
        return len(self._obs.get((app, backend), []))

    def observe(
        self, app: str, backend: str, params_row, observed_time: float
    ) -> bool:
        """Record one completed job; refit + republish when due.

        Returns True when the database model was actually updated, so the
        caller (a scheduling policy) can invalidate cached predictions.
        """
        key = (app, backend)
        self._obs.setdefault(key, []).append(
            (np.asarray(params_row, dtype=np.float64), float(observed_time))
        )
        self._since_refit[key] = self._since_refit.get(key, 0) + 1
        if self._since_refit[key] < self.refit_every:
            return False
        params, times = self.training_set(app, backend)
        spec_probe = fit_feature_spec(
            params,
            degree=self.fit_kwargs.get("degree", 3),
            cross_terms=self.fit_kwargs.get("cross_terms", False),
        )
        # Without bootstrap rows to anchor the fit (warm-started from a
        # saved ModelDatabase), live observations cluster at the few
        # argmin-chosen configs and can leave the design matrix badly
        # rank-deficient even once it is square — demand a 2x margin
        # before replacing a loaded model.
        min_rows = spec_probe.n_features * (1 if key in self._seed else 2)
        if params.shape[0] < min_rows:
            return False  # still underdetermined; keep the current model
        model = regression.fit(params, times, device=FIT_DEVICE,
                               **self.fit_kwargs)
        self.db.put(app, self.platform, model, backend=backend)
        self._since_refit[key] = 0
        self.n_refits += 1
        return True

    # ---- drift response (repro_torch.obs.drift alarms) ------------------------

    def refit_category(
        self,
        app: str,
        category: str,
        *,
        keep_last: int | None = None,
        drop_seed: bool = True,
        scale_hint: float | None = None,
    ) -> bool:
        """Category-targeted refit in response to a drift alarm.

        A drifted category means its historical rows — above all the
        bootstrap seed anchors, profiled *before* the shift — now describe
        a platform that no longer exists, so the every-completion
        :meth:`observe` path (which keeps them as anchors) cannot recover:
        a handful of post-shift rows never outweighs hundreds of stale
        ones.  This method evicts the seed anchors (``drop_seed``), trims
        the live history to the most recent ``keep_last`` rows, and refits
        from what remains.  When too few rows survive for a determinable
        fit, the published model's coefficient vector is rescaled by
        ``scale_hint`` (the ledger's EWMA of realized/predicted) instead —
        predictions are linear in ``coef``, so for the canonical
        multiplicative platform shift this one-line correction is already
        the right answer, available from the very first alarm.

        Returns True when the database model was updated (the caller must
        invalidate cached plans).
        """
        key = (app, category)
        if drop_seed:
            self._seed.pop(key, None)
        if keep_last is not None and key in self._obs:
            self._obs[key] = self._obs[key][-int(keep_last):]
        params, times = self.training_set(app, category)
        if params.shape[0]:
            spec_probe = fit_feature_spec(
                params,
                degree=self.fit_kwargs.get("degree", 3),
                cross_terms=self.fit_kwargs.get("cross_terms", False),
            )
            if params.shape[0] >= 2 * spec_probe.n_features:
                model = regression.fit(params, times, device=FIT_DEVICE,
                                       **self.fit_kwargs)
                self.db.put(app, self.platform, model, backend=category)
                self._since_refit[key] = 0
                self.n_drift_refits += 1
                return True
        if scale_hint is None or scale_hint <= 0:
            return False
        try:
            current = self.db.get(app, self.platform, backend=category)
        except KeyError:
            return False
        rescaled = dataclasses.replace(
            current,
            coef=np.asarray(current.coef, dtype=np.float64) * scale_hint,
        )
        self.db.put(app, self.platform, rescaled, backend=category)
        self._since_refit[key] = 0
        self.n_drift_refits += 1
        return True

    # ---- per-phase refinement (telemetry traces) ------------------------

    def observe_phases(
        self,
        app: str,
        backend: str,
        params_row,
        phase_times: dict[str, float],
    ) -> bool:
        """Record one completed job's per-phase wall times; refit the
        decomposed per-phase time models when due.

        Every completed job whose oracle returns a
        :class:`repro_torch.telemetry.JobTrace` contributes one row per phase;
        once enough rows accumulate, one
        :class:`~repro_torch.core.regression.RegressionModel` per phase is
        (re)fitted and published into the database under the telemetry
        layer's resource-qualified keys (``"<phase>:time_s"``) — the
        continuous analogue of ``telemetry.models.fit_phase_models``.
        Returns True when the models were republished.
        """
        from repro_torch.telemetry.models import phase_resource_key

        row = np.asarray(params_row, dtype=np.float64)
        for phase, t in phase_times.items():
            self._phase_obs.setdefault((app, backend, phase), []).append(
                (row, float(t))
            )
        key = (app, backend)
        self._phase_since_refit[key] = self._phase_since_refit.get(key, 0) + 1
        if self._phase_since_refit[key] < self.phase_refit_every:
            return False
        phases = sorted(
            p for (a, b, p) in self._phase_obs if (a, b) == key
        )
        if not phases:
            return False
        refitted = False
        for phase in phases:
            obs = self._phase_obs[(app, backend, phase)]
            if self.max_points is not None:
                obs = obs[-self.max_points:]
            params = np.asarray([r for r, _ in obs], dtype=np.float64)
            times = np.asarray([t for _, t in obs], dtype=np.float64)
            spec_probe = fit_feature_spec(
                params,
                degree=self.phase_fit_kwargs.get("degree", 2),
                cross_terms=self.phase_fit_kwargs.get("cross_terms", False),
            )
            # No bootstrap anchor rows exist for phases: always demand the
            # 2x determinacy margin (see ``observe``).
            if params.shape[0] < 2 * spec_probe.n_features:
                continue
            model = regression.fit(params, times, device=FIT_DEVICE,
                                   **self.phase_fit_kwargs)
            self.db.put(
                app, self.platform, model, backend=backend,
                resource=phase_resource_key(phase),
            )
            refitted = True
        if refitted:
            self._phase_since_refit[key] = 0
            self.n_phase_refits += 1
        return refitted
