"""Regression-driven configuration autotuner; counterpart of ``repro.core.tuner``.

Sample a subset of a discrete configuration space, profile each sample,
fit the paper's polynomial model, and return the argmin of its prediction
over the whole space.  Categorical knobs (e.g. the reduce backend) get one
model per category, and the joint argmin is taken across them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core import regression
from repro_torch.core.profiler import profile_experiments


@dataclasses.dataclass
class TuneResult:
    best_config: np.ndarray
    predicted_time: float
    model: regression.RegressionModel
    sampled_configs: np.ndarray
    sampled_times: np.ndarray
    # Filled by validate(): true time of the chosen config and of the true
    # optimum, to report regret.
    measured_best_time: float | None = None
    true_optimum_time: float | None = None

    @property
    def regret_pct(self) -> float | None:
        if self.measured_best_time is None or self.true_optimum_time is None:
            return None
        return (
            (self.measured_best_time - self.true_optimum_time)
            / self.true_optimum_time
            * 100.0
        )


def _latin_hypercube_indices(n_space: int, n_samples: int, seed: int) -> np.ndarray:
    """Stratified index sample over a 1-D enumeration of the space."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(0, n_space, n_samples + 1)
    idx = np.array(
        [rng.integers(int(edges[i]), max(int(edges[i + 1]), int(edges[i]) + 1))
         for i in range(n_samples)]
    )
    return np.clip(idx, 0, n_space - 1)


def tune(
    run_fn: Callable[[Sequence[float]], float],
    space: np.ndarray,
    *,
    n_samples: int | None = None,
    repeats: int = 1,
    degree: int = 3,
    scale: bool = True,
    lam: float = 1e-6,
    cross_terms: bool = True,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
) -> TuneResult:
    """Profile a sample of ``space`` (K, N), model, and argmin the prediction.

    Defaults use the conditioning fixes (scale + tiny ridge + cross terms);
    pass ``scale=False, lam=0.0, cross_terms=False`` for the paper's basis.
    """
    space = np.asarray(space, dtype=np.float64)
    K, N = space.shape
    n_feat = 1 + N * degree + (N * (N - 1) // 2 if cross_terms else 0)
    if n_samples is None:
        n_samples = min(K, max(2 * n_feat, 8))
    n_samples = min(n_samples, K)
    if n_samples < n_feat:
        raise ValueError(
            f"n_samples={n_samples} < n_features={n_feat}; enlarge the sample"
        )
    idx = _latin_hypercube_indices(K, n_samples, seed)
    samples = space[np.unique(idx)]
    # Top up uniques lost to clipping.
    rng = np.random.default_rng(seed + 1)
    while samples.shape[0] < min(n_samples, K):
        extra = space[rng.integers(0, K)]
        if not (samples == extra).all(axis=1).any():
            samples = np.vstack([samples, extra])
    prof = profile_experiments(
        run_fn, samples, repeats=repeats, verbose=verbose
    )
    model = regression.fit(
        prof.params,
        prof.times,
        degree=degree,
        scale=scale,
        lam=lam,
        cross_terms=cross_terms,
        device=device,
    )
    pred = model.predict(space, device=device).cpu().numpy().astype(np.float64)
    best = int(np.argmin(pred))
    return TuneResult(
        best_config=space[best],
        predicted_time=float(pred[best]),
        model=model,
        sampled_configs=prof.params,
        sampled_times=prof.times,
    )


@dataclasses.dataclass
class CategoricalTuneResult:
    """Joint optimum over (category, numeric config)."""

    best_category: str
    best_config: np.ndarray
    predicted_time: float
    per_category: dict[str, TuneResult]

    def predicted_times(self) -> dict[str, float]:
        return {c: r.predicted_time for c, r in self.per_category.items()}


def tune_categorical(
    run_fns: Mapping[str, Callable[[Sequence[float]], float]],
    space: np.ndarray,
    **tune_kwargs,
) -> CategoricalTuneResult:
    """Tune a mixed categorical x numeric space: one polynomial model per
    category value, argmin across all of them."""
    if not run_fns:
        raise ValueError("run_fns must name at least one category")
    per = {
        cat: tune(fn, space, **tune_kwargs) for cat, fn in run_fns.items()
    }
    best_cat = min(per, key=lambda c: per[c].predicted_time)
    return CategoricalTuneResult(
        best_category=best_cat,
        best_config=per[best_cat].best_config,
        predicted_time=per[best_cat].predicted_time,
        per_category=per,
    )


def validate(
    result: TuneResult,
    run_fn: Callable[[Sequence[float]], float],
    space: np.ndarray,
    *,
    repeats: int = 1,
) -> TuneResult:
    """Measure the chosen config and the exhaustive optimum; fill regret."""
    space = np.asarray(space, dtype=np.float64)
    times = np.array(
        [
            np.mean([run_fn(row) for _ in range(repeats)])
            for row in space
        ]
    )
    chosen = np.where((space == result.best_config).all(axis=1))[0]
    result.measured_best_time = float(times[chosen[0]])
    result.true_optimum_time = float(times.min())
    return result


def mesh_factorizations(n_devices: int, *, min_axis: int = 1) -> np.ndarray:
    """All (data, model) integer factorizations of n_devices — the discrete
    config space whose analogue in the paper is (#mappers, #reducers)."""
    out = []
    for data in range(min_axis, n_devices + 1):
        if n_devices % data == 0:
            model = n_devices // data
            if model >= min_axis:
                out.append((data, model))
    return np.asarray(out, dtype=np.float64)
