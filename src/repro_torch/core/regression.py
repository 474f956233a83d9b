"""Multivariate linear regression on polynomial features (paper Eqn. 3-6).

Counterpart of ``repro.core.regression``.  Ordinary least squares through
the normal equations, ``(P^T P + lam*I) A = P^T T`` solved rather than
inverted; ``lam`` defaults to 0 (paper-faithful).  Opt-in: ridge
(``lam > 0``) and a Huber-weighted IRLS robust refit.

``dtype=torch.float64`` (default) solves in numpy float64, as the
reference does; ``torch.float32`` solves with ``torch.linalg.solve`` on
``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.features import FeatureSpec, design_matrix, fit_feature_spec
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RegressionModel:
    """A fitted config->time model for one (application, platform)."""

    spec: FeatureSpec
    coef: np.ndarray  # (F,) alpha vector, paper ordering
    # Fit diagnostics.
    train_rmse: float
    train_mape: float  # mean |err|/|T| in percent, paper's error metric
    r2: float

    def predict(self, params, device="cuda") -> torch.Tensor:
        """Paper Eqn. 4-5: evaluate the fitted polynomial (float32)."""
        P = design_matrix(self.spec, params, device=device)
        return P @ torch.as_tensor(self.coef, dtype=P.dtype, device=P.device)

    def to_dict(self) -> dict:
        return {
            "spec": dataclasses.asdict(self.spec),
            "coef": np.asarray(self.coef).tolist(),
            "train_rmse": self.train_rmse,
            "train_mape": self.train_mape,
            "r2": self.r2,
        }

    @staticmethod
    def from_dict(d: dict) -> "RegressionModel":
        spec_d = dict(d["spec"])
        for k in ("lo", "hi"):
            if spec_d.get(k) is not None:
                spec_d[k] = tuple(spec_d[k])
        return RegressionModel(
            spec=FeatureSpec(**spec_d),
            coef=np.asarray(d["coef"], dtype=np.float64),
            train_rmse=float(d["train_rmse"]),
            train_mape=float(d["train_mape"]),
            r2=float(d["r2"]),
        )


def _solve_normal_equations(P, T, lam, dtype=torch.float32):
    """A = (P^T P + lam I)^{-1} P^T T  via a linear solve (paper Eqn. 6)."""
    P = P.to(dtype)
    T = T.to(dtype)
    G = P.T @ P  # (F, F) Gram matrix
    G = G + lam * torch.eye(G.shape[0], dtype=dtype, device=P.device)
    return torch.linalg.solve(G, P.T @ T)


def _irls_huber(P, T, coef0, delta, lam, dtype=torch.float32, iters=5):
    """Huber-weighted IRLS refinement: downweights experiments whose
    residual exceeds ``delta``."""
    P = P.to(dtype)
    T = T.to(dtype)
    eye = torch.eye(P.shape[1], dtype=dtype, device=P.device)
    coef = coef0.to(dtype)
    for _ in range(iters):
        r = T - P @ coef
        w = torch.clamp(delta / (torch.abs(r) + 1e-12), max=1.0)
        Pw = P * w[:, None]
        coef = torch.linalg.solve(Pw.T @ P + lam * eye, Pw.T @ T)
    return coef


def fit(
    params,
    times,
    *,
    degree: int = 3,
    cross_terms: bool = False,
    scale: bool = False,
    lam: float = 0.0,
    robust: bool = False,
    huber_delta: float | None = None,
    dtype=torch.float64,
    device="cuda",
) -> RegressionModel:
    """Fit the paper's model.  Defaults (modulo dtype) are paper-faithful.

    params: (M, N) raw configuration parameter values.
    times:  (M,)  mean total execution time per experiment (profiler output).
    The design matrix is built in float32 on ``device``; the float32 solve
    runs there too.
    """
    dev = resolve_device(device)
    params = np.asarray(params, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    if params.ndim != 2 or times.ndim != 1 or params.shape[0] != times.shape[0]:
        raise ValueError(
            f"bad shapes params={params.shape} times={times.shape}"
        )
    M, N = params.shape
    spec = fit_feature_spec(
        params, degree=degree, cross_terms=cross_terms, scale=scale
    )
    if M < spec.n_features:
        raise ValueError(
            f"underdetermined fit: M={M} experiments < F={spec.n_features} "
            f"features (paper requires M >> N)"
        )
    P = design_matrix(spec, params, device=dev).cpu().numpy().astype(np.float64)

    if dtype == torch.float64:
        # Normal-equations solve in numpy float64 (paper Eqn. 6).
        G = P.T @ P + lam * np.eye(P.shape[1])
        coef = np.linalg.solve(G, P.T @ times)
        if robust:
            delta = huber_delta or 1.345 * max(
                1e-12, float(np.std(times - P @ coef))
            )
            for _ in range(5):
                r = times - P @ coef
                w = np.minimum(1.0, delta / (np.abs(r) + 1e-12))
                Pw = P * w[:, None]
                G = Pw.T @ P + lam * np.eye(P.shape[1])
                coef = np.linalg.solve(G, Pw.T @ times)
    else:
        Pt = torch.as_tensor(P, dtype=dtype, device=dev)
        Tt = torch.as_tensor(times, dtype=dtype, device=dev)
        coef_t = _solve_normal_equations(Pt, Tt, lam, dtype=dtype)
        coef = coef_t.cpu().numpy().astype(np.float64)
        if robust:
            delta = huber_delta or 1.345 * max(
                1e-12, float(np.std(times - P @ coef))
            )
            coef = _irls_huber(
                Pt, Tt, coef_t, delta, lam, dtype=dtype
            ).cpu().numpy().astype(np.float64)

    pred = P @ coef
    resid = times - pred
    rmse = float(np.sqrt(np.mean(resid**2)))
    mape = float(np.mean(np.abs(resid) / np.maximum(np.abs(times), 1e-12))) * 100
    ss_res = float(np.sum(resid**2))
    ss_tot = float(np.sum((times - times.mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return RegressionModel(
        spec=spec, coef=coef, train_rmse=rmse, train_mape=mape, r2=r2
    )


def prediction_error_stats(model: RegressionModel, params, times,
                           device="cuda") -> dict:
    """Paper Table 1: mean and variance of |pred - actual| / actual in %."""
    times = np.asarray(times, dtype=np.float64)
    pred = model.predict(params, device=device).cpu().numpy().astype(np.float64)
    err_pct = np.abs(pred - times) / np.maximum(np.abs(times), 1e-12) * 100
    return {
        "mean_pct": float(np.mean(err_pct)),
        "var_pct": float(np.var(err_pct)),
        "median_pct": float(np.median(err_pct)),
        "max_pct": float(np.max(err_pct)),
        "per_experiment_pct": err_pct.tolist(),
    }
