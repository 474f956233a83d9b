"""Polynomial design matrix for config->time regression (paper Eqn. 1-2).

Counterpart of ``repro.core.features``.  Each of the N configuration
parameters expands into monomials up to ``degree`` (3 in the paper), with
no cross terms, plus one intercept column:

    row(p) = [1, p_1, p_1^2, p_1^3, ..., p_N, p_N^2, p_N^3]

``scale=True`` maps each parameter affinely to [0, 1] first (fit-time
ranges stored); ``cross_terms=True`` adds the pairwise products.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Immutable description of a fitted feature map."""

    n_params: int
    degree: int = 3
    cross_terms: bool = False
    scale: bool = False
    # Fit-time parameter ranges (used only when scale=True).
    lo: tuple[float, ...] | None = None
    hi: tuple[float, ...] | None = None

    @property
    def n_features(self) -> int:
        n = 1 + self.n_params * self.degree
        if self.cross_terms:
            n += self.n_params * (self.n_params - 1) // 2
        return n

    def column_names(self) -> list[str]:
        names = ["1"]
        for i in range(self.n_params):
            for d in range(1, self.degree + 1):
                names.append(f"p{i}" if d == 1 else f"p{i}^{d}")
        if self.cross_terms:
            for i in range(self.n_params):
                for j in range(i + 1, self.n_params):
                    names.append(f"p{i}*p{j}")
        return names


def fit_feature_spec(
    params,
    *,
    degree: int = 3,
    cross_terms: bool = False,
    scale: bool = False,
) -> FeatureSpec:
    """Build a FeatureSpec from training parameter rows (M, N)."""
    params = np.asarray(params, dtype=np.float64)
    if params.ndim != 2:
        raise ValueError(f"params must be (M, N), got shape {params.shape}")
    n_params = params.shape[1]
    lo = hi = None
    if scale:
        lo = tuple(float(x) for x in params.min(axis=0))
        hi_raw = params.max(axis=0)
        # Width 1 for a constant parameter keeps the affine map invertible.
        hi = tuple(
            float(h if h > l else l + 1.0) for l, h in zip(lo, hi_raw)
        )
    return FeatureSpec(
        n_params=n_params, degree=degree, cross_terms=cross_terms,
        scale=scale, lo=lo, hi=hi,
    )


def design_matrix(spec: FeatureSpec, params, device="cuda") -> torch.Tensor:
    """Expand raw parameter rows (M, N) into the float32 design matrix
    (M, F) on ``device``.  The same float32 operations in the same order
    as the reference, so the entries agree to the last bit."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(params), dtype=torch.float32, device=dev)
    if p.dim() == 1:
        p = p[None, :]
    if p.shape[-1] != spec.n_params:
        raise ValueError(
            f"expected {spec.n_params} parameters, got {p.shape[-1]}"
        )
    if spec.scale:
        lo = torch.tensor(spec.lo, dtype=torch.float32, device=dev)
        hi = torch.tensor(spec.hi, dtype=torch.float32, device=dev)
        p = (p - lo) / (hi - lo)
    cols = [torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=dev)]
    for i in range(spec.n_params):
        pi = p[..., i : i + 1]
        acc = pi
        for _ in range(spec.degree):
            cols.append(acc)
            acc = acc * pi
    if spec.cross_terms:
        for i in range(spec.n_params):
            for j in range(i + 1, spec.n_params):
                cols.append(p[..., i : i + 1] * p[..., j : j + 1])
    # Paper ordering: [1, p1, p1^2, p1^3, p2, p2^2, p2^3, ...]
    return torch.cat(cols, dim=-1)


def grid(ranges: Sequence[tuple[int, int, int]]) -> np.ndarray:
    """Cartesian experiment grid: ranges[(lo, hi, step)] per parameter."""
    axes = [np.arange(lo, hi + 1, step) for lo, hi, step in ranges]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1).astype(np.float64)
