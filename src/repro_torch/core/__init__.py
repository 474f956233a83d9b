"""Core: the paper's profiling -> modeling -> prediction pipeline.

Paper: "On Modeling Dependency between MapReduce Configuration Parameters
and Total Execution Time" (Rizvandi et al., 2012).  ``costmodel`` is the
analytic timer at scale (roofline terms of a dry run on the H100's
figures), and ``mesh_factorizations`` the mesh-shape configuration space
the tuner sweeps over it.
"""

from repro_torch.core.costmodel import RooflineReport, roofline_from_counts
from repro_torch.core.features import (
    FeatureSpec,
    design_matrix,
    fit_feature_spec,
    grid,
)
from repro_torch.core.profiler import (
    ProfileResult,
    profile_categorical,
    profile_experiments,
    timeit,
)
from repro_torch.core.predictor import ModelDatabase
from repro_torch.core.regression import (
    RegressionModel,
    fit,
    prediction_error_stats,
)
from repro_torch.core.tuner import (
    CategoricalTuneResult,
    TuneResult,
    mesh_factorizations,
    tune,
    tune_categorical,
    validate,
)

__all__ = [
    "RooflineReport",
    "roofline_from_counts",
    "mesh_factorizations",
    "FeatureSpec",
    "design_matrix",
    "fit_feature_spec",
    "grid",
    "ProfileResult",
    "profile_categorical",
    "profile_experiments",
    "timeit",
    "ModelDatabase",
    "RegressionModel",
    "fit",
    "prediction_error_stats",
    "CategoricalTuneResult",
    "TuneResult",
    "tune",
    "tune_categorical",
    "validate",
]
