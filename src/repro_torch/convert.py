"""State that crosses between the reference package and the port.

The system has no weights: what crosses is configuration, data and fitted
models.

* :func:`job_config_from_reference` — a reference ``JobConfig`` (as
  ``dataclasses.asdict``) becomes the port's, with the reduce backend
  renamed through :data:`REFERENCE_BACKEND_NAMES`;
* :func:`regression_model_from_reference` — a reference
  ``RegressionModel.to_dict()`` becomes a port model that predicts the
  same values;
* :meth:`ModelDatabase.load` reads a JSON file written by the reference
  (the format is shared).

Corpora cross through their seed: ``mapreduce.datagen`` draws the same
RNG sequence as the reference.
"""

from __future__ import annotations

from repro_torch.core.predictor import ModelDatabase
from repro_torch.core.regression import RegressionModel
from repro_torch.mapreduce.engine import JobConfig

__all__ = [
    "REFERENCE_BACKEND_NAMES",
    "ModelDatabase",
    "job_config_from_reference",
    "regression_model_from_reference",
]

#: reference reduce backend name -> the port's backend of the same role
REFERENCE_BACKEND_NAMES = {
    "jnp": "torch",
    "xla": "scatter_reduce",
    "pallas": "cuda",
}


def job_config_from_reference(d: dict) -> JobConfig:
    """The port's ``JobConfig`` for ``dataclasses.asdict`` of a reference one."""
    fields = dict(d)
    name = fields.get("reduce_backend", "jnp")
    if name not in REFERENCE_BACKEND_NAMES:
        raise ValueError(
            f"unknown reference reduce backend {name!r}; "
            f"known: {sorted(REFERENCE_BACKEND_NAMES)}"
        )
    fields["reduce_backend"] = REFERENCE_BACKEND_NAMES[name]
    return JobConfig(**fields)


def regression_model_from_reference(d: dict) -> RegressionModel:
    """A port model from a reference ``RegressionModel.to_dict()``."""
    return RegressionModel.from_dict(d)
