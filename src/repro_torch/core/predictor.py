"""Prediction phase + model database (paper Fig. 2b).

Counterpart of ``repro.core.predictor``, with the same JSON format, so a
database written by either package loads in the other.  One fitted model
per (application, platform[, backend[, resource]]): the paper's models
are valid only for the same application on the same platform.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from repro_torch.core.regression import RegressionModel

_SEP = "\x00"


class ModelDatabase:
    """Per-(application, platform[, backend[, resource]]) RegressionModels."""

    def __init__(self) -> None:
        self._models: dict[tuple[str, str, str, str], RegressionModel] = {}

    @staticmethod
    def _key(
        application: str,
        platform: str,
        backend: str = "",
        resource: str = "",
    ) -> tuple[str, str, str, str]:
        return (application, platform, backend, resource)

    def put(
        self,
        application: str,
        platform: str,
        model: RegressionModel,
        backend: str = "",
        resource: str = "",
    ) -> None:
        self._models[
            self._key(application, platform, backend, resource)
        ] = model

    def get(
        self,
        application: str,
        platform: str,
        backend: str = "",
        resource: str = "",
    ) -> RegressionModel:
        key = self._key(application, platform, backend, resource)
        if key not in self._models:
            raise KeyError(
                f"no model for application={application!r} on "
                f"platform={platform!r}"
                + (f" backend={backend!r}" if backend else "")
                + (f" resource={resource!r}" if resource else "")
                + "; the paper's models do not transfer "
                "across applications or platforms — profile first."
            )
        return self._models[key]

    def __contains__(self, key: tuple[str, ...]) -> bool:
        return self._key(*key) in self._models

    def __len__(self) -> int:
        return len(self._models)

    def applications(self) -> list[tuple[str, ...]]:
        """Stored keys; the resource component is elided when empty."""
        return sorted(
            key if key[3] else key[:3] for key in self._models
        )

    def backends_for(self, application: str, platform: str) -> list[str]:
        """Backend key components stored for one (application, platform),
        over total-time (resource ``""``) models only."""
        return sorted(
            b
            for (a, p, b, res) in self._models
            if (a, p, res) == (application, platform, "")
        )

    def resources_for(
        self, application: str, platform: str, backend: str = ""
    ) -> list[str]:
        """Non-empty resource key components stored for one
        (application, platform, backend)."""
        return sorted(
            res
            for (a, p, b, res) in self._models
            if (a, p, b) == (application, platform, backend) and res
        )

    def predict(
        self,
        application: str,
        platform: str,
        params: Sequence[float],
        backend: str = "",
        resource: str = "",
        device="cuda",
    ) -> float:
        """Paper Fig. 2b: look up the app's model, evaluate Eqn. 5."""
        model = self.get(application, platform, backend, resource)
        pred = model.predict(np.asarray(params), device=device)
        return float(pred.reshape(-1)[0])

    # ---- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        payload = {}
        for key, model in self._models.items():
            app, plat, backend, resource = key
            # Resource-less keys keep the 3-part wire format.
            parts = [app, plat, backend] + ([resource] if resource else [])
            payload[_SEP.join(parts)] = model.to_dict()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic publish

    @classmethod
    def load(cls, path: str) -> "ModelDatabase":
        db = cls()
        with open(path) as f:
            payload = json.load(f)
        for key, d in payload.items():
            parts = key.split(_SEP)
            if len(parts) < 2 or len(parts) > 4:
                raise ValueError(f"malformed model key {key!r} in {path}")
            # Older files: 2-part (app, platform) and 3-part (+backend).
            parts = parts + [""] * (4 - len(parts))
            app, plat, backend, resource = parts
            db.put(
                app, plat, RegressionModel.from_dict(d),
                backend=backend, resource=resource,
            )
        return db
