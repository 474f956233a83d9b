"""Prediction ledger + drift alarms: watch the models the schedulers trust
(counterpart of ``repro.obs.drift``).

Every dispatch carries a prediction (``Plan.predicted_time``) and every
completion realizes a wall clock — one free accuracy experiment per job,
per (app, backend, depth) category.  :class:`PredictionLedger` records the
pairs and maintains two EWMAs per category:

* the **absolute relative error** ``|pred - real| / real`` — when it
  crosses ``threshold`` (after ``min_samples`` observations) the category
  has drifted and a :class:`DriftAlarm` fires;
* the **realized/predicted ratio** — its value at alarm time is the
  ``scale_hint``: for a multiplicative platform shift (the canonical
  drift: same machine, different load factor) rescaling the category's
  model by this hint is already the maximum-likelihood correction, which
  is what :meth:`repro_torch.cluster.online.OnlineRefiner.refit_category` applies
  when too few post-shift rows exist for a full refit.

After an alarm both EWMAs reset (re-arm), so a persistent shift raises a
short *sequence* of alarms whose hints converge multiplicatively on the
true factor instead of one alarm followed by silence — and a recovered
category stops alarming entirely.

Samples whose ratio falls outside ``ratio_clip`` never touch the EWMAs:
drift worth auto-correcting is multiplicative and modest (a platform
getting 1.6x slower), not three orders of magnitude.  A 400x ratio means
the *prediction* was pathological — typically the polynomial dipped <= 0
at an argmin-chosen corner and the policy clamped it to its floor — and a
clamped prediction carries no scale information at all.  Such samples are
tallied (``n_outliers``) and kept in the entry history, but letting them
into the hint would command a 400x rescale and the correction loop would
oscillate instead of converging.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["DriftAlarm", "LEDGER_SCHEMA_VERSION", "PredictionLedger"]

#: Serialization schema for :meth:`PredictionLedger.to_json` (same
#: convention as ``telemetry.TRACE_SCHEMA_VERSION``): bump on breaking
#: layout changes so old readers fail loudly instead of misparsing.
LEDGER_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class DriftAlarm:
    """One drift detection: a category's EWMA error crossed threshold."""

    t: float                  #: sim time of the triggering completion
    app: str
    category: str             #: policy category key ("backend[@dD]")
    ewma_abs_rel_err: float
    scale_hint: float         #: EWMA of realized/predicted at alarm time
    n: int                    #: observations since the last (re-)arm


@dataclasses.dataclass
class _CatState:
    ewma_err: float | None = None
    ewma_ratio: float | None = None
    n: int = 0


class PredictionLedger:
    """Per-(app, category) record of predicted vs realized times."""

    def __init__(
        self,
        *,
        alpha: float = 0.4,
        threshold: float = 0.25,
        min_samples: int = 3,
        keep_last: int = 64,
        ratio_clip: tuple[float, float] = (0.25, 4.0),
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0.0:
            raise ValueError("threshold must be > 0")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        lo, hi = float(ratio_clip[0]), float(ratio_clip[1])
        if not 0.0 < lo < 1.0 < hi:
            raise ValueError(
                f"ratio_clip must straddle 1.0 with 0 < lo < 1 < hi, "
                f"got {ratio_clip!r}"
            )
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.keep_last = int(keep_last)
        self.ratio_clip = (lo, hi)
        self.n_outliers = 0
        self._state: dict[tuple[str, str], _CatState] = {}
        #: bounded (t, predicted, realized) history per category.
        self._entries: dict[tuple[str, str], list[tuple]] = {}
        self.alarms: list[DriftAlarm] = []
        self.n_records = 0

    def record(
        self,
        app: str,
        category: str,
        predicted: float,
        realized: float,
        t: float = 0.0,
    ) -> DriftAlarm | None:
        """Record one (prediction, realization) pair; return the alarm if
        this observation pushed the category over threshold."""
        predicted = float(predicted)
        realized = float(realized)
        err = abs(predicted - realized) / max(abs(realized), 1e-12)
        ratio = realized / max(predicted, 1e-12)
        key = (app, category)
        entries = self._entries.setdefault(key, [])
        entries.append((float(t), predicted, realized))
        if len(entries) > self.keep_last:
            del entries[: len(entries) - self.keep_last]
        self.n_records += 1
        lo, hi = self.ratio_clip
        if not lo <= ratio <= hi:
            # Untrusted sample (see module docstring): recorded above,
            # but it must not steer the alarm or the scale hint.
            self.n_outliers += 1
            return None
        st = self._state.setdefault(key, _CatState())
        a = self.alpha
        st.ewma_err = (
            err if st.ewma_err is None else a * err + (1 - a) * st.ewma_err
        )
        st.ewma_ratio = (
            ratio if st.ewma_ratio is None
            else a * ratio + (1 - a) * st.ewma_ratio
        )
        st.n += 1
        if st.n >= self.min_samples and st.ewma_err > self.threshold:
            alarm = DriftAlarm(
                t=float(t), app=app, category=category,
                ewma_abs_rel_err=st.ewma_err, scale_hint=st.ewma_ratio,
                n=st.n,
            )
            self.alarms.append(alarm)
            # Re-arm: the next alarm's hint is estimated purely from
            # post-correction observations.
            self._state[key] = _CatState()
            return alarm
        return None

    # ---- queries ---------------------------------------------------------

    def ewma_error(self, app: str, category: str) -> float | None:
        st = self._state.get((app, category))
        return st.ewma_err if st else None

    def categories(self) -> list[tuple[str, str]]:
        return sorted(self._entries)

    def category_mae_pct(self, app: str, category: str) -> float | None:
        """Plain MAE% over the retained history (reporting, not alarming)."""
        entries = self._entries.get((app, category))
        if not entries:
            return None
        errs = [
            abs(p - r) / max(abs(r), 1e-12) * 100.0 for _, p, r in entries
        ]
        return sum(errs) / len(errs)

    # ---- serialization ---------------------------------------------------

    def state_dict(self) -> dict:
        """Full resumable state (unlike :meth:`to_dict`, which is a report
        summary).  Keys are ``"app/category"`` strings; the layout is
        versioned by the embedded ``schema`` field."""
        return {
            "schema": LEDGER_SCHEMA_VERSION,
            "config": {
                "alpha": self.alpha,
                "threshold": self.threshold,
                "min_samples": self.min_samples,
                "keep_last": self.keep_last,
                "ratio_clip": list(self.ratio_clip),
            },
            "n_records": self.n_records,
            "n_outliers": self.n_outliers,
            "state": {
                f"{app}/{cat}": dataclasses.asdict(st)
                for (app, cat), st in sorted(self._state.items())
            },
            "entries": {
                f"{app}/{cat}": [list(e) for e in entries]
                for (app, cat), entries in sorted(self._entries.items())
            },
            "alarms": [dataclasses.asdict(a) for a in self.alarms],
        }

    def to_json(self, **dumps_kwargs) -> str:
        dumps_kwargs.setdefault("sort_keys", True)
        return json.dumps(self.state_dict(), **dumps_kwargs)

    @staticmethod
    def from_state_dict(d: dict) -> "PredictionLedger":
        if not isinstance(d, dict):
            raise ValueError(
                f"ledger state must be a dict, got {type(d).__name__}"
            )
        # Pre-versioning dumps carried no schema field: read them as v1.
        version = int(d.get("schema", 1))
        if not 1 <= version <= LEDGER_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported ledger schema version {version}; this build "
                f"reads versions 1..{LEDGER_SCHEMA_VERSION}"
            )
        cfg = d.get("config", {})
        led = PredictionLedger(
            alpha=cfg.get("alpha", 0.4),
            threshold=cfg.get("threshold", 0.25),
            min_samples=cfg.get("min_samples", 3),
            keep_last=cfg.get("keep_last", 64),
            ratio_clip=tuple(cfg.get("ratio_clip", (0.25, 4.0))),
        )
        led.n_records = int(d.get("n_records", 0))
        led.n_outliers = int(d.get("n_outliers", 0))
        for key, st in d.get("state", {}).items():
            app, _, cat = key.partition("/")
            led._state[(app, cat)] = _CatState(
                ewma_err=st.get("ewma_err"),
                ewma_ratio=st.get("ewma_ratio"),
                n=int(st.get("n", 0)),
            )
        for key, entries in d.get("entries", {}).items():
            app, _, cat = key.partition("/")
            led._entries[(app, cat)] = [
                (float(t), float(p), float(r)) for t, p, r in entries
            ]
        led.alarms = [DriftAlarm(**a) for a in d.get("alarms", [])]
        return led

    @staticmethod
    def from_json(s: str) -> "PredictionLedger":
        return PredictionLedger.from_state_dict(json.loads(s))

    def to_dict(self) -> dict:
        return {
            "n_records": self.n_records,
            "n_outliers": self.n_outliers,
            "threshold": self.threshold,
            "alpha": self.alpha,
            "alarms": [dataclasses.asdict(a) for a in self.alarms],
            "categories": {
                f"{app}/{cat}": {
                    "n_entries": len(self._entries[(app, cat)]),
                    "ewma_abs_rel_err": self.ewma_error(app, cat),
                    "mae_pct": self.category_mae_pct(app, cat),
                }
                for app, cat in self.categories()
            },
        }
