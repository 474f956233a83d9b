"""SLO policies + multi-window burn-rate alarms over windowed metrics
(counterpart of ``repro.obs.slo``).

An SLO here is the service-level statement the ROADMAP's "millions of
users" north star implies: *"objective × 100 % of completed jobs are
good"*, where good means turnaround within the target (or, for
deadline-carrying workloads, the deadline was met).  The monitor turns
the completion stream into **burn rates** — the rate at which the error
budget (the allowed ``1 - objective`` bad fraction) is being consumed,
measured over two sliding sim-time windows:

* the **fast** window reacts to an overload within seconds but would flap
  on a single unlucky burst;
* the **slow** window confirms the burn is sustained but would alarm far
  too late on its own.

An alarm *trips* only when **both** exceed ``trip_burn`` (the classic
multi-window burn-rate alerting rule), and *clears* — re-arms, in the
style of :mod:`repro_torch.obs.drift`'s alarm/re-arm machinery — once both
fall below ``clear_burn``.  Each transition is recorded as a
:class:`BurnAlarm`; :class:`~repro_torch.obs.controller.OverloadController`
converts them into admission shedding and the suspend-to-disk valve.

Error-budget accounting is lifetime: ``budget()`` reports events, bad
events, the allowed budget at the current event count, and the remaining
fraction — negative remaining means the service has formally blown its
SLO for the run.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.windows import RollingSum

__all__ = ["BurnAlarm", "SLOMonitor", "SLOPolicy"]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The objective: ``objective`` of completed jobs must be *good*.

    A job is good when its turnaround is within ``p99_turnaround_s``; a
    deadline-carrying job is judged by its deadline instead when
    ``use_deadlines`` is set (best-effort jobs still fall back to the
    turnaround target).
    """

    p99_turnaround_s: float
    objective: float = 0.99
    use_deadlines: bool = False

    def __post_init__(self):
        if self.p99_turnaround_s <= 0:
            raise ValueError("p99_turnaround_s must be > 0")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )

    @property
    def budget_fraction(self) -> float:
        """Allowed bad fraction: 1 - objective."""
        return 1.0 - self.objective

    def is_good(
        self, turnaround_s: float, met_deadline: bool | None = None
    ) -> bool:
        if self.use_deadlines and met_deadline is not None:
            return met_deadline
        return turnaround_s <= self.p99_turnaround_s


class SLOMonitor:
    """Multi-window burn-rate alarm over a completion stream.

    Drive it with :meth:`observe` on every completion and :meth:`update`
    whenever a control decision is due; ``update`` returns a
    :class:`BurnAlarm` exactly at trip/clear transitions and ``None``
    otherwise.  All times are sim time.
    """

    def __init__(
        self,
        slo: SLOPolicy,
        *,
        fast_window_s: float = 30.0,
        slow_window_s: float = 120.0,
        trip_burn: float = 2.0,
        clear_burn: float = 1.0,
        min_events: int = 12,
        n_buckets: int = 8,
    ):
        if slow_window_s <= fast_window_s:
            raise ValueError(
                f"slow window ({slow_window_s}s) must exceed the fast "
                f"window ({fast_window_s}s)"
            )
        if not 0 < clear_burn <= trip_burn:
            raise ValueError(
                f"need 0 < clear_burn <= trip_burn, got "
                f"({clear_burn}, {trip_burn})"
            )
        self.slo = slo
        self.trip_burn = float(trip_burn)
        self.clear_burn = float(clear_burn)
        self.min_events = int(min_events)
        self._fast_bad = RollingSum(fast_window_s, n_buckets)
        self._fast_all = RollingSum(fast_window_s, n_buckets)
        self._slow_bad = RollingSum(slow_window_s, n_buckets)
        self._slow_all = RollingSum(slow_window_s, n_buckets)
        self.tripped = False
        self.alarms: list[BurnAlarm] = []
        self.n_events = 0
        self.n_bad = 0

    # ---- feeding ---------------------------------------------------------

    def observe(
        self,
        t: float,
        turnaround_s: float,
        met_deadline: bool | None = None,
    ) -> None:
        good = self.slo.is_good(turnaround_s, met_deadline)
        bad = 0.0 if good else 1.0
        self._fast_all.observe(t, 1.0)
        self._slow_all.observe(t, 1.0)
        if bad:
            self._fast_bad.observe(t, 1.0)
            self._slow_bad.observe(t, 1.0)
        self.n_events += 1
        self.n_bad += int(bad)

    # ---- queries ---------------------------------------------------------

    def _burn(self, bad: RollingSum, all_: RollingSum, now: float) -> float:
        n = all_.total(now)
        if n <= 0:
            return 0.0
        return (bad.total(now) / n) / self.slo.budget_fraction

    def burn_rates(self, now: float) -> tuple[float, float]:
        """(fast, slow) burn: windowed bad fraction over budget fraction.
        Burn 1.0 consumes budget exactly as fast as the SLO allows."""
        return (
            self._burn(self._fast_bad, self._fast_all, now),
            self._burn(self._slow_bad, self._slow_all, now),
        )

    def budget(self) -> dict:
        """Lifetime error-budget account at the current event count."""
        allowed = self.slo.budget_fraction * self.n_events
        return {
            "events": self.n_events,
            "bad_events": self.n_bad,
            "allowed_bad": allowed,
            "remaining": allowed - self.n_bad,
            "remaining_frac": (
                (allowed - self.n_bad) / allowed if allowed > 0 else 1.0
            ),
        }

    # ---- alarm state machine --------------------------------------------

    def update(self, now: float) -> BurnAlarm | None:
        """Advance the trip/clear state machine; return the transition
        alarm when one fires.

        Trip: both burns above ``trip_burn`` with at least ``min_events``
        completions in the fast window (a near-empty window is noise, not
        an overload).  Clear: both burns back below ``clear_burn`` — the
        budget is recovering — with no event-count gate, since an empty
        window after an overload *is* recovery.
        """
        fast, slow = self.burn_rates(now)
        if not self.tripped:
            if (
                fast > self.trip_burn
                and slow > self.trip_burn
                and self._fast_all.total(now) >= self.min_events
            ):
                self.tripped = True
                return self._alarm(now, "trip", fast, slow)
        elif fast < self.clear_burn and slow < self.clear_burn:
            self.tripped = False
            return self._alarm(now, "clear", fast, slow)
        return None

    def _alarm(
        self, now: float, event: str, fast: float, slow: float
    ) -> BurnAlarm:
        alarm = BurnAlarm(
            t=float(now),
            event=event,
            burn_fast=fast,
            burn_slow=slow,
            budget_remaining_frac=self.budget()["remaining_frac"],
            n_events=self.n_events,
        )
        self.alarms.append(alarm)
        return alarm

    def to_dict(self) -> dict:
        return {
            "slo": dataclasses.asdict(self.slo),
            "tripped": self.tripped,
            "trip_burn": self.trip_burn,
            "clear_burn": self.clear_burn,
            "fast_window_s": self._fast_all.window_s,
            "slow_window_s": self._slow_all.window_s,
            "n_alarms": len(self.alarms),
            "alarms": [dataclasses.asdict(a) for a in self.alarms],
            "budget": self.budget(),
        }


@dataclasses.dataclass(frozen=True)
class BurnAlarm:
    """One burn-rate state transition (trip or clear)."""

    t: float
    event: str                    #: "trip" | "clear"
    burn_fast: float
    burn_slow: float
    budget_remaining_frac: float
    n_events: int
