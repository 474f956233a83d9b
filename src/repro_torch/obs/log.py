"""Leveled structured logging for long sim runs
(counterpart of ``repro.obs.log``).

A :class:`Logger` emits either human text (``[name] message key=value``,
the shape the launch CLIs have always printed) or JSON-lines (one object
per line: ``{"logger", "level", "event", ...fields}``) — the ``--log-json``
flag on ``repro_torch.launch.cluster`` flips the mode, so
a multi-hour trace replay is machine-parseable without changing any call
site.  No handlers, no global registry, no stdlib ``logging`` config: a
logger is a plain object writing to one stream, which keeps bench CSV on
stdout and diagnostics on whatever stream the caller picked.
"""

from __future__ import annotations

import json
import sys

__all__ = ["LEVELS", "Logger", "get_logger"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class Logger:
    """One named log stream, text or JSON-lines.

    ``stream=None`` resolves to ``sys.stderr`` at call time (not at
    construction), so pytest's capture and CLI redirection both see the
    output they expect.
    """

    def __init__(
        self,
        name: str,
        *,
        level: str = "info",
        json_lines: bool = False,
        stream=None,
    ):
        if level not in LEVELS:
            raise ValueError(
                f"unknown level {level!r}; expected one of {sorted(LEVELS)}"
            )
        self.name = name
        self.level = level
        self.json_lines = bool(json_lines)
        self.stream = stream

    def _out(self):
        return self.stream if self.stream is not None else sys.stderr

    def enabled(self, level: str) -> bool:
        return LEVELS[level] >= LEVELS[self.level]

    def log(self, level: str, event: str, **fields) -> None:
        """Emit one record; ``fields`` must be JSON-representable scalars
        (or short lists) — they become ``key=value`` pairs in text mode."""
        if level not in LEVELS:
            raise ValueError(f"unknown level {level!r}")
        if not self.enabled(level):
            return
        out = self._out()
        if self.json_lines:
            rec = {"logger": self.name, "level": level, "event": event}
            rec.update(fields)
            out.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
        else:
            msg = fields.pop("msg", None)
            parts = [f"[{self.name}]", str(msg) if msg is not None else event]
            parts += [f"{k}={v}" for k, v in fields.items()]
            out.write(" ".join(parts) + "\n")
        out.flush()

    def debug(self, event: str, **fields) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields) -> None:
        self.log("info", event, **fields)

    def warning(self, event: str, **fields) -> None:
        self.log("warning", event, **fields)

    def error(self, event: str, **fields) -> None:
        self.log("error", event, **fields)


def get_logger(
    name: str,
    *,
    level: str = "info",
    json_lines: bool = False,
    stream=None,
) -> Logger:
    """Construct a :class:`Logger` (kept as a function so call sites read
    like the stdlib idiom; there is deliberately no global registry)."""
    return Logger(name, level=level, json_lines=json_lines, stream=stream)
