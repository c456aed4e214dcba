"""Structured logger for launch-layer status lines.

The launch scripts route their status lines through one level-filtered
logger while keeping the stdout text **byte-identical**: the message is
printed verbatim (no timestamp/level prefix) whenever its level passes
the threshold.

The threshold (DEBUG, INFO, WARNING or ERROR; default INFO) is set with
:func:`set_level`, not from the environment.  Each emitted line also
records a structured :func:`repro_torch.obs.trace.instant` event (cat
``"log"``) carrying the level and any keyword fields — on traced runs
the log stream lands in the same JSONL timeline as the spans.
"""

from __future__ import annotations

import sys

from . import trace

LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}
DEFAULT_LEVEL = "INFO"

_threshold = LEVELS[DEFAULT_LEVEL]


def set_level(level: str) -> None:
    """Print messages at ``level`` and above from now on."""
    global _threshold
    name = level.upper()
    if name not in LEVELS:
        raise ValueError(f"log level {level!r} not in {tuple(LEVELS)}")
    _threshold = LEVELS[name]


def log(level: str, msg: str, **fields) -> None:
    """Emit ``msg`` verbatim to stdout when ``level`` passes the
    threshold; always leave a structured instant event when tracing is
    on."""
    trace.instant(msg, cat="log", level=level, **fields)
    if LEVELS[level] >= _threshold:
        print(msg, flush=True)
        sys.stdout.flush()


def debug(msg: str, **fields) -> None:
    log("DEBUG", msg, **fields)


def info(msg: str, **fields) -> None:
    log("INFO", msg, **fields)


def warning(msg: str, **fields) -> None:
    log("WARNING", msg, **fields)


def error(msg: str, **fields) -> None:
    log("ERROR", msg, **fields)
