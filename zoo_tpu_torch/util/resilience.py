"""Request deadlines and numeric env parsing for the serving engine
(the part of ``zoo_tpu/util/resilience.py`` the engine uses)."""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

__all__ = ["Deadline", "DeadlineExceeded", "env_float", "env_int"]

logger = logging.getLogger(__name__)


def env_float(name: str, default: float) -> float:
    """``$name`` as a float; unset, empty or malformed -> ``default``
    (malformed values warn)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("bad %s=%r; using %s", name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    return int(env_float(name, default))


class DeadlineExceeded(RuntimeError):
    """A propagated request deadline expired before the work completed.
    Terminal: another attempt can only arrive even later."""


class Deadline:
    """An absolute deadline on the local monotonic clock."""

    __slots__ = ("at",)

    def __init__(self, seconds: float):
        self.at = time.monotonic() + float(seconds)

    @classmethod
    def from_ms(cls, ms) -> Optional["Deadline"]:
        """Budget in milliseconds -> Deadline; ``None`` stays None.
        ``ms <= 0`` is an already-expired deadline."""
        if ms is None:
            return None
        return cls(float(ms) / 1000.0)

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return max(0.0, 1000.0 * self.remaining())

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"
