"""Wire-frame integrity: CRC trailers and the one corruption exception
(counterpart of ``zoo_tpu/util/integrity.py``, the serving plane's part;
the shard-exchange data plane is not ported yet).

The serving door's frames carry a ``zlib.crc32`` trailer of the exact
payload bytes; :func:`verify_crc` checks it on receipt. A mismatch
raises :class:`FrameCorrupt` — a :class:`ConnectionError` subclass BY
DESIGN: every retry / failover / pool-invalidation path already treats
transport errors as transient, so a corrupt frame is retried on a fresh
connection instead of ever reaching a decoder. Each detection lands on
the ``zoo_wire_corrupt_frames_total`` counter.

``ZOO_WIRE_CRC`` (default on) is the kill switch; the trailer is
negotiated per connection, so a peer that never asks for it still
interoperates on the plain protocol.

Chaos seam: :func:`corrupt_seam` is the in-transit bit-flip injection
point — senders pass the outbound payload through it AFTER computing
the CRC, so an armed ``serving.wire.corrupt`` fault site simulates
corruption on the wire exactly like real bit rot would.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional

__all__ = [
    "FrameCorrupt", "frame_crc", "verify_crc", "wire_crc_enabled",
    "corrupt_seam", "corrupt_action", "flip_bit", "WIRE_CRC_ENV",
]

WIRE_CRC_ENV = "ZOO_WIRE_CRC"

# the metrics import is LAZY: resilience re-exports FrameCorrupt from
# here, so "import integrity first" must never be a circular import
_corrupt_frames = None


def _corrupt_counter():
    global _corrupt_frames
    if _corrupt_frames is None:
        from zoo_tpu_torch.obs.metrics import counter
        _corrupt_frames = counter(
            "zoo_wire_corrupt_frames_total",
            "Frames whose CRC trailer failed verification, by wire "
            "plane (serving = the ZSRV TCP door, shard = the ZSXN "
            "data plane). Each one is a caught would-have-been "
            "garbage decode: the frame was dropped and the transfer "
            "retried on a fresh connection.",
            labels=("plane",))
    return _corrupt_frames


def wire_crc_enabled() -> bool:
    """Whether this process wants CRC trailers on its wire frames
    (``ZOO_WIRE_CRC``, default on). Read at connection time, so a test
    can toggle it per server/client."""
    return os.environ.get(WIRE_CRC_ENV, "1") not in ("0", "false", "off")


class FrameCorrupt(ConnectionError):
    """A wire frame failed its CRC check.

    A :class:`ConnectionError` on purpose: retry policies and the HA
    failover path treat it exactly like a reset — drop the (possibly
    desynchronized) connection, redial, re-send. It must NEVER be
    swallowed into a decode attempt."""


def frame_crc(buf) -> int:
    """CRC of the exact bytes that cross the transport."""
    return zlib.crc32(memoryview(buf)) & 0xFFFFFFFF


def verify_crc(buf, expected: int, plane: str,
               context: Optional[str] = None):
    """Raise :class:`FrameCorrupt` (and count it) when ``buf`` does not
    hash to ``expected``. ``plane`` labels the counter; ``context``
    names the frame for the error message."""
    got = zlib.crc32(memoryview(buf)) & 0xFFFFFFFF
    if got == (expected & 0xFFFFFFFF):
        return
    _corrupt_counter().labels(plane=plane).inc()
    raise FrameCorrupt(
        f"{plane} frame CRC mismatch"
        + (f" ({context})" if context else "")
        + f": got {got:#010x}, trailer says {expected & 0xFFFFFFFF:#010x}"
        f" over {len(buf)} byte(s) — corrupt or desynchronized stream; "
        "dropping the connection and retrying")


def flip_bit(buf, bit: int = 0) -> bytes:
    """``buf`` with one bit flipped — the canonical chaos corruption."""
    out = bytearray(buf)
    if out:
        out[(bit // 8) % len(out)] ^= 1 << (bit % 8)
    return bytes(out)


def corrupt_action(holder=None, site=None, **_ctx):
    """The ready-made fault ACTION a chaos test arms at a corruption
    seam: replaces the outbound payload with a one-bit-flipped COPY::

        inject("serving.wire.corrupt", action=corrupt_action, p=0.1)
    """
    if holder is not None:
        holder["buf"] = flip_bit(holder["buf"])


def corrupt_seam(site: str, payload):
    """The in-transit corruption injection point: unarmed, one dict
    check; an armed site's action may swap ``holder["buf"]`` for
    corrupted bytes, which the receiver's CRC check then catches."""
    from zoo_tpu_torch.util.resilience import default_injector
    if not default_injector._sites:  # the everyday fast path
        return payload
    holder = {"buf": payload}
    default_injector.fire(site, holder=holder)
    return holder["buf"]
