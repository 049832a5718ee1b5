"""Minimal RESP2 Redis client over a socket (own copy of
``zoo_tpu/serving/resp.py``; no redis-py dependency).

It speaks the protocol directly and works against any real Redis as
well as :class:`zoo_tpu_torch.serving.redis_embedded.EmbeddedRedis`.
One request is in flight per client (a lock around send and reply);
replies are bytes, ints, lists or ``None``, and an error reply raises
:class:`RedisError`. Replies are read through :class:`SocketReader`, in
time linear in their size (a batch of image records is tens of MB).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional

_CRLF = b"\r\n"


class SocketReader:
    """Lines and exact byte counts read from a socket: a buffer that
    grows at its end and is consumed from its front, so reading n bytes
    costs O(n) however they arrive. ``None`` once the peer closed."""

    def __init__(self, sock: socket.socket, chunk: int = 1 << 20):
        self._sock, self._chunk = sock, chunk
        self._buf = bytearray()

    def _fill(self) -> bool:
        data = self._sock.recv(self._chunk)
        self._buf += data
        return bool(data)

    def line(self) -> Optional[bytes]:
        start = 0
        while True:
            i = self._buf.find(_CRLF, start)
            if i >= 0:
                out = bytes(self._buf[:i])
                del self._buf[:i + 2]
                return out
            start = max(0, len(self._buf) - 1)
            if not self._fill():
                return None

    def exact(self, n: int) -> Optional[bytes]:
        while len(self._buf) < n:
            if not self._fill():
                return None
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class RedisClient:
    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = 30.0):
        self.host, self.port = host, int(port)
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=timeout)
        self._reader = SocketReader(self._sock)
        self._lock = threading.Lock()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    # -- protocol ---------------------------------------------------------
    def execute(self, *args):
        parts = [a if isinstance(a, (bytes, bytearray)) else
                 str(a).encode() for a in args]
        msg = [b"*" + str(len(parts)).encode() + _CRLF]
        for p in parts:
            msg += [b"$" + str(len(p)).encode() + _CRLF, bytes(p), _CRLF]
        msg = b"".join(msg)
        with self._lock:
            self._sock.sendall(msg)
            return self._read_reply()

    def _read_line(self) -> bytes:
        line = self._reader.line()
        if line is None:
            raise ConnectionError("redis connection closed")
        return line

    def _read_exact(self, n: int) -> bytes:
        out = self._reader.exact(n)
        if out is None:
            raise ConnectionError("redis connection closed")
        return out

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest
        if t == b"-":
            raise RedisError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            out = self._read_exact(n)
            self._read_exact(2)  # trailing CRLF
            return out
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"bad RESP type byte {t!r}")

    # -- helpers mirroring the redis-py surface the client code uses ------
    def ping(self):
        return self.execute("PING")

    def info(self) -> Dict[str, int]:
        raw = self.execute("INFO").decode()
        out = {}
        for line in raw.splitlines():
            if ":" in line and not line.startswith("#"):
                k, _, v = line.partition(":")
                try:
                    out[k] = int(v)
                except ValueError:
                    out[k] = v
        return out

    def xadd(self, stream: str, fields: Dict[str, str]):
        args = ["XADD", stream, "*"]
        for k, v in fields.items():
            args += [k, v]
        return self.execute(*args)

    def xgroup_create(self, stream: str, group: str, last_id: str = "$"):
        return self.execute("XGROUP", "CREATE", stream, group, last_id)

    def xreadgroup(self, group: str, consumer: str, stream: str,
                   count: int = 10, block_ms: Optional[int] = None):
        args = ["XREADGROUP", "GROUP", group, consumer, "COUNT", count]
        if block_ms is not None:
            args += ["BLOCK", block_ms]
        args += ["STREAMS", stream, ">"]
        return self.execute(*args)

    def xack(self, stream: str, group: str, *ids):
        return self.execute("XACK", stream, group, *ids)

    def hset(self, key: str, mapping: Dict[str, str]):
        args = ["HSET", key]
        for k, v in mapping.items():
            args += [k, v]
        return self.execute(*args)

    def hgetall(self, key: str) -> Dict[bytes, bytes]:
        flat = self.execute("HGETALL", key) or []
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    def keys(self, pattern: str) -> List[bytes]:
        return self.execute("KEYS", pattern) or []

    def delete(self, *keys):
        return self.execute("DEL", *keys)


class RedisError(RuntimeError):
    pass
