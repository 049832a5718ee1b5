"""Embedded Redis-protocol server for Cluster Serving (own copy of
``zoo_tpu/serving/redis_embedded.py``).

A threaded TCP server (one thread a connection) over an in-memory store,
speaking the RESP2 the serving wire protocol needs: streams (XADD,
XGROUP CREATE, XREADGROUP with COUNT and BLOCK, XACK, XLEN), hashes
(HSET, HGET, HGETALL), keys (KEYS, DEL), strings (SET, GET) and PING,
INFO, FLUSHALL. Commands are read through the client's
:class:`~zoo_tpu_torch.serving.resp.SocketReader`. A consumer group
keeps one cursor (at-most-once: XACK has nothing pending to clear).
Deployments point the same clients at a real Redis; the protocol is the
same.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from zoo_tpu_torch.serving.resp import SocketReader

_CRLF = b"\r\n"


def _encode(obj) -> bytes:
    """Python → RESP2."""
    if obj is None:
        return b"$-1\r\n"
    if isinstance(obj, bool):
        return b":1\r\n" if obj else b":0\r\n"
    if isinstance(obj, int):
        return b":" + str(obj).encode() + _CRLF
    if isinstance(obj, str):
        obj = obj.encode()
    if isinstance(obj, (bytes, bytearray)):
        return b"$" + str(len(obj)).encode() + _CRLF + bytes(obj) + _CRLF
    if isinstance(obj, (list, tuple)):
        out = b"*" + str(len(obj)).encode() + _CRLF
        return out + b"".join(_encode(o) for o in obj)
    raise TypeError(f"cannot encode {type(obj)}")


class _Ok:
    def __init__(self, msg="OK"):
        self.msg = msg


class _Err:
    def __init__(self, msg):
        self.msg = msg


class EmbeddedRedis:
    """In-memory store + RESP server. Start with ``start()``; the bound
    port is in ``.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._hashes: Dict[bytes, Dict[bytes, bytes]] = {}
        self._streams: Dict[bytes, List[Tuple[bytes, Dict[bytes, bytes]]]] \
            = {}
        self._groups: Dict[Tuple[bytes, bytes], int] = {}  # next index
        self._strings: Dict[bytes, bytes] = {}
        self._seq = 0
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EmbeddedRedis":
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(64)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self

    def stop(self):
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        reader = SocketReader(conn)
        try:
            while not self._stop.is_set():
                cmd = self._read_command(reader)
                if cmd is None:
                    return
                reply = self._dispatch(cmd)
                if isinstance(reply, _Ok):
                    conn.sendall(b"+" + reply.msg.encode() + _CRLF)
                elif isinstance(reply, _Err):
                    conn.sendall(b"-ERR " + reply.msg.encode() + _CRLF)
                else:
                    conn.sendall(_encode(reply))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    @staticmethod
    def _read_command(reader: SocketReader) -> Optional[List[bytes]]:
        """One RESP array of bulk strings (or an inline command)."""
        line = reader.line()
        if line is None:
            return None
        if not line.startswith(b"*"):
            return line.split()
        parts = []
        for _ in range(int(line[1:])):
            hdr = reader.line()
            if hdr is None or not hdr.startswith(b"$"):
                return None
            part = reader.exact(int(hdr[1:]) + 2)
            if part is None:
                return None
            parts.append(part[:-2])
        return parts

    # -- commands ---------------------------------------------------------
    def _dispatch(self, parts: List[bytes]):
        if not parts:
            return _Err("empty command")
        cmd = parts[0].upper().decode()
        fn = getattr(self, "_cmd_" + cmd.lower(), None)
        if fn is None:
            return _Err(f"unknown command '{cmd}'")
        try:
            return fn(parts[1:])
        except Exception as e:  # noqa: BLE001
            return _Err(str(e))

    def _cmd_ping(self, args):
        return _Ok("PONG")

    def _cmd_info(self, args):
        text = "# Memory\r\nused_memory:1024\r\nmaxmemory:0\r\n"
        return text.encode()

    def _cmd_flushall(self, args):
        with self._lock:
            self._hashes.clear()
            self._streams.clear()
            self._groups.clear()
            self._strings.clear()
        return _Ok()

    def _cmd_set(self, args):
        with self._lock:
            self._strings[args[0]] = args[1]
        return _Ok()

    def _cmd_get(self, args):
        with self._lock:
            return self._strings.get(args[0])

    def _cmd_xadd(self, args):
        key, idarg = args[0], args[1]
        fields = args[2:]
        with self._cv:
            self._seq += 1
            entry_id = (f"{int(time.time() * 1000)}-{self._seq}".encode()
                        if idarg == b"*" else idarg)
            kv = {fields[i]: fields[i + 1]
                  for i in range(0, len(fields), 2)}
            self._streams.setdefault(key, []).append((entry_id, kv))
            self._cv.notify_all()
        return entry_id

    def _cmd_xlen(self, args):
        with self._lock:
            return len(self._streams.get(args[0], []))

    def _cmd_xgroup(self, args):
        sub = args[0].upper()
        if sub == b"CREATE":
            key, group = args[1], args[2]
            with self._lock:
                if (key, group) in self._groups:
                    return _Err("BUSYGROUP Consumer Group name already "
                                "exists")
                # '$' starts at the end; '0' from the beginning
                start = len(self._streams.get(key, [])) \
                    if args[3] == b"$" else 0
                self._groups[(key, group)] = start
            return _Ok()
        return _Err(f"unsupported XGROUP subcommand {sub!r}")

    def _cmd_xreadgroup(self, args):
        # XREADGROUP GROUP g consumer [COUNT n] [BLOCK ms] STREAMS key >
        i = 0
        group = consumer = None
        count, block = 10, None
        keys = []
        while i < len(args):
            a = args[i].upper()
            if a == b"GROUP":
                group, consumer = args[i + 1], args[i + 2]
                i += 3
            elif a == b"COUNT":
                count = int(args[i + 1])
                i += 2
            elif a == b"BLOCK":
                block = int(args[i + 1]) / 1000.0
                i += 2
            elif a == b"STREAMS":
                keys = args[i + 1:]
                i = len(args)
            else:
                i += 1
        key = keys[0]
        deadline = None if block is None else time.monotonic() + block
        with self._cv:
            while True:
                start = self._groups.get((key, group), 0)
                entries = self._streams.get(key, [])[start:start + count]
                if entries:
                    self._groups[(key, group)] = start + len(entries)
                    out = [[key, [[eid, _flatten(kv)]
                                  for eid, kv in entries]]]
                    return out
                if deadline is None:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(timeout=remaining)

    def _cmd_xack(self, args):
        return len(args) - 2  # at-most-once group cursor: nothing pending

    def _cmd_hset(self, args):
        key = args[0]
        with self._lock:
            h = self._hashes.setdefault(key, {})
            added = 0
            for i in range(1, len(args), 2):
                if args[i] not in h:
                    added += 1
                h[args[i]] = args[i + 1]
        return added

    def _cmd_hgetall(self, args):
        with self._lock:
            h = self._hashes.get(args[0], {})
            return _flatten(h)

    def _cmd_hget(self, args):
        with self._lock:
            return self._hashes.get(args[0], {}).get(args[1])

    def _cmd_keys(self, args):
        import fnmatch
        pat = args[0].decode()
        with self._lock:
            names = [k for k in list(self._hashes) + list(self._strings)
                     + list(self._streams)]
        return [k for k in names if fnmatch.fnmatch(k.decode(), pat)]

    def _cmd_del(self, args):
        n = 0
        with self._lock:
            for k in args:
                for store in (self._hashes, self._strings, self._streams):
                    if k in store:
                        del store[k]
                        n += 1
        return n


def _flatten(kv: Dict[bytes, bytes]) -> List[bytes]:
    out: List[bytes] = []
    for k, v in kv.items():
        out.append(k)
        out.append(v)
    return out
