"""Length-prefixed MessagePack-over-TCP RPC (port of the reference's
``multihost/rpc.py``; no torch).

Frame = 4-byte big-endian payload length + MessagePack payload, written
by the port's own codec (``checkpoint/msgpack_codec.py``), byte for byte
what the reference's ``msgpack.packb(obj, use_bin_type=True)`` writes, so
the two packages' coordinators and workers talk to each other.  Requests
are ``{"method": str, **params}``; responses are ``{"ret": ...}`` or
``{"err": str}``.  Raw numpy buffers travel as binary fields inside the
payload (see ``wire.pack_rows``): no base64, no copies beyond the socket.

Failure semantics are NAMED, never a hang:

* ``WorkerDied``  — connection refused/reset, or the peer closed the
  socket cleanly between frames (and, on the client, the tracked worker
  process has exited).  Raised after the bounded retries are exhausted.
* ``RpcTimeout``  — no bytes within the per-call timeout, after retries.
* ``TornFrame``   — the peer closed mid-frame (header or payload
  truncated short of the declared length) or sent an undecodable
  payload; the partial frame is REJECTED, never half-decoded.
* ``RemoteError`` — the handler raised; deterministic, never retried.

``RpcClient.call`` retries ``retries`` times on transport failures
(reconnecting each attempt: every shard RPC is idempotent, gathers are
reads and scatters rewrite the same rows), then raises the named error.
``socket_bytes`` counts whole frames (payload + 4-byte prefix) both
directions: the envelope overhead reported next to the priced payload
bytes.
"""

from __future__ import annotations

import socket
import struct
import threading

from repro_torch.checkpoint.msgpack_codec import pack, unpackb

# 1 GiB frame cap: a corrupt or hostile length prefix must not drive a
# multi-GiB allocation before the torn-frame check can fire
MAX_FRAME_BYTES = 1 << 30


class RpcError(RuntimeError):
    pass


class WorkerDied(RpcError):
    pass


class RpcTimeout(RpcError):
    pass


class TornFrame(RpcError):
    pass


class RemoteError(RpcError):
    pass


def send_frame(sock: socket.socket, obj) -> int:
    """Send one frame; returns bytes written (payload + prefix)."""
    parts: list = []
    pack(obj, parts.append)
    n = sum(memoryview(p).nbytes for p in parts)
    sock.sendall(b"".join([struct.pack(">I", n), *parts]))
    return n + 4


def _recv_upto(sock: socket.socket, n: int) -> memoryview:
    """Up to ``n`` bytes, stopping early only on EOF."""
    buf = memoryview(bytearray(n))
    got = 0
    while got < n:
        try:
            k = sock.recv_into(buf[got:])
        except TimeoutError:
            raise RpcTimeout(
                f"no bytes within the socket timeout "
                f"({got}/{n} received)") from None
        if not k:
            break
        got += k
    return buf[:got]


def recv_frame(sock: socket.socket):
    """One frame -> ``(decoded_obj, frame_bytes)``.

    A clean close BETWEEN frames raises ``WorkerDied`` (the peer went
    away, nothing lost); any truncation INSIDE a frame raises
    ``TornFrame``: a partial payload is rejected whole, never decoded up
    to the tear."""
    hdr = _recv_upto(sock, 4)
    if len(hdr) == 0:
        raise WorkerDied("peer closed the connection")
    if len(hdr) < 4:
        raise TornFrame(f"frame header truncated at {len(hdr)}/4 bytes")
    (n,) = struct.unpack(">I", hdr)
    if n > MAX_FRAME_BYTES:
        raise TornFrame(f"declared frame length {n} exceeds the "
                        f"{MAX_FRAME_BYTES}-byte cap")
    payload = _recv_upto(sock, n)
    if len(payload) < n:
        raise TornFrame(f"frame payload truncated at {len(payload)}/{n} "
                        f"bytes")
    try:
        obj = unpackb(payload)
    except Exception as e:   # any malformed payload is a torn frame
        raise TornFrame(f"undecodable frame payload: {e}") from None
    return obj, n + 4


class RpcClient:
    """One persistent connection to a worker, with bounded retries.

    ``proc`` (optional ``subprocess.Popen``) is polled on failure so the
    raised error names a dead process instead of a generic reset."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 10.0,
                 retries: int = 2, name: str = "worker", proc=None):
        self.addr = (host, port)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.name = name
        self.proc = proc
        self.socket_bytes = 0
        self._sock: socket.socket | None = None

    def _connect(self) -> None:
        s = socket.create_connection(self.addr, timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(self, method: str, **params):
        req = {"method": method, **params}
        last_err: Exception | None = None
        for _attempt in range(self.retries + 1):
            try:
                if self._sock is None:
                    self._connect()
                self.socket_bytes += send_frame(self._sock, req)
                resp, nbytes = recv_frame(self._sock)
                self.socket_bytes += nbytes
                if "err" in resp:
                    raise RemoteError(f"worker {self.name!r}: {method}: "
                                      f"{resp['err']}")
                return resp.get("ret")
            except RemoteError:
                raise      # handler bug: deterministic, retrying is noise
            except (WorkerDied, TornFrame, RpcTimeout, OSError) as e:
                self.close()
                last_err = e
        dead = self.proc is not None and self.proc.poll() is not None
        where = f"{self.addr[0]}:{self.addr[1]}"
        msg = (f"worker {self.name!r} ({where}): {method!r} failed after "
               f"{self.retries + 1} attempt(s): {last_err}"
               + (f" [process exited with code {self.proc.returncode}]"
                  if dead else ""))
        if isinstance(last_err, RpcTimeout) and not dead:
            raise RpcTimeout(msg) from last_err
        raise WorkerDied(msg) from last_err


class _Shutdown(Exception):
    """Raised by a handler to stop the server after the reply is sent."""


class RpcServer:
    """Threaded accept loop over a ``{method: fn(**params)}`` table.

    One handler thread per connection; dispatch is serialized under one
    lock (handlers mutate shared numpy shards in place).  A handler
    raising ``_Shutdown`` stops the whole server after its reply frame
    goes out: the worker's ``shutdown`` RPC."""

    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 0):
        self.handlers = dict(handlers)
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def _handle_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                try:
                    req, _ = recv_frame(conn)
                except (WorkerDied, TornFrame, RpcTimeout, OSError):
                    return          # peer gone or torn: drop the conn
                stop = False
                try:
                    with self._lock:
                        method = req.get("method")
                        fn = self.handlers.get(method)
                        if fn is None:
                            resp = {"err": f"unknown method {method!r}"}
                        else:
                            params = {k: v for k, v in req.items()
                                      if k != "method"}
                            resp = {"ret": fn(**params)}
                except _Shutdown:
                    resp, stop = {"ret": None}, True
                except Exception as e:   # surfaced as RemoteError
                    resp = {"err": f"{type(e).__name__}: {e}"}
                try:
                    send_frame(conn, resp)
                except OSError:
                    return
                if stop:
                    self._stop.set()
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except TimeoutError:
                    continue
                except OSError:
                    return
                t = threading.Thread(target=self._handle_conn, args=(conn,),
                                     daemon=True)
                t.start()
        finally:
            try:
                self._srv.close()
            except OSError:
                pass

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
