"""Wire framing for the fleet transport: versioned, length-prefixed frames.

A fleet connection speaks two layers:

  1. **Handshake** — on connect, each side writes an 8-byte hello
     (``MAGIC`` + big-endian version + reserved) and reads the peer's.
     A peer that is not a Synapse fleet endpoint fails the magic check;
     a peer from an incompatible release fails the version check.  Both
     fail *before* any pickle payload is exchanged, so a stray client
     can never feed bytes into ``pickle.loads``.
  2. **Frames** — every message after the handshake is one frame: a
     4-byte big-endian length prefix followed by exactly that many bytes
     of pickled payload.  The length is checked against
     ``MAX_FRAME_BYTES`` before any allocation, so a corrupt or hostile
     header cannot ask the receiver to buffer gigabytes.

Failure modes are loud and typed: a clean close between frames raises
``TransportClosed`` (the peer is gone — reap it); a close *inside* a
frame, a bad magic, or an oversized header raises ``FramingError`` (the
stream is corrupt — the connection is unusable either way).  Nothing in
this module retries or blocks forever: reads run under the socket's
timeout, and a timeout surfaces as ``TransportClosed`` too.

The payload is pickle because both ends are this repo (the coordinator
ships ``WorkerSpec``/``ScheduleBundle``s, agents ship
``EmulationReport``s) — the handshake is what keeps pickle off the wire
for strangers.  Agents should still only connect to coordinators they
trust, exactly like any multiprocessing-over-network transport.
"""
from __future__ import annotations

import pickle
import socket
import struct

MAGIC = b"SYNF"
VERSION = 1
MAX_FRAME_BYTES = 1 << 28          # 256 MiB: far above any real bundle

_HELLO = struct.Struct(">4sHH")    # magic, version, reserved
_LEN = struct.Struct(">I")


class TransportError(RuntimeError):
    """Base class for everything this layer raises."""


class FramingError(TransportError):
    """The byte stream is corrupt: truncated frame, oversized length
    header, or a peer that isn't speaking this protocol at all."""


class VersionMismatch(FramingError):
    """The peer speaks this protocol, but a different version of it."""


class TransportClosed(TransportError):
    """The peer is gone: clean EOF between frames, reset, or a read/write
    that sat past the socket timeout."""


def send_hello(sock: socket.socket) -> None:
    try:
        sock.sendall(_HELLO.pack(MAGIC, VERSION, 0))
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise TransportClosed(f"peer closed during handshake: {e}") from e


def recv_hello(sock: socket.socket) -> None:
    raw = _recv_exact(sock, _HELLO.size, what="handshake hello")
    magic, version, _ = _HELLO.unpack(raw)
    if magic != MAGIC:
        raise FramingError(
            f"peer is not a Synapse fleet endpoint: expected magic "
            f"{MAGIC!r}, got {magic!r}")
    if version != VERSION:
        raise VersionMismatch(
            f"peer speaks fleet framing v{version}, this side v{VERSION}")


def handshake(sock: socket.socket) -> None:
    """Symmetric hello exchange — both ends call this right after
    connect/accept (8 bytes each way always fit in the socket buffers,
    so send-then-recv cannot deadlock)."""
    send_hello(sock)
    recv_hello(sock)


def send_frame(sock: socket.socket, obj, *, _mangle=None) -> None:
    """Pickle ``obj`` into one length-prefixed frame.

    ``_mangle`` is a fault-injection hook (``bytes -> bytes``, length
    preserved) used by the chaos engine and the framing tests to put a
    corrupt-but-well-framed payload on the wire; production callers
    leave it None.
    """
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME_BYTES:
        raise FramingError(f"refusing to send a {len(payload)}-byte frame "
                           f"(cap {MAX_FRAME_BYTES})")
    if _mangle is not None:
        payload = _mangle(payload)
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise TransportClosed(f"peer closed while sending: {e}") from e


def recv_frame(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size, what="frame header", clean_eof=True)
    n = _LEN.unpack(head)[0]
    if n > MAX_FRAME_BYTES:
        raise FramingError(f"frame header announces {n} bytes "
                           f"(cap {MAX_FRAME_BYTES}) — corrupt stream")
    payload = _recv_exact(sock, n, what=f"{n}-byte frame payload")
    try:
        return pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 — unpickling bad bytes can raise
        # almost anything (UnpicklingError, EOFError, AttributeError...);
        # a well-framed but undecodable payload is a corrupt stream, and
        # must surface as FramingError -> PeerGone, not leak raw pickle
        # internals into the scheduler
        raise FramingError(
            f"frame payload failed to unpickle ({type(e).__name__}: {e}) "
            "— corrupt stream") from e


def _recv_exact(sock: socket.socket, n: int, *, what: str,
                clean_eof: bool = False) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (ConnectionResetError, socket.timeout, OSError) as e:
            raise TransportClosed(f"peer lost mid-{what}: {e}") from e
        if not chunk:
            if clean_eof and not buf:
                raise TransportClosed("peer closed the connection")
            raise FramingError(f"connection closed mid-{what}: got "
                               f"{len(buf)} of {n} bytes")
        buf += chunk
    return bytes(buf)
