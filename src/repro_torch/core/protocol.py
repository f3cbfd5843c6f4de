"""Wire protocol between the checkpoint coordinator and worker checkpoint threads.

Mirrors DMTCP's coordinator <-> checkpoint-thread socket messages (paper Fig. 1):
length-prefixed JSON over TCP.

  worker -> coordinator:  INTRO, READY, WRITTEN, FAILED, HEARTBEAT, BYE
  coordinator -> worker:  CKPT_REQ, COMMIT, ABORT, EXIT_REQ, PING
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Optional

# message types
INTRO = "INTRO"
CKPT_REQ = "CKPT_REQ"
READY = "READY"
WRITTEN = "WRITTEN"
COMMIT = "COMMIT"
ABORT = "ABORT"
FAILED = "FAILED"
HEARTBEAT = "HEARTBEAT"
EXIT_REQ = "EXIT_REQ"
BYE = "BYE"
PING = "PING"

_LEN = struct.Struct("<I")
MAX_MSG = 64 * 1024 * 1024


def configure(sock: socket.socket) -> socket.socket:
    """Small control messages: disable Nagle or every barrier pays ~40ms."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def send_msg(sock: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket, timeout: Optional[float] = None) -> Optional[dict]:
    """Returns None on clean EOF; raises socket.timeout on timeout."""
    sock.settimeout(timeout)
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_MSG:
        raise ValueError(f"oversized message: {n}")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode())


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def msg(kind: str, **kw) -> dict:
    kw["type"] = kind
    return kw
