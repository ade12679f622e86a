"""The action server's wire protocol: the port's own copy of
``send_msg``, ``ProtocolError`` and ``recv_msg`` of
``blurr_tpu/serving/server.py``.

Both directions: a 4-byte big-endian length, then UTF-8 JSON. A test holds
the bytes ``send_msg`` writes to the JAX package's, so either package's
client drives either server.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional


def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


# generous bound for a base64 camera frame + metadata; rejects hostile
# length prefixes before buffering (a 0xFFFFFFFF header would otherwise
# allocate 4 GiB per connection)
MAX_MSG_BYTES = 64 * 1024 * 1024


class ProtocolError(ValueError):
    """Malformed wire data. ``recoverable`` says whether the stream is
    still framed (bad JSON in a complete frame) or lost (oversized length
    prefix whose payload was never consumed)."""

    def __init__(self, msg: str, recoverable: bool):
        super().__init__(msg)
        self.recoverable = recoverable


def recv_msg(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_MSG_BYTES:
        raise ProtocolError(
            f"frame length {length} exceeds MAX_MSG_BYTES={MAX_MSG_BYTES}",
            recoverable=False,
        )
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        # the frame was fully consumed — the connection can keep serving
        raise ProtocolError(f"invalid JSON payload: {exc}", recoverable=True)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()  # linear-time accumulate (bytes += is O(n^2))
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)
