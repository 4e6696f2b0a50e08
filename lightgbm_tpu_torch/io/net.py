"""Length-prefixed pickle frames: the serving RPC's wire unit.

Port of the framing of ``lightgbm_tpu/io/net.py`` (``send_frame``,
``recv_frame`` and their guards), byte for byte, so a client of either
package talks to a server of either.  A frame is an 8-byte little-endian
length and a pickle.  The JAX package's ``SocketNet`` (the TCP mesh of
multi-machine dataset construction) is not ported: ROADMAP.md Queue A,
"multi-GPU and multi-host".

The length prefix is untrusted input: a length past ``max_bytes`` raises
before any allocation, and a binary wire-protocol header
(`serving/fleet/wire.py`, magic ``LGBT``) is named as the protocol
mismatch it is, which the client's protocol negotiation relies on.  The
``net.recv.corrupt_len`` fault point (`reliability/faults.py`) drives the
guard in tests.
"""

from __future__ import annotations

import pickle
import socket
import struct

from ..reliability import faults
from ..reliability.metrics import rel_inc

_LEN = struct.Struct("<Q")

# frame-size guard: anything past this default is a corrupt length prefix,
# not data.  Configurable per call.
DEFAULT_MAX_FRAME_BYTES = 256 << 20


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload) -> None:
    """8-byte little-endian length + pickle."""
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def recv_frame(sock: socket.socket,
               max_bytes: int = DEFAULT_MAX_FRAME_BYTES):
    """Receive one frame.  Anything above ``max_bytes`` raises a
    ``ConnectionError`` naming both numbers instead of attempting the
    allocation; a binary wire-protocol header (magic ``LGBT``) raises one
    naming the protocol mismatch.  Either way the stream has no resync
    point after a bad prefix: the caller must close."""
    raw = _recv_exact(sock, _LEN.size)
    (ln,) = _LEN.unpack(raw)
    f = faults.fire("net.recv.corrupt_len")
    if f is not None:
        ln = int(f.get("len", 1 << 62))
    if raw[:4] == b"LGBT":
        rel_inc("net.frames_rejected_protocol_mismatch")
        raise ConnectionError(
            "binary wire-protocol frame received on a pickle channel — "
            "protocol mismatch (peer speaks serving/fleet/wire.py framing)")
    if max_bytes > 0 and ln > max_bytes:
        rel_inc("net.frames_rejected_oversize")
        raise ConnectionError(
            f"frame length {ln} exceeds max_frame_bytes {max_bytes} — "
            f"corrupt length prefix or peer protocol mismatch")
    return pickle.loads(_recv_exact(sock, ln))
