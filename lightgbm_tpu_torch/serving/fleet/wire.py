"""Binary wire protocol of the serving fleet — no pickle on the wire.

Port of ``lightgbm_tpu/serving/fleet/wire.py``: the same frames, byte for
byte, so a client of either package talks to a server of either.  The
port's ``ServingClient`` opens with a binary ``OP_PING`` (protocol
negotiation); a pickle server (the threaded ``PredictionServer`` of either
package) reads the header as a giant length prefix, names the mismatch and
closes, and the client falls back to pickle framing.  The fleet gateway
that answers in kind is not ported yet (ROADMAP.md Queue A, "serving and
lifecycle").

Frame header (32 bytes, little-endian)::

    magic      4s   b"LGBT"
    version    u8   protocol version (1)
    opcode     u8   OP_* below
    flags      u16  FLAG_* bits
    trace_id   16s  NUL-padded ASCII request id ("" = none)
    length     u64  payload byte count

Payloads:

  * ``OP_PREDICT`` request — ``<IIH`` (n_rows, n_features, name_len) +
    UTF-8 model name + raw little-endian **float32** row block
    (n_rows x n_features, C order).  ``FLAG_RAW_SCORE`` asks for raw
    scores.
  * ``OP_PREDICT`` response (``FLAG_RESP``) — ``<II`` (n_rows, k) + raw
    little-endian **float64** scores.
  * ``OP_SHED`` / ``OP_ERROR`` responses and every other op — a UTF-8
    JSON object.  Typed data only; nothing on this path ever unpickles.

Corrupt input: the header is untrusted.  A bad magic/version or a length
past ``max_bytes`` raises ``WireError`` before any payload allocation;
after a corrupt header the stream has no resync point, so the defined
behavior is to close the connection.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...io.net import DEFAULT_MAX_FRAME_BYTES, _recv_exact

MAGIC = b"LGBT"
WIRE_VERSION = 1

_HDR = struct.Struct("<4sBBH16sQ")          # magic, ver, op, flags, tid, len
_PREDICT_REQ = struct.Struct("<IIH")        # n_rows, n_features, name_len
_PREDICT_RESP = struct.Struct("<II")        # n_rows, k

HEADER_SIZE = _HDR.size                     # 32

# opcodes (request and response share the opcode; FLAG_RESP marks the
# direction, OP_SHED/OP_ERROR are response-only)
OP_PREDICT = 1
OP_PING = 2
OP_HEALTH = 3
OP_METRICS = 4
OP_STATS = 5
OP_SWAP = 6
OP_SHUTDOWN = 7
OP_SHED = 8
OP_ERROR = 9

FLAG_RESP = 1 << 0
FLAG_RAW_SCORE = 1 << 1

OP_NAMES = {OP_PREDICT: "predict", OP_PING: "ping", OP_HEALTH: "health",
            OP_METRICS: "metrics", OP_STATS: "stats", OP_SWAP: "swap",
            OP_SHUTDOWN: "shutdown", OP_SHED: "shed", OP_ERROR: "error"}


class WireError(ConnectionError):
    """Corrupt or oversize binary frame.  A ``ConnectionError`` subclass
    because the only safe reaction is dropping the connection: after a
    bad fixed-size header there is no way to find the next frame
    boundary in the stream."""


def _json_default(obj):
    # reports carry numpy scalars (latency percentiles etc.)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def pack_frame(opcode: int, payload: bytes = b"", flags: int = 0,
               trace_id: str = "") -> bytes:
    tid = (trace_id or "").encode("ascii", "replace")[:16]
    return _HDR.pack(MAGIC, WIRE_VERSION, opcode, flags, tid,
                     len(payload)) + payload


def unpack_header(header: bytes,
                  max_bytes: int = DEFAULT_MAX_FRAME_BYTES
                  ) -> Tuple[int, int, str, int]:
    """Validate a 32-byte header → (opcode, flags, trace_id, length).

    Every check runs BEFORE the payload exists: a corrupt or malicious
    header can never drive an allocation (`io/net.py` gives the pickle
    path the same guarantee)."""
    magic, ver, opcode, flags, tid, length = _HDR.unpack(header)
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r} — not a wire frame "
                        f"(close and resynchronize by reconnecting)")
    if ver != WIRE_VERSION:
        raise WireError(f"unsupported wire version {ver} "
                        f"(this side speaks {WIRE_VERSION})")
    if opcode not in OP_NAMES:
        raise WireError(f"unknown opcode {opcode}")
    if max_bytes > 0 and length > max_bytes:
        raise WireError(
            f"frame length {length} exceeds max_frame_bytes {max_bytes} — "
            f"corrupt header or protocol mismatch")
    return opcode, flags, tid.rstrip(b"\x00").decode("ascii", "replace"), \
        int(length)


# -- JSON payloads (every non-predict op) ------------------------------------

def encode_json(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, default=_json_default,
                      separators=(",", ":")).encode("utf-8")


def decode_json(payload: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed JSON payload: {e}") from None
    if not isinstance(obj, dict):
        raise WireError("JSON payload is not an object")
    return obj


# -- predict payloads --------------------------------------------------------

def encode_predict_request(X: np.ndarray, model: str = "default") -> bytes:
    """Raw float32 row block: ``<IIH`` + name + C-order rows."""
    X = np.ascontiguousarray(np.atleast_2d(X), dtype=np.float32)
    name = model.encode("utf-8")
    return _PREDICT_REQ.pack(X.shape[0], X.shape[1], len(name)) + name + \
        X.tobytes()


def decode_predict_request(payload: bytes) -> Tuple[np.ndarray, str]:
    if len(payload) < _PREDICT_REQ.size:
        raise WireError("truncated predict request payload")
    n, f, nlen = _PREDICT_REQ.unpack_from(payload)
    ofs = _PREDICT_REQ.size
    want = ofs + nlen + n * f * 4
    if len(payload) != want:
        raise WireError(f"predict payload size mismatch: header promises "
                        f"{want} bytes, frame carries {len(payload)}")
    name = payload[ofs:ofs + nlen].decode("utf-8", "replace") or "default"
    X = np.frombuffer(payload, dtype="<f4", count=n * f,
                      offset=ofs + nlen).reshape(n, f)
    return X.astype(np.float64), name


def encode_predict_response(scores: np.ndarray) -> bytes:
    """``<II`` (n_rows, k) + float64 scores (k=1 → flat vector)."""
    s = np.asarray(scores, dtype="<f8")
    if s.ndim == 1:
        n, k = s.shape[0], 1
    else:
        n, k = s.shape
    return _PREDICT_RESP.pack(n, k) + np.ascontiguousarray(s).tobytes()


def decode_predict_response(payload: bytes) -> np.ndarray:
    if len(payload) < _PREDICT_RESP.size:
        raise WireError("truncated predict response payload")
    n, k = _PREDICT_RESP.unpack_from(payload)
    want = _PREDICT_RESP.size + n * k * 8
    if len(payload) != want:
        raise WireError(f"predict response size mismatch: header promises "
                        f"{want} bytes, frame carries {len(payload)}")
    s = np.frombuffer(payload, dtype="<f8", count=n * k,
                      offset=_PREDICT_RESP.size)
    return s.copy() if k == 1 else s.reshape(n, k).copy()


# -- blocking socket helpers (client side + tests) ---------------------------

def send_wire_frame(sock, opcode: int, payload: bytes = b"",
                    flags: int = 0, trace_id: str = "") -> None:
    sock.sendall(pack_frame(opcode, payload, flags, trace_id))


def recv_wire_frame(sock, max_bytes: int = DEFAULT_MAX_FRAME_BYTES
                    ) -> Tuple[int, int, str, bytes]:
    """Blocking receive of one frame → (opcode, flags, trace_id, payload).
    The header is validated (magic/version/length guard) before the
    payload is read, so ``max_bytes`` bounds every allocation."""
    opcode, flags, tid, length = unpack_header(
        _recv_exact(sock, HEADER_SIZE), max_bytes)
    payload = _recv_exact(sock, length) if length else b""
    return opcode, flags, tid, payload


def error_frame(message: str, trace_id: str = "") -> bytes:
    return pack_frame(OP_ERROR, encode_json({"error": message}),
                      FLAG_RESP, trace_id)


def shed_frame(inflight: int, capacity: int, trace_id: str = "",
               model: str = "", scope: str = "") -> bytes:
    """Structured overload answer.  ``model`` names the shed tenant and
    ``scope`` distinguishes a per-tenant-cap shed (``"tenant"``) from a
    global-capacity one (empty), so clients and log scrapers can tell
    WHOSE budget burned."""
    body = {"error": "overloaded", "shed": True,
            "inflight": int(inflight), "capacity": int(capacity)}
    if model:
        body["model"] = model
    if scope:
        body["scope"] = scope
    return pack_frame(OP_SHED, encode_json(body), FLAG_RESP, trace_id)


def response_to_dict(opcode: int, flags: int, trace_id: str,
                     payload: bytes) -> Dict[str, Any]:
    """Normalize a binary RESPONSE frame into the dict shape the pickle
    protocol uses, so ``ServingClient`` shares one result path (shed →
    ``ServerOverloaded``, error → ``RuntimeError``) across protocols."""
    if opcode == OP_SHED:
        resp = decode_json(payload)
        resp.setdefault("ok", False)
    elif opcode == OP_ERROR:
        resp = {"ok": False, "error": decode_json(payload).get("error")}
    elif opcode == OP_PREDICT:
        resp = {"ok": True, "scores": decode_predict_response(payload)}
    else:
        resp = decode_json(payload) if payload else {}
        resp.setdefault("ok", True)
    if trace_id:
        resp.setdefault("trace_id", trace_id)
    return resp
