"""Length-prefixed pickle frames and the TCP net of dataset construction.

Port of ``lightgbm_tpu/io/net.py``, host code copied, byte for byte on the
wire, so a client of either package talks to a server of either.  A frame
is an 8-byte little-endian length and a pickle: the serving RPC's wire unit
(``send_frame``, ``recv_frame`` and their guards) and the unit of
``SocketNet``, the ``allgather`` / ``sync_min`` / ``sync_max`` seam of
``io/distributed.py`` over TCP (the role the reference's socket linkers
play, `src/network/linkers_socket.cpp:77-218`).

``SocketNet``: rank 0 listens on the first machine-list entry and every
other rank connects once; each collective is a sequence-numbered relay
through rank 0 (a star).  Every collective runs under a deadline
(``collective_deadline``, default the construction timeout); a dead or
late peer fails it with the rank named, and rank 0 broadcasts an abort
frame naming the failed rank so every survivor raises the root cause
within seconds.  Construction connects with bounded exponential backoff,
counting retries.  The ``net.send.drop`` / ``net.send.delay`` /
``net.send.truncate`` / ``net.recv.corrupt_len`` / ``net.crash`` fault
points (`reliability/faults.py`) drive those paths in tests.

The length prefix is untrusted input: a length past ``max_bytes`` raises
before any allocation, and a binary wire-protocol header
(`serving/fleet/wire.py`, magic ``LGBT``) is named as the protocol
mismatch it is, which the client's protocol negotiation relies on.  The
``net.recv.corrupt_len`` fault point (`reliability/faults.py`) drives the
guard in tests.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import time
from typing import List, Optional, Tuple

from ..reliability import faults
from ..reliability.metrics import rel_inc

_LEN = struct.Struct("<Q")
_HDR = struct.Struct("<iq")          # (rank, seq)

# control sequence numbers (regular collectives count up from 0)
HELLO_SEQ = -1
ABORT_SEQ = -2

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


def _send_msg(sock: socket.socket, rank: int, seq: int, payload) -> None:
    f = faults.fire("net.send.delay", rank)
    if f is not None:
        time.sleep(float(f.get("seconds", 1.0)))
    if faults.fire("net.send.drop", rank) is not None:
        try:
            sock.close()
        except OSError:
            pass
        raise faults.InjectedFault(
            f"injected fault net.send.drop on rank {rank}")
    if faults.fire("net.send.truncate", rank) is not None:
        # claim a full frame, deliver half, cut the socket — the peer's
        # _recv_exact sees the organic "peer closed mid-message"
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            sock.sendall(_HDR.pack(rank, seq))
            sock.sendall(_LEN.pack(len(blob)) + blob[:max(len(blob) // 2, 1)])
        finally:
            try:
                sock.close()
            except OSError:
                pass
        raise faults.InjectedFault(
            f"injected fault net.send.truncate on rank {rank}")
    sock.sendall(_HDR.pack(rank, seq))
    send_frame(sock, payload)


def _recv_msg(sock: socket.socket,
              max_bytes: int = DEFAULT_MAX_FRAME_BYTES
              ) -> Tuple[int, int, object]:
    rank, seq = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return rank, seq, recv_frame(sock, max_bytes)


class SocketNet:
    """Multi-process ``Network`` role over TCP (see module docstring).

    Usage (every process)::

        net = SocketNet(rank, num_machines, master=("host", port))
        ds = distributed_construct(net, shard, cfg, ...)
        net.close()

    ``timeout`` bounds construction (bind/connect/hello);
    ``collective_deadline`` (default ``timeout``) bounds EACH collective —
    a peer that does not produce its payload within the deadline fails the
    collective on every rank with the late rank named.
    """

    def __init__(self, rank: int, num_machines: int,
                 master: Tuple[str, int], timeout: float = 120.0,
                 collective_deadline: Optional[float] = None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        if not (0 <= rank < num_machines):
            raise ValueError(f"rank {rank} outside [0, {num_machines})")
        self.rank = int(rank)
        self.num_machines = int(num_machines)
        self._seq = 0
        self._timeout = timeout
        self._deadline = float(collective_deadline or timeout)
        self._max_frame = int(max_frame_bytes)
        self._conns: List[Optional[socket.socket]] = [None] * num_machines
        self._sock: Optional[socket.socket] = None
        self._aborted: Optional[str] = None
        if num_machines == 1:
            return
        if rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.settimeout(timeout)
            srv.bind((master[0], master[1]))
            srv.listen(num_machines)
            self._srv = srv
            for _ in range(num_machines - 1):
                try:
                    conn, _addr = srv.accept()
                except socket.timeout:
                    missing = [r for r in range(1, num_machines)
                               if self._conns[r] is None]
                    raise ConnectionError(
                        f"rank 0 timed out ({timeout}s) waiting for ranks "
                        f"{missing} to connect")
                conn.settimeout(timeout)
                try:
                    r, seq, _ = _recv_msg(conn, self._max_frame)  # hello
                except (OSError, ConnectionError, EOFError,
                        pickle.UnpicklingError) as e:
                    raise ConnectionError(
                        f"rank 0: handshake failed while awaiting a hello "
                        f"from {_addr}: {type(e).__name__}: {e}") from e
                if seq != HELLO_SEQ or not (0 < r < num_machines):
                    raise ConnectionError(f"bad hello from rank {r}")
                if self._conns[r] is not None:
                    raise ConnectionError(f"duplicate rank {r}")
                self._conns[r] = conn
        else:
            # bounded reconnect-with-backoff while rank 0 comes up (the
            # reference's TryBind/Connect loop, `linkers_socket.cpp:163-218`)
            deadline = time.monotonic() + timeout
            backoff = 0.05
            last = None
            while True:
                try:
                    s = socket.create_connection(master, timeout=timeout)
                    break
                except OSError as e:
                    last = e
                    rel_inc("net.connect_retries")
                    if time.monotonic() > deadline:
                        raise ConnectionError(
                            f"rank {rank} could not reach master "
                            f"{master}: {last}") from last
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1.0)
            s.settimeout(timeout)
            self._sock = s
            _send_msg(s, self.rank, HELLO_SEQ, None)     # hello

    # -- failure plumbing ----------------------------------------------------

    def _fail(self, msg: str) -> "ConnectionError":
        rel_inc("net.collective_failures")
        return ConnectionError(msg)

    def _recv_deadline(self, sock: socket.socket, until: float,
                       waiting_on: str, seq: int):
        """One deadline-bounded message receive; timeouts and transport
        errors become a ``ConnectionError`` naming who we waited for."""
        remaining = until - time.monotonic()
        if remaining <= 0:
            raise self._fail(
                f"collective {seq} deadline ({self._deadline:g}s) exceeded "
                f"waiting for {waiting_on}")
        try:
            sock.settimeout(remaining)
            return _recv_msg(sock, self._max_frame)
        except socket.timeout:
            raise self._fail(
                f"collective {seq} deadline ({self._deadline:g}s) exceeded "
                f"waiting for {waiting_on}") from None
        except (OSError, EOFError, pickle.UnpicklingError) as e:
            raise self._fail(
                f"collective {seq} failed: {waiting_on} is gone "
                f"({type(e).__name__}: {e})") from e

    def _abort_survivors(self, failed: str, error: str, seq: int) -> None:
        """Rank 0 only: tell every still-connected rank WHY the collective
        died so survivors raise the root cause instead of timing out."""
        payload = {"failed_rank": failed, "error": error, "seq": seq}
        for r, conn in enumerate(self._conns):
            if conn is None or r == 0:
                continue
            try:
                # drain the survivor's pending payload first: closing a
                # socket with unread received data turns the close into an
                # RST, which can discard the abort frame in flight — the
                # star protocol has at most one unread message per peer
                try:
                    conn.settimeout(0.2)
                    _recv_msg(conn, self._max_frame)
                except Exception:
                    pass        # best-effort; nothing pending is fine
                conn.settimeout(min(self._deadline, 5.0))
                _send_msg(conn, 0, ABORT_SEQ, payload)
                rel_inc("net.aborts_sent")
            except OSError:
                pass            # that rank is gone too; it will see EOF

    # -- collectives ---------------------------------------------------------

    def allgather(self, obj) -> List:
        if self.num_machines == 1:
            return [obj]
        if self._aborted:
            raise self._fail(f"network already aborted: {self._aborted}")
        seq = self._seq
        self._seq += 1
        if faults.fire("net.crash", self.rank) is not None:
            os._exit(17)        # simulated hard rank death, mid-collective
        until = time.monotonic() + self._deadline
        if self.rank == 0:
            slots: List = [None] * self.num_machines
            slots[0] = obj
            for r in range(1, self.num_machines):
                try:
                    pr, pseq, payload = self._recv_deadline(
                        self._conns[r], until, f"rank {r}", seq)
                except ConnectionError as e:
                    self._aborted = str(e)
                    self._abort_survivors(f"rank {r}", str(e), seq)
                    raise
                if pseq != seq:
                    err = (f"collective sequence mismatch: rank {pr} at "
                           f"{pseq}, master at {seq}")
                    self._aborted = err
                    self._abort_survivors(f"rank {pr}", err, seq)
                    raise self._fail(err)
                slots[pr] = payload
            bad: List[Tuple[int, Exception]] = []
            for r in range(1, self.num_machines):
                try:
                    _send_msg(self._conns[r], 0, seq, slots)
                except (OSError, ConnectionError) as e:
                    bad.append((r, e))
            if bad:
                r, e = bad[0]
                err = (f"collective {seq} result broadcast failed: rank {r} "
                       f"is gone ({e})")
                self._aborted = err
                self._abort_survivors(f"rank {r}", err, seq)
                raise self._fail(err)
            return slots
        try:
            _send_msg(self._sock, self.rank, seq, obj)
        except faults.InjectedFault:
            raise
        except (OSError, ConnectionError) as e:
            raise self._fail(
                f"collective {seq}: rank {self.rank} could not reach the "
                f"master ({type(e).__name__}: {e})") from e
        # grace past the master's own deadline: when a THIRD rank is late,
        # the master times out at `deadline` and then broadcasts the abort
        # naming it — waiting slightly longer means this rank raises that
        # root cause instead of its own less-informative timeout
        until += max(1.0, 0.25 * self._deadline)
        _pr, pseq, slots = self._recv_deadline(
            self._sock, until, "the master (rank 0)", seq)
        if pseq == ABORT_SEQ:
            rel_inc("net.aborts_received")
            info = slots if isinstance(slots, dict) else {}
            self._aborted = str(info.get("error", "unknown"))
            raise self._fail(
                f"collective aborted by the master: {info.get('failed_rank')}"
                f" failed — {info.get('error')}")
        if pseq != seq:
            raise self._fail(
                f"collective sequence mismatch: got {pseq}, expected {seq}")
        return slots

    def sync_min(self, v: int) -> int:
        return min(self.allgather(int(v)))

    def sync_max(self, v: int) -> int:
        return max(self.allgather(int(v)))

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        for c in self._conns:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        srv = getattr(self, "_srv", None)
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass

    def __enter__(self) -> "SocketNet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def parse_machine_list(path: str) -> List[Tuple[str, int]]:
    """``machine_list_filename`` format (`docs/Parallel-Learning-Guide.rst`):
    one ``ip port`` per line; the FIRST entry is the master.  Malformed
    lines raise with the file, line number and offending text named."""
    out: List[Tuple[str, int]] = []
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            ln = raw.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) < 2:
                raise ValueError(
                    f"{path}:{lineno}: expected 'ip port', got {ln!r}")
            host, port_s = parts[0], parts[1]
            try:
                port = int(port_s)
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: port {port_s!r} is not an integer "
                    f"(line: {ln!r})") from None
            if not (0 < port < 65536):
                raise ValueError(
                    f"{path}:{lineno}: port {port} outside (0, 65536) "
                    f"(line: {ln!r})")
            out.append((host, port))
    return out


def net_from_config(cfg, rank: int) -> SocketNet:
    """Build the construction-phase net from the reference's config surface
    (``num_machines`` / ``machine_list_filename`` / ``time_out``) plus the
    reliability knobs (``net_max_frame_mb`` / ``net_collective_deadline_s``
    / ``fault_spec``)."""
    if getattr(cfg, "fault_spec", ""):
        faults.arm(cfg.fault_spec)
    machines = parse_machine_list(cfg.machine_list_filename) \
        if cfg.machine_list_filename else [("127.0.0.1",
                                            int(cfg.local_listen_port))]
    if len(machines) < int(cfg.num_machines):
        raise ValueError(
            f"machine list has {len(machines)} entries but "
            f"num_machines={cfg.num_machines}")
    deadline = float(getattr(cfg, "net_collective_deadline_s", 0.0)) or None
    return SocketNet(rank, int(cfg.num_machines), master=machines[0],
                     timeout=float(cfg.time_out),
                     collective_deadline=deadline,
                     max_frame_bytes=int(getattr(cfg, "net_max_frame_mb",
                                                 256)) << 20)
