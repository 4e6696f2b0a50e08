"""Selector-based async gateway in front of the replica fleet.

Port of ``lightgbm_tpu/serving/fleet/gateway.py``.  One event-loop thread
owns every client socket: thousands of connections cost buffers, not
threads.  The loop accepts, reads, parses frames incrementally, applies
admission and hands complete predict requests to a replica
(`replicas.ReplicaSet`); the replicas' ``MicroBatcher`` workers, which
replay the bucket graphs on the card, answer through a cross-thread outbuf
and a socketpair wakeup, so the loop never waits on device work and device
work never touches a socket.

Three protocols on one port, decided by a connection's first 4 bytes:
``LGBT`` means binary wire frames (`wire.py`), ``GET `` or ``HEAD`` a
plain-HTTP Prometheus scrape of ``/metrics`` (one HTTP/1.0 response, then
close), anything else the pickle framing of `io/net.py`, so clients of
either package keep working and a stock Prometheus scrapes the gateway.  A
corrupt binary header follows ``wire.py``'s resync-or-close rule: an
oversize length on a well-formed header gets an error frame, then close; a
bad magic or version closes at once.

Threads: the loop thread alone owns ``_conns`` and every ``_Conn``'s
parser fields; ``_Conn.out_lock`` (a leaf) guards ``outbuf``/``closing``
for the loop and the workers; ``_pending`` (its own leaf lock) lists
connections with fresh output; replica, batcher and stats state keep their
own locks, never held while a gateway lock is.  ``stop`` joins the loop,
the snapshot thread, the lifecycle watchdog, the autopilot and every
batcher.

Tenant admission (`reliability/degrade.TenantAdmission`), the per-tenant
SLO series, the drift window (`observability/drift.py`), ``stats_out``
snapshots and ``telemetry_out`` ride the same loop.  ``promote_rolling``
prepares a candidate on every replica (a capture per bucket while the
others replay), gates it per replica with the shadow validator over the
recorded traffic and commits one replica at a time: requests in flight
ride whichever version their replica holds, so none drops during a roll or
a ``rollback_fleet``.

``health`` reports each replica's real device errors: a CUDA error is
sticky to the process's context on its card, so the replicas sharing that
card keep failing and re-admission after ``recovery_s`` cannot clear it;
the gateway is then not ready until the process restarts.
"""

from __future__ import annotations

import contextlib
import pickle
import selectors
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_NULL_CTX = contextlib.nullcontext()

from ...io.net import DEFAULT_MAX_FRAME_BYTES, _LEN
from ...lifecycle.recorder import TrafficRecorder
from ...lifecycle.shadow import shadow_validate
from ...observability.drift import DriftMonitor
from ...observability.trace import TraceRecorder, new_trace_id
from ...reliability import faults
from ...reliability.degrade import AdmissionController, TenantAdmission
from ...reliability.metrics import rel_inc
from ..batcher import ServingStats
from . import wire
from .replicas import ReplicaSet

_RECV_CHUNK = 1 << 16


class _Conn:
    """Per-connection state.  Parser fields (``inbuf``, ``protocol``)
    are loop-thread-only; ``outbuf``/``closing`` are shared with worker
    threads under ``out_lock`` (a leaf lock)."""

    __slots__ = ("sock", "inbuf", "outbuf", "out_lock", "protocol",
                 "closing")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.out_lock = threading.Lock()
        self.protocol: Optional[str] = None     # None until sniffed
        self.closing = False                    # flush outbuf, then close


class FleetServer:
    """Async front end + replica fleet; drop-in surface for
    ``PredictionServer`` (start/stop/wait/report/port) plus the fleet
    ops (``promote_rolling``/``rollback_fleet``, per-replica stats).
    A CPU booster's replicas serve on the CPU, any other's on every card
    (round-robin)."""

    def __init__(self, booster=None, replicas: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch_rows: int = 256, deadline_ms: float = 2.0,
                 min_bucket: int = 32, warmup: bool = True,
                 telemetry_out: str = "", request_timeout: float = 60.0,
                 max_inflight: int = 64, trace: bool = False,
                 trace_out: str = "", trace_capacity: int = 65536,
                 stats_out: str = "", stats_interval_s: float = 10.0,
                 record_rows: int = 0, recovery_s: float = 1.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 slo_p99_ms: float = 50.0, slo_target: float = 0.99,
                 drift_psi_threshold: float = 0.2,
                 drift_ks_threshold: float = 0.15,
                 drift_min_rows: int = 32,
                 tenant_max_inflight: int = 0,
                 drift_baseline_path: str = ""):
        self.host = host
        self.port = int(port)
        self.request_timeout = float(request_timeout)
        self.max_frame_bytes = int(max_frame_bytes)
        self.telemetry_out = telemetry_out
        self.admission = AdmissionController(max_inflight)
        # per-tenant caps (0 = derive from the global cap: a single
        # tenant may use the whole capacity; set lower to isolate)
        self.tenant_admission = TenantAdmission(
            tenant_max_inflight if tenant_max_inflight > 0
            else max_inflight)
        self.stats = ServingStats(slo_p99_ms=slo_p99_ms,
                                  slo_target=slo_target)
        self.tracer: Optional[TraceRecorder] = None
        if trace or trace_out:
            self.tracer = TraceRecorder(True, capacity=trace_capacity)
            self.stats.attach_tracer(self.tracer)
        self.trace_out = trace_out
        self.stats_out = stats_out
        self.stats_interval_s = float(stats_interval_s)
        self.recorder = TrafficRecorder(record_rows)
        # drift detection over the recorder window (observability/
        # drift.py): a no-op until a baseline is captured, which only
        # happens when the recorder is enabled — telemetry off keeps the
        # request path free of any drift work
        self.drift = DriftMonitor(psi_threshold=drift_psi_threshold,
                                  ks_threshold=drift_ks_threshold,
                                  min_rows=drift_min_rows,
                                  tracer=self.tracer)
        # baselines persisted alongside the model artifact survive a
        # gateway restart — without this, a restart silently disables
        # drift detection until the next promotion recaptures
        self.drift_baseline_path = drift_baseline_path
        if drift_baseline_path and self.recorder.enabled:
            try:
                self.drift.restore(drift_baseline_path)
            except Exception as e:
                rel_inc("drift.baseline_restore_errors")
                print(f"[lightgbm_tpu_torch] [Warning] drift baseline restore "
                      f"failed: {e}", flush=True)
        self.lifecycle = None
        self.autopilot = None
        # a booster the caller put on the CPU (device_type=cpu) serves
        # there; otherwise the replicas take the cards
        devices = None
        if booster is not None and booster.gbdt.device.type == "cpu":
            devices = [booster.gbdt.device]
        self.replicas = ReplicaSet(
            stats=self.stats, replicas=replicas, devices=devices,
            max_batch_rows=max_batch_rows, deadline_ms=deadline_ms,
            min_bucket=min_bucket, warmup=warmup, recovery_s=recovery_s)
        self.buckets = self.replicas.buckets
        if booster is not None:
            self.replicas.load("default", booster=booster)
        self._sel: Optional[selectors.BaseSelector] = None
        self._srv: Optional[socket.socket] = None
        self._wake_r: Optional[socket.socket] = None
        self._wake_w: Optional[socket.socket] = None
        self._conns: Dict[socket.socket, _Conn] = {}
        self._pending_lock = threading.Lock()
        self._pending: List[_Conn] = []
        self._thread: Optional[threading.Thread] = None
        self._stats_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._promote_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetServer":
        # a fault spec in LGBT_FAULTS is read (and a refused point raises)
        # here, not in the first batch
        faults.load()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self.port))
            srv.listen(128)
            # the selector loop IS the timeout discipline: non-blocking
            # sockets can never park a thread in recv/accept
            srv.setblocking(False)
            self.port = srv.getsockname()[1]
            self._srv = srv
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            self._wake_w.setblocking(False)
            self._sel = selectors.DefaultSelector()
            self._sel.register(srv, selectors.EVENT_READ, "accept")
            self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        except Exception:
            # close-on-error-path: a failed bind/register must not leak
            # the listener, the wakeup pair or the selector — the loop's
            # finally never runs because the loop never starts
            self._close_io()
            raise
        self._thread = threading.Thread(
            target=self._loop, name="lgbt-fleet-gateway", daemon=True)
        self._thread.start()
        if self.stats_out:
            self._stats_thread = threading.Thread(
                target=self._stats_loop, name="lgbt-fleet-stats",
                daemon=True)
            self._stats_thread.start()
        return self

    def _close_io(self) -> None:
        """Best-effort close of the loop-owned io objects — the error
        path of ``start()`` (the loop's ``finally`` owns the happy
        path)."""
        if self._sel is not None:
            try:
                self._sel.close()
            except OSError:
                pass
            self._sel = None
        for attr in ("_srv", "_wake_r", "_wake_w"):
            s = getattr(self, attr)
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
                setattr(self, attr, None)

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        if self.autopilot is not None:
            self.autopilot.stop()
        if self.lifecycle is not None:
            self.lifecycle.stop()
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._stats_thread is not None:
            # the snapshot loop wakes on the same stop event; joining it
            # here means no snapshot write can race the final one below
            self._stats_thread.join(timeout=5.0)
        self.replicas.stop()
        if self.telemetry_out:
            from ...observability import write_report
            write_report(self.report(), self.telemetry_out)
        if self.stats_out:
            self._write_stats_snapshot()
        if self.trace_out and self.tracer is not None:
            self.tracer.save(self.trace_out)
        self._stopped.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- report / snapshots --------------------------------------------------

    def report(self) -> Dict[str, Any]:
        self.stats.tel.device = self.registry.device
        rep = self.stats.report(models=self.replicas.versions(),
                                jit_entries=self.replicas.jit_entries())
        rep["serving"]["replicas"] = self.replicas.section()
        if self.lifecycle is not None:
            rep["lifecycle"] = self.lifecycle.section()
        if self.autopilot is not None:
            rep["autopilot"] = self.autopilot.section()
        drift = self.check_drift()
        if drift is not None:
            rep["drift"] = drift
        return rep

    @property
    def registry(self):
        """Replica 0's registry — the fleet's canonical view, letting
        ``LifecycleController`` (built for the single-registry server)
        bind to a fleet for refit/shadow; promotion goes through
        ``promote_rolling``, never through this registry alone."""
        return self.replicas.replicas[0].registry

    # -- drift monitoring ----------------------------------------------------

    def capture_drift_baseline(self, name: str = "default") -> bool:
        """Snapshot the current recorder window as the drift baseline
        for one model — called after every committed promotion, and
        callable by operators/tests directly.  False (nothing captured)
        when recording is off, the window is under the monitor's
        ``min_rows`` or no model by that name is live."""
        if not self.recorder.enabled:
            return False
        try:
            model = self.replicas.get(name)
        except KeyError:
            return False
        captured = self.drift.capture(model, self.recorder.snapshot())
        if captured:
            self._persist_drift_baselines()
        return captured

    def _persist_drift_baselines(self) -> None:
        """Atomic save (tmp + ``os.replace``) of every captured baseline
        so a restarted gateway resumes drift detection immediately."""
        if not self.drift_baseline_path:
            return
        try:
            self.drift.save(self.drift_baseline_path)
        except Exception as e:
            rel_inc("drift.baseline_persist_errors")
            print(f"[lightgbm_tpu_torch] [Warning] drift baseline save "
                  f"failed: {e}", flush=True)

    def check_drift(self, name: str = "default",
                    drain: bool = False) -> Optional[Dict[str, Any]]:
        """Compare the recorder window against the captured baseline →
        the ``drift`` report section (None when recording is off or no
        baseline exists — the proven telemetry-off no-op).  ``drain``
        empties the ring so consecutive checks judge disjoint windows;
        the default non-destructive snapshot keeps the window available
        for the lifecycle shadow replay."""
        if not self.recorder.enabled or not self.drift.has_baseline(name):
            return None
        try:
            model = self.replicas.get(name)
        except KeyError:
            return None
        X = self.recorder.drain() if drain else self.recorder.snapshot()
        if X.size == 0:
            return self.drift.section(name)
        return self.drift.check(model, X) or self.drift.section(name)

    def trace(self) -> Optional[Dict[str, Any]]:
        return self.tracer.export() if self.tracer is not None else None

    def _write_stats_snapshot(self) -> None:
        from ...observability import write_report
        try:
            write_report(self.report(), self.stats_out)
        except Exception as e:
            rel_inc("serve.stats_snapshot_errors")
            print(f"[lightgbm_tpu_torch] [Warning] stats snapshot failed: {e}",
                  flush=True)

    def _stats_loop(self) -> None:
        while not self._stop.wait(self.stats_interval_s):
            self._write_stats_snapshot()

    # -- fleet promotion -----------------------------------------------------

    def promote_rolling(self, name: str = "default", booster=None,
                        model_str: Optional[str] = None,
                        model_file: Optional[str] = None,
                        settle_s: float = 0.0,
                        divergence_max: float = 0.25,
                        latency_max_ratio: float = 8.0,
                        shadow_min_rows: int = 1, *,
                        prepared: Optional[Sequence] = None,
                        X: Optional[np.ndarray] = None,
                        labels: Optional[np.ndarray] = None,
                        metric: str = "",
                        metric_floor: float = float("nan")
                        ) -> Dict[str, Any]:
        """Fleet-wide promotion with a PER-REPLICA shadow gate: prepare
        (build+warm+verify) the candidate on EVERY replica off to the
        side, then commit one replica at a time, re-running the shadow
        validator on THAT replica's prepared copy against its own
        incumbent immediately before its swap.  A gate failure at
        replica 0 commits nothing; a failure mid-roll aborts and
        reverse-rolls the already-committed replicas, leaving the fleet
        homogeneous on the incumbent.  Serving is never interrupted:
        each commit (and each rollback) is an atomic registry swap and
        batchers resolve their model per batch.  Returns the structured
        outcome with every gate's report.

        The autopilot passes the candidates ``prepare_all`` already
        built (``prepared``) and the window it judges them on: ``X`` in
        place of the recording (every gate then runs, however few its
        rows) and its ``labels``, ``metric`` and ``metric_floor``, so
        replica 0's gate is the cycle's one shadow run."""
        with self._promote_lock:
            if prepared is None:
                prepared = self.replicas.prepare_all(
                    name, booster=booster, model_str=model_str,
                    model_file=model_file)
            out: Dict[str, Any] = {"model": name,
                                   "replicas": len(self.replicas)}
            explicit = X is not None
            if not explicit:
                X = self.recorder.snapshot()
            rows = int(X.shape[0]) if X.size else 0
            incumbents: Dict[int, Any] = {}
            for r in self.replicas.replicas:
                try:
                    incumbents[r.index] = r.registry.get(name)
                except KeyError:
                    pass
            gate_active = explicit or (X.size and rows >= shadow_min_rows)

            def _gate(index, model):
                inc = incumbents.get(index)
                if inc is None or not gate_active:
                    return True, {"skipped": True, "rows": rows}
                rep = shadow_validate(
                    model, inc, X, labels=labels, metric=metric,
                    metric_floor=metric_floor, divergence_max=divergence_max,
                    latency_max_ratio=latency_max_ratio,
                    min_rows=shadow_min_rows, buckets=self.buckets)
                return bool(rep["passed"]), rep

            roll = self.replicas.commit_rolling_gated(
                prepared, _gate, settle_s=settle_s, name=name)
            out["gates"] = [{"replica": g["replica"],
                             "passed": g["passed"]}
                            for g in roll["gates"]]
            out["shadow"] = (roll["gates"][0]["report"] if roll["gates"]
                             else {"skipped": True, "rows": rows})
            out["versions"] = roll["versions"]
            out["committed"] = roll["committed"]
            if not roll["committed"]:
                out["aborted_replica"] = roll["aborted_replica"]
                out["restored"] = roll["restored"]
                # mid-roll abort (something already committed, now
                # reverse-rolled) vs a clean replica-0 rejection
                rel_inc("serve.fleet_promotions_aborted"
                        if roll["restored"]
                        else "serve.fleet_promotions_rejected")
                if self.tracer is not None:
                    self.tracer.instant(
                        "fleet.roll_abort",
                        args={"model": name,
                              "replica": str(roll["aborted_replica"])})
                return out
            rel_inc("serve.fleet_promotions")
            # the traffic the new version was judged on becomes its
            # drift baseline: later windows are compared against the
            # distribution that was live at promote time
            if self.recorder.enabled and X.size:
                out["drift_baseline"] = self.drift.capture(prepared[0], X)
                self._persist_drift_baselines()
            return out

    def rollback_fleet(self, name: str = "default") -> Dict[str, Any]:
        """Re-swap every replica's retained incumbent (zero-drop for the
        same reason the roll is)."""
        with self._promote_lock:
            restored = self.replicas.rollback_all(name)
        return {"model": name, "restored": restored}

    # -- event loop ----------------------------------------------------------

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (OSError, AttributeError, BlockingIOError):
            pass                      # full pipe still wakes the selector

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                events = self._sel.select(timeout=0.25)
                for key, mask in events:
                    if key.data == "accept":
                        self._accept_ready()
                    elif key.data == "wake":
                        self._drain_wake()
                    else:
                        conn: _Conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._read_ready(conn)
                        if mask & selectors.EVENT_WRITE and \
                                conn.sock in self._conns:
                            self._write_ready(conn)
                self._apply_pending()
        finally:
            for conn in list(self._conns.values()):
                self._close_conn(conn)
            for s in (self._srv, self._wake_r, self._wake_w):
                if s is not None:
                    try:
                        self._sel.unregister(s)
                    except (KeyError, ValueError):
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass
            self._sel.close()

    def _accept_ready(self) -> None:
        while True:
            try:
                sock, _addr = self._srv.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            rel_inc("serve.fleet_connections")

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _apply_pending(self) -> None:
        """Loop-thread: pick up conns whose outbuf gained data from a
        worker thread and add EVENT_WRITE to their interest."""
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for conn in pending:
            if conn.sock not in self._conns:
                continue
            self._write_ready(conn)      # try inline; registers WRITE if short

    def _read_ready(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.inbuf.extend(data)
        try:
            self._parse(conn)
        except wire.WireError as e:
            # bad magic / version / unparseable frame: no trustable
            # frame boundary remains — close (wire.py's defined
            # resync-or-close contract)
            rel_inc("serve.fleet_wire_errors")
            self._send_bytes(conn, wire.error_frame(str(e)), close=True)
            if conn.protocol != "binary":
                self._close_conn(conn)

    def _write_ready(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        with conn.out_lock:
            buf = conn.outbuf
            while buf:
                try:
                    sent = conn.sock.send(bytes(buf[:_RECV_CHUNK]))
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    self._close_conn(conn)
                    return
                del buf[:sent]
            drained = not buf
            closing = conn.closing
        want = selectors.EVENT_READ if drained else \
            selectors.EVENT_READ | selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, want, conn)
        except (KeyError, ValueError):
            return
        if drained and closing:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if self._conns.pop(conn.sock, None) is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- response path (any thread) ------------------------------------------

    def _send_bytes(self, conn: _Conn, data: bytes,
                    close: bool = False) -> None:
        """Queue response bytes and (cross-thread) wake the selector.
        Safe from worker threads: only touches outbuf under its leaf
        lock and the pending list under its own."""
        with conn.out_lock:
            conn.outbuf.extend(data)
            if close:
                conn.closing = True
        on_loop = threading.current_thread() is self._thread
        if on_loop:
            self._write_ready(conn)
        else:
            with self._pending_lock:
                self._pending.append(conn)
            self._wake()

    def _encode_resp(self, conn: _Conn, resp: Dict[str, Any],
                     opcode: int, trace_id: str = "") -> bytes:
        """One response dict → this connection's framing."""
        if conn.protocol == "pickle":
            blob = pickle.dumps(resp, protocol=pickle.HIGHEST_PROTOCOL)
            return _LEN.pack(len(blob)) + blob
        if opcode == wire.OP_PREDICT and resp.get("ok"):
            return wire.pack_frame(
                wire.OP_PREDICT,
                wire.encode_predict_response(resp["scores"]),
                wire.FLAG_RESP, trace_id)
        if resp.get("shed"):
            return wire.shed_frame(resp.get("inflight", 0),
                                   resp.get("capacity", 0), trace_id,
                                   model=resp.get("model", ""),
                                   scope=resp.get("scope", ""))
        if not resp.get("ok", True):
            return wire.error_frame(str(resp.get("error")), trace_id)
        body = {k: v for k, v in resp.items() if k != "ok"}
        return wire.pack_frame(opcode, wire.encode_json(body),
                               wire.FLAG_RESP, trace_id)

    # -- request parsing (loop thread only) ----------------------------------

    def _parse(self, conn: _Conn) -> None:
        if conn.protocol is None:
            if len(conn.inbuf) < len(wire.MAGIC):
                return
            # three protocols, one port, one 4-byte sniff: the wire
            # magic means binary frames, an HTTP method means a plain
            # Prometheus scrape, anything else is legacy pickle framing
            head = bytes(conn.inbuf[:4])
            if head == wire.MAGIC:
                conn.protocol = "binary"
            elif head in (b"GET ", b"HEAD"):
                conn.protocol = "http"
            else:
                conn.protocol = "pickle"
        if conn.protocol == "binary":
            self._parse_binary(conn)
        elif conn.protocol == "http":
            self._parse_http(conn)
        else:
            self._parse_pickle(conn)

    def _parse_binary(self, conn: _Conn) -> None:
        while len(conn.inbuf) >= wire.HEADER_SIZE:
            opcode, flags, tid, length = wire.unpack_header(
                bytes(conn.inbuf[:wire.HEADER_SIZE]), self.max_frame_bytes)
            if len(conn.inbuf) < wire.HEADER_SIZE + length:
                return
            payload = bytes(conn.inbuf[wire.HEADER_SIZE:
                                       wire.HEADER_SIZE + length])
            del conn.inbuf[:wire.HEADER_SIZE + length]
            self._handle_binary(conn, opcode, flags, tid, payload)
            if conn.sock not in self._conns:
                return

    # upper bound on an HTTP request head: a scrape request is a few
    # hundred bytes; anything bigger is not a scraper
    _HTTP_MAX_HEAD = 16384

    def _parse_http(self, conn: _Conn) -> None:
        """The Prometheus scrape protocol: wait for one complete request
        head, answer one HTTP/1.0 response assembled from the
        fleet-aggregated snapshot, close.  Loop thread only — the page
        render is host-side string work, never a device call."""
        end = conn.inbuf.find(b"\r\n\r\n")
        if end < 0:
            if len(conn.inbuf) > self._HTTP_MAX_HEAD:
                self._close_conn(conn)
            return
        head = bytes(conn.inbuf[:end]).decode("latin-1", "replace")
        del conn.inbuf[:]
        parts = head.split("\r\n", 1)[0].split()
        method = parts[0].upper() if parts else "GET"
        path = parts[1].split("?", 1)[0] if len(parts) >= 2 else ""
        if path == "/metrics":
            status, ctype = "200 OK", "text/plain; version=0.0.4; " \
                                      "charset=utf-8"
            body = self._prometheus_page()
        else:
            status, ctype = "404 Not Found", "text/plain; charset=utf-8"
            body = "not found (scrape /metrics)\n"
        rel_inc("serve.fleet_http_scrapes")
        payload = body.encode("utf-8")
        resp = (f"HTTP/1.0 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n").encode("ascii")
        if method != "HEAD":
            resp += payload
        self._send_bytes(conn, resp, close=True)

    def _prometheus_page(self) -> str:
        """The fleet-aggregated Prometheus exposition: gateway counters
        + admission + every replica + per-tenant SLO series + drift
        gauges — the same text the binary/pickle ``metrics`` op returns."""
        from ...observability.metrics_export import prometheus_snapshot
        return prometheus_snapshot(
            self.stats, registry=self.replicas, admission=self.admission,
            replicas=self.replicas.section(),
            tenants=self.stats.tenants_section(), drift=self.drift)

    def _parse_pickle(self, conn: _Conn) -> None:
        while len(conn.inbuf) >= _LEN.size:
            (ln,) = _LEN.unpack(bytes(conn.inbuf[:_LEN.size]))
            if self.max_frame_bytes > 0 and ln > self.max_frame_bytes:
                rel_inc("net.frames_rejected_oversize")
                self._close_conn(conn)
                return
            if len(conn.inbuf) < _LEN.size + ln:
                return
            blob = bytes(conn.inbuf[_LEN.size:_LEN.size + ln])
            del conn.inbuf[:_LEN.size + ln]
            try:
                msg = pickle.loads(blob)
            except Exception:
                self._close_conn(conn)
                return
            self._handle_pickle(conn, msg)
            if conn.sock not in self._conns:
                return

    # -- op dispatch ---------------------------------------------------------

    def _handle_pickle(self, conn: _Conn, msg) -> None:
        if not isinstance(msg, dict) or "op" not in msg:
            self._send_bytes(conn, self._encode_resp(
                conn, {"ok": False, "error": "malformed request"}, 0))
            return
        op = str(msg.get("op"))
        if op == "predict":
            X = msg.get("data")
            self._predict(conn, wire.OP_PREDICT, np.asarray(X, np.float64),
                          str(msg.get("model", "default")),
                          bool(msg.get("raw_score")),
                          msg.get("trace_id") or "")
            return
        self._control(conn, op, dict(msg), opcode=0)

    def _handle_binary(self, conn: _Conn, opcode: int, flags: int,
                       tid: str, payload: bytes) -> None:
        if opcode == wire.OP_PREDICT:
            X, name = wire.decode_predict_request(payload)
            self._predict(conn, opcode, X, name,
                          bool(flags & wire.FLAG_RAW_SCORE), tid)
            return
        msg = wire.decode_json(payload) if payload else {}
        msg["op"] = wire.OP_NAMES.get(opcode, "?")
        self._control(conn, msg["op"], msg, opcode=opcode, trace_id=tid)

    def _control(self, conn: _Conn, op: str, msg: Dict[str, Any],
                 opcode: int, trace_id: str = "") -> None:
        """Non-predict ops.  Cheap ones answer inline on the loop
        thread; slow ones (swap = prepare+warm on every replica,
        shutdown = join worker threads) run on a side thread and respond
        through the cross-thread outbuf."""
        if op == "ping":
            resp = {"ok": True, "version": wire.WIRE_VERSION}
        elif op == "health":
            models = self.replicas.versions()
            healthy = sum(1 for r in self.replicas.replicas if r.healthy())
            # a real device error is sticky to its card: not ready, and
            # the replicas' re-admission after recovery_s cannot clear it
            device_errors = {str(i): e for i, e in
                             self.replicas.device_errors().items()}
            resp = {"ok": True,
                    "ready": bool(models) and not device_errors
                    and not self._stop.is_set(),
                    "models": models,
                    "versions": self.replicas.versions_detail(),
                    "replicas": len(self.replicas),
                    "replicas_healthy": healthy,
                    "device_errors": device_errors,
                    **self.admission.snapshot()}
            if device_errors:
                resp["device_errors_note"] = (
                    "a CUDA error is sticky to the process's context on "
                    "its card: every replica there keeps failing and "
                    "re-admission after recovery_s cannot clear it; "
                    "restart the server")
        elif op == "stats":
            resp = {"ok": True, "report": self.report()}
        elif op == "metrics":
            # refresh the drift verdict so a scrape-by-op sees the same
            # data the stats report carries, then render the one page
            # the HTTP endpoint also serves
            self.check_drift()
            resp = {"ok": True,
                    "text": self._prometheus_page(),
                    "content_type": "text/plain; version=0.0.4"}
        elif op == "swap":
            def _swap():
                try:
                    out = self.promote_rolling(
                        str(msg.get("model", "default")),
                        model_str=msg.get("model_str"),
                        model_file=msg.get("model_file"))
                    if out.get("committed"):
                        r = {"ok": True, "fleet": out,
                             "version": max(out["versions"].values())}
                    else:
                        r = {"ok": False, "fleet": out,
                             "error": "candidate rejected by shadow gate"}
                except Exception as e:
                    r = {"ok": False,
                         "error": f"{type(e).__name__}: {e}"}
                if not r.get("ok"):
                    # control-plane failure: burn the tenant's error
                    # budget too, so the rollback watchdog's error-rate
                    # deltas see failed swaps, not just predict errors
                    self.stats.record_error()
                    self.stats.record_tenant_error(
                        str(msg.get("model", "default")))
                self._send_bytes(conn, self._encode_resp(
                    conn, r, opcode or wire.OP_SWAP, trace_id))
            threading.Thread(target=_swap, name="lgbt-fleet-swap",
                             daemon=True).start()
            return
        elif op == "shutdown":
            resp = {"ok": True}
            self._send_bytes(conn, self._encode_resp(
                conn, resp, opcode or wire.OP_SHUTDOWN, trace_id),
                close=True)
            threading.Thread(target=self.stop, daemon=True).start()
            return
        else:
            resp = {"ok": False, "error": f"unknown op {op!r}"}
            self.stats.record_error()
            self.stats.record_tenant_error(str(msg.get("model",
                                                       "default")))
        self._send_bytes(conn, self._encode_resp(conn, resp,
                                                 opcode, trace_id))

    def _predict(self, conn: _Conn, opcode: int, X: np.ndarray, name: str,
                 raw_score: bool, trace_id: str) -> None:
        tid = trace_id or (new_trace_id() if self.tracer is not None
                           else "")
        if not self.admission.try_acquire():
            self.stats.record_shed()
            self.stats.record_tenant_shed(name)
            resp = {"ok": False, "error": "overloaded", "shed": True,
                    "model": name,
                    "inflight": self.admission.inflight,
                    "capacity": self.admission.capacity}
            if tid:
                resp["trace_id"] = tid
            self._send_bytes(conn, self._encode_resp(conn, resp, opcode,
                                                     tid))
            return
        if not self.tenant_admission.try_acquire(name):
            # over THIS tenant's cap while the gateway still has global
            # headroom: shed the hot tenant, the rest keep admitting
            self.admission.release()
            self.stats.record_shed()
            self.stats.record_tenant_shed(name)
            self.stats.record_tenant_cap_shed(name)
            resp = {"ok": False, "error": "overloaded", "shed": True,
                    "model": name, "scope": "tenant",
                    "inflight": self.tenant_admission.inflight(name),
                    "capacity": self.tenant_admission.capacity}
            if tid:
                resp["trace_id"] = tid
            self._send_bytes(conn, self._encode_resp(conn, resp, opcode,
                                                     tid))
            return
        t0 = time.perf_counter()
        try:
            X = np.atleast_2d(X)
            self.recorder.record(X)
            replica = self.replicas.pick()
            model = replica.registry.get(name)
            span = self.tracer.span(
                "serve.request", cat="serving", trace_id=tid or None,
                args={"model": name, "rows": int(X.shape[0]),
                      "replica": replica.index}) \
                if self.tracer is not None else _NULL_CTX

            def _done(handle) -> None:
                try:
                    if handle.error is not None:
                        self.stats.record_error()
                        resp = {"ok": False,
                                "error": f"{type(handle.error).__name__}: "
                                         f"{handle.error}"}
                    else:
                        scores = model.convert_output(handle.result,
                                                      raw_score)
                        resp = {"ok": True, "scores": np.asarray(scores)}
                    if tid:
                        resp["trace_id"] = tid
                    self._send_bytes(conn, self._encode_resp(
                        conn, resp, opcode, tid))
                finally:
                    self.tenant_admission.release(name)
                    self.admission.release()
                    ms = (time.perf_counter() - t0) * 1e3
                    self.stats.record_request_latency(ms)
                    self.stats.record_tenant_request(
                        name, ms, error=handle.error is not None)

            with span:
                replica.submit_async(X, name, _done, trace_id=tid or None)
        except Exception as e:
            # dispatch-time failure (unknown model, bad shape): the
            # admission slots release HERE because no callback will
            self.stats.record_error()
            self.tenant_admission.release(name)
            self.admission.release()
            ms = (time.perf_counter() - t0) * 1e3
            self.stats.record_request_latency(ms)
            self.stats.record_tenant_request(name, ms, error=True)
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if tid:
                resp["trace_id"] = tid
            self._send_bytes(conn, self._encode_resp(conn, resp, opcode,
                                                     tid))
