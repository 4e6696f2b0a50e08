"""Threaded prediction server + client over length-prefixed pickle frames.

Port of ``lightgbm_tpu/serving/server.py``: the same RPC, ops and frames
(`io/net.py` framing: 8-byte LE length + pickle), so a client of either
package talks to a server of either.  One accept loop, one handler thread
per connection; all predictions funnel through per-model ``MicroBatcher``
workers so concurrent clients coalesce into shared device batches, each a
CUDA graph replay of the model's bucket on the card
(`registry.py:ServingModel`).  Responses carry numpy arrays and plain
dicts only.

Ops (dict in, dict out; ``{"ok": False, "error": ...}`` on failure):

  * ``predict``  — ``{"op", "model", "data": ndarray, "raw_score",
    "trace_id"?}`` → ``{"ok": True, "scores": ndarray, "trace_id"?}``; the
    (client-supplied or, when tracing, server-generated) ``trace_id`` is
    echoed back and carried through the batcher so the request span, its
    micro-batch span and the batch's stage spans share one id
  * ``swap``     — ``{"op", "model", "model_str"}`` → load/verify/hot-swap
    a new model text; the old version serves until the swap commits
  * ``stats``    — full telemetry report (``serving`` schema section,
    including exact p50/p95/p99 request latency)
  * ``metrics``  — Prometheus text-format snapshot (counters, stage
    timers, reliability counters, request-latency histogram) through the
    same framed-RPC plumbing as ``health``
  * ``health``   — readiness probe, distinct from ``ping`` liveness:
    registered models + admission state (inflight/capacity/shedding);
    accurate under overload
  * ``ping`` / ``shutdown``

Overload never drops a connection: past ``max_inflight`` concurrently
admitted predicts, requests shed with a structured
``{"ok": False, "error": "overloaded", "shed": True}`` frame that echoes
the request's ``trace_id`` so clients can correlate rejections
(`reliability/degrade.py`).  A batch of a CPU model whose predict path
raises, and a batch of a CUDA model failed by the injected
``serve.predict.fail``, degrade to the host numpy traversal, counted
(``fallback_fn``); a real device error of a CUDA model fails the batch's
requests and ``health`` reports not ready.

Operational surfaces beyond the socket: ``stats_out``/``stats_interval_s``
write periodic atomic (tmp + ``os.replace``) schema-validated stats
snapshots operators can poll without a connection, and
``trace=True``/``trace_out`` record request-scoped spans
(`observability/trace.py`) written as Chrome trace-event JSON on stop.

Start via ``Booster.serve()`` or ``python -m lightgbm_tpu_torch serve
input_model=model.txt`` (``device_type=cpu`` for the CPU).
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
from typing import Any, Dict, Optional

_NULL_CTX = contextlib.nullcontext()

import numpy as np

from ..io.net import recv_frame, send_frame
from ..lifecycle.recorder import TrafficRecorder
from ..observability.trace import TraceRecorder, new_trace_id
from ..reliability import faults
from ..reliability.degrade import AdmissionController
from ..reliability.metrics import rel_inc
from .batcher import MicroBatcher, ServingStats, bucket_ladder
from .registry import ModelRegistry


class ServerOverloaded(RuntimeError):
    """Raised by ``ServingClient`` on a structured shed frame.  Carries
    the server's admission state and the request's echoed ``trace_id``
    so a client can correlate the rejection with its own records."""

    def __init__(self, resp: Dict[str, Any]):
        super().__init__(
            f"server overloaded (inflight "
            f"{resp.get('inflight')}/{resp.get('capacity')})")
        self.trace_id = resp.get("trace_id")
        self.inflight = resp.get("inflight")
        self.capacity = resp.get("capacity")


class ServerUnavailable(ConnectionError):
    """Raised by ``ServingClient`` when the transport retry budget is
    exhausted (connect or send/recv kept failing).  A ``ConnectionError``
    subclass, so callers that already handle transport failures keep
    working; distinct from ``ServerOverloaded``, which is a STRUCTURED
    server decision and is never retried blindly."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"server unavailable after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts
        self.last_error = last


class PredictionServer:
    """Long-lived serving process state: registry + batchers + listener."""

    def __init__(self, booster=None, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch_rows: int = 256, deadline_ms: float = 2.0,
                 min_bucket: int = 32, warmup: bool = True,
                 telemetry_out: str = "", request_timeout: float = 60.0,
                 max_inflight: int = 64, trace: bool = False,
                 trace_out: str = "", trace_capacity: int = 65536,
                 stats_out: str = "", stats_interval_s: float = 10.0,
                 record_rows: int = 0, slo_p99_ms: float = 50.0,
                 slo_target: float = 0.99):
        self.host = host
        self.port = int(port)
        self.max_batch_rows = int(max_batch_rows)
        self.deadline_ms = float(deadline_ms)
        self.min_bucket = int(min_bucket)
        self.telemetry_out = telemetry_out
        self.request_timeout = float(request_timeout)
        self.admission = AdmissionController(max_inflight)
        self.stats = ServingStats(slo_p99_ms=slo_p99_ms,
                                  slo_target=slo_target)
        # request-scoped tracing: host-side spans only, written as Chrome
        # trace-event JSON on stop (open in Perfetto)
        self.trace_out = trace_out
        self.tracer: Optional[TraceRecorder] = None
        if trace or trace_out:
            self.tracer = TraceRecorder(True, capacity=trace_capacity)
            self.stats.attach_tracer(self.tracer)
        # periodic atomic schema-validated stats snapshots (poll the file
        # instead of the socket op)
        self.stats_out = stats_out
        self.stats_interval_s = float(stats_interval_s)
        self._stats_thread: Optional[threading.Thread] = None
        # bounded traffic ring for the lifecycle shadow loop; capacity 0
        # (the default) keeps the request path a single attribute check
        self.recorder = TrafficRecorder(record_rows)
        # set by LifecycleController when one is bound to this server;
        # report() then carries the "lifecycle" section
        self.lifecycle = None
        self.buckets = bucket_ladder(min_bucket, max_batch_rows)
        self.registry = registry or ModelRegistry(
            stats=self.stats, warm_buckets=self.buckets, warmup=warmup)
        if registry is not None and not registry.warm_buckets:
            registry.warm_buckets = self.buckets
        self.registry.stats = self.stats
        if booster is not None:
            self.registry.load("default", booster=booster)
        self._batchers: Dict[str, MicroBatcher] = {}
        self._batcher_lock = threading.Lock()
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "PredictionServer":
        # a fault spec in LGBT_FAULTS is read (and a refused point raises)
        # here, not in the first batch
        faults.load()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self.port))
            srv.listen(16)
            srv.settimeout(0.25)          # poll the stop flag
        except OSError:
            # close-on-error-path: a failed bind (port in use) must not
            # leak the listener fd
            srv.close()
            raise
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="lgbt-serve-accept", daemon=True)
        self._accept_thread.start()
        if self.stats_out:
            self._stats_thread = threading.Thread(
                target=self._stats_loop, name="lgbt-serve-stats", daemon=True)
            self._stats_thread.start()
        return self

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        if self.lifecycle is not None:
            self.lifecycle.stop()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._batcher_lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.stop()
        # join-on-stop: the accept loop exits on the closed listener and
        # the stats loop wakes on the stop event — wait for both so no
        # daemon thread outlives stop() and races the final snapshot
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=5.0)
        if self.telemetry_out:
            from ..observability import write_report
            write_report(self.report(), self.telemetry_out)
        if self.stats_out:
            self._write_stats_snapshot()     # final snapshot at shutdown
        if self.trace_out and self.tracer is not None:
            self.tracer.save(self.trace_out)
        self._stopped.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- report --------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        self.stats.tel.device = self.registry.device
        rep = self.stats.report(models=self.registry.versions(),
                                jit_entries=self.registry.jit_entries())
        if self.lifecycle is not None:
            rep["lifecycle"] = self.lifecycle.section()
        return rep

    def trace(self) -> Optional[Dict[str, Any]]:
        """The captured Chrome trace-event JSON object (``None`` when
        tracing is off)."""
        return self.tracer.export() if self.tracer is not None else None

    def _write_stats_snapshot(self) -> None:
        from ..observability import write_report
        try:
            write_report(self.report(), self.stats_out)
        except Exception as e:
            # a full disk or transient schema problem must not kill the
            # snapshot loop (or serving); the failure is counted so it
            # still surfaces in the reliability section
            rel_inc("serve.stats_snapshot_errors")
            print(f"[lightgbm_tpu_torch] [Warning] stats snapshot failed: {e}",
                  flush=True)

    def _stats_loop(self) -> None:
        """Periodic operator-pollable snapshots: atomic (tmp +
        ``os.replace`` inside ``write_report``) and schema-validated, so
        a reader never observes a torn or malformed file."""
        while not self._stop.wait(self.stats_interval_s):
            self._write_stats_snapshot()

    # -- batching ------------------------------------------------------------

    def _batcher(self, name: str) -> MicroBatcher:
        with self._batcher_lock:
            b = self._batchers.get(name)
            if b is None:
                # resolve the model at BATCH time so a hot-swap is picked
                # up atomically at the next batch boundary
                def predict_fn(Xpad, m, _name=name):
                    return self.registry.get(_name).predict_padded(Xpad, m)

                # graceful degradation, counted in the reliability
                # section: ServingModel.host_fallback re-scores the batch
                # on the host or re-raises a real device error
                def fallback_fn(Xpad, m, error, _name=name):
                    return self.registry.get(_name).host_fallback(
                        Xpad, m, error)

                b = MicroBatcher(
                    predict_fn,
                    num_features=self.registry.get(name).num_features,
                    max_batch_rows=self.max_batch_rows,
                    deadline_ms=self.deadline_ms,
                    min_bucket=self.min_bucket, stats=self.stats,
                    fallback_fn=fallback_fn).start()
                self._batchers[name] = b
            return b

    # -- connection handling -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # deadline before the handler thread exists: a client that
            # connects and never speaks can otherwise pin a thread forever
            conn.settimeout(self.request_timeout + 30.0)
            threading.Thread(target=self._handle, args=(conn,),
                             name="lgbt-serve-conn", daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_frame(conn)
                except (ConnectionError, socket.timeout, OSError, EOFError):
                    break
                try:
                    resp = self._dispatch(msg)
                except Exception as e:
                    # Exception, not BaseException: a SystemExit /
                    # KeyboardInterrupt must kill the handler, not become
                    # an RPC error frame
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    send_frame(conn, resp)
                except OSError:
                    break
                if isinstance(msg, dict) and msg.get("op") == "shutdown":
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, msg) -> Dict[str, Any]:
        if not isinstance(msg, dict) or "op" not in msg:
            return {"ok": False, "error": "malformed request"}
        op = msg["op"]
        if op == "ping":
            return {"ok": True}
        if op == "health":
            # readiness, distinct from liveness (`ping`): servable models
            # exist, none met a device error, and the server is not
            # stopping.  Stays ACCURATE under overload — a saturated server
            # is alive and ready, it is just shedding; clients and
            # balancers read that from `shedding`
            models = self.registry.versions()
            device_errors = self.registry.device_errors()
            return {"ok": True,
                    "ready": bool(models) and not device_errors
                    and not self._stop.is_set(),
                    "models": models,
                    "device_errors": device_errors,
                    # serving + retained-previous version per model, so an
                    # operator sees what is live and what a rollback
                    # would restore
                    "versions": self.registry.versions_detail(),
                    **self.admission.snapshot()}
        if op == "predict":
            name = str(msg.get("model", "default"))
            # the request's causal id: client-supplied, or minted here
            # when tracing so every request is attributable in the trace
            trace_id = msg.get("trace_id") or \
                (new_trace_id() if self.tracer is not None else None)
            # bounded admission: past capacity we answer IMMEDIATELY with
            # a structured shed frame — never a queue-until-timeout that
            # looks like a dropped connection from the outside.  The shed
            # frame echoes trace_id so the client can correlate the
            # rejection with its own request records
            if not self.admission.try_acquire():
                self.stats.record_shed()
                self.stats.record_tenant_shed(name)
                resp = {"ok": False, "error": "overloaded", "shed": True,
                        "inflight": self.admission.inflight,
                        "capacity": self.admission.capacity}
                if trace_id is not None:
                    resp["trace_id"] = trace_id
                return resp
            t0 = time.perf_counter()
            failed = False
            try:
                model = self.registry.get(name)
                X = np.atleast_2d(np.asarray(msg["data"], dtype=np.float64))
                # lifecycle traffic capture: the shadow loop replays
                # candidates against what the server actually answered
                self.recorder.record(X)
                span = self.tracer.span(
                    "serve.request", cat="serving", trace_id=trace_id,
                    args={"model": name, "rows": int(X.shape[0])}) \
                    if self.tracer is not None else _NULL_CTX
                with span:
                    raw = self._batcher(name).submit(
                        X, timeout=self.request_timeout, trace_id=trace_id)
                    scores = model.convert_output(raw,
                                                  bool(msg.get("raw_score")))
                resp = {"ok": True, "scores": np.asarray(scores)}
                if trace_id is not None:
                    resp["trace_id"] = trace_id
                return resp
            except Exception:
                # an admitted request answering with an error frame: the
                # rate the lifecycle rollback watchdog judges a fresh
                # promotion by
                failed = True
                self.stats.record_error()
                raise
            finally:
                self.admission.release()
                # admission→response latency, errors included — the p99
                # an external client actually observes server-side
                ms = (time.perf_counter() - t0) * 1e3
                self.stats.record_request_latency(ms)
                self.stats.record_tenant_request(name, ms, error=failed)
        if op == "swap":
            version = self.registry.load(
                msg.get("model", "default"), model_str=msg.get("model_str"),
                model_file=msg.get("model_file"))
            return {"ok": True, "version": version}
        if op == "stats":
            return {"ok": True, "report": self.report()}
        if op == "metrics":
            # Prometheus text exposition over the same framed-RPC plumbing
            # as `health` — scrape with `ServingClient.metrics()` or the
            # CLI; le buckets in seconds, counters monotone
            from ..observability.metrics_export import prometheus_snapshot
            return {"ok": True,
                    "text": prometheus_snapshot(
                        self.stats, registry=self.registry,
                        admission=self.admission,
                        tenants=self.stats.tenants_section()),
                    "content_type": "text/plain; version=0.0.4"}
        if op == "shutdown":
            # ack first; stop from a side thread (stop() joins batcher
            # threads and must not run on this handler)
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class ServingClient:
    """Tiny blocking client for ``PredictionServer`` and ``FleetServer``.

    Protocol: ``protocol="auto"`` (the default) probes the server ONCE
    with a binary ``ping`` frame (`serving/fleet/wire.py`) on the first
    connection — a fleet gateway answers in kind and the client speaks
    compact typed binary frames from then on; a legacy pickle server
    rejects the probe's magic as a protocol mismatch and closes, and the
    client reconnects speaking pickle (without burning the transport
    retry budget — negotiation is not a failure).  ``protocol="binary"``
    / ``"pickle"`` pin the framing explicitly.

    Transport failures — refused/dropped connections, recv timeouts,
    torn frames — retry with bounded exponential backoff (the SocketNet
    reconnect pattern, `io/net.py`), reconnecting between attempts;
    after ``retries`` failed attempts a typed ``ServerUnavailable``
    raises.  Structured SERVER decisions are never retried blindly: a
    shed/overload frame raises ``ServerOverloaded`` immediately (the
    server is alive and explicitly refusing — hammering it back is how
    retry storms start) and error frames raise ``RuntimeError`` — the
    same semantics under both framings.
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 retries: int = 3, backoff_s: float = 0.05,
                 protocol: str = "auto"):
        if protocol not in ("auto", "binary", "pickle"):
            raise ValueError(f"unknown protocol {protocol!r} "
                             f"(auto, binary or pickle)")
        self._host = host
        self._port = int(port)
        self._timeout = float(timeout)
        self._retries = max(int(retries), 0)
        self._backoff_s = float(backoff_s)
        self._protocol = protocol
        # the negotiated framing, sticky after the first connection
        self._wire: Optional[str] = \
            "pickle" if protocol == "pickle" else None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        with self._lock:
            self._connect_locked()

    @property
    def protocol(self) -> Optional[str]:
        """The negotiated framing ("binary" or "pickle")."""
        return self._wire

    def _negotiate(self, s: socket.socket) -> bool:
        """One-shot probe on a fresh socket: binary ping → True when the
        server answers in wire framing.  A pickle server sees the magic
        as a giant/mismatched length prefix and closes; that surfaces
        here as a transport error → False (fall back), unless the caller
        pinned ``protocol="binary"``."""
        from .fleet import wire
        try:
            wire.send_wire_frame(s, wire.OP_PING)
            opcode, _flags, _tid, payload = wire.recv_wire_frame(s)
            wire.response_to_dict(opcode, _flags, _tid, payload)
            return True
        except (ConnectionError, socket.timeout, OSError, EOFError) as e:
            if self._protocol == "binary":
                raise ServerUnavailable(1, e) from e
            return False

    def _connect_locked(self) -> None:
        """(Re)connect under ``self._lock`` with the bounded
        backoff-retry loop; transient connect errors count into the
        reliability table.  Protocol negotiation runs once, on the first
        successful connection."""
        self._close_locked()
        backoff = self._backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self._retries + 1):
            s: Optional[socket.socket] = None
            try:
                s = socket.create_connection((self._host, self._port),
                                             timeout=self._timeout)
                s.settimeout(self._timeout)
                if self._wire is None:
                    if self._negotiate(s):
                        self._wire = "binary"
                    else:
                        # the probe's rejection closed the socket; the
                        # pickle reconnect is part of negotiation, not a
                        # transport failure
                        self._wire = "pickle"
                        try:
                            s.close()
                        except OSError:
                            pass
                        s = None
                        s = socket.create_connection(
                            (self._host, self._port),
                            timeout=self._timeout)
                        s.settimeout(self._timeout)
                self._sock = s
                return
            except ServerUnavailable:
                # pinned protocol="binary" against a non-binary server:
                # a definitive answer, not a transient to retry — but
                # the probe socket must still close on the way out
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                raise
            except OSError as e:
                # close-on-error-path: a socket that connected but then
                # failed (probe timeout, reset mid-negotiation) would
                # otherwise leak an fd per retry
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                last = e
                rel_inc("serve.client_connect_retries")
                if attempt >= self._retries:
                    break
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
        raise ServerUnavailable(self._retries + 1, last)

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip_locked(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One request/response exchange in the negotiated framing.
        Binary responses are normalized into the pickle protocol's dict
        shape so every caller above this line is protocol-blind."""
        if self._wire != "binary":
            send_frame(self._sock, msg)
            return recv_frame(self._sock)
        from .fleet import wire
        op = msg["op"]
        tid = msg.get("trace_id") or ""
        if op == "predict":
            payload = wire.encode_predict_request(
                np.asarray(msg["data"]), msg.get("model", "default"))
            flags = wire.FLAG_RAW_SCORE if msg.get("raw_score") else 0
            wire.send_wire_frame(self._sock, wire.OP_PREDICT, payload,
                                 flags, tid)
        else:
            opcode = {"ping": wire.OP_PING, "health": wire.OP_HEALTH,
                      "metrics": wire.OP_METRICS, "stats": wire.OP_STATS,
                      "swap": wire.OP_SWAP,
                      "shutdown": wire.OP_SHUTDOWN}.get(op)
            if opcode is None:
                raise ValueError(f"op {op!r} has no binary encoding")
            body = {k: v for k, v in msg.items()
                    if k not in ("op", "trace_id")}
            wire.send_wire_frame(self._sock, opcode,
                                 wire.encode_json(body) if body else b"",
                                 0, tid)
        return wire.response_to_dict(
            *wire.recv_wire_frame(self._sock))

    def _call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            backoff = self._backoff_s
            last: Optional[BaseException] = None
            resp = None
            for attempt in range(self._retries + 1):
                try:
                    if self._sock is None:
                        self._connect_locked()
                    resp = self._roundtrip_locked(msg)
                    break
                except ServerUnavailable:
                    raise
                except (ConnectionError, socket.timeout, OSError,
                        EOFError) as e:
                    # transient transport failure: drop the socket and
                    # retry the whole send/recv on a fresh connection
                    last = e
                    self._close_locked()
                    rel_inc("serve.client_call_retries")
                    if attempt >= self._retries:
                        raise ServerUnavailable(attempt + 1, last) from e
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1.0)
        if not resp.get("ok"):
            if resp.get("shed"):
                # structured overload: typed, with the echoed trace_id —
                # an explicit server decision, NOT retried
                raise ServerOverloaded(resp)
            raise RuntimeError(f"server error: {resp.get('error')}")
        return resp

    def ping(self) -> bool:
        return self._call({"op": "ping"})["ok"]

    def health(self) -> Dict[str, Any]:
        """Readiness + admission state (see ``health`` op)."""
        return self._call({"op": "health"})

    def predict(self, X, model: str = "default", raw_score: bool = False,
                trace_id: Optional[str] = None) -> np.ndarray:
        """Blocking predict.  ``trace_id`` (any opaque string, e.g.
        ``observability.new_trace_id()``) is carried through the server's
        request/batch/stage spans and echoed in the response — including
        shed responses, where it lands on ``ServerOverloaded.trace_id``.
        Under the binary framing the row block ships as float32 (the
        bandwidth win); scores come back float64."""
        msg = {"op": "predict", "model": model,
               "data": np.asarray(X, dtype=np.float64),
               "raw_score": raw_score}
        if trace_id is not None:
            msg["trace_id"] = trace_id
        return self._call(msg)["scores"]

    def swap(self, model_str: str, model: str = "default") -> int:
        return self._call({"op": "swap", "model": model,
                           "model_str": model_str})["version"]

    def stats(self) -> Dict[str, Any]:
        """Full telemetry report (``serving`` section with exact
        p50/p95/p99 request latency under ``latency_ms``)."""
        return self._call({"op": "stats"})["report"]

    def metrics(self) -> str:
        """Prometheus text-format metrics snapshot (see ``metrics`` op)."""
        return self._call({"op": "metrics"})["text"]

    def shutdown(self) -> None:
        self._call({"op": "shutdown"})

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
