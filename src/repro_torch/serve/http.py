"""Asyncio HTTP front end for the QueryServer (DESIGN.md §16).

The network surface the paper's web application talks to — the layer
that turns the threaded ``QueryServer`` into a deployable artifact. The
shape follows Earth-Copilot's FastAPI container app (SNIPPETS.md), but
it is hand-rolled on stdlib ``asyncio`` streams so the repo's tests and
CI need no extra dependency: a tiny, strict HTTP/1.1 server speaking
JSON.

Routes:

  POST /query    {"pos_ids": [...], "neg_ids": [...], "model"?,
                  "max_results"?, "timeout_ms"?, "source"?, ...}
                 -> 200 {"ok": true, "ids": [...], "scores": [...], ...}
  POST /ingest   {"op": "append"|"delete"|"compact"|"checkpoint",
                  "features"?: [[...], ...], "ids"?: [...]}
                 -> 200 {"ok": true, "info": {...}}
  GET  /healthz  -> 200 {"health": "ok"|"degraded"} | 503 ("draining")
  GET  /stats    -> 200 QueryServer.summary() (JSON-sanitised)
  GET  /metrics  -> 200 Prometheus text exposition (the server's
                    unified metrics registry, DESIGN.md §17)
  GET  /traces?n=K -> 200 {"traces": [...], "slow": [...]} — the K most
                    recent finished query traces + slow-query log

Request ids: an inbound ``X-Request-Id`` header becomes the trace id
for that query (tracing enabled), so a caller's correlation id follows
the request through admission, device rounds, and the slow-query log;
responses echo it back as ``X-Request-Id`` and as ``trace_id`` in the
JSON body. Without the header the server mints one.

Error contract: the typed taxonomy maps to HTTP statuses via
``repro_torch.serve.policy.http_status_for`` — ``rate_limited`` -> 429,
``overloaded``/``shutdown`` -> 503 (with ``Retry-After``),
``deadline_exceeded`` -> 504; anything else the engine raised is a 500
with the typed tag in the body. Transport errors are the usual 400
(malformed JSON / bad fields), 404, 405, 413.

Deadlines: a request's ``timeout_ms`` becomes an ABSOLUTE monotonic
deadline at admission (``deadline_after``), before ``submit`` — so HTTP
queue wait, admission-queue wait and device time all burn the same
budget, which is what a latency SLO means. No ``timeout_ms`` falls back
to the QueryServer's ``default_deadline_s`` (also stamped at admission).

Concurrency model: the asyncio loop owns the sockets and parsing; each
request's blocking ``submit(...).get()`` runs via a thread-pool hop so
slow queries never stall the accept loop or each other's responses. The
loop runs on a dedicated daemon thread (``start()``/``close()``), so
the front end composes with the threaded server and tests drive a REAL
socket.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import deadline_after
from repro_torch.serve.engine import (IngestRequest, QueryRequest,
                                      QueryServer)
from repro_torch.serve.policy import ServerClosed, http_status_for

__all__ = ["HttpFrontEnd", "jsonable"]

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 256 * 1024 * 1024
# generous bound on waiting out a submitted request: the QueryServer
# contract says every submit resolves (shed, expired, drained or
# served), so this only fires on a serving-layer bug — and then the
# client gets a typed 500 instead of a socket that never answers
_RESOLVE_TIMEOUT_S = 300.0

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}

# query kwargs the wire accepts verbatim (everything else in the body is
# rejected — a typo'd field must not silently change semantics)
_QUERY_KWARGS = ("max_results", "n_models", "seed", "max_depth",
                 "k_neighbors", "include_training")
_QUERY_FIELDS = ("pos_ids", "neg_ids", "model", "timeout_ms",
                 "source") + _QUERY_KWARGS
_INGEST_FIELDS = ("op", "features", "ids", "timeout_ms", "source")


def jsonable(obj):
    """Recursively convert summary()/info payloads (numpy arrays and
    scalars, torch tensors, tuples, dataclass-ish dicts) into
    JSON-serialisable structures. A tensor goes out as its values, as
    an ndarray does — never as its ``str`` (``"tensor([...],
    device='cuda:0')"``)."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class _BadRequest(Exception):
    """Transport-level rejection; ``status`` rides to the wire."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


def _require_int_list(body: Dict, field: str):
    v = body.get(field)
    if not isinstance(v, list) or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in v):
        raise _BadRequest(f"{field!r} must be a list of ints")
    return v


def _parse_timeout_ms(body: Dict) -> Optional[float]:
    t = body.get("timeout_ms")
    if t is None:
        return None
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t <= 0:
        raise _BadRequest("'timeout_ms' must be a positive number")
    return float(t)


def _check_fields(body: Dict, allowed: Tuple[str, ...]) -> None:
    unknown = sorted(set(body) - set(allowed))
    if unknown:
        raise _BadRequest(f"unknown fields {unknown}; "
                          f"allowed: {sorted(allowed)}")


class HttpFrontEnd:
    """Serve a ``QueryServer`` over a real TCP socket.

    >>> fe = HttpFrontEnd(server, port=0)   # 0 -> ephemeral port
    >>> host, port = fe.start()
    >>> ... curl http://host:port/query ...
    >>> fe.close()

    ``start`` spawns the asyncio loop on a daemon thread and returns
    once the listening socket is bound (so the bound port is readable
    immediately); ``close`` stops the loop, closes the listener and
    joins the thread. The front end never outlives its QueryServer
    contract: requests in flight at ``close`` still resolve (the
    QueryServer answers everything submitted), only NEW connections are
    refused.
    """

    def __init__(self, server: QueryServer, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self.host = host
        self.port = int(port)          # rebound to the real port on start
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._req_id = 0
        self._id_lock = threading.Lock()
        # wire-level ledger (the engine keeps its own): one entry per
        # HTTP response by status class, plus per-route counts
        self._stats_lock = threading.Lock()
        self.stats = {"http_requests": 0, "http_2xx": 0, "http_4xx": 0,
                      "http_5xx": 0, "by_route": {}, "by_status": {}}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        if self._thread is not None:
            raise RuntimeError("front end already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="http-front-end")
        self._thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("HTTP front end failed to start in 10s")
        if self._startup_error is not None:
            raise RuntimeError("HTTP front end failed to bind") \
                from self._startup_error
        return self.host, self.port

    def close(self) -> None:
        """Stop accepting, close the listener, join the loop thread.
        Idempotent; never raises on double-close."""
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None and loop.is_running():
            loop.call_soon_threadsafe(stop.set)
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        try:
            asyncio.run(self._serve())
        except BaseException as e:  # noqa: BLE001 — surfaced via start()
            self._startup_error = e
            self._started.set()

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._on_connection,
                                            self.host, self.port)
        self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            await self._stop.wait()
        finally:
            server.close()
            await server.wait_closed()

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                parsed = await self._read_request(reader)
                if parsed is None:
                    break
                method, path, headers, body = parsed
                keep_alive = headers.get("connection", "").lower() \
                    != "close"
                extra_headers: Optional[Dict[str, str]] = None
                try:
                    res = await self._dispatch(method, path, headers,
                                               body)
                    status, payload = res[0], res[1]
                    if len(res) > 2:
                        extra_headers = res[2]
                except _BadRequest as e:
                    status, payload = e.status, {"ok": False,
                                                 "error": str(e),
                                                 "error_type":
                                                     "bad_request"}
                except Exception as e:  # noqa: BLE001 — never drop a conn
                    status, payload = 500, {"ok": False, "error": f"{e}",
                                            "error_type": "internal"}
                self._note(path, status)
                await self._write_response(writer, status, payload,
                                           keep_alive,
                                           extra_headers=extra_headers)
                if not keep_alive:
                    break
        except (_BadRequest, asyncio.IncompleteReadError,
                ConnectionError, asyncio.LimitOverrunError):
            pass          # torn/oversized request line: drop the conn
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 — peer may already be gone
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        """One request: (method, path, headers, body) or None on EOF."""
        try:
            line = await reader.readline()
        except ValueError:
            raise _BadRequest("request line too long", status=413)
        if not line:
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest("malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        hdr_bytes = 0
        while True:
            line = await reader.readline()
            hdr_bytes += len(line)
            if hdr_bytes > _MAX_HEADER_BYTES:
                raise _BadRequest("headers too large", status=413)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest("bad Content-Length")
        if length > _MAX_BODY_BYTES:
            raise _BadRequest("body too large", status=413)
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, payload,
                              keep_alive: bool, *,
                              extra_headers: Optional[Dict[str, str]]
                              = None) -> None:
        # dict payloads go out as JSON; str payloads (the /metrics
        # exposition) as text/plain with the Prometheus version tag
        if isinstance(payload, str):
            data = payload.encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            data = json.dumps(jsonable(payload)).encode()
            ctype = "application/json"
        reason = _REASONS.get(status, "Unknown")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(data)}",
                f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        if status in (429, 503):
            head.append("Retry-After: 1")     # back-pressure, not failure
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()

    def _note(self, path: str, status: int) -> None:
        with self._stats_lock:
            self.stats["http_requests"] += 1
            bucket = f"http_{status // 100}xx"
            if bucket in self.stats:
                self.stats[bucket] += 1
            self.stats["by_route"][path] = \
                self.stats["by_route"].get(path, 0) + 1
            self.stats["by_status"][str(status)] = \
                self.stats["by_status"].get(str(status), 0) + 1

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    async def _dispatch(self, method: str, path: str,
                        headers: Dict[str, str], body: bytes):
        """Route one request. Returns ``(status, payload)`` or
        ``(status, payload, extra_response_headers)``; a str payload is
        written as text/plain (the Prometheus exposition)."""
        path, _, qs = path.partition("?")
        if path == "/query":
            if method != "POST":
                return 405, {"ok": False, "error": "POST required",
                             "error_type": "method_not_allowed"}
            return await self._query(self._parse_json(body), headers)
        if path == "/ingest":
            if method != "POST":
                return 405, {"ok": False, "error": "POST required",
                             "error_type": "method_not_allowed"}
            return await self._ingest(self._parse_json(body))
        if path == "/healthz":
            if method != "GET":
                return 405, {"ok": False, "error": "GET required",
                             "error_type": "method_not_allowed"}
            return self._healthz()
        if path == "/stats":
            if method != "GET":
                return 405, {"ok": False, "error": "GET required",
                             "error_type": "method_not_allowed"}
            return 200, {"ok": True, **self.server.summary(),
                         "http": self.http_stats()}
        if path == "/metrics":
            if method != "GET":
                return 405, {"ok": False, "error": "GET required",
                             "error_type": "method_not_allowed"}
            return 200, self.server.obs.render_prometheus()
        if path == "/traces":
            if method != "GET":
                return 405, {"ok": False, "error": "GET required",
                             "error_type": "method_not_allowed"}
            return self._traces(qs)
        return 404, {"ok": False, "error": f"no route {path!r}",
                     "error_type": "not_found"}

    def _traces(self, qs: str) -> Tuple[int, Dict]:
        n = 20
        for part in qs.split("&"):
            k, _, v = part.partition("=")
            if k == "n":
                try:
                    n = max(1, min(int(v), 1000))
                except ValueError:
                    raise _BadRequest("'n' must be an integer")
        store = self.server.obs.traces
        return 200, {"ok": True, "traces": store.recent(n),
                     "slow": store.slow_log(n)}

    @staticmethod
    def _parse_json(body: bytes) -> Dict:
        if not body:
            raise _BadRequest("empty body; JSON object required")
        try:
            parsed = json.loads(body)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"malformed JSON: {e}")
        if not isinstance(parsed, dict):
            raise _BadRequest("JSON body must be an object")
        return parsed

    def _next_id(self) -> int:
        with self._id_lock:
            self._req_id += 1
            return self._req_id

    async def _resolve(self, req) -> Tuple[int, Dict, object]:
        """Submit to the QueryServer and await the response WITHOUT
        blocking the event loop (thread-pool hop around the blocking
        queue.get). Returns (status, base payload, QueryResponse)."""
        try:
            out = self.server.submit(req)
        except ServerClosed as e:
            return (http_status_for(e.code),
                    {"ok": False, "error": str(e), "error_type": e.code},
                    None)
        resp = await asyncio.to_thread(out.get, True, _RESOLVE_TIMEOUT_S)
        if resp.ok:
            return 200, {"ok": True}, resp
        return (http_status_for(resp.error_type),
                {"ok": False, "error": resp.error,
                 "error_type": resp.error_type}, resp)

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    async def _query(self, body: Dict, headers: Dict[str, str]):
        _check_fields(body, _QUERY_FIELDS)
        pos = _require_int_list(body, "pos_ids")
        neg = _require_int_list(body, "neg_ids")
        model = body.get("model", "dbranch")
        if not isinstance(model, str):
            raise _BadRequest("'model' must be a string")
        kwargs = {k: body[k] for k in _QUERY_KWARGS if k in body}
        timeout_ms = _parse_timeout_ms(body)
        # absolute monotonic deadline stamped at ADMISSION: HTTP queue
        # wait and admission wait burn the same budget the device does
        deadline_s = None if timeout_ms is None \
            else deadline_after(timeout_ms / 1e3)
        t0 = time.perf_counter()
        # the trace is born HERE (not in submit) so a caller-supplied
        # X-Request-Id becomes the trace id end to end (length-capped:
        # the id lands in logs and the trace ring verbatim)
        rid = headers.get("x-request-id", "")[:128] or None
        trace = self.server.obs.new_trace(rid)
        req = QueryRequest(self._next_id(), pos, neg, model,
                           kwargs=kwargs, deadline_s=deadline_s,
                           source=str(body.get("source", "default")),
                           trace=trace)
        status, payload, resp = await self._resolve(req)
        if resp is None and trace is not None:
            # submit refused (ServerClosed) before the server could own
            # the trace — finish it here so nothing dangles
            self.server.obs.observe_trace(
                trace, status=payload.get("error_type", "shutdown"))
        payload["request_id"] = req.request_id
        payload["e2e_ms"] = round(1e3 * (time.perf_counter() - t0), 3)
        if trace is not None:
            payload["trace_id"] = trace.trace_id
        if status == 200:
            res = resp.result
            payload.update({
                "model": res.model,
                "ids": np.asarray(res.ids),
                "scores": np.asarray(res.scores),
                "n_found": res.n_found,
                "train_time_s": res.train_time_s,
                "query_time_s": res.query_time_s,
                "latency_ms": round(1e3 * resp.latency_s, 3),
                "cache": resp.info.get("cache", "miss"),
            })
        if trace is not None:
            return status, payload, {"X-Request-Id": trace.trace_id}
        return status, payload

    async def _ingest(self, body: Dict) -> Tuple[int, Dict]:
        _check_fields(body, _INGEST_FIELDS)
        op = body.get("op")
        if op not in ("append", "delete", "compact", "checkpoint"):
            raise _BadRequest(
                "'op' must be append | delete | compact | checkpoint")
        features = None
        ids = None
        if op == "append":
            raw = body.get("features")
            if not isinstance(raw, list) or not raw:
                raise _BadRequest(
                    "'features' must be a non-empty list of rows")
            try:
                features = np.asarray(raw, dtype=np.float32)
            except (TypeError, ValueError) as e:
                raise _BadRequest(f"bad 'features': {e}")
            if features.ndim != 2:
                raise _BadRequest("'features' must be [rows, dims]")
        elif op == "delete":
            ids = _require_int_list(body, "ids")
        req = IngestRequest(self._next_id(), op, features=features,
                            ids=ids,
                            source=str(body.get("source", "default")))
        status, payload, resp = await self._resolve(req)
        payload["request_id"] = req.request_id
        if status == 200:
            payload["info"] = resp.info
            payload["latency_ms"] = round(1e3 * resp.latency_s, 3)
        return status, payload

    def _healthz(self) -> Tuple[int, Dict]:
        health = self.server.health
        # draining is the one state a load balancer must route AWAY
        # from; ok and degraded both still serve (degraded = reduced
        # max_results / salvaged catalog — answers remain correct)
        status = 503 if health == "draining" else 200
        return status, {"ok": status == 200, "health": health}

    def http_stats(self) -> Dict:
        with self._stats_lock:
            return {**{k: v for k, v in self.stats.items()
                       if not isinstance(v, dict)},
                    "by_route": dict(self.stats["by_route"]),
                    "by_status": dict(self.stats["by_status"])}


# ----------------------------------------------------------------------
# demo entry point: a curl-able engine over synthetic imagery features
# ----------------------------------------------------------------------

def main(argv=None) -> None:   # pragma: no cover - exercised manually
    import argparse

    from repro_torch.core.engine import SearchEngine
    from repro_torch.data.synthetic import (PatchDatasetConfig,
                                            generate_patches,
                                            handcrafted_features)
    from repro_torch.serve.cache import ResultCache

    ap = argparse.ArgumentParser(
        description="serve a demo RapidEarth engine over HTTP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--n", type=int, default=20_000,
                    help="synthetic catalog rows")
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    data = generate_patches(PatchDatasetConfig(n_patches=args.n, seed=0))
    feats = handcrafted_features(data["images"])
    engine = SearchEngine(feats, n_subsets=24, subset_dim=6, live=True,
                          device=args.device)
    server = QueryServer(engine, max_results=100,
                         queue_depth=args.queue_depth,
                         default_deadline_s=args.deadline_s,
                         cache=ResultCache())
    server.start()
    fe = HttpFrontEnd(server, host=args.host, port=args.port)
    host, port = fe.start()
    print(f"serving {args.n} rows on http://{host}:{port} from "
          f"{engine.device}  (POST /query, POST /ingest, GET /healthz, "
          f"GET /stats)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        fe.close()
        server.close()


if __name__ == "__main__":   # pragma: no cover
    main()
