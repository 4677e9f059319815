"""Query service: the RPC surface of the engine on one device.

Counterpart of ``tiflash_tpu/mpp/service.py``.  Role analog: the
``FlashService`` endpoints (Coprocessor, DispatchMPPTask, CancelMPPTask)
and the HTTP status/metrics servers.  Plans arrive as JSON
(``plan/serde.py``); the surface is a small threaded HTTP server:

  POST /query    {"plan": <plan json>, "distributed": bool, "async": bool,
                  "settings": {name: value}}
                 -> {"query_id": N, "columns": {name: [values...]},
                     "summary": {...}}
                 (async: -> {"query_id": N} at once; poll /result)
  GET  /result?id=N -> state (+ columns/summary when FINISHED)
  POST /cancel   {"query_id": N} -> cooperative abort: the query stops at
                 its next checkpoint and frees its admission slot
  GET  /metrics  -> flat counter dump (JSON)
  GET  /status   -> tables, backend, devices, memory
  GET  /queries  -> the last 100 queries and their states
  GET  /logs?q=&level=&limit= -> records of the in-memory log ring
  POST /failpoint {"name": ..., "action": "enable"|"disable"|"pause",
                   "probability": p}

Errors answer 400 (a bad plan, an unknown setting), 499 (cancelled) or
500 (``kind: failpoint``, or an engine error), each with
``runtime/errors.py:error_payload``.

Admission: a bounded semaphore caps concurrent queries; a QUEUED query
polls its cancel flag while it waits and gives up after
``service_queue_timeout_s`` (0 = wait forever).

The port's service runs on one device, ``device`` (``cuda`` unless the
caller asks for the CPU).  A ``mesh`` raises ``NotImplementedError``: the
distributed runner comes with the distribution slice of the port.  With
no mesh, a request's ``"distributed": true`` runs on the one device, as
the reference's service does when its mesh is None.  System tables are
built per query on the service's device and merged into its tables.

Each request runs in its own thread (``ThreadingHTTPServer``), on the
device's default stream: work from concurrent queries interleaves on the
card in launch order.  The cancel scope (thread-local) and the log
context (a contextvar) follow each request's thread; the allocator's
peak is process-wide, so a query's ``peak_device_bytes`` includes what
concurrent queries held (``runtime/memory.py:QueryMemoryScope``).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import torch

from ..plan.serde import plan_from_json
from ..runtime.cancel import CancelFlag, QueryCancelled, QueryTimeout, cancel_scope
from ..runtime.errors import error_payload
from ..runtime.executor import QueryRunner
from ..runtime.failpoint import FailPoint, FailPointError
from ..runtime.logging import RING, get_logger, query_context
from ..runtime.memory import device_memory_stats
from ..runtime.metrics import METRICS
from ..runtime.settings import Settings
from ..runtime.syncpoint import sync_point
from ..storage.catalog import Catalog

_TERMINAL = ("FINISHED", "FAILED", "CANCELLED")


class QueryService:
    def __init__(
        self,
        catalog: Catalog,
        mesh=None,
        settings: Optional[Settings] = None,
        max_concurrency: Optional[int] = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "QueryService over a mesh comes with the distribution slice "
                "of the port; this service runs on one device")
        self.catalog = catalog
        self.device = torch.device(device)
        self.settings = settings or Settings()
        self._admission = threading.BoundedSemaphore(
            max_concurrency or self.settings.service_max_concurrency)
        self._blocks = None
        self._lock = threading.Lock()
        # the query registry (the process-list analog), per-query cancel
        # flags and async results, keyed by query id
        self._qid = 0
        self._queries: Dict[int, Dict] = {}
        self._cancels: Dict[int, CancelFlag] = {}
        self._results: Dict[int, Dict] = {}

    def _tables(self):
        with self._lock:
            if self._blocks is None:
                self._blocks = self.catalog.blocks(self.device)
            return self._blocks

    def _register(self) -> int:
        with self._lock:
            self._qid += 1
            qid = self._qid
            self._queries[qid] = {"id": qid, "state": "QUEUED"}
            self._cancels[qid] = CancelFlag()
        return qid

    def cancel(self, qid: int) -> Dict:
        """Cooperative abort (the CancelMPPTask analog)."""
        with self._lock:
            flag = self._cancels.get(qid)
            entry = self._queries.get(qid)
            if flag is None or entry is None:
                return {"ok": False, "error": f"unknown query id {qid}"}
            terminal = entry["state"] in _TERMINAL
            if not terminal:
                entry["state"] = "CANCELLING"
        flag.set()
        METRICS.counter("queries_cancelled_total").inc()
        return {"ok": True, "state": entry["state"] if terminal else "CANCELLING"}

    def _acquire_admission(self, flag: CancelFlag) -> None:
        """Take an admission slot, polling the cancel flag while QUEUED;
        give up after ``service_queue_timeout_s`` (0 = wait forever)."""
        timeout = self.settings.service_queue_timeout_s
        t0 = time.monotonic()
        while not self._admission.acquire(timeout=0.05):
            if flag.is_set():
                raise QueryCancelled("cancelled while queued for admission")
            if timeout and time.monotonic() - t0 > timeout:
                raise QueryTimeout("queued past service_queue_timeout_s")

    def execute(self, plan_json: Dict, distributed: Optional[bool] = None,
                qid: Optional[int] = None,
                settings_override: Optional[Dict] = None) -> Dict:
        """Run one plan and return its rows and summary.  ``distributed``
        is accepted for the reference's signature; with no mesh every
        query runs on the service's device.  Unknown setting names raise
        ``ValueError`` (a 400)."""
        plan = plan_from_json(plan_json)
        settings = self.settings
        if settings_override:
            settings = settings.with_overrides(settings_override)
        uses_system = "system_" in json.dumps(plan_json)
        if qid is None:
            qid = self._register()
        with self._lock:
            flag = self._cancels[qid]
        log = get_logger("tiflash_tpu_torch.service")
        try:
            sync_point("service.query.queued")
            self._acquire_admission(flag)
            try:
                with query_context(qid), cancel_scope(flag):
                    with self._lock:
                        if self._queries[qid]["state"] == "QUEUED":
                            self._queries[qid]["state"] = "RUNNING"
                    log.info("query %d start", qid)
                    sync_point("service.query.running")
                    flag.check()
                    tables = self._tables()
                    if uses_system:
                        from ..storage.system import system_blocks

                        tables = {**tables, **system_blocks(
                            self.catalog, self.settings, self.queries()["queries"],
                            device=self.device)}
                    out, summary = QueryRunner(plan, settings=settings,
                                               cancel=flag).run(tables)
            finally:
                self._admission.release()
        except QueryCancelled:
            with self._lock:
                self._queries[qid]["state"] = "CANCELLED"
            log.info("query %d cancelled", qid)
            raise
        except Exception:
            with self._lock:
                self._queries[qid]["state"] = "FAILED"
            raise
        cols = out.to_pylists()
        with self._lock:
            self._queries[qid].update(
                state="FINISHED", rows=summary.result_rows,
                wall_seconds=summary.wall_seconds, retries=summary.retries)
        return {
            "query_id": qid,
            "columns": cols,
            "summary": {
                "rows": summary.result_rows,
                "wall_seconds": summary.wall_seconds,
                "retries": summary.retries,
                "backend": summary.backend,
                "devices": summary.num_devices,
            },
        }

    def execute_async(self, plan_json: Dict, distributed: Optional[bool] = None,
                      settings_override: Optional[Dict] = None) -> Dict:
        """Submit and return the query id at once; poll ``result``."""
        if settings_override:  # validate now, so bad names 400 at submit
            self.settings.with_overrides(settings_override)
        qid = self._register()

        def work():
            try:
                res = self.execute(plan_json, distributed, qid=qid,
                                   settings_override=settings_override)
            except Exception as e:
                res = {"query_id": qid, "error": f"{type(e).__name__}: {e}"}
            with self._lock:
                self._results[qid] = res

        threading.Thread(target=work, daemon=True).start()
        return {"query_id": qid}

    def result(self, qid: int) -> Dict:
        with self._lock:
            entry = self._queries.get(qid)
            if entry is None:
                return {"error": f"unknown query id {qid}"}
            out = {"query_id": qid, "state": entry["state"]}
            out.update(self._results.get(qid, {}))
            return out

    def queries(self) -> Dict:
        with self._lock:
            return {"queries": list(self._queries.values())[-100:]}

    def status(self) -> Dict:
        return {
            "tables": {n: {"rows": t.row_count, "columns": list(t.schema)}
                       for n, t in self.catalog.tables.items()},
            "backend": self.device.type,
            "devices": 1,
            "distributed": False,
            "memory": device_memory_stats(self.device),
        }


def make_http_server(service: QueryService, port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj):
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if self.path == "/metrics":
                self._send(200, METRICS.dump())
            elif self.path == "/status":
                self._send(200, service.status())
            elif self.path == "/queries":
                self._send(200, service.queries())
            elif url.path == "/logs":
                try:
                    self._send(200, {"logs": RING.search(
                        pattern=q.get("q", [""])[0],
                        level=q.get("level", [""])[0],
                        limit=int(q.get("limit", ["200"])[0]))})
                except Exception as e:  # a bad regex, a bad limit
                    self._send(400, {"error": str(e)})
            elif url.path == "/result":
                try:
                    qid = int(q["id"][0])
                except (KeyError, ValueError):
                    self._send(400, {"error": "need ?id=<query_id>"})
                    return
                self._send(200, service.result(qid))
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            try:
                if self.path == "/query":
                    run = service.execute_async if req.get("async") else service.execute
                    self._send(200, run(req["plan"], req.get("distributed"),
                                        settings_override=req.get("settings")))
                elif self.path == "/cancel":
                    self._send(200, service.cancel(int(req["query_id"])))
                elif self.path == "/failpoint":
                    action = req.get("action")
                    if action == "enable":
                        FailPoint.enable(req["name"], req.get("probability"))
                    elif action == "pause":
                        FailPoint.enable(req["name"], pause=True)
                    else:
                        FailPoint.disable(req["name"])
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except QueryCancelled as e:
                self._send(499, {**error_payload(e), "kind": "cancelled"})
            except FailPointError as e:
                self._send(500, {**error_payload(e), "kind": "failpoint"})
            except (KeyError, ValueError) as e:
                self._send(400, error_payload(e))
            except Exception as e:  # engine errors answer 500
                self._send(500, error_payload(e))

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_background(service: QueryService, port: int = 0):
    """Start the HTTP server on a daemon thread; returns (server, port)."""
    httpd = make_http_server(service, port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


__all__ = ["QueryService", "make_http_server", "serve_background"]
