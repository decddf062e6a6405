"""An elasticsearch in the repo, for the elastic store.

The port's copy of seaweedfs_tpu/filer/fake_elastic.py: the REST/JSON
subset elastic_store.py sends (index creation, document PUT/GET/DELETE
by id, ``_search`` with bool filters of term, range and prefix, a sort
and a size, ``_delete_by_query``), with optional basic auth, on a
threaded HTTP server over indices in memory.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote, urlparse

_DOC = re.compile(r"^/([^/]+)/_doc/(.+)$")
_INDEX = re.compile(r"^/([^/]+)$")
_SEARCH = re.compile(r"^/([^/]+)/_search$")
_DELQ = re.compile(r"^/([^/]+)/_delete_by_query$")
_CMP = {"gt": lambda a, b: a > b, "gte": lambda a, b: a >= b,
        "lt": lambda a, b: a < b, "lte": lambda a, b: a <= b}
_NO_INDEX = {"error": {"type": "index_not_found_exception"}}


def _match_filter(src: dict, f: dict) -> bool:
    if "term" in f:
        ((field, want),) = f["term"].items()
        return src.get(field) == want
    if "prefix" in f:
        ((field, want),) = f["prefix"].items()
        return str(src.get(field, "")).startswith(want)
    if "range" in f:
        ((field, conds),) = f["range"].items()
        v = src.get(field)
        return v is not None and all(_CMP[op](v, rhs)
                                     for op, rhs in conds.items()
                                     if op in _CMP)
    raise ValueError(f"fake_elastic: unsupported filter {f}")


def _match_query(src: dict, query: dict) -> bool:
    if not query:
        return True
    if "bool" in query:
        b = query["bool"]
        if "filter" in b and not all(_match_filter(src, f)
                                     for f in b["filter"]):
            return False
        if "should" in b and not any(_match_filter(src, f)
                                     for f in b["should"]):
            return False
        return True
    return _match_filter(src, query)


def _make_handler(indices: dict, lock: threading.Lock, auth: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, status: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            return json.loads(raw) if raw else {}

        def _route(self):
            """The request's path, or None once a 401 was sent."""
            if auth and self.headers.get("Authorization") != auth:
                self._reply(401, {"error": "unauthorized"})
                return None
            return urlparse(self.path).path

        def do_GET(self):
            path = self._route()
            if path is None:
                return
            if path == "/":
                self._reply(200, {"name": "fake-elastic",
                                  "version": {"number": "7.0.0-fake"}})
                return
            m = _DOC.match(path)
            if not m:
                self._reply(404, {"found": False})
                return
            idx, doc_id = m.group(1), unquote(m.group(2))
            with lock:
                src = indices.get(idx, {}).get(doc_id)
            if src is None:
                self._reply(404, {"found": False, "_id": doc_id})
            else:
                self._reply(200, {"found": True, "_id": doc_id,
                                  "_source": src})

        def do_PUT(self):
            path = self._route()
            if path is None:
                return
            m = _DOC.match(path)
            if m:
                idx, doc_id = m.group(1), unquote(m.group(2))
                src = self._body()
                with lock:
                    indices.setdefault(idx, {})[doc_id] = src
                self._reply(200, {"result": "updated", "_id": doc_id})
                return
            m = _INDEX.match(path)
            if not m:
                self._reply(400, {"error": "bad path"})
                return
            with lock:
                exists = m.group(1) in indices
                indices.setdefault(m.group(1), {})
            if exists:
                self._reply(400, {"error": {
                    "type": "resource_already_exists_exception"}})
            else:
                self._reply(200, {"acknowledged": True})

        def do_DELETE(self):
            path = self._route()
            if path is None:
                return
            m = _DOC.match(path)
            if not m:
                self._reply(400, {"error": "bad path"})
                return
            idx, doc_id = m.group(1), unquote(m.group(2))
            with lock:
                existed = indices.get(idx, {}).pop(doc_id, None)
            if existed is None:
                self._reply(404, {"result": "not_found"})
            else:
                self._reply(200, {"result": "deleted"})

        def do_POST(self):
            path = self._route()
            if path is None:
                return
            body = self._body()
            query = body.get("query", {})
            m = _SEARCH.match(path) or _DELQ.match(path)
            if not m:
                self._reply(404, {"error": f"no route {path}"})
                return
            with lock:
                coll = indices.get(m.group(1))
                if coll is None:
                    matched = None
                else:
                    matched = [(doc_id, src) for doc_id, src in coll.items()
                               if _match_query(src, query)]
                    if m.re is _DELQ:
                        for doc_id, _ in matched:
                            del coll[doc_id]
            if matched is None:
                self._reply(404, _NO_INDEX)
            elif m.re is _DELQ:
                self._reply(200, {"deleted": len(matched)})
            else:
                for sort in reversed(body.get("sort", [])):
                    ((field, order),) = (sort.items()
                                         if isinstance(sort, dict)
                                         else ((sort, "asc"),))
                    if isinstance(order, dict):
                        order = order.get("order", "asc")
                    matched.sort(key=lambda r: r[1].get(field) or "",
                                 reverse=order == "desc")
                hits = [{"_id": doc_id, "_source": src} for doc_id, src
                        in matched[:int(body.get("size", 10))]]
                self._reply(200, {"hits": {"total": {"value": len(matched)},
                                           "hits": hits}})

    return Handler


class FakeElasticServer:
    def __init__(self, host: str = "127.0.0.1", auth: str = "",
                 port: int = 0):
        self.indices: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._srv = ThreadingHTTPServer(
            (host, port), _make_handler(self.indices, self._lock, auth))
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def servers(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
