"""The elasticsearch filer store: documents keyed by path, one search a
listing.

The port's copy of seaweedfs_tpu/filer/elastic_store.py (upstream
weed/filer/elastic/v7/elastic_store.go:33-130): an entry is a document
in the ``.seaweedfs_filemeta`` index whose id is the quoted full path,
carrying its directory (``ParentId``) and ``Name``, so a listing is one
filtered search sorted by ``Name``; the KV face has an index of its own
(indexKV, :19-30). The layout is the reference's one index rather than
upstream's index per top directory. The transport is the REST/JSON API
(``_doc``, ``_search``, ``_delete_by_query``) through blocking ``urllib``
calls bounded by the caller's deadline budget (utils/retry.py), so the
filer server makes its store calls in an executor. The tests and the
smoke run it against fake_elastic.py.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Optional
from urllib.parse import quote

from ..utils import retry
from .entry import Entry
from .stores import FilerStore, _split

INDEX = ".seaweedfs_filemeta"
INDEX_KV = ".seaweedfs_kv_entries"  # elastic_store.go:20
# keyword fields: a dynamic mapping makes ParentId and Name analyzed
# text, whose term queries match tokens and which cannot be sorted
_MAPPINGS = ((INDEX, {"ParentId": {"type": "keyword"},
                      "Name": {"type": "keyword"},
                      "Entry": {"type": "text", "index": False}}),
             (INDEX_KV, {"Value": {"type": "binary"}}))


class ElasticStore(FilerStore):
    name = "elastic"

    def __init__(self, servers: str = "http://127.0.0.1:9200",
                 username: str = "", password: str = "",
                 timeout: float = 10.0, **_):
        base = servers.split(",")[0]
        if not base.startswith("http"):
            base = "http://" + base
        self._base = base.rstrip("/")
        self._timeout = timeout
        self._auth = None
        if username and password:
            self._auth = "Basic " + base64.b64encode(
                f"{username}:{password}".encode()).decode()
        self._call("GET", "/")  # reachable?
        for index, props in _MAPPINGS:
            try:
                self._call("PUT", f"/{index}",
                           {"mappings": {"properties": props}})
            except urllib.error.HTTPError as e:
                body = e.read().decode("utf-8", "replace")
                if e.code == 400 and "resource_already_exists" in body:
                    continue  # made by an earlier run
                raise

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None,
              ok_missing: bool = False) -> Optional[dict]:
        req = urllib.request.Request(
            self._base + path,
            data=(json.dumps(payload).encode()
                  if payload is not None else None),
            headers={"Content-Type": "application/json",
                     **({"Authorization": self._auth}
                        if self._auth else {})},
            method=method)
        try:
            with urllib.request.urlopen(
                    req, timeout=retry.cap_timeout(self._timeout)) as r:
                body = r.read()
                return json.loads(body) if body else {}
        except urllib.error.HTTPError as e:
            if e.code == 404 and ok_missing:
                return None
            raise

    @staticmethod
    def _doc_id(path: str) -> str:
        return quote(path, safe="")

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        self._call("PUT",
                   f"/{INDEX}/_doc/{self._doc_id(entry.full_path)}"
                   "?refresh=true",
                   {"ParentId": d, "Name": name, "Entry": entry.to_json()})

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Optional[Entry]:
        doc = self._call("GET", f"/{INDEX}/_doc/{self._doc_id(path)}",
                         ok_missing=True)
        if doc is None or not doc.get("found"):
            return None
        return Entry.from_json(doc["_source"]["Entry"])

    def delete_entry(self, path: str) -> None:
        self._call("DELETE",
                   f"/{INDEX}/_doc/{self._doc_id(path)}?refresh=true",
                   ok_missing=True)

    def delete_folder_children(self, path: str) -> None:
        # the children by ParentId, the deeper tree by its prefix (every
        # ParentId starts with "/": the root's deep prefix is "/")
        base = path.rstrip("/") or "/"
        deep_prefix = "/" if base == "/" else base + "/"
        self._call("POST", f"/{INDEX}/_delete_by_query?refresh=true", {
            "query": {"bool": {"should": [
                {"term": {"ParentId": base}},
                {"prefix": {"ParentId": deep_prefix}},
            ]}}}, ok_missing=True)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        filters: list[dict] = [{"term": {"ParentId": dir_path}}]
        if start_file_name:
            op = "gte" if include_start else "gt"
            filters.append({"range": {"Name": {op: start_file_name}}})
        if prefix:
            filters.append({"prefix": {"Name": prefix}})
        result = self._call("POST", f"/{INDEX}/_search", {
            "query": {"bool": {"filter": filters}},
            "sort": [{"Name": "asc"}],
            "size": limit,
        }, ok_missing=True)  # no index yet: an empty listing
        if result is None:
            return []
        return [Entry.from_json(hit["_source"]["Entry"])
                for hit in result["hits"]["hits"]]

    def kv_put(self, key: str, value: bytes) -> None:
        self._call("PUT", f"/{INDEX_KV}/_doc/{self._doc_id(key)}"
                   "?refresh=true",
                   {"Value": base64.b64encode(value).decode()})

    def kv_get(self, key: str) -> Optional[bytes]:
        doc = self._call("GET", f"/{INDEX_KV}/_doc/{self._doc_id(key)}",
                         ok_missing=True)
        if doc is None or not doc.get("found"):
            return None
        return base64.b64decode(doc["_source"]["Value"])
