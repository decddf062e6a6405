"""Minimal in-repo Azure Blob service for the tests and the smoke.

The port's copy of seaweedfs_tpu/replication/fake_azure.py, whole. The
Azure sink (replication/sink.py AzureSink, counterpart of
weed/replication/sink/azuresink/azure_sink.go) is proven against this
fake without cloud access: a threaded HTTP server implementing Put
Blob, Put Block, Put Block List, Delete Blob and Get Blob with real
SharedKey signature verification (the same azure_shared_key_signature
the sink uses, so a canonicalization bug on either side fails a test).
Same pattern as replication/fake_gcs.py.
"""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .sink import azure_shared_key_signature


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a) -> None:
        pass

    @property
    def srv(self) -> "FakeAzureServer":
        return self.server.owner  # type: ignore

    def _reject(self, code: int, msg: str) -> None:
        body = msg.encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _auth_ok(self, verb: str, path: str, query: dict,
                 body_len: int) -> bool:
        auth = self.headers.get("Authorization", "")
        want_prefix = f"SharedKey {self.srv.account}:"
        if not auth.startswith(want_prefix):
            return False
        given = auth[len(want_prefix):]
        expect = azure_shared_key_signature(
            self.srv.account, self.srv.key, verb, path, query,
            dict(self.headers.items()), body_len)
        import hmac
        return hmac.compare_digest(given, expect)

    def _parse(self):
        parsed = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(parsed.path)
        query = dict(urllib.parse.parse_qsl(parsed.query,
                                            keep_blank_values=True))
        parts = path.lstrip("/").split("/", 1)
        container = parts[0] if parts else ""
        blob = parts[1] if len(parts) > 1 else ""
        return path, query, container, blob

    def do_PUT(self) -> None:
        path, query, container, blob = self._parse()
        length = int(self.headers.get("Content-Length", "0") or 0)
        body = self.rfile.read(length) if length else b""
        if not self._auth_ok("PUT", path, query, length):
            return self._reject(403, "AuthenticationFailed")
        if not container or not blob:
            return self._reject(400, "InvalidUri")
        with self.srv.lock:
            cont = self.srv.containers.setdefault(container, {})
            comp = query.get("comp", "")
            if comp == "block":
                bid = query.get("blockid", "")
                if not bid:
                    return self._reject(400, "MissingBlockId")
                self.srv.blocks.setdefault((container, blob), {})[bid] = \
                    body
            elif comp == "blocklist":
                staged = self.srv.blocks.pop((container, blob), {})
                ids = []
                import re
                for m in re.finditer(
                        rb"<(?:Latest|Committed|Uncommitted)>([^<]+)</",
                        body):
                    ids.append(m.group(1).decode())
                try:
                    cont[blob] = b"".join(staged[i] for i in ids)
                except KeyError:
                    return self._reject(400, "InvalidBlockList")
            else:
                if self.headers.get("x-ms-blob-type") != "BlockBlob":
                    return self._reject(400, "UnsupportedBlobType")
                cont[blob] = body
        self.send_response(201)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self) -> None:
        path, query, container, blob = self._parse()
        if not self._auth_ok("DELETE", path, query, 0):
            return self._reject(403, "AuthenticationFailed")
        with self.srv.lock:
            cont = self.srv.containers.get(container, {})
            if blob not in cont:
                return self._reject(404, "BlobNotFound")
            del cont[blob]
        self.send_response(202)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self) -> None:
        # unauthenticated readback for test assertions
        _path, _query, container, blob = self._parse()
        with self.srv.lock:
            data: Optional[bytes] = self.srv.containers.get(
                container, {}).get(blob)
        if data is None:
            return self._reject(404, "BlobNotFound")
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class FakeAzureServer:
    def __init__(self, account: str = "devaccount",
                 key_b64: str = "ZmFrZS1henVyZS1rZXktZm9yLWNp",
                 host: str = "127.0.0.1", port: int = 0):
        self.account = account
        self.key = key_b64
        self.containers: dict[str, dict[str, bytes]] = {}
        self.blocks: dict[tuple, dict[str, bytes]] = {}
        self.lock = threading.Lock()
        self._http = ThreadingHTTPServer((host, port), _Handler)
        self._http.owner = self  # type: ignore
        self.host, self.port = self._http.server_address
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._http.shutdown()
        self._http.server_close()
