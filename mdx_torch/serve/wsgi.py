"""Minimal from-scratch WSGI micro-framework: the port's copy of
``mdx/serve/wsgi.py``.

Flask is not part of this deployment footprint, so the JSON API surface
(ref backend/app.py) runs on this ~200-line router instead: path-parameter
routing, JSON request/response helpers, multipart/form-data uploads, file
responses, CORS, and a max-body-size guard.  Pure stdlib.  One addition:
:meth:`App.make_server` returns the threading server ``run`` serves on, so
a caller can serve on a free port (port 0) and shut it down.
"""

from __future__ import annotations


import json
import mimetypes
import os
import re
import threading
from typing import Any, Callable, Iterable
from wsgiref.simple_server import WSGIServer, WSGIRequestHandler, make_server

_STATUS_TEXT = {
    200: "200 OK", 202: "202 Accepted", 204: "204 No Content",
    302: "302 Found",
    400: "400 Bad Request", 403: "403 Forbidden", 404: "404 Not Found",
    405: "405 Method Not Allowed", 413: "413 Payload Too Large",
    500: "500 Internal Server Error",
}


class Request:
    """Parsed WSGI request: JSON body, query args, multipart files."""

    def __init__(self, environ: dict, max_content_length: int):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = _parse_qs(environ.get("QUERY_STRING", ""))
        self._max = max_content_length
        self._body: bytes | None = None

    @property
    def content_length(self) -> int:
        try:
            return int(self.environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            return 0

    @property
    def body(self) -> bytes:
        if self._body is None:
            n = self.content_length
            if n > self._max:
                raise PayloadTooLarge()
            self._body = self.environ["wsgi.input"].read(n) if n else b""
        return self._body

    def json(self) -> dict[str, Any]:
        try:
            data = json.loads(self.body.decode("utf-8"))
            return data if isinstance(data, dict) else {}
        except Exception:
            return {}

    def files(self) -> dict[str, tuple[str, bytes]]:
        """Parse multipart/form-data → {field: (filename, content)}.
        Parsed once and cached (payloads run up to the 50 MB cap)."""
        cached = getattr(self, "_files", None)
        if cached is not None:
            return cached
        ctype = self.environ.get("CONTENT_TYPE", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if "multipart/form-data" not in ctype or not m:
            self._files = {}
        else:
            self._files = _parse_multipart(self.body, m.group(1).encode())
        return self._files

    def arg(self, name: str, default=None, type_: Callable | None = None):
        v = self.query.get(name, default)
        if v is not None and type_ is not None:
            try:
                return type_(v)
            except (TypeError, ValueError):
                return default
        return v


class PayloadTooLarge(Exception):
    pass


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 headers: list[tuple[str, str]] | None = None):
        self.body = body
        self.status = status
        self.headers = headers or []


def jsonify(data: Any, status: int = 200) -> Response:
    body = json.dumps(data).encode("utf-8")
    return Response(body, status, [("Content-Type", "application/json")])


def send_file(path: str, mimetype: str | None = None) -> Response:
    mimetype = mimetype or mimetypes.guess_type(path)[0] or "application/octet-stream"
    with open(path, "rb") as f:
        return Response(f.read(), 200, [("Content-Type", mimetype)])


class App:
    """Router: ``app.route("/api/runs/<run_id>/status", methods=["GET"])``."""

    def __init__(self, max_content_length: int = 50 * 1024 * 1024):
        self._routes: list[tuple[re.Pattern, set[str], Callable]] = []
        self.max_content_length = max_content_length
        self.cors = True
        # optional hook: (status, message) -> Response, used by HTML apps
        # so framework-level 413/404/500 render pages instead of raw JSON
        self.error_renderer: Callable[[int, str], Response] | None = None

    def route(self, pattern: str, methods: Iterable[str] = ("GET",)):
        regex = re.compile(
            "^" + re.sub(r"<(?:path:)?([a-zA-Z_]+)>",
                         lambda m: (f"(?P<{m.group(1)}>.+)"
                                    if m.group(0).startswith("<path:")
                                    else f"(?P<{m.group(1)}>[^/]+)"),
                         pattern) + "$")

        def deco(fn):
            self._routes.append((regex, {m.upper() for m in methods}, fn))
            return fn
        return deco

    # -- WSGI entry -----------------------------------------------------

    def __call__(self, environ, start_response):
        req = Request(environ, self.max_content_length)

        def _err(status: int, message: str) -> Response:
            if self.error_renderer is not None:
                try:
                    return self.error_renderer(status, message)
                except Exception:
                    pass
            return jsonify({"error": message}, status)

        try:
            resp = self._dispatch(req)
            if (resp.status in (404, 405) and self.error_renderer is not None
                    and resp.headers
                    and resp.headers[0][1].startswith("application/json")):
                resp = _err(resp.status, "Not found"
                            if resp.status == 404 else "Method not allowed")
        except PayloadTooLarge:
            resp = _err(413, "File too large (max 50 MB)")
        except Exception:  # pragma: no cover - defensive 500
            import traceback
            traceback.print_exc()
            resp = _err(500, "Internal server error")
        headers = list(resp.headers)
        if self.cors:
            headers.append(("Access-Control-Allow-Origin", "*"))
            headers.append(("Access-Control-Allow-Headers", "Content-Type"))
            headers.append(("Access-Control-Allow-Methods",
                            "GET, POST, OPTIONS"))
        headers.append(("Content-Length", str(len(resp.body))))
        start_response(_STATUS_TEXT.get(resp.status, f"{resp.status} "),
                       headers)
        return [resp.body]

    def _dispatch(self, req: Request) -> Response:
        if req.method == "OPTIONS":  # CORS preflight
            return Response(b"", 204)
        allowed: set[str] = set()
        for regex, methods, fn in self._routes:
            m = regex.match(req.path)
            if not m:
                continue
            if req.method not in methods:
                allowed |= methods
                continue
            out = fn(req, **m.groupdict())
            if isinstance(out, Response):
                return out
            if isinstance(out, tuple):
                return jsonify(out[0], out[1])
            return jsonify(out)
        if allowed:
            return jsonify({"error": "Method not allowed"}, 405)
        return jsonify({"error": "Not found"}, 404)

    # -- Dev/prod server -------------------------------------------------

    def make_server(self, host: str = "0.0.0.0", port: int = 5000):
        """The thread-per-request server on (host, port), not yet serving
        (``server.server_port`` is the port taken where ``port`` is 0)."""
        return make_server(host, port, self,
                           server_class=_ThreadingWSGIServer,
                           handler_class=_QuietHandler)

    def run(self, host: str = "0.0.0.0", port: int = 5000):
        server = self.make_server(host, port)
        print(f" * mdx API serving on http://{host}:{port}", flush=True)
        server.serve_forever()


class _ThreadingWSGIServer(WSGIServer):
    """Thread-per-request server (stdlib socketserver mixin inline)."""

    daemon_threads = True

    def process_request(self, request, client_address):
        t = threading.Thread(target=self._work, args=(request, client_address),
                             daemon=True)
        t.start()

    def _work(self, request, client_address):
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # keep stdout clean
        pass


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------


def _parse_qs(qs: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in qs.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[_unquote(k)] = _unquote(v)
    return out


def _unquote(s: str) -> str:
    from urllib.parse import unquote_plus
    return unquote_plus(s)


def _parse_multipart(body: bytes, boundary: bytes) -> dict[str, tuple[str, bytes]]:
    """RFC 7578 multipart/form-data parser (file parts only).

    Exactly ONE CRLF is removed on each side of a part — binary payloads
    legitimately end in 0x0D/0x0A bytes, so ``strip(b"\\r\\n")`` would
    silently truncate uploads."""
    out: dict[str, tuple[str, bytes]] = {}
    delim = b"--" + boundary
    for part in body.split(delim):
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part.rstrip(b"\r\n-") == b"":
            continue
        header_blob, sep, content = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        headers = header_blob.decode("utf-8", "replace")
        m_name = re.search(r'name="([^"]*)"', headers)
        m_file = re.search(r'filename="([^"]*)"', headers)
        if not m_name:
            continue
        filename = m_file.group(1) if m_file else ""
        out[m_name.group(1)] = (filename, content)
    return out


def secure_filename(name: str) -> str:
    """Strip path separators / control chars from an upload filename."""
    name = os.path.basename(name.replace("\\", "/"))
    name = re.sub(r"[^A-Za-z0-9_.\-]", "_", name)
    return name.strip("._") or ""
