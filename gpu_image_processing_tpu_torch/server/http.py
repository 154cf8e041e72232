"""Minimal threaded HTTP/JSON framework on the standard library.

A copy of the JAX package's `server/http.py` (stdlib only), without the
supervisor's adopted listener.  The reference serves through FastAPI +
uvicorn (backend/app.py:29-43,526-543); this router has the same externally
visible behavior: JSON request/response bodies, permissive CORS
(`allow_origins=["*"]`), HTTPException-style error payloads
(``{"detail": ...}``), and multipart file upload support.

Handlers are plain functions `(Request) -> (status, payload_dict)` and are
directly unit-testable without sockets via `Router.dispatch`.
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional


class HTTPError(Exception):
    """FastAPI-HTTPException analog: carries status + detail."""

    def __init__(self, status_code: int, detail: str):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


@dataclass
class Request:
    method: str
    path: str
    headers: dict[str, str] = field(default_factory=dict)
    json: Optional[dict] = None
    files: dict[str, tuple[str, bytes]] = field(default_factory=dict)
    query: dict[str, str] = field(default_factory=dict)


Handler = Callable[[Request], tuple[int, Any]]


def parse_multipart(body: bytes, content_type: str) -> dict[str, tuple[str, bytes]]:
    """Parse multipart/form-data file fields -> {field: (filename, data)}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise HTTPError(400, "Malformed multipart request: missing boundary")
    boundary = b"--" + m.group(1).encode()
    files: dict[str, tuple[str, bytes]] = {}
    for part in body.split(boundary):
        # Trim exactly ONE leading/trailing CRLF -- the protocol delimiter
        # around each part (RFC 2046).  strip(b"\r\n") would also eat
        # trailing 0x0D/0x0A bytes belonging to the FILE DATA itself,
        # truncating binary uploads whose content ends in CR or LF.
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part.rstrip(b"-\r\n ") == b"":
            continue
        if b"\r\n\r\n" not in part:
            continue
        raw_headers, data = part.split(b"\r\n\r\n", 1)
        disp = ""
        for line in raw_headers.decode("latin-1").split("\r\n"):
            if line.lower().startswith("content-disposition"):
                disp = line
        name_m = re.search(r'name="([^"]*)"', disp)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if name_m:
            files[name_m.group(1)] = (
                file_m.group(1) if file_m else "",
                data,
            )
    return files


class Router:
    """Method+path exact-match routing with JSON marshalling."""

    def __init__(self):
        self._routes: dict[tuple[str, str], Handler] = {}

    def route(self, method: str, path: str):
        def deco(fn: Handler) -> Handler:
            self._routes[(method.upper(), path)] = fn
            return fn

        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def dispatch(self, request: Request) -> tuple[int, Any]:
        handler = self._routes.get((request.method.upper(), request.path))
        if handler is None:
            known_paths = {p for (_, p) in self._routes}
            if request.path in known_paths:
                return 405, {"detail": "Method Not Allowed"}
            return 404, {"detail": "Not Found"}
        try:
            return handler(request)
        except HTTPError as exc:
            return exc.status_code, {"detail": exc.detail}
        except Exception as exc:  # pragma: no cover - last-resort guard
            return 500, {"detail": f"Internal error: {exc}"}


_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, Authorization",
}


class InFlightGauge:
    """Requests currently inside a handler (ThreadingHTTPServer: one
    thread per connection, so a plain int needs the lock).  The RSS
    recycle watchdog drains on this before exiting (server/app.py)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def __enter__(self) -> "InFlightGauge":
        with self._lock:
            self._n += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._lock:
            self._n -= 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _max_in_flight() -> int:
    """Load-shedding cap: requests already inside handlers before new ones
    get an immediate 503 (0 disables).  Protects the worker when the
    device wedges (observed: relay windows where one execute blocks for
    minutes) -- without a cap every new request parks another thread plus
    its decoded buffers behind the stall."""
    import os

    try:
        return max(0, int(os.environ.get("GIP_TPU_MAX_IN_FLIGHT", "64")))
    except ValueError:
        return 64


def _max_body_bytes() -> int:
    """Request-body cap in bytes (GIP_TPU_MAX_BODY_MB, default 64; 0
    disables).  Oversized uploads are refused with 413 BEFORE the body is
    read: the in-flight gauge bounds threads but not bytes, so without
    this 64 concurrent multi-GB POSTs would be buffered in full -- the
    decode-bomb threshold only fires after buffering.  64 MB comfortably
    covers the 7 MP serving workload even base64-inflated.  (Hardening
    beyond the reference; its uvicorn stack has no body cap either.)"""
    import os

    try:
        mb = max(0, int(os.environ.get("GIP_TPU_MAX_BODY_MB", "64")))
    except ValueError:
        mb = 64
    return mb * 1024 * 1024


def make_handler_class(router: Router, in_flight: Optional[InFlightGauge] = None,
                       draining: Optional[threading.Event] = None):
    gauge = in_flight if in_flight is not None else InFlightGauge()
    drain_evt = draining if draining is not None else threading.Event()

    class JSONRequestHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Keep stdlib logging quiet; the app logs at a higher level.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, status: int, payload: Any) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # Keep-alive ends after this response (worker draining, or
                # the client asked) -- say so per HTTP/1.1.
                self.send_header("Connection", "close")
            for k, v in _CORS_HEADERS.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):  # CORS preflight
            self.send_response(204)
            for k, v in _CORS_HEADERS.items():
                self.send_header(k, v)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _handle(self, method: str) -> None:
            # Load shedding: when the device is wedged, requests pile up
            # one thread each behind the stall; past the cap, shed with an
            # immediate 503 (and close, so retries land fresh) instead of
            # parking unboundedly.
            cap = _max_in_flight()
            if cap and gauge.value >= cap:
                self.close_connection = True
                self._send(503, {
                    "detail": f"Server overloaded: {gauge.value} requests "
                              "in flight; retry shortly"})
                return
            # The WHOLE request -- body read through response write -- sits
            # inside the gauge: the recycle drain (server/app.py) must not
            # exit the process mid-body-read or mid-_send.
            with gauge:
                # Draining (worker recycle / graceful stop): whatever this
                # request's outcome (200, 400, 500), close the keep-alive
                # connection after it so the client's NEXT request goes to
                # the supervisor's listen backlog (and the replacement
                # worker) instead of dying with the exiting process.
                if drain_evt.is_set():
                    self.close_connection = True
                path, _, query_str = self.path.partition("?")
                req = Request(method=method, path=path,
                              headers=dict(self.headers))
                if query_str:
                    for pair in query_str.split("&"):
                        k, _, v = pair.partition("=")
                        req.query[k] = v
                # Join ALL Transfer-Encoding header values: a request
                # carrying "Transfer-Encoding: gzip" then a second
                # "Transfer-Encoding: chunked" line must still hit the 411
                # (reading only the first value would re-open the keep-alive
                # desync this check exists to block).
                te_all = ",".join(
                    self.headers.get_all("Transfer-Encoding") or [])
                if "chunked" in te_all.lower():
                    # This server reads exactly Content-Length bytes; a
                    # chunked body would be left unread on the stream and
                    # poison the next keep-alive request.  Rejected even
                    # when a Content-Length is ALSO present (the classic
                    # request-smuggling shape: reading CL bytes of chunk
                    # framing desyncs the connection just the same).  Per
                    # RFC 9112 answer 411 and close.
                    self.close_connection = True
                    self._send(411, {
                        "detail": "chunked transfer encoding not supported; "
                                  "send Content-Length"})
                    return
                try:
                    # ALL Content-Length headers, not just the first: a
                    # request with conflicting duplicates ('CL: 5' then
                    # 'CL: 50') framed on the first value leaves the
                    # remaining body bytes on the stream to be parsed as
                    # the next keep-alive request -- the same desync/
                    # smuggling shape as the chunked case.  RFC 9110
                    # s8.6: differing duplicate Content-Length values
                    # must be rejected.
                    cls = self.headers.get_all("Content-Length") or []
                    if len({v.strip() for v in cls}) > 1:
                        raise ValueError("conflicting Content-Length")
                    length = int(cls[0] if cls else 0)
                    if length < 0:
                        # "Content-Length: -1" parses but cannot frame a
                        # body -- and rfile.read(-1) would read until EOF,
                        # parking this handler thread (inside the in-flight
                        # gauge) until the client closes.
                        raise ValueError("negative Content-Length")
                except ValueError:
                    # A malformed Content-Length means the body can't be
                    # framed; treating it as 0 would leave the real body
                    # unread on a live keep-alive connection (desync).
                    self.close_connection = True
                    self._send(400, {"detail": "invalid Content-Length"})
                    return
                body_cap = _max_body_bytes()
                if body_cap and length > body_cap:
                    # Refuse BEFORE buffering; close so the unread body
                    # bytes in flight don't poison the keep-alive stream.
                    self.close_connection = True
                    self._send(413, {
                        "detail": f"Request body {length} bytes exceeds "
                                  f"limit {body_cap} bytes "
                                  "(GIP_TPU_MAX_BODY_MB)"})
                    return
                body = self.rfile.read(length) if length else b""
                ctype = self.headers.get("Content-Type", "")
                try:
                    if body and "application/json" in ctype:
                        req.json = json.loads(body)
                    elif body and "multipart/form-data" in ctype:
                        req.files = parse_multipart(body, ctype)
                except (json.JSONDecodeError, HTTPError) as exc:
                    detail = getattr(exc, "detail",
                                     f"Invalid request body: {exc}")
                    self._send(400, {"detail": detail})
                    return
                status, payload = router.dispatch(req)
                if drain_evt.is_set():
                    self.close_connection = True
                self._send(status, payload)

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

    return JSONRequestHandler


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that does not spam tracebacks when a client
    disconnects mid-response (BrokenPipe/ConnectionReset are routine under
    load-generator churn and keep-alive teardown)."""

    def handle_error(self, request, client_address):  # noqa: D102
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError)):
            return
        super().handle_error(request, client_address)


class AppServer:
    """Threaded HTTP server wrapper (uvicorn analog).  Port 0 binds an
    ephemeral port; `port` then holds the one bound."""

    def __init__(self, router: Router, host: str, port: int):
        self.router = router
        self.host = host
        self.port = port
        self.in_flight = InFlightGauge()
        self.draining = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _make_httpd(self) -> ThreadingHTTPServer:
        handler = make_handler_class(self.router, self.in_flight,
                                     self.draining)
        httpd = _QuietThreadingHTTPServer((self.host, self.port), handler)
        self.port = httpd.server_address[1]
        return httpd

    def start_background(self) -> None:
        self._httpd = self._make_httpd()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd = self._make_httpd()
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        # Mark draining BEFORE stopping the accept loop so every response
        # sent from this point closes its keep-alive connection.
        self.draining.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
