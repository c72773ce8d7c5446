"""Control-plane RPC transport (the port's copy of
``dlrover_tpu/rpc/transport.py``).

Two unary methods — ``get`` and ``report`` — carrying an opaque pickled
:class:`dlrover_tpu_torch.common.comm.Message` envelope, mirroring the
reference's wire protocol (proto/elastic_training.proto:26-29,
master/servicer.py:912 GrpcMasterServicer, elastic_agent/master_client.py).

The port's transport is HTTP (stdlib only, the same two-verb surface;
reference servicer.py:994 HttpMasterServicer), and ``"http"`` is its
default kind, so the port's control plane needs no ``grpcio``. The gRPC
server and stub (generic method handlers, so no protoc-generated stubs;
bytes in, bytes out) stay for callers that ask for ``kind="grpc"``,
and import ``grpc`` only when one is built.
"""

import abc
import http.client
import os
import signal
import socket
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.comm import Message
from dlrover_tpu_torch.common.log import logger

SERVICE_NAME = "dlrover_tpu_torch.Master"
GET_METHOD = f"/{SERVICE_NAME}/get"
REPORT_METHOD = f"/{SERVICE_NAME}/report"

GRPC_MAX_MESSAGE = 512 * 1024 * 1024  # checkpoints metadata can be chunky

# wait_ready is bounded on both stubs (blocking-wait audit, ISSUE 5):
# the default below caps how long a worker stalls on an absent master,
# and every expiry ticks a counter so "could not reach the master in
# time" shows up on /metrics instead of only in scattered caller logs.
WAIT_READY_TIMEOUT_S = 60.0

# Env-tunable socket phases for the HTTP stub: connect (TCP handshake
# to the master) and read (waiting on a reply over an established
# connection) fail differently — a hung master accepts connections and
# then never answers, so a single coarse timeout either stalls workers
# or flakes connects. Either unset falls back to the stub's ctor
# timeout; a hung master then surfaces as a bounded socket.timeout (a
# retryable transport error) instead of a stuck thread.
CONNECT_TIMEOUT_ENV = "DLROVER_TPU_RPC_CONNECT_TIMEOUT_S"
READ_TIMEOUT_ENV = "DLROVER_TPU_RPC_READ_TIMEOUT_S"


def _env_timeout(name: str) -> Optional[float]:
    raw = os.getenv(name, "")
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return None
    return val if val > 0 else None


def _wait_ready_expired_counter():
    from dlrover_tpu_torch.observability.registry import default_registry

    return default_registry().counter(
        "rpc_wait_ready_expired_total",
        "bounded master wait_ready calls that timed out",
    )


class MasterService(abc.ABC):
    """What a master must implement to be served over any transport."""

    @abc.abstractmethod
    def get(self, message: Message) -> Message:
        ...

    @abc.abstractmethod
    def report(self, message: Message) -> Message:
        ...


def _generic_handler(service: MasterService):
    """The gRPC generic handler serving ``service`` (its base class is
    grpc's, so the class is built where grpc is imported)."""
    import grpc

    class _GenericHandler(grpc.GenericRpcHandler):
        def __init__(self, service: MasterService):
            self._service = service

        def service(self, handler_call_details):
            method = handler_call_details.method
            if method == GET_METHOD:
                return grpc.unary_unary_rpc_method_handler(self._handle_get)
            if method == REPORT_METHOD:
                return grpc.unary_unary_rpc_method_handler(
                    self._handle_report
                )
            return None

        def _handle_get(self, request: bytes, context) -> bytes:
            try:
                msg = Message.deserialize(request)
                return self._service.get(msg).serialize()
            except Exception:
                logger.exception("error handling get RPC")
                context.abort(grpc.StatusCode.INTERNAL, "get failed")

        def _handle_report(self, request: bytes, context) -> bytes:
            try:
                msg = Message.deserialize(request)
                return self._service.report(msg).serialize()
            except Exception:
                logger.exception("error handling report RPC")
                context.abort(grpc.StatusCode.INTERNAL, "report failed")

    return _GenericHandler(service)


class GrpcMasterServer:
    def __init__(self, port: int, service: MasterService, max_workers: int = 64):
        import grpc

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", GRPC_MAX_MESSAGE),
                ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE),
            ],
        )
        self._server.add_generic_rpc_handlers([_generic_handler(service)])
        self.port = self._server.add_insecure_port(f"[::]:{port}")
        if self.port == 0:
            raise RuntimeError(f"failed to bind master RPC port {port}")

    def start(self):
        self._server.start()

    def stop(self, grace: float = 1.0):
        self._server.stop(grace)


class GrpcMasterStub:
    """Client side of the two-verb protocol."""

    def __init__(self, addr: str, timeout: float = 10.0):
        import grpc

        self._grpc = grpc
        self._addr = addr
        self._timeout = timeout
        self._channel = grpc.insecure_channel(
            addr,
            options=[
                ("grpc.max_send_message_length", GRPC_MAX_MESSAGE),
                ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE),
                # No transparent transport retries: mutations (kv add,
                # rendezvous join) must be applied at most once per call.
                ("grpc.enable_retries", 0),
            ],
        )
        self._get = self._channel.unary_unary(GET_METHOD)
        self._report = self._channel.unary_unary(REPORT_METHOD)

    def get(self, message: Message, timeout: Optional[float] = None) -> Message:
        data = self._get(message.serialize(), timeout=timeout or self._timeout)
        return Message.deserialize(data)

    def report(self, message: Message, timeout: Optional[float] = None) -> Message:
        data = self._report(
            message.serialize(), timeout=timeout or self._timeout
        )
        return Message.deserialize(data)

    def wait_ready(self, timeout: float = WAIT_READY_TIMEOUT_S) -> bool:
        grpc = self._grpc
        try:
            grpc.channel_ready_future(self._channel).result(timeout=timeout)
            return True
        except grpc.FutureTimeoutError:
            _wait_ready_expired_counter().inc()
            return False

    def close(self):
        self._channel.close()


# --------------------------------------------------------------------------
# HTTP transport (same two-verb surface, stdlib only)
# --------------------------------------------------------------------------


class _HttpHandler(BaseHTTPRequestHandler):
    service: MasterService = None  # class attr injected by server factory
    # HTTP/1.1: responses carry Content-Length (set below) and the
    # connection stays open between requests — required for the stub's
    # keep-alive to actually keep anything alive (1.0 closes per call).
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on each connection. A reply goes out in two writes
    # (the headers, then the body); with Nagle on, the body waits for
    # the client's delayed ACK of the headers, about 40 ms on Linux,
    # on every RPC of a keep-alive connection (the reference's handler
    # leaves it on).
    disable_nagle_algorithm = True

    def log_message(self, *args):  # quiet
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            msg = Message.deserialize(body)
            if self.path == "/get":
                resp = self.service.get(msg)
            elif self.path == "/report":
                resp = self.service.report(msg)
            else:
                self.send_error(404)
                return
            payload = resp.serialize()
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except Exception:
            logger.exception("error handling HTTP RPC %s", self.path)
            self.send_error(500)


class _FleetHTTPServer(ThreadingHTTPServer):
    # The stdlib default listen backlog is 5: a fleet of workers (or a
    # rendezvous storm of 1k joiners) opening connections together gets
    # its SYNs dropped and the clients burn ~1s retry backoffs — the
    # §32 load harness measured exactly that. 128 rides the kernel's
    # somaxconn clamp.
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._open_conns: set = set()
        self._conns_mu = threading.Lock()

    def process_request_thread(self, request, client_address):
        with self._conns_mu:
            self._open_conns.add(request)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conns_mu:
                self._open_conns.discard(request)

    def close_open_connections(self):
        """Sever established keep-alive connections. shutdown() only
        stops the accept loop — handler threads parked on persistent
        client connections would otherwise keep answering for a stopped
        master generation (epoch fencing, DESIGN.md §37: a stub must
        fail over to the restarted master, not a zombie thread)."""
        with self._conns_mu:
            conns = list(self._open_conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class HttpMasterServer:
    def __init__(self, port: int, service: MasterService):
        handler = type("BoundHandler", (_HttpHandler,), {"service": service})
        self._httpd = _FleetHTTPServer(("", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._service = service
        self._shutdown_hooks: List[Callable[[], None]] = []
        self._stopped = False

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-master"
        )
        self._thread.start()

    def add_shutdown_hook(self, fn: Callable[[], None]):
        """Run ``fn`` during graceful_stop AFTER in-flight requests have
        drained — the journal flush/close hook goes here so the last
        handled verb's records are durable before the process exits."""
        self._shutdown_hooks.append(fn)

    def graceful_stop(self, drain_s: float = 5.0):
        """SIGTERM-quality shutdown (DESIGN.md §37): stop accepting new
        connections, wait (bounded) for in-flight handlers to drain,
        then run shutdown hooks (journal flush+fsync) and close. Idem-
        potent; plain stop() remains the abrupt path."""
        if self._stopped:
            return
        self._stopped = True
        # shutdown() stops the accept loop; handler threads already
        # spawned by ThreadingHTTPServer keep running their request.
        self._httpd.shutdown()
        inflight = getattr(
            getattr(self._service, "telemetry", None), "inflight_now", None
        )
        if callable(inflight):
            deadline = time.monotonic() + max(drain_s, 0.0)
            while inflight() > 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            left = inflight()
            if left:
                logger.warning(
                    "graceful stop: %d RPCs still in flight after %.1fs "
                    "drain window",
                    left,
                    drain_s,
                )
        for hook in self._shutdown_hooks:
            try:
                hook()
            except Exception:
                logger.exception("shutdown hook %s failed", hook)
        self._httpd.close_open_connections()
        self._httpd.server_close()

    def install_sigterm_handler(self, drain_s: float = 5.0):
        """Route SIGTERM to graceful_stop (main thread only; signal
        module refuses elsewhere). Chains to any previous handler so
        process-level cleanup still runs."""
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            self.graceful_stop(drain_s=drain_s)
            if callable(prev) and prev not in (
                signal.SIG_IGN,
                signal.SIG_DFL,
            ):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _on_term)

    def stop(self, grace: float = 1.0):
        if self._stopped:
            return
        self._stopped = True
        self._httpd.shutdown()
        self._httpd.close_open_connections()
        self._httpd.server_close()


class HttpMasterStub:
    """Keep-alive client: one persistent TCP connection per calling
    thread (http.client connections are not thread-safe, and the
    prefetcher/heartbeat/training threads all share a stub), reconnecting
    on error. The old connection-per-call behavior cost a TCP handshake
    on every control RPC — measurable at the data path's per-shard
    cadence."""

    def __init__(self, addr: str, timeout: float = 10.0):
        self._host, port = addr.rsplit(":", 1)
        self._port = int(port)
        self._timeout = timeout
        # Env overrides (read once at construction so a long-lived stub
        # is consistent): connect bounds the TCP handshake, read bounds
        # each wait for reply bytes on the established socket.
        self._connect_timeout = _env_timeout(CONNECT_TIMEOUT_ENV)
        self._read_timeout = _env_timeout(READ_TIMEOUT_ENV)
        self._local = threading.local()
        self._closed = False

    def _connection(self, timeout=None):
        """(conn, reused): reused tells the caller whether a failure may
        be a stale keep-alive socket rather than a dead master."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            if (
                self._read_timeout is not None
                and getattr(conn, "sock", None) is None
            ):
                # The peer closed the keep-alive socket. With split
                # timeouts, http.client's silent auto-reconnect would
                # stamp the (short) connect timeout on the new socket
                # and apply it to reads — rebuild through the eager-
                # connect path below instead.
                self._drop_connection()
            else:
                return conn, True
        base = timeout or self._timeout
        conn = http.client.HTTPConnection(
            self._host, self._port,
            timeout=self._connect_timeout or base,
        )
        # http.client stamps the connection timeout onto the socket at
        # connect(); connecting eagerly here lets the read phase get its
        # own (usually longer) bound — a master that accepts but never
        # answers surfaces as socket.timeout instead of a stuck thread.
        read_timeout = self._read_timeout or base
        if read_timeout != (self._connect_timeout or base):
            conn.connect()
            conn.sock.settimeout(read_timeout)
        self._local.conn = conn
        return conn, False

    def _drop_connection(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already broken
                pass

    # A reused connection dying with one of these before any response
    # bytes means the server idled the socket out before reading the
    # request — it was never processed, so ONE transparent retry on a
    # fresh connection preserves at-most-once semantics. Anything else
    # (or the same failure on a fresh connection) propagates: mutations
    # must not be transparently re-sent (mirrors the gRPC stub's
    # enable_retries=0).
    _STALE_ERRORS = (
        http.client.RemoteDisconnected,
        http.client.BadStatusLine,
        BrokenPipeError,
        ConnectionResetError,
    )

    def _call(self, path: str, message: Message, timeout=None) -> Message:
        body = message.serialize()
        for attempt in (1, 2):
            if attempt > 1:
                # The transparent stale-keep-alive re-send below is the
                # SAME logical RPC: the active span (opened by the
                # client's retry wrapper or any caller) records it as
                # an incremented retry attr, never a sibling span — so
                # the at-most-once story stays legible in one trace.
                from dlrover_tpu_torch.observability import tracing

                tracing.bump_current("retry")
            conn, reused = self._connection(timeout)
            try:
                conn.request("POST", path, body=body)
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    raise RuntimeError(
                        f"RPC {path} failed: HTTP {resp.status}"
                    )
                return Message.deserialize(resp.read())
            except RuntimeError:
                self._drop_connection()
                raise
            except self._STALE_ERRORS:
                self._drop_connection()
                if not reused or self._closed:
                    raise
            except Exception:
                self._drop_connection()
                raise
        raise RuntimeError(f"RPC {path} failed after reconnect")

    def get(self, message: Message, timeout=None) -> Message:
        return self._call("/get", message, timeout)

    def report(self, message: Message, timeout=None) -> Message:
        return self._call("/report", message, timeout)

    def wait_ready(self, timeout: float = WAIT_READY_TIMEOUT_S) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                self._call("/get", Message())
                return True
            except Exception:
                time.sleep(0.5)
        _wait_ready_expired_counter().inc()
        return False

    def close(self):
        self._closed = True
        self._drop_connection()


DEFAULT_KIND = "http"


def _check_kind(kind: str):
    if kind not in ("http", "grpc"):
        raise ValueError(f"unknown transport {kind!r}: 'http' or 'grpc'")


def create_master_server(port: int, service: MasterService,
                         kind: str = DEFAULT_KIND):
    _check_kind(kind)
    if kind == "http":
        return HttpMasterServer(port, service)
    return GrpcMasterServer(port, service)


def build_master_stub(addr: str, kind: str = DEFAULT_KIND,
                      timeout: float = 10.0):
    _check_kind(kind)
    if kind == "http":
        return HttpMasterStub(addr, timeout)
    return GrpcMasterStub(addr, timeout)
