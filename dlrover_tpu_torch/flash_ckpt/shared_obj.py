"""Cross-process shared objects between trainer and agent on one host
(a copy of ``dlrover_tpu/flash_ckpt/shared_obj.py``, with the port's
restricted unpickler): SharedLock, SharedQueue and SharedDict over Unix
domain sockets. The agent hosts tiny UDS servers; trainer processes
connect as clients. Used by the flash-checkpoint engine to hand the
agent save events and to serialize shm access.
"""

import os
import pickle
import queue as _queue
import socket
import threading
import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.log import logger

SOCKET_DIR_ENV = "DLROVER_TPU_SHARED_DIR"


def default_socket_dir() -> str:
    d = os.getenv(SOCKET_DIR_ENV, "")
    if not d:
        d = os.path.join(
            "/tmp", f"dlrover_tpu_{os.getenv('DLROVER_TPU_JOB_NAME', 'job')}"
        )
    os.makedirs(d, exist_ok=True)
    return d


def socket_path(name: str, sock_dir: str = "") -> str:
    return os.path.join(sock_dir or default_socket_dir(), f"{name}.sock")


def _recv_msg(conn: socket.socket) -> Optional[dict]:
    header = conn.recv(8)
    if len(header) < 8:
        return None
    size = int.from_bytes(header, "big")
    chunks = []
    while size > 0:
        chunk = conn.recv(min(size, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        size -= len(chunk)
    # UDS sockets are filesystem-permission scoped, but keep the same
    # no-arbitrary-code deserialization policy as every other boundary.
    from dlrover_tpu_torch.common.serialize import loads_pytree

    return loads_pytree(b"".join(chunks))


def _send_msg(conn: socket.socket, obj: Any):
    payload = pickle.dumps(obj)
    conn.sendall(len(payload).to_bytes(8, "big") + payload)


class _UdsServer(threading.Thread):
    """One request-per-connection UDS server running in the agent."""

    def __init__(self, name: str, handler, sock_dir: str = ""):
        super().__init__(daemon=True, name=f"uds-{name}")
        self._path = socket_path(name, sock_dir)
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self._path)
        self._sock.listen(64)
        self._handler = handler
        self._stopped = False

    def run(self):
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket):
        with conn:
            while True:
                try:
                    request = _recv_msg(conn)
                except (ConnectionResetError, OSError):
                    return
                if request is None:
                    return
                try:
                    response = self._handler(request)
                except Exception as e:  # noqa: BLE001
                    logger.exception("UDS handler error")
                    response = {"error": str(e)}
                try:
                    _send_msg(conn, response)
                except (BrokenPipeError, OSError):
                    return

    def stop(self):
        self._stopped = True
        try:
            self._sock.close()
        finally:
            if os.path.exists(self._path):
                os.unlink(self._path)


class _UdsClient:
    def __init__(self, name: str, sock_dir: str = "", connect_timeout: float = 60.0):
        self._path = socket_path(name, sock_dir)
        self._lock = threading.Lock()
        self._conn: Optional[socket.socket] = None
        self._connect_timeout = connect_timeout

    def _ensure_conn(self) -> socket.socket:
        if self._conn is None:
            deadline = time.time() + self._connect_timeout
            while True:
                try:
                    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    conn.connect(self._path)
                    self._conn = conn
                    break
                except (FileNotFoundError, ConnectionRefusedError):
                    if time.time() > deadline:
                        raise
                    time.sleep(0.1)
        return self._conn

    def call(self, request: dict) -> dict:
        with self._lock:
            conn = self._ensure_conn()
            try:
                _send_msg(conn, request)
                resp = _recv_msg(conn)
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._conn = None
                conn = self._ensure_conn()
                _send_msg(conn, request)
                resp = _recv_msg(conn)
            if resp is None:
                self._conn = None
                raise ConnectionError(f"UDS server {self._path} hung up")
            if "error" in resp:
                raise RuntimeError(resp["error"])
            return resp

    def close(self):
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


# --------------------------------------------------------------------------
# SharedQueue
# --------------------------------------------------------------------------


class SharedQueueServer:
    def __init__(self, name: str, maxsize: int = 0, sock_dir: str = ""):
        self._queue: _queue.Queue = _queue.Queue(maxsize)
        self._server = _UdsServer(f"queue-{name}", self._handle, sock_dir)
        self._server.start()

    def _handle(self, req: dict) -> dict:
        op = req["op"]
        if op == "put":
            try:
                self._queue.put(req["item"], timeout=req.get("timeout"))
                return {"ok": True}
            except _queue.Full:
                return {"ok": False, "full": True}
        if op == "get":
            try:
                item = self._queue.get(
                    block=req.get("block", True), timeout=req.get("timeout")
                )
                return {"ok": True, "item": item}
            except _queue.Empty:
                return {"ok": False, "empty": True}
        if op == "qsize":
            return {"ok": True, "size": self._queue.qsize()}
        return {"error": f"unknown op {op}"}

    # direct (in-process) access for the hosting agent
    def get(self, block=True, timeout=None):
        return self._queue.get(block=block, timeout=timeout)

    def put(self, item, timeout=None):
        self._queue.put(item, timeout=timeout)

    def qsize(self) -> int:
        return self._queue.qsize()

    def task_done(self):
        """The hosting agent finished the item it last got."""
        self._queue.task_done()

    def unfinished(self) -> int:
        """Items put and not yet marked done (queued or in hand)."""
        with self._queue.all_tasks_done:
            return self._queue.unfinished_tasks

    def stop(self):
        self._server.stop()


class SharedQueueClient:
    def __init__(self, name: str, sock_dir: str = ""):
        self._client = _UdsClient(f"queue-{name}", sock_dir)

    def put(self, item, timeout: Optional[float] = None):
        resp = self._client.call({"op": "put", "item": item, "timeout": timeout})
        if not resp.get("ok"):
            raise _queue.Full()

    def get(self, block: bool = True, timeout: Optional[float] = None):
        resp = self._client.call(
            {"op": "get", "block": block, "timeout": timeout}
        )
        if not resp.get("ok"):
            raise _queue.Empty()
        return resp["item"]

    def qsize(self) -> int:
        return self._client.call({"op": "qsize"})["size"]


# --------------------------------------------------------------------------
# SharedLock
# --------------------------------------------------------------------------


def _owner_gone(owner: str) -> bool:
    """A client's owner id starts with its pid (``SharedLockClient``):
    true when that process has exited. The agent reaps a dead worker
    before it restarts one, so a SIGKILLed holder shows as gone."""
    pid = owner.split("-", 1)[0]
    if not pid.isdigit():
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    return False


class SharedLockServer:
    def __init__(self, name: str, sock_dir: str = ""):
        self._lock = threading.Lock()
        self._owner: Optional[str] = None
        self._cond = threading.Condition()
        self._server = _UdsServer(f"lock-{name}", self._handle, sock_dir)
        self._server.start()

    def _handle(self, req: dict) -> dict:
        op = req["op"]
        owner = req.get("owner", "")
        if op == "acquire":
            blocking = req.get("blocking", True)
            timeout = req.get("timeout", 60.0)
            deadline = time.time() + (timeout if blocking else 0)
            with self._cond:
                while self._owner is not None and self._owner != owner:
                    if _owner_gone(self._owner):
                        # A worker killed mid shm write never releases;
                        # its image is checked by its CRC, not the lock.
                        logger.warning("shared lock: holder %s exited "
                                       "without releasing", self._owner)
                        self._owner = None
                        break
                    remaining = deadline - time.time()
                    if not blocking or remaining <= 0:
                        return {"ok": True, "acquired": False}
                    self._cond.wait(min(remaining, 1.0))
                self._owner = owner
                return {"ok": True, "acquired": True}
        if op == "release":
            with self._cond:
                if self._owner == owner:
                    self._owner = None
                    self._cond.notify_all()
            return {"ok": True}
        if op == "locked":
            with self._cond:
                return {"ok": True, "locked": self._owner is not None}
        return {"error": f"unknown op {op}"}

    # In-process acquire/release for the hosting agent (the saver thread
    # must hold the same lock workers use before reading shm).
    def acquire(self, owner: str = "agent-local", timeout: float = 60.0) -> bool:
        resp = self._handle(
            {"op": "acquire", "owner": owner, "blocking": True, "timeout": timeout}
        )
        return resp.get("acquired", False)

    def release(self, owner: str = "agent-local"):
        self._handle({"op": "release", "owner": owner})

    def stop(self):
        self._server.stop()


class SharedLockClient:
    def __init__(self, name: str, sock_dir: str = ""):
        self._client = _UdsClient(f"lock-{name}", sock_dir)
        self._owner = f"{os.getpid()}-{id(self)}"

    def acquire(self, blocking: bool = True, timeout: float = 60.0) -> bool:
        resp = self._client.call(
            {
                "op": "acquire",
                "owner": self._owner,
                "blocking": blocking,
                "timeout": timeout,
            }
        )
        return resp.get("acquired", False)

    def release(self):
        self._client.call({"op": "release", "owner": self._owner})

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


# --------------------------------------------------------------------------
# SharedDict
# --------------------------------------------------------------------------


class SharedDictServer:
    def __init__(self, name: str, sock_dir: str = ""):
        self._dict: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._server = _UdsServer(f"dict-{name}", self._handle, sock_dir)
        self._server.start()

    def _handle(self, req: dict) -> dict:
        op = req["op"]
        if op == "set":
            with self._lock:
                self._dict[req["key"]] = req["value"]
            return {"ok": True}
        if op == "get":
            with self._lock:
                return {"ok": True, "value": self._dict.get(req["key"])}
        if op == "update":
            with self._lock:
                self._dict.update(req["items"])
            return {"ok": True}
        if op == "dump":
            with self._lock:
                return {"ok": True, "items": dict(self._dict)}
        if op == "delete":
            with self._lock:
                self._dict.pop(req["key"], None)
            return {"ok": True}
        return {"error": f"unknown op {op}"}

    # in-process access
    def get(self, key: str, default=None):
        with self._lock:
            return self._dict.get(key, default)

    def set(self, key: str, value):
        with self._lock:
            self._dict[key] = value

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._dict)

    def stop(self):
        self._server.stop()


class SharedDictClient:
    def __init__(self, name: str, sock_dir: str = ""):
        self._client = _UdsClient(f"dict-{name}", sock_dir)

    def set(self, key: str, value):
        self._client.call({"op": "set", "key": key, "value": value})

    def get(self, key: str, default=None):
        value = self._client.call({"op": "get", "key": key})["value"]
        return default if value is None else value

    def update(self, items: Dict[str, Any]):
        self._client.call({"op": "update", "items": items})

    def dump(self) -> Dict[str, Any]:
        return self._client.call({"op": "dump"})["items"]

    def delete(self, key: str):
        self._client.call({"op": "delete", "key": key})
