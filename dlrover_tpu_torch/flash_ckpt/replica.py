"""Cross-host in-memory checkpoint replication (the port's copy of
``dlrover_tpu/flash_ckpt/replica.py``: the same HTTP routes, token
header and KV keys, so either package's agent pushes to and pulls from
the other's).

Each node keeps a backup of its replica-group peers' shm checkpoint
images, so a RELAUNCHED node restores from a live peer's memory instead
of (slow) storage. The exchange runs agent to agent over HTTP: after a
shm save the agent's saver pushes its raw segment images to its group
peers; a relaunched agent pulls its segments back before its workers
start. Peer addresses go through the master KV store.

Segment payloads are the raw shm bytes (magic + meta + data), so a
restored segment is byte-identical to what the lost node held and the
normal memory-first engine load path just works. The snapshot copies
the segment under the agent's shm lock and lets go of it before any
byte crosses the wire: a worker's next save never waits on a transfer.
"""

import http.client
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.flash_ckpt.engine import shm_segment_name
from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler

_ADDR_KEY = "ckpt-replica-addr/{rank}"
REPLICA_TOKEN_KEY = CheckpointConstant.REPLICA_TOKEN_KEY


class ReplicaTokenUnavailable(RuntimeError):
    """No usable shared secret for the replica service."""


def resolve_auth_token(master_client=None, timeout: float = 30.0) -> str:
    """Shared-secret header value for the replica service.

    Replica payloads end up in workers' shm segments, so writes must be
    limited to job members. The secret is either the operator-provided
    DLROVER_TPU_REPLICA_TOKEN (the strong option: never on the wire via
    the master) or the random per-job token the master generates at
    startup and serves via its KV store — not derivable offline, though
    readable by anyone who can already reach the master's RPC port.
    Without either, the service refuses to start.
    """
    token = os.getenv("DLROVER_TPU_REPLICA_TOKEN", "")
    if token:
        return token
    if master_client is not None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                value = master_client.kv_store_get(REPLICA_TOKEN_KEY)
            except Exception:
                value = b""
            if value:
                return value.decode()
            time.sleep(0.5)
    raise ReplicaTokenUnavailable(
        "checkpoint replica service needs DLROVER_TPU_REPLICA_TOKEN or a "
        "master-distributed per-job token; refusing to open the port"
    )


# ---------------------------------------------------------------------------
# Raw segment snapshot / restore
# ---------------------------------------------------------------------------


def image_end(meta: dict) -> int:
    """The end of an image's valid bytes in its segment."""
    end = meta["data_start"]
    for leaf in meta["leaves"]:
        for shard in leaf.shards:
            end = max(end, meta["data_start"] + shard.offset + shard.nbytes)
    return end


def snapshot_segment(name: str, lock=None) -> Optional[bytes]:
    """Copy the valid bytes of a committed shm segment (None if absent
    or mid-write)."""
    if lock is not None:
        lock.acquire()
    try:
        handler = SharedMemoryHandler(name)
        meta = handler.load_meta()
        if meta is None:
            handler.close()
            return None
        payload = bytes(handler._shm.buf[:image_end(meta)])  # noqa: SLF001
        handler.close()
        return payload
    finally:
        if lock is not None:
            lock.release()


def restore_segment(name: str, payload: bytes):
    """Write a snapshot back into a (possibly new) shm segment with the
    same commit ordering as a normal save."""
    handler = SharedMemoryHandler(name)
    handler._ensure_shm(len(payload))  # noqa: SLF001
    buf = handler._shm.buf  # noqa: SLF001
    buf[:8] = b"\x00" * 8
    buf[8 : len(payload)] = payload[8:]
    # Commit with the PAYLOAD's magic, not this build's: a snapshot from
    # an older layout version must keep its own version stamp or the
    # reader would parse v1 offsets with v2 rules.
    buf[:8] = payload[:8]
    handler.close()


# ---------------------------------------------------------------------------
# Replica HTTP service (runs in the agent)
# ---------------------------------------------------------------------------


class _ReplicaStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[Tuple[int, int], bytes] = {}

    def put(self, owner_rank: int, local_rank: int, payload: bytes):
        with self._lock:
            self._data[(owner_rank, local_rank)] = payload

    def get(self, owner_rank: int, local_rank: int) -> Optional[bytes]:
        with self._lock:
            return self._data.get((owner_rank, local_rank))

    def owners(self) -> List[int]:
        with self._lock:
            return sorted({o for o, _ in self._data})


def _make_handler(store: _ReplicaStore, token: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _authorized(self) -> bool:
            if self.headers.get("X-Replica-Token") == token:
                return True
            self.send_response(403)
            self.end_headers()
            return False

        def _parse(self):
            parts = self.path.strip("/").split("/")
            if len(parts) != 3 or parts[0] != "replica":
                return None
            try:
                return int(parts[1]), int(parts[2])
            except ValueError:
                return None

        def do_PUT(self):
            if not self._authorized():
                return
            key = self._parse()
            if key is None:
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", "0"))
            payload = self.rfile.read(length)
            store.put(key[0], key[1], payload)
            self.send_response(200)
            self.end_headers()

        def do_GET(self):
            if not self._authorized():
                return
            key = self._parse()
            payload = None if key is None else store.get(key[0], key[1])
            if payload is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler


class CkptReplicaManager:
    """Agent-side replica push/pull coordinator.

    ``group_size`` nodes form a replica group (consecutive ranks); each
    node pushes its segments to every other group member after a save.
    """

    def __init__(
        self,
        node_rank: int,
        master_client=None,
        group_size: int = 2,
        port: int = 0,
        addr_map: Optional[Dict[int, str]] = None,
    ):
        self._node_rank = node_rank
        self._client = master_client
        self._group_size = max(1, group_size)
        self._store = _ReplicaStore()
        self._token = resolve_auth_token(master_client)
        self._server = ThreadingHTTPServer(
            ("0.0.0.0", port), _make_handler(self._store, self._token)
        )
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._world: List[int] = [node_rank]
        # Static address map for tests / masterless runs.
        self._addr_map = addr_map or {}
        # Payload bytes the last push_node_image delivered (all peers),
        # and the last restore_missing_segments' missing segments and
        # restored bytes.
        self.last_push_bytes = 0
        self.last_pull_missing = 0
        self.last_pull_bytes = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self, advertise_host: str = "127.0.0.1"):
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="ckpt-replica-server",
            daemon=True,
        )
        self._thread.start()
        addr = f"{advertise_host}:{self.port}"
        if self._client is not None:
            try:
                self._client.kv_store_set(
                    _ADDR_KEY.format(rank=self._node_rank),
                    addr.encode(),
                )
            except Exception:
                logger.warning("replica addr publish failed", exc_info=True)
        logger.info("ckpt replica service on %s", addr)

    def stop(self):
        if self._thread is not None:
            # shutdown() blocks until serve_forever acknowledges; calling
            # it on a never-started server would wait forever.
            self._server.shutdown()
        self._server.server_close()

    def set_world(self, world_nodes: List[int]):
        self._world = sorted(world_nodes) or [self._node_rank]

    # ---- group topology ----------------------------------------------------

    def group_peers(self, rank: Optional[int] = None) -> List[int]:
        """Other members of ``rank``'s replica group (consecutive blocks
        of group_size over the sorted world)."""
        rank = self._node_rank if rank is None else rank
        world = self._world
        if rank not in world or self._group_size <= 1:
            return []
        i = world.index(rank)
        start = i - (i % self._group_size)
        return [
            r
            for r in world[start : start + self._group_size]
            if r != rank
        ]

    def _peer_addr(self, rank: int) -> Optional[str]:
        if rank in self._addr_map:
            return self._addr_map[rank]
        if self._client is None:
            return None
        try:
            value = self._client.kv_store_get(_ADDR_KEY.format(rank=rank))
            return value.decode() if value else None
        except Exception:
            return None

    # ---- push (after save) --------------------------------------------------

    def push_node_image(
        self, local_world_size: int, locks: Optional[list] = None
    ) -> int:
        """Push this node's shm segments to its group peers; returns the
        number of segment replicas delivered."""
        peers = self.group_peers()
        if not peers:
            return 0
        payloads = []
        for local_rank in range(local_world_size):
            lock = locks[local_rank] if locks else None
            payload = snapshot_segment(shm_segment_name(local_rank), lock)
            if payload is not None:
                payloads.append((local_rank, payload))
        delivered = 0
        self.last_push_bytes = 0
        for peer in peers:
            addr = self._peer_addr(peer)
            if addr is None:
                continue
            for local_rank, payload in payloads:
                if self._http_put(addr, self._node_rank, local_rank, payload):
                    delivered += 1
                    self.last_push_bytes += len(payload)
        return delivered

    # ---- pull (relaunched node) ---------------------------------------------

    def restore_missing_segments(
        self,
        local_world_size: int,
        candidate_ranks: Optional[List[int]] = None,
    ) -> int:
        """Fetch this node's segments from peers when the local shm is
        empty (fresh host after relaunch). Returns segments restored.

        ``candidate_ranks``: peers to ask. Defaults to the group peers,
        but a relaunched node should pass every possible rank — the push
        side grouped by the *actual* rendezvous world at save time, which
        the fresh node cannot reconstruct; a 404 from a non-holder is
        cheap, a missed holder costs a slow storage restore.
        """
        if candidate_ranks is None:
            candidate_ranks = self.group_peers()
        candidates = [r for r in candidate_ranks if r != self._node_rank]
        restored = 0
        self.last_pull_missing = self.last_pull_bytes = 0
        for local_rank in range(local_world_size):
            name = shm_segment_name(local_rank)
            handler = SharedMemoryHandler(name)
            have = handler.load_meta() is not None
            handler.close()
            if have:
                continue
            self.last_pull_missing += 1
            for peer in candidates:
                addr = self._peer_addr(peer)
                if addr is None:
                    continue
                payload = self._http_get(
                    addr, self._node_rank, local_rank
                )
                if payload is not None:
                    restore_segment(name, payload)
                    self.last_pull_bytes += len(payload)
                    logger.info(
                        "restored shm segment %s from peer %d", name, peer
                    )
                    restored += 1
                    break
        return restored

    # ---- http plumbing ------------------------------------------------------

    def _http_put(
        self, addr: str, owner: int, local_rank: int, payload: bytes
    ) -> bool:
        try:
            host, port = addr.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            conn.request(
                "PUT",
                f"/replica/{owner}/{local_rank}",
                body=payload,
                headers={"X-Replica-Token": self._token},
            )
            ok = conn.getresponse().status == 200
            conn.close()
            return ok
        except Exception:
            # Peer churn mid-transfer must never break the save path.
            logger.warning("replica push to %s failed", addr)
            return False

    def _http_get(
        self, addr: str, owner: int, local_rank: int
    ) -> Optional[bytes]:
        try:
            host, port = addr.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            conn.request(
                "GET",
                f"/replica/{owner}/{local_rank}",
                headers={"X-Replica-Token": self._token},
            )
            resp = conn.getresponse()
            payload = resp.read() if resp.status == 200 else None
            conn.close()
            return payload
        except Exception:
            return None
