"""Block migration: a request's paged-KV state as bytes (port of
``dlrover_tpu/serving/kvpool/migrate.py``; the payload is byte for byte
the reference's, so either package imports what the other exported).

The disaggregated serving plane treats paged KV blocks as a fleet-wide
currency: a prefill replica fills a request's blocks, serializes them,
and a decode replica admits the request MID-STREAM — no re-prefill.
The same primitive backs live drain (moving in-flight decodes off a
replica that is being removed).

- :func:`export_request` serializes a DECODE-state request on a source
  :class:`PagedServingEngine`: block contents (always int8 on the wire,
  ``ops.kv_quant`` — bit-exact passthrough for int8 pools,
  quantize-on-export for fp pools, on the device, so only int8 rows and
  their scales cross to the host), fill cursor, sampled tokens, and
  scheduler state. The source keeps the request live until the importer
  acks — the caller decides whether the fallback is source-side
  completion (live drain) or a from-scratch re-prefill (two-phase
  dispatch). A gather or quantization that raises on the device is a
  :class:`MigrationError`: there is no host fallback.
- :func:`release_exported` drops the request from the source after the
  ack: slot recycled, blocks decref'd — conservation holds (prompt
  blocks the prefix cache holds a ref on stay cached).
- :func:`import_request` admits the payload into a destination engine
  through the scheduler's DECODE-entry path: allocate blocks (fresh,
  refcount 1 — COW state is rebuilt by construction, never shipped),
  install the table and fill, land the rows with one scatter per pool,
  register the full prompt blocks into the destination prefix trie
  (hit-rate survives migration), and reconstruct the request's phase
  timeline on the local monotonic clock — the ``serving.migrate`` span
  lands between the (source-side) prefill and the local decode.

Payload layout: ``MAGIC | u32 header_len | json header | kv wire``
with the kv wire of :func:`ops.kv_quant.kv_to_wire` (its own
self-describing header carries dtype + shapes). Wall-clock export
stamps bound the migration pause across processes on one host.
"""

import json
import struct
import time
from typing import Dict, Optional

import numpy as np

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.ops.kv_quant import kv_from_wire
from dlrover_tpu_torch.serving.scheduler import DECODE, Request

MIGRATE_MAGIC = b"KVM1"


class MigrationError(RuntimeError):
    """Structural failure: payload malformed, engines incompatible, or
    the device gather failed."""


class MigrationRefused(MigrationError):
    """Destination cannot hold the request right now (no free slot /
    not enough blocks) — the router treats this as a routing miss, not
    a breaker strike."""


def export_request(engine, req: Request,
                   now: Optional[float] = None) -> bytes:
    """Serialize ``req``'s blocks + scheduler state on the source
    engine. The request stays LIVE on the source — pair with
    :func:`release_exported` once the importer acks."""
    if req.state != DECODE or not req.tokens:
        raise MigrationError(
            f"rid {req.rid} not migratable: state={req.state!r}, "
            f"{len(req.tokens)} tokens (prefill must have completed)"
        )
    if req.slot < 0:
        raise MigrationError(f"rid {req.rid} holds no slot")
    if now is None:
        now = time.monotonic()
    slot = req.slot
    blocks = list(engine._slot_blocks[slot])
    fill = int(engine._lengths[slot])
    if not blocks or fill > len(blocks) * engine.block_size:
        raise MigrationError(
            f"rid {req.rid}: fill {fill} exceeds {len(blocks)} blocks"
        )
    try:
        wire = engine._export_blocks(blocks)
    except Exception as e:  # noqa: BLE001 — device errors vary
        raise MigrationError(
            f"rid {req.rid}: block export failed: "
            f"{type(e).__name__}: {e}"
        ) from e
    admit_ts = req.admit_ts if req.admit_ts is not None else (
        req.submit_ts
    )
    first_ts = req.first_token_ts if req.first_token_ts is not None \
        else now
    header = {
        "v": 1,
        "src_rid": req.rid,
        "prompt": [int(t) for t in req.prompt],
        "tokens": [int(t) for t in req.tokens],
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature,
        "slo_class": req.slo_class,
        "fill": fill,
        "n_blocks": len(blocks),
        "block_size": engine.block_size,
        "src_kv_dtype": engine.kv_cache_dtype,
        # Source-side phase durations, for timeline reconstruction on
        # the destination clock (monotonic stamps don't cross
        # processes; durations do).
        "queue_s": max(admit_ts - req.submit_ts, 0.0),
        "prefill_s": max(first_ts - admit_ts, 0.0),
        "decode_s": max(now - first_ts, 0.0),
        "deadline_remaining_s": (
            req.deadline - now if req.deadline is not None else None
        ),
        "prefix_hit_blocks": req.prefix_hit_blocks,
        # Wall clock (same-host processes): bounds the migration pause.
        "exported_wall": time.time(),
    }
    hdr = json.dumps(header).encode()
    return b"".join(
        [MIGRATE_MAGIC, struct.pack("<I", len(hdr)), hdr, wire]
    )


def peek_header(payload: bytes) -> Dict[str, object]:
    """The scheduler-state header alone — routers size destinations
    (``n_blocks``) without touching the KV bytes."""
    if payload[:4] != MIGRATE_MAGIC:
        raise MigrationError("bad migration payload magic")
    (hlen,) = struct.unpack_from("<I", payload, 4)
    return json.loads(payload[8:8 + hlen].decode())


def release_exported(engine, req: Request,
                     now: Optional[float] = None) -> None:
    """Source-side release after the importer acked: recycle the slot,
    decref the blocks (prefix-cached prompt blocks keep the cache's
    ref — conservation holds), and record a ``migrated`` outcome. The
    request's spans are emitted by the DESTINATION: the source emits
    nothing, or the request would double-report."""
    if req.state == DECODE and req.slot >= 0:
        slot = req.slot
        engine.scheduler.evict(req, now)
        engine._release_slot(req, slot)
        engine._lengths[slot] = 0
        engine._tokens[slot] = 0
        engine._temps[slot] = 0.0
    engine.metrics.requests.inc(outcome="migrated")
    engine.metrics.annotate("serving_migrate_out", rid=req.rid)


def can_import(engine, n_blocks: int) -> bool:
    """Cheap admission probe: a free slot plus ``n_blocks`` coverable
    by free + evictable-cache blocks (the import never preempts a
    peer — a migration must not burn another request's prefill)."""
    if engine.scheduler.free_slots() < 1:
        return False
    stats = engine._allocator.stats(engine._live_block_ids())
    return stats["free"] + stats["cached"] >= n_blocks


def import_request(engine, payload: bytes,
                   trace: Optional[dict] = None) -> Request:
    """Admit a migrated request into ``engine`` mid-stream (see module
    docstring). Raises :class:`MigrationRefused` when the engine
    cannot hold it, :class:`MigrationError` on incompatibility."""
    t_in = time.monotonic()
    header = peek_header(payload)
    (hlen,) = struct.unpack_from("<I", payload, 4)
    wire = memoryview(payload)[8 + hlen:]
    kq, _, _, _, _ = kv_from_wire(wire)  # validates; views, no copy
    L, n, bs, kh, hd = kq.shape
    cfg = engine.config
    if (L, kh, hd) != (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim):
        raise MigrationError(
            f"model shape mismatch: wire {(L, kh, hd)} vs engine "
            f"{(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)}"
        )
    if bs != engine.block_size or bs != header["block_size"]:
        raise MigrationError(
            f"block_size mismatch: wire {bs} vs engine "
            f"{engine.block_size}"
        )
    if n != header["n_blocks"] or n > engine.max_blocks:
        raise MigrationError(
            f"{n} wire blocks vs header {header['n_blocks']} / "
            f"table capacity {engine.max_blocks}"
        )
    fill = int(header["fill"])
    if fill > n * bs:
        raise MigrationError(f"fill {fill} exceeds {n} wire blocks")
    if not can_import(engine, n):
        raise MigrationRefused(
            f"destination full: {n} blocks + a slot needed"
        )
    slo = header["slo_class"]
    if slo not in engine.scheduler.slo_classes:
        # A stock single-class destination must not reject tagged
        # traffic mid-migration; untagged is the local default.
        slo = None
    req = engine.scheduler.admit_decode(
        np.asarray(header["prompt"], np.int32),
        [int(t) for t in header["tokens"]],
        int(header["max_new_tokens"]),
        temperature=float(header["temperature"]),
        slo_class=slo,
        now=t_in,
    )
    slot = req.slot
    try:
        blocks = engine._alloc_blocks(n, req)
    except Exception:
        engine.scheduler.evict(req)
        raise
    engine._tables[slot, :] = 0  # SENTINEL_BLOCK
    engine._slot_blocks[slot] = list(blocks)
    engine._tables[slot, :n] = blocks
    engine._lengths[slot] = fill
    engine._tokens[slot] = req.tokens[-1]
    engine._temps[slot] = req.temperature
    try:
        engine._import_blocks(wire, blocks)
    except Exception as e:  # noqa: BLE001 — device errors vary
        engine.scheduler.evict(req)
        engine._release_slot(req, slot)
        engine._lengths[slot] = 0
        raise MigrationError(
            f"block import failed: {type(e).__name__}: {e}"
        ) from e
    if engine._cache is not None:
        # Imported chains join the destination trie: the NEXT request
        # sharing this prompt hits warm blocks — hit-rate survives
        # migration. Partial tails stay private (decode appends there).
        n_full = req.prompt_len // bs
        if n_full:
            engine._cache.insert(req.prompt, blocks[:n_full])
    # Timeline on the LOCAL monotonic clock: the migrate window ends
    # now; its start is bounded by the wall-clock export stamp; the
    # source phases hang off it by their carried durations.
    t_done = time.monotonic()
    pause = max(time.time() - header["exported_wall"], t_done - t_in)
    req.migrate_end_ts = t_done
    req.migrate_start_ts = t_done - pause
    req.first_token_ts = req.migrate_start_ts - header["decode_s"]
    req.admit_ts = req.first_token_ts - header["prefill_s"]
    req.submit_ts = req.admit_ts - header["queue_s"]
    remaining = header.get("deadline_remaining_s")
    req.deadline = (
        t_done + remaining if remaining is not None else None
    )
    req.prefix_hit_blocks = int(header.get("prefix_hit_blocks", 0))
    req.trace = trace
    engine.metrics.requests.inc(outcome="imported")
    engine.metrics.annotate(
        "serving_import", rid=req.rid, src_rid=header["src_rid"],
        blocks=n, fill=fill, pause_s=round(pause, 6),
    )
    logger.debug(
        "imported rid %d (src rid %d): %d blocks, fill %d, pause %.1f"
        "ms", req.rid, header["src_rid"], n, fill, pause * 1e3,
    )
    return req
