"""The port's block migration (counterpart of ``tests/test_migrate.py``)
on ``tiny_config`` (f32), ``device="cpu"``.

- **Wire.** ``kv_to_wire`` gives JAX's bytes for int8, f32 and bf16
  blocks (all-zero rows too, which hit the scale floor); ``kv_from_wire``
  round-trips JAX's bytes; bad magic and truncation raise as in JAX.
- **Across packages.** A request exported by either package after
  prefill (0 decode steps) or mid-decode (3, the live-drain case), with
  fp and int8 pools, is imported by the other: the destination's pool
  rows equal, element for element, what JAX's import writes from the
  same payload; the request continues token-exact against the
  destination package's unmigrated run; ``peek_header`` has JAX's
  keys; block invariants hold on both ends.
- **The reference's migration laws**, against the port: prefix-trie
  registration, in-flight imported blocks never evicted,
  ``MigrationRefused`` on a full destination, export only in DECODE
  (and a failed device export is a ``MigrationError``), the
  ``admit_decode`` errors, the migrate span between prefill and decode.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import ml_dtypes
import numpy as np
import pytest

import jax

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import kv_quant as jax_kvq
from dlrover_tpu.serving import kvpool as jax_kvpool
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.ops import kv_quant
from dlrover_tpu_torch.serving import kvpool
from dlrover_tpu_torch.serving.scheduler import DECODE, Scheduler

pytestmark = pytest.mark.kvpool


# ---- wire -------------------------------------------------------------------


def _blocks(dtype, zero_rows=False, seed=0):
    rs = np.random.RandomState(seed)
    k = (rs.randn(2, 3, 8, 2, 16) * 4).astype(np.float32)
    v = rs.randn(2, 3, 8, 2, 16).astype(np.float32)
    if zero_rows:
        k[:, 1] = 0.0
        v[0, :, 3] = 0.0
    return k.astype(dtype), v.astype(dtype)


def _int8_blocks():
    q = jax_kvq.quantize_kv
    k, v = _blocks(np.float32, seed=1)
    (kq, ks), (vq, vs) = q(k), q(v)
    return tuple(np.asarray(t) for t in (kq, vq, ks, vs))


WIRE_CASES = ["int8", "f32", "bf16", "f32_zero_rows", "bf16_zero_rows",
              "roundtrip_jax_bytes", "bad_magic", "truncated"]


@pytest.mark.parametrize("case", WIRE_CASES)
def test_wire_matches_jax(case):
    if case in ("int8", "roundtrip_jax_bytes"):
        args = _int8_blocks()
    elif case in ("f32", "f32_zero_rows"):
        args = _blocks(np.float32, zero_rows="zero" in case)
    elif case in ("bf16", "bf16_zero_rows"):
        args = _blocks(ml_dtypes.bfloat16, zero_rows="zero" in case)
    else:
        args = _blocks(np.float32)
    want = jax_kvq.kv_to_wire(*args)
    if case == "bad_magic":
        bad = b"XXXX" + want[4:]
        for mod in (jax_kvq, kv_quant):
            with pytest.raises(ValueError, match="magic"):
                mod.kv_from_wire(bad)
        return
    if case == "truncated":
        for mod in (jax_kvq, kv_quant):
            with pytest.raises(ValueError, match="truncated"):
                mod.kv_from_wire(want[:-3])
        with pytest.raises(ValueError, match="truncated"):
            kv_quant.kv_from_wire_tensors(want[:-3], "cpu")
        return
    if case == "roundtrip_jax_bytes":
        got = kv_quant.kv_from_wire(want)
        ref = jax_kvq.kv_from_wire(want)
        for a, b in zip(got[:4], ref[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[4] == ref[4]
        assert kv_quant.kv_to_wire(*got[:4]) == want
        on_dev = kv_quant.kv_from_wire_tensors(want, "cpu")
        for a, b in zip(on_dev[:4], ref[:4]):
            assert np.array_equal(a.numpy(), b)
        return
    got = kv_quant.kv_to_wire(*args)
    assert got == want
    if case != "int8":
        # The scale is a true f32 division amax / 127 (numpy's), which
        # the card must give too (not a product with 1/127).
        amax = np.abs(np.asarray(args[0], np.float32)).max(-1)
        scale = kv_quant.quantize_kv(kv_quant._as_tensor(args[0]))[1]
        np.testing.assert_array_equal(
            scale.numpy(), np.maximum(amax / np.float32(127), 1e-20))
    # The tensor path (an engine's export) writes the same bytes.
    tensors = [kv_quant._as_tensor(a) for a in args]
    assert kv_quant.kv_to_wire(*tensors) == want
    hdr = jax_kvq.kv_from_wire(got)[4]
    assert hdr["src_dtype"] == {"int8": "int8", "f32": "float32",
                                "bf16": "bfloat16"}[case.split("_")[0]]


# ---- engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny_config()
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    return llama.tiny_config(), params, jcfg, jparams


ENGINE_KW = dict(max_len=32, prefill_chunk=4, block_size=8)


def port_engine(tiny, kv="fp", slots=2, **kw):
    cfg, params = tiny[:2]
    eng = kvpool.PagedServingEngine(
        cfg, params, slots=slots, kv_cache_dtype=kv,
        registry=MetricsRegistry(), device="cpu", **ENGINE_KW, **kw)
    eng.warmup()
    return eng


def jax_engine(tiny, kv="fp", slots=2):
    jcfg, jparams = tiny[2:]
    eng = jax_kvpool.PagedServingEngine(
        jcfg, jparams, slots=slots, kv_cache_dtype=kv, **ENGINE_KW)
    eng.warmup()
    return eng


def make_prompt(cfg, n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)


def drive_to_decode(eng, prompt, max_new, decode_steps=0):
    req = eng.submit(prompt, max_new)
    for _ in range(200):
        if req.state == DECODE:
            break
        eng.step()
    assert req.state == DECODE and req.tokens
    for _ in range(decode_steps):
        eng.step()
    return req


def _rows(pools, blocks):
    return [np.asarray(p)[:, blocks] for p in pools]


def _port_pools(eng):
    pools = [eng._k, eng._v]
    if eng.kv_cache_dtype == "int8":
        pools += [eng._kscale, eng._vscale]
    return [p.numpy() for p in pools]


@pytest.fixture(scope="module")
def unmigrated(tiny):
    """Per kv dtype: the greedy tokens of one unmigrated request through
    a port engine and a JAX engine."""
    prompt = make_prompt(tiny[0], 11, seed=3)
    out = {}
    for kv in ("fp", "int8"):
        for pkg, make in (("port", port_engine), ("jax", jax_engine)):
            eng = make(tiny, kv)
            req = eng.submit(prompt, 8)
            eng.run_until_idle()
            assert len(req.tokens) == 8
            out[pkg, kv] = list(req.tokens)
    return prompt, out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("decode_steps", [0, 3])
@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_migration_across_packages(tiny, unmigrated, kv, decode_steps,
                                   direction):
    prompt, ref = unmigrated
    if direction == "jax_to_port":
        src, exp, rel = jax_engine(tiny, kv), jax_kvpool.export_request, \
            jax_kvpool.release_exported
    else:
        src, exp, rel = port_engine(tiny, kv), kvpool.export_request, \
            kvpool.release_exported
    req = drive_to_decode(src, prompt, 8, decode_steps=decode_steps)
    payload = exp(src, req)
    # Both packages land the same payload in the same rows.
    jdst, pdst = jax_engine(tiny, kv), port_engine(tiny, kv)
    jreq = jax_kvpool.import_request(jdst, payload)
    preq = kvpool.import_request(pdst, payload)
    rel(src, req)
    jblocks = jdst._slot_blocks[jreq.slot]
    pblocks = pdst._slot_blocks[preq.slot]
    assert list(jblocks) == list(pblocks)
    for got, want in zip(_rows(_port_pools(pdst), pblocks),
                         _rows(jdst._pools(), jblocks)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert preq.tokens == jreq.tokens == req.tokens
    assert pdst.call_counts["import"] == 1
    # The header has JAX's keys, whichever package wrote it.
    assert sorted(kvpool.peek_header(payload)) == sorted(
        jax_kvpool.peek_header(payload))
    assert kvpool.peek_header(payload)["src_kv_dtype"] == kv
    dst = pdst if direction == "jax_to_port" else jdst
    moved = preq if direction == "jax_to_port" else jreq
    dst.run_until_idle()
    pkg = "port" if direction == "jax_to_port" else "jax"
    assert moved.tokens == ref[pkg, kv]
    assert moved.migrate_end_ts is not None
    for eng in (src, dst):
        eng.check_block_invariants()
    assert src.kv_stats()["used"] == 0
    if direction == "port_to_jax":
        assert src.call_counts["export"] == 1


# ---- the reference's migration laws, against the port ----------------------


def test_imported_chain_registers_in_destination_trie(tiny):
    cfg = tiny[0]
    src, dst = port_engine(tiny), port_engine(tiny)
    prompt = make_prompt(cfg, 17, seed=4)  # 2 full blocks + tail
    req = drive_to_decode(src, prompt, 4)
    imported = kvpool.import_request(dst, kvpool.export_request(src, req))
    kvpool.release_exported(src, req)
    dst.run_until_idle()
    assert len(imported.tokens) == 4
    follow = dst.submit(prompt, 4)
    dst.run_until_idle()
    assert follow.prefix_hit_blocks == 2
    dst.check_block_invariants()


def test_eviction_never_frees_inflight_imported_blocks(tiny):
    cfg = tiny[0]
    src, dst = port_engine(tiny), port_engine(tiny)
    req = drive_to_decode(src, make_prompt(cfg, 17, seed=5), 10)
    imported = kvpool.import_request(dst, kvpool.export_request(src, req))
    kvpool.release_exported(src, req)
    slot_blocks = list(dst._slot_blocks[imported.slot])
    assert dst._cache.evict_lru(len(slot_blocks)) >= 1
    for b in slot_blocks:
        assert dst._allocator.refcount(b) >= 1  # the slot's ref survives
    dst.run_until_idle()
    assert len(imported.tokens) == 10 and not imported.failed
    dst.check_block_invariants()


def test_import_refused_when_destination_full(tiny):
    cfg = tiny[0]
    src, dst = port_engine(tiny), port_engine(tiny, slots=1)
    blocker = drive_to_decode(dst, make_prompt(cfg, 5, seed=8), 20)
    req = drive_to_decode(src, make_prompt(cfg, 9, seed=9), 6)
    payload = kvpool.export_request(src, req)
    assert not kvpool.can_import(dst, kvpool.peek_header(payload)["n_blocks"])
    before = dst.kv_stats()
    with pytest.raises(kvpool.MigrationRefused):
        kvpool.import_request(dst, payload)
    assert dst.kv_stats() == before
    assert dst.scheduler.free_slots() == 0
    src.run_until_idle()  # the source still owns the request
    assert len(req.tokens) == 6 and not req.failed
    dst.run_until_idle()
    assert len(blocker.tokens) == 20
    src.check_block_invariants()
    dst.check_block_invariants()


def test_export_requires_decode_state_and_surfaces_device_errors(
        tiny, monkeypatch):
    cfg = tiny[0]
    src = port_engine(tiny)
    req = src.submit(make_prompt(cfg, 9, seed=10), 8)
    with pytest.raises(kvpool.MigrationError, match="not migratable"):
        kvpool.export_request(src, req)  # still queued
    for _ in range(50):
        if req.state == DECODE:
            break
        src.step()

    def broken(blocks):
        raise RuntimeError("device gather failed")

    monkeypatch.setattr(src, "_export_blocks", broken)
    with pytest.raises(kvpool.MigrationError, match="export failed"):
        kvpool.export_request(src, req)
    src.run_until_idle()  # the request decodes on where it is
    assert len(req.tokens) == 8 and not req.failed
    src.check_block_invariants()


def test_decode_entry_admission_law():
    sch = Scheduler(slots=1, max_len=32, prefill_chunk=4)
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="sampled token"):
        sch.admit_decode(prompt, [], 4)
    with pytest.raises(ValueError, match="already complete"):
        sch.admit_decode(prompt, [1, 2, 3, 4], 4)
    with pytest.raises(ValueError, match="no decode room"):
        sch.admit_decode(np.arange(32, dtype=np.int32), [1], 4)
    with pytest.raises(ValueError, match="unknown SLO class"):
        sch.admit_decode(prompt, [7], 4, slo_class="nope")
    req = sch.admit_decode(prompt, [7], 4, now=10.0)
    assert req.state == DECODE and req.slot == 0
    assert req.prefill_pos == 5 and req.tokens == [7]
    assert req.admit_ts == 10.0 and req.first_token_ts == 10.0
    assert sch.free_slots() == 0
    with pytest.raises(RuntimeError, match="no free slot"):
        sch.admit_decode(prompt, [7], 4)
    sch.finish(req)
    assert sch.free_slots() == 1


def test_migrate_span_between_prefill_and_decode(tiny):
    cfg = tiny[0]
    src, dst = port_engine(tiny), port_engine(tiny)
    req = drive_to_decode(src, make_prompt(cfg, 9, seed=12), 5,
                          decode_steps=2)
    payload = kvpool.export_request(src, req)
    tracer = tracing.arm(tracing.Tracer(service="test"))
    try:
        imported = kvpool.import_request(dst, payload)
        kvpool.release_exported(src, req)
        dst.run_until_idle()
    finally:
        tracing.disarm()
    spans = [s for s in tracer.finished() if s["name"].startswith("serving.")]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    root = by_name["serving.request"][0]
    kids = [s for s in spans if s.get("parent_id") == root["span_id"]]
    assert abs(sum(s["dur_s"] for s in kids) - root["dur_s"]) <= 1e-6
    mig = by_name["serving.migrate"][0]
    pre = by_name["serving.prefill"][0]
    dec = max(by_name["serving.decode"], key=lambda s: s["mono"])
    assert pre["mono"] + pre["dur_s"] <= mig["mono"] + 1e-6
    assert mig["mono"] + mig["dur_s"] <= dec["mono"] + 1e-6
    # Two source decode steps ran before the export: their segment.
    assert any(s["attrs"].get("segment") == "pre_migrate"
               for s in by_name["serving.decode"])
    assert len(imported.tokens) == 5
