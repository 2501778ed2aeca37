"""The port's row-paged KV cache and batcher against ``repro.serve``.

Mirrors tests/test_serve.py's cache tests on the port (``gather_seq`` with
torch tensors included; the property test keeps ``deadline=None``); a
seeded random sequence of cache operations on both packages gives the same
records, page tables and free lists; a serving replay
(``repro.serve.replay.build_replay``) run once with the reference's cache
and once with the port's, wrapped so that its streams reach the
reference's recorder as the reference's record type, gives equal
``SystemResult``s, step by step, with chunked prefill off and on; and the
chunked-prefill scheduler tests of tests/test_serve_replay.py that use
only the batcher run against the port's batcher."""
import dataclasses

import numpy as np
import pytest
from _proptest import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.serve import batching as jax_batching
from repro.serve import kv_cache as jax_kv
from repro.serve.replay import build_replay
from repro.workloads.stream import ExtentRecord as JaxRecord
from repro.workloads.stream import ExtentStream as JaxStream
from repro_torch import serve as port_serve
from repro_torch.serve import batching as port_batching
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.kv_cache import (ROW_BYTES, RowPagedKVCache,
                                        tokens_per_row)


def _cache(**kw):
    base = dict(n_pages=16, page_tokens=tokens_per_row(64, 2),
                n_kv_heads=2, head_dim=64, max_seqs=4,
                max_pages_per_seq=8, device="cpu")
    base.update(kw)
    return RowPagedKVCache(**base)


# --- tests/test_serve.py's cache tests, on the port ---------------------------

def test_serve_package_exports_the_cache():
    assert port_serve.RowPagedKVCache is RowPagedKVCache
    assert port_serve.ROW_BYTES == jax_kv.ROW_BYTES == ROW_BYTES == 4096
    assert port_serve.tokens_per_row is tokens_per_row


def test_page_is_whole_rows():
    c = _cache()
    assert c.page_bytes % ROW_BYTES == 0
    assert c.rows_per_page() >= 1
    with pytest.raises(ValueError):
        _cache(page_tokens=3)


def test_tokens_per_row_exact():
    assert tokens_per_row(64, 2, 2) == 4096 // (64 * 2 * 2)
    with pytest.raises(ValueError):
        tokens_per_row(96, 5, 2)        # no integral packing in one row
    for args in ((64, 2, 2, 1), (128, 4, 2, 16), (64, 8, 4, 2)):
        assert tokens_per_row(*args) == jax_kv.tokens_per_row(*args)


def test_alloc_append_free_cycle():
    c = _cache()
    c.alloc_seq(0, 10)
    used0 = c.utilization()
    pg, slot = c.append_token(0)
    assert 0 <= pg < c.n_pages
    c.free_seq(0)
    assert c.utilization() == 0.0
    assert used0 > 0


def test_append_crosses_page_boundary():
    c = _cache()
    tp = c.page_tokens
    c.alloc_seq(0, tp)                   # exactly one full page
    pg2, slot2 = c.append_token(0)       # must grab a fresh page
    assert slot2 == 0
    assert c.page_table[0, 1] == pg2


def test_pool_exhaustion_raises():
    c = _cache(n_pages=2, max_pages_per_seq=8)
    with pytest.raises(MemoryError):
        c.alloc_seq(0, c.page_tokens * 3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_matches_writes(dtype):
    c = _cache(dtype=dtype, page_tokens=tokens_per_row(
        64, 2, 2 if dtype == "bfloat16" else 4))
    assert c.pool_k.dtype == getattr(torch, dtype)
    assert c.pool_k.device.type == "cpu"
    c.alloc_seq(1, 3)
    for t in range(3):
        pg, slot = divmod(t, c.page_tokens)
        page_id = int(c.page_table[1, pg])
        c.write(page_id, slot,
                torch.full((2, 64), float(t)), torch.full((2, 64), -float(t)))
    k, v = c.gather_seq(1)
    assert k.shape == (3, 2, 64) and k.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(k[:, 0, 0].float().numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_allclose(v[:, 0, 0].float().numpy(), [0.0, -1.0, -2.0])


def test_gather_follows_interleaved_pages():
    """Two sequences whose pages interleave in the pool: the gather
    follows each one's page table, across page boundaries."""
    c = _cache(page_tokens=tokens_per_row(64, 2))       # 16 tokens a page
    c.alloc_seq(0, 0)
    c.alloc_seq(2, 0)
    for _ in range(3):
        for sid in (0, 2):
            c.append_chunk(sid, c.page_tokens)
    assert list(c.page_table[0, :3]) == [0, 2, 4]
    assert list(c.page_table[2, :3]) == [1, 3, 5]
    vals = {}
    for sid in (0, 2):
        n = int(c.seq_lens[sid])
        vals[sid] = torch.randn((n, 2, 64), generator=torch.Generator()
                                .manual_seed(sid))
        for t in range(n):
            pg, slot = divmod(t, c.page_tokens)
            c.write(int(c.page_table[sid, pg]), slot, vals[sid][t],
                    -vals[sid][t])
    for sid in (0, 2):
        k, v = c.gather_seq(sid)
        torch.testing.assert_close(k, vals[sid].to(torch.bfloat16),
                                   rtol=0, atol=0)
        torch.testing.assert_close(v, (-vals[sid]).to(torch.bfloat16),
                                   rtol=0, atol=0)


def test_default_device_is_cuda():
    field = {f.name: f for f in dataclasses.fields(RowPagedKVCache)}
    assert field["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        RowPagedKVCache(16, 16, 2, 64, 4, 8)


def test_kv_cache_emits_unified_records():
    """The paged KV cache speaks the ExtentRecord currency: whole-page
    row-aligned reads and in-page writes, covering BOTH the K and the V
    pool."""
    c = _cache()
    c.alloc_seq(2, c.page_tokens + 1)    # spans two pages
    reads = c.read_stream(2, base_addr=1 << 20, arrival_ns=5.0)
    assert len(reads) == 4               # 2 pages x {K, V}
    assert reads.read_bytes == 4 * c.page_bytes
    addrs = {r.addr for r in reads}
    assert len(addrs) == 4               # K and V pages never alias
    for r in reads:
        assert r.kind == "read" and r.arrival_ns == 5.0 and r.stream_id == 2
        assert (r.addr - (1 << 20)) % ROW_BYTES == 0
        assert r.nbytes % ROW_BYTES == 0
    before = int(c.seq_lens[2])
    writes = c.append_stream(2)
    assert int(c.seq_lens[2]) == before + 1   # token accounted exactly once
    per_tok = c.page_bytes // c.page_tokens
    assert len(writes) == 2              # K write + V write
    assert all(w.kind == "write" and w.stream_id == 2
               and w.nbytes == per_tok for w in writes)
    page_id, slot = divmod(int(c.seq_lens[2]) - 1, c.page_tokens)
    pool_page = int(c.page_table[2, page_id])
    assert [w.addr for w in writes] == [
        c.page_addr(pool_page, pool="k") + slot * per_tok,
        c.page_addr(pool_page, pool="v") + slot * per_tok]


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(min_value=0, max_value=999))
def test_kv_pool_never_double_allocates(seed):
    """Property: live pages are disjoint across sequences at all times."""
    rng = np.random.default_rng(seed)
    c = _cache(n_pages=12, max_seqs=3, max_pages_per_seq=4)
    lens = [0, 0, 0]
    for _ in range(40):
        sid = int(rng.integers(0, 3))
        if lens[sid] == 0 and rng.random() < 0.5:
            n = int(rng.integers(1, c.page_tokens * 2))
            try:
                c.alloc_seq(sid, n)
                lens[sid] = n
            except MemoryError:
                pass
        elif lens[sid] and rng.random() < 0.3:
            c.free_seq(sid)
            lens[sid] = 0
        elif lens[sid]:
            try:
                c.append_token(sid)
                lens[sid] += 1
            except MemoryError:
                pass
        live = [p for row in c.page_table for p in row if p >= 0]
        assert len(live) == len(set(live))
        assert len(live) + len(c._free) == c.n_pages


# --- record for record against the reference ----------------------------------

def _records(stream) -> list:
    return [(r.addr, r.nbytes, r.kind, r.arrival_ns, r.stream_id)
            for r in stream]


def _run_both(port, ref, rng, ops=60):
    """The same seeded random operations on both caches; after each, the
    records, page tables, lengths and free lists must be equal."""
    base = int(rng.integers(0, 4)) * ROW_BYTES
    for i in range(ops):
        sid = int(rng.integers(0, port.max_seqs))
        op = rng.choice(["alloc", "append", "chunk", "read", "free",
                         "write"])
        t = float(i)
        if op == "alloc" and port.seq_lens[sid] == 0:
            n = int(rng.integers(0, 2 * port.page_tokens))
            outs = []
            for c in (port, ref):
                try:
                    c.alloc_seq(sid, n)
                    outs.append("ok")
                except (MemoryError, ValueError) as e:
                    outs.append(type(e))
            assert outs[0] == outs[1]
        elif op in ("append", "chunk"):
            n = int(rng.integers(1, 3 * port.page_tokens))
            outs = []
            for c in (port, ref):
                try:
                    s = (c.append_stream(sid, base, t) if op == "append"
                         else c.append_chunk_stream(sid, n, base, t))
                    outs.append(_records(s))
                except (MemoryError, ValueError) as e:
                    outs.append(type(e))
            assert outs[0] == outs[1], (i, op)
        elif op == "read":
            assert _records(port.read_stream(sid, base, t)) \
                == _records(ref.read_stream(sid, base, t))
        elif op == "write":
            page, slot = int(rng.integers(0, port.n_pages)), \
                int(rng.integers(0, port.page_tokens))
            assert _records(port.write_stream(sid, page, slot, base, t)) \
                == _records(ref.write_stream(sid, page, slot, base, t))
        elif op == "free":
            port.free_seq(sid)
            ref.free_seq(sid)
        np.testing.assert_array_equal(port.page_table, ref.page_table)
        np.testing.assert_array_equal(port.seq_lens, ref.seq_lens)
        assert port._free == ref._free
        assert port.utilization() == ref.utilization()
        assert port.free_pages == ref.free_pages
        for p in range(port.n_pages):
            for pool in ("k", "v"):
                assert port.page_addr(p, base, pool) \
                    == ref.page_addr(p, base, pool)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("geometry", [(2, 64, 1, "bfloat16"),
                                      (4, 128, 16, "bfloat16"),
                                      (2, 64, 2, "float32")])
def test_records_match_reference(seed, geometry):
    kv, hd, rows, dtype = geometry
    itemsize = 2 if dtype == "bfloat16" else 4
    kw = dict(n_pages=10, page_tokens=tokens_per_row(hd, kv, itemsize,
                                                     rows),
              n_kv_heads=kv, head_dim=hd, max_seqs=3, max_pages_per_seq=5,
              dtype=dtype)
    port, ref = RowPagedKVCache(device="cpu", **kw), jax_kv.RowPagedKVCache(
        **kw)
    assert port.page_bytes == ref.page_bytes
    assert port.rows_per_page() == ref.rows_per_page() == rows
    assert port.pool_span_bytes == ref.pool_span_bytes
    assert tuple(port.pool_k.shape) == ref.pool_k.shape
    _run_both(port, ref, np.random.default_rng(seed))


# --- a serving replay with either cache -----------------------------------------

class RecordAdapter:
    """The port's cache as the reference's recorder sees it: every stream
    method returns the reference's ExtentStream of the same records (the
    reference's stream type accepts its own records only); everything
    else is the port's cache itself."""

    def __init__(self, cache: RowPagedKVCache):
        self.cache = cache

    def __getattr__(self, name):
        attr = getattr(self.cache, name)
        if name.endswith("_stream"):
            def wrapped(*args, **kwargs):
                return JaxStream(JaxRecord(*r) for r in
                                 _records(attr(*args, **kwargs)))
            return wrapped
        return attr


def _same(a, b, path="") -> None:
    """Field-by-field equality of SystemResult-like values."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _replay(chunk, port: bool):
    eng, _ = build_replay(policy="rome_qd2", rate_rps=2e5, n_requests=6,
                          seed=11, keep_traces=True,
                          prefill_chunk_tokens=chunk)
    ref = eng.recorder.cache
    if port:
        eng.recorder.cache = RecordAdapter(RowPagedKVCache(
            ref.n_pages, ref.page_tokens, ref.n_kv_heads, ref.head_dim,
            ref.max_seqs, ref.max_pages_per_seq, ref.dtype, device="cpu"))
    results = []
    run = eng.system.run

    def capture(stream, **kw):
        res = run(stream, **kw)
        results.append(res)
        return res

    eng.system.run = capture
    return eng.run(), results


@pytest.mark.parametrize("chunk", [None, 8])
def test_replay_with_port_cache_gives_equal_system_results(chunk):
    ref, ref_results = _replay(chunk, port=False)
    got, got_results = _replay(chunk, port=True)
    assert ref.completed == 6 and len(ref_results) == len(ref.steps) > 0
    _same(got_results, ref_results, "SystemResult")
    assert got.summary() == ref.summary()
    _same(got.requests, ref.requests, "requests")
    _same(got.steps, ref.steps, "steps")
    assert [t.stream for t in got.traces] == [t.stream for t in ref.traces]
    kinds = {s.kind for s in ref.steps}
    assert kinds == ({"decode"} if chunk is None else kinds | {"mixed"})


# --- chunked prefill in the batcher (tests/test_serve_replay.py) ---------------

def test_prefill_pack_respects_budget_and_fifo():
    """Packs never exceed the token budget, are FIFO by admission, and
    apply_prefill flips decode eligibility only once the whole prompt has
    landed."""
    b = ContinuousBatcher(n_slots=2, prefill_chunk_tokens=5)
    b.submit(Request(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=2))
    b.submit(Request(rid=1, prompt=np.zeros(3, np.int32), max_new_tokens=2))
    b.schedule()
    done_rids = []
    for _ in range(8):
        pack = b.prefill_pack()
        if not pack:
            break
        assert sum(n for _, _, n in pack) <= 5
        assert all(n > 0 for _, _, n in pack)
        rids = [req.rid for _, req, n in pack]
        assert rids == sorted(rids)                # FIFO by admission
        b.record_tokens(np.zeros(b.n_slots, np.int32), decode=False)
        done_rids += [r.rid for r in b.apply_prefill(pack)]
    assert set(done_rids) == {0, 1}
    assert all(r.prefill_done for r in b.active if r is not None)
    with pytest.raises(ValueError):
        ContinuousBatcher(n_slots=2, prefill_chunk_tokens=0)


def test_chunked_prefill_timeline_ordering():
    """prefill_done_step lies between admission and the first token, and
    a request emits no token before its prompt is prefilled; a prefill
    step that decodes nothing (decode=False) emits no token either."""
    b = ContinuousBatcher(n_slots=2, prefill_chunk_tokens=4)
    reqs = [Request(rid, np.zeros(n, np.int32), max_new_tokens=3)
            for rid, n in enumerate((9, 2, 5))]
    for r in reqs:
        b.submit(r)
    for step in range(40):
        if b.idle():
            break
        b.schedule()
        pack = b.prefill_pack()
        mid = [r for r in b.active if r is not None and not r.prefill_done]
        b.record_tokens(np.full(b.n_slots, step, np.int32),
                        decode=step % 3 != 2)
        assert all(not r.out_tokens for r in mid)
        b.apply_prefill(pack)
    assert b.idle() and len(b.completed) == 3
    for r in reqs:
        t = r.timeline
        assert t.admitted_step <= t.prefill_done_step < t.first_token_step
        assert len(r.out_tokens) == 3


def test_legacy_default_prefills_at_admission():
    """prefill_chunk_tokens=None: the whole prompt counts at admission,
    no pack is proposed, and the request decodes from its first step."""
    b = ContinuousBatcher(n_slots=1)
    r = Request(0, np.zeros(7, np.int32), max_new_tokens=1)
    b.submit(r)
    b.schedule()
    assert r.prefill_done and r.prefilled_tokens == 7
    assert b.prefill_pack() == []
    assert b.apply_prefill([]) == []
    b.record_tokens(np.array([5]))
    assert r.out_tokens == [5]
    assert r.timeline.prefill_done_step == r.timeline.admitted_step \
        == r.timeline.first_token_step == 0


@pytest.mark.parametrize("chunk", [None, 1, 3, 16])
@pytest.mark.parametrize("seed", range(3))
def test_batcher_matches_reference(chunk, seed):
    """Both batchers driven by the same seeded submissions, packs and
    decode flags: the same admissions, packs, completions and
    timelines."""
    rng = np.random.default_rng(seed)
    batchers = [mod.ContinuousBatcher(3, prefill_chunk_tokens=chunk,
                                      admit=lambda r: r.rid % 5 != 4
                                      or r.timeline.submitted_step > 2)
                for mod in (port_batching, jax_batching)]
    mods = (port_batching, jax_batching)
    reqs = [[], []]
    for step in range(60):
        if step < 8:
            n = int(rng.integers(1, 12))
            m = int(rng.integers(1, 5))
            for i, (mod, b) in enumerate(zip(mods, batchers)):
                r = mod.Request(step, np.zeros(n, np.int32), m)
                reqs[i].append(r)
                b.submit(r)
        tokens = rng.integers(0, 100, 3).astype(np.int32)
        decode = bool(rng.random() < 0.8)
        outs = []
        for b in batchers:
            adm = [(s, r.rid) for s, r in b.schedule()]
            pack = b.prefill_pack()
            packed = [(s, r.rid, n) for s, r, n in pack]
            done = [r.rid for r in b.record_tokens(tokens, decode=decode)]
            pre = [r.rid for r in b.apply_prefill(pack)]
            outs.append((adm, packed, done, pre, b.steps, b.slot_steps,
                         b.busy_slot_steps, b.occupancy, b.idle()))
        assert outs[0] == outs[1], step
    for rp, rj in zip(*reqs):
        assert dataclasses.asdict(rp.timeline) == dataclasses.asdict(
            rj.timeline)
        assert (rp.out_tokens, rp.prefilled_tokens, rp.done) \
            == (rj.out_tokens, rj.prefilled_tokens, rj.done)
