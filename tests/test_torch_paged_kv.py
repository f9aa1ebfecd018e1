"""The port's int8 and paged KV caches against the JAX package: the int8
quantizer, the decode seam with scales, the paged primitives, the block
allocator, the cache sizes, the int8 session, the engine's greedy streams
over the static, paged, int8 and paged int8 caches (the same weights,
through a model zip), the engine's resident-bytes gauge and its out-of-blocks
behaviour; and the freeze contract of the port's in-place caches.

Tolerances: the int8 values equal and the scales within 1 ulp (both divide
the same float32 absmax by 127); the decode seam with scales within 1e-6 of
the same attention on an explicitly dequantized cache (the same float32
products, summed in another order); the paged primitives exact (they move
values); int8 prefill logits within 1e-5 of JAX's (float32 stacks with other
summation orders, on the same int8 slots); greedy streams token for token.

The freeze contract: the port writes caches in place, so a row that is
inactive in a batch step keeps its committed entries bit for bit only
because its writes are kept from landing (``redirect_inactive_writes``).
Each freeze case also shows that the same step without the redirect does
overwrite them: the row sits within k+1 of ``max_len``, where the write's
start is clamped back over committed positions."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generate import block_bytes as jax_block_bytes
from deeplearning4j_tpu.generate import session as jax_session
from deeplearning4j_tpu.nn.layers import attention as jax_attention
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.ops import paged_attention as jax_paged
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine

from deeplearning4j_tpu_torch.generate import (BlockAllocator, GenerationSession,
                                               OutOfBlocksError, SpeculativeGenerationSession,
                                               block_bytes, blocks_needed, paged_decode_state)
from deeplearning4j_tpu_torch.nn.layers import attention as port_attention
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.ops import paged_attention as port_paged
from deeplearning4j_tpu_torch.parallel import DecodeEngine

from torch_decode_helpers import MAX_LEN, PROMPTS, collect, draft_pair, lm_pair

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ENGINES = {"static": {}, "paged": {"block_size": 4}, "int8": {"cache_dtype": "int8"},
           "paged int8": {"cache_dtype": "int8", "block_size": 4}}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return lm_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    return draft_pair(tmp_path_factory)[1]


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engines' greedy streams and resident bytes, one engine per
    cache layout."""
    out = {}
    for label, kw in ENGINES.items():
        eng = JaxEngine(models[0], max_len=MAX_LEN, slots=4, registry=JaxRegistry(), **kw)
        try:
            out[label] = (collect(eng, PROMPTS), eng.stats()["kv_cache_bytes"])
        finally:
            eng.shutdown()
    return out


def _engine(model, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return DecodeEngine(model, max_len=MAX_LEN, slots=4, **kw)


# ---------------------------------------------------------------------------
# int8 quantizer and the decode seam with scales
# ---------------------------------------------------------------------------


def test_quantize_kv_rows_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 2, 5, 8) * rs.uniform(0.01, 10, (3, 2, 5, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero slot: scale eps / 127
    jq, js = jax_attention.quantize_kv_rows(jnp.asarray(x))
    pq, ps = port_attention.quantize_kv_rows(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ps.numpy(), np.asarray(js), maxulp=1)


@pytest.mark.parametrize("tq", [1, 3])
def test_decode_attention_with_scales_matches_explicit_dequant(tq):
    rs = np.random.RandomState(1)
    q = torch.from_numpy(rs.randn(2, 3, tq, 8).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(2, 3, 12, 8).astype(np.float32)) for _ in range(2))
    kq, ks = port_attention.quantize_kv_rows(k)
    vq, vs = port_attention.quantize_kv_rows(v)
    pos = torch.tensor([4, 11 - tq], dtype=torch.int32)
    got = pfa.decode_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs)
    ref = pfa.decode_attention(q, kq.float() * ks[..., None], vq.float() * vs[..., None], pos)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# paged primitives
# ---------------------------------------------------------------------------


def test_pack_row_blocks_matches_jax():
    x = np.random.RandomState(2).randn(3, 12, 4).astype(np.float32)
    got = port_paged.pack_row_blocks(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_paged.pack_row_blocks(jnp.asarray(x), 4)))
    with pytest.raises(ValueError, match="divisible"):
        port_paged.pack_row_blocks(torch.from_numpy(x), 5)


@pytest.mark.parametrize("trailing", [(4,), ()])  # K/V pools and scale pools
def test_paged_gather_matches_jax(trailing):
    rs = np.random.RandomState(3)
    pool = rs.randn(*((7, 2, 4) + trailing)).astype(np.float32)
    table = np.array([[3, 1, 0], [6, 6, 2]], np.int32)
    got = port_paged.paged_gather(torch.from_numpy(pool), torch.from_numpy(table))
    want = jax_paged.paged_gather(jnp.asarray(pool), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("trailing", [(4,), ()])
def test_paged_cache_write_matches_jax(trailing):
    rs = np.random.RandomState(4)
    pool = rs.randn(*((9, 2, 4) + trailing)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 6]], np.int32)
    new = rs.randn(*((3, 2, 3) + trailing)).astype(np.float32)
    # row 1 writes across a block edge; row 2 runs past the table's
    # capacity (12) and is clamped to its last slot, as in JAX
    pos = np.array([0, 2, 10], np.int32)
    want = jax_paged.paged_cache_write(jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table),
                                       jnp.asarray(pos))
    pt = torch.from_numpy(pool.copy())
    out = port_paged.paged_cache_write(pt, torch.from_numpy(new), torch.from_numpy(table),
                                       torch.from_numpy(pos))
    assert out.data_ptr() == pt.data_ptr()  # in place
    # row 2's last two writes both land on the clamped slot: compare the
    # slots written once, and that the clamped one holds one of the two
    got = pt.numpy()
    want = np.asarray(want)
    clamp = (6, slice(None), 3)  # row 2's block for positions 8-11, slot 3
    mask = np.ones(pool.shape[:3], bool)
    mask[clamp] = False
    np.testing.assert_array_equal(got[mask], want[mask])
    assert any(np.array_equal(got[clamp], new[2, :, j]) for j in (1, 2))


# ---------------------------------------------------------------------------
# allocator, paged state, sizes
# ---------------------------------------------------------------------------


class TestBlockAllocator:
    def test_block_zero_reserved_and_all_or_nothing(self):
        a = BlockAllocator(5)  # 4 usable, block 0 is trash
        assert a.total_blocks == 4 and a.free_blocks == 4
        ids = a.alloc(3)
        assert len(ids) == 3 and 0 not in ids and ids == [1, 2, 3]
        assert a.free_blocks == 1
        with pytest.raises(OutOfBlocksError):
            a.alloc(2)
        assert a.free_blocks == 1
        a.free(ids)
        assert a.free_blocks == 4

    def test_free_validates_ids(self):
        a = BlockAllocator(4)
        with pytest.raises(ValueError):
            a.free([0])
        with pytest.raises(ValueError):
            a.free([4])
        with pytest.raises(ValueError):
            BlockAllocator(1)

    def test_blocks_needed(self):
        assert [blocks_needed(n, 4) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_state_and_sizes_match_jax(models, cache_dtype):
    jm, pm = models
    js = jax_session.GenerationSession(jm, max_len=MAX_LEN, cache_dtype=cache_dtype)
    ps = GenerationSession(pm, max_len=MAX_LEN, cache_dtype=cache_dtype)
    carry = paged_decode_state(ps, 3, block_size=4, num_blocks=10)
    paged = [st for st in carry.values() if "block_table" in st]
    assert len(paged) == 2
    for st in paged:
        assert tuple(st["block_table"].shape) == (3, MAX_LEN // 4)
        assert st["cache_k"].shape[:3] == (10, 4, 4)
        assert ("cache_k_scale" in st) == (cache_dtype == "int8")
    assert block_bytes(ps, 4) == jax_block_bytes(js, 4) > 0
    for b in (1, 4):
        assert ps.cache_bytes(b) == js.cache_bytes(b)
    assert ps.bucket_sizes() == js.bucket_sizes()
    assert ps.bucket_sizes(10) == js.bucket_sizes(10)
    with pytest.raises(ValueError, match="divisible"):
        paged_decode_state(ps, 2, block_size=5, num_blocks=10)


# ---------------------------------------------------------------------------
# the int8 session
# ---------------------------------------------------------------------------


def test_int8_session_prefill_matches_jax(models):
    jm, pm = models
    _, jl, jlens = jax_session.GenerationSession(jm, max_len=MAX_LEN, cache_dtype="int8").prefill(PROMPTS)
    carry, pl, plens = GenerationSession(pm, max_len=MAX_LEN, cache_dtype="int8").prefill(PROMPTS)
    np.testing.assert_array_equal(plens, jlens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
    st = carry["layer_2"]
    assert st["cache_k"].dtype == torch.int8 and st["cache_k_scale"].dtype == torch.float32


def test_int8_session_greedy_matches_jax(models):
    jm, pm = models
    j = jax_session.GenerationSession(jm, max_len=MAX_LEN, cache_dtype="int8").generate(PROMPTS, 10)
    p = GenerationSession(pm, max_len=MAX_LEN, cache_dtype="int8").generate(PROMPTS, 10)
    assert p == j


def test_cache_dtype_validated(models):
    with pytest.raises(ValueError, match="cache_dtype"):
        GenerationSession(models[1], max_len=MAX_LEN, cache_dtype="int4")


# ---------------------------------------------------------------------------
# the freeze contract of the in-place caches
# ---------------------------------------------------------------------------


def _carry(sess, lengths, paged: bool):
    """A 2-row carry prefilled with prompts of ``lengths`` (static, or paged
    with row 0 on blocks 1-2 and row 1 on blocks 3-8)."""
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 23, n).tolist() for n in lengths]
    if not paged:
        return sess.prefill(prompts)[0]
    carry = paged_decode_state(sess, 2, block_size=4, num_blocks=12)
    table = torch.tensor([[1, 2, 9, 10, 11, 0], [3, 4, 5, 6, 7, 8]], dtype=torch.int32)
    for st in carry.values():
        if "block_table" in st:
            st["block_table"].copy_(table)
    tb = max(lengths)
    ids = np.zeros((2, tb), np.int32)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
    mask = torch.from_numpy((np.arange(tb)[None] < np.asarray(lengths)[:, None]).astype(np.float32))
    with torch.no_grad():
        new, _ = sess._forward(carry, sess._prep(torch.from_numpy(ids)), mask)
    from deeplearning4j_tpu_torch.generate import freeze_rows
    return freeze_rows(new, carry)


def _row1(carry, paged: bool):
    """Row 1's state: its cache rows (its blocks 3-8 when paged) and pos."""
    out = {}
    for name, st in carry.items():
        for key, t in st.items():
            if key == "block_table":
                continue
            if paged and key != "pos":
                out[(name, key)] = t[3:9].clone()
            else:
                out[(name, key)] = t[1].clone()
    return out


def _same(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["static", "paged"])
def test_inactive_row_frozen_in_plain_step(models, paged, cache_dtype):
    """Row 1 is full (pos == max_len): a plain step's write for it would be
    clamped onto its last committed position."""
    sess = GenerationSession(models[1], max_len=MAX_LEN, cache_dtype=cache_dtype)
    toks = torch.tensor([5, 7], dtype=torch.int32)
    active = torch.tensor([True, False])
    with torch.no_grad():
        carry = _carry(sess, [3, MAX_LEN], paged)
        before = _row1(carry, paged)
        pos0 = int(carry["layer_1"]["pos"][0])
        sess.step(carry, toks, active)
        assert _same(_row1(carry, paged), before)
        assert int(carry["layer_1"]["pos"][0]) == pos0 + 1
        if not paged:  # control: the unmasked step overwrites position L-1
            sess.step(carry, toks)
            assert not _same(_row1(carry, paged), before)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["static", "paged"])
def test_inactive_row_frozen_in_speculative_verify(models, draft, paged, cache_dtype):
    """Row 1 sits 2 positions from max_len, inside the k+1 = 4 window: the
    verify's write for it would start clamped at L-4, over 2 committed
    positions. Both the target's and the draft's carries keep it."""
    spec = SpeculativeGenerationSession(models[1], draft, max_len=MAX_LEN, k=3,
                                        cache_dtype=cache_dtype)
    lengths = [3, MAX_LEN - 2]
    with torch.no_grad():
        tcarry = _carry(spec.target, lengths, paged)
        dcarry = _carry(spec.draft, lengths, False)
        t_before, d_before = _row1(tcarry, paged), _row1(dcarry, False)
        pos0 = int(tcarry["layer_1"]["pos"][0])
        z = np.zeros(2)
        _, _, toks, n_acc, n_emit = spec.step(
            tcarry, dcarry, [5, 7], [1, 1], [True, False], z, [True, True], np.ones(2),
            z.astype(np.int64), np.ones(2), [3, 0])
        assert _same(_row1(tcarry, paged), t_before)
        assert _same(_row1(dcarry, False), d_before)
        # the active row committed exactly its emitted tokens
        assert int(tcarry["layer_1"]["pos"][0]) == pos0 + int(n_emit[0])
        assert int(dcarry["layer_1"]["pos"][0]) == pos0 + int(n_emit[0])
        if not paged:  # control: the same verify with row 1 active overwrites
            spec.step(tcarry, dcarry, [5, 7], [1, 1], [True, True], z, [True, True],
                      np.ones(2), z.astype(np.int64), np.ones(2), [3, 3])
            assert not _same(_row1(tcarry, paged), t_before)


# ---------------------------------------------------------------------------
# the engine over each cache layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", list(ENGINES))
def test_engine_greedy_streams_match_jax_engine(models, jax_streams, label):
    eng = _engine(models[1], **ENGINES[label])
    try:
        assert collect(eng, PROMPTS) == jax_streams[label][0]
        if "block_size" not in ENGINES[label]:  # static: the whole carry
            assert eng.stats()["kv_cache_bytes"] == jax_streams[label][1]
    finally:
        eng.shutdown()


def test_paged_engine_gauge_tracks_resident_blocks(models):
    reg = MetricsRegistry()
    eng = _engine(models[1], block_size=4, registry=reg)
    try:
        st = eng.stats()
        assert st["kv_cache_bytes"] == 0 and st["kv_block_size"] == 4
        assert st["kv_blocks_total"] == 4 * (MAX_LEN // 4) == st["kv_blocks_free"]
        per_block = block_bytes(eng.session, 4)
        seen = []
        eng._step_hook = lambda: seen.append((eng.stats()["kv_blocks_free"],
                                              eng.stats()["kv_cache_bytes"]))
        eng.submit([1, 2, 3, 4, 5], max_tokens=4).result(timeout=120)
        eng._step_hook = None
        free_mid, bytes_mid = seen[0]
        used_mid = st["kv_blocks_total"] - free_mid
        assert used_mid >= blocks_needed(5, 4) and bytes_mid == used_mid * per_block
        assert reg.get("dl4j_tpu_generate_kv_cache_bytes") is not None
        done = eng.stats()
        assert done["kv_blocks_free"] == done["kv_blocks_total"]
        assert done["kv_cache_bytes"] == 0
    finally:
        eng.shutdown()


def test_admit_requeues_until_blocks_free_then_fails_terminally(models):
    """5 usable blocks of 4: a second request waits for the first's blocks
    instead of failing; a prompt the whole pool cannot hold fails once the
    batch is idle, with a clear error."""
    eng = _engine(models[1], block_size=4, num_kv_blocks=6)
    try:
        h1 = eng.submit(list(range(1, 11)), max_tokens=8)
        h2 = eng.submit(list(range(4, 14)), max_tokens=8)
        assert len(h1.result(timeout=120)) == 8 and len(h2.result(timeout=120)) == 8
        assert h1.reason == h2.reason == "completed"
        h = eng.submit(list(range(1, 22)), max_tokens=2)
        term = list(h.events(timeout=60))[-1]
        assert term["reason"] == "failed" and "blocks" in term.get("error", "")
    finally:
        eng.shutdown()


def test_mid_stream_exhaustion_preempts_one_row(models):
    """4 usable blocks, two rows of 2 blocks each growing: when neither can
    get a third block, the first is preempted (partial output, reason
    "failed") and its blocks let the other finish its greedy stream."""
    eng = _engine(models[1], block_size=4, num_kv_blocks=5)
    try:
        eng._slot_target = 0  # hold admission until both are queued
        ha = eng.submit([1, 2, 3, 4, 5], max_tokens=10)
        hb = eng.submit([6, 7, 8, 9, 10], max_tokens=10)
        eng.set_decode_control(slot_target=2)
        eng._wake.set()
        ha.result(timeout=120)
        hb.result(timeout=120)
    finally:
        eng.shutdown()
    term = list(ha.events(timeout=5))[-1]
    assert ha.reason == "failed" and "exhausted" in term.get("error", "")
    assert 0 < len(ha.tokens) < 10
    assert hb.reason == "completed"
    sess = GenerationSession(models[1], max_len=MAX_LEN)
    assert hb.tokens == sess.generate([[6, 7, 8, 9, 10]], 10)[0]
