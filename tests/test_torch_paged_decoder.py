"""The port's paged KV cache against the JAX package's.

Mirrors ``tests/test_paged_decoder.py``: the page allocator's accounting,
reservation and exhaustion; scatter/gather round trips and null-page
routing; and the paged steps (``paged_prefill_chunk`` at chunk widths 4
and 8, ``paged_decode_step``) against their JAX counterparts, logits and
pools, at the JAX pin (rtol/atol 2e-4), on ``pw-tiny-decoder`` and a tiny
config with an 8-token sliding window.  JAX weights are carried across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.ops import attention as jattn  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.ops import attention as tattn  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
JCFG = jdec.decoder_config_for("pw-tiny-decoder")
TCFG = tdec.decoder_config_for("pw-tiny-decoder")
CONFIGS = {
    "full": (JCFG, TCFG),
    "window8": (dataclasses.replace(JCFG, sliding_window=8), dataclasses.replace(TCFG, sliding_window=8)),
}
J_CHUNK = jax.jit(jdec.paged_prefill_chunk, static_argnums=(7,))
J_STEP = jax.jit(jdec.paged_decode_step, static_argnums=(6,))
J_PREFILL = jax.jit(jdec.prefill, static_argnums=(3, 4))


@pytest.fixture(scope="module")
def trees():
    jtree = jax.device_get(jax.jit(jdec.init_decoder_params, static_argnums=(0, 1))(JCFG, 3))
    return jtree, tdec.from_jax_decoder_params(jtree, TCFG, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------


def test_allocator_basic_accounting():
    a = tdec.PageAllocator(9, page_size=4, bytes_per_token=10)
    assert a.free_pages == 8  # page 0 reserved as the null page
    assert a.used_pages == 0 and a.live_bytes == 0 and a.peak_bytes == 0
    assert [a.pages_for(n) for n in (1, 4, 5, 0)] == [1, 1, 2, 1]
    a.reserve(3)
    assert a.reserved == 3
    pages = [a.alloc() for _ in range(3)]
    assert a.reserved == 0
    assert 0 not in pages  # the null page is never handed out
    assert a.used_pages == 3 and a.live_bytes == 3 * 4 * 10
    a.release(pages)
    assert a.used_pages == 0 and a.live_bytes == 0
    assert a.peak_bytes == 3 * 4 * 10  # high-water mark survives release


def test_allocator_reservation_bounds_admission():
    a = tdec.PageAllocator(5, page_size=2, bytes_per_token=1)
    assert a.can_reserve(4)
    a.reserve(4)
    assert not a.can_reserve(1)
    with pytest.raises(tdec.PageExhaustedError):
        a.reserve(1)
    # a slot that finishes early returns its unused reservation too
    p = a.alloc()
    a.release([p], unreserve=3)
    assert a.reserved == 0 and a.free_pages == 4


def test_allocator_exhaustion_raises():
    a = tdec.PageAllocator(3, page_size=2, bytes_per_token=1)
    a.reserve(2)
    a.alloc()
    a.alloc()
    with pytest.raises(tdec.PageExhaustedError):
        a.alloc(reserved=False)


def test_allocator_rejects_degenerate_pool():
    with pytest.raises(ValueError):
        tdec.PageAllocator(1, page_size=2, bytes_per_token=1)


@pytest.mark.parametrize("name", ["pw-tiny-decoder", "mistral-7b-instruct"])
def test_kv_bytes_per_token_matches_jax(name):
    assert tdec.kv_bytes_per_token(tdec.decoder_config_for(name)) == \
        jdec.kv_bytes_per_token(jdec.decoder_config_for(name))
    if name == "mistral-7b-instruct":
        assert tdec.kv_bytes_per_token(tdec.decoder_config_for(name)) == 131072


def test_init_kv_pool_shape():
    k, v = tdec.init_kv_pool(TCFG, 6, 4, "cpu")
    jk, _ = jdec.init_kv_pool(JCFG, 6, 4)
    assert tuple(k.shape) == jk.shape and k.dtype == TCFG.dtype
    assert float(k.abs().sum() + v.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# scatter / gather
# ---------------------------------------------------------------------------


def _pools(num_pages=6, page=4, kh=2, d=3):
    return torch.zeros((num_pages, page, kh, d)), jnp.zeros((num_pages, page, kh, d), jnp.float32)


def test_scatter_gather_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    pool, jpool = _pools()
    # slot 0 uses pages [1, 2]; slot 1 uses page [3]
    bt = np.array([[1, 2], [3, 0]])
    positions = np.array([[0, 1, 5], [0, 1, 1]])
    values = rng.normal(size=(2, 3, 2, 3)).astype(np.float32)
    tattn.scatter_kv_pages(pool, _t(bt), _t(positions), torch.from_numpy(values))
    got = tattn.gather_kv_pages(pool, _t(bt))  # [S, 8, KH, D]
    np.testing.assert_allclose(_np(got[0, 0]), values[0, 0])
    np.testing.assert_allclose(_np(got[0, 1]), values[0, 1])
    np.testing.assert_allclose(_np(got[0, 5]), values[0, 2])
    np.testing.assert_allclose(_np(got[1, 0]), values[1, 0])
    # same-position scatter takes the last write (set semantics)
    np.testing.assert_allclose(_np(got[1, 1]), values[1, 2])
    assert float(got[0, 2:5].abs().sum()) == 0.0  # untouched positions stay zero
    jpool = jattn.scatter_kv_pages(jpool, jnp.asarray(bt, jnp.int32), jnp.asarray(positions, jnp.int32),
                                   jnp.asarray(values))
    np.testing.assert_array_equal(_np(pool), _np(jpool))
    np.testing.assert_array_equal(_np(got), _np(jattn.gather_kv_pages(jpool, jnp.asarray(bt, jnp.int32))))


def test_scatter_out_of_table_routes_to_null_page():
    """A position past the table's width lands in page 0, never in a
    slot's live pages."""
    pool, _ = _pools()
    bt = _t([[1, 2]])  # covers positions [0, 8)
    tattn.scatter_kv_pages(pool, bt, _t([[3]]), torch.full((1, 1, 2, 3), 7.0))
    tattn.scatter_kv_pages(pool, bt, _t([[9]]), torch.full((1, 1, 2, 3), 99.0))
    got = tattn.gather_kv_pages(pool, bt)
    np.testing.assert_allclose(_np(got[0, 3]), 7.0)
    assert float(got[0, 4:].abs().sum()) == 0.0  # live pages untouched
    assert float(pool[0, 1].abs().sum()) == 2 * 3 * 99.0  # the null page took it
    # the padding position of a prefill chunk goes the same way
    tattn.scatter_kv_pages(pool, bt, _t([[2**30]]), torch.full((1, 1, 2, 3), 5.0))
    assert float(pool[1:].abs().sum()) == float(got.abs().sum())


def test_null_block_table_entries_gather_null_page():
    pool, _ = _pools()
    pool[2] = 5.0  # a page some other slot owns
    got = tattn.gather_kv_pages(pool, _t([[1, 0]]))
    assert float(got[0, 4:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# paged steps vs the JAX package's
# ---------------------------------------------------------------------------


def _alloc_tables(lens, max_tokens, page):
    """Contiguous page assignment, the scheduler's shape."""
    bt = np.zeros((len(lens), -(-max_tokens // page)), np.int64)
    nxt = 1
    for s, n in enumerate(lens):
        for g in range(-(-n // page)):
            bt[s, g] = nxt
            nxt += 1
    return bt


def _ragged(rng, lens):
    ids = np.zeros((len(lens), max(lens)), np.int64)
    for s, n in enumerate(lens):
        ids[s, :n] = rng.integers(1, JCFG.vocab_size, n)
    return ids


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_paged_prefill_chunks_match_jax(trees, chunk, config):
    """Chunked paged prefill on a ragged batch: every chunk's logits and
    the pools after it equal the JAX package's; the last logits also match
    dense ``prefill``."""
    jc, tc = CONFIGS[config]
    jtree, ttree = trees
    lens = [7, 12, 1]
    S, page, num_pages = len(lens), 4, 16
    ids = _ragged(np.random.default_rng(1), lens)
    bt = _alloc_tables(lens, 32, page)
    tk, tv = tdec.init_kv_pool(tc, num_pages, page, "cpu")
    jk, jv = jdec.init_kv_pool(jc, num_pages, page)
    done = [0] * S
    logits = None
    while any(done[s] < lens[s] for s in range(S)):
        cids = np.zeros((S, chunk), np.int64)
        clens, starts = np.zeros(S, np.int64), np.zeros(S, np.int64)
        take = np.zeros(S, bool)
        for s in range(S):
            n = min(chunk, lens[s] - done[s])
            if n > 0:
                cids[s, :n] = ids[s, done[s]:done[s] + n]
                clens[s], starts[s] = n, done[s]
                take[s] = done[s] + n >= lens[s]
        tl, tk, tv = tdec.paged_prefill_chunk(ttree, tk, tv, _t(bt), _t(cids), _t(clens), _t(starts), tc)
        jl, jk, jv = J_CHUNK(jtree, jk, jv, *(jnp.asarray(a, jnp.int32) for a in (bt, cids, clens, starts)), jc)
        live = clens > 0
        np.testing.assert_allclose(_np(tl)[live], _np(jl)[live], **TOL)
        np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
        np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
        logits = tl if logits is None else torch.where(torch.from_numpy(take)[:, None], tl, logits)
        for s in range(S):
            done[s] += int(clens[s])
    dense, _, _ = J_PREFILL(jtree, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), jc, 32)
    np.testing.assert_allclose(_np(logits), _np(dense), **TOL)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_paged_decode_matches_jax(trees, config):
    """Greedy continuation after a paged prefill: the port's paged decode
    step gives the JAX step's logits and pools at every step, the JAX
    tokens exactly, and the dense port path's tokens."""
    jc, tc = CONFIGS[config]
    jtree, ttree = trees
    lens = [5, 9]
    S, C, page, num_pages = len(lens), 32, 4, 24
    ids = _ragged(np.random.default_rng(2), lens)
    bt = _alloc_tables([C] * S, C, page)
    tk, tv = tdec.init_kv_pool(tc, num_pages, page, "cpu")
    jk, jv = jdec.init_kv_pool(jc, num_pages, page)
    zeros = np.zeros(S, np.int64)
    tl, tk, tv = tdec.paged_prefill_chunk(ttree, tk, tv, _t(bt), _t(ids), _t(lens), _t(zeros), tc)
    jl, jk, jv = J_CHUNK(jtree, jk, jv, *(jnp.asarray(a, jnp.int32) for a in (bt, ids, lens, zeros)), jc)
    dl, dk, dv = tdec.prefill(ttree, _t(ids), _t(lens), tc, C)
    pos = np.asarray(lens, np.int64)
    for step in range(12):
        tok = np.asarray(tl.argmax(-1))
        np.testing.assert_array_equal(tok, np.asarray(jnp.argmax(jl, -1)), err_msg=f"step {step}")
        np.testing.assert_array_equal(tok, np.asarray(dl.argmax(-1)), err_msg=f"step {step}")
        tl, tk, tv = tdec.paged_decode_step(ttree, tk, tv, _t(bt), _t(pos), _t(tok), tc)
        jl, jk, jv = J_STEP(jtree, jk, jv, *(jnp.asarray(a, jnp.int32) for a in (bt, pos, tok)), jc)
        dl, dk, dv = tdec.decode_step(ttree, dk, dv, _t(tok), _t(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tl), _np(dl), **TOL)
        pos += 1
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    # the pages hold the dense cache, rearranged through the block table
    paged = tattn.gather_kv_pages(tk[0], _t(bt))
    np.testing.assert_allclose(_np(paged), _np(dk[0]), **TOL)


def test_padding_rows_never_touch_live_pages(trees):
    """A slot that is decoding (chunk length 0) while another prefills
    keeps its cached tokens: its padding queries write only to page 0."""
    _, ttree = trees
    page = 4
    tk, tv = tdec.init_kv_pool(TCFG, 8, page, "cpu")
    bt = _t([[1, 2], [3, 4]])
    ids = _t([[5, 6, 7, 8], [9, 10, 11, 0]])
    tdec.paged_prefill_chunk(ttree, tk, tv, bt, ids, _t([4, 3]), _t([0, 0]), TCFG)
    before = tk[:, 1:5].clone()
    tdec.paged_prefill_chunk(ttree, tk, tv, bt, _t([[12, 0, 0, 0], [0, 0, 0, 0]]), _t([1, 0]), _t([4, 3]), TCFG)
    assert torch.equal(tk[:, 3], before[:, 2])  # slot 1's page, untouched
    assert torch.equal(tk[:, 1], before[:, 0])
    assert float(tk[:, 2, 0].abs().sum()) > 0  # slot 0's new token landed
