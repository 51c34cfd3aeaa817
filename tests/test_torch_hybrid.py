"""The port's index slice held to the JAX package's.

``BM25Index`` and ``PyHnswIndex``/``NativeHnswIndex`` take the same adds,
updates, removes and queries in both packages (three metrics, compaction,
filters on the engine's ``Json``) and answer alike: BM25 bit for bit, HNSW
ids equal and scores within 1e-6.  Where the JAX package's native core did
not load in this worker (its build race, ROADMAP's "Three known flakes"),
the port's native index is held to the exact top-k at recall >= 0.9 and to
its ``PyHnswIndex``'s self-match scores instead.  ``HybridIndex`` runs
through ``DataIndex.query`` and ``query_as_of_now`` with retractions (its dense
half a ``BruteForceKnn``, an ``LshKnn`` or a ``USearchKnn``), and
the three factories and the default document indexes through
``DocumentStore``, their change streams equal to JAX's.  ``chip_smoke.py``'s
``[hybrid]`` program at a small width (a 2-layer encoder, the port's
carrying the JAX encoder's weights; the JAX one's Pallas attention in
interpret mode): stored embeddings at cosine > 0.999
(``tests/test_attention_kernel.py:119``), BM25 lists equal, fused lists
equal but where the dense scores of the chunks that part lie within 1e-2.
"""

from __future__ import annotations

import json
import sys

import jax
import numpy as np
import pytest

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu.models.encoder as jenc_mod
import pathway_tpu_torch as tpw
from pathway_tpu.ops import attention as jattn
from tests import torch_dataflow_programs as progs

PACKAGES = (jpw, tpw)
SCORE_TOL = 1e-6
DENSE_TOL = 1e-2
COS_MIN = 0.999
SMALL = {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 512, "max_position_embeddings": 128}


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def jax_native_loaded() -> bool:
    """Whether the JAX package's native core loaded in this worker; asked at
    run time only, never at import or collection."""
    from pathway_tpu import native

    return native.get() is not None


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------

VOCAB = tuple(progs.WORDS) + ("kappa", "lambda", "mu", "nu", "xi", "omicron", "pi", "rho")


def bm25_run(pw, seed: int, filtered: bool) -> list:
    """Adds, removes and re-adds over ``Json`` metadata, then queries."""
    bm25 = progs.sub(pw, "stdlib.indexing.bm25")
    rng = np.random.default_rng(seed)
    index = bm25.BM25Index()
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    texts = [" ".join(rng.choice(VOCAB, size=int(rng.integers(3, 30)), p=p / p.sum())) for _ in range(80)]
    for key, text in enumerate(texts):
        index.add(key, text.upper() if key % 7 == 0 else text, pw.Json({"group": key % 3, "path": f"/d/{key}"}))
    for key in rng.choice(80, size=20, replace=False):
        index.remove(int(key))
    for key in range(0, 80, 9):
        index.add(key, texts[(key + 1) % 80], pw.Json({"group": 1, "path": f"/e/{key}"}))
    filters = ["group == 1", "globmatch('/d/1*', path)", "group != 0 && group != 1"] if filtered else [None]
    out = []
    for q in range(12):
        query = " ".join(rng.choice(VOCAB, size=int(rng.integers(1, 6))))
        for f in filters:
            out.append(index.search(query, int(rng.integers(1, 12)), f))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("filtered", [False, True])
def test_bm25_matches_jax_bit_for_bit(seed, filtered):
    jax_out, port = (bm25_run(pw, seed, filtered) for pw in PACKAGES)
    assert sum(map(len, jax_out)) > 20
    assert port == jax_out


# ---------------------------------------------------------------------------
# HNSW
# ---------------------------------------------------------------------------


def hnsw_ops(seed: int, scenario: str, n: int = 120, dim: int = 12) -> list:
    """The operations of ``scenario``: every row added with ``Json``-like
    metadata, then ``updates`` (every row re-added twice with new vectors,
    so tombstones outnumber live nodes and the index compacts) or
    ``removes`` (70 rows removed, compacting too, and 10 re-added)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(3 * n, dim)).astype(np.float32)
    ops = [("add", i, vecs[i], {"group": i % 3}) for i in range(n)]
    if scenario == "updates":
        ops += [("add", i, vecs[n + (i + r * 37) % (2 * n)], {"group": (i + r) % 3}) for r in range(2) for i in range(n)]
    else:
        gone = [int(i) for i in rng.choice(n, size=70, replace=False)]
        ops += [("remove", i, None, None) for i in gone] + [("add", i, vecs[2 * n + i], {"group": 2}) for i in gone[:10]]
    return ops


def hnsw_run(index, ops, queries, pw, k: int = 7) -> list:
    for op, key, vec, meta in ops:
        if op == "add":
            index.add(key, vec, pw.Json(meta))
        else:
            index.remove(key)
    return [index.search(q, k, f) for q in queries for f in (None, "group == 1")]


def hnsw_queries(seed: int, dim: int = 12):
    return np.random.default_rng(seed + 100).normal(size=(10, dim)).astype(np.float32)


def assert_same_answers(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [key for key, _s in g] == [key for key, _s in w]
        np.testing.assert_allclose([s for _k, s in g], [s for _k, s in w], atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("metric", ["cos", "l2sq", "ip"])
@pytest.mark.parametrize("scenario", ["updates", "removes"])
def test_py_hnsw_matches_jax(metric, scenario):
    ops, queries = hnsw_ops(3, scenario), hnsw_queries(3)
    answers = [hnsw_run(progs.sub(pw, "stdlib.indexing.hnsw").PyHnswIndex(metric=metric), ops, queries, pw)
               for pw in PACKAGES]
    assert sum(map(len, answers[0])) > 60
    assert_same_answers(answers[1], answers[0])


@pytest.mark.parametrize("metric", ["cos", "l2sq", "ip"])
@pytest.mark.parametrize("scenario", ["updates", "removes"])
def test_native_hnsw_matches_jax(metric, scenario):
    ops, queries = hnsw_ops(5, scenario), hnsw_queries(5)
    thnsw = progs.sub(tpw, "stdlib.indexing.hnsw")
    native = thnsw.NativeHnswIndex(metric=metric)
    got = hnsw_run(native, ops, queries, tpw)
    assert native._n_dead <= len(native)  # compacted
    if jax_native_loaded():
        want = hnsw_run(progs.sub(jpw, "stdlib.indexing.hnsw").NativeHnswIndex(metric=metric), ops, queries, jpw)
        assert_same_answers(got, want)
        return
    # the JAX native core lost its build race here: the exact top-k and the
    # port's own Python graph stand in for it
    live = {}
    for op, key, vec, _meta in ops:
        if op == "add":
            live[key] = vec
        else:
            live.pop(key, None)
    keys = np.array(sorted(live))
    mat = np.stack([live[key] for key in keys])
    prep = mat / np.linalg.norm(mat, axis=1, keepdims=True) if metric == "cos" else mat
    hits = 0
    for q, res in zip(queries, got[::2]):
        qq = q / np.linalg.norm(q) if metric == "cos" else q
        sims = -((prep - qq) ** 2).sum(1) if metric == "l2sq" else prep @ qq
        hits += len({key for key, _s in res} & set(keys[np.argsort(-sims)[:7]].tolist()))
    assert hits / (7 * len(queries)) >= 0.9
    py = thnsw.PyHnswIndex(metric=metric)
    hnsw_run(py, ops, [], tpw)
    for key in keys[:10]:  # each row's score against itself (first but under ip)
        n_hits, p_hits = native.search(live[key], 7), py.search(live[key], 7)
        assert metric == "ip" or n_hits[0][0] == p_hits[0][0] == key
        ns, ps = dict(n_hits)[key], dict(p_hits)[key]  # two summation orders in f32
        assert abs(ns - ps) <= SCORE_TOL * max(1.0, abs(ps))


# ---------------------------------------------------------------------------
# HybridIndex, the factories and the default document indexes
# ---------------------------------------------------------------------------


@pytest.fixture
def same_hnsw(monkeypatch):
    """Both packages' ``HnswIndex`` on one implementation: the native core
    where the JAX package's loaded in this worker, else the Python graph."""
    impl = "NativeHnswIndex" if jax_native_loaded() else "PyHnswIndex"
    for pw in PACKAGES:
        mod = progs.sub(pw, "stdlib.indexing.hnsw")
        monkeypatch.setattr(mod, "HnswIndex", lambda _cls=getattr(mod, impl), **kw: _cls(**kw))
    return impl


@pytest.mark.parametrize("dense", ["brute", "lsh", "usearch"])
def test_hybrid_index_queries_match_jax(dense, same_hnsw):
    jax_out, port = (progs.capture(pw, progs.hybrid_index_program(pw, dense)) for pw in PACKAGES)
    for name, stream in jax_out.items():
        assert any(d < 0 for _t, _k, d, _r in stream), name  # data changes revise answers
    assert port == jax_out


def factory_store(pw, name: str) -> dict:
    """A ``DocumentStore`` over the mock embedder and the named factory, or
    a default document index over its chunks: 20 documents in two epochs
    and 5 retractions in a third, queried with ``k`` and a filter."""
    idx = progs.sub(pw, "stdlib.indexing")
    llm = progs.sub(pw, "xpacks.llm")
    mocks = progs.sub(pw, "xpacks.llm.mocks")
    rng = np.random.default_rng(progs.SEED + 60)

    class Doc(pw.Schema):
        data: bytes
        _metadata: pw.Json

    texts = [" ".join(rng.choice(VOCAB, size=int(rng.integers(3, 14)))) for _ in range(20)]
    meta = [pw.Json({"path": f"/docs/{i:02d}.txt", "group": i % 3}) for i in range(20)]
    rows = [(t.encode(), m, 2 if i < 14 else 4, 1) for i, (t, m) in enumerate(zip(texts, meta))]
    rows += [(texts[i].encode(), meta[i], 6, -1) for i in range(0, 15, 3)]
    docs = pw.debug.table_from_rows(Doc, rows, is_stream=True)
    emb = mocks.fake_embeddings_model
    factories = {
        "UsearchKnnFactory": lambda: idx.UsearchKnnFactory(embedder=emb),
        "TantivyBM25Factory": lambda: idx.TantivyBM25Factory(),
        "HybridIndexFactory": lambda: idx.HybridIndexFactory(
            retriever_factories=[idx.UsearchKnnFactory(embedder=emb), idx.TantivyBM25Factory()]),
    }
    queries = [(" ".join(rng.choice(VOCAB, size=3)), int(rng.integers(1, 5)), f, None)
               for f in (None, "group == 1", None)]
    if name in factories:
        store = llm.DocumentStore(docs, factories[name]())
        q = pw.debug.table_from_rows(store.RetrieveQuerySchema, queries)
        return {"retrieve": store.retrieve_query(q)}
    store = llm.DocumentStore(docs, idx.TantivyBM25Factory())
    chunks = store.chunked_docs
    kw = {"embedder": emb, "dimensions": 8} if name == "default_vector_document_index" else {}
    index = getattr(idx, name)(chunks.text, chunks, metadata_column=chunks.metadata, **kw)
    q = pw.debug.table_from_rows(pw.schema_from_types(q=str, k=int, f=str | None), [x[:3] for x in queries])
    return {"asof_now": index.query_as_of_now(q.q, number_of_matches=q.k, metadata_filter=q.f)}


@pytest.mark.parametrize("name", ["UsearchKnnFactory", "TantivyBM25Factory", "HybridIndexFactory",
                                  "default_vector_document_index", "default_full_text_document_index"])
def test_document_indexes_match_jax(name, same_hnsw):
    jax_out, port = (progs.capture(pw, factory_store(pw, name)) for pw in PACKAGES)
    assert all(jax_out.values())
    assert port == jax_out


def test_usearch_knn_keeps_the_device_keyword_and_stays_on_the_host():
    idx = progs.sub(tpw, "stdlib.indexing")
    t = tpw.debug.table_from_markdown("text\nalpha beta")
    inner = idx.USearchKnn(t.text, device="cuda:0", connectivity=8, expansion_search=32)
    built = inner.factory().build()  # a host graph: no device is touched
    assert type(built).__name__ in ("NativeHnswIndex", "PyHnswIndex") and built.ef_search == 32


# ---------------------------------------------------------------------------
# chip_smoke.py's [hybrid] program at a small width
# ---------------------------------------------------------------------------

HY_SIZES = chip_smoke.HybridSizes(files=14, words=(20, 90), questions=6, commits=1, k=4, deleted=2, rewritten=2)


@pytest.fixture(scope="module")
def small_encoder(tmp_path_factory):
    """The config directory of a 2-layer encoder; both packages' shared
    encoders of it carry the JAX encoder's weights (seed 0)."""
    d = tmp_path_factory.mktemp("hybrid_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)  # the config's own tokenizer, no download
        jenc = jenc_mod.shared_sentence_encoder(str(d))
        tenc = progs.sub(tpw, "models.encoder").shared_sentence_encoder(str(d), device="cpu")
        tenc.set_params(jax.device_get(jenc.params))
        yield str(d), jenc


def hybrid_run(pw, model_dir: str, corpus: dict) -> tuple:
    """The phase's store and retrieval on ``corpus``, staged by
    ``table_from_rows``: the files at time 2, the questions at 4, the change
    at 6.  Returns (the probe, each question's final answer)."""
    emb = progs.sub(pw, "xpacks.llm.embedders").SentenceTransformerEmbedder(model_dir, max_batch_size=16,
                                                                            **progs.port_kw(pw))

    class Doc(pw.Schema):
        data: bytes
        _metadata: pw.Json

    def row(i, text, time, diff):
        return (text.encode(), pw.Json({"path": f"doc{i:05d}.txt"}), time, diff)

    texts = corpus["texts"]
    rows = [row(i, texts[i], 2, 1) for i in range(HY_SIZES.files)]
    for i in corpus["deleted"] + corpus["rewritten"]:
        rows.append(row(i, texts[i], 6, -1))
    rows += [row(i, texts[corpus["new_text"][i]], 6, 1) for i in corpus["rewritten"]]
    docs = pw.debug.table_from_rows(Doc, rows, is_stream=True)
    store = chip_smoke.hybrid_store(pw, docs, emb)
    questions = pw.debug.table_from_rows(store.RetrieveQuerySchema,
                                         [(q, HY_SIZES.k, None, None, 4, 1) for q in corpus["questions"]],
                                         is_stream=True)
    hits = chip_smoke.hybrid_hits(pw, store, questions)
    probe = chip_smoke.HybridProbe(pw)
    probe.install()
    try:
        final = pw.debug._capture_table(hits).final_rows()
    finally:
        probe.uninstall()
    return probe, {row[0]: [(h["text"], h["dist"]) for h in row[1].value] for row in final.values()}


def test_hybrid_phase_program_matches_jax(small_encoder):
    model_dir, jenc = small_encoder
    corpus = chip_smoke.hybrid_corpus(0, HY_SIZES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc_mod, "encoder_attention",
                   lambda *a, interpret=False, **kw: jattn.encoder_attention(*a, interpret=True, **kw))
        runs = {}
        for pw in PACKAGES:
            runs[pw] = hybrid_run(pw, model_dir, corpus)
            pw.G.clear()
        (jprobe, janswers), (tprobe, tanswers) = runs[jpw], runs[tpw]
        # the port's stored vectors against the JAX encoder's embeddings
        texts = sorted(tprobe.stored)
        ref = np.asarray(jenc.encode(texts))
        got = np.stack([tprobe.stored[t] for t in texts])
        cos = (ref * got).sum(1) / (np.linalg.norm(ref, axis=1) * np.linalg.norm(got, axis=1))
    assert len(texts) == len(set(corpus["chunk_texts"])) and cos.min() > COS_MIN
    assert tprobe.dense_types == {"NativeHnswIndex"}
    searched = [[(s["query"], s["after"]) for s in p.searches] for p in (jprobe, tprobe)]
    assert searched[0] == searched[1] and len(searched[1]) >= 2 * HY_SIZES.questions
    for js, ts in zip(jprobe.searches, tprobe.searches):
        assert ts["inner"]["bm25"] == js["inner"]["bm25"]
        if ts["fused"] != js["fused"]:
            jd, td = js["inner"]["hnsw"], ts["inner"]["hnsw"]
            jscore, tscore = dict(jd), dict(td)
            for (jt, _js), (tt, _ts) in zip(jd, td):
                if jt != tt:  # parted: each chunk's score within the pin in the other package
                    assert abs(jscore[jt] - tscore.get(jt, -9)) <= DENSE_TOL
                    assert abs(tscore[tt] - jscore.get(tt, -9)) <= DENSE_TOL
    assert janswers.keys() == tanswers.keys() == set(corpus["questions"])
    removed = set(corpus["chunk_texts"][c] for c in corpus["initial"]) - \
        set(corpus["chunk_texts"][c] for c in corpus["final"])
    for q, hits in tanswers.items():
        assert len(hits) == HY_SIZES.k and not {t for t, _d in hits} & removed
