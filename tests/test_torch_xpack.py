"""The retrieval half of the port's LLM xpack held to the JAX package's.

Splitters and parsers give equal chunks on the same inputs (the PDF, DOCX
and PPTX of ``tests/doc_fixtures.py``, UTF-8 and JSON).  A
``VectorStoreServer`` over ``mocks.fake_embeddings_model`` gives retrieve,
statistics and inputs streams equal to JAX's bit for bit, keys and times
included, its documents staged by ``pw.debug.table_from_rows``.  The slice
as a whole: ``VectorStoreServer`` over ``SentenceTransformerEmbedder`` of a
2-layer encoder (the port's carrying the JAX encoder's weights; the JAX
one's Pallas attention in interpret mode) with its documents from
``pw.io.fs.read`` of a directory of 36 files: embeddings at cosine > 0.999
(``tests/test_attention_kernel.py:119``), distances within 3e-3 (two
bf16 encoders at that cosine part here by up to 1.48e-3 on the CPU) and
retrieved texts equal but at ties within it.  ``Table.live()`` raises
``NotImplementedError`` naming slice H6c, which brings it; the CLI's
``replay``, which slice H4b brought, runs its program under the replay
env, and ``pw.io.postgres.write``, which slice H6b brought, sends the JAX
package's statements to ``tests/torch_fake_services.py``'s Postgres.
"""

from __future__ import annotations

import asyncio
import json
import sys

import jax
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.models.encoder as jenc_mod
import pathway_tpu_torch as tpw
from pathway_tpu.ops import attention as jattn
from tests import doc_fixtures
from tests import torch_dataflow_programs as progs

PACKAGES = (jpw, tpw)
SMALL = {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 512, "max_position_embeddings": 128}
COS_MIN = 0.999
DIST_TOL = 3e-3  # twice the largest gap read on this test (1.48e-3, CPU)


@pytest.fixture(autouse=True)
def clean_graphs(monkeypatch):
    for pw in PACKAGES:
        monkeypatch.setattr(progs.sub(pw, "io._file_readers"), "_time", progs.PinnedClock)
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def corpus(n: int, seed: int, words=(3, 40)) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(progs.WORDS, size=int(rng.integers(*words)))) + "." * int(rng.integers(0, 2))
            for _ in range(n)]


SPLITTERS = {
    "token_default": ("TokenCountSplitter", {}),
    "token_small": ("TokenCountSplitter", {"min_tokens": 3, "max_tokens": 9}),
    "recursive": ("RecursiveSplitter", {"chunk_size": 40, "chunk_overlap": 6}),
    "null": ("NullSplitter", {}),
}


@pytest.mark.parametrize("name", sorted(SPLITTERS))
def test_splitter_chunks_match_jax(name):
    cls, kw = SPLITTERS[name]
    texts = corpus(24, progs.SEED + 40, words=(3, 700))
    got = [[progs.canon(getattr(progs.sub(pw, "xpacks.llm.splitters"), cls)(**kw).__wrapped__(t, {"i": 1}))
            for t in texts] for pw in PACKAGES]
    assert got[1] == got[0]


DOCS = {
    "utf8": ("Utf8Parser", {}, "naïve café text\nsecond line".encode()),
    "json": ("ParseJson", {}, json.dumps({"text": "a json body", "title": "t"}).encode()),
    "pdf": ("PypdfParser", {}, doc_fixtures.make_pdf(["first page text", "second page\nwith two lines"])),
    "docx": ("DocxParser", {}, doc_fixtures.make_docx(["A heading", "a paragraph of words", "last one"])),
    "pptx": ("PptxParser", {}, doc_fixtures.make_pptx([["Title slide", "sub"], ["Second", "bullet one"]])),
    "slides": ("SlideParser", {}, doc_fixtures.make_pptx([["Deck", "intro"], ["Results", "numbers"]])),
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_parser_outputs_match_jax(name):
    cls, kw, data = DOCS[name]
    got = [progs.canon(getattr(progs.sub(pw, "xpacks.llm.parsers"), cls)(**kw).__wrapped__(data)) for pw in PACKAGES]
    assert got[0][1], name  # some chunks
    assert got[1] == got[0]


def mock_store(pw) -> dict:
    """A ``VectorStoreServer`` over the mock embedder and a token splitter:
    24 documents in two epochs and 6 retractions in a third, queries with
    ``k``, a metadata filter and a glob pattern, and statistics and inputs
    queries."""
    vs = progs.sub(pw, "xpacks.llm.vector_store")
    mocks = progs.sub(pw, "xpacks.llm.mocks")
    splitters = progs.sub(pw, "xpacks.llm.splitters")

    class Doc(pw.Schema):
        data: bytes
        _metadata: pw.Json

    texts = corpus(24, progs.SEED + 41, words=(3, 30))
    meta = [pw.Json({"path": f"/docs/{i:02d}.txt", "modified_at": 100 + i, "size": len(t), "group": i % 3})
            for i, t in enumerate(texts)]
    rows = [(t.encode(), m, 2 if i < 16 else 4, 1) for i, (t, m) in enumerate(zip(texts, meta))]
    rows += [(texts[i].encode(), meta[i], 6, -1) for i in range(0, 12, 2)]
    docs = pw.debug.table_from_rows(Doc, rows, is_stream=True)
    server = vs.VectorStoreServer(docs, embedder=mocks.fake_embeddings_model,
                                  splitter=splitters.TokenCountSplitter(min_tokens=2, max_tokens=8), **progs.port_kw(pw))
    Q = server.RetrieveQuerySchema
    queries = pw.debug.table_from_rows(Q, [(texts[1][:20], 3, None, None), (texts[5], 2, "group == 2", None),
                                           ("beta gamma", 4, None, "/docs/1*")])
    I = server.InputsQuerySchema
    inputs = pw.debug.table_from_rows(I, [(None, None), ("group == 1", None), (None, "*/0*")])
    stats = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)]).select()
    return {"retrieve": server.retrieve_query(queries), "statistics": server.statistics_query(stats),
            "inputs": server.inputs_query(inputs)}


def test_mock_vector_store_matches_jax():
    got = [progs.capture(pw, mock_store(pw)) for pw in PACKAGES]
    assert all(got[0][name] for name in ("retrieve", "statistics", "inputs"))
    assert got[1] == got[0]


@pytest.fixture(scope="module")
def small_encoders(tmp_path_factory):
    """The config directory of a 2-layer encoder, and the two packages'
    shared encoders of it on one set of weights (JAX's, seed 0)."""
    d = tmp_path_factory.mktemp("vs_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc_mod, "encoder_attention",
                   lambda *a, interpret=False, **kw: jattn.encoder_attention(*a, interpret=True, **kw))
        mp.setitem(sys.modules, "transformers", None)  # the config's own tokenizer, no download
        jenc = jenc_mod.shared_sentence_encoder(str(d))
        tenc = progs.sub(tpw, "models.encoder").shared_sentence_encoder(str(d), device="cpu")
        tenc.set_params(jax.device_get(jenc.params))
        yield str(d)


def embedded_store(pw, model_dir: str, root) -> tuple:
    """The slice's user program: ``fs.read`` of ``root`` into a
    ``VectorStoreServer`` over ``SentenceTransformerEmbedder``, queried
    from a table; returns (the answers, the embedder)."""
    emb = progs.sub(pw, "xpacks.llm.embedders").SentenceTransformerEmbedder(model_dir, max_batch_size=16,
                                                                            **progs.port_kw(pw))
    docs = pw.io.fs.read(str(root), format="binary", mode="static", with_metadata=True)
    server = progs.sub(pw, "xpacks.llm.vector_store").VectorStoreServer(docs, embedder=emb, **progs.port_kw(pw))
    texts = corpus(8, progs.SEED + 43, words=(2, 6))
    queries = pw.debug.table_from_rows(server.RetrieveQuerySchema, [(t, 4, None, None) for t in texts])
    return server.retrieve_query(queries), emb


def final_answers(pw, table) -> dict:
    rows = pw.debug._capture_table(table).final_rows()
    return {k: [(a["text"], a["dist"]) for a in row[0].value] for k, row in rows.items()}


def test_vector_store_over_the_encoder_matches_jax(small_encoders, tmp_path):
    texts = corpus(36, progs.SEED + 42, words=(4, 60))
    for i, t in enumerate(texts):
        (tmp_path / f"doc{i:02d}.txt").write_text(t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc_mod, "encoder_attention",
                   lambda *a, interpret=False, **kw: jattn.encoder_attention(*a, interpret=True, **kw))
        answers, embedders = {}, {}
        for pw in PACKAGES:
            table, embedders[pw] = embedded_store(pw, small_encoders, tmp_path)
            answers[pw] = final_answers(pw, table)
            pw.G.clear()

        async def embed(emb):
            return np.stack(await asyncio.gather(*(emb.__wrapped__(t) for t in texts)))

        vecs = {pw: asyncio.run(embed(embedders[pw])) for pw in PACKAGES}
    cos = (vecs[jpw] * vecs[tpw]).sum(1) / (np.linalg.norm(vecs[jpw], axis=1) * np.linalg.norm(vecs[tpw], axis=1))
    assert cos.min() > COS_MIN
    a, b = answers[jpw], answers[tpw]
    assert a.keys() == b.keys() and len(a) == 8
    for key, hits in a.items():
        got = b[key]
        assert len(got) == len(hits) == 4
        assert np.abs(np.array([d for _t, d in got]) - [d for _t, d in hits]).max() <= DIST_TOL
        for (text, dist), (got_text, got_dist) in zip(hits, got):
            if text != got_text:  # a tie: both within the pin of each other
                assert abs(dist - got_dist) <= DIST_TOL and got_text in [t for t, _d in hits]


def replays(tmp_path, monkeypatch) -> int:
    """``replay`` (slice H4b) runs its program under the replay env: the
    program checks the env it was given and exits 0."""
    import sys

    from pathway_tpu_torch import cli

    for name in ("PATHWAY_SNAPSHOT_ACCESS", "PATHWAY_REPLAY_STORAGE", "PATHWAY_PERSISTENCE_MODE"):
        monkeypatch.delenv(name, raising=False)
    check = (
        "import os; e = os.environ; "
        f"assert e['PATHWAY_SNAPSHOT_ACCESS'] == 'replay' and e['PATHWAY_REPLAY_STORAGE'] == {str(tmp_path)!r}; "
        "assert e['PATHWAY_PERSISTENCE_MODE'] == e['PATHWAY_REPLAY_MODE'] == 'batch'; "
        "assert e['PATHWAY_PROCESSES'] == '1' and e['PATHWAY_PROCESS_ID'] == '0'"
    )
    with pytest.raises(SystemExit) as done:
        cli.main(["replay", "--record-path", str(tmp_path), "--mode", "batch",
                  sys.executable, "-c", check])
    return done.value.code


def postgres_statements(pw) -> list[str]:
    """``pw.io.postgres.write`` (slice H6b) of an update stream to a fresh
    fake Postgres: the statements it received."""
    from tests.torch_fake_services import PgServer

    srv = PgServer(auth="scram", user="u", password="p")
    t = pw.debug.table_from_markdown("k | v | _time | _diff\n1 | a | 2 | 1\n1 | a | 4 | -1\n1 | b | 4 | 1")
    pw.io.postgres.write(t, {"host": "127.0.0.1", "port": srv.port, "user": "u", "password": "p"}, "t",
                         init_mode="create_if_not_exists")
    try:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
        srv.close()
    return srv.statements


@pytest.mark.parametrize("name,later", [
    ("cli_replay", None), ("io.postgres", None), ("table.live", "slice H6c"),
])
def test_deferred_entry_points_raise_naming_their_slice(name, later, tmp_path, monkeypatch):
    if name == "cli_replay":  # brought by slice H4b: runs now
        assert replays(tmp_path, monkeypatch) == 0
        return
    if name == "io.postgres":  # brought by slice H6b: sends JAX's statements
        statements = [postgres_statements(pw) for pw in PACKAGES]
        assert statements[1] == statements[0] and len(statements[0]) == 8
        return
    # brought by slice H6c: runs a one-row table to the JAX package's snapshot
    snaps = [progs.live_snapshot(pw) for pw in PACKAGES]
    assert later == "slice H6c" and snaps[1] == snaps[0] and snaps[0][0] and snaps[0][1], snaps
