"""The answering half of the port's LLM xpack held to the JAX package's.

``prompts.*`` and ``rerank_topk_filter`` give equal values on the same
inputs; ``CrossEncoderReranker`` over a 2-layer cross-encoder carrying the
JAX one's weights scores within 0.05·(max|ref|+1)
(``tests/test_attention_kernel.py:135``; the JAX attention through its
plain XLA version, as on any CPU); ``JaxChat`` on ``pw-tiny-decoder`` (f32, the JAX weights carried by
``from_jax_decoder_params``) gives exactly JAX's greedy answers on the
continuous and the static path.  The ``rag`` program of
``tests/torch_rest_programs.py`` — ``BaseRAGQuestionAnswerer``,
``AdaptiveRAGQuestionAnswerer`` and ``VectorStoreServer`` over
``FakeEmbeddings`` and ``IdentityMockChat`` — answers every route as the
JAX package's does, and ``RAGClient`` and ``VectorStoreClient`` of both
packages get the same answers from the port's server.
"""

from __future__ import annotations

import json
import sys

import jax
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.models.encoder as jenc_mod
import pathway_tpu_torch as tpw
from tests import torch_dataflow_programs as progs
from tests import torch_rest_programs as rp

PACKAGES = (jpw, tpw)
NAMES = {jpw: "pathway_tpu", tpw: "pathway_tpu_torch"}
SMALL_CE = {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 512, "max_position_embeddings": 128}
QUESTIONS = ["what is alpha", "where is the delta", "tell me about kappa lambda"]


@pytest.fixture(autouse=True)
def clean_graphs():
    for pw in PACKAGES:
        pw.G.clear()
    yield
    for pw in PACKAGES:
        pw.G.clear()


def final(pw, table) -> list:
    return sorted(progs.canon(r) for r in pw.debug._capture_table(table).final_rows().values())


PROMPTS = ["prompt_short_qa", "prompt_qa", "prompt_qa_geometric_rag", "prompt_summarize", "prompt_query_rewrite_hyde"]


@pytest.mark.parametrize("name", PROMPTS)
def test_prompts_match_jax(name):
    def program(pw):
        fn = getattr(progs.sub(pw, "xpacks.llm.prompts"), name)
        rows = [(q, pw.Json([{"text": f"doc {i}"}, "plain"]), (q, "second")) for i, q in enumerate(QUESTIONS)]
        t = pw.debug.table_from_rows(pw.schema_from_types(q=str, docs=pw.Json, texts=tuple), rows)
        args = (pw.this.texts,) if name == "prompt_summarize" else (pw.this.q,) if "hyde" in name \
            else (pw.this.docs, pw.this.q)
        return final(pw, t.select(p=fn(*args)))

    got = [program(pw) for pw in PACKAGES]
    assert got[0] and got[1] == got[0]


@pytest.mark.parametrize("k", [1, 2, 5])
def test_rerank_topk_filter_matches_jax(k):
    def program(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(docs=tuple, scores=tuple),
                                     [(("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.7)), (("x", "y"), (2.0, -1.0))])
        return final(pw, t.select(top=progs.sub(pw, "xpacks.llm.rerankers").rerank_topk_filter(
            pw.this.docs, pw.this.scores, k)))

    got = [program(pw) for pw in PACKAGES]
    assert got[1] == got[0]


def jit_init(module, model_name, config, seed=0):
    """The JAX encoders' seeded init, jitted (the eager one takes ~10 s on
    the CPU); the port carries whatever weights it makes."""
    ids = jax.numpy.zeros((1, 16), jax.numpy.int32)
    return jax.jit(module.init)(jax.random.PRNGKey(seed), ids, ids + 1), False


def test_cross_encoder_reranker_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "config.json").write_text(json.dumps(SMALL_CE))
    monkeypatch.setitem(sys.modules, "transformers", None)  # hashing tokenizer, seeded weights
    monkeypatch.setattr(jenc_mod, "init_model_params", jit_init)
    rerankers = {pw: progs.sub(pw, "xpacks.llm.rerankers").CrossEncoderReranker(str(tmp_path), **progs.port_kw(pw))
                 for pw in PACKAGES}
    rerankers[tpw]._ce.set_params(jax.device_get(rerankers[jpw]._ce.params))
    rng = np.random.default_rng(progs.SEED)
    pairs = [(" ".join(rng.choice(progs.WORDS, size=int(rng.integers(3, 30)))), q) for q in QUESTIONS * 4]

    def scores(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(doc=str, q=str), pairs)
        rows = pw.debug._capture_table(t.select(pw.this.doc, pw.this.q, s=rerankers[pw](pw.this.doc, pw.this.q)))
        return dict(((d, q), s) for d, q, s in rows.final_rows().values())

    ref, got = scores(jpw), scores(tpw)
    assert ref.keys() == got.keys() and len(ref) == len(pairs)
    ref_v = np.array([ref[p] for p in pairs])
    assert np.abs(np.array([got[p] for p in pairs]) - ref_v).max() <= 0.05 * (np.abs(ref_v).max() + 1.0)


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "static"])
def test_jax_chat_greedy_matches_jax(continuous, monkeypatch):
    from pathway_tpu.models import decoder as jdec
    from pathway_tpu.serving import generation as jgen
    from pathway_tpu_torch.models import decoder as tdec
    from pathway_tpu_torch.serving import generation as tgen

    monkeypatch.setenv("PATHWAY_GENERATE_CONTINUOUS", "1" if continuous else "0")
    monkeypatch.setitem(sys.modules, "transformers", None)  # no checkpoint lookup: hashing tokenizer
    jlm = jdec.shared_decoder("pw-tiny-decoder", max_cache=64, quantize=None)
    tlm = tdec.shared_decoder("pw-tiny-decoder", max_cache=64, quantize=None, device="cpu")
    tlm.params = tdec.from_jax_decoder_params(jax.device_get(jlm.params), tlm.config, "cpu")

    def answers(pw):
        llms = progs.sub(pw, "xpacks.llm.llms")
        chat = llms.JaxChat("pw-tiny-decoder", max_new_tokens=8, max_cache=64, **progs.port_kw(pw))
        t = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(q,) for q in QUESTIONS])
        return final(pw, t.select(pw.this.q, a=chat(llms.prompt_chat_single_qa(pw.this.q))))

    try:
        got = [answers(pw) for pw in PACKAGES]
    finally:
        jgen.reset_shared_schedulers()
        tgen.reset_shared_schedulers()
    assert len(got[0]) == len(QUESTIONS) and got[1] == got[0]


@pytest.fixture(scope="module", autouse=True)
def rag_procs():
    """The ``rag`` program in both packages, started with the file's first
    test so that they boot while the in-process tests run."""
    ports = {pw: rp.free_ports(3) for pw in PACKAGES}
    procs = {pw: rp.spawn(NAMES[pw], "rag", ports[pw]) for pw in PACKAGES}
    try:
        yield ports, procs
    finally:
        rp.stop(procs.values())


@pytest.fixture(scope="module")
def rag_servers(rag_procs):
    ports, procs = rag_procs
    for pw in PACKAGES:
        for port in ports[pw]:
            rp.wait_ready(procs[pw], port, "/v1/statistics", {})
    return ports


ROUTES = {
    "answer": ("/v1/pw_ai_answer", {"prompt": "what is alpha?"}),
    "retrieve": ("/v1/retrieve", {"query": "alpha beta", "k": 2}),
    "statistics": ("/v1/statistics", {}),
    "list": ("/v2/list_documents", {}),
    "summary": ("/v1/pw_ai_summary", {"text_list": ["one text", "another text"]}),
}


@pytest.mark.parametrize("server", ["base", "adaptive"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_rag_routes_match_jax(rag_servers, server, route):
    i = ("base", "adaptive").index(server)
    got = [rp.call(rag_servers[pw][i], *ROUTES[route]) for pw in PACKAGES]
    assert got[0][0] == 200 and got[1] == got[0]


def test_clients_get_jax_answers_from_the_port(rag_servers):
    def ask(client_pw, server_pw):
        base, _adaptive, vs = rag_servers[server_pw]
        rag = progs.sub(client_pw, "xpacks.llm.question_answering").RAGClient(host=rp.HOST, port=base, timeout=20)
        store = progs.sub(client_pw, "xpacks.llm.vector_store").VectorStoreClient(host=rp.HOST, port=vs, timeout=20)
        return [rag.retrieve("alpha beta", k=2), rag.statistics(), rag.pw_ai_answer("what is alpha?"),
                rag.pw_list_documents(), rag.pw_ai_summary(["a", "b"]), store.query("delta", k=3),
                store.get_vectorstore_statistics(), store.get_input_files()]

    ref = ask(jpw, jpw)
    assert all(ref)
    assert ask(tpw, tpw) == ref
    assert ask(jpw, tpw) == ref
