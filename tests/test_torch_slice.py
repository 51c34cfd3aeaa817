"""The whole slice: texts → sentence encoder → brute-force index → top-k,
through the JAX package and through the port on the CPU, with the JAX
encoder's weights carried across.  A ``config.json`` directory gives both
packages the small shape (2 layers, H=128, 4 heads, ffn 512, vocab 1000).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder  # noqa: E402
from pathway_tpu.stdlib.indexing import nearest_neighbors as jnn  # noqa: E402

import pathway_tpu_torch as pt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "vocab_size": 1000,
    "hidden_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 512,
    "max_position_embeddings": 128,
}
N_CLUSTERS = 60
TRUNCATIONS = (3, 7, 12, 18)  # words cut off the end of a 30-word base text
K = 3


def _corpus(seed=0):
    """300 documents (above the 256-row threshold: the device top-k path)
    in clusters: a 30-word base text and its truncations.  A base text's
    nearest neighbours are then itself and its two mildest truncations, in
    that order, with score gaps (about 1e-2 at this seed) well above the
    bf16 rounding noise between the two packages (below 1e-3).  Unrelated
    texts under random weights often score closer together than that
    noise, and their order would be decided by it."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, size=int(m))) for m in rng.integers(3, 9, size=2000)]
    docs = []
    for _ in range(N_CLUSTERS):
        base = [str(w) for w in rng.choice(words, size=30)]
        docs.append(" ".join(base))
        docs.extend(" ".join(base[: 30 - m]) for m in TRUNCATIONS)
    return docs


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


@pytest.fixture(scope="module")
def encoders(model_dir):
    # no HF checkpoint or tokenizer lookup (the card has no transformers
    # either): both sides use the hashing tokenizer and seeded weights
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    try:
        jenc = JaxEncoder(model_dir)
        tenc = pt.SentenceEncoder(model_dir, device="cpu")
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved
    tenc.set_params(jax.device_get(jenc.params))
    return jenc, tenc


@pytest.fixture(scope="module")
def slice_results(encoders):
    jenc, tenc = encoders
    docs = _corpus()
    bases = np.arange(0, len(docs), 1 + len(TRUNCATIONS))
    queries = [docs[i] for i in bases]
    out = {}
    for name, enc, index in (
        ("jax", jenc, jnn.BruteForceKnnIndex(jnn.DistanceMetric.COS)),
        ("port", tenc, pt.BruteForceKnnIndex(pt.DistanceMetric.COS, device="cpu")),
    ):
        embs = enc.encode(docs)
        for i, vec in enumerate(embs):
            index.add(i, vec)
        q = enc.encode(queries)
        out[name] = (embs, q, index.search_many([(v, K, None) for v in q]))
    return bases, out


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_embeddings_agree(slice_results):
    _, out = slice_results
    (je, jq, _), (te, tq, _) = out["jax"], out["port"]
    assert te.shape == je.shape == (N_CLUSTERS * (1 + len(TRUNCATIONS)), SMALL["hidden_size"])
    assert te.dtype == np.float32
    assert np.isfinite(te).all()
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, atol=1e-5)
    assert _cos_rows(te, je).min() > 0.999
    assert _cos_rows(tq, jq).min() > 0.999


def test_top_k_agrees(slice_results):
    bases, out = slice_results
    jhits, thits = out["jax"][2], out["port"][2]
    for row, (j, t) in enumerate(zip(jhits, thits)):
        assert [key for key, _ in t] == [key for key, _ in j], row
        np.testing.assert_allclose([s for _, s in t], [s for _, s in j], atol=1e-3, rtol=0)
    # each base text finds itself, then its two mildest truncations
    for base, hits in zip(bases, thits):
        assert [key for key, _ in hits] == [base, base + 1, base + 2]


def test_encoder_surface(encoders):
    _, tenc = encoders
    assert tenc.dimensions == SMALL["hidden_size"]
    one = tenc.encode_one("streaming dataflow")
    np.testing.assert_allclose(one, tenc.encode(["streaming dataflow"])[0], atol=1e-6)
    assert tenc.encode([]).shape == (0,)
    before = tenc.forward_batches
    tenc.encode(["x"] * 3)
    assert tenc.forward_batches == before + 1


def test_device_default_raises_without_cuda(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.SentenceEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.BruteForceKnnIndex(pt.DistanceMetric.COS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DecoderLM("pw-tiny-decoder")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DecoderLM("pw-tiny-moe-decoder", quantize="int8")
    assert pt.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_nothing_of_jax(model_dir):
    """In a fresh interpreter that cannot import jax, flax, pathway_tpu (or
    transformers, which the card lacks), the port imports and runs the
    embed-and-retrieve slice, reranking with the cross-encoder, W8A8
    embeddings, the generation path, an int8 MoE decoder,
    self-speculative decoding, a LoRA-adapted MoE decoder, the
    multimodal encoder, the encoder behind ``AsyncMicroBatcher`` and
    ``DeviceExecutor.submit``, and a step of each training path (the
    contrastive step, causal-LM, LoRA and MoE) with a checkpoint saved and
    restored, and the multi-device layer (``parallel/mesh.py``,
    ``sharding.py``, ``index.py``, ``ring_attention.py`` and
    ``models/long_context.py``) on a one-rank gloo mesh made on demand, on
    the CPU, then ``dryrun_multichip(1)`` (tensor, pipeline, expert and
    data×tensor parallelism) and a mesh LoRA state saved through
    ``torch.distributed.checkpoint``; then the Table API (the dataflow,
    the table, the runner, ``debug`` and the native core) runs a
    three-row ``groupby`` through ``pw.run``; then the connectors, the
    indexes and the LLM xpack's retrieval half answer a query of a
    ``VectorStoreServer`` over ``SentenceTransformerEmbedder`` fed by
    ``pw.io.fs.read``, and a hybrid BM25 + HNSW ``DocumentStore`` answers
    it too; then the stdlib's small modules import and ``Table.diff``
    runs, and a sliding ``windowby``, ``pw.graphs.pagerank``,
    ``pw.viz``'s ``show`` and a ``pw.demo.range_stream`` run in one
    ``pw.run``; last, the multi-worker layer (``comm``, ``supervisor``,
    ``standby``, ``autoscaler``, ``telemetry``, ``__main__``) imports and a
    supervised 2-worker cluster of forked children, which inherit the
    block, recovers from a seeded crash; and the observability layer
    (``http_server``, ``probes``, ``profiler``, ``slo``, ``top``,
    ``monitoring``, ``license``) serves ``/metrics`` and ``/status`` during
    a ``pw.run(with_http_server=True, monitoring_level=ALL)``; and the
    message streams and object stores: a ``pw.io.kafka.read`` over the
    in-process broker persisted through ``Backend.s3`` to the SigV4
    endpoint, and its resume; and the sinks and lakes (every ``pw.io``
    module and the SharePoint xpack import): a ``pw.io.sqlite.read`` into
    ``pw.io.postgres.write_snapshot`` over SCRAM to the fake Postgres; and
    the rest of the Table API: ``pw.sql`` over the same SQLite table,
    ``export_table``, ``import_table`` and ``Table.live()``, ``pw.load_yaml``
    (PyYAML is imported only then), ``pw.transformer``'s module, and the
    ``lint`` analyzer over its own package."""
    script = textwrap.dedent(
        f"""
        import importlib.abc, sys

        BLOCKED = ("jax", "jaxlib", "flax", "pathway_tpu", "transformers")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import pathway_tpu_torch as pt

        enc = pt.SentenceEncoder({model_dir!r}, device="cpu")
        index = pt.BruteForceKnnIndex(pt.DistanceMetric.COS, device="cpu")
        texts = [f"document {{i}} about topic {{i % 13}} and {{i * 7}}" for i in range(260)]
        for i, vec in enumerate(enc.encode(texts)):
            index.add(i, vec)
        hits = index.search(enc.encode_one(texts[17]), 3)
        assert hits[0][0] == 17, hits

        ce = pt.CrossEncoder({model_dir!r}, device="cpu")
        assert not ce.pretrained
        scores = ce.score([(texts[17], texts[key]) for key, _ in hits])
        assert scores.shape == (3,) and np.isfinite(scores).all(), scores
        w8a8 = pt.SentenceEncoder({model_dir!r}, quantize="int8", device="cpu")
        a, b = w8a8.encode(texts[:8]), enc.encode(texts[:8])
        assert (a * b).sum(axis=1).min() > 0.99

        lm = pt.DecoderLM("pw-tiny-decoder", max_cache=64, device="cpu")
        sched = pt.GenerationScheduler(lm, slots=2)
        fut = sched.submit_ids([5, 9, 17], max_new_tokens=4)
        assert fut.result(timeout=60) == lm.generate_ids([[5, 9, 17]], max_new_tokens=4)[0]
        sched.shutdown()
        moe = pt.DecoderLM("pw-tiny-moe-decoder", max_cache=64, quantize="int8", device="cpu")
        assert isinstance(moe.params["layers"]["wg"], dict) and not moe.pretrained
        assert len(moe.generate_ids([[5, 9, 17]], max_new_tokens=4)[0]) <= 4
        moe_f = pt.DecoderLM("pw-tiny-moe-decoder", max_cache=64, eos_id=None, device="cpu")
        assert moe_f.generate_ids_speculative([[5, 9, 17]], max_new_tokens=6, n_draft=3) == \
            moe_f.generate_ids([[5, 9, 17]], max_new_tokens=6)
        from pathway_tpu_torch.models import lora, vision

        base_rows = moe_f.generate_ids([[5, 9, 17]], max_new_tokens=4)
        moe_f.params = lora.lora_decoder_tree(moe_f.params, moe_f.config, rank=2)
        assert moe_f.generate_ids([[5, 9, 17]], max_new_tokens=4) == base_rows
        mm = pt.MultimodalEncoder("pw-tiny-siglip", device="cpu")
        imgs = np.random.default_rng(0).integers(0, 256, size=(3, 40, 40, 3)).astype(np.uint8)
        scores = mm.score(imgs, ["a photo", "a report"])
        assert scores.shape == (3, 2) and np.isfinite(scores).all(), scores
        assert vision.shared_multimodal_encoder("pw-tiny-siglip", device="cpu").dimensions == 32
        import torch
        from torch.distributed.tensor import Shard
        from pathway_tpu_torch.models.long_context import LongContextSentenceEncoder
        from pathway_tpu_torch.parallel import (ShardedDeviceIndex, make_mesh, put_global,
            ring_encoder_attention, shard_params)

        mesh = make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        sharded = pt.BruteForceKnnIndex(pt.DistanceMetric.COS, mesh=mesh)
        for i, vec in enumerate(enc.encode(texts[:40])):
            sharded.add(i, vec)
        assert sharded.search(enc.encode_one(texts[17]), 3)[0][0] == 17
        six = ShardedDeviceIndex(mesh, enc.dimensions, block=16)
        six.add(enc.encode(texts[:40]))
        assert six.search(enc.encode(texts[17:18]), 1)[0][0, 0] == 17
        assert put_global(np.ones((4, 2), np.float32), mesh, (Shard(0), Shard(0))).shape == (4, 2)
        assert shard_params({{"Embed_0": {{"embedding": np.ones((8, 4), np.float32)}}}}, mesh)
        q = torch.randn(1, 32, 16)
        ctx = ring_encoder_attention(mesh, q, q, q, torch.zeros(1, 32), 2)
        assert ctx.shape == (1, 32, 16) and torch.isfinite(ctx).all()
        lce = LongContextSentenceEncoder({model_dir!r}, mesh)
        lce.set_params(enc.params)
        assert (lce.encode(texts[:4]) * enc.encode(texts[:4])).sum(axis=1).min() > 0.99
        torch.distributed.destroy_process_group()
        import asyncio
        from pathway_tpu_torch.device import get_default_executor
        from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

        ex = get_default_executor("cpu")
        batcher = AsyncMicroBatcher(enc.encode, max_batch_size=8, executor=ex)

        async def embed():
            return await asyncio.gather(*(batcher.submit(t) for t in texts[:20]))

        rows = np.stack(asyncio.run(embed()))
        assert (rows * enc.encode(texts[:20])).sum(axis=1).min() > 0.999
        import os, tempfile
        from pathway_tpu_torch.xpacks.llm import VectorStoreServer, embedders, mocks, parsers, splitters  # noqa: F401
        from pathway_tpu_torch.stdlib.indexing import BruteForceKnn, DataIndex, LshKnn  # noqa: F401

        docs_dir = tempfile.mkdtemp()
        for i in range(6):
            with open(os.path.join(docs_dir, f"d{{i}}.txt"), "w") as f:
                f.write(texts[i])
        docs = pt.io.fs.read(docs_dir, format="binary", mode="static", with_metadata=True)
        emb = embedders.SentenceTransformerEmbedder({model_dir!r}, device="cpu")
        server = VectorStoreServer(docs, embedder=emb, device="cpu")
        queries = pt.debug.table_from_rows(server.RetrieveQuerySchema, [(texts[3], 2, None, None)])
        answers = []
        pt.io.subscribe(server.retrieve_query(queries), on_change=lambda key, row, time, is_addition: answers.append(row))
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        assert answers[-1]["result"].value[0]["text"] == texts[3], answers
        pt.G.clear()
        from pathway_tpu_torch.stdlib.indexing import (HybridIndexFactory, TantivyBM25Factory,
            UsearchKnnFactory, default_full_text_document_index, default_vector_document_index)  # noqa: F401
        from pathway_tpu_torch.stdlib.indexing.hnsw import NativeHnswIndex
        from pathway_tpu_torch.xpacks.llm import DocumentStore

        docs = pt.io.fs.read(docs_dir, format="binary", mode="static", with_metadata=True)
        store = DocumentStore(docs, HybridIndexFactory(retriever_factories=[UsearchKnnFactory(embedder=emb),
                                                                            TantivyBM25Factory()]))
        answers = []
        pt.io.subscribe(store.retrieve_query(queries), on_change=lambda key, row, time, is_addition: answers.append(row))
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        assert answers[-1]["result"].value[0]["text"] == texts[3], answers
        assert NativeHnswIndex().search(np.ones(3, np.float32), 1) == []
        pt.G.clear()
        from pathway_tpu_torch import ml, ordered, stateful, statistical  # noqa: F401
        from pathway_tpu_torch.stdlib.ml import classifiers, hmm, index, smart_table_ops  # noqa: F401
        from pathway_tpu_torch.stdlib.utils import async_transformer, col, filtering, pandas_transformer  # noqa: F401

        t = pt.debug.table_from_markdown("t | v\\n1 | 10\\n2 | 13")
        diffs = []
        t.diff(pt.this.t, pt.this.v)._subscribe_raw(lambda key, row, time, diff: diffs.append(row[-1]))
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        assert sorted(diffs, key=str) == [3, None], diffs
        pt.G.clear()
        from pathway_tpu_torch import demo, graphs, temporal, viz  # noqa: F401

        win = t.windowby(pt.this.t, window=temporal.sliding(hop=1, duration=2)).reduce(n=pt.reducers.count())
        e = pt.debug.table_from_markdown("u | v\\n1 | 2\\n2 | 1")
        ranks = graphs.pagerank(e.select(u=e.pointer_from(pt.this.u), v=e.pointer_from(pt.this.v)), steps=3)
        shown, stream = win.show(), demo.range_stream(nb_rows=3, input_rate=1e4, autocommit_duration_ms=5)
        seen = []
        stream._subscribe_raw(lambda key, row, time, diff: seen.append(row[0]))
        ranks._subscribe_raw(lambda key, row, time, diff: None)
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        assert sorted(r[0] for r in shown.rows.values()) == [1, 1, 2] and seen == [0.0, 1.0, 2.0], (shown.rows, seen)
        pt.G.clear()
        from pathway_tpu_torch import cli, persistence
        from pathway_tpu_torch.engine import persistence as pz

        proot = tempfile.mkdtemp()
        cfg = persistence.Config(persistence.Backend.filesystem(proot),
                                 persistence_mode=pt.PersistenceMode.OPERATOR_PERSISTING)
        totals = []
        for _ in range(2):
            s = t.reduce(total=pt.reducers.sum(pt.this.v))
            s._subscribe_raw(lambda key, row, time, diff: totals.append((row[0], diff)))
            pt.run(persistence_config=cfg, monitoring_level=pt.MonitoringLevel.NONE)
            pt.G.clear()
        assert totals == [(23, 1)], totals  # the resumed run re-emits nothing
        assert pz.scrub_root(pz.FileBackend(proot))["ok"] and cli.main(["scrub", proot]) == 0
        fut = ex.submit(lambda: enc.encode(texts[:3]), name="direct")
        assert fut.result(timeout=60).shape == (3, enc.dimensions)
        ex.close()
        assert ex.metrics_snapshot()["backlog.device.queue"] == 0.0

        import functools, tempfile
        import torch
        from pathway_tpu_torch.models import decoder, encoder
        from pathway_tpu_torch.parallel import (TrainCheckpointer, init_train_state,
            make_causal_lm_train_step, make_contrastive_train_step, make_moe_train_step, MoEConfig)

        adam = functools.partial(torch.optim.Adam, lr=1e-3)
        ecfg = encoder.EncoderConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32,
                                     max_len=16, dtype=torch.float32)
        module = encoder.SentenceEncoderModule(ecfg, encoder.init_params(ecfg, 0), device="cpu")
        state, _ = init_train_state(module, adam, device="cpu")
        ids = np.random.default_rng(0).integers(1, 64, size=(4, 8))
        state, loss = make_contrastive_train_step(module, device="cpu")(state, ids, ids > 0, ids, ids > 0)
        assert np.isfinite(float(loss)) and state.step == 1
        dcfg = decoder.decoder_config_for("pw-tiny-decoder")
        init_lm, run_lm = make_causal_lm_train_step(dcfg, adam, device="cpu")
        lm_state, lm_loss = run_lm(init_lm(0), ids, np.full(4, 8))
        init_lora, run_lora = lora.make_lora_train_step(dcfg, lm_state.params, adam, device="cpu", rank=2)
        lo_state, lo_loss = run_lora(init_lora(), ids, np.full(4, 8))
        init_moe, step_moe = make_moe_train_step(MoEConfig(hidden=8, experts=4, intermediate=16), adam,
                                                 device="cpu")
        x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
        params, opt, moe_loss = step_moe(*init_moe(0), x, np.tanh(x))
        assert all(np.isfinite(float(v)) for v in (lm_loss, lo_loss, moe_loss))
        with tempfile.TemporaryDirectory() as tmp, TrainCheckpointer(tmp) as ck:
            ck.save(lo_state)
            assert ck.restore(init_lora()).step == 1
        from pathway_tpu_torch.parallel import collectives, dryrun, pipeline  # noqa: F401
        from pathway_tpu_torch.parallel import dryrun_multichip

        dryrun_multichip(1, device="cpu")  # tp, pp, ep, dp×tp and the index on a one-rank group
        mesh = make_mesh(device="cpu")
        init_ml, run_ml = lora.make_lora_train_step(dcfg, lm_state.params, adam, mesh=mesh, rank=2)
        ml_state, ml_loss = run_ml(init_ml(), ids, np.full(4, 8))
        with tempfile.TemporaryDirectory() as tmp, TrainCheckpointer(tmp) as ck:
            ck.save(ml_state)  # through torch.distributed.checkpoint
            assert ck.restore(init_ml()).step == 1
        torch.distributed.destroy_process_group()
        import pathway_tpu_torch.debug, pathway_tpu_torch.engine.dataflow  # noqa: E401
        import pathway_tpu_torch.internals.runner, pathway_tpu_torch.internals.table  # noqa: E401
        from pathway_tpu_torch import native

        assert native.get() is not None
        t = pt.debug.table_from_markdown("g | v\\na | 1\\nb | 2\\na | 3")
        got = []
        t.groupby(pt.this.g).reduce(g=pt.this.g, s=pt.reducers.sum(pt.this.v))._subscribe_raw(
            lambda key, row, time, diff: got.append((row, diff)))
        assert pt.run(monitoring_level=pt.MonitoringLevel.NONE).epochs == 1
        assert sorted(got) == [(("a", 4), 1), (("b", 2), 1)], got
        import json
        from pathway_tpu_torch import __main__  # noqa: F401
        from pathway_tpu_torch.engine import autoscaler, comm, standby, supervisor, telemetry  # noqa: F401
        from tests import torch_cluster_programs as cluster

        croot = tempfile.mkdtemp()
        plan = json.dumps({{"seed": 7, "faults": [{{"kind": "crash", "worker": 1, "at_epoch": 3, "attempt": 0}}]}})
        res = cluster.run_supervised("pathway_tpu_torch", croot, plan)
        assert res.restarts == 1 and res.exit_codes == [0, 0], res.history
        assert cluster.counts_of(cluster.canonical_bytes(croot)) == cluster.EXPECTED_COUNTS

        import threading, time, urllib.request  # noqa: E401
        from pathway_tpu_torch.engine import http_server, probes, profiler, slo  # noqa: F401
        from pathway_tpu_torch.internals import license, monitoring, top  # noqa: F401

        port, scraped, go = cluster.free_port_base(1), {{}}, threading.Event()

        class Feed(pt.io.python.ConnectorSubject):
            def run(self):
                self.next(g="a", v=1)
                self.commit()
                go.wait(60)  # the second row waits for the scrapes
                self.next(g="b", v=2)
                self.commit()

        def scrape():
            base = f"http://127.0.0.1:{{port}}"
            for _ in range(1200):
                try:
                    status = json.loads(urllib.request.urlopen(base + "/status", timeout=2).read())
                    if status["output"]["rows_in"]:
                        scraped["status"] = status
                        scraped["metrics"] = urllib.request.urlopen(base + "/metrics", timeout=2).read().decode()
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            go.set()

        served = []
        feed = pt.io.python.read(Feed(), schema=pt.schema_from_types(g=str, v=int), name="feed")
        feed.groupby(pt.this.g).reduce(g=pt.this.g, s=pt.reducers.sum(pt.this.v))._subscribe_raw(
            lambda key, row, time, diff: served.append((row, diff)))
        threading.Thread(target=scrape, daemon=True).start()
        with pt.local_pathway_config(monitoring_http_port=port):
            pt.run(with_http_server=True, monitoring_level=pt.MonitoringLevel.ALL)
        pt.G.clear()
        assert sorted(served) == [(("a", 1), 1), (("b", 2), 1)], served
        metrics_body, status = scraped["metrics"], scraped["status"]
        assert metrics_body.endswith("# EOF\\n") and "pathway_epoch_duration_ms_count" in metrics_body
        assert "pathway_freshness_e2e_ms_count" in metrics_body
        assert status["epochs"] >= 1 and {{"freshness", "backlog", "device", "slo"}} <= set(status), status
        from pathway_tpu_torch.io import kafka as kafka_mod
        from tests.torch_fake_services import KafkaBroker, S3Server, until_drained

        broker, s3 = KafkaBroker(finite=True), S3Server()
        broker.create_topic("words", 2)
        kafka_mod._get_client = broker.get_client
        kafka_mod._KafkaReader.run = until_drained(kafka_mod._KafkaReader.run)
        bucket = pt.io.s3.AwsS3Settings(access_key=s3.access_key, secret_access_key=s3.secret_key,
                                        endpoint=s3.endpoint, with_path_style=True)
        persisted = pt.persistence.Config(pt.persistence.Backend.s3("s3://pathway/run", bucket))

        def word_counts(messages):
            for key, w in messages:
                broker.produce("words", w.encode(), key=str(key).encode())
            net = {{}}
            t = pt.io.kafka.read({{"bootstrap.servers": "x", "group.id": "g", "auto.offset.reset": "earliest"}},
                                 "words", format="plaintext", autocommit_duration_ms=20, name="words")
            t.groupby(pt.this.data).reduce(w=pt.this.data, n=pt.reducers.count())._subscribe_raw(
                lambda key, row, time, diff: net.__setitem__(row, net.get(row, 0) + diff))
            pt.run(monitoring_level=pt.MonitoringLevel.NONE, persistence_config=persisted)
            pt.G.clear()
            return sorted(r for r, n in net.items() if n)

        assert word_counts([(0, "a"), (1, "b"), (2, "a"), (3, "b")]) == [("a", 2), ("b", 2)]
        # resumed from the bucket: key 1 is replaced by its new message
        assert word_counts([(4, "a"), (1, "c")]) == [("a", 3), ("b", 1), ("c", 1)]
        assert s3.stats()["requests"]["PUT"] and not s3.stats()["rejected"]
        s3.close()
        import sqlite3
        from pathway_tpu_torch.xpacks.connectors import sharepoint  # noqa: F401
        from tests.torch_fake_services import PgServer

        db, pg = os.path.join({str(model_dir)!r}, "logs.db"), PgServer(user="u", password="p")
        with sqlite3.connect(db) as conn:
            conn.execute("CREATE TABLE IF NOT EXISTS t (g TEXT)")
            conn.executemany("INSERT INTO t VALUES (?)", [("a",), ("b",), ("a",)])
        logs = pt.io.sqlite.read(db, "t", pt.schema_from_types(g=str), mode="static")
        pt.io.postgres.write_snapshot(logs.groupby(pt.this.g).reduce(pt.this.g, n=pt.reducers.count()),
                                      {{"host": "127.0.0.1", "port": pg.port, "user": "u", "password": "p"}},
                                      "counts", ["g"], init_mode="create_if_not_exists")
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        pt.G.clear()
        assert pg.rows("counts") == [("a", 2), ("b", 1)] and not pg.stats()["rejected"], pg.rows("counts")
        from pathway_tpu_torch import analysis
        from pathway_tpu_torch.internals import export_import, interactive, row_transformer, sql, yaml_loader

        assert "yaml" not in sys.modules  # PyYAML is imported by load_yaml, not by the package
        counted = pt.sql("SELECT g, COUNT(*) AS n FROM logs GROUP BY g HAVING COUNT(*) >= 2",
                         logs=pt.io.sqlite.read(db, "t", pt.schema_from_types(g=str), mode="static"))
        exported = export_import.export_table(counted)
        pt.run(monitoring_level=pt.MonitoringLevel.NONE)
        pt.G.clear()
        assert [row for _k, row, _t, _d in exported.data_from_offset(0)[0]] == [("a", 2)]
        live = pt.import_table(exported).live()
        assert live.wait_for(30).snapshot().data[0][1] == ("a", 2) and isinstance(live, interactive.LiveTable)
        assert yaml_loader.load_yaml("n: !pw.reducers.count") and row_transformer.ClassArg and sql.SqlError
        report = analysis.run_lint([os.path.join({REPO!r}, "pathway_tpu_torch", "analysis")])
        assert report.ok and report.files == 8, analysis.report_to_text(report)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env, cwd=REPO
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
