"""Pathway's ``DocumentStore`` as the question-answering templates build
it: ``ParseUtf8`` → ``TokenCountSplitter`` → ``SentenceTransformerEmbedder``
→ ``BruteForceKnnFactory`` (cosine), over a documents table.

``build`` sets the encoder's weights through its ``set_params`` from the
harness's seeded tree and checks that the program serves the shape the
configuration file states.  ``instrument`` puts the benchmark's wrappers
around the store's calls.
"""

from __future__ import annotations

import zlib
from array import array

from portbench import weights

SIZE_KEYS = {  # configuration key -> the program's EncoderConfig field
    "hidden_size": "hidden",
    "num_hidden_layers": "layers",
    "num_attention_heads": "heads",
    "intermediate_size": "intermediate",
    "vocab_size": "vocab_size",
    "max_position_embeddings": "max_len",
}


def build(cfg: dict, docs, seed: int, device, probe) -> dict:
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    kw = {} if device is None else {"device": device}
    embedder = SentenceTransformerEmbedder(cfg["model"], max_batch_size=cfg["embedder_max_batch"], **kw)
    enc = embedder._encoder
    served = {k: getattr(enc.config, f) for k, f in SIZE_KEYS.items()}
    stated = {k: cfg[k] for k in SIZE_KEYS}
    if served != stated or enc.config.pooling != cfg["pooling"]:
        raise ValueError(f"the program serves {served} ({enc.config.pooling}), the configuration states {stated}")
    if enc.pretrained:
        raise ValueError("the program found a checkpoint; the benchmark serves seeded weights")
    tree = weights.bert_tree(cfg, seed, enc.device)
    enc.set_params(weights.to_numpy_f32(tree))
    splitter = TokenCountSplitter(min_tokens=cfg["splitter_min_tokens"], max_tokens=cfg["splitter_max_tokens"])
    store = DocumentStore(docs, BruteForceKnnFactory(embedder=embedder, **kw), parser=ParseUtf8(), splitter=splitter)
    return {"store": store, "embedder": embedder, "encoder": enc, "splitter": splitter, "tree": tree}


def instrument(sys_: dict, probe, trace: bool) -> None:
    """Always: the texts and vectors the encoder was given and gave back,
    a digest of each text's token ids, the documents split, and every
    vector the index took (and every search it answered).  Traced: rows
    and shapes of the forwards, the attention calls, the runner's epochs."""
    from pathway_tpu_torch.engine import dataflow as df
    from pathway_tpu_torch.models import encoder as encoder_mod
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnIndex

    enc, splitter = sys_["encoder"], sys_["splitter"]

    def encode(orig):
        def call(texts, *a, **k):
            with probe.span("encode"):
                out = orig(texts, *a, **k)
            probe.add("encode", list(texts), out)
            return out
        return call

    def tokenize(orig):
        def call(text, *a, **k):
            ids = orig(text, *a, **k)
            probe.add("ids", text, zlib.crc32(array("i", ids).tobytes()), len(ids))
            return ids
        return call

    def chunk(orig):
        def call(text, *a, **k):
            out = orig(text, *a, **k)
            probe.add("split", len(out))
            return out
        return call

    def add(orig):
        def call(index, key, vector, *a, **k):
            probe.add("index_add", id(index), key, vector)
            return orig(index, key, vector, *a, **k)
        return call

    def search_many(orig):
        def call(index, requests):
            with probe.span("search"):
                out = orig(index, requests)
            probe.add("search", id(index), [r[0] for r in requests], [r[1] for r in requests], out)
            return out
        return call

    probe.patch(enc, "encode", encode)
    probe.patch(enc.tokenizer, "encode", tokenize)
    probe.patch(splitter, "chunk", chunk)
    probe.patch(BruteForceKnnIndex, "add", add)
    probe.patch(BruteForceKnnIndex, "search_many", search_many)
    if not trace:
        return

    def run_padded(orig):
        def call(id_lists, *a, **k):
            probe.add("rows", [len(x) for x in id_lists])
            return orig(id_lists, *a, **k)
        return call

    def attention(orig):
        def call(q, k, v, bias, heads):
            probe.add("attention", *q.shape)
            with probe.span("encoder_attention"):
                return orig(q, k, v, bias, heads)
        return call

    def run_epoch(orig):
        def call(scope, time_):
            if scope.parent is not None:
                return orig(scope, time_)
            import time as _t

            t0 = _t.perf_counter()
            try:
                with probe.span("epoch"):
                    return orig(scope, time_)
            finally:
                probe.add("epoch", _t.perf_counter() - t0)
        return call

    def on_forward(_module, args):
        probe.add("forward", int(args[0].shape[0]), int(args[0].shape[1]))

    probe.patch(enc, "_run_padded", run_padded)
    probe.patch_kwdefault(encoder_mod.fused_sentence_apply, "attention", attention)
    probe.patch(df.Scope, "run_epoch", run_epoch)
    handle = enc.model.register_forward_pre_hook(on_forward)
    probe.on_close(handle.remove)
