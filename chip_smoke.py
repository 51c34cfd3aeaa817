#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--docs N] [--seed S]

Phases, each on a line of its own; any failure exits non-zero:

1. card: name and power limit (nvidia-smi), torch and CUDA versions, the
   TF32 flags (set off explicitly);
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the reference shapes, the main path's and the kernel's edge
   shapes, plus the masking and independence pins; device-only times of
   kernel, plain version and the PyTorch library call at every main-path
   shape (CUDA graphs of many launches, inputs rotated past the L2 cache),
   and the wrapper's host time per call;
4. main path at full all-MiniLM-L6-v2 width (seeded random weights):
   encode a synthetic corpus (262,144 texts by default) in length-sorted
   batches, time one arrival-order pass over a part of it, fill a cosine
   ``BruteForceKnnIndex`` with it, answer one untimed warm-up and 128 timed
   ``search_many`` batches of 64 re-encoded corpus texts at k=10, and check
   the answers; the kernels' launch counts are zeroed just before and read
   just after, every attention shape the run gave the kernel is held
   against the plain version, and the launches are counted per shape.

Then one JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  It imports nothing of JAX or of ``pathway_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense
ATTN_TOL = 0.05  # the JAX package's own kernel-vs-XLA pin (bf16 probabilities)
PIN_TOL = 1e-3  # masked keys and other sequences must not move the output
SCORE_TOL = 1e-2  # bf16-stored index vs f32 scores of the same vectors
COS_MIN = 0.999


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls between
    two CUDA events: host enqueue time included, for work far longer than
    its launch (a whole forward)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(calls, reps: int = 40, replays: int = 5) -> float:
    """Device-only ms per call: ``reps`` calls, cycling through ``calls``
    (one per input copy), captured in one CUDA graph and replayed after a
    warm-up; the median of ``replays`` replays between CUDA events."""
    for call in calls:  # warm-up outside the capture: builds, loads, configures
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` (argument checks, allocation, launch),
    from the host clock around ``calls`` calls that do not wait for the
    device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# ---------------------------------------------------------------------------
# Phase 3: encoder-attention kernel against its plain version.
# ---------------------------------------------------------------------------

REFERENCE_SHAPES = [  # tests/test_attention_kernel.py's shapes
    (4, 64, 384, 12),
    (2, 128, 768, 12),
    (8, 16, 384, 12),
    (1, 256, 1024, 16),
    (3, 64, 384, 12),
]
MAIN_SHAPE = (512, 64, 384, 12)  # all-MiniLM-L6-v2 at max_batch 512, seq bucket 64
EXTRA_SHAPES = [
    (512, 16, 384, 12),  # the main path's corpus batches at seq buckets 16 and 32
    (512, 32, 384, 12),
    (64, 16, 384, 12),  # its 64-query batches
    (64, 32, 384, 12),
    (64, 64, 384, 12),
    (16, 512, 384, 12),  # the largest seq bucket
    (2, 128, 1024, 8),  # hd=128, the widest head the kernel takes
]
EDGE_SHAPES = [  # the edges of the kernel's work plan
    (4, 1, 384, 12),  # S=1: one real row in a 16-row tile
    (8, 24, 384, 12),  # S not a multiple of 16: two sequences of 32 rows per item
    (3, 48, 256, 8),  # 48 rows per item, hd=32, two head groups
    (3, 100, 384, 12),  # S > 64 and not a multiple of 64: a short last key chunk
    (1, 64, 384, 12),  # B=1
    (1, 16, 384, 12),  # B=1 where an item packs four sequences
    (513, 16, 384, 12),  # B not a multiple of the sequences per item
    (5, 64, 96, 3),  # H not a multiple of 128: one 96-column group
    (8, 32, 768, 12),  # hd=64, packed
    (6, 16, 1024, 8),  # hd=128, packed
]
TIMED_SHAPES = [  # the main path's attention shapes (PERF.md section 5)
    (512, 16, 384, 12),
    (512, 32, 384, 12),
    (512, 64, 384, 12),
    (64, 64, 384, 12),
]
L2_BYTES = 50 * 2**20  # H100


def fused_qkv(gen, B, S, H, device):
    """q, k, v as column views of one ``[B*S, 3H]`` tensor (row stride 3H),
    as the trunk's fused QKV projection leaves them."""
    qkv = torch.randn((B * S, 3 * H), generator=gen, device=device).to(torch.bfloat16)
    return tuple(qkv[:, i * H : (i + 1) * H].reshape(B, S, H) for i in range(3))


def padded_mask(B, S, device):
    mask = torch.zeros((B, S), device=device)
    mask[:, int(S * 0.8) :] = -1e9  # padded tail keys
    if B > 1:
        mask[-1, :] = -1e9  # an all-padding row, as the executor's batch padding makes
    return mask


def check_attention_shape(gen, shape, device) -> float:
    """Kernel against the plain version at ``shape`` = (B, S, H, heads), with
    q, k, v contiguous and as views of a fused QKV tensor, padded tail keys
    and an all-padding row; returns the larger max abs err of the two."""
    from pathway_tpu_torch.ops.attention import (
        encoder_attention,
        encoder_attention_reference,
    )

    B, S, H, heads = shape
    worst = 0.0
    for layout in ("contiguous", "fused_qkv"):
        q, k, v = fused_qkv(gen, B, S, H, device)
        if layout == "contiguous":
            q, k, v = (t.contiguous() for t in (q, k, v))
        mask = padded_mask(B, S, device)
        out = encoder_attention(q, k, v, mask, heads)
        ref = encoder_attention_reference(q, k, v, mask, heads)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"attention {shape} {layout}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log("kernels", shape=list(shape), layout=layout, max_abs_err=err)
        if err >= ATTN_TOL:
            fail(f"attention {shape} {layout}: max abs err {err}")
        worst = max(worst, err)
    return worst


def time_attention_shape(gen, shape, device) -> dict:
    """Device-only ms of kernel, plain version and ``scaled_dot_product_attention``
    at ``shape``, on q, k, v as views of fused QKV tensors, with enough
    input copies in rotation to exceed the L2 cache; the bound from the
    shape; and the wrapper's host µs per call."""
    from pathway_tpu_torch.ops.attention import (
        encoder_attention,
        encoder_attention_reference,
    )

    B, S, H, heads = shape
    hd = H // heads
    operand_bytes = 4 * B * S * H * 2 + B * S * 4  # q, k, v read; ctx written; bias read
    copies = max(2, -(-2 * L2_BYTES // operand_bytes))
    inputs = [(*fused_qkv(gen, B, S, H, device), padded_mask(B, S, device)) for _ in range(copies)]
    sdpa_inputs = [
        (*(t.reshape(B, S, heads, hd).transpose(1, 2) for t in (q, k, v)),
         mask.to(torch.bfloat16)[:, None, None, :])
        for q, k, v, mask in inputs
    ]
    kernel = [lambda x=x: encoder_attention(*x, heads) for x in inputs]
    plain = [lambda x=x: encoder_attention_reference(*x, heads) for x in inputs]
    library = [
        lambda x=x: torch.nn.functional.scaled_dot_product_attention(x[0], x[1], x[2], attn_mask=x[3])
        for x in sdpa_inputs
    ]
    t_bytes = operand_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * S * S * H / BF16_FLOPS_PER_S * 1e3
    row = {
        "shape": list(shape),
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "input_copies": copies,
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log("kernels", timed=list(shape), **{k: v for k, v in row.items() if k != "shape"})
    us = host_us(kernel[0])
    log("kernels", shape=list(shape), wrapper_host_us_per_call=us)
    row["host_us"] = us
    return row


def attention_phase(device) -> tuple[dict, dict, dict]:
    """The kernel line's entry for encoder attention, the max abs err at
    each shape checked, and the times at each main-path shape."""
    from pathway_tpu_torch.ops.attention import encoder_attention

    gen = torch.Generator(device=device).manual_seed(0)
    checked = {}
    for shape in REFERENCE_SHAPES + [MAIN_SHAPE] + EXTRA_SHAPES + EDGE_SHAPES:
        checked[shape] = check_attention_shape(gen, shape, device)
    worst = max(checked.values())

    # a masked key must not influence any query's context
    B, S, H, heads = 2, 64, 384, 12
    q, k, v = fused_qkv(gen, B, S, H, device)
    mask = torch.zeros((B, S), device=device)
    mask[:, 32:] = -1e9
    out1 = encoder_attention(q, k, v, mask, heads)
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:, :] = 99.0
    v2[:, 32:, :] = -99.0
    out2 = encoder_attention(q, k2, v2, mask, heads)
    pin = (out1.float() - out2.float()).abs().max().item()
    log("kernels", pin="masked_keys", max_abs_diff=pin)
    if pin >= PIN_TOL:
        fail(f"masked keys moved the output by {pin}")

    # a sequence's output does not depend on the other sequences of the batch
    B, S, H, heads = 8, 16, 384, 12
    q, k, v = fused_qkv(gen, B, S, H, device)
    mask = torch.zeros((B, S), device=device)
    full = encoder_attention(q, k, v, mask, heads)
    solo = encoder_attention(q[:1], k[:1], v[:1], mask[:1], heads)
    pin = (full[0].float() - solo[0].float()).abs().max().item()
    log("kernels", pin="cross_sequence", max_abs_diff=pin)
    if pin >= PIN_TOL:
        fail(f"sequences leak into each other: {pin}")

    timed = {shape: time_attention_shape(gen, shape, device) for shape in TIMED_SHAPES}
    main = timed[MAIN_SHAPE]
    return {
        "name": "encoder_attention",
        "route": "cuda",
        "source": "pathway_tpu_torch/ops/csrc/encoder_attention.cu",
        "replaces": "pathway_tpu/ops/attention.py:259",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": list(MAIN_SHAPE),
    }, checked, timed


# ---------------------------------------------------------------------------
# Phase 4: the embed-and-retrieve main path.
# ---------------------------------------------------------------------------


def synthetic_corpus(n: int, seed: int) -> tuple[list[str], np.ndarray]:
    """``n`` texts of 6-60 words over a 20,000-word synthetic vocabulary."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    word_lens = rng.integers(3, 10, size=20000)
    vocab = ["".join(rng.choice(letters, size=int(n_))) for n_ in word_lens]
    lengths = rng.integers(6, 61, size=n)
    words = rng.integers(0, len(vocab), size=int(lengths.sum()))
    texts, at = [], 0
    for length in lengths:
        texts.append(" ".join(vocab[w] for w in words[at : at + length]))
        at += length
    return texts, lengths


def main_path(device, docs: int, seed: int, checked: dict, model: str = "all-MiniLM-L6-v2",
              query_batches: int = 128, batch_queries: int = 64, k: int = 10,
              arrival_docs: int = 65536) -> dict:
    """Drive the main path; ``checked`` maps each attention shape that phase 3
    held against the plain version to its max abs err, and gains the shapes
    this run gave the kernel that phase 3 had not checked.  Returns the
    launches per kernel and, for attention, per shape."""
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.models.encoder import fused_sentence_apply
    from pathway_tpu_torch.models.tokenizer import bucket_seq_len, pad_batch
    from pathway_tpu_torch.ops.attention import (
        encoder_attention,
        encoder_attention_reference,
    )

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    texts, lengths = synthetic_corpus(docs, seed)
    log("main", step="corpus", docs=docs, seconds=time.perf_counter() - t0)

    # the encoder and the index run on the card by default; the keyword is
    # passed only where a CPU rehearsal asks for the host
    kw = {} if on_card else {"device": device}
    enc = pt.SentenceEncoder(model, seed=seed, **kw)
    index = pt.BruteForceKnnIndex(pt.DistanceMetric.COS, **kw)
    order = np.argsort(lengths, kind="stable")  # length-sorted batches: buckets 16/32/64
    arrival = min(arrival_docs, docs)
    query_batches = min(query_batches, docs // batch_queries - 1)
    rng = np.random.default_rng(seed + 1)
    picks = rng.choice(docs, size=(query_batches + 1, batch_queries), replace=False)
    cfg = enc.config
    # forwards per (batch, seq) shape, hence the attention launches per shape
    seen: dict[tuple, int] = {}

    def count_forward(_module, args):
        shape = (*args[0].shape, cfg.hidden, cfg.heads)
        seen[shape] = seen.get(shape, 0) + 1

    enc.model.register_forward_pre_hook(count_forward)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts zeroed just before, read just after ----
    encoder_attention.launches = 0
    forwards_before = enc.forward_batches
    embs = np.empty((docs, enc.dimensions), np.float32)
    sync()
    t0 = time.perf_counter()
    for start in range(0, docs, enc.max_batch):
        ids = order[start : start + enc.max_batch]
        embs[ids] = enc.encode([texts[i] for i in ids])
    sync()
    encode_s = time.perf_counter() - t0
    # a stream encodes texts as they arrive: nearly every batch pads to the
    # longest seq bucket
    t0 = time.perf_counter()
    arrival_embs = np.concatenate([
        enc.encode(texts[start : min(start + enc.max_batch, arrival)])
        for start in range(0, arrival, enc.max_batch)
    ])
    sync()
    arrival_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(docs):
        index.add(i, embs[i])
    index.search(embs[0], k)  # builds and uploads the device index
    sync()
    index_s = time.perf_counter() - t0
    latencies, answers, queries = [], [], []
    for n, batch in enumerate(picks):
        t0 = time.perf_counter()
        q = enc.encode([texts[i] for i in batch])
        res = index.search_many([(q[j], k, None) for j in range(len(batch))])
        if n:  # the first batch warms up and is not timed
            latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append(res)
        queries.append(q)
    launches = {"encoder_attention": encoder_attention.launches}
    forwards = enc.forward_batches - forwards_before
    shape_forwards = dict(seen)
    # ---- end of the counted run ----

    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    buckets = {}
    for n in lengths:
        b = bucket_seq_len(int(n) + 2)
        buckets[b] = buckets.get(b, 0) + 1
    log("main", step="encode", order="length-sorted", docs=docs, seconds=encode_s,
        emb_per_s=docs / encode_s, seq_buckets=buckets, forward_batches=forwards,
        peak_mem_gb=peak_gb)
    log("main", step="encode", order="arrival", docs=arrival, seconds=arrival_s,
        emb_per_s=arrival / arrival_s)
    log("main", step="index", rows=docs, seconds=index_s)
    log("main", step="query", batches=len(latencies), warmup_batches=1,
        queries_per_batch=batch_queries, k=k,
        latency_ms_p50=float(np.percentile(latencies, 50)),
        latency_ms_p99=float(np.percentile(latencies, 99)),
        latency_ms_max=float(np.max(latencies)))

    if not np.isfinite(embs).all() or embs.shape != (docs, cfg.hidden):
        fail(f"embeddings: shape {embs.shape} or non-finite values")
    # on the CPU (a rehearsal) the wrapper runs the plain version and counts nothing
    expected = cfg.layers * forwards if on_card else 0
    if launches["encoder_attention"] != expected:
        fail(f"attention launches {launches['encoder_attention']} != {expected} "
             f"({cfg.layers} layers x {forwards} forward batches)")
    by_shape = {sh: cfg.layers * n for sh, n in shape_forwards.items()} if on_card else {}
    if sum(by_shape.values()) != launches["encoder_attention"]:
        fail(f"attention launches per shape {by_shape} do not add up to "
             f"{launches['encoder_attention']}")
    # padding to another seq bucket must not move an embedding
    arrival_cos = float((arrival_embs * embs[:arrival]).sum(axis=1).min())
    if arrival_cos <= COS_MIN:
        fail(f"arrival-order vs length-sorted embeddings: min cosine {arrival_cos}")

    # answers against plain f32 scores of the same vectors, on the device
    corpus = torch.from_numpy(embs).to(device)
    corpus = corpus / corpus.norm(dim=1, keepdim=True).clamp_min(1e-12)
    worst_score, self_first = 0.0, 0
    for batch, q, res in zip(picks, queries, answers):
        if any(len(hits) != k for hits in res):
            fail(f"a query of batch {batch[:4]}... got fewer than {k} hits")
        qt = torch.from_numpy(q).to(device)
        qt = qt / qt.norm(dim=1, keepdim=True).clamp_min(1e-12)
        ids = torch.tensor([[h[0] for h in hits] for hits in res], device=device)
        got = torch.tensor([[h[1] for h in hits] for hits in res], device=device)
        plain = torch.einsum("qkd,qd->qk", corpus[ids], qt)
        worst_score = max(worst_score, (got - plain).abs().max().item())
        own = (corpus[torch.from_numpy(batch).to(device)] * qt).sum(dim=1)
        first = ids[:, 0] == torch.from_numpy(batch).to(device)
        ok = first | (own >= got[:, 0] - SCORE_TOL)
        self_first += int(ok.sum())
        if not bool(ok.all()):
            j = int((~ok).nonzero()[0])
            fail(f"query {batch[j]}: own document scores {own[j].item()}, top hit {res[j][0]}")
    if worst_score >= SCORE_TOL:
        fail(f"returned scores differ from plain f32 scores by {worst_score}")

    # every attention shape this run gave the kernel, against the plain version
    if on_card:
        gen = torch.Generator(device=device).manual_seed(seed)
        for shape in sorted(set(shape_forwards) - set(checked)):
            checked[shape] = check_attention_shape(gen, shape, device)
    log("main", step="shapes", attention_shapes=sorted(shape_forwards),
        launches={str(list(sh)): n for sh, n in sorted(by_shape.items())},
        max_abs_err={str(list(sh)): checked[sh] for sh in sorted(shape_forwards) if sh in checked})

    # the kernel path against the plain attention, on the same 64 texts
    sample = [texts[i] for i in picks[0]]
    id_lists = [enc.tokenizer.encode(t) for t in sample]
    ids, mask = pad_batch(id_lists, bucket_seq_len(max(len(x) for x in id_lists)))
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    tree = enc.model.tree()
    with torch.inference_mode():
        fast = fused_sentence_apply(tree, ids_t, mask_t, enc.config, attention=encoder_attention)
        plain = fused_sentence_apply(tree, ids_t, mask_t, enc.config, attention=encoder_attention_reference)
    cos = torch.nn.functional.cosine_similarity(fast, plain, dim=1).min().item()
    log("main", step="check", max_score_err=worst_score, own_doc_first=self_first,
        attention_launches=launches, forward_batches=forwards, min_cos_kernel_vs_plain=cos)
    if cos <= COS_MIN:
        fail(f"kernel-path embeddings vs plain attention: min cosine {cos}")

    # where the encode time goes: the host tokenizer alone, and one forward
    # at the largest batch of the run, whose attention share the kernel
    # line's time gives
    sample = texts[: min(docs, 16384)]
    t0 = time.perf_counter()
    for text in sample:
        enc.tokenizer.encode(text)
    tokenize_s = time.perf_counter() - t0
    step = {"texts_per_s_tokenizer": len(sample) / tokenize_s}
    if on_card:
        ids_t = torch.randint(104, enc.config.vocab_size, (enc.max_batch, 64), device=device)
        mask_t = torch.ones_like(ids_t)
        with torch.inference_mode():
            step["forward_ms"] = time_ms(lambda: enc.model(ids_t, mask_t), iters=10)
        step["forward_shape"] = list(ids_t.shape)
    log("main", step="breakdown", **step)
    return {"launches": launches, "attention_launches": by_shape, "emb_per_s": docs / encode_s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=262144)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathway_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    log("card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    messages = _build.build(ptxas_info=True)
    log("build", seconds=time.perf_counter() - t0, sources=_build.sources())
    for name, text in messages.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    attention, checked, timed = attention_phase(device)
    log("kernels", **{k: v for k, v in attention.items() if k != "launches"})

    result = main_path(device, args.docs, args.seed, checked)
    attention["max_abs_err"] = max(checked.values())
    # one row per attention shape of the main path, timed here if phase 3 had not
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    attention["shapes"] = []
    for shape, n in sorted(result["attention_launches"].items()):
        if shape not in timed:
            timed[shape] = time_attention_shape(gen, shape, device)
        attention["shapes"].append(dict(timed[shape], launches=n, max_abs_err=checked[shape]))
    kernels = [dict(attention, launches=result["launches"][attention["name"]])]
    for kern in kernels:
        if not kern["launches"]:
            fail(f"kernel {kern['name']} was not launched on the main path")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
