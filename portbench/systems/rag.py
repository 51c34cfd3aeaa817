"""``AdaptiveRAGQuestionAnswerer(JaxChat(...))`` over a ``DocumentStore``,
served over REST (``build_server``), as ``chip_smoke.py``'s ``[rag]``
runs it.

The decoder is the process's shared continuous-batching scheduler of the
model, built here first so that its weights can be set: the program's own
seeded tree is dropped and the harness's tree put in its place
(``DecoderLM.params``).  ``control`` switches the program's weight-only
int8 path on (``JaxChat(quantize="int8")``), serving the same weights
quantized by the program.
"""

from __future__ import annotations

import threading
import time

from portbench import weights
from portbench.systems import docstore

SIZE_KEYS = {
    "hidden_size": "hidden",
    "num_hidden_layers": "layers",
    "num_attention_heads": "heads",
    "num_key_value_heads": "kv_heads",
    "intermediate_size": "intermediate",
    "vocab_size": "vocab_size",
    "served_positions": "max_len",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "sliding_window": "sliding_window",
}


def build(cfg: dict, store_cfg: dict, docs, seed: int, device, probe, port: int, control: bool = False) -> dict:
    import gc

    import torch

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.serving import generation
    from pathway_tpu_torch.xpacks.llm import AdaptiveRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.llms import JaxChat

    store = docstore.build(store_cfg, docs, seed, device, probe)
    quantize = "int8" if control else None
    sched = generation.shared_scheduler(cfg["model"], max_cache=cfg["max_cache"], quantize=quantize, device=device)
    lm = sched.lm
    served = {k: getattr(lm.config, f) for k, f in SIZE_KEYS.items()}
    stated = {k: cfg[k] for k in SIZE_KEYS}
    if served != stated or sched.slots != cfg["slots"]:
        raise ValueError(f"the program serves {served} on {sched.slots} slots, the configuration states {stated}")
    if lm.pretrained:
        raise ValueError("the program found a checkpoint; the benchmark serves seeded weights")
    lm.params = None  # the program's own seeded tree: freed before the harness's is made
    gc.collect()
    if lm.device.type == "cuda":
        torch.cuda.empty_cache()
    tree = weights.mistral_tree(cfg, seed, lm.device, dtype=lm.config.dtype)
    lm.params = dec.quantize_decoder_tree(tree) if control else tree
    chat = JaxChat(cfg["model"], max_new_tokens=cfg["max_new_tokens"], max_cache=cfg["max_cache"],
                   quantize=quantize, device=device)
    rag = AdaptiveRAGQuestionAnswerer(chat, store["store"], n_starting_documents=cfg["n_starting_documents"],
                                      factor=cfg["factor"], max_iterations=cfg["max_iterations"])
    rag.build_server("127.0.0.1", port)
    return {**store, "sched": sched, "lm": lm, "decoder_tree": tree, "rag": rag, "chat": chat}


def instrument(sys_: dict, probe, trace: bool) -> None:
    """Always: each prompt the scheduler was given with its request, and
    the tokens each decode step appended to each request.  Traced: host
    time of each tick, the prefill chunks and decode contexts, and a
    range around the paged attention of decode steps."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.ops import attention as attention_ops

    docstore.instrument(sys_, probe, trace)
    sched = sys_["sched"]
    local = threading.local()

    def submit(orig):
        def call(prompt, *a, **k):
            local.prompt = prompt
            try:
                return orig(prompt, *a, **k)
            finally:
                local.prompt = None
        return call

    def submit_request(orig):
        def call(prompt_ids, *a, **k):
            req = orig(prompt_ids, *a, **k)
            probe.add("submit", getattr(local, "prompt", None), req)
            return req
        return call

    def run_decode(orig):
        def call(rows):
            live = [sched._slots[i] for i in rows]
            live = [s for s in live if s is not None and s.prefill_done]
            before = [(s.req, len(s.req.out), s.seq_len + 1) for s in live]
            if trace:
                page = sched.page_size
                pages = sum(-(-ctx // page) for _r, _n, ctx in before)
                probe.add("decode_step", [ctx for _r, _n, ctx in before], pages * page)
            out = orig(rows)
            probe.add("decoded", [(req, len(req.out) - n) for req, n, _c in before])
            return out
        return call

    probe.patch(sched, "submit", submit)
    probe.patch(sched, "submit_request", submit_request)
    probe.patch(sched, "_run_decode", run_decode)
    if not trace:
        return

    def tick(orig):
        def call():
            t0 = time.perf_counter()
            with probe.span("tick"):
                out = orig()
            probe.add("tick", time.perf_counter() - t0)
            return out
        return call

    def run_prefill(orig):
        def call(rows):
            T = sched.prefill_chunk
            chunks = []
            for i in rows:
                s = sched._slots[i]
                if s is not None and s.prompt_len > s.seq_len:
                    chunks.append((min(T, s.prompt_len - s.seq_len), s.seq_len))
            probe.add("prefill", chunks)
            return orig(rows)
        return call

    def decode_step(orig):
        def call(*a, **k):
            local.decoding = True
            try:
                return orig(*a, **k)
            finally:
                local.decoding = False
        return call

    def paged_attention(orig):
        def call(*a, **k):
            if getattr(local, "decoding", False):
                with probe.span("decode_attention"):
                    return orig(*a, **k)
            return orig(*a, **k)
        return call

    # a query embedded or searched meanwhile launches on another thread
    probe.foreign["decode_attention"] = ("encode", "search")
    probe.patch(sched, "_tick", tick)
    probe.patch(sched, "_run_prefill", run_prefill)
    probe.patch(dec, "paged_decode_step", decode_step)
    probe.patch(attention_ops, "paged_gqa_attention", paged_attention)


def release(sys_: dict) -> None:
    """Free the program's serving state (the scheduler's KV pool, its
    thread, the shared decoder); the harness's weight tree stays for the
    reference."""
    import gc

    import torch

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.serving import generation

    generation.reset_shared_schedulers()
    dec.shared_decoder.cache_clear()
    sys_["lm"].params = None
    for key in ("sched", "lm", "rag", "chat"):
        sys_.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
