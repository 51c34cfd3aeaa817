"""A copy of the benchmark at a size the CPU runs in seconds: MiniLM's
shape for the store, the port's tiny decoder preset for the answers, and
short documents, questions and windows."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent

STORE = {
    "name": "tiny_store", "system": "docstore", "model": "all-MiniLM-L6-v2",
    "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12, "intermediate_size": 1536,
    "vocab_size": 30522, "max_position_embeddings": 512, "pooling": "mean",
    "splitter_min_tokens": 20, "splitter_max_tokens": 60, "embedder_max_batch": 16,
    "control_env": {"PATHWAY_ENCODER_QUANTIZE": "int8"},
}
RAG_STORE = {**STORE, "name": "tiny_rag_store", "splitter_min_tokens": 5, "splitter_max_tokens": 10,
             "index_score_tolerance": 1e-5}  # the CPU's index scores in float32
RAG = {
    "name": "tiny_rag", "system": "rag", "model": "pw-tiny-decoder",
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "vocab_size": 512, "served_positions": 128, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None, "store_config": "tiny_rag_store",
    "n_starting_documents": 2, "factor": 2, "max_iterations": 4, "max_new_tokens": 8, "max_cache": 128,
    "slots": 8,
}
BACKLOG = {
    "generator": "document_backlog", "commit_docs": 8, "ahead_commits": 2, "vocab_words": 2000,
    "zipf_exponent": 1.0, "sentence_words": [5, 12], "sentence_pool": 256, "words_median": 60,
    "words_log_sigma": 0.5, "words_min": 20, "words_max": 200, "size_block_docs": 64,
    "warmup_chunks": 16, "check_chunks": 16,
}
ANSWERS = {
    "generator": "closed_loop_answers", "store_docs": 24, "doc_words": [10, 30], "chunk_words": 10,
    "commit_docs": 8, "question_words": [3, 5], "question_swap": 0.25, "question_pool": 256, "clients": 4,
    "start_stagger_s": 0.05, "warmup_answers": 2, "check_answers": 3, "check_block": 2, "deadline_ms": 300000,
}
INGEST_LIMITS = {"chunks_not_as_split": 0, "chunks_not_indexed": 0, "index_vectors_not_encoded": 0,
                 "token_id_mismatches": 0, "embedding_l2_msq": 0.0002}
ANSWER_LIMITS = {"chunks_not_as_split": 0, "requests_unanswered": 0, "requests_overtaken": 0,
                 "retrievals_unknown": 0, "retrievals_not_sorted": 0, "retrievals_malformed": 0,
                 "retrievals_off_topk": 0, "retrieval_scores_off": 0, "prompts_not_template": 0,
                 "prompt_id_mismatches": 0, "answer_text_mismatches": 0, "embedding_l2_msq": 0.0003, "served_logit_gap_mean": 0.05}


def make(root: Path) -> dict:
    """Write a tiny benchmark under ``root`` (a copy of ``portbench/`` with
    tiny files added) and return its ``BENCHMARK.json`` contents."""
    pdir = root / PKG.name
    shutil.copytree(PKG, pdir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    files = {
        "configs/tiny_store.json": STORE, "configs/tiny_rag_store.json": RAG_STORE, "configs/tiny_rag.json": RAG,
        "traffic/tiny_backlog.json": BACKLOG, "traffic/tiny_answers.json": ANSWERS,
        "limits/tiny_ingest.json": INGEST_LIMITS, "limits/tiny_answers.json": ANSWER_LIMITS,
    }
    for rel, data in files.items():
        (pdir / rel).write_text(json.dumps(data))
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"{PKG.name}/configs/{n}.json", "reduced": [], "why": "test"}
                        for n in ("tiny_store", "tiny_rag_store", "tiny_rag")]
    bench["workloads"] = [
        {"name": "tiny_ingest", "config": "tiny_store", "traffic": "tiny_backlog", "chips": 1, "why": "test"},
        {"name": "tiny_answers", "config": "tiny_rag", "traffic": "tiny_answers", "chips": 1, "why": "test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_ingest"] if "bge_ingest_backlog" in m["workloads"] else ["tiny_answers"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def workload(bench: dict, name: str) -> dict:
    return next(w for w in bench["workloads"] if w["name"] == name)
