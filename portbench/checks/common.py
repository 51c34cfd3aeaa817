"""What the checks share: the reference's embeddings of texts, the map from
a vector the index took back to the text the encoder embedded, and a
number beside its limit."""

from __future__ import annotations

import torch

from portbench.reference import bert, strict_f32, text


def gap_stats(name: str, gaps: torch.Tensor) -> dict:
    """The widest, median and mean of a set of gaps, and their mean square:
    the limits file says which of them are compared."""
    g = gaps.double()
    if not len(g):
        return {f"{name}_{k}": 0.0 for k in ("max", "median", "mean", "msq")}
    return {f"{name}_max": float(g.max()), f"{name}_median": float(g.median()),
            f"{name}_mean": float(g.mean()), f"{name}_msq": float((g * g).mean())}


def reference_ids(texts: list[str], cfg: dict) -> list[list[int]]:
    return [text.hash_ids(t, cfg["vocab_size"], cfg["max_position_embeddings"]) for t in texts]


def reference_embeddings(tree, id_lists: list[list[int]], cfg: dict, device) -> torch.Tensor:
    strict_f32()
    return bert.embed(tree, id_lists, cfg["num_attention_heads"], cfg["pooling"], device)


def encoded_texts(probe) -> dict:
    """Vector bytes -> the text the encoder embedded into it."""
    out: dict = {}
    for _t, texts, vectors in probe.of("encode"):
        for i, t in enumerate(texts):
            out[vectors[i].tobytes()] = t
    return out


def id_digests(probe) -> dict:
    return {t: (crc, n) for _t, t, crc, n in probe.of("ids")}


def id_mismatches(texts: list[str], ref_ids: list[list[int]], probe) -> int:
    import zlib
    from array import array

    digests = id_digests(probe)
    bad = 0
    for t, ids in zip(texts, ref_ids):
        if digests.get(t) != (zlib.crc32(array("i", ids).tobytes()), len(ids)):
            bad += 1
    return bad


def l2_gaps(got, ref: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of each row of ``got`` from the same row of ``ref``."""
    g = torch.as_tensor(got, dtype=torch.float32, device=ref.device)
    return (g - ref).norm(dim=1) if len(g) else torch.zeros(0)
