"""Seeded text: the synthetic vocabulary and corpus of ``chip_smoke.py``
(``synthetic_corpus``, ``rag_corpus``'s question spans), extended to long
documents of sentences over a Zipf vocabulary.

The same seed gives the same texts.  Document sizes come from a fixed set
(quantiles of the traffic's distribution) that each seed only reorders, so
runs on different seeds carry the same amount of work.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def synthetic_corpus(n: int, seed: int, words_per_text: tuple[int, int] = (6, 60)):
    """``n`` texts of 6-60 words (or ``words_per_text``) over a 20,000-word
    synthetic vocabulary drawn from ``seed``: the texts, their lengths in
    words, each text's word ids and the vocabulary (copied from
    ``chip_smoke.py``)."""
    rng = np.random.default_rng(seed)
    word_lens = rng.integers(3, 10, size=20000)
    vocab = ["".join(rng.choice(LETTERS, size=int(n_))) for n_ in word_lens]
    lengths = rng.integers(words_per_text[0], words_per_text[1] + 1, size=n)
    words = rng.integers(0, len(vocab), size=int(lengths.sum()))
    texts, ids, at = [], [], 0
    for length in lengths:
        ids.append(words[at : at + length])
        texts.append(" ".join(vocab[w] for w in ids[-1]))
        at += length
    return texts, lengths, ids, vocab


def fixed_sizes(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``n`` word counts at the midpoint quantiles of a lognormal of this
    median and log-sigma, clipped to ``[lo, hi]``: the same set for every
    seed."""
    nd = NormalDist()
    q = [nd.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.round(median * np.exp(sigma * np.array(q))), lo, hi).astype(np.int64)


class DocumentStream:
    """Documents of sentences over a Zipf vocabulary, made lazily in
    commits: commit ``c`` holds the same texts for the same seed whenever
    it is asked for.  A document joins sentences drawn from a seeded pool
    (``sentence_pool`` sentences of ``sentence_words`` words, the last
    ending in a full stop) until it holds its word count, so making one
    costs microseconds of the host."""

    def __init__(self, p: dict, seed: int):
        self.p = p
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed, 11])
        word_lens = rng.integers(3, 10, size=p["vocab_words"])
        vocab = np.array(["".join(rng.choice(LETTERS, size=int(k))) for k in word_lens], dtype=object)
        ranks = np.arange(1, p["vocab_words"] + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** -p["zipf_exponent"])
        cdf /= cdf[-1]
        lo, hi = p["sentence_words"]
        lens = rng.integers(lo, hi + 1, size=p["sentence_pool"])
        words = vocab[np.minimum(np.searchsorted(cdf, rng.random(int(lens.sum()))), len(vocab) - 1)]
        ends = np.cumsum(lens)
        words[ends - 1] = words[ends - 1] + "."
        self.sentences = [" ".join(words[e - n : e]) for e, n in zip(ends, lens)]
        self.sentence_lens = lens
        self.sizes = fixed_sizes(p["size_block_docs"], p["words_median"], p["words_log_sigma"],
                                 p["words_min"], p["words_max"])
        self._orders: dict = {}

    def commit(self, c: int) -> list[str]:
        """The ``commit_docs`` documents of commit ``c``."""
        n = self.p["commit_docs"]
        block = self.sizes.shape[0]
        rng = np.random.default_rng([self.seed, 23, c])
        out = []
        for i in range(c * n, (c + 1) * n):
            b, j = divmod(i, block)
            if b not in self._orders:
                self._orders = {b: np.random.default_rng([self.seed, 29, b]).permutation(block)}
            target = int(self.sizes[self._orders[b][j]])
            picks = rng.integers(0, len(self.sentences), size=target // self.p["sentence_words"][0] + 1)
            total = np.cumsum(self.sentence_lens[picks])
            take = int(np.searchsorted(total, target)) + 1
            out.append(" ".join(self.sentences[k] for k in picks[:take]))
        return out


def rag_store(p: dict, seed: int) -> dict:
    """The RAG store's documents (``rag_corpus``'s files: ``files`` texts of
    ``words`` words, no sentence ends) and a pool of distinct questions:
    spans of ``question_words`` words of the files' consecutive
    ``chunk_words``-word spans, with a ``question_swap`` share of the words
    swapped for random ones."""
    texts, _lengths, ids, vocab = synthetic_corpus(p["store_docs"], seed + 301, words_per_text=tuple(p["doc_words"]))
    step = p["chunk_words"]
    spans = [w[a : a + step] for w in ids for a in range(0, len(w), step)]
    rng = np.random.default_rng(seed + 303)
    lo, hi = p["question_words"]
    questions: list[str] = []
    seen: set = set()
    while len(questions) < p["question_pool"]:
        words = spans[int(rng.integers(len(spans)))]
        n = min(int(rng.integers(lo, hi + 1)), len(words))
        start = int(rng.integers(0, len(words) - n + 1))
        picked = np.array(words[start : start + n])
        swapped = rng.random(n) < p["question_swap"]
        picked[swapped] = rng.integers(0, len(vocab), size=int(swapped.sum()))
        q = " ".join(vocab[w] for w in picked)
        if q not in seen:
            seen.add(q)
            questions.append(q)
    return {"texts": texts, "questions": questions}


def sample_indices(n: int, k: int, seed: int, salt: int, must: list[int] = ()) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed, with ``must`` in."""
    rng = np.random.default_rng([int(seed), 41, salt])
    picked = list(dict.fromkeys([m for m in must if 0 <= m < n]))
    rest = [int(i) for i in rng.permutation(n) if int(i) not in set(picked)]
    return sorted(picked + rest[: max(0, min(k, n) - len(picked))])
