"""The port's copies of the tokenizer and the bucketing planner give the
JAX package's token ids, padding, sequence buckets and batch plans, and
the port's slim executor dispatches by those plans."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from pathway_tpu.device import bucketing as jb
from pathway_tpu.models import tokenizer as jt
from pathway_tpu_torch.device import bucketing as tb
from pathway_tpu_torch.models import tokenizer as tt

TEXTS = [
    "",
    "hello world",
    "Streaming dataflow, with retractions!",
    "ÜNICODE café — naïve façade",
    "a " * 700,  # longer than max_length: truncated
    "tabs\tand\nnewlines; punctuation?!",
]


@pytest.mark.parametrize("vocab,max_length", [(30522, 512), (1000, 128), (30522, 16)])
def test_hash_tokenizer_ids_match(vocab, max_length):
    j = jt.HashTokenizer(vocab_size=vocab, max_length=max_length)
    t = tt.HashTokenizer(vocab_size=vocab, max_length=max_length)
    for text in TEXTS:
        assert t.encode(text) == j.encode(text)
        assert t.encode(text, max_length=8) == j.encode(text, max_length=8)
    for a, b in zip(TEXTS, reversed(TEXTS)):
        assert t.encode_pair(a, b) == j.encode_pair(a, b)
    ids = j.encode(TEXTS[2])
    assert t.decode(ids) == j.decode(ids)


def test_load_tokenizer_falls_back_to_hashing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # no HF tokenizer available
    tok = tt.load_tokenizer(str(tmp_path), 1000, 64)
    ref = jt.load_tokenizer(str(tmp_path), 1000, 64)
    assert isinstance(tok, tt.HashTokenizer)
    assert tok.encode(TEXTS[1]) == ref.encode(TEXTS[1])


def test_pad_batch_matches():
    tok = tt.HashTokenizer()
    id_lists = [tok.encode(t) for t in TEXTS[:4]]
    for seq in (4, 16, 64):
        ids_t, mask_t = tt.pad_batch(id_lists, seq)
        ids_j, mask_j = jt.pad_batch(id_lists, seq)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)
        assert ids_t.dtype == ids_j.dtype and mask_t.dtype == mask_j.dtype


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 33, 64, 65, 200, 512, 513, 2000])
def test_seq_and_batch_buckets_match(n):
    assert tt.bucket_seq_len(n) == jt.bucket_seq_len(n)
    assert tt.bucket_batch(n) == jt.bucket_batch(n)
    assert tt.bucket_batch(n, max_batch=32) == jt.bucket_batch(n, max_batch=32)
    assert tb.next_pow2(n) == jb.next_pow2(n)


POLICIES = [
    {},
    {"max_bucket": 64},
    {"min_bucket": 8, "max_bucket": 256},
    {"min_bucket": 3, "max_bucket": 40},
    {"sizes": (3, 19, 100)},
]


@pytest.mark.parametrize("kwargs", POLICIES, ids=lambda k: str(k) or "default")
def test_bucket_policy_matches(kwargs):
    t, j = tb.BucketPolicy(**kwargs), jb.BucketPolicy(**kwargs)
    assert t.buckets() == j.buckets()
    for n in (1, 2, 3, 7, 19, 20, 40, 63, 64, 65, 100, 511, 512, 513, 1500):
        assert [_fields(c) for c in t.plan(n)] == [_fields(c) for c in j.plan(n)]
        if n <= j.max_bucket:
            assert t.bucket_for(n) == j.bucket_for(n)


def _fields(chunk):
    return (chunk.start, chunk.count, chunk.bucket)


@pytest.mark.parametrize("kwargs", [{"min_bucket": 0}, {"min_bucket": 8, "max_bucket": 4}, {"sizes": ()}])
def test_bucket_policy_rejects_bad_bounds(kwargs):
    with pytest.raises(ValueError):
        jb.BucketPolicy(**kwargs)
    with pytest.raises(ValueError):
        tb.BucketPolicy(**kwargs)


def test_plan_rejects_empty_and_oversized():
    p = tb.BucketPolicy(max_bucket=8)
    with pytest.raises(ValueError):
        p.plan(0)
    with pytest.raises(ValueError):
        p.bucket_for(9)


@pytest.mark.parametrize("n,bucket", [(3, 4), (4, 4), (1, 16)])
def test_pad_batch_dim_matches(n, bucket):
    a = np.arange(n * 5, dtype=np.int32).reshape(n, 5) + 1
    pt, mt = tb.pad_batch_dim(a, bucket)
    pj, mj = jb.pad_batch_dim(a, bucket)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(mt, mj)
    assert (pt[n:] == 0).all()
    with pytest.raises(ValueError):
        tb.pad_batch_dim(a, n - 1)


def test_executor_pads_splits_and_unpads():
    """``run_batch`` hands the callable bucket-sized batches (zero rows
    appended), splits above the largest bucket, and returns exactly the
    submitted rows, in order."""
    import torch

    from pathway_tpu_torch.device import DeviceExecutor

    seen = []

    def fn(scale, x, *, shift):
        seen.append(tuple(x.shape))
        return x * scale + shift, x.sum(dim=1)

    ex = DeviceExecutor("cpu")
    ex.register("affine", fn, policy=tb.BucketPolicy(max_bucket=8))
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    y, sums = ex.run_batch("affine", (x,), operands=(torch.tensor(2.0),), static={"shift": 1.0})
    assert seen == [(8, 3), (4, 3)]  # 8 rows, then 3 padded to 4
    np.testing.assert_array_equal(y, x * 2 + 1)
    np.testing.assert_array_equal(sums, x.sum(axis=1))
    assert ex.dispatches("affine") == 2
    with pytest.raises(ValueError):
        ex.run_batch("affine", (x[:0],), static={"shift": 0.0})
