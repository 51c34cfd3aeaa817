"""The port's encoders on the shared default executor, against the JAX
package's.

A tiny ``SentenceEncoder`` (2 layers, H=128, 4 heads, ffn 512, vocab 1000;
the JAX encoder's weights carried across) serves texts behind
``AsyncMicroBatcher`` and ``submit``, and its embeddings are held to the
JAX encoder's ``encode`` of the same texts at cosine > 0.999
(``tests/test_attention_kernel.py:119``).  Two instances of one model with
different weights share one registration and each runs its own weights,
since the weights are the dispatch's operand.  An explicit CPU host
fallback (``as_host_fallback``) serves a tripped breaker's batches.
"""

from __future__ import annotations

import asyncio
import json
import sys

import jax
import numpy as np
import pytest

import pathway_tpu_torch as pt
import pathway_tpu_torch.device as tdev
from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

SMALL = {
    "vocab_size": 1000,
    "hidden_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 512,
    "max_position_embeddings": 128,
}
COS_MIN = 0.999
TEXTS = [f"streaming document {i} about topic {i % 7} with {i * 3} words" for i in range(40)]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    return str(d)


def _without_transformers(make):
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    try:
        return make()
    finally:
        if saved == "absent":
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved


@pytest.fixture(scope="module")
def pairs(model_dir):
    """(jax, port) sentence encoders at seeds 0 and 1, the port's carrying
    the JAX weights."""
    out = {}
    for seed in (0, 1):
        jenc = _without_transformers(lambda: JaxEncoder(model_dir, seed=seed))
        tenc = _without_transformers(lambda: pt.SentenceEncoder(model_dir, seed=seed, device="cpu"))
        tenc.set_params(jax.device_get(jenc.params))
        out[seed] = (jenc, tenc)
    return out


def _cos_rows(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_encoder_registers_on_the_default_executor(pairs):
    _, tenc = pairs[0]
    ex = tdev.get_default_executor("cpu")
    assert tenc._executor is ex and ex.registered(tenc._callable)


def test_batcher_over_encode_matches_the_jax_encoder(pairs):
    jenc, tenc = pairs[0]
    ex = tdev.get_default_executor("cpu")
    batch_sizes = []

    def process(items):
        batch_sizes.append(len(items))
        return tenc.encode(items)

    batcher = AsyncMicroBatcher(process, max_batch_size=16, flush_delay=0.002, executor=ex)

    async def main():
        return await asyncio.gather(*(batcher.submit(t) for t in TEXTS))

    rows = np.stack(asyncio.run(main()))
    ref = np.asarray(jenc.encode(TEXTS), np.float32)
    assert rows.shape == ref.shape == (len(TEXTS), SMALL["hidden_size"]) and rows.dtype == np.float32
    assert np.isfinite(rows).all()
    assert _cos_rows(rows, ref).min() > COS_MIN
    assert sum(batch_sizes) == len(TEXTS) and max(batch_sizes) <= 16
    # each row of a coalesced batch is the row a direct encode gives
    assert _cos_rows(rows, tenc.encode(TEXTS)).min() > COS_MIN
    with batcher._lock:
        assert not batcher._pending


def test_submit_overlaps_tokenizing_with_dispatch(pairs):
    """The submit pattern: the caller tokenizes the next batch while the
    dispatch thread runs the current one; results equal a synchronous
    loop's."""
    jenc, tenc = pairs[0]
    ex = tdev.get_default_executor("cpu")
    batches = [TEXTS[i : i + 8] for i in range(0, len(TEXTS), 8)]
    sync = [tenc._run_padded([tenc.tokenizer.encode(t) for t in b]) for b in batches]
    futures = []
    for b in batches:
        ids = [tenc.tokenizer.encode(t) for t in b]
        futures.append(ex.submit(lambda ids=ids: tenc._run_padded(ids), name="encode", nbytes=0))
    rows = np.concatenate([f.result(timeout=60) for f in futures])
    np.testing.assert_array_equal(rows, np.concatenate(sync))
    assert _cos_rows(rows, np.asarray(jenc.encode(TEXTS))).min() > COS_MIN


def test_two_instances_of_one_model_run_their_own_weights(pairs):
    (j0, t0), (j1, t1) = pairs[0], pairs[1]
    assert t0._callable == t1._callable  # one shared registration
    a, b = t0.encode(TEXTS[:8]), t1.encode(TEXTS[:8])
    assert _cos_rows(a, b).max() < 0.99  # different weights, different embeddings
    assert _cos_rows(a, np.asarray(j0.encode(TEXTS[:8]))).min() > COS_MIN
    assert _cos_rows(b, np.asarray(j1.encode(TEXTS[:8]))).min() > COS_MIN
    np.testing.assert_array_equal(t0.encode(TEXTS[:8]), a)


def test_an_explicit_cpu_fallback_serves_a_tripped_breaker(model_dir, pairs, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_BREAKER_COOLDOWN_S", "60")
    _, twin = pairs[0]
    enc = _without_transformers(
        lambda: pt.SentenceEncoder(model_dir, device="cpu", host_fallback=twin.as_host_fallback())
    )
    enc.set_params(twin.params)
    ex = enc._executor
    assert enc._callable != twin._callable  # a fallback makes the registration its own
    ref = enc.encode(TEXTS[:6])
    tfaults.install_plan(tfaults.FaultPlan(
        [{"kind": "device_error", "source": enc._callable, "from_nth": 1, "max_times": 1}], seed=3))
    try:
        out = enc.encode(TEXTS[:6])
        again = enc.encode(TEXTS[:6])  # the breaker is open: the fallback serves, the device is not tried
    finally:
        tfaults.clear_plan()
    st = ex.resilience_stats(enc._callable)
    assert st["breaker"]["state"] == "open" and st["fallback_batches"] == 2
    assert _cos_rows(out, ref).min() > COS_MIN and _cos_rows(again, ref).min() > COS_MIN
