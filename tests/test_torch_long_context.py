"""The port's long-context encoder across gloo ranks, against the JAX
package's ``LongContextSentenceEncoder`` on a mesh of the same size (the
conftest's virtual CPU devices), with the JAX encoder's weights carried
across.

A ``config.json`` directory built here gives both packages a tiny shape
(2 layers, H 64, 4 heads, ``max_len`` 32); a second one pools by CLS.
The texts run past ``max_len`` ids at worlds 2 and 4, where positions
tile.  Each world size spawns one gloo group (``tests/gloo_ranks.py``)
that runs every case.  Tolerances: cosine > ``COS_MIN`` against JAX (both
run the trunk in bf16 with f32 attention; they part by bf16 rounding
only), the JAX tests' own 0.02 for padding invariance
(``tests/test_long_context.py:77``) and 0.99 for the world-1 encoder
against the single-card ``SentenceEncoder`` (``:53``).
"""

from __future__ import annotations

import json
import pickle
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.sharding import Mesh  # noqa: E402

from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder  # noqa: E402
from pathway_tpu.models.encoder import pack_fast_params  # noqa: E402
from pathway_tpu.models.long_context import LongContextSentenceEncoder as JaxLongContext  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

SMALL = {
    "vocab_size": 1000,
    "hidden_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 128,
    "max_position_embeddings": 32,
}
COS_MIN = 0.999
PAD_TOL = 0.02  # tests/test_long_context.py:77
SINGLE_COS_MIN = 0.99  # :53
WORLDS = (1, 2, 4)
POOLINGS = ("mean", "cls")


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    dirs = {}
    for pooling in POOLINGS:
        d = tmp_path_factory.mktemp(f"long_context_{pooling}")
        (d / "config.json").write_text(json.dumps(SMALL))
        if pooling == "cls":
            (d / "1_Pooling").mkdir()
            (d / "1_Pooling" / "config.json").write_text(json.dumps({"pooling_mode_cls_token": True}))
        dirs[pooling] = str(d)
    return dirs


@pytest.fixture(scope="module")
def no_transformers():
    """Neither package looks up an HF checkpoint or tokenizer: the hashing
    tokenizer and seeded weights, as in the ranks and on the card."""
    saved = sys.modules.get("transformers", "absent")
    sys.modules["transformers"] = None
    yield
    if saved == "absent":
        del sys.modules["transformers"]
    else:
        sys.modules["transformers"] = saved


@pytest.fixture(scope="module")
def jax_params(model_dirs, no_transformers, tmp_path_factory):
    """The JAX encoder's seeded params, pickled for the ranks."""
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(JaxEncoder(model_dirs["mean"], seed=0).params))
    path = tmp_path_factory.mktemp("long_context_params") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return params, str(path)


@pytest.fixture(scope="module")
def groups(model_dirs, jax_params, tmp_path_factory):
    started = {
        w: g.RankGroup(g.long_context_cases, w, tmp_path_factory.mktemp(f"long_context{w}"), model_dirs, jax_params[1])
        for w in WORLDS
    }
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(world, groups):
    return groups[world].results()


@pytest.fixture(scope="module")
def jax_encoders(world, model_dirs, jax_params, no_transformers):
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    return {pooling: JaxLongContext(model_dirs[pooling], mesh, seed=0) for pooling in POOLINGS}


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)


def test_jax_long_context_runs_the_carried_weights(jax_encoders, jax_params):
    """The JAX side's tree is the one carried to the ranks (same seed)."""
    enc = jax_encoders["mean"]
    want = pack_fast_params(jax_params[0], enc.config)
    for got, ref in zip(jax.tree_util.tree_leaves(enc._tree), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(got, np.float32), np.asarray(ref, np.float32))


@pytest.mark.parametrize("pooling", POOLINGS)
def test_matches_jax_long_context_encoder(ranks, jax_encoders, pooling):
    texts = g.long_context_texts()
    want = jax_encoders[pooling].encode(texts)
    first = ranks[0][pooling]["embeddings"]
    assert first.shape == want.shape == (len(texts), SMALL["hidden_size"]) and first.dtype == np.float32
    assert np.isfinite(first).all()
    np.testing.assert_allclose(np.linalg.norm(first, axis=1), 1.0, atol=1e-5)
    assert _cos(first, want).min() > COS_MIN
    for res in ranks[1:]:  # every rank returns the same vectors
        np.testing.assert_array_equal(res[pooling]["embeddings"], first)


def test_texts_run_past_max_len(ranks, world, jax_encoders):
    """Ids are cut at max_len × n; past max_len positions tile, and the
    sequence bucket stays divisible by the ring."""
    ids, uncut = ranks[0]["mean"]["ids"], ranks[0]["mean"]["uncut"]
    max_len = SMALL["max_position_embeddings"]
    assert max(ids) == min(max(uncut), max_len * world)
    if world > 1:
        assert max(ids) > max_len
    buckets = ranks[0]["mean"]["seq_buckets"]
    assert buckets == [jax_encoders["mean"]._bucket_seq(n) for n in (1, 17, 33, 200, 10_000)]
    assert all(b % world == 0 for b in buckets)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_padding_invariance(ranks, pooling):
    """Batch-mates must not change a text's embedding (mask correctness
    across sequence blocks)."""
    for res in ranks:
        assert np.abs(res[pooling]["alone"] - res[pooling]["padded"]).max() < PAD_TOL


def test_world_one_matches_the_sentence_encoder(groups):
    """At world 1 texts are cut at max_len, as in JAX on one chip: the
    ring of one block against the port's fused SentenceEncoder."""
    res = groups[1].results()[0]
    assert _cos(res["mean"]["embeddings"], res["single"]).min() > SINGLE_COS_MIN


def test_no_encoder_kernel_and_a_shared_encoder(ranks):
    for res in ranks:
        assert res["encoder_launches"] == 0  # the ring's plain einsums, as in JAX
        assert res["shared_is_cached"]
