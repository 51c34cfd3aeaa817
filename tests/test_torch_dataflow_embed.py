"""``chip_smoke.py``'s ``[dataflow]`` Table program at a small size, in both
packages: docs streamed in 4 epochs, a fifth retracting 8 and replacing
the text of 8 others, embedded by an async ``pw.udf`` through the
package's ``AsyncMicroBatcher`` over its ``SentenceEncoder``, scored
against a unit query, joined with their sources and reduced per source.

The encoder is tiny (2 layers, H=128, 4 heads, ffn 512, vocab 1000); the
port's carries the JAX encoder's weights.  The JAX encoder runs its
Pallas attention in interpret mode (its ``fused_trunk`` given
``interpret=True`` here, in the test).  Keys, times, diffs, doc ids,
source names and counts must be equal; embeddings at cosine > 0.999
(``tests/test_attention_kernel.py:119``); a score, the dot of unit vectors,
within sqrt(2·(1 − 0.999)) of JAX's, the bound that cosine gives, and a
source's total within its count times that.  The port's final rows must
be a direct ``encode`` of the live texts, replaced texts included and
retracted docs absent.  Its pure-Python core (``PATHWAY_NATIVE=0``, in a
subprocess) and its row path give its own streams, bit for bit.
"""

from __future__ import annotations

import json
import math
import pickle
import sys

import jax
import numpy as np
import pytest

import chip_smoke
import pathway_tpu as pj
import pathway_tpu.models.encoder as jenc_mod
import pathway_tpu_torch as pt
from pathway_tpu.ops import attention as jattn
from pathway_tpu_torch.device import get_default_executor
from pathway_tpu_torch.internals import vector_compiler as vc
from tests import torch_dataflow_programs as P

SMALL = {
    "vocab_size": 1000,
    "hidden_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 512,
    "max_position_embeddings": 128,
}
COS_MIN = 0.999
SCORE_TOL = math.sqrt(2 * (1 - COS_MIN))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The config directory, the JAX encoder (interpret-mode Pallas
    attention) and the port's encoder on its weights."""
    d = tmp_path_factory.mktemp("small_encoder")
    (d / "config.json").write_text(json.dumps(SMALL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc_mod, "encoder_attention",
                   lambda *a, interpret=False, **kw: jattn.encoder_attention(*a, interpret=True, **kw))
        mp.setitem(sys.modules, "transformers", None)  # the config's own tokenizer, no download
        jenc = jenc_mod.SentenceEncoder(str(d), seed=0)
        params = jax.device_get(jenc.params)
        tenc = P.port_encoder(str(d), params)
        yield str(d), params, jenc, tenc


@pytest.fixture(scope="module")
def python_core_run(model, tmp_path_factory):
    model_dir, params, _, _ = model
    tmp = tmp_path_factory.mktemp("python_core_embed")
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    proc = P.spawn_python_core(tmp / "out.pkl", model_dir, tmp / "params.pkl")
    yield proc, tmp / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def streams(model, python_core_run) -> dict:
    _, _, jenc, tenc = model
    out = {"jax": P.capture_embedding(pj, jenc.encode, jenc.dimensions)}
    for columnar in (True, False):
        vc.set_enabled(columnar)
        try:
            out[columnar] = P.capture_embedding(pt, tenc.encode, tenc.dimensions, executor=get_default_executor("cpu"))
        finally:
            vc.set_enabled(True)
    return out


def _cos(a, b) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_keys_times_diffs_and_columns_match_jax(streams):
    want, got = streams["jax"], streams[True]
    for table in ("docs", "per_source"):
        assert [d[:3] for d in got[table]] == [d[:3] for d in want[table]], table
    for (_, _, _, w), (_, _, _, g) in zip(want["docs"], got["docs"]):
        assert g[:2] == w[:2]  # doc_id, source name
        assert _cos(g[2], w[2]) > COS_MIN
        assert abs(g[3] - w[3]) <= SCORE_TOL
    for (_, _, _, w), (_, _, _, g) in zip(want["per_source"], got["per_source"]):
        assert g[:2] == w[:2]  # source name, count
        assert abs(g[2] - w[2]) <= g[1] * SCORE_TOL


def test_final_rows_are_a_direct_encode_of_the_live_texts(model, streams):
    _, _, _, tenc = model
    stream = P.embed_stream()
    live = stream["live"]
    docs = chip_smoke.final_rows([(k, r, t, d) for t, k, d, r in streams[True]["docs"]])
    got = {row[0]: row for row in docs.values()}
    assert sorted(got) == sorted(live)
    assert not set(stream["retracted"]) & set(got) and set(stream["replaced"]) <= set(got)
    ids = sorted(live)
    direct = tenc.encode([live[i][0] for i in ids])
    for i, vec in zip(ids, direct):
        assert _cos(got[i][2], vec) > COS_MIN
    query = P.embed_query(tenc.dimensions)
    groups = chip_smoke.final_rows([(k, r, t, d) for t, k, d, r in streams[True]["per_source"]])
    names = dict(stream["sources"])
    for name, count, total in groups.values():
        members = [j for j, i in enumerate(ids) if names[live[i][1]] == name]
        assert count == len(members)
        want = float((direct[members] @ query).sum())
        assert abs(total - want) <= chip_smoke.DATAFLOW_SUM_REL * max(1.0, abs(want))


def _assert_same(a: dict, b: dict) -> None:
    for table in a:
        assert [d[:3] for d in a[table]] == [d[:3] for d in b[table]], table
        for (_, _, _, x), (_, _, _, y) in zip(a[table], b[table]):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert np.array_equal(u, v) if isinstance(u, np.ndarray) else u == v, table


def test_row_path_matches_columnar(streams):
    _assert_same(streams[False], streams[True])


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "row"])
def test_python_core_matches_native(python_core_run, streams, columnar):
    got = P.python_core_result(*python_core_run)
    _assert_same(got[columnar]["embedding"], streams[True])
