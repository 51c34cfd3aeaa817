"""The port's ring attention across gloo ranks, against the JAX package's
ring on a mesh of the same size (the conftest's virtual CPU devices; its
``ring_attention_traced``, the computation ``ring_encoder_attention``
runs, under one jit) and against the plain attention, at
``tests/test_ring_attention.py``'s shapes (S halved) and pins.

Each world size spawns one gloo group (``tests/gloo_ranks.py``) that runs
every case; a rank returns its sequence block and the test joins the
blocks in ring order.  Inputs are f32 from numpy, rounded to bf16 in both
packages.  Tolerances: the JAX test's own (0.05 against the plain
attention, 0.06 against the f32 truth, 1e-3 for masked keys), and
against the JAX ring ``RING_TOL``: both rings accumulate in f32 and round
once to bf16 at the end, so they part by at most one bf16 step of an
output (|out| < 2 here, a step of 2**-7).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from pathway_tpu.ops.attention import _xla_attention  # noqa: E402
from pathway_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from pathway_tpu.parallel.ring_attention import ring_attention_traced  # noqa: E402
from pathway_tpu_torch.ops.attention import encoder_attention_reference  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

ATTN_TOL = 0.05  # tests/test_ring_attention.py:48
TRUTH_TOL = 0.06  # :85
PIN_TOL = 1e-3  # :109
RING_TOL = 2.0**-7 + 1e-6
F32_TOL = 1e-5  # both rings in f32 end to end
WORLDS = (2, 4)

# the JAX ring under one jit (its eager entry point re-traces every call)
_jax_ring_jit = jax.jit(ring_attention_traced, static_argnums=(0, 5, 6))


def jax_ring(mesh, q, k, v, bias, heads, axis=None):
    return _jax_ring_jit(mesh, q, k, v, bias, heads, axis)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {w: g.RankGroup(g.ring_cases, w, tmp_path_factory.mktemp(f"ring{w}")) for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def ranks(world, groups):
    return groups[world].results()


def _sp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _joined(ranks, key, *sub):
    """The ranks' sequence blocks in ring order."""
    blocks = []
    for res in ranks:
        v = res[key]
        for s in sub:
            v = v[s]
        blocks.append(v)
    return np.concatenate(blocks, axis=1)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _plain(q, k, v, bias, heads, dtype=torch.bfloat16):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return encoder_attention_reference(*t, torch.from_numpy(bias), heads).float().numpy()


@pytest.mark.parametrize("shape", g.RING_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_ring_and_plain_attention(ranks, world, shape):
    B, S, H, heads = shape
    q, k, v, bias = g.ring_inputs(B, S, H, 0, 0.9)
    out = _joined(ranks, "shapes", shape)
    assert out.shape == (B, S, H) and np.isfinite(out).all()
    want = np.asarray(jax_ring(_sp_mesh(world), _bf16(q), _bf16(k), _bf16(v), jnp.asarray(bias), heads), np.float32)
    assert np.abs(want).max() < 2.0  # RING_TOL's premise
    assert np.abs(out - want).max() < RING_TOL
    assert np.abs(out - _plain(q, k, v, bias, heads)).max() < ATTN_TOL
    ref = np.asarray(_xla_attention(_bf16(q), _bf16(k), _bf16(v), jnp.asarray(bias), heads), np.float32)
    assert np.abs(out - ref).max() < ATTN_TOL


def test_bf16_ring_error_vs_f32_truth_stays_bounded(ranks, world):
    """The ring's blockwise online softmax must not accumulate error with
    the hops: bf16 within the f32 truth's envelope, and no ring position
    worse than 3x another (tests/test_ring_attention.py:86-89)."""
    B, S, H, heads = g.TRUTH_SHAPE
    q, k, v, bias = g.ring_inputs(B, S, H, 2, 0.95)
    truth = _plain(q, k, v, bias, heads, torch.float32)
    ring = _joined(ranks, "truth")
    err = np.abs(ring - truth)
    assert err.max() < TRUTH_TOL, err.max()
    per_block = err.reshape(B, world, S // world, H).max(axis=(0, 2, 3))
    assert per_block.max() < 3.0 * max(per_block.min(), 1e-3), per_block
    # in f32 end to end the ring is the plain attention and the JAX ring
    f32 = _joined(ranks, "f32")
    np.testing.assert_allclose(f32, truth, atol=F32_TOL, rtol=0)
    jf32 = jax_ring(_sp_mesh(world), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), heads)
    np.testing.assert_allclose(f32, np.asarray(jf32), atol=F32_TOL, rtol=0)


def test_masked_keys_do_not_leak_across_ring(ranks):
    """Keys masked on a remote rank's block must not influence any query."""
    out1 = _joined(ranks, "pin", 0)
    out2 = _joined(ranks, "pin", 1)
    assert np.abs(out1 - out2).max() < PIN_TOL


def test_rejects_indivisible_sequence(ranks, world):
    for res in ranks:
        assert res["indivisible"] == f"sequence length {g.INDIVISIBLE_S} not divisible by mesh axis {world}"


def test_ring_over_the_data_axis_of_a_2d_mesh(ranks, world):
    """On the ("data", "model") mesh the ring runs inside each data group
    (peers are group ranks turned into global ranks); model ranks hold the
    same blocks."""
    B, S, H, heads = g.RING_SHAPES[0]
    q, k, v, bias = g.ring_inputs(B, S, H, 3, 0.9)
    jmesh = jax_make_mesh(world)
    want = np.asarray(jax_ring(jmesh, _bf16(q), _bf16(k), _bf16(v), jnp.asarray(bias), heads, axis="data"), np.float32)
    data = jmesh.shape["data"]
    blk = S // data
    for res in ranks:
        d, _ = res["data_ring"]["coordinate"]
        got = res["data_ring"]["block"]
        assert got.shape == (B, blk, H)
        assert np.abs(got - want[:, d * blk : (d + 1) * blk]).max() < RING_TOL
    by_data = {}
    for res in ranks:
        by_data.setdefault(res["data_ring"]["coordinate"][0], []).append(res["data_ring"]["block"])
    for blocks in by_data.values():
        for b in blocks[1:]:
            np.testing.assert_array_equal(b, blocks[0])
