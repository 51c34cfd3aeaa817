"""The port's data- and tensor-parallel contrastive encoder step
(``parallel/train.py``'s ``init_train_state`` and
``make_contrastive_train_step`` with ``mesh=``) across a gloo world of 4
(``make_mesh`` gives ``(2, 2)``), against the JAX package's step on
``make_mesh(4)`` (the conftest's virtual CPU devices).

``tests/test_parallel.py:94-117``'s encoder config in f32, its tree drawn
once from a seed and given to both packages as numpy, the port's leaves
placed by ``shard_params``.  JAX's step-0 gradient is read from its first
Adam moment.  Pins (``tests/test_torch_train.py``'s): step-0 gradients at
relative L2 1e-5, leaf for leaf (so a constant factor from a collective's
backward fails), the key bias's (rounding noise in both packages) under
1e-6 of the whole gradient; the losses of 3 Adam steps at 1e-5 relative.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pathway_tpu.models import encoder as jenc  # noqa: E402
from pathway_tpu.parallel import make_contrastive_train_step as j_contrastive_step  # noqa: E402
from pathway_tpu.parallel import make_mesh, shard_params  # noqa: E402
from pathway_tpu.parallel import train as jtrain  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc  # noqa: E402
from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402
from tests.test_torch_dp_tp_train import first_grads, flat, rel_l2  # noqa: E402

ENCODER = dict(vocab_size=256, hidden=32, layers=1, heads=2, intermediate=64, max_len=32)  # test_parallel.py:100-102
LR = 1e-3
GRAD_TOL, LOSS_TOL = 1e-5, 1e-5
WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ids_a = rng.integers(1, 256, size=(16, 8))
    ids_b = rng.integers(1, 256, size=(16, 8))
    mask = np.ones((16, 8), np.int64)
    mask[::3, 4:] = 0  # padded rows: the masks reach pooling and attention
    return tenc.init_params(tenc.EncoderConfig(**ENCODER), 0), (ids_a, mask, ids_b, mask)


@pytest.fixture(scope="module")
def group(tmp_path_factory, inputs):
    params, batch = inputs
    started = g.RankGroup(gm.contrastive_mesh_case, WORLD, tmp_path_factory.mktemp("contrastive"), ENCODER,
                          params, batch)
    yield started
    started.stop()


@pytest.fixture(scope="module")
def want(inputs):
    """JAX's mesh step: the losses of 3 Adam steps and the first's gradient."""
    params, batch = inputs  # params: the Flax tree, {"params": ...}
    jmod = jenc.SentenceEncoderModule(jenc.EncoderConfig(**ENCODER, dtype=jnp.float32))
    mesh = make_mesh(WORLD)
    state = jtrain.TrainState(params=shard_params(params, mesh), opt_state=optax.adam(LR).init(params))
    step = j_contrastive_step(jmod, optax.adam(LR), mesh)
    out = dict(losses=[])
    for i in range(3):
        state, loss = step(state, *batch)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = flat(first_grads(state.opt_state)["params"], sep=".")
    return out


@pytest.fixture(scope="module")
def ranks(group, want):
    """The ranks' results, waited for after JAX's (computed meanwhile)."""
    return group.results()


def test_contrastive_mesh_grads_match_jax(ranks, want):
    jg = want["grads"]
    total = np.sqrt(sum(np.square(w).sum() for w in jg.values()))
    for res in ranks:
        assert res["shape"] == (2, 2)
        assert sorted(res["grads"]) == sorted(jg)
        for name, grad in res["grads"].items():
            if name.endswith("key.bias"):
                # softmax over keys is invariant to the key bias: both
                # gradients are rounding noise (tests/test_torch_train.py)
                assert max(np.linalg.norm(grad), np.linalg.norm(jg[name])) < 1e-6 * total, name
            else:
                assert rel_l2(grad, jg[name]) < GRAD_TOL, name


def test_contrastive_mesh_losses_match_jax(ranks, want):
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=LOSS_TOL)
        assert res["losses"][-1] < res["losses"][0]


def test_contrastive_params_follow_shard_params(ranks):
    for res in ranks:
        placements = res["placements"]
        # replicated over data; output features (or embedding rows) split over model
        assert all(p[0] == "R" for p in placements.values())
        split = [k for k, p in placements.items() if p[1].startswith("S(")]
        assert split and len(split) < len(placements)
        assert res["both"].startswith("ValueError") and "not both" in res["both"]


def test_contrastive_mesh_refuses_rows_that_do_not_split(ranks):
    """3 rows over ``data`` of 2 raise, as JAX's ``device_put`` onto
    ``P("data")`` does, instead of dropping the third row."""
    for res in ranks:
        assert res["uneven"] == "ValueError: dim 0 of size 3 does not split over 2 ranks"
