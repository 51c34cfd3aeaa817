"""The port's tensor-parallel decoder (``models/decoder.py``:
``tp_param_specs``, ``tp_cache_specs``, ``place_tp_params`` and the
forward of a placed tree) across gloo ranks, against the JAX package's
unsharded functions.

The spec trees are compared with JAX's leaf for leaf in the pytest
process.  One tree per config is drawn from a seed and given to both
packages as numpy; one gloo group per world size
(``tests/gloo_model_ranks.py``) places it on a ``("model",)`` mesh and
runs every case.  Pins: TP ``prefill`` and ``decode_step`` of
``pw-tiny-decoder`` at atol 1e-5 (``tests/test_decoder.py:262,270``); the
MoE decoder with its experts over ``model`` at 2e-4
(``tests/test_moe_decoder.py:126``), its decode step too; the placed
tree's training forward at the decoder pin 2e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from tests import gloo_model_ranks as gm  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

DENSE, MOE = "pw-tiny-decoder", "pw-tiny-moe-decoder"
TP_TOL = dict(rtol=0, atol=1e-5)  # tests/test_decoder.py:262,270
MOE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_moe_decoder.py:126
DECODER_TOL = dict(rtol=2e-4, atol=2e-4)
WORLDS = (1, 2)


def _case(name: str, rng, b: int, s: int, cache: int):
    cfg = jdec.decoder_config_for(name)
    tree = gm.seeded_decoder_tree(tdec.decoder_config_for(name), 3)
    ids = rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.array([s, s - 3][:b], np.int32)
    tok = rng.integers(1, cfg.vocab_size, size=(b,)).astype(np.int32)
    return tree, ids, lens, cache, tok


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(4)
    return {DENSE: _case(DENSE, rng, 2, 8, 16), MOE: _case(MOE, rng, 2, 6, 8)}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def groups(tmp_path_factory, cases):
    started = {w: g.RankGroup(gm.tp_decoder_cases, w, tmp_path_factory.mktemp(f"tp{w}"), cases) for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def ranks(world, groups, want):
    """The ranks' results, waited for after JAX's (computed meanwhile)."""
    return groups[world].results()


@pytest.fixture(scope="module")
def want(cases):
    """JAX's unsharded prefill, decode step and training forward."""
    out = {}
    for name, (tree, ids, lens, cache, tok) in cases.items():
        cfg = jdec.decoder_config_for(name)
        logits, kc, vc = jdec.prefill(tree, jnp.asarray(ids), jnp.asarray(lens), cfg, cache)
        step, _, _ = jdec.decode_step(tree, kc, vc, jnp.asarray(tok), jnp.asarray(lens), cfg)
        tl, taux = jdec.causal_lm_logits_and_aux(tree, jnp.asarray(ids), jnp.asarray(lens), cfg)
        out[name] = dict(prefill=np.asarray(logits), k_cache=np.asarray(kc), v_cache=np.asarray(vc),
                         decode=np.asarray(step), train_logits=np.asarray(tl), train_aux=float(taux))
    return out


def _specs(tree):
    if hasattr(tree, "items"):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", [DENSE, MOE])
@pytest.mark.parametrize("axis", ["model", "tp"])
def test_tp_specs_match_jax_leaf_for_leaf(name, axis):
    jcfg, tcfg = jdec.decoder_config_for(name), tdec.decoder_config_for(name)
    assert tdec.tp_param_specs(tcfg, axis) == _specs(jdec.tp_param_specs(jcfg, axis))
    assert tdec.tp_cache_specs(axis) == tuple(jdec.tp_cache_specs(axis))
    # the spec tree covers the param tree leaf for leaf
    tree = tdec.init_decoder_params(tcfg, 0, device="cpu")
    assert sorted(dict(tdec._leaf_items(tree))) == sorted(dict(tdec._leaf_items(tdec.tp_param_specs(tcfg, axis))))


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_prefill_matches_jax(ranks, want, name):
    tol = TP_TOL if name == DENSE else MOE_TOL
    for res in ranks:
        np.testing.assert_allclose(res[name]["prefill"], want[name]["prefill"], **tol)
        np.testing.assert_allclose(res[name]["replicated_prefill"], want[name]["prefill"], **tol)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_decode_step_matches_jax(ranks, want, name):
    tol = TP_TOL if name == DENSE else MOE_TOL
    for res in ranks:
        np.testing.assert_allclose(res[name]["decode"], want[name]["decode"], **tol)
        assert res[name]["cache_in_place"]  # the placed caches are written in place, as the plain ones are


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_cache_is_split_over_kv_heads(ranks, want, world, name):
    cfg = tdec.decoder_config_for(name)
    tol = TP_TOL if name == DENSE else MOE_TOL
    for res in ranks:
        r = res[name]
        assert r["cache_placements"] == ("S(3)",)
        assert r["cache_local"][3] == cfg.kv_heads // world
        np.testing.assert_allclose(r["k_cache"], want[name]["k_cache"], **tol)
        np.testing.assert_allclose(r["v_cache"], want[name]["v_cache"], **tol)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_leaves_hold_their_shards(ranks, world, name):
    cfg = tdec.decoder_config_for(name)
    tree = tdec.init_decoder_params(cfg, 0, device="cpu")
    specs = dict(tdec._leaf_items(tdec.tp_param_specs(cfg)))
    for res in ranks:
        for path, shape in res[name]["local_shapes"].items():
            path = tuple(path.split("/"))
            full = list(dict(tdec._leaf_items(tree))[path].shape)
            for d, axis in enumerate(specs[path]):
                if axis:
                    full[d] //= world
            assert shape == tuple(full), path


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_view_is_worked_out_at_placement(ranks, world, name):
    cfg = tdec.decoder_config_for(name)
    for res in ranks:
        assert res[name]["view_at_placement"]  # the steps reuse the placed tree's view, not a new one
        assert res[name]["view_heads"] == (cfg.heads // world, cfg.kv_heads // world)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_tp_training_forward_matches_jax(ranks, want, name):
    for res in ranks:
        np.testing.assert_allclose(res[name]["train_logits"], want[name]["train_logits"], **DECODER_TOL)
        np.testing.assert_allclose(res[name]["train_aux"], want[name]["train_aux"], **DECODER_TOL)


def test_int8_and_lora_trees_are_refused(ranks):
    for res in ranks:
        assert res["int8"].startswith("ValueError") and "LoRA or int8" in res["int8"]
        assert res["lora"].startswith("ValueError") and "LoRA or int8" in res["lora"]


def test_paged_path_and_mixed_trees_are_refused(ranks):
    for res in ranks:
        assert res["paged"].startswith("NotImplementedError") and "tensor-parallel" in res["paged"]
        assert res["mixed"].startswith("ValueError") and "lm_head" in res["mixed"]
        assert res["mixed_placed"] == res["mixed"]  # placement makes the same check, once
