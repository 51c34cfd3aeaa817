"""The port's mixture-of-experts layer against the JAX package's.

``pathway_tpu_torch/parallel/moe.py`` beside ``pathway_tpu/parallel/moe.py``:
the routing tensors (dispatch, combine, aux), ``moe_ffn`` with dropping,
``full_capacity``, grouped dispatch (a padded ragged tail group) and the
serving group map, float and int8 expert weights.  Weights and inputs
come from numpy with a seed; the port runs on the CPU.  Everything is held at the reference's own
pin, 1e-5 (``tests/test_moe.py``).

Router logits are continuous random draws, so no two probabilities of a
token tie; where a test makes ties on purpose (uniform logits), the port's
stable descending sort picks the lower expert first, as ``lax.top_k`` does,
and the test checks that it does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu.parallel import moe as jmoe  # noqa: E402
from pathway_tpu_torch.parallel import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX references, compiled once per config
J_MOE = jax.jit(jmoe.moe_ffn, static_argnums=(2,), static_argnames=("full_capacity",))
J_ROUTING = jax.jit(jmoe._routing, static_argnums=(1, 2))


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _to_torch(tree):
    if hasattr(tree, "items"):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(a.copy() if a.dtype == np.int8 else a.astype(np.float32))


def _params(cfg, seed):
    """Scaled-normal weights from numpy (the JAX init's shapes and scales),
    as the JAX tree (numpy arrays) and the port's."""
    rng = np.random.default_rng(seed)
    E, H, F = cfg.experts, cfg.hidden, cfg.intermediate

    def normal(shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    jp = {"router": normal((H, E), H), "wg": normal((E, H, F), H),
          "wu": normal((E, H, F), H), "wd": normal((E, F, H), F)}
    return jp, _to_torch(jp)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dense_swiglu(x, wg, wu, wd):
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


@pytest.mark.parametrize("kw,n", [
    (dict(hidden=8, experts=4, intermediate=16, top_k=2), 32),
    (dict(hidden=8, experts=4, intermediate=16, top_k=1, capacity_factor=0.5), 16),
    (dict(hidden=8, experts=8, intermediate=16, top_k=2, capacity_factor=2.0), 7),
    (dict(hidden=8, experts=8, intermediate=16, top_k=2), 1),
])
def test_config_capacity_matches_jax(kw, n):
    jc, tc = _cfgs(**kw)
    assert tc.capacity(n) == jc.capacity(n)
    assert (tc.group_size, tc.serving_group_size) == (jc.group_size, jc.serving_group_size) == (4096, 1024)


def test_init_shapes_and_scales_match_jax():
    jc, tc = _cfgs(hidden=16, experts=4, intermediate=32)
    want = jax.eval_shape(lambda: jmoe.init_moe_params(jc, seed=0))
    got = tmoe.init_moe_params(tc, seed=0, device="cpu")
    assert set(got) == set(want)
    for name, w in got.items():
        assert tuple(w.shape) == want[name].shape, name
        fan_in = w.shape[-2]
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.15, name
    assert got["router"].dtype == torch.float32
    assert torch.equal(tmoe.init_moe_params(tc, seed=0, device="cpu")["wg"], got["wg"])


@pytest.mark.parametrize("T,E,K,capacity,masked", [
    (16, 4, 2, 16, False),  # ample capacity
    (16, 4, 2, 5, False),  # overflow: second choices drop first
    (24, 8, 2, 7, True),  # padding tokens masked out
    (9, 4, 1, 3, True),
    (5, 8, 2, 5, False),
])
def test_routing_matches_jax(T, E, K, capacity, masked):
    jc, tc = _cfgs(hidden=8, experts=E, intermediate=16, top_k=K)
    rng = np.random.default_rng(T * 100 + capacity)
    logits = rng.normal(size=(T, E)).astype(np.float32) * 2
    valid = rng.random(T) < 0.7 if masked else None
    jd, jcomb, jaux = J_ROUTING(jnp.asarray(logits), jc, capacity,
                                    None if valid is None else jnp.asarray(valid))
    td, tcomb, taux = tmoe._routing(torch.from_numpy(logits), tc, capacity,
                                    None if valid is None else torch.from_numpy(valid))
    assert tuple(td.shape) == jd.shape == (T, E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_routing_takes_a_group_axis():
    """A leading group axis gives each group's own routing."""
    _, tc = _cfgs(hidden=8, experts=4, intermediate=16)
    logits = torch.from_numpy(_x(1, (3, 10, 4)))
    valid = torch.from_numpy(np.random.default_rng(2).random((3, 10)) < 0.8)
    d, c, a = tmoe._routing(logits, tc, 6, valid)
    for g in range(3):
        dg, cg, ag = tmoe._routing(logits[g], tc, 6, valid[g])
        assert torch.equal(d[g], dg) and torch.equal(c[g], cg)
        assert float(a[g]) == pytest.approx(float(ag), abs=1e-7)


def test_routing_ties_pick_the_lower_expert_and_aux_prefers_uniform():
    """Uniform logits tie every expert: the port picks expert 0 as
    ``lax.top_k`` does, and the aux loss is 1 (its minimum); collapsed
    routing scores about E."""
    jc, tc = _cfgs(hidden=4, experts=4, intermediate=8, top_k=1)
    uniform = np.zeros((32, 4), np.float32)
    jd, _, jaux = J_ROUTING(jnp.asarray(uniform), jc, 32)
    td, _, taux = tmoe._routing(torch.from_numpy(uniform), tc, capacity=32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(taux) == pytest.approx(1.0, abs=1e-4) == float(jaux)
    collapsed = uniform.copy()
    collapsed[:, 0] = 50.0
    assert float(tmoe._routing(torch.from_numpy(collapsed), tc, capacity=32)[2]) == pytest.approx(4.0, abs=1e-2)


CASES = {
    # name: (config kwargs, token shape, full_capacity)
    "drop": (dict(hidden=8, experts=4, intermediate=16, top_k=2), (32, 8), False),
    "drop_tight": (dict(hidden=8, experts=4, intermediate=16, top_k=2, capacity_factor=0.5), (32, 8), False),
    "full_capacity": (dict(hidden=8, experts=4, intermediate=16, top_k=2, capacity_factor=0.1), (24, 8), True),
    "grouped_ragged": (dict(hidden=8, experts=4, intermediate=16, top_k=2, capacity_factor=8.0, group_size=7),
                       (32, 8), False),
    "serving_group_map": (dict(hidden=8, experts=4, intermediate=16, top_k=2, group_size=0, serving_group_size=7),
                          (32, 8), True),
    "batch_axes": (dict(hidden=16, experts=4, intermediate=32, top_k=2, capacity_factor=8.0), (6, 5, 16), False),
    "top1_eight_experts": (dict(hidden=8, experts=8, intermediate=16, top_k=1), (40, 8), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_jax(name):
    kw, shape, full = CASES[name]
    jc, tc = _cfgs(**kw)
    jp, tp = _params(jc, seed=sorted(CASES).index(name))
    x = _x(7, shape)
    jy, jaux = J_MOE(jp, jnp.asarray(x), jc, full_capacity=full)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tc, full_capacity=full)
    assert tuple(ty.shape) == shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_identical_experts_match_dense_ffn():
    jc, tc = _cfgs(hidden=16, experts=4, intermediate=32, top_k=2, capacity_factor=8.0)
    _, tp = _params(jc, seed=0)
    for name in ("wg", "wu", "wd"):
        tp[name] = tp[name][:1].expand_as(tp[name]).contiguous()
    x = torch.from_numpy(_x(1, (6, 5, 16)))
    y, aux = tmoe.moe_ffn(tp, x, tc)
    want = _dense_swiglu(x.reshape(-1, 16), tp["wg"][0], tp["wu"][0], tp["wd"][0]).reshape(x.shape)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    assert np.isfinite(float(aux))


def test_capacity_overflow_drops_not_corrupts():
    """Every token's top choice is expert 0, which has C < 16 slots: the
    first C tokens get its output, the rest exactly zero."""
    jc, tc = _cfgs(hidden=8, experts=4, intermediate=16, top_k=1, capacity_factor=0.5)
    jp, tp = _params(jc, seed=4)
    tp["router"] = torch.zeros_like(tp["router"])
    tp["router"][:, 0] = 100.0
    jp = dict(jp, router=tp["router"].numpy())
    x = 0.1 + np.abs(_x(5, (16, 8)))
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tc)
    C = tc.capacity(16)
    assert C < 16
    head = _dense_swiglu(torch.from_numpy(x[:C]), tp["wg"][0], tp["wu"][0], tp["wd"][0])
    np.testing.assert_allclose(y[:C].numpy(), head.numpy(), **TOL)
    np.testing.assert_allclose(y[C:].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(J_MOE(jp, jnp.asarray(x), jc)[0]), **TOL)


def test_full_capacity_never_drops():
    jc, tc = _cfgs(hidden=8, experts=4, intermediate=16, top_k=2, capacity_factor=0.1)
    _, tp = _params(jc, seed=10)
    for name in ("wg", "wu", "wd"):
        tp[name] = tp[name][:1].expand_as(tp[name]).contiguous()
    x = torch.from_numpy(_x(11, (24, 8)))
    want = _dense_swiglu(x, tp["wg"][0], tp["wu"][0], tp["wd"][0])
    y, _ = tmoe.moe_ffn(tp, x, tc, full_capacity=True)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    y_drop, _ = tmoe.moe_ffn(tp, x, tc)
    assert not np.allclose(y_drop.numpy(), want.numpy(), atol=1e-3)


@pytest.mark.parametrize("field,full", [("group_size", False), ("serving_group_size", True)])
def test_grouping_matches_single_group(field, full):
    """Grouped dispatch (five groups of 7, a tail padded by 3) gives the
    one-group output when no token can drop: ample capacity, or
    ``full_capacity`` with the groups run one at a time."""
    base = tmoe.MoEConfig(hidden=8, experts=4, intermediate=16, top_k=2, capacity_factor=8.0,
                          group_size=0, serving_group_size=0)
    grouped = dataclasses.replace(base, **{field: 7})
    tp = tmoe.init_moe_params(base, seed=8, device="cpu")
    x = torch.from_numpy(_x(9, (32, 8)))
    y_single, _ = tmoe.moe_ffn(tp, x, base, full_capacity=full)
    y_grouped, aux = tmoe.moe_ffn(tp, x, grouped, full_capacity=full)
    np.testing.assert_allclose(y_grouped.numpy(), y_single.numpy(), **TOL)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("full", [False, True])
def test_int8_expert_tree_matches_jax(full):
    """Expert weights as the JAX package's int8 pairs (``quantize_decoder_tree``
    codes and scales), carried across unchanged: the same output."""
    jc, tc = _cfgs(hidden=16, experts=4, intermediate=32, top_k=2, group_size=9)
    jp, _ = _params(jc, seed=3)
    wrapper = {"embed": np.zeros((1, 16), np.float32), "final_norm": np.ones(16, np.float32),
               "lm_head": np.zeros((16, 1), np.float32),
               "layers": {name: jp[name] for name in ("wg", "wu", "wd")}}
    jq = jax.device_get(jdec.quantize_decoder_tree(wrapper))["layers"]
    jqp = dict(jq, router=jp["router"])
    tqp = _to_torch(jqp)
    assert tqp["wg"]["q"].dtype == torch.int8 and tqp["wg"]["s"].shape == (4, 1, 32)
    x = _x(4, (20, 16))
    jy, jaux = J_MOE(jqp, jnp.asarray(x), jc, full_capacity=full)
    ty, taux = tmoe.moe_ffn(tqp, torch.from_numpy(x), tc, full_capacity=full)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # and the int8 layer stays close to the float one it quantizes
    fy, _ = tmoe.moe_ffn(_to_torch(jp), torch.from_numpy(x), tc, full_capacity=full)
    assert float((ty - fy).norm() / fy.norm()) < 0.05


def test_bf16_activations_keep_the_router_in_f32():
    """In bf16 the router still decides in f32: the same experts as the f32
    layer on the same (bf16-representable) tokens, and an output within
    bf16 rounding of it."""
    _, tc = _cfgs(hidden=16, experts=4, intermediate=32, top_k=2)
    tp = tmoe.init_moe_params(tc, seed=5, device="cpu")
    bc = dataclasses.replace(tc, dtype=torch.bfloat16)
    bp = {k: (v if k == "router" else v.to(torch.bfloat16)) for k, v in tp.items()}
    x = torch.from_numpy(_x(6, (12, 16))).to(torch.bfloat16)
    yb, _ = tmoe.moe_ffn(bp, x, bc, full_capacity=True)
    yf, _ = tmoe.moe_ffn({k: v.float() for k, v in bp.items()}, x.float(), tc, full_capacity=True)
    assert yb.dtype == torch.bfloat16
    assert float((yb.float() - yf).norm() / yf.norm()) < 2e-2
