"""The port's ``TrainCheckpointer`` (``parallel/checkpoint.py``): the
counterparts of ``tests/test_train_checkpoint.py``, on the CPU.

Pinned: a round trip keeps every value (params and the optimizer's
state) and the like-state's devices and dtypes; a resumed run continues
the same trajectory (identical CPU losses); retention prunes and the
latest step wins; an MoE decoder state round-trips over a different
init; restoring with no checkpoint raises.  Beyond the JAX package's:
a LoRA state writes its adapters and not its frozen base and resumes,
saves are atomic and never overwrite, and a like-state of another
structure is refused.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.models import encoder as tenc  # noqa: E402
from pathway_tpu_torch.models import lora as tlora  # noqa: E402
from pathway_tpu_torch.parallel import (  # noqa: E402
    TrainCheckpointer,
    init_train_state,
    make_causal_lm_train_step,
    make_contrastive_train_step,
)
from pathway_tpu_torch.parallel.train import named_leaves  # noqa: E402

CFG = tenc.EncoderConfig(vocab_size=256, hidden=32, layers=2, heads=2, intermediate=64, max_len=32,
                         dtype=torch.float32)
ADAM = functools.partial(torch.optim.Adam, lr=1e-3)


def _setup(seed=0, dtype=torch.float32):
    module = tenc.SentenceEncoderModule(CFG, tenc.init_params(CFG, seed), device="cpu")
    if dtype != torch.float32:
        module = module.to(dtype)
    state, _ = init_train_state(module, ADAM, device="cpu")
    return state, make_contrastive_train_step(module, device="cpu")


def _batch(rng, n=16):
    return rng.integers(1, 256, size=(n, 16)).astype(np.int32), np.ones((n, 16), np.int32)


def _assert_trees_equal(a, b):
    fa, fb = named_leaves(a), named_leaves(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name


def _assert_opt_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)


def test_roundtrip_preserves_values_and_placement(tmp_path):
    state, step = _setup()
    ids, mask = _batch(np.random.default_rng(0))
    state, _ = step(state, ids, mask, ids, mask)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        assert ck.save(state) == 1
        fresh, _ = _setup(seed=5)
        restored = ck.restore(fresh)
    assert restored.step == state.step == 1
    _assert_trees_equal(restored.params, state.params)
    _assert_opt_equal(restored.opt_state, state.opt_state)
    # the like-state's own tensors, on its device, still trainable
    for name, t in restored.params.items():
        assert t is fresh.params[name] and t.device.type == "cpu" and t.requires_grad


def test_restore_casts_onto_the_like_dtypes(tmp_path):
    state, step = _setup()
    ids, mask = _batch(np.random.default_rng(4))
    state, _ = step(state, ids, mask, ids, mask)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        like, _ = _setup(seed=5, dtype=torch.bfloat16)
        restored = ck.restore(like)
    for name, t in restored.params.items():
        assert t.dtype == torch.bfloat16
        torch.testing.assert_close(t, state.params[name].to(torch.bfloat16), rtol=0, atol=0)
    moments = restored.opt_state.state_dict()["state"][0]
    assert moments["exp_avg"].dtype == torch.bfloat16


def test_resume_continues_the_same_trajectory(tmp_path):
    state, step = _setup()
    rng = np.random.default_rng(1)
    ids, mask = _batch(rng)
    ids2, mask2 = _batch(rng)
    losses = []
    for _ in range(3):
        state, loss = step(state, ids, mask, ids2, mask2)
        losses.append(float(loss))
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        fresh, step2 = _setup(seed=9)
        resumed = ck.restore(fresh)
    resumed, loss_resumed = step2(resumed, ids, mask, ids2, mask2)
    state, loss_orig = step(state, ids, mask, ids2, mask2)
    assert float(loss_resumed) == float(loss_orig)  # the same trajectory, bit for bit
    assert float(loss_resumed) < losses[0]
    assert resumed.step == state.step == 4


def test_retention_prunes_and_latest_wins(tmp_path):
    state, step = _setup()
    ids, mask = _batch(np.random.default_rng(2))
    with TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2) as ck:
        for _ in range(4):
            state, _ = step(state, ids, mask, ids, mask)
            ck.save(state)
        assert ck.all_steps() == [3, 4]
        assert ck.latest_step() == 4
        assert sorted(os.listdir(ck.directory)) == ["3", "4"]  # no temporary left behind
        fresh, _ = _setup()
        assert ck.restore(fresh).step == 4
        assert ck.restore(fresh, step=3).step == 3


def test_a_saved_step_is_never_overwritten(tmp_path):
    state, _ = _setup()
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        with pytest.raises(FileExistsError):
            ck.save(state)
        assert ck.all_steps() == [0]


def test_moe_decoder_state_roundtrip(tmp_path):
    cfg = tdec.decoder_config_for("pw-tiny-moe-decoder")
    init_state, run = make_causal_lm_train_step(cfg, functools.partial(torch.optim.Adam, lr=1e-2), device="cpu")
    state = init_state(seed=0)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, cfg.vocab_size, size=(8, 12))
    lens = np.full(8, 12)
    state, _ = run(state, ids, lens)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        fresh = init_state(seed=7)  # a different init: every leaf must be overwritten
        restored = ck.restore(fresh)
    _assert_trees_equal(restored.params, state.params)
    restored, loss = run(restored, ids, lens)
    state, want = run(state, ids, lens)
    assert np.isfinite(float(loss)) and float(loss) == float(want)


def test_lora_state_writes_its_adapters_and_resumes(tmp_path):
    """The frozen base is the caller's: only the adapters and the
    optimizer state are written, and a fresh ``init_state`` over the same
    base resumes the run bit for bit."""
    cfg = tdec.decoder_config_for("pw-tiny-decoder")
    base = tdec.init_decoder_params(cfg, 1, device="cpu")
    init_state, run = tlora.make_lora_train_step(cfg, base, functools.partial(torch.optim.Adam, lr=1e-2),
                                                 device="cpu", rank=4)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(1, cfg.vocab_size, size=(4, 10)), np.full(4, 10)) for _ in range(4)]
    state = init_state()
    for ids, lens in batches[:2]:
        state, _ = run(state, ids, lens)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        saved = torch.load(os.path.join(ck.directory, "2", "state.pt"), weights_only=True)
        resumed = ck.restore(init_state())
    written = set(saved["params"])
    assert written == {f"layers/{t}/{k}" for t in tlora.DEFAULT_TARGETS for k in ("a", "b")}
    assert "embed" in saved["frozen"] and "layers/wq/w" in saved["frozen"]
    for ids, lens in batches[2:]:
        state, want = run(state, ids, lens)
        resumed, got = run(resumed, ids, lens)
        assert float(got) == float(want)
    _assert_trees_equal(resumed.params, state.params)


def test_restore_refuses_another_structure(tmp_path):
    state, _ = _setup()
    cfg = tdec.decoder_config_for("pw-tiny-decoder")
    other = make_causal_lm_train_step(cfg, ADAM, device="cpu")[0](seed=0)
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ck:
        ck.save(state)
        with pytest.raises(ValueError, match="other leaves"):
            ck.restore(other)


def test_restore_without_checkpoint_raises(tmp_path):
    fresh, _ = _setup()
    with TrainCheckpointer(str(tmp_path / "none")) as ck:
        assert ck.latest_step() is None and ck.all_steps() == []
        with pytest.raises(FileNotFoundError):
            ck.restore(fresh)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    from tests import gloo_model_ranks as gm
    from tests import gloo_ranks as g

    tmp = tmp_path_factory.mktemp("sharded")
    return g.run_ranks(gm.sharded_checkpoint_case, 2, tmp, str(tmp / "ckpt"))


@pytest.mark.parametrize("key", ["lm", "lora"])
def test_sharded_state_resumes_bit_for_bit_across_ranks(sharded, key):
    """A mesh-placed state (tensor-parallel causal LM; replicated LoRA) at
    world 2, saved through ``torch.distributed.checkpoint`` by both ranks
    and restored into a fresh state: the resumed losses are the
    uninterrupted run's, bit for bit, on every rank."""
    for res in sharded:
        r = res[key]
        assert r["resumed"] == r["after"] and r["restored_step"] == 2 and r["steps"] == [2]
        assert r["same_tensors"]  # restored into the like-state's own tensors
        assert r["again"].startswith("FileExistsError")  # a saved step is never overwritten
        # each rank wrote its own shards; rank 0 the metadata
        assert r["files"] == [".metadata", "__0_0.distcp", "__1_0.distcp", "meta.pt"]
    lm, lora = sharded[0]["lm"], sharded[0]["lora"]
    assert (lm["trainable"], lm["frozen"]) == (12, 0)
    # the LoRA state writes its wq/wv adapters (a and b) and not its 12 frozen base leaves
    assert (lora["trainable"], lora["frozen"]) == (4, 12)
