"""Rank bodies of the port's tensor-, data-, expert- and pipeline-parallel
tests, run in gloo groups by ``tests/gloo_ranks.py``'s ``RankGroup``.

Like ``gloo_ranks.py`` this module imports no JAX and nothing of
``pathway_tpu``: the parent process builds each tree in JAX from a seed,
passes it here as numpy arrays, and holds the ranks' answers against the
JAX package.  Each body runs every case of its test file in one group.
Gradients are read inside the optimizer's first ``step`` (:class:`Capture`),
after the data-parallel reduction and before the update, gathered whole.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

LR = 1e-2


class Capture(torch.optim.Adam):
    """``torch.optim.Adam`` (``optax.adam``'s counterpart) that keeps the
    whole gradient of every leaf at its first step, in param order."""

    def step(self, closure=None):
        if not hasattr(self, "first_grads"):
            self.first_grads = [
                (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad.clone()).numpy()
                for g in self.param_groups for p in g["params"]
            ]
        return super().step(closure)


def capture(lr: float = LR):
    return functools.partial(Capture, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def named_grads(state) -> dict:
    """``{leaf name: first-step gradient}`` of a state built by
    ``train_state`` over a :class:`Capture` optimizer."""
    from pathway_tpu_torch.parallel.train import named_leaves

    names = [n for n, t in named_leaves(state.params).items() if t.requires_grad]
    return dict(zip(names, state.opt_state.first_grads))


def numpy_tree(tree):
    """A tree of tensors as nested dicts of numpy arrays (what the JAX
    package takes, and the ranks take back)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def seeded_decoder_tree(cfg, seed: int) -> dict:
    """``init_decoder_params(cfg, seed)`` of the port on the CPU, as numpy:
    one tree from a seed for both packages."""
    from pathway_tpu_torch.models.decoder import init_decoder_params

    return numpy_tree(init_decoder_params(cfg, seed, device="cpu"))


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError, FileExistsError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


# ---------------------------------------------------------------------------
# tests/test_torch_tp_decoder.py
# ---------------------------------------------------------------------------


def tp_decoder_cases(rank: int, world: int, cases: dict) -> dict:
    """Each case (config name, numpy tree, ids, lengths, cache length,
    decode token): TP ``prefill`` and one ``decode_step`` over a
    ``("model",)`` mesh, the view those steps took, the replicated tree's
    prefill, and the training forward; then the refusals."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.lora import lora_decoder_tree
    from pathway_tpu_torch.parallel import place_tree, world_mesh

    mesh = world_mesh((world,), ("model",), device="cpu")
    out: dict = {}
    for name, (tree_np, ids, lens, cache, tok) in cases.items():
        cfg = dec.decoder_config_for(name)
        tree = dec.from_jax_decoder_params(tree_np, cfg, "cpu")
        placed = dec.place_tp_params(tree, cfg, mesh)
        ids, lens, tok = torch.from_numpy(ids).long(), torch.from_numpy(lens).long(), torch.from_numpy(tok).long()
        with torch.no_grad():
            logits, kc, vc = dec.prefill(placed, ids, lens, cfg, cache)
            res = dict(
                prefill=logits.numpy(),
                cache_placements=tuple(str(p) for p in kc.placements),
                cache_local=tuple(kc.to_local().shape),
                k_cache=kc.full_tensor().clone().numpy(),
                v_cache=vc.full_tensor().clone().numpy(),
                local_shapes={"/".join(k): tuple(v.to_local().shape) for k, v in dec._leaf_items(placed)},
            )
            step, kc2, _ = dec.decode_step(placed, kc, vc, tok, lens, cfg)
            res["decode"] = step.numpy()
            res["cache_in_place"] = kc2 is kc
            res["view_at_placement"] = dec.shard_view(placed, cfg)[1] is placed.view
            res["view_heads"] = (placed.view.heads, placed.view.kv_heads)
            res["replicated_prefill"] = dec.prefill(place_tree(tree, mesh), ids, lens, cfg, cache)[0].numpy()
            tl, taux = dec.causal_lm_logits_and_aux(placed, ids, lens, cfg)
            res["train_logits"], res["train_aux"] = tl.numpy(), float(taux)
        out[name] = res
    cfg = dec.decoder_config_for("pw-tiny-decoder")
    tree = dec.init_decoder_params(cfg, 0, device="cpu")
    placed = dec.place_tp_params(tree, cfg, mesh)
    out["int8"] = _error(lambda: dec.place_tp_params(dec.quantize_decoder_tree(tree), cfg, mesh))
    out["lora"] = _error(lambda: dec.place_tp_params(lora_decoder_tree(tree, cfg, rank=2), cfg, mesh))
    pool = dec.init_kv_pool(cfg, 4, 8, "cpu")
    out["paged"] = _error(lambda: dec.paged_decode_step(
        placed, *pool, torch.ones((1, 2), dtype=torch.long), torch.zeros(1, dtype=torch.long),
        torch.ones(1, dtype=torch.long), cfg))
    mixed = {**placed, "lm_head": tree["lm_head"]}
    out["mixed"] = _error(lambda: dec.prefill(mixed, torch.ones((1, 4), dtype=torch.long), torch.tensor([4]), cfg, 8))
    out["mixed_placed"] = _error(lambda: dec.PlacedTree(mixed, cfg))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dp_tp_train.py and tests/test_torch_dp_contrastive.py
# ---------------------------------------------------------------------------

DP_STEPS = 3


def contrastive_mesh_case(rank: int, world: int, enc_cfg: dict, params_np: dict, batch) -> dict:
    """The contrastive step on ``make_mesh``: step-0 gradients and the
    losses of ``DP_STEPS`` Adam steps from the JAX tree."""
    from pathway_tpu_torch.models import encoder as tenc
    from pathway_tpu_torch.parallel import init_train_state, make_contrastive_train_step, make_mesh

    mesh = make_mesh(device="cpu")
    cfg = tenc.EncoderConfig(**enc_cfg, dtype=torch.float32)
    module = tenc.SentenceEncoderModule(cfg, params_np, device="cpu")
    state, _ = init_train_state(module, capture(1e-3), mesh=mesh)
    step = make_contrastive_train_step(module, mesh=mesh)
    losses = []
    for _ in range(DP_STEPS):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    grads = dict(zip(sorted(state.params), state.opt_state.first_grads))
    placements = {k: tuple(str(p) for p in v.placements) for k, v in state.params.items()}
    return dict(shape=tuple(mesh.shape), losses=losses, grads=grads, placements=placements,
                both=_error(lambda: make_contrastive_train_step(module, device="cpu", mesh=mesh)))


def lm_mesh_case(rank: int, world: int, trees: dict, ids, lens) -> dict:
    """The causal-LM step of each decoder on ``make_mesh``, from the JAX
    tree placed by ``tp_param_specs``: step-0 gradients and
    ``DP_STEPS`` losses."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import make_causal_lm_train_step, make_lm_step_runner, make_mesh
    from pathway_tpu_torch.parallel.train import train_state

    mesh = make_mesh(device="cpu")
    out: dict = {"shape": tuple(mesh.shape)}
    for name, tree_np in trees.items():
        cfg = dec.decoder_config_for(name)
        state = train_state(dec.place_tp_params(dec.from_jax_decoder_params(tree_np, cfg, "cpu"), cfg, mesh),
                            capture())
        run = make_lm_step_runner(cfg, mesh=mesh)
        losses = []
        for _ in range(DP_STEPS):
            state, loss = run(state, ids, lens)
            losses.append(float(loss))
        out[name] = dict(losses=losses, grads=named_grads(state), step=state.step)
    out["both"] = _error(lambda: make_causal_lm_train_step(cfg, capture(), device="cpu", mesh=mesh))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_ep.py
# ---------------------------------------------------------------------------


def moe_ep_cases(rank: int, world: int, ffn: tuple, train: tuple | None) -> dict:
    """``moe_ffn`` on ``make_ep_mesh(world)`` (and on a ``(2, 2)`` mesh at
    world 4, the rank's rows of the tokens), and at world 4 the EP train
    step on ``make_ep_mesh(4, expert_parallel=2)``."""
    from pathway_tpu_torch.parallel import make_ep_mesh, make_moe_train_step, moe_ffn, place_tree
    from pathway_tpu_torch.parallel.moe import MoEConfig, ep_param_specs
    from pathway_tpu_torch.parallel.train import train_state

    cfg_kw, params_np, x = ffn
    cfg = MoEConfig(**cfg_kw)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    out: dict = {}
    meshes = {"all_expert": make_ep_mesh(world, device="cpu")}
    if world == 4:
        meshes["data_expert"] = make_ep_mesh(4, expert_parallel=2, device="cpu")
    for key, mesh in meshes.items():
        n_data = mesh.size(0)
        rows = np.split(x, n_data)[mesh.get_local_rank("data")]
        y, aux = moe_ffn(place_tree(params, mesh, ep_param_specs()), torch.from_numpy(rows), cfg, mesh)
        out[key] = dict(shape=tuple(mesh.shape), y=y.numpy(), aux=float(aux), data=mesh.get_local_rank("data"))
    out["world"] = _error(lambda: make_ep_mesh(world + 1, device="cpu"))
    if train is not None:
        cfg_kw, params_np, xs, target, steps = train
        cfg = MoEConfig(**cfg_kw)
        mesh = meshes["data_expert"]
        _, step_fn = make_moe_train_step(cfg, capture(), mesh=mesh)
        state = train_state(place_tree({k: torch.from_numpy(v) for k, v in params_np.items()}, mesh,
                                       ep_param_specs()), capture())
        p, o, losses = state.params, state.opt_state, []
        for _ in range(steps):
            p, o, loss = step_fn(p, o, xs, target)
            losses.append(float(loss))
        out["train"] = dict(losses=losses, grads=dict(zip(sorted(p), o.first_grads)),
                            local=tuple(p["wg"].to_local().shape))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------


def pipeline_cases(rank: int, world: int, forwards: dict, training: tuple) -> dict:
    """Each forward case (config fields, numpy tree, ids, lengths,
    ``n_micro``) through ``make_pipelined_causal_lm`` on
    ``make_pp_mesh(world)``, then ``DP_STEPS`` steps of
    ``make_pp_train_step``'s ``run`` from the JAX tree, with step-0
    gradients, and the unpipelined step's from the same tree and batch."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.parallel import (
        make_lm_step_runner,
        make_pipelined_causal_lm,
        make_pp_mesh,
        make_pp_train_step,
        place_pp_params,
    )
    from pathway_tpu_torch.parallel.train import train_state

    mesh = make_pp_mesh(world, device="cpu")
    out: dict = {"world": _error(lambda: make_pp_mesh(world + 1, device="cpu"))}
    for key, (fields, tree_np, ids, lens, n_micro) in forwards.items():
        cfg = dec.DecoderConfig(**fields, dtype=torch.float32)
        placed = place_pp_params(dec.from_jax_decoder_params(tree_np, cfg, "cpu"), mesh)
        with torch.no_grad():
            got = make_pipelined_causal_lm(cfg, mesh, n_micro)(placed, torch.from_numpy(ids).long(),
                                                               torch.from_numpy(lens).long())
        out[key] = dict(logits=got.numpy(), local_layers=tuple(placed["layers"]["wq"].to_local().shape))
        if key == "remat":  # and a remat step's gradients against the plain forward's
            grads = {}
            for remat in (False, True):
                state = train_state(place_pp_params(dec.from_jax_decoder_params(
                    tree_np, dataclasses.replace(cfg, remat=remat), "cpu"), mesh), capture())
                _, run = make_pp_train_step(dataclasses.replace(cfg, remat=remat), capture(), mesh, n_micro)
                state, _ = run(state, ids, lens)
                grads[remat] = named_grads(state)
            out[key]["remat_grads"] = grads
    fields, tree_np, ids, lens, n_micro = training
    cfg = dec.DecoderConfig(**fields, dtype=torch.float32)
    _, run = make_pp_train_step(cfg, capture(), mesh, n_micro)
    state = train_state(place_pp_params(dec.from_jax_decoder_params(tree_np, cfg, "cpu"), mesh), capture())
    losses = []
    for _ in range(DP_STEPS):
        state, loss = run(state, ids, lens)
        losses.append(float(loss))
    # the unpipelined step on one device, from the same tree and batch
    plain = train_state(dec.from_jax_decoder_params(tree_np, cfg, "cpu"), capture())
    plain, plain_loss = make_lm_step_runner(cfg, device="cpu")(plain, ids, lens)
    out["train"] = dict(losses=losses, grads=named_grads(state), step=state.step, plain_loss=float(plain_loss),
                        plain_grads=named_grads(plain))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dryrun.py
# ---------------------------------------------------------------------------


def dryrun_case(rank: int, world: int) -> str:
    from pathway_tpu_torch.parallel import dryrun_multichip

    dryrun_multichip(world, device="cpu")
    return _error(lambda: dryrun_multichip(world + 1, device="cpu"))


# ---------------------------------------------------------------------------
# tests/test_torch_train_checkpoint.py
# ---------------------------------------------------------------------------


def sharded_checkpoint_case(rank: int, world: int, directory: str) -> dict:
    """A tensor-parallel causal-LM state and a replicated LoRA state on
    ``make_mesh``: saved through ``torch.distributed.checkpoint`` after 2
    steps, then 2 more steps, against a fresh state restored from the save
    and run 2 steps."""
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.lora import make_lora_train_step
    from pathway_tpu_torch.parallel import TrainCheckpointer, make_causal_lm_train_step, make_mesh

    mesh = make_mesh(device="cpu")
    cfg = dec.decoder_config_for("pw-tiny-decoder")
    adam = functools.partial(torch.optim.Adam, lr=LR)
    ids = np.random.default_rng(5).integers(1, cfg.vocab_size, size=(4, 12))
    lens = np.array([12, 9, 7, 2])
    out: dict = {}
    init_lm, run_lm = make_causal_lm_train_step(cfg, adam, mesh=mesh)
    base = dec.init_decoder_params(cfg, 11, device="cpu")
    init_lora, run_lora = make_lora_train_step(cfg, base, adam, mesh=mesh, rank=2)
    for key, init, run in (("lm", lambda: init_lm(0), run_lm), ("lora", init_lora, run_lora)):
        path = os.path.join(directory, key)
        state = init()
        for _ in range(2):
            state, _ = run(state, ids, lens)
        with TrainCheckpointer(path) as ck:
            ck.save(state)
            again = _error(lambda: ck.save(state))
            after = [float(run(state, ids, lens)[1]) for _ in range(2)]
            fresh = init_lm(7) if key == "lm" else init_lora()
            restored = ck.restore(fresh)
            resumed = [float(run(restored, ids, lens)[1]) for _ in range(2)]
            meta = torch.load(os.path.join(path, "2", "meta.pt"), weights_only=True)
            out[key] = dict(after=after, resumed=resumed, restored_step=int(restored.step), steps=ck.all_steps(),
                            trainable=len(meta["trainable"]), frozen=len(meta["frozen"]),
                            files=sorted(os.listdir(os.path.join(path, "2"))), again=again,
                            same_tensors=all(a is b for a, b in zip(restored.params["layers"].values(),
                                                                    fresh.params["layers"].values())))
    return out
