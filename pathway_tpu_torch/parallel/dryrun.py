"""One step of every distributed path of the port, at tiny shapes.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: the same six
checks at the same shapes, run on each rank of a world of ``n`` (the
caller's process group; a single process with none makes a group of one
in memory, as every mesh does):

* the contrastive train step, data-parallel batch × tensor-parallel
  weights (``make_mesh``);
* the corpus-sharded index (``ShardedDeviceIndex``): each document is its
  own nearest neighbour;
* ring attention over a sequence-parallel ``("sp",)`` ring;
* the decoder's tensor-parallel serving step, prefill and one cached
  decode, with heads and FFN split over a ``("model",)`` mesh;
* one pipeline-parallel decoder train step (GPipe, one stage per rank);
* one expert-parallel MoE train step (``make_ep_mesh(n, n)``).

Each asserts that its result is finite and raises ``AssertionError``
otherwise; the index asserts its ids.  One difference from the JAX
function: the MoE layer has ``n`` experts, and at ``n = 1`` it routes
top-1, where JAX's ``lax.top_k`` refuses ``k = 2`` over one expert (so the
JAX dry run cannot run at one device, and the port's runs on one card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _check(ok: bool, what: str) -> None:
    if not ok:  # a real raise, not an assert: the checks hold under python -O too
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, *, device=None) -> None:
    """Run one step of each distributed path over a world of ``n_devices``
    ranks (this rank's part), at ``dryrun_multichip``'s shapes, on
    ``device`` (a card unless ``"cpu"``).  A world of another size
    raises."""
    from pathway_tpu_torch.models.decoder import DecoderConfig, decode_step, init_decoder_params, place_tp_params, prefill
    from pathway_tpu_torch.models.encoder import EncoderConfig, SentenceEncoderModule, init_params
    from pathway_tpu_torch.parallel.index import ShardedDeviceIndex
    from pathway_tpu_torch.parallel.mesh import make_mesh, mesh_device, world_mesh
    from pathway_tpu_torch.parallel.moe import MoEConfig, make_ep_mesh, make_moe_train_step
    from pathway_tpu_torch.parallel.pipeline import make_pp_mesh, make_pp_train_step
    from pathway_tpu_torch.parallel.ring_attention import ring_encoder_attention
    from pathway_tpu_torch.parallel.train import init_train_state, make_contrastive_train_step

    n = n_devices
    mesh = make_mesh(n, device=device)
    dev = mesh_device(mesh)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    adam = functools.partial(torch.optim.Adam, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)

    cfg = EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=2, intermediate=128, max_len=32)
    module = SentenceEncoderModule(cfg, init_params(cfg, 0), device=dev)
    state, _ = init_train_state(module, adamw, mesh=mesh)
    step = make_contrastive_train_step(module, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = 2 * n  # divisible by the data axis
    ids_a = rng.integers(1, 512, size=(batch, 16))
    ids_b = rng.integers(1, 512, size=(batch, 16))
    mask = np.ones((batch, 16), np.int64)
    state, loss = step(state, ids_a, mask, ids_b, mask)
    _check(np.isfinite(float(loss)), f"non-finite loss {loss!r}")

    index = ShardedDeviceIndex(mesh, 16, block=8)
    docs = rng.normal(size=(64, 16)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    index.add(docs)
    ids, scores = index.search(docs[:4], 3)
    _check(ids[:, 0].tolist() == [0, 1, 2, 3], f"index ids {ids}")
    _check(bool(np.isfinite(scores).all()), "non-finite index scores")

    sp_mesh = world_mesh((n,), ("sp",), device=dev)
    B, S, H, heads = 1, 8 * n, 128, 4
    q = torch.as_tensor(rng.normal(size=(B, S, H)), dtype=torch.bfloat16, device=dev)
    ctx = ring_encoder_attention(sp_mesh, q, q, q, torch.zeros((B, S), device=dev), heads)
    _check(bool(torch.isfinite(ctx.float()).all()), "non-finite ring attention")

    dcfg = DecoderConfig(vocab_size=128, hidden=8 * n, layers=2, heads=n, kv_heads=n, intermediate=16 * n,
                         max_len=64, dtype=torch.float32)
    tp_mesh = world_mesh((n,), ("model",), device=dev)
    tree = place_tp_params(init_decoder_params(dcfg, 0, device=dev), dcfg, tp_mesh)
    dids = torch.as_tensor(rng.integers(1, 128, size=(2, 8)), device=dev)
    dlens = torch.tensor([8, 5], device=dev)
    with torch.no_grad():
        logits, kc, vc = prefill(tree, dids, dlens, dcfg, 16)
        logits2, kc, vc = decode_step(tree, kc, vc, logits.argmax(-1), dlens, dcfg)
    _check(bool(torch.isfinite(logits2).all()), "non-finite tensor-parallel decode logits")

    pcfg = DecoderConfig(vocab_size=128, hidden=32, layers=n, heads=4, kv_heads=2, intermediate=64, max_len=32,
                         dtype=torch.float32)
    pp_init, pp_run = make_pp_train_step(pcfg, adam, make_pp_mesh(n, device=dev), n_micro=2)
    pids = rng.integers(1, 128, size=(4, 8))
    _, pp_loss = pp_run(pp_init(0), pids, np.full((4,), 8))
    _check(np.isfinite(float(pp_loss)), f"non-finite pipeline loss {pp_loss!r}")

    mcfg = MoEConfig(hidden=16, experts=n, intermediate=32, top_k=min(2, n))
    ep_init, ep_step = make_moe_train_step(mcfg, adam, mesh=make_ep_mesh(n, expert_parallel=n, device=dev))
    xtok = rng.normal(size=(8 * n, 16)).astype(np.float32)
    _, _, ep_loss = ep_step(*ep_init(0), xtok, np.tanh(xtok))
    _check(np.isfinite(float(ep_loss)), f"non-finite MoE loss {ep_loss!r}")
