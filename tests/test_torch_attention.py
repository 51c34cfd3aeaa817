"""The port's encoder attention on the CPU against the JAX package's.

On a CPU tensor the port's ``encoder_attention`` runs its plain PyTorch
version; it is held against the JAX plain path (``_xla_attention``) and
against the Pallas kernel run in interpret mode, with the JAX test suite's
own tolerances (``tests/test_attention_kernel.py``).  The CUDA kernel itself
is held against the same plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.ops import attention as jattn  # noqa: E402
from pathway_tpu_torch.ops import attention as tattn  # noqa: E402

SHAPES = [
    (4, 64, 384, 12),  # MiniLM chunk shape
    (2, 128, 768, 12),  # BGE-base
    (8, 16, 384, 12),  # tiny bucket
    (1, 256, 1024, 16),  # mxbai-large
    (3, 64, 384, 12),  # batch not divisible by the TPU kernel's block
]
TOL = 0.05  # the JAX suite's kernel-vs-XLA pin: bf16 probabilities round differently
PIN = 1e-3


def _qkv(rng, B, S, H):
    return [rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(3)]


def _tail_mask(B, S):
    mask = np.zeros((B, S), np.float32)
    mask[:, int(S * 0.8) :] = -1e9  # padded tail keys
    return mask


def _port(q, k, v, mask, heads):
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    return tattn.encoder_attention(*bf, torch.from_numpy(mask), heads)


def _jax(q, k, v, mask, heads, interpret):
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    if interpret:
        return jattn.encoder_attention(*bf, jnp.asarray(mask), heads, interpret=True)
    return jattn._xla_attention(*bf, jnp.asarray(mask), heads)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("B,S,H,heads", SHAPES)
def test_cpu_attention_matches_jax(B, S, H, heads, interpret):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, S, H)
    mask = _tail_mask(B, S)
    out = _port(q, k, v, mask, heads)
    assert out.shape == (B, S, H) and out.dtype == torch.bfloat16
    err = np.abs(_f32(out) - _f32(_jax(q, k, v, mask, heads, interpret))).max()
    assert err < TOL, err


def test_masked_keys_do_not_move_the_output():
    rng = np.random.default_rng(1)
    B, S, H, heads = 2, 64, 384, 12
    q, k, v = _qkv(rng, B, S, H)
    mask = np.zeros((B, S), np.float32)
    mask[:, 32:] = -1e9
    out1 = _port(q, k, v, mask, heads)
    k2, v2 = k.copy(), v.copy()
    k2[:, 32:, :] = 99.0
    v2[:, 32:, :] = -99.0
    out2 = _port(q, k2, v2, mask, heads)
    assert np.abs(_f32(out1) - _f32(out2)).max() < PIN


def test_no_cross_sequence_leakage():
    rng = np.random.default_rng(2)
    B, S, H, heads = 8, 16, 384, 12
    q, k, v = _qkv(rng, B, S, H)
    mask = np.zeros((B, S), np.float32)
    full = _port(q, k, v, mask, heads)
    solo = _port(q[:1], k[:1], v[:1], mask[:1], heads)
    assert np.abs(_f32(full[0]) - _f32(solo[0])).max() < PIN


def test_strided_views_of_fused_qkv():
    """q, k, v as column views of one ``[B*S, 3H]`` tensor, as the trunk's
    fused projection leaves them: same result as contiguous copies."""
    rng = np.random.default_rng(3)
    B, S, H, heads = 3, 32, 384, 12
    qkv = torch.from_numpy(rng.normal(size=(B * S, 3 * H)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (qkv[:, i * H : (i + 1) * H].reshape(B, S, H) for i in range(3))
    assert q.stride() == (S * 3 * H, 3 * H, 1)  # a view, not a copy
    mask = _tail_mask(B, S)
    out = tattn.encoder_attention(q, k, v, torch.from_numpy(mask), heads)
    dense = tattn.encoder_attention(q.contiguous(), k.contiguous(), v.contiguous(), torch.from_numpy(mask), heads)
    assert torch.equal(out, dense)
    ref = jattn._xla_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)), jnp.asarray(mask), heads
    )
    assert np.abs(_f32(out) - _f32(ref)).max() < TOL


def test_all_masked_row_is_finite_and_matches():
    """A batch-padding row (every key masked) softmaxes uniformly over its
    own keys, as ``_xla_attention`` does: finite, the mean of its v."""
    rng = np.random.default_rng(4)
    B, S, H, heads = 3, 16, 128, 4
    q, k, v = _qkv(rng, B, S, H)
    mask = _tail_mask(B, S)
    mask[2, :] = -1e9
    out = _f32(_port(q, k, v, mask, heads))
    assert np.isfinite(out).all()
    assert np.abs(out - _f32(_jax(q, k, v, mask, heads, False))).max() < TOL
    v_mean = _f32(torch.from_numpy(v[2]).to(torch.bfloat16)).mean(0)
    assert np.abs(out[2] - v_mean[None, :]).max() < TOL
    # the Pallas kernel packs several sequences per program, and an
    # all-masked row there also weighs the other packed sequences' keys
    # (its output is discarded by the caller); the real rows agree
    pallas = _f32(_jax(q, k, v, mask, heads, True))
    assert np.isfinite(pallas).all()
    assert np.abs(out[:2] - pallas[:2]).max() < TOL


def test_plain_version_keeps_f32_inputs():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 16, 128))
    out = tattn.encoder_attention_reference(q, k, v, torch.zeros(2, 16), 4)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 128)


@pytest.mark.parametrize(
    "S,H,heads,ok",
    [
        (64, 384, 12, True),  # MiniLM, hd 32
        (128, 768, 12, True),  # BGE-base, hd 64
        (256, 1024, 8, True),  # hd 128
        (7, 384, 12, True),  # any sequence length
        (64, 384, 5, False),  # H % heads != 0
        (64, 384, 24, False),  # hd 16
        (64, 1024, 4, False),  # hd 256
    ],
)
def test_kernel_shape_predicate(S, H, heads, ok):
    assert tattn._supported(S, H, heads) is ok


def test_other_devices_raise():
    q = torch.zeros((1, 16, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tattn.encoder_attention(q, q, q, torch.zeros((1, 16), device="meta"), 4)


def test_launch_counter_is_a_plain_integer_untouched_on_cpu():
    before = tattn.encoder_attention.launches
    assert isinstance(before, int)
    rng = np.random.default_rng(6)
    _port(*_qkv(rng, 1, 16, 128), np.zeros((1, 16), np.float32), 4)
    assert tattn.encoder_attention.launches == before


# ---------------------------------------------------------------------------
# The CUDA wrapper's own arithmetic: the work plan and the layout checks.
# ---------------------------------------------------------------------------


def work_items(B, S, H, plan):
    """Each item's (sequences, query rows, columns) as ranges, decoded as
    ``Plan``'s docstring and the kernel decode them, clipped to the operands
    as the kernel's loads and stores are."""
    for it in range(plan.items):
        g, rest = it % plan.groups, it // plan.groups
        q0 = (rest % plan.chunks) * plan.seq_rows
        b0 = (rest // plan.chunks) * plan.seqs
        yield (
            range(b0, min(b0 + plan.seqs, B)),
            range(q0, min(q0 + plan.seq_rows, S)),
            range(g * tattn.GROUP_COLS, min((g + 1) * tattn.GROUP_COLS, H)),
        )

PLAN_GRID = [
    (B, S, H, heads)
    for B in (1, 3, 512, 513)
    for S in (1, 16, 24, 32, 48, 64, 65, 100, 512)
    for H, heads in ((384, 12), (768, 12), (1024, 8), (96, 3), (64, 1))
]


@pytest.mark.parametrize("B,S,H,heads", PLAN_GRID)
def test_plan_covers_every_row_and_head_once(B, S, H, heads):
    plan = tattn.plan(B, S, H)
    hd = H // heads
    seen = np.zeros((B, S, heads), np.int64)
    n = 0
    for seqs, rows, cols in work_items(B, S, H, plan):
        n += 1
        assert len(cols) % hd == 0 and cols.start % hd == 0  # whole heads only
        heads_of = slice(cols.start // hd, cols.stop // hd)
        for b in seqs:
            seen[b, rows.start : rows.stop, heads_of] += 1
    assert n == plan.items
    assert (seen == 1).all()


@pytest.mark.parametrize(
    "S,seq_rows,seqs,chunks",
    [
        (1, 16, 4, 1),
        (16, 16, 4, 1),  # the main path's bucket 16: four sequences per item
        (24, 32, 2, 1),
        (32, 32, 2, 1),  # bucket 32: two per item
        (33, 48, 1, 1),
        (64, 64, 1, 1),
        (65, 64, 1, 2),  # past 64: query tiles of 64 rows, keys in chunks of 64
        (512, 64, 1, 8),
    ],
)
def test_plan_packs_short_sequences(S, seq_rows, seqs, chunks):
    plan = tattn.plan(7, S, 384)
    assert (plan.seq_rows, plan.seqs, plan.chunks) == (seq_rows, seqs, chunks)
    assert plan.seq_rows % tattn.MMA_ROWS == 0
    assert plan.seq_rows * plan.seqs <= tattn.TILE_ROWS
    assert plan.items == -(-7 // seqs) * chunks * 3


@pytest.mark.parametrize(
    "H,widths",
    [(384, [128, 128, 128]), (768, [128] * 6), (96, [96]), (320, [128, 128, 64]), (64, [64])],
)
def test_head_groups_are_128_columns_with_a_narrower_last(H, widths):
    plan = tattn.plan(1, 64, H)
    assert [len(cols) for _, _, cols in work_items(1, 64, H, plan)] == widths


def test_fused_qkv_views_pass_the_layout_check():
    B, S, H = 3, 24, 384
    qkv = torch.zeros((B * S, 3 * H), dtype=torch.bfloat16)
    for i in range(3):
        view = qkv[:, i * H : (i + 1) * H].reshape(B, S, H)
        assert tattn._row_strides(view, "q", B, S, H) == (S * 3 * H, 3 * H)
    dense = torch.zeros((B, S, H), dtype=torch.bfloat16)
    assert tattn._row_strides(dense, "q", B, S, H) == (S * H, H)


@pytest.mark.parametrize(
    "make",
    [
        # a base 2 bytes past a 16-byte boundary
        lambda: torch.zeros(2 * 16 * 384 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 384),
        # a row stride of 388 elements (776 bytes, not whole 16 bytes)
        lambda: torch.zeros((2, 16, 388), dtype=torch.bfloat16)[:, :, :384],
        # a column stride of 2
        lambda: torch.zeros((2, 16, 768), dtype=torch.bfloat16)[:, :, ::2],
    ],
    ids=["misaligned_base", "row_stride", "column_stride"],
)
def test_layouts_tma_cannot_read_raise(make):
    t = make()
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        tattn._row_strides(t, "q", 2, 16, 384)


def test_wrong_shape_raises():
    with pytest.raises(ValueError, match="expected"):
        tattn._row_strides(torch.zeros((2, 16, 384), dtype=torch.bfloat16), "k", 2, 32, 384)
