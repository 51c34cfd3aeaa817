"""The reference against independent tiny computations, and the
yardstick's operation and byte counts against hand-worked ones."""

import math

import numpy as np
import pytest
import torch

from portbench import arith, weights
from portbench.reference import bert, mistral, text, topk


def np_layer_norm(x, scale, bias, eps=1e-6):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * scale + bias


def np_gelu_tanh(x):
    return 0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3)))


def np_bert(tree, ids, mask, heads, pooling):
    """One sequence at a time, heads in a loop: a second, plain spelling."""
    enc = {k: v for k, v in weights.to_numpy_f32(tree)["params"]["Encoder_0"].items()}
    out = []
    for row, m in zip(ids, mask):
        n = len(row)
        x = enc["Embed_0"]["embedding"][row] + enc["Embed_1"]["embedding"][:n]
        x = np_layer_norm(x, enc["LayerNorm_0"]["scale"], enc["LayerNorm_0"]["bias"])
        H = x.shape[1]
        hd = H // heads
        i = 0
        while f"TransformerBlock_{i}" in enc:
            b = enc[f"TransformerBlock_{i}"]
            a = b["MultiHeadDotProductAttention_0"]
            ctx = np.zeros_like(x)
            for h in range(heads):
                cols = slice(h * hd, (h + 1) * hd)
                q = x @ a["query"]["kernel"].reshape(H, H)[:, cols] + a["query"]["bias"].reshape(H)[cols]
                k = x @ a["key"]["kernel"].reshape(H, H)[:, cols] + a["key"]["bias"].reshape(H)[cols]
                v = x @ a["value"]["kernel"].reshape(H, H)[:, cols] + a["value"]["bias"].reshape(H)[cols]
                s = q @ k.T / math.sqrt(hd) + np.where(np.array(m) > 0, 0.0, -1e9)[None, :]
                p = np.exp(s - s.max(1, keepdims=True))
                ctx[:, cols] = (p / p.sum(1, keepdims=True)) @ v
            x = np_layer_norm(x + ctx @ a["out"]["kernel"].reshape(H, H) + a["out"]["bias"],
                              b["LayerNorm_0"]["scale"], b["LayerNorm_0"]["bias"])
            h1 = np_gelu_tanh(x @ b["Dense_0"]["kernel"] + b["Dense_0"]["bias"])
            x = np_layer_norm(x + h1 @ b["Dense_1"]["kernel"] + b["Dense_1"]["bias"],
                              b["LayerNorm_1"]["scale"], b["LayerNorm_1"]["bias"])
            i += 1
        mm = np.array(m, np.float64)[:, None]
        pooled = x[0] if pooling == "cls" else (x * mm).sum(0) / mm.sum()
        out.append(pooled / np.linalg.norm(pooled))
    return np.stack(out)


TINY_BERT = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2, "vocab_size": 200,
             "max_position_embeddings": 16, "num_hidden_layers": 2}


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bert_matches_a_plain_numpy_encoder(pooling):
    tree = weights.bert_tree(TINY_BERT, 7, "cpu")
    rows = [[101, 150, 160, 102], [101, 120, 102]]
    got = bert.embed(tree, rows, 2, pooling, "cpu").numpy()
    # padded rows: the second row's padding must not change its embedding
    want = np_bert(tree, rows, [[1] * len(r) for r in rows], 2, pooling)
    assert np.abs(got - want).max() < 1e-5


TINY_LM = {"hidden_size": 16, "intermediate_size": 24, "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 50, "num_hidden_layers": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 3}


def np_mistral(tree, cfg, seq):
    t = {k: (v.float().numpy() if torch.is_tensor(v) else {kk: vv.float().numpy() for kk, vv in v.items()})
         for k, v in tree.items()}
    H, NH, KH = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D, S = H // NH, len(seq)
    x = t["embed"][seq].astype(np.float64)

    def rms(v, s):
        return v / np.sqrt((v**2).mean(-1, keepdims=True) + cfg["rms_norm_eps"]) * s

    def rope(v):  # v [S, heads, D]: rotate each pair (i, i + D/2) by pos·θ_i
        out = v.copy()
        for p in range(S):
            for i in range(D // 2):
                ang = p / cfg["rope_theta"] ** (2 * i / D)
                c, s_ = math.cos(ang), math.sin(ang)
                a, b = v[p, :, i], v[p, :, i + D // 2]
                out[p, :, i], out[p, :, i + D // 2] = a * c - b * s_, b * c + a * s_
        return out

    for li in range(cfg["num_hidden_layers"]):
        w = {k: v[li] for k, v in t["layers"].items()}
        h = rms(x, w["ln0"])
        q = rope((h @ w["wq"]).reshape(S, NH, D))
        k = rope((h @ w["wk"]).reshape(S, KH, D))
        v = (h @ w["wv"]).reshape(S, KH, D)
        ctx = np.zeros((S, NH, D))
        for hh in range(NH):
            kv = hh // (NH // KH)
            for qp in range(S):
                keys = [kp for kp in range(S) if kp <= qp and kp > qp - cfg["sliding_window"]]
                s = np.array([q[qp, hh] @ k[kp, kv] for kp in keys]) / math.sqrt(D)
                p = np.exp(s - s.max())
                p /= p.sum()
                ctx[qp, hh] = sum(pi * v[kp, kv] for pi, kp in zip(p, keys))
        x = x + ctx.reshape(S, H) @ w["wo"]
        h = rms(x, w["ln1"])
        g = h @ w["wg"]
        x = x + ((g / (1 + np.exp(-g))) * (h @ w["wu"])) @ w["wd"]
    return rms(x, t["final_norm"]) @ t["lm_head"]


def test_mistral_matches_a_plain_numpy_decoder():
    tree = weights.mistral_tree(TINY_LM, 3, "cpu", dtype=torch.float32)
    seqs = [[5, 9, 2, 33, 7, 1], [4, 8]]
    got = mistral.logits_at(tree, TINY_LM, seqs, [[0, 3, 5], [1]], "cpu")
    for s, pos, lg in zip(seqs, [[0, 3, 5], [1]], got):
        want = np_mistral(tree, TINY_LM, s)[pos]
        assert np.abs(lg.numpy() - want).max() < 1e-4


def test_cosines_by_hand():
    q = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    d = torch.tensor([[4.0, 3.0], [0.0, 2.0], [-1.0, 0.0]])
    want = torch.tensor([[24 / 25, 4 / 5, -3 / 5], [4 / 5, 0.0, -1.0]], dtype=torch.float64)
    assert torch.allclose(topk.cosine_scores(q, d), want, atol=1e-12)


def test_fp8_topk_rounds_to_float8_and_bfloat16():
    g = torch.Generator().manual_seed(2)
    q, d = torch.randn(3, 64, generator=g), torch.randn(200, 64, generator=g)
    vals, idx = topk.fp8_cosine_topk(q, d, 10)
    exact = topk.cosine_scores(q, d)
    gap = (vals.double() - exact.gather(1, idx)).abs()
    assert bool((vals[:, 1:] <= vals[:, :-1]).all())
    assert torch.equal(vals, vals.to(torch.bfloat16).float())
    # e4m3 keeps 3 bits of each element: the scores move by far more than
    # a bfloat16 rounding of the exact ones, and by less than the bound
    assert 2.0 ** -9 < float(gap.max()) < 2 * 2.0 ** -4 + 2.0 ** -8


def test_splitter_rule_by_hand():
    words = "a b c. d e f g. h i j k"
    # max 5 words: cut after "c." (the last sentence end after min 2 words)
    assert text.split_chunks(words, 2, 5) == ["a b c.", "d e f g.", "h i j k"]
    # no sentence end: plain spans of max words
    assert text.split_chunks("w1 w2 w3 w4 w5 w6 w7", 2, 3) == ["w1 w2 w3", "w4 w5 w6", "w7"]
    assert text.split_chunks("", 2, 3) == []


def test_hash_ids_shape_and_decode():
    ids = text.hash_ids("Hello, world.", 30522, 512)
    assert ids[0] == text.CLS and ids[-1] == text.SEP and len(ids) == 6  # hello , world .
    assert all(text.FIRST_ID <= i < 30522 for i in ids[1:-1])
    assert ids == text.hash_ids("hello , WORLD .", 30522, 512)  # case-blind, split the same
    assert len(text.hash_ids(" ".join(["x"] * 600), 30522, 512)) == 512
    assert text.decode([101, 7, 0, 102, 12]) == "tok7 tok12"


def test_tokenizer_and_splitter_are_faithful_copies_of_the_program():
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    sample = "One two; three: four. Five six! Seven? eight nine ten. " * 40 + "tail words"
    tok = HashTokenizer(vocab_size=32000, max_length=4096)
    assert tok.encode(sample) == text.hash_ids(sample, 32000, 4096)
    assert tok.decode([101, 500, 102, 900]) == text.decode([101, 500, 102, 900])
    sp = TokenCountSplitter(min_tokens=7, max_tokens=20)
    assert [c for c, _m in sp.chunk(sample)] == text.split_chunks(sample, 7, 20)


def test_bert_flops_by_hand():
    # L=2, H=4, F=8, one layer: 2*(8*16 + 4*4*8) + 4*4*4 = 576
    assert arith.bert_sequence_flops(2, 4, 1, 8) == 576
    assert arith.bert_sequence_flops(2, 4, 3, 8) == 3 * 576


def test_encoder_attention_roofline_by_hand():
    B, S, H = 256, 512, 768
    assert arith.encoder_attention_flops(B, S, H) == 4 * 256 * 512 * 512 * 768
    nbytes = 4 * 256 * 512 * 768 * 2 + 256 * 512 * 4  # q, k, v, out in bf16; f32 key bias
    assert arith.encoder_attention_bytes(B, S, H) == nbytes
    # at S 512 the bytes bound: 0.2405 ms against 0.2085 ms of FLOPs
    assert arith.roofline_s(arith.encoder_attention_flops(B, S, H), nbytes) == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 == pytest.approx(2.4054e-4, rel=1e-3)


def test_decoder_flops_and_paged_bytes_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 16,
           "vocab_size": 10, "num_hidden_layers": 2, "sliding_window": 4}
    # per layer weights: 8*8 + 2*8*4 + 8*8 + 3*8*16 = 576; D = 4
    assert arith.decoder_matmul_params(cfg) == 576
    # context 6, window 4: per layer 2*576 + 4*4*2*4 = 1280; two layers; head 2*8*10
    assert arith.decoder_token_flops(cfg, 6, logits=True) == 2 * 1280 + 160
    assert arith.decoder_token_flops(cfg, 2, logits=False) == 2 * (1152 + 4 * 2 * 2 * 4)
    # 32 live tokens, 3 rows: per layer K and V 2*32*1*4*2 + q and out 2*3*2*4*2
    assert arith.decode_attention_bytes(cfg, 32, 3) == 2 * (512 + 96)
    assert arith.decode_attention_flops(cfg, [2, 9]) == 2 * (4 * 2 * 2 * 4 + 4 * 4 * 2 * 4)


def test_weights_are_seeded_and_bf16():
    a = weights.bert_tree(TINY_BERT, 5, "cpu")
    b = weights.bert_tree(TINY_BERT, 5, "cpu")
    c = weights.bert_tree(TINY_BERT, 2**31 + 9, "cpu")
    k = ("TransformerBlock_1", "Dense_0", "kernel")
    leaf = lambda t: t["params"]["Encoder_0"][k[0]][k[1]][k[2]]  # noqa: E731
    assert leaf(a).dtype == torch.bfloat16 and torch.equal(leaf(a), leaf(b)) and not torch.equal(leaf(a), leaf(c))
    m = weights.mistral_tree(TINY_LM, 5, "cpu")
    assert m["layers"]["wq"].shape == (2, 16, 16) and m["layers"]["wk"].shape == (2, 16, 8)
