#!/usr/bin/env python3
"""Where the encoder-attention kernel's time goes, on one CUDA card.

    python3 attention_ablation.py

Builds three cut-down copies of ``pathway_tpu_torch/ops/csrc/encoder_attention.cu``
beside the kernel itself: without the arithmetic (the TMA loads, the
pipeline and the ctx stores only), without the loads (the arithmetic on
whatever the ring holds, and the stores), and without either (the pipeline
and the stores). Times each, the kernel, and a device copy that reads and
writes as many bytes as the kernel must move, at every main-path attention
shape, the way ``chip_smoke.py`` times kernels (CUDA graphs, inputs rotated
past the L2 cache). Prints the card, then one JSON line per shape. The
cut-down copies compute nothing useful and are never checked; the kernel
itself is held to its plain version by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

CUTS = {
    "no_arithmetic": [("        switch (blocks) {", "        if (false) switch (blocks) {")],
    "no_loads": [
        ("mbar_arrive_expect_tx(bar, halves * box_bytes * (c == 0 ? 3 : 2));", "mbar_arrive(bar);"),
        ("          for (int h = 0; h < halves; ++h) {", "          for (int h = 0; h < 0; ++h) {"),
    ],
}
CUTS["neither"] = CUTS["no_arithmetic"] + CUTS["no_loads"]


def build_cuts(_build) -> dict:
    """Compile every cut-down copy at once; returns the C entry points."""
    src = (_build.CSRC / "encoder_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"attention_ablation: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attention_ablation: nvcc failed for {name}:\n{text}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).encoder_attention_bf16
        fn.argtypes = _build.load("encoder_attention").encoder_attention_bf16.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import attention

    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    attention._kernel()  # builds the kernel and sets its argument types
    kernels = {"kernel": attention._kernel(), **build_cuts(_build)}
    gen = torch.Generator(device=device).manual_seed(0)
    for shape in cs.TIMED_SHAPES:
        B, S, H, heads = shape
        operand_bytes = 4 * B * S * H * 2 + B * S * 4
        copies = max(2, -(-2 * cs.L2_BYTES // operand_bytes))
        inputs = [(*cs.fused_qkv(gen, B, S, H, device), cs.padded_mask(B, S, device)) for _ in range(copies)]
        row = {"shape": list(shape), "bound_ms": operand_bytes / cs.HBM_BYTES_PER_S * 1e3}
        build_kernel = attention._kernel
        try:
            for name, fn in kernels.items():
                attention._kernel = lambda fn=fn: fn
                row[f"{name}_ms"] = cs.device_ms([lambda x=x: attention.encoder_attention(*x, heads) for x in inputs])
        finally:
            attention._kernel = build_kernel
        src = [torch.empty(operand_bytes // 4, dtype=torch.bfloat16, device=device) for _ in range(2)]
        dst = [torch.empty_like(t) for t in src]
        row["copy_ms"] = cs.device_ms([lambda i=i: dst[i].copy_(src[i]) for i in range(2)])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
