// Bidirectional (encoder) multi-head attention for Hopper, sm_90a.
//
// Replaces the TPU kernel pathway_tpu/ops/attention.py::_attn_kernel, which
// encoder_attention launches through pl.pallas_call. Same math:
//
//   ctx = softmax(q . k^T / sqrt(hd) + bias) . v      per sequence and head,
//
// q, k, v and ctx in the packed [B, S, H] layout (H = heads * hd, head h in
// columns [h*hd, (h+1)*hd)), bias [B, S] f32 added to every query's scores
// over the keys (0 valid, -1e9 padding), softmax in f32, probabilities
// rounded to bf16 before the PV product, bf16 out.
//
// What bounds it on an H100: one call must read q, k, v and write ctx,
// 4*B*S*H*2 bytes (~100.7 MB at B=512, S=64, H=384: ~30 us at 3.35 TB/s),
// against 4*B*S^2*H flops (~3.2 GFLOP, ~3.3 us at the bf16 tensor-core
// peak). It is memory bound, so the design is about keeping enough bytes in
// flight and moving each of them once, in wide transactions:
//
// * Work items of 128 columns (a head group: 4 heads at hd=32, 2 at 64, 1 at
//   128, the TPU kernel's LANE_GROUP) by up to 64 rows. Each row read is
//   256 contiguous bytes of q, k and v; the last group of an H that is not
//   a multiple of 128 is narrower.
// * Short sequences are packed, not padded: for S <= 64 each sequence takes
//   S rounded up to 16 rows (one m16n8k16 tile height), and an item holds
//   64 / that many sequences (4 at S=16, 2 at S=32). A 16-row query tile
//   belongs to one sequence and walks only that sequence's keys, so no warp
//   idles and no key tile is mostly mask. For S > 64 an item is 64 query
//   rows of one sequence, and its keys stream through in chunks of 64 with
//   an online softmax in f32.
// * TMA (cp.async.bulk.tensor) moves every tile: a 3-D tensor map over
//   [B, S, H] with the strides the wrapper is given (q, k and v are read in
//   place from the fused QKV output, row stride 3H), boxes of 64 columns by
//   rows by sequences, 128-byte swizzle so the ldmatrix reads of the tiles
//   are free of bank conflicts. Rows past S, sequences past B and columns
//   past H arrive as zeros, so the ragged edges need no load code.
// * A persistent grid of one CTA per SM walks the items. One producer warp
//   keeps a ring of four stages (q, k, v and the bias row of one item or key
//   chunk: 48 KB each) in flight, with mbarrier completion; the consumer
//   warps compute the item in front while the next three load. The grid has
//   no B limit.
// * One consumer warp per (16-row tile, head) of an item: 16 warps at
//   hd=32, 8 at 64, 4 at 128. Eight warps with two units each at hd=32 left
//   the kernel bound by the latency of the dependent softmax chain rather
//   than by memory; one unit per warp doubles the warps that hide it.
//   attention_ablation.py times the kernel with its arithmetic or its loads
//   cut out, to show which side holds it.
// * Fragments come from the staged tiles with ldmatrix (.trans for V); both
//   products run on mma.sync m16n8k16 (bf16 in, f32 accumulate), the score
//   accumulators repacked in registers as the A operand of the PV product.
//   wgmma is not used: at 4*S*H flops per 8*H bytes the tensor cores are
//   idle most of the time whichever instruction feeds them.
// * Each warp normalises its ctx rows, transposes them through shared
//   memory with stmatrix, and writes whole 16-byte pieces of the rows that
//   exist; no barrier across warps.
//
// The producer stages the bias times log2(e) (exp becomes one ex2) and -inf
// for keys past S, so the score loop has no branch. A row whose keys are all
// at -1e9 (a padding row of the batch) gets the plain version's uniform,
// finite softmax, never NaN.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroupCols = 128;    // columns per work item
constexpr int kBoxCols = 64;       // columns per TMA box: 128 bytes, the swizzle span
constexpr int kTileRows = 64;      // rows per work item (queries) and per key chunk
constexpr int kStages = 4;

constexpr int kHalfBytes = kTileRows * kBoxCols * 2;  // one box of 64 rows: 8 KB
constexpr int kTileBytes = 2 * kHalfBytes;            // 64 rows x 128 columns: 16 KB
constexpr int kBiasOffset = 3 * kTileBytes;           // q, k, v, then the bias row
constexpr int kStageBytes = kBiasOffset + 1024;       // 64 floats; keeps tiles 1024-aligned
constexpr int kOutOffset = kStages * kStageBytes;     // one ctx tile
constexpr int kBarOffset = kOutOffset + kTileBytes;
constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;  // 1024: alignment slack

// The work plan, computed by the wrapper (pathway_tpu_torch/ops/attention.py
// plan()): item it covers head group it % groups, chunk (it / groups) %
// chunks and sequences from (it / groups / chunks) * seqs on.
struct Plan {
  int B, S, H;
  int seq_rows;  // rows one sequence takes in a tile (S <= 64: S rounded up to 16; else 64)
  int seqs;      // sequences per item (64 / seq_rows)
  int chunks;    // query tiles per sequence = key chunks per item
  int groups;    // 128-column head groups
  int items;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) in a tile of two swizzled 64-column boxes; col is
// a multiple of 8 (one 16-byte chunk). The 128-byte swizzle puts chunk c of
// row r at chunk c ^ (r % 8), as TMA does on a 1024-aligned box.
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return (col >> 6) * kHalfBytes + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a . b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's work: 16 query rows of one sequence, one head, in base-2 units
// (scores and bias carry a factor log2(e), so exp is one ex2).
template <int HD>
struct Unit {
  uint32_t qf[HD / 16][4];  // Q's A fragments, one per k-step
  float o[HD / 8][4];       // unnormalised context
  float m[2];               // running max of rows g and g+8
  float l[4];               // running sums, as the accumulator of P . ones
};

// Fold one chunk of keys (tile rows key0 .. key0+16*BLOCKS-1) into u. bias
// holds the chunk's keys' bias times log2(e), -inf past the sequence. The
// key-block count is a template argument so that every loop unrolls without
// a branch.
template <int HD, int BLOCKS>
__device__ __forceinline__ void attend(Unit<HD>& u, uint32_t k_tile, uint32_t v_tile,
                                       const float* bias, int key0, int col, float scale,
                                       bool first, int lane) {
  constexpr int OB = HD / 8;
  const int t = lane & 3;

  // key0 is a multiple of 16, so a lane's swizzle depends on its own row
  // within 8 only: the lane's offset is computed once, the block's added.
  k_tile += key0 * 128;
  v_tile += key0 * 128;
  float sc[2 * BLOCKS][4];
#pragma unroll
  for (int n = 0; n < 2 * BLOCKS; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t b[4];
      ldsm_x4(b, k_tile + n * 1024 + tile_off(lane & 7, col + kp * 32 + 8 * (lane >> 3)));
      mma_bf16(sc[n], u.qf[2 * kp], b[0], b[1]);
      mma_bf16(sc[n], u.qf[2 * kp + 1], b[2], b[3]);
    }
  }

  // Scale and bias (the bias masks keys past the sequence), running max.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * BLOCKS; ++n) {
    const float2 kb = *reinterpret_cast<const float2*>(bias + key0 + n * 8 + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sc[n][2 * r] = fmaf(sc[n][2 * r], scale, kb.x);
      sc[n][2 * r + 1] = fmaf(sc[n][2 * r + 1], scale, kb.y);
      mx[r] = fmaxf(mx[r], fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // the chunk's first key is always a key of the sequence: mx is finite
    if (first) {
      u.m[r] = mx[r];
    } else {
      const float m_new = fmaxf(u.m[r], mx[r]);
      const float corr = ex2(u.m[r] - m_new);
      u.m[r] = m_new;
      u.l[2 * r] *= corr;
      u.l[2 * r + 1] *= corr;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        u.o[j][2 * r] *= corr;
        u.o[j][2 * r + 1] *= corr;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * BLOCKS; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = ex2(sc[n][i] - u.m[i / 2]);
  }

  // O += P . V, P repacked from the score fragments as bf16 A fragments;
  // the row sums of the same bf16 P come from one more product with ones,
  // so the weights that reach V sum to one.
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < BLOCKS; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
        pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
        pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
        pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
    };
    mma_bf16(u.l, a, kOnes, kOnes);
#pragma unroll
    for (int jp = 0; jp < HD / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, v_tile + kk * 2048 + tile_off(row, col + jp * 16 + 8 * (lane >> 4)));
      mma_bf16(u.o[2 * jp], a, b[0], b[1]);
      mma_bf16(u.o[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// One warp per (16-row tile, head) of a full item: 16 at hd=32, 8 at 64, 4 at 128.
template <int HD>
__host__ __device__ constexpr int consumer_warps() {
  return (kTileRows / 16) * (kGroupCols / HD);
}

template <int HD>
__global__ void __launch_bounds__((consumer_warps<HD>() + 1) * 32, 1)
    encoder_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                             const Plan p, float scale) {
  constexpr int KS = HD / 16;
  constexpr int OB = HD / 8;
  constexpr int kWarps = consumer_warps<HD>();
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-aligned tiles
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + kBarOffset;  // kStages barriers of 8 bytes
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = p.seq_rows * p.seqs;  // rows of one item's tiles
  const int box_bytes = rows * kBoxCols * 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);         // the producer, plus the TMA bytes
      mbar_init(empty_bar + 8 * s, kWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // Producer: every lane reads two of the chunk's (at most 64) bias
    // values before the stage is free and stores them after; lane 0 then
    // arrives (the warp's stores ordered before it) and issues the loads.
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
      const int col = (it % p.groups) * kGroupCols;
      const int rest = it / p.groups;
      const int q0 = (rest % p.chunks) * p.seq_rows;
      const int b0 = (rest / p.chunks) * p.seqs;
      const int halves = (min(kGroupCols, p.H - col) + kBoxCols - 1) / kBoxCols;
      for (int c = 0; c < p.chunks; ++c) {
        const int k0 = c * p.seq_rows;
        float kb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = lane + 32 * j;
          const int b = b0 + r / p.seq_rows;
          const int key = k0 + r % p.seq_rows;
          kb[j] = 0.f;  // rows of sequences past B: finite, and never stored
          if (r < rows && b < p.B)
            kb[j] = key < p.S ? __ldg(bias + static_cast<long long>(b) * p.S + key) * kLog2e
                              : -INFINITY;
        }
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        float* bias_s = reinterpret_cast<float*>(smem + stage * kStageBytes + kBiasOffset);
        bias_s[lane] = kb[0];
        bias_s[lane + 32] = kb[1];
        __syncwarp();
        if (lane == 0) {
          const uint32_t st = base + stage * kStageBytes;
          const uint32_t bar = full_bar + 8 * stage;
          mbar_arrive_expect_tx(bar, halves * box_bytes * (c == 0 ? 3 : 2));
          for (int h = 0; h < halves; ++h) {
            const int x = col + h * kBoxCols;
            if (c == 0) tma_load(st + h * kHalfBytes, &tm_q, bar, x, q0, b0);
            tma_load(st + kTileBytes + h * kHalfBytes, &tm_k, bar, x, k0, b0);
            tma_load(st + 2 * kTileBytes + h * kHalfBytes, &tm_v, bar, x, k0, b0);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warp w takes 16-row tile w % tiles of head w / tiles. A warp
  // without a unit (a short item, a narrow last group) still waits and
  // releases each stage, so every barrier phase sees every warp.
  const int tiles = rows / 16;
  const int tile = warp % tiles;
  const int hcol = (warp / tiles) * HD;        // the head's first column in the group
  const int tile_seq = tile * 16 / p.seq_rows;  // the tile's sequence in the item
  const int tile_row0 = tile * 16 % p.seq_rows;  // and its first row there
  const int key0 = tile_seq * p.seq_rows;
  const int row = tile * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix/stmatrix row
  const uint32_t ob = base + kOutOffset;        // ctx tile: each warp its own rows x head
  const float scale2 = scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int col = (it % p.groups) * kGroupCols;
    const int rest = it / p.groups;
    const int q0 = (rest % p.chunks) * p.seq_rows;
    const int b0 = (rest / p.chunks) * p.seqs;
    const bool active = warp < tiles * (min(kGroupCols, p.H - col) / HD);

    Unit<HD> u;
#pragma unroll
    for (int j = 0; j < OB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) u.o[j][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) u.l[e] = 0.f;

    for (int c = 0; c < p.chunks; ++c) {
      // 16-key blocks of each sequence in this chunk
      const int blocks = (min(p.seq_rows, p.S - c * p.seq_rows) + 15) >> 4;
      mbar_wait(full_bar + 8 * stage, phase);
      if (active) {
        const uint32_t st = base + stage * kStageBytes;
        if (c == 0) {
#pragma unroll
          for (int s = 0; s < KS; ++s)
            ldsm_x4(u.qf[s], st + tile_off(row, hcol + s * 16 + 8 * (lane >> 4)));
        }
        const uint32_t k_tile = st + kTileBytes;
        const uint32_t v_tile = st + 2 * kTileBytes;
        const float* bias_s =
            reinterpret_cast<const float*>(smem + stage * kStageBytes + kBiasOffset);
        const bool first = c == 0;
        switch (blocks) {
          case 4:
            attend<HD, 4>(u, k_tile, v_tile, bias_s, key0, hcol, scale2, first, lane);
            break;
          case 3:
            attend<HD, 3>(u, k_tile, v_tile, bias_s, key0, hcol, scale2, first, lane);
            break;
          case 2:
            attend<HD, 2>(u, k_tile, v_tile, bias_s, key0, hcol, scale2, first, lane);
            break;
          default:
            attend<HD, 1>(u, k_tile, v_tile, bias_s, key0, hcol, scale2, first, lane);
        }
      }
      __syncwarp();  // the warp's reads of the stage are done
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (!active) continue;

    // Epilogue: normalise, transpose through shared memory with stmatrix,
    // and write whole 16-byte pieces of the rows that exist.
    const float inv[2] = {1.f / u.l[0], 1.f / u.l[2]};
#pragma unroll
    for (int jp = 0; jp < OB / 2; ++jp) {
      const float* o0 = u.o[2 * jp];
      const float* o1 = u.o[2 * jp + 1];
      stsm_x4(ob + tile_off(row, hcol + jp * 16 + 8 * (lane >> 4)),
              pack_bf16(o0[0] * inv[0], o0[1] * inv[0]), pack_bf16(o0[2] * inv[1], o0[3] * inv[1]),
              pack_bf16(o1[0] * inv[0], o1[1] * inv[0]), pack_bf16(o1[2] * inv[1], o1[3] * inv[1]));
    }
    __syncwarp();
    const int b = b0 + tile_seq;
    for (int i = lane; i < 16 * OB; i += 32) {
      const int s = q0 + tile_row0 + i / OB;
      if (b < p.B && s < p.S) {
        const int cc = hcol + (i % OB) * 8;
        const uint4 v =
            *reinterpret_cast<const uint4*>(smem + kOutOffset + tile_off(tile * 16 + i / OB, cc));
        *reinterpret_cast<uint4*>(out + (static_cast<long long>(b) * p.S + s) * p.H + col + cc) = v;
      }
    }
    __syncwarp();  // read back before the next item's stmatrix
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched at run time so that
// nothing links libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A [B, S, H] bf16 operand with unit column stride, row stride ss and batch
// stride sb (elements), cut into boxes of 64 columns x seq_rows x seqs.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, const Plan& p,
                  long long sb, long long ss) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.S),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(p.seq_rows),
                             static_cast<cuuint32_t>(p.seqs)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const CUtensorMap maps[3], const float* bias, void* out, const Plan& p, int ctas,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(encoder_attention_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  encoder_attention_kernel<HD><<<ctas, (consumer_warps<HD>() + 1) * 32, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<__nv_bfloat16*>(out), p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 [B, S, H] with unit column stride, batch stride *_sb and row
// stride *_ss in elements (multiples of 8, on a 16-byte aligned base); bias:
// f32 [B, S] contiguous; out: bf16 [B, S, H] contiguous. seq_rows, seqs,
// chunks, groups and items are the wrapper's plan; ctas the persistent grid.
// Launches on `stream` and returns 0, a CUDA error code, or minus a CUresult
// when a tensor map cannot be encoded.
extern "C" int encoder_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int B, int S, int H, int hd,
                                      long long q_sb, long long q_ss, long long k_sb,
                                      long long k_ss, long long v_sb, long long v_ss,
                                      int seq_rows, int seqs, int chunks, int groups, int items,
                                      int ctas, float scale, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const Plan p{B, S, H, seq_rows, seqs, chunks, groups, items};
  CUtensorMap maps[3];
  const long long sb[3] = {q_sb, k_sb, v_sb};
  const long long ss[3] = {q_ss, k_ss, v_ss};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = make_map(encode, &maps[i], ptrs[i], p, sb[i], ss[i]);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  switch (hd) {
    case 32:
      return launch<32>(maps, b, out, p, ctas, scale, st);
    case 64:
      return launch<64>(maps, b, out, p, ctas, scale, st);
    case 128:
      return launch<128>(maps, b, out, p, ctas, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
