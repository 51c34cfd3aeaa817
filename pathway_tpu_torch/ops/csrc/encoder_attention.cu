// Bidirectional (encoder) multi-head attention for Hopper, sm_90a.
//
// Replaces the TPU kernel pathway_tpu/ops/attention.py::_attn_kernel, which
// encoder_attention launches through pl.pallas_call. Same math:
//
//   ctx = softmax(q . k^T / sqrt(hd) + bias) . v      per sequence and head,
//
// q, k, v and ctx in the packed [B, S, H] layout (H = heads * hd, head h in
// columns [h*hd, (h+1)*hd)), bias [B, S] f32 added to every query's scores
// over the keys (0 valid, -1e9 padding), softmax in f32, bf16 out.
//
// What bounds it on an H100: at the main-path shape (B=512, S=64, H=384,
// 12 heads) one call must read q, k, v and write ctx, 4*B*S*H*2 bytes
// ~ 100.7 MB, ~30 us at 3.35 TB/s; its 4*B*S^2*H ~ 3.2 GFLOP take ~3.3 us at
// the bf16 tensor-core peak. So it is memory bound, and the design aims at
// moving each byte once: q, k and v are read in place from the fused QKV
// projection's output (the row stride is passed in, so the wrapper makes no
// relayout copy), each block reads the K and V of its (sequence, head) once
// per 64 query rows (once in all for S <= 64), scores and probabilities stay
// in registers, and ctx is written once, already packed.
//
// Design: one block of four warps per (query tile of 64 rows, head,
// sequence); each warp owns 16 query rows. Both products run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate): S = Q.K^T with Q's
// fragments held in registers and K's read from shared memory, then O += P.V
// with the score accumulators repacked in registers as the A operand (the
// C-fragment layout of one product is the A-fragment layout of the next).
// Keys are walked in tiles of 64 with an online softmax in f32 (running max
// and running sum per row), so shared memory stays bounded (35 KB at
// hd=128) for every S. The bias is added exactly as the plain version adds
// it, so a row whose keys are all masked (a padding row of the batch) gets a
// uniform, finite softmax, as in the plain version, and never NaN. As in the
// plain version the probabilities are rounded to bf16 before the PV product
// (here before normalisation, which happens once at the end).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kQueryTile = 16 * kWarps;
constexpr int kKeyTile = 64;
constexpr int kPad = 8;  // bf16 elements of row padding: conflict-free fragment loads

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
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

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, int S, int H,
                             long long q_sb, long long q_ss, long long k_sb,
                             long long k_ss, long long v_sb, long long v_ss,
                             float scale) {
  constexpr int LD = HD + kPad;      // shared-memory row length, bf16
  constexpr int KS = HD / 16;        // k-steps of the QK^T product
  constexpr int NB = kKeyTile / 8;   // n-blocks of scores per key tile
  constexpr int OB = HD / 8;         // n-blocks of the output row
  constexpr int W = HD / 2;          // bf16 pairs per head row

  __shared__ __align__(16) __nv_bfloat16 ks[kKeyTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeyTile * LD];

  const int b = blockIdx.z;
  const int col = blockIdx.y * HD;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int r0 = blockIdx.x * kQueryTile + warp * 16;  // the warp's first query row
  const bool active = r0 < S;

  const __nv_bfloat16* qb = q + b * q_sb + col;
  const __nv_bfloat16* kb = k + b * k_sb + col;
  const __nv_bfloat16* vb = v + b * v_sb + col;
  const float* bias_b = bias + static_cast<long long>(b) * S;

  // Q's A fragments for all k-steps, straight from global memory; rows past
  // S are zero and never written.
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1);
      const int dim = s * 16 + 8 * (i >> 1) + 2 * t;
      qf[s][i] = row < S ? *reinterpret_cast<const uint32_t*>(qb + row * q_ss + dim) : 0u;
    }
  }

  float o[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g+8
  float l[2] = {0.f, 0.f};              // running sums (this thread's columns)

  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeyTile * W; i += kWarps * 32) {
      const int r = i / W, w = i % W;
      uint32_t kv = 0u, vv = 0u;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint32_t*>(kb + (k0 + r) * k_ss + 2 * w);
        vv = *reinterpret_cast<const uint32_t*>(vb + (k0 + r) * v_ss + 2 * w);
      }
      *reinterpret_cast<uint32_t*>(ks + r * LD + 2 * w) = kv;
      *reinterpret_cast<uint32_t*>(vs + r * LD + 2 * w) = vv;
    }
    __syncthreads();
    if (!active) continue;

    // Scores of the warp's 16 rows against the tile's 64 keys.
    float sc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + s * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + s * 16 + 8);
        mma_bf16(sc[n], qf[s], b0, b1);
      }
    }

    // Scale, bias, structural mask (keys past S), and the running max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + n * 8 + 2 * t + e;
        const bool valid = key < S;
        const float kbias = valid ? bias_b[key] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& s = sc[n][2 * r + e];
          s = valid ? s * scale + kbias : -INFINITY;
          mx[r] = fmaxf(mx[r], s);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is always valid, so the max is finite from the first tile on
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(sc[n][i] - m[i / 2]);
        sc[n][i] = p;
        l[i / 2] += p;
      }
    }

    // O += P . V, P repacked from the score fragments as bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vrow = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        const __nv_bfloat16* vp = vrow + j * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[j], a, b0, b1);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = out + (static_cast<long long>(b) * S + row) * H + col + 2 * t;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, const void* bias, void* out,
            int B, int S, int heads, long long q_sb, long long q_ss, long long k_sb,
            long long k_ss, long long v_sb, long long v_ss, float scale,
            cudaStream_t stream) {
  const dim3 grid((S + kQueryTile - 1) / kQueryTile, heads, B);
  encoder_attention_kernel<HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), S, heads * HD, q_sb, q_ss, k_sb, k_ss, v_sb,
      v_ss, scale);
}

}  // namespace

// q, k, v: bf16 [B, S, heads*hd] with unit column stride, batch stride *_sb
// and row stride *_ss in elements (even, 4-byte aligned base); bias: f32
// [B, S] contiguous; out: bf16 [B, S, heads*hd] contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int encoder_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int B, int S,
                                      int heads, int hd, long long q_sb, long long q_ss,
                                      long long k_sb, long long k_ss, long long v_sb,
                                      long long v_ss, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      launch<32>(q, k, v, bias, out, B, S, heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                 scale, st);
      break;
    case 64:
      launch<64>(q, k, v, bias, out, B, S, heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                 scale, st);
      break;
    case 128:
      launch<128>(q, k, v, bias, out, B, S, heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                  scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
