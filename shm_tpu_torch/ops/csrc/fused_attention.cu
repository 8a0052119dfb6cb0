// Fused deterministic attention-VAE gate for Hopper (sm_90a), float32 and
// bf16.
//
// Replaces the Pallas TPU kernel shm_tpu/ops/fused_attention.py::_kernel
// (:157), launched by fused_attention_gate (:401, pallas_call at :524). Same
// function:
//
//   x [N,T,D] -> in_proj + sinusoidal positions -> L pre-LN transformer blocks
//     -> final LayerNorm -> mean over the T rows -> [LayerNorm eps 1e-5]
//     -> mu = fc_mu (z = mu) -> h0 = tanh(fc_latent_to_hidden(mu))
//     -> decoder in_proj(h0) broadcast over T + positions -> L blocks
//     -> final LayerNorm -> output head x_hat
//     -> resid = (x - x_hat)^2 [N,T,D] and mse = sum(resid) / (T*D) [N]
//
// A block: LayerNorm (eps 1e-6, var = E[x^2] - E[x]^2 clamped at 0) -> QKV
// (1/sqrt(32) already folded into the query weight and bias) -> per head
// softmax(q k^T) v over the T keys, max-subtracted -> output projection ->
// residual -> LayerNorm -> MLP with tanh-GELU -> residual.
//
// H in {32,64,128}, heads = H/32 of 32 columns, MLP width 4H, L in {1,2},
// D <= 128, Z <= 32, any T whose buffers fit a block's shared memory (the
// wrapper works that out and refuses the rest). Weights come in [in, out]
// layout, the four products' as TF32 fragments (below); wqkv is packed per
// head: columns h*96 .. h*96+95 hold q|k|v of head h. The TPU kernel's
// paddings (T to 128, H to 128 lanes) and its key mask exist only for its
// tiling and are not carried over: this kernel attends over exactly T keys.
//
// Bound on this card. Per window and block: QKV 2*T*H*3H, scores and PV
// 2*2*T*T*H, output projection 2*T*H*H, MLP 2*2*T*H*4H; for the 4DOF preset
// (T=100, D=12, H=128, L=2+2) about 178 MFLOP a window, about 970 GFLOP at
// N=5,440: ~14.5 ms at the 67 TFLOP/s float32 rate without tensor cores
// (~1 ms in bf16 on the tensor cores). The bytes (x, resid, weights once) are
// ~55 MB, ~17 us. So the kernel is bound by operations. The four weight
// products are ~89% of them (~862 GFLOP at N=5,440): in 3xTF32 on the
// tensor cores (three products each, 495 TFLOP/s TF32) ~5.2 ms.
//
// Design. One block of 512 threads owns one window and keeps its whole pass
// in shared memory; only x, the weights, resid and mse touch device memory.
//   * The residual stream s [T,H] and its normalised copy nrm [T,H] stay
//     resident (rows padded to a multiple of 8, row stride H+4 floats). One
//     window's QKV for all heads (154 KB at 4DOF) would not fit beside them,
//     so attention runs head by head: q, k, v of one head [T,32] each, the
//     scores of 32 query rows at a time [32,T], and the head's output written
//     over its dead q rows, then multiplied into s by the head's 32 rows of
//     the output weight. Nothing of another window or of a column >= T is
//     ever in a softmax row.
//   * The MLP's hidden layer [T,4H] (205 KB) is cut into column chunks of
//     CC = 128 that reuse the attention buffers: gelu(nrm W1[:,chunk]) then
//     s += that times W2[chunk,:].
//   * Every product with a weight (QKV, output projection, W1, W2) goes
//     through one warp-level routine, mma_rows, on the tensor cores:
//     mma.sync m16n8k8 TF32 in 3xTF32, a * b = a_s b_b + a_b b_s + a_b b_b
//     with big = rna_tf32(x) and small = rna_tf32(x - big) (round to
//     nearest, ties away from zero), summed in float32: relative error
//     ~2^-21 a product, near float32's own. A warp owns NW n8 column tiles
//     and walks the m16 row tiles of its m-group with the k loop outside, so
//     it loads each weight fragment once for all of them and splits each A
//     fragment once for its NW n-tiles. The products with N = 128 (output
//     projection and W2 at H=128, every W1 chunk) give 4 n-tiles (32
//     columns) to a warp and split the rows into 4 m-groups: each weight
//     fragment is loaded by 4 warps of the block, each A element split 4
//     times. One n-tile a warp (each fragment loaded once a block) splits
//     every A element 16 times and was slower (PERF.md §6). QKV of a
//     head (12 n-tiles) gives 3 n-tiles to a warp and its rows to 4
//     m-groups; all 16 warps work. At H = 64 / 32 the products with
//     N = H have 8 / 4 n-tiles: more m-groups, and at H = 32 some warps idle.
//   * The weights come packed once by the wrapper in fragment order: for each
//     (n-tile, k-step, lane) one float4 {b0 big, b1 big, b0 small, b1 small},
//     so one coalesced 16-byte load gives a lane its whole B fragment. A stays
//     in shared memory; its padded row strides (H+4, 36, CC+4 floats) make
//     the fragment loads conflict-free (lane (g, t) hits bank 4g + t), and
//     it is split in registers by the same two integer operations the
//     wrapper rounds the weights with (cvt.rna.tf32.f32 costs four).
//     A row past the padded T reads the last row (inside A; its results are
//     never stored), so the k loop has no branch.
//   * What binds is not the tensor cores: in an earlier version, four FMAs
//     in place of every mma left the time unchanged, and no split of A
//     saved a third of the products' time (PERF.md §6).
//   * LayerNorm and softmax rows are one warp each with shuffle reductions;
//     sums over k and the window's MSE run in a fixed order (no atomics).
// Scores, softmax and P.V stay on the FMA pipes; several windows a block,
// bf16 wgmma and keys streamed beyond a block's shared memory are later work.
//
// The bf16 instance (C entry shm_fused_attention_gate_bf16, template BF) is
// the TPU kernel with dtype=bf16 (fused_attention.py:206-212, :252-353):
// every product's two operands rounded to bf16 and summed in float32. In
// mma_rows each A element is rounded to bf16 in place of the TF32 split and
// the B fragments are the wrapper's packing of the bf16-rounded weights (the
// query's scale folded in first), so a_b b_b alone, one mma a k-step, is the
// exact bf16 product. On the FMA pipes the scores multiply the stored bf16
// q and k, P.V the probabilities rounded after the softmax's division (the
// TPU kernel's packed softmax; its streaming form past 128 steps rounds
// them before) and the stored bf16 v, and the token, latent and output heads
// round both operands. The residual stream s is rounded as the TPU kernel
// stores it: after the tokens, after the output projection (its last head)
// and after the MLP (its last chunk); q | k | v and the attention output o
// as they are stored. LayerNorm, softmax and the pooled summary stay
// float32. Its io is float32 or bf16 (template IOT): with bf16 the window is
// read as bf16 (in the residual's x - y too) and the residual stored bf16.
// Its bound at N=5,440 (4DOF preset) is the 970.6 GFLOP at the 989 TFLOP/s
// bf16 rate, 0.98 ms; what binds the float32 body (not its mma) binds it.
//
// Accurate expf/tanhf (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int HD = 32;          // head size
constexpr int HDP = HD + 4;     // padded row of the per-head q/k/v buffers
constexpr int QC = 32;          // query rows per score chunk
constexpr int CC = 128;         // MLP hidden columns per chunk (divides 4H)
constexpr int TM = 8;           // rows are padded to a multiple of TM
constexpr int LMAX = 2;
constexpr int HMAX = 128;
constexpr int ZMAX = 32;
constexpr int DMAX = 128;
constexpr int SMALL = 512;      // floats for the per-window vectors
constexpr int NUM_W = 2 * (4 + 16 * LMAX) + 8;
constexpr float STACK_EPS = 1e-6f;
constexpr float MODEL_EPS = 1e-5f;

typedef unsigned short bf16_t;  // raw bf16 bits

// float32 -> nearest bf16 (ties to even), as a float32; identity unless R
template <bool R>
__device__ __forceinline__ float rd(float x) {
  if constexpr (R) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r << 16);
  }
  return x;
}

// the window and the residual in their io type: float32, or bf16 bits
__device__ __forceinline__ float ld_io(const float* p) { return *p; }
__device__ __forceinline__ float ld_io(const bf16_t* p) {
  return __uint_as_float((unsigned)*p << 16);
}
__device__ __forceinline__ void st_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_io(bf16_t* p, float v) {
  *p = (bf16_t)(__float_as_uint(rd<true>(v)) >> 16);
}

// the four products' weights as TF32 fragments (mma_rows), the rest as given
struct BlockW {
  const float *ln1s, *ln1b, *bqkv, *bo, *ln2s, *ln2b, *b1, *b2;
  const float4 *wqkv_f, *wo_f, *w1_f, *w2_f;
};
struct StackW {
  const float *in_w, *in_b;   // [in, H], [H]
  BlockW layer[LMAX];
  const float *fs, *fb;       // final norm
};
struct AttnW {
  StackW enc;
  const float *ln_s, *ln_b, *mu_w, *mu_b, *z2h_w, *z2h_b;
  StackW dec;
  const float *out_w, *out_b;  // [H, D], [D]
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi)
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// One row of LayerNorm by one warp: out[c] = (in[c] - mean) * rsqrt(var + eps)
// * scale[c] + bias[c], var = E[x^2] - E[x]^2 clamped at 0. in/out may alias.
__device__ __forceinline__ void ln_row(const float* in, float* out,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias, int H,
                                       float eps, int lane) {
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < H; c += 32) {
    const float v = in[c];
    sum += v;
    sq = fmaf(v, v, sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / H;
  const float var = fmaxf(sq / H - mean * mean, 0.0f);
  const float r = 1.0f / sqrtf(var + eps);
  for (int c = lane; c < H; c += 32)
    out[c] = (in[c] - mean) * r * __ldg(scale + c) + __ldg(bias + c);
}

// nrm[row] = LayerNorm(s[row]) for every row < rows; one warp a row.
__device__ __forceinline__ void ln_rows(const float* s, float* nrm, int ld,
                                        int rows, const float* scale,
                                        const float* bias, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NWARP)
    ln_row(s + r * ld, nrm + r * ld, scale, bias, H, STACK_EPS, lane);
}

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;   // round to nearest, ties away from zero; low 13 bits zero
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The same rounding in two integer operations, as the wrapper packs the
// weights (cvt.rna.tf32.f32 compiles to ~4 with its Inf/NaN guard): equal
// to tf32_rna for every finite x, which is all the kernel feeds it.
__device__ __forceinline__ unsigned tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col): TF32 operands, float32 accumulators.
// Lane (g = lane/4, t = lane%4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = C[g][2t, 2t+1], C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// One k-step of mma_rows: the MW row tiles at A + ro (this lane's two rows
// of each, as offsets) times the NW n-tiles' fragments b. Each A element is
// split once for the NW n-tiles; each k-step adds a_s b_b, a_b b_s, then
// a_b b_b into one float32 accumulator. Under BF each A element is rounded
// to bf16 and the k-step adds a_b b_b alone (b holds bf16-rounded weights).
template <int NW, int MW, bool BF>
__device__ __forceinline__ void mma_kstep(float (&acc)[MW][NW][4], const float* A,
                                          const int (&ro)[MW][2],
                                          const float4 (&b)[NW]) {
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const float x[4] = {A[ro[i][0]], A[ro[i][1]], A[ro[i][0] + 4], A[ro[i][1] + 4]};
    unsigned big[4], sml[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (BF) {
        big[q] = __float_as_uint(rd<true>(x[q]));
        sml[q] = 0u;
      } else {
        big[q] = tf32_round(x[q]);
        sml[q] = tf32_round(x[q] - __uint_as_float(big[q]));
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if constexpr (!BF) {
        mma_tf32(acc[i][j], sml, b[j].x, b[j].y);   // a_s b_b
        mma_tf32(acc[i][j], big, b[j].z, b[j].w);   // a_b b_s
      }
      mma_tf32(acc[i][j], big, b[j].x, b[j].y);     // a_b b_b
    }
  }
}

// A weight product on the tensor cores in 3xTF32. For every row < M and
// every column pair (col, col+1) of the NTL n-tiles (8 columns each) at Bf:
//   epi(row, col, sum_k A[row][k] W[k][col], sum_k A[row][k] W[k][col+1])
// over the KS k-steps (8 rows of W each) at Bf. A [M][lda] is in
// shared memory. W [K, N] comes packed by the wrapper as float4 {b0 big, b1
// big, b0 small, b1 small} at [(nt * KT + kt) * 32 + lane], KT = K/8, lane
// (g, t) holding W[8kt+t][8nt+g] and W[8kt+t+4][8nt+g]; Bf points at the
// first (n-tile, k-step).
// Warp w owns the NW n-tiles of n-group w % NG (NG = NTL/NW) and the m16
// row tiles of m-group w / NG (the 16 warps split the rows when NG < 16),
// MW row tiles at a time. The k loop runs outside the row tiles, so each
// fragment of W is loaded once for all of them (the loop is unrolled by two,
// so two k-steps' loads are in flight), and each split A fragment serves NW
// n-tiles.
// A pass always computes MW row tiles, without a branch in the k loop: a
// row past M (the last tile's second half at T = 100, or a tile past the
// m-group's) reads row M-1 instead, which stays inside A, and is never
// passed to epi (a row of the product depends only on its own row of A).
// k runs in order (no atomics).
template <int NW, int MW, bool BF, class Epi>
__device__ __forceinline__ void mma_rows(const float* A, int lda, int M,
                                         const float4* __restrict__ Bf, int KT,
                                         int KS, int NTL, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NG = NTL / NW, MG = NG >= NWARP ? 1 : NWARP / NG;
  if (warp >= NG * MG) return;
  const int ng = warp % NG, mg = warp / NG;
  const int MT = (M + 15) >> 4, per = (MT + MG - 1) / MG;
  const int m_end = min(MT, (mg + 1) * per);
  const float4* bw = Bf + (size_t)ng * NW * KT * 32 + lane;
  for (int m0 = mg * per; m0 < m_end; m0 += MW) {
    int ro[MW][2];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ro[i][h] = min((m0 + i) * 16 + g + 8 * h, M - 1) * lda + t;
    float acc[MW][NW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < KS; ++ks) {
      float4 b[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) b[j] = __ldg(bw + ((size_t)j * KT + ks) * 32);
      mma_kstep<NW, MW, BF>(acc, A + ks * 8, ro, b);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int r = (m0 + i) * 16 + g;
      if (m0 + i >= m_end) break;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int col = (ng * NW + j) * 8 + 2 * t;
        if (r < M) epi(r, col, acc[i][j][0], acc[i][j][1]);
        if (r + 8 < M) epi(r + 8, col, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

struct Smem {
  float* s;      // [Tp][ld] residual stream
  float* nrm;    // [Tp][ld] normalised stream
  float* small;  // [SMALL] pooled | mu | h0 | tok0 | reduction slots
  float* area;   // q|k|v [3][Tp][HDP] + scores [QC][Tld], or the MLP chunk
};

// One pre-LN transformer block on the window's stream, in place.
template <bool BF>
__device__ void transformer_block(const BlockW& w, const Smem& m, int T, int Tp,
                                  int H) {
  const int ld = H + 4, Tld = (T + 3) & ~3, heads = H / HD;
  const int KT = H / 8;   // k-steps of a product over H (n-tiles of one over H)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* s = m.s;
  float* qh = m.area;
  float* kh = qh + Tp * HDP;
  float* vh = kh + Tp * HDP;
  float* S = vh + Tp * HDP;

  ln_rows(s, m.nrm, ld, Tp, w.ln1s, w.ln1b, H);
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    // q | k | v of head h, all rows: nrm [Tp,H] x wqkv[:, h*96 .. h*96+95]
    const float* bq = w.bqkv + h * 3 * HD;
    mma_rows<3, 2, BF>(m.nrm, ld, Tp, w.wqkv_f + (size_t)h * 12 * KT * 32, KT,
                       KT, 12, [&](int row, int col, float v0, float v1) {
                         float* dst = qh + (col / HD) * Tp * HDP + row * HDP + col % HD;
                         *reinterpret_cast<float2*>(dst) =
                             make_float2(rd<BF>(v0 + __ldg(bq + col)),
                                         rd<BF>(v1 + __ldg(bq + col + 1)));
                       });
    __syncthreads();

    for (int r0 = 0; r0 < Tp; r0 += QC) {
      const int rows = min(QC, Tp - r0);             // a multiple of TM
      // scores S[i][j] = q[r0+i] . k[j]: a thread owns key j for 4 query rows
      for (int tile = tid; tile < (rows / 4) * T; tile += NT) {
        const int j = tile % T, qg = tile / T;
        const float* kr = kh + j * HDP;
        const float* qr = qh + (r0 + qg * 4) * HDP;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < HD; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + i * HDP + c);
            acc[i] = fmaf(qv.x, kv.x, acc[i]);
            acc[i] = fmaf(qv.y, kv.y, acc[i]);
            acc[i] = fmaf(qv.z, kv.z, acc[i]);
            acc[i] = fmaf(qv.w, kv.w, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) S[(qg * 4 + i) * Tld + j] = acc[i];
      }
      __syncthreads();
      // softmax over the T keys of each row, one warp a row
      for (int i = warp; i < rows; i += NWARP) {
        float* row = S + i * Tld;
        float mx = -3.402823466e+38f;
        for (int j = lane; j < T; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int j = lane; j < T; j += 32) {
          const float e = expf(row[j] - mx);
          row[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int j = lane; j < T; j += 32) row[j] = rd<BF>(row[j] / sum);
      }
      __syncthreads();
      // o[r0+i] = sum_j P[i][j] v[j], written over the dead q rows
      for (int tile = tid; tile < rows * (HD / 4); tile += NT) {
        const int c4 = tile % (HD / 4), i = tile / (HD / 4);
        const float* p = S + i * Tld;
        const float* v = vh + c4 * 4;
        float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < T; ++j) {
          const float pj = p[j];
          const float4 vv = *reinterpret_cast<const float4*>(v + j * HDP);
          o.x = fmaf(pj, vv.x, o.x);
          o.y = fmaf(pj, vv.y, o.y);
          o.z = fmaf(pj, vv.z, o.z);
          o.w = fmaf(pj, vv.w, o.w);
        }
        *reinterpret_cast<float4*>(qh + (r0 + i) * HDP + c4 * 4) =
            make_float4(rd<BF>(o.x), rd<BF>(o.y), rd<BF>(o.z), rd<BF>(o.w));
      }
      __syncthreads();
    }
    // s += o_h [Tp,32] x wo[h*32 .. h*32+31, :] (+ bo with the first head;
    // under BF s rounded after the last)
    const float* bo = w.bo;
    const bool first = h == 0, last = h == heads - 1;
    mma_rows<4, 2, BF>(qh, HDP, Tp, w.wo_f + (size_t)h * (HD / 8) * 32, KT,
                       HD / 8, KT, [&](int row, int col, float v0, float v1) {
                         float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                         float2 v = *dst;
                         v.x += first ? v0 + __ldg(bo + col) : v0;
                         v.y += first ? v1 + __ldg(bo + col + 1) : v1;
                         if (BF && last) v = make_float2(rd<BF>(v.x), rd<BF>(v.y));
                         *dst = v;
                       });
    __syncthreads();
  }

  ln_rows(s, m.nrm, ld, Tp, w.ln2s, w.ln2b, H);
  __syncthreads();
  // MLP, the hidden layer in column chunks of CC
  float* h1 = m.area;
  constexpr int ldh = CC + 4;
  for (int c0 = 0; c0 < 4 * H; c0 += CC) {
    const float* b1 = w.b1 + c0;
    mma_rows<4, 2, BF>(m.nrm, ld, Tp, w.w1_f + (size_t)(c0 / 8) * KT * 32, KT,
                       KT, CC / 8, [&](int row, int col, float v0, float v1) {
                         *reinterpret_cast<float2*>(h1 + row * ldh + col) =
                             make_float2(gelu_tanh(v0 + __ldg(b1 + col)),
                                         gelu_tanh(v1 + __ldg(b1 + col + 1)));
                       });
    __syncthreads();
    // s += the chunk's h1 W2 (+ b2 with the first; under BF s rounded after
    // the last)
    const float* b2 = w.b2;
    const bool first = c0 == 0, last = c0 + CC >= 4 * H;
    mma_rows<4, 2, BF>(h1, ldh, Tp, w.w2_f + (size_t)(c0 / 8) * 32, 4 * KT,
                       CC / 8, KT, [&](int row, int col, float v0, float v1) {
                         float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                         float2 v = *dst;
                         v.x += first ? v0 + __ldg(b2 + col) : v0;
                         v.y += first ? v1 + __ldg(b2 + col + 1) : v1;
                         if (BF && last) v = make_float2(rd<BF>(v.x), rd<BF>(v.y));
                         *dst = v;
                       });
    __syncthreads();
  }
}

template <bool BF, typename IOT>
__global__ void __launch_bounds__(NT)
fused_attention_gate_kernel(const IOT* __restrict__ x,
                            const float* __restrict__ pos,   // [T, H]
                            IOT* __restrict__ resid, float* __restrict__ mse,
                            const AttnW W, int T, int Tp, int D, int H, int Z,
                            int L, int use_ln, int with_resid) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4;
  Smem m;
  m.s = smem;
  m.nrm = m.s + Tp * ld;
  m.small = m.nrm + Tp * ld;
  m.area = m.small + SMALL;
  float* pooled = m.small;             // [H]
  float* mu = pooled + HMAX;           // [Z]
  float* h0 = mu + ZMAX;               // [H]
  float* tok0 = h0 + HMAX;             // [H]
  float* red = tok0 + HMAX;            // [NWARP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t n = blockIdx.x;
  const IOT* xw = x + n * T * D;

  // ---------------- encoder tokens: x in_proj + positions (pad rows 0)
  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    float v = 0.0f;
    if (t < T) {
      for (int d = 0; d < D; ++d)
        v = fmaf(rd<BF>(ld_io(xw + t * D + d)), rd<BF>(__ldg(W.enc.in_w + d * H + c)), v);
      v = rd<BF>(v + __ldg(W.enc.in_b + c) + __ldg(pos + t * H + c));
    }
    m.s[t * ld + c] = v;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) transformer_block<BF>(W.enc.layer[l], m, T, Tp, H);

  // ---------------- final norm, mean over the T real rows
  ln_rows(m.s, m.nrm, ld, T, W.enc.fs, W.enc.fb, H);
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    float a = 0.0f;
    for (int t = 0; t < T; ++t) a += m.nrm[t * ld + c];
    pooled[c] = a / T;
  }
  __syncthreads();
  if (use_ln) {
    if (warp == 0) ln_row(pooled, pooled, W.ln_s, W.ln_b, H, MODEL_EPS, lane);
    __syncthreads();
  }
  // ---------------- latent head (z = mu), decoder token
  for (int z = tid; z < Z; z += NT) {
    float a = 0.0f;
    for (int k = 0; k < H; ++k) a = fmaf(rd<BF>(pooled[k]), rd<BF>(__ldg(W.mu_w + k * Z + z)), a);
    mu[z] = a + __ldg(W.mu_b + z);
  }
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    float a = 0.0f;
    for (int z = 0; z < Z; ++z) a = fmaf(rd<BF>(mu[z]), rd<BF>(__ldg(W.z2h_w + z * H + c)), a);
    h0[c] = tanhf(a + __ldg(W.z2h_b + c));
  }
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    float a = 0.0f;
    for (int k = 0; k < H; ++k) a = fmaf(rd<BF>(h0[k]), rd<BF>(__ldg(W.dec.in_w + k * H + c)), a);
    tok0[c] = a + __ldg(W.dec.in_b + c);
  }
  __syncthreads();
  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    m.s[t * ld + c] = t < T ? rd<BF>(tok0[c] + __ldg(pos + t * H + c)) : 0.0f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) transformer_block<BF>(W.dec.layer[l], m, T, Tp, H);

  // ---------------- final norm, output head, residual, MSE
  ln_rows(m.s, m.nrm, ld, T, W.dec.fs, W.dec.fb, H);
  __syncthreads();
  float part = 0.0f;
  for (int i = tid; i < T * D; i += NT) {
    const int t = i / D, d = i % D;
    const float* r = m.nrm + t * ld;
    float y = 0.0f;
    for (int k = 0; k < H; ++k) y = fmaf(rd<BF>(r[k]), rd<BF>(__ldg(W.out_w + k * D + d)), y);
    y += __ldg(W.out_b + d);
    const float e = ld_io(xw + i) - y;
    const float e2 = e * e;
    if (with_resid) st_io(resid + n * T * D + i, e2);
    part += e2;
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f;
    for (int k = 0; k < NWARP; ++k) a += red[k];
    mse[n] = a / (float)(T * D);
  }
}

// out[i] = x[i] rounded to TF32 by cvt.rna.tf32.f32 (exact = 1) or by the
// kernel's tf32_round (exact = 0), for the checks that the wrapper's packing
// and the kernel's split of A both round as cvt.rna.tf32.f32 does
__global__ void tf32_round_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n, int exact) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = __uint_as_float(exact ? tf32_rna(x[i]) : tf32_round(x[i]));
}

}  // namespace

static int padded_rows(int T) { return (T + TM - 1) / TM * TM; }

// Bytes of dynamic shared memory one window of T steps at width H needs: the
// stream and its normalised copy, the per-window vectors, and the larger of
// one head's q | k | v with a score chunk and one chunk of the MLP's hidden
// layer. The wrapper refuses, before any launch, a shape for which this
// passes what a block may use.
extern "C" long long shm_fused_attention_smem_bytes(int T, int H) {
  const size_t Tp = padded_rows(T), Tld = (T + 3) & ~3;
  const size_t attn = 3 * Tp * HDP + QC * Tld;
  const size_t mlp = Tp * (CC + 4);
  return sizeof(float) *
         (2 * Tp * (H + 4) + SMALL + (attn > mlp ? attn : mlp));
}

namespace {

// the kernel instance at (BF, IOT) on the `w` pointers of the C entries
template <bool BF, typename IOT>
int launch_gate(const IOT* x, const float* pos, IOT* resid, float* mse,
                const void* const* w, int n_w, int N, int T, int D, int H,
                int Z, int L, int use_ln, int with_resid, void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || Z <= 0 ||
      Z > ZMAX || L < 1 || L > LMAX || H % HD || H < HD || H > HMAX ||
      (with_resid && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Tp = padded_rows(T);
  const int smem_bytes = (int)shm_fused_attention_smem_bytes(T, H);
  AttnW W;
  const float* const* p = reinterpret_cast<const float* const*>(w);
  auto stack = [&](StackW& s) {
    s.in_w = *p++;
    s.in_b = *p++;
    for (int l = 0; l < LMAX; ++l) {
      BlockW& b = s.layer[l];
      // wqkv, wo, w1 and w2 as given [in, out] are the plain version's; the
      // kernel reads their fragments
      b.ln1s = *p++; b.ln1b = *p++; p++; b.bqkv = *p++;
      p++; b.bo = *p++; b.ln2s = *p++; b.ln2b = *p++;
      p++; b.b1 = *p++; p++; b.b2 = *p++;
      auto frag = [&] { return reinterpret_cast<const float4*>(*p++); };
      b.wqkv_f = frag(); b.wo_f = frag(); b.w1_f = frag(); b.w2_f = frag();
    }
    s.fs = *p++;
    s.fb = *p++;
  };
  stack(W.enc);
  W.ln_s = *p++; W.ln_b = *p++; W.mu_w = *p++; W.mu_b = *p++;
  W.z2h_w = *p++; W.z2h_b = *p++;
  stack(W.dec);
  W.out_w = *p++; W.out_b = *p++;
  auto kern = fused_attention_gate_kernel<BF, IOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, NT, smem_bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, pos, resid, mse, W, T, Tp, D, H, Z, L, use_ln, with_resid);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes. `w` holds NUM_W = 80 device pointers: the encoder stack
// (in_w in_b, then per layer ln1s ln1b wqkv bqkv wo bo ln2s ln2b w1 b1 w2 b2
// and the fragments of wqkv wo w1 w2 (mma_rows; 16-byte aligned) for LMAX = 2
// layers, then final-norm scale and bias), ln_scale ln_bias mu_w
// mu_b z2h_w z2h_b, the decoder stack in the same order, out_w out_b
// (pointers of an absent layer or LayerNorm may be null). `pos` is the
// [T, H] position table. Returns cudaErrorInvalidValue for a shape the kernel
// does not take, the error of cudaFuncSetAttribute for a window too long for
// a block's shared memory, else the launch's cudaGetLastError(), 0 on success.
extern "C" int shm_fused_attention_gate_f32(
    const float* x, const float* pos, float* resid, float* mse,
    const void* const* w, int n_w, int N, int T, int D, int H, int Z, int L,
    int use_ln, int with_resid, void* stream) {
  return launch_gate<false, float>(x, pos, resid, mse, w, n_w, N, T, D, H, Z,
                                   L, use_ln, with_resid, stream);
}

// The C entry of the bf16 instance: the arguments of
// shm_fused_attention_gate_f32 with `w`'s fragments those of the
// bf16-rounded weights, x and resid bf16 when io_bf16 is 1 and float32 when
// it is 0. Returns as shm_fused_attention_gate_f32 does.
extern "C" int shm_fused_attention_gate_bf16(
    const void* x, const float* pos, void* resid, float* mse,
    const void* const* w, int n_w, int N, int T, int D, int H, int Z, int L,
    int use_ln, int with_resid, int io_bf16, void* stream) {
  if (io_bf16 == 1)
    return launch_gate<true, bf16_t>(
        static_cast<const bf16_t*>(x), pos, static_cast<bf16_t*>(resid), mse,
        w, n_w, N, T, D, H, Z, L, use_ln, with_resid, stream);
  if (io_bf16 != 0) return (int)cudaErrorInvalidValue;
  return launch_gate<true, float>(
      static_cast<const float*>(x), pos, static_cast<float*>(resid), mse, w,
      n_w, N, T, D, H, Z, L, use_ln, with_resid, stream);
}

// out = registers a thread, local memory (spill) bytes a thread, threads a
// block, dynamic shared bytes a block at (T, H), blocks an SM at once.
extern "C" int shm_fused_attention_info(int T, int H, int* out) {
  cudaFuncAttributes a;
  auto kern = fused_attention_gate_kernel<false, float>;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  const int smem_bytes = (int)shm_fused_attention_smem_bytes(T, H);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, NT, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = NT;
  out[3] = smem_bytes;
  out[4] = blocks;
  return 0;
}

// out[i] = x[i] rounded to TF32 by cvt.rna.tf32.f32 (exact = 1) or by the
// kernel's own split of A (exact = 0)
extern "C" int shm_tf32_round(const float* x, float* out, int n, int exact,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  tf32_round_kernel<<<(n + 255) / 256, 256, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(x, out, n, exact);
  return (int)cudaGetLastError();
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
