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
// residual -> LayerNorm -> MLP [H, M] then [M, H] with tanh-GELU -> residual,
// M = mlp_ratio H (C argument M, a multiple of CC = 128; the TPU kernel's
// check at :457).
//
// The softmax has the TPU kernel's two forms (C argument `streaming`). The
// packed form (fused_attention.py:245-249) divides each row by its sum,
// then P.V. The streaming form (:292-330) walks the keys in blocks of KB =
// 128, the TPU kernel's width, whose edges set where the running max
// rescales: per row, m from -1e30 and l from 0; a block's m_new = max(m,
// rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new), l = l alpha +
// sum p, o = o alpha + p.V (p rounded to bf16 under BF, l summing it
// unrounded); o / l after the last block.
//
// H in {32,64,128}, heads = H/32 of 32 columns, MLP width M, L in {1,2},
// D <= 128, Z <= 128, any T >= 1: a window whose buffers fit a block's shared
// memory runs in the resident body, a longer one in the long body (below;
// the wrapper's plan() picks, from the same byte counts). Weights come in
// [in, out] layout, the four products' as TF32 fragments (below); wqkv is
// packed per head: columns h*96 .. h*96+95 hold q|k|v of head h. The TPU
// kernel's paddings (T to 128, H to 128 lanes) and its key mask exist only
// for its tiling and are not carried over: this kernel attends over exactly
// T keys, so the last key block holds T - 128 floor((T-1)/128) of them.
//
// Bound on this card. Per window and block: QKV 2*T*H*3H, scores and PV
// 2*2*T*T*H, output projection 2*T*H*H, MLP 2*2*T*H*M; for the 4DOF preset
// (T=100, D=12, H=128, M=4H, L=2+2) about 178 MFLOP a window, 970 GFLOP at
// N=5,440: ~14.5 ms at the 67 TFLOP/s float32 rate without tensor cores
// (~1 ms in bf16 on the tensor cores). The bytes (x, resid, weights once) are
// ~55 MB, ~17 us. So the kernel is bound by operations. The four weight
// products are ~89% of them (~862 GFLOP at N=5,440): in 3xTF32 on the
// tensor cores (three products each, 495 TFLOP/s TF32) ~5.2 ms.
//
// Design of the resident body. One block of 512 threads owns one window and
// keeps its whole pass in shared memory; only x, the weights, resid and mse
// touch device memory.
//   * The residual stream s [T,H] and its normalised copy nrm [T,H] stay
//     resident (rows padded to a multiple of 8, row stride H+4 floats). One
//     window's QKV for all heads (154 KB at 4DOF) would not fit beside them,
//     so attention runs head by head: q, k, v of one head [T,32] each, the
//     scores of 32 query rows at a time [32,T], and the head's output written
//     over its dead q rows, then multiplied into s by the head's 32 rows of
//     the output weight. Nothing of another window or of a column >= T is
//     ever in a softmax row.
//   * The MLP's hidden layer [T,M] (205 KB at M = 4H = 512) is cut into
//     column chunks of CC = 128 that reuse the attention buffers: gelu(nrm
//     W1[:,chunk]) then s += that times W2[chunk,:]. M is a runtime bound of
//     the chunk loop and W2's k-steps (M/8); shared memory does not depend
//     on it.
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
//   * The streaming form (template STREAM) keeps the score chunk [32, T] of
//     the packed form: one warp a row walks its key blocks, stores p and
//     keeps each block's alpha and the row's l in the per-window vectors
//     (free while the blocks run); P.V then sums each block apart and
//     rescales. The packed instance's arithmetic is the one it had before
//     the form existed (the 4DOF attention root's mse, the same bits on the
//     card). The window fits only up to T = 268 (H = 32), so a row has at
//     most NKB_RES key blocks. The long body's streaming form gives these
//     bits too but takes 1.14-1.23x the time at T = 100 and 200 (PERF.md
//     §6), so the resident body keeps its own.
// Scores, softmax and P.V stay on the FMA pipes in float32; several windows
// a block and wgmma are later work.
//
// Design of the long body (fused_attention_long_kernel), for a window whose
// buffers pass a block's shared memory (at H = 128 past T = 136, at 64 past
// 208, at 32 past 268), for any T. A persistent grid: as many blocks as the
// card runs at once (one an SM: 145-205 KB of shared memory and 512 threads),
// block b running windows b, b + grid, ...; each block owns a slot of device
// memory (the wrapper allocates grid slots; 4 Tp H floats each, 1 MB at T =
// 512, H = 128) that holds the window's stream s [Tp, H] and every head's
// q | k | v [heads][3][Tp][32]. Shared memory holds a tile of QL = 128 rows
// of s and, in turn, a head's 128 query rows, one key block of k and v
// [128, 36] each and its scores [128, 132], or the tile's normalised rows and
// one MLP column chunk. A layer runs in two passes over the row tiles:
// (A) LayerNorm and q | k | v of every head (one mma_rows over 3H columns)
// into the slot; (B) per tile of query rows, each head's attention over the
// key blocks, streamed from the slot, its output projection added to the
// tile, then the tile's LayerNorm and MLP, and the tile written back. Every
// row-local step (LayerNorm, the products, the MLP, the pool, the head) is
// the resident body's arithmetic on fewer rows, and each softmax row and
// P.V element sums in the resident body's order, so the streaming form gives
// the resident body's bits. Its packed form takes two passes over the key
// blocks: the first finds each row's max and (online) denominator, the
// second forms p = exp(s - m) / l, rounds it under BF and sums P.V in the
// packed order; its denominator rounds in another order than the resident
// body's one sum. Bound: the work is the resident body's (below), as many
// operations a window; the slot's traffic (~8 passes over 4 Tp H floats a
// layer, from L2 mostly) adds bytes the bound does not count. At T = 512,
// H = 128, L = 2+2, N = 1,024, gate-only: 1,377.65 GFLOP, 20.56 ms at the
// 67 TFLOP/s float32 rate; the scores and P.V, 40% of them, and the packed
// form's second pass of scores run on the FMA pipes (PERF.md §6).
//
// The bf16 instance (C entry shm_fused_attention_gate_bf16) is the TPU
// kernel with dtype=bf16 (fused_attention.py:206-212, :252-353): every
// product's two operands rounded to bf16 and summed in float32. The residual
// stream s is rounded as the TPU kernel stores it: after the tokens, after
// the output projection (its last head) and after the MLP (its last chunk);
// q | k | v, the probabilities and the attention output o as they are
// stored; the packed form rounds p after the softmax's division, the
// streaming form before P.V (its mm casts p to bf16) and divides o by the
// float32 l after. LayerNorm, softmax and the pooled summary stay float32.
// Its io is float32 or bf16 (template IOT): with bf16 the window is read as
// bf16 (in the residual's x - y too) and the residual stored bf16. The
// token, latent and output heads round both operands on the FMA pipes. Its
// bound at N=5,440 (4DOF preset) is the 970.6 GFLOP at the 989 TFLOP/s bf16
// rate, 0.98 ms.
//
// Design of the bf16 resident body (fused_attention_bf16_kernel). Every
// product runs on mma.sync.m16n8k16 bf16 with float32 sums, from operands
// stored as bf16 in shared memory: LayerNorm's output, q | k | v, P (in
// registers), o and the MLP's GELU chunk; s stays float32 [Tp][H+4]. A
// comes by ldmatrix (x4) from rows of 8 + a multiple of 64 bf16 (80, 144 or
// 272 bytes), so an ldmatrix's eight rows sit on distinct banks. The four
// weight products read the wrapper's m16n8k16 B fragments of the
// bf16-rounded weights, 2 bytes a weight (uint2 {b0, b1} a lane, n-tile and
// k-step; the float32 body's fragments take 8): in mma16_rows a k-step's
// fragments serve two row tiles and each ldmatrix of A its warp's n-tiles.
// The heads go in groups of HG (all of them while their q | k | v fits
// beside s; at the 4DOF preset all four): one QKV product over the group's
// 96 HG columns, then attend16, one warp a head and 16 query rows (28 tasks
// for 16 warps at T = 100), its scores q.k^T (k by ldmatrix), softmax and
// P.V (P as the A fragments of its own score accumulators, v by
// ldmatrix.trans, the keys padded to 16 with zero rows of v past the padded
// stream) in registers, no barrier inside; then one output projection over
// the group's rows of W_o. Every product's k-steps go in pairs chained from
// zero, each pair's partial added to the float32 sum to nearest (rows 1 and
// 6's sum: the tensor cores truncate inside a chain); a score is one
// such pair. No atomics: two launches give the same bits. Shared memory at
// the 4DOF preset: 176.6 KB (the float32 body 169.6 KB), one block of 512
// threads an SM; a window fits up to T = 208 at H = 128 (HG 1), past the
// float32 body's 136 (328 at H = 64, 464 at 32).
// What binds it (PERF.md §6): not the tensor cores (the mma turned
// into one FADD each left the time as it was), nor the weight fragments'
// traffic (-7% when every k-step read one L1-resident fragment) or the
// ldmatrix (-5% without it); the phases between the barriers are short and
// latency-bound at 16 warps and 128 registers a thread (ptxas spills 280 B
// a thread). Two blocks of 256 threads an SM (HG 1), a warp's slice of W
// held in registers, the next k-pair's fragments prefetched, four row tiles
// a warp, or full unrolling each ran slower.
// The long body's bf16 instance keeps its arithmetic (float32 tiles in
// shared memory, A rounded to bf16 in registers, one TF32 mma a k-step of 8
// on the TF32 fragments of the bf16-rounded weights, *_frag_bf16; scores and
// P.V on the FMA pipes).
//
// Accurate expf/tanhf (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int HD = 32;          // head size
constexpr int HDP = HD + 4;     // padded row of the per-head q/k/v buffers
constexpr int QC = 32;          // query rows per score chunk
constexpr int CC = 128;         // MLP hidden columns per chunk (divides M)
constexpr int TM = 8;           // rows are padded to a multiple of TM
constexpr int LMAX = 2;
constexpr int HMAX = 128;
constexpr int ZMAX = 128;       // the JAX kernel's bound: fc_mu padded to 128 lanes
constexpr int DMAX = 128;
constexpr int SMALL = 512;      // floats for the per-window vectors
static_assert(3 * HMAX + ZMAX <= SMALL, "pooled | mu | h0 | tok0 fit SMALL");
constexpr int KB = 128;         // keys a block of the streaming softmax
constexpr int NKB_RES = 4;      // key blocks a resident window may have
constexpr int QL = 128;         // rows a tile (and query rows a chunk) of the
                                // long body
constexpr int NUM_W = 2 * (4 + 16 * LMAX) + 8;
constexpr long long SMEM_LIMIT = 232448;   // shared bytes a block may use (H100)
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

// the four products' weights as fragments (float4 TF32 fragments in the
// float32 instance and the long body's bf16 one, uint2 m16n8k16 bf16
// fragments in the bf16 resident body), the rest as given
struct BlockW {
  const float *ln1s, *ln1b, *bqkv, *bo, *ln2s, *ln2b, *b1, *b2;
  const void *wqkv_f, *wo_f, *w1_f, *w2_f;
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
// a_b b_b into one float32 accumulator. Under BF (the long body's bf16
// instance) each A element is rounded to bf16 and the k-step adds a_b b_b
// alone (b holds bf16-rounded weights).
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

// two float32 values as bf16x2, lo in the low half, each rounded to nearest
// even
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 accumulators.
// Lane (g = lane/4, t = lane%4): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
// a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; b0 = B[2t, 2t+1][g],
// b1 = B[2t+8, 2t+9][g] (lower k in the low half); d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A weight product on the tensor cores in 3xTF32. For every row < M and
// every column pair (col, col+1) of the NTL n-tiles (8 columns each) from
// n-tile nt0:
//   epi(row, col, sum_k A[row][k] W[k][col], sum_k A[row][k] W[k][col+1])
// over the KS k-steps (8 rows of W each) from k-step kt0; A [M][lda] is in
// shared memory, col counted from n-tile nt0. W [K, N] comes packed by the
// wrapper as float4 {b0 big, b1 big, b0 small, b1 small} at
// [(nt * KT + kt) * 32 + lane], KT = K/8, lane (g, t) holding W[8kt+t][8nt+g]
// and W[8kt+t+4][8nt+g] (under BF the same of the bf16-rounded weight, the
// query's scale folded in first, small parts zero).
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
                                         const void* Bw, int KT, int nt0,
                                         int kt0, int KS, int NTL, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NG = NTL / NW, MG = NG >= NWARP ? 1 : NWARP / NG;
  if (warp >= NG * MG) return;
  const int ng = warp % NG, mg = warp / NG;
  const int MT = (M + 15) >> 4, per = (MT + MG - 1) / MG;
  const int m_end = min(MT, (mg + 1) * per);
  const float4* bw = static_cast<const float4*>(Bw) +
                     ((size_t)(nt0 + ng * NW) * KT + kt0) * 32 + lane;
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

// One key block [j0, j1) of one row of the streaming softmax, by one warp:
// the row's running max m and denominator l move to the block's, the row's
// scores become p = exp(s - m_new) (rounded under BF; l sums them
// unrounded), and alpha = exp(m_old - m_new) is returned in `alpha` (lane 0
// writes it). The packed form's max starts from -FLT_MAX, the streaming
// form's running max from -1e30, as the TPU kernel's do.
template <bool BF>
__device__ __forceinline__ void stream_block(float* row, int j0, int j1,
                                             int lane, float& m, float& l,
                                             float& alpha) {
  float mx = -3.402823466e+38f;
  for (int j = j0 + lane; j < j1; j += 32) mx = fmaxf(mx, row[j]);
  const float m_new = fmaxf(m, warp_max(mx));
  const float a = expf(m - m_new);
  float sum = 0.0f;
  for (int j = j0 + lane; j < j1; j += 32) {
    const float e = expf(row[j] - m_new);
    row[j] = rd<BF>(e);
    sum += e;
  }
  l = l * a + warp_sum(sum);
  m = m_new;
  if (lane == 0) alpha = a;
}

// o + sum_{j0 <= j < j1} p[j] v[j] for 4 columns of v (row stride HDP), j in
// order
__device__ __forceinline__ float4 pv_sum(float4 o, const float* p,
                                         const float* v, int j0, int j1) {
  for (int j = j0; j < j1; ++j) {
    const float pj = p[j];
    const float4 vv = *reinterpret_cast<const float4*>(v + j * HDP);
    o.x = fmaf(pj, vv.x, o.x);
    o.y = fmaf(pj, vv.y, o.y);
    o.z = fmaf(pj, vv.z, o.z);
    o.w = fmaf(pj, vv.w, o.w);
  }
  return o;
}

// o alpha + blk, the streaming form's step of P.V
__device__ __forceinline__ float4 rescale_add(float4 o, float a, float4 blk) {
  return make_float4(fmaf(o.x, a, blk.x), fmaf(o.y, a, blk.y),
                     fmaf(o.z, a, blk.z), fmaf(o.w, a, blk.w));
}

struct Smem {
  float* s;      // [Tp][ld] residual stream
  float* nrm;    // [Tp][ld] normalised stream
  float* small;  // [SMALL] pooled | mu | h0 | tok0, then the MSE's reduction
                 // slots over pooled; in a block of the streaming form,
                 // alpha [QC][NKB_RES] | l [QC] over pooled | mu
  float* area;   // q|k|v [3][Tp][HDP] + scores [QC][Tld], or the MLP chunk
};

// One pre-LN transformer block of the float32 resident body on the window's
// stream, in place; STREAM: the streaming softmax.
template <bool STREAM>
__device__ void transformer_block(const BlockW& w, const Smem& m, int T, int Tp,
                                  int H, int M) {
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
    mma_rows<3, 2, false>(m.nrm, ld, Tp, w.wqkv_f, KT, h * 12, 0, KT, 12,
                          [&](int row, int col, float v0, float v1) {
                            float* dst = qh + (col / HD) * Tp * HDP + row * HDP + col % HD;
                            *reinterpret_cast<float2*>(dst) =
                                make_float2(v0 + __ldg(bq + col), v1 + __ldg(bq + col + 1));
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
      if constexpr (STREAM) {
        // each row's key blocks: p stored, alpha a block and l kept
        for (int i = warp; i < rows; i += NWARP) {
          float mrun = -1e30f, l = 0.0f;
          for (int b = 0, j0 = 0; j0 < T; ++b, j0 += KB)
            stream_block<false>(S + i * Tld, j0, min(T, j0 + KB), lane, mrun, l,
                             m.small[i * NKB_RES + b]);
          if (lane == 0) m.small[QC * NKB_RES + i] = l;
        }
        __syncthreads();
        // o[r0+i] = (sum over blocks, rescaled, of P_b v_b) / l, written over
        // the dead q rows
        for (int tile = tid; tile < rows * (HD / 4); tile += NT) {
          const int c4 = tile % (HD / 4), i = tile / (HD / 4);
          float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int b = 0, j0 = 0; j0 < T; ++b, j0 += KB)
            o = rescale_add(o, m.small[i * NKB_RES + b],
                            pv_sum(make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                                   S + i * Tld, vh + c4 * 4, j0, min(T, j0 + KB)));
          const float l = m.small[QC * NKB_RES + i];
          *reinterpret_cast<float4*>(qh + (r0 + i) * HDP + c4 * 4) =
              make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
        }
        __syncthreads();
      } else {
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
          for (int j = lane; j < T; j += 32) row[j] = row[j] / sum;
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
          *reinterpret_cast<float4*>(qh + (r0 + i) * HDP + c4 * 4) = o;
        }
        __syncthreads();
      }
    }
    // s += o_h [Tp,32] x wo[h*32 .. h*32+31, :] (+ bo with the first head)
    const float* bo = w.bo;
    const bool first = h == 0;
    mma_rows<4, 2, false>(qh, HDP, Tp, w.wo_f, KT, 0, h * (HD / 8), HD / 8, KT,
                          [&](int row, int col, float v0, float v1) {
                            float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                            float2 v = *dst;
                            v.x += first ? v0 + __ldg(bo + col) : v0;
                            v.y += first ? v1 + __ldg(bo + col + 1) : v1;
                            *dst = v;
                          });
    __syncthreads();
  }

  ln_rows(s, m.nrm, ld, Tp, w.ln2s, w.ln2b, H);
  __syncthreads();
  // MLP, the hidden layer in column chunks of CC
  float* h1 = m.area;
  constexpr int ldh = CC + 4;
  for (int c0 = 0; c0 < M; c0 += CC) {
    const float* b1 = w.b1 + c0;
    mma_rows<4, 2, false>(m.nrm, ld, Tp, w.w1_f, KT, c0 / 8, 0, KT, CC / 8,
                          [&](int row, int col, float v0, float v1) {
                            *reinterpret_cast<float2*>(h1 + row * ldh + col) =
                                make_float2(gelu_tanh(v0 + __ldg(b1 + col)),
                                            gelu_tanh(v1 + __ldg(b1 + col + 1)));
                          });
    __syncthreads();
    // s += the chunk's h1 W2 (+ b2 with the first)
    const float* b2 = w.b2;
    const bool first = c0 == 0;
    mma_rows<4, 2, false>(h1, ldh, Tp, w.w2_f, M / 8, 0, c0 / 8, CC / 8, KT,
                          [&](int row, int col, float v0, float v1) {
                            float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                            float2 v = *dst;
                            v.x += first ? v0 + __ldg(b2 + col) : v0;
                            v.y += first ? v1 + __ldg(b2 + col + 1) : v1;
                            *dst = v;
                          });
    __syncthreads();
  }
}

// sum over k < n of a(k) b(k), fmaf in k order; under BF (the bf16
// bodies) unrolled by U, so that the loads of U terms are in flight at once
// (the float32 bodies keep the compiler's own choice)
template <bool BF, int U, class FA, class FB>
__device__ __forceinline__ float dot(int n, FA a, FB b) {
  float y = 0.0f;
  if constexpr (BF) {
#pragma unroll (U)
    for (int k = 0; k < n; ++k) y = fmaf(a(k), b(k), y);
  } else {
    for (int k = 0; k < n; ++k) y = fmaf(a(k), b(k), y);
  }
  return y;
}

// the encoder's token at step t < T, column c: x in_proj + positions
template <bool BF, typename IOT>
__device__ __forceinline__ float enc_token(const IOT* xw, const StackW& enc,
                                           const float* pos, int t, int c,
                                           int D, int H) {
  const float v = dot<BF, 4>(D, [&](int d) { return rd<BF>(ld_io(xw + t * D + d)); },
                             [&](int d) { return rd<BF>(__ldg(enc.in_w + d * H + c)); });
  return rd<BF>(v + __ldg(enc.in_b + c) + __ldg(pos + t * H + c));
}

// the output head's column d from a row r of the decoder's final norm
template <bool BF>
__device__ __forceinline__ float out_head(const float* r, const AttnW& W,
                                          int d, int H, int D) {
  const float y = dot<BF, 16>(H, [&](int k) { return rd<BF>(r[k]); },
                              [&](int k) { return rd<BF>(__ldg(W.out_w + k * D + d)); });
  return y + __ldg(W.out_b + d);
}

// the per-window vectors in `small`: pooled [H] | mu [Z] | h0 [H] | tok0 [H],
// each slot as wide as its largest (HMAX, ZMAX); the MSE's warp sums
// [NWARP] over pooled, read only after the decoder, when pooled, mu and h0
// are dead (a streaming block's alpha and l sit over pooled | mu too, and
// tok0 is read before the decoder's first block)
__device__ __forceinline__ float* small_mu(float* small) { return small + HMAX; }
__device__ __forceinline__ float* small_h0(float* small) { return small + HMAX + ZMAX; }
__device__ __forceinline__ float* small_tok0(float* small) { return small + 2 * HMAX + ZMAX; }
__device__ __forceinline__ float* small_red(float* small) { return small; }

// the pooled summary (in small) -> [LayerNorm eps 1e-5] -> mu (z = mu) ->
// h0 = tanh(fc_latent_to_hidden(mu)) -> the decoder's token tok0 (in small)
template <bool BF>
__device__ void latent_head(const AttnW& W, float* small, int H, int Z,
                            int use_ln) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pooled = small;
  float* mu = small_mu(small);
  float* h0 = small_h0(small);
  float* tok0 = small_tok0(small);
  if (use_ln) {
    if (warp == 0) ln_row(pooled, pooled, W.ln_s, W.ln_b, H, MODEL_EPS, lane);
    __syncthreads();
  }
  for (int z = tid; z < Z; z += NT) {
    const float a = dot<BF, 16>(H, [&](int k) { return rd<BF>(pooled[k]); },
                                [&](int k) { return rd<BF>(__ldg(W.mu_w + k * Z + z)); });
    mu[z] = a + __ldg(W.mu_b + z);
  }
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    const float a = dot<BF, 8>(Z, [&](int z) { return rd<BF>(mu[z]); },
                               [&](int z) { return rd<BF>(__ldg(W.z2h_w + z * H + c)); });
    h0[c] = tanhf(a + __ldg(W.z2h_b + c));
  }
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    const float a = dot<BF, 16>(H, [&](int k) { return rd<BF>(h0[k]); },
                                [&](int k) { return rd<BF>(__ldg(W.dec.in_w + k * H + c)); });
    tok0[c] = a + __ldg(W.dec.in_b + c);
  }
  __syncthreads();
}

// the window's MSE from each thread's part: warp sums, then thread 0 in
// warp order
__device__ __forceinline__ void store_mse(float part, float* red, float* mse,
                                          int T, int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f;
    for (int k = 0; k < NWARP; ++k) a += red[k];
    *mse = a / (float)(T * D);
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(NT)
fused_attention_gate_kernel(const float* __restrict__ x,
                            const float* __restrict__ pos,   // [T, H]
                            float* __restrict__ resid, float* __restrict__ mse,
                            const AttnW W, int T, int Tp, int D, int H, int M,
                            int Z, int L, int use_ln, int with_resid) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4;
  Smem m;
  m.s = smem;
  m.nrm = m.s + Tp * ld;
  m.small = m.nrm + Tp * ld;
  m.area = m.small + SMALL;
  float* pooled = m.small;             // [H]
  float* tok0 = small_tok0(m.small);   // [H]

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const float* xw = x + n * T * D;

  // ---------------- encoder tokens: x in_proj + positions (pad rows 0)
  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    m.s[t * ld + c] = t < T ? enc_token<false>(xw, W.enc, pos, t, c, D, H) : 0.0f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l)
    transformer_block<STREAM>(W.enc.layer[l], m, T, Tp, H, M);

  // ---------------- final norm, mean over the T real rows
  ln_rows(m.s, m.nrm, ld, T, W.enc.fs, W.enc.fb, H);
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    float a = 0.0f;
    for (int t = 0; t < T; ++t) a += m.nrm[t * ld + c];
    pooled[c] = a / T;
  }
  __syncthreads();
  // ---------------- latent head (z = mu), decoder token
  latent_head<false>(W, m.small, H, Z, use_ln);
  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    m.s[t * ld + c] = t < T ? tok0[c] + __ldg(pos + t * H + c) : 0.0f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l)
    transformer_block<STREAM>(W.dec.layer[l], m, T, Tp, H, M);

  // ---------------- final norm, output head, residual, MSE
  ln_rows(m.s, m.nrm, ld, T, W.dec.fs, W.dec.fb, H);
  __syncthreads();
  float part = 0.0f;
  for (int i = tid; i < T * D; i += NT) {
    const int t = i / D, d = i % D;
    const float e = ld_io(xw + i) - out_head<false>(m.nrm + t * ld, W, d, H, D);
    const float e2 = e * e;
    if (with_resid) st_io(resid + n * T * D + i, e2);
    part += e2;
  }
  store_mse(part, small_red(m.small), mse + n, T, D);
}

// ------------------------------------------------------- bf16 resident body

// row stride (bf16 elements) of the bf16 resident body's buffers w columns
// wide: 8 more, so that the eight rows an ldmatrix reads sit on distinct
// banks (80, 144 or 272 bytes a row at w = 32, 64, 128)
__host__ __device__ constexpr int bld(int w) { return w + 8; }

// four 8x8 bf16 matrices of shared memory: lanes 8q..8q+7 give the row
// addresses of matrix q, and r[q] holds lane (g, t)'s {M_q[g][2t],
// M_q[g][2t+1]}, or under TRANS {M_q[2t][g], M_q[2t+1][g]}
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// the A fragment (mma_bf16) of rows r0 .. r0+15, columns k0 .. k0+15 of a
// bf16 [M][lda] buffer; a row past M reads row M-1
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4], const bf16_t* A, int lda,
                                       int r0, int M, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4<false>(a, A + min(r0 + (lane & 15), M - 1) * lda + k0 + (lane >> 4) * 8);
}

// acc += part, each to nearest: how a pair of k-steps, chained from zero on
// the tensor cores, reaches the float32 sum
template <int N>
__device__ __forceinline__ void add_part(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[j][r]);
}

// A weight product of the bf16 resident body on the tensor cores. For every
// row < M and every column pair (col, col+1) of the NTL n-tiles from n-tile
// nt0: epi(row, col, sum_k A[row][k] W[k][col], ... W[k][col+1]) over the
// KS k-steps of 16 from k-step ks0 (col counted from n-tile nt0). A is bf16
// [M][lda] in shared memory, its k-th column at A + k; W comes as the
// wrapper's m16n8k16 fragments of the bf16-rounded weight, uint2 {b0, b1}
// at Bw[(nt * KT + ks) * 32 + lane], KT k-steps an n-tile.
// Warp w owns the NW n-tiles of n-group w % NG (NG = NTL/NW) and the row
// tiles of m-group w / NG (the 16 warps split the rows when NG < 16), MW
// row tiles at a time: a k-step's NW fragments of W (one 8-byte load a
// lane each) serve its MW row tiles, and each ldmatrix of A its NW n-tiles.
// The k-steps go in pairs, each chained from zero, and each pair's partial
// is added to the float32 sum to nearest (add_part), in k order. Holding a
// warp's whole slice of W in registers instead spilled at 128 registers a
// thread (PERF.md §6).
template <int NW, int MW, class Epi>
__device__ __forceinline__ void mma16_rows(const bf16_t* A, int lda, int M,
                                           const uint2* __restrict__ Bw, int KT,
                                           int nt0, int ks0, int KS, int NTL,
                                           Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NG = NTL / NW, MG = NG >= NWARP ? 1 : NWARP / NG;
  const int MT = (M + 15) >> 4, per = (MT + MG - 1) / MG;
  for (int task = warp; task < NG * MG; task += NWARP) {
    const int ng = task % NG, mg = task / NG;
    const uint2* bw = Bw + ((size_t)(nt0 + ng * NW) * KT + ks0) * 32 + lane;
    const int m_end = min(MT, (mg + 1) * per);
    for (int m0 = mg * per; m0 < m_end; m0 += MW) {
      float acc[MW][NW][4] = {};
#pragma unroll 2
      for (int kp = 0; kp < KS; kp += 2) {
        uint2 b[2][NW];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int j = 0; j < NW; ++j)
            if (kp + kk < KS) b[kk][j] = __ldg(bw + ((size_t)j * KT + kp + kk) * 32);
        float part[MW][NW][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kp + kk >= KS) break;
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            if (m0 + i >= m_end) break;
            unsigned a[4];
            ldsm_a(a, A, lda, (m0 + i) * 16, M, (kp + kk) * 16);
#pragma unroll
            for (int j = 0; j < NW; ++j) mma_bf16(part[i][j], a, b[kk][j].x, b[kk][j].y);
          }
        }
#pragma unroll
        for (int i = 0; i < MW; ++i) add_part(acc[i], part[i]);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        if (m0 + i >= m_end) break;
        const int r = (m0 + i) * 16 + g;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int col = (ng * NW + j) * 8 + 2 * t;
          if (r < M) epi(r, col, acc[i][j][0], acc[i][j][1]);
          if (r + 8 < M) epi(r + 8, col, acc[i][j][2], acc[i][j][3]);
        }
      }
    }
  }
}

// One row of LayerNorm by one warp (ln_row's arithmetic), stored as bf16
__device__ __forceinline__ void ln_row16(const float* in, bf16_t* out,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, int H,
                                         int lane) {
  float sum = 0.0f, sq = 0.0f;
#pragma unroll 4
  for (int c = lane; c < H; c += 32) {
    const float v = in[c];
    sum += v;
    sq = fmaf(v, v, sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / H;
  const float var = fmaxf(sq / H - mean * mean, 0.0f);
  const float r = 1.0f / sqrtf(var + STACK_EPS);
#pragma unroll 4
  for (int c = lane; c < H; c += 32)
    out[c] = (bf16_t)(__float_as_uint(
        rd<true>((in[c] - mean) * r * __ldg(scale + c) + __ldg(bias + c))) >> 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The attention of a group of HG heads on the tensor cores, one warp a task
// (a head and a tile of 16 query rows), its scores, softmax and P.V in
// registers. qkv holds q | k | v [3][Tk][ldq] in bf16, head hl's 32 columns
// at hl * 32 of each row; rows T .. Tk-1 of k and v are pad tokens or zeros,
// so every product is finite. The scores of a key block (KB keys, 16 n8
// tiles) are q.k^T, one k-step pair (head size 32) chained from zero; keys
// at or past T are -inf, so their p is exactly 0. P enters P.V as the A
// fragments of its own accumulators (the C fragments of two n8 tiles are
// the A fragment of one k-step), v as B by ldmatrix.trans; P.V's k-steps
// (16 keys) go in pairs as mma16_rows' do. The packed form (one key
// block: one pass; more: a first pass for each row's max and online
// denominator) rounds p = exp(s - m) / l to bf16; the streaming form starts
// m from -1e30, rounds p = exp(s - m_new) for P.V, sums l from the
// unrounded p, rescales o by alpha and adds the block's P_b V_b to it, and
// divides by l at the end. The output o, rounded to bf16, is written over
// the task's own q rows.
template <bool STREAM>
__device__ void attend16(bf16_t* qkv, int ldq, int Tk, int T, int HG) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkb = (T + KB - 1) / KB;
  for (int task = warp; task < HG * (Tk / 16); task += NWARP) {
    const int hl = task % HG, r0 = task / HG * 16;
    bf16_t* q = qkv + hl * HD;
    const bf16_t* k = q + Tk * ldq;
    const bf16_t* v = k + Tk * ldq;
    unsigned qa[2][4];
    ldsm_a(qa[0], q, ldq, r0, Tk, 0);
    ldsm_a(qa[1], q, ldq, r0, Tk, 16);
    float m[2], l[2] = {0.0f, 0.0f}, o[4][4] = {};
    m[0] = m[1] = STREAM ? -1e30f : -3.402823466e+38f;
    for (int pass = STREAM || nkb == 1 ? 1 : 0; pass < 2; ++pass) {
      for (int b = 0; b < nkb; ++b) {
        const int j0 = b * KB, ksn = (min(KB, T - j0) + 15) / 16;
        float sc[KB / 8][4];
#pragma unroll
        for (int jt = 0; jt < KB / 8; ++jt) {
          if (jt >= 2 * ksn) break;
          unsigned kb[4];
          ldsm_x4<false>(kb, k + (j0 + jt * 8 + (lane & 7)) * ldq + (lane >> 3) * 8);
          sc[jt][0] = sc[jt][1] = sc[jt][2] = sc[jt][3] = 0.0f;
          mma_bf16(sc[jt], qa[0], kb[0], kb[1]);
          mma_bf16(sc[jt], qa[1], kb[2], kb[3]);
          const int j = j0 + jt * 8 + 2 * t;
          if (j >= T) sc[jt][0] = sc[jt][2] = __int_as_float(0xff800000);   // -inf
          if (j + 1 >= T) sc[jt][1] = sc[jt][3] = __int_as_float(0xff800000);
        }
        float bm[2] = {-3.402823466e+38f, -3.402823466e+38f};
#pragma unroll
        for (int jt = 0; jt < KB / 8; ++jt) {
          if (jt >= 2 * ksn) break;
          bm[0] = fmaxf(bm[0], fmaxf(sc[jt][0], sc[jt][1]));
          bm[1] = fmaxf(bm[1], fmaxf(sc[jt][2], sc[jt][3]));
        }
        float alpha[2], mp[2];   // the block's rescale; the max p subtracts
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bm[h] = quad_max(bm[h]);
          const float m_new = fmaxf(m[h], bm[h]);
          alpha[h] = expf(m[h] - m_new);
          mp[h] = STREAM || pass == 0 ? m_new : nkb == 1 ? bm[h] : m[h];
        }
        // exp(s - mp) in place, and its row sums
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int jt = 0; jt < KB / 8; ++jt) {
          if (jt >= 2 * ksn) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[jt][e] = expf(sc[jt][e] - mp[e >> 1]);
            sum[e >> 1] += sc[jt][e];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] = quad_sum(sum[h]);
          if (STREAM || pass == 0) {
            l[h] = l[h] * alpha[h] + sum[h];
            m[h] = mp[h];
          } else if (nkb == 1) {
            l[h] = sum[h];
          }
        }
        if (pass == 0) continue;
        // P.V of the block, chained into o (the streaming form's rescaled
        // first): p rounded to bf16 as it is packed, the packed form's after
        // the division
        if constexpr (STREAM) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        }
#pragma unroll
        for (int kp = 0; kp < KB / 16; kp += 2) {
          if (kp >= ksn) break;
          float part[4][4] = {};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int ks = kp + kk;
            if (ks >= ksn) break;
            float p[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p[u][e] = STREAM ? sc[2 * ks + u][e] : sc[2 * ks + u][e] / l[e >> 1];
            const unsigned pa[4] = {pack_bf16x2(p[0][0], p[0][1]), pack_bf16x2(p[0][2], p[0][3]),
                                    pack_bf16x2(p[1][0], p[1][1]), pack_bf16x2(p[1][2], p[1][3])};
#pragma unroll
            for (int dp = 0; dp < 2; ++dp) {
              unsigned vb[4];
              ldsm_x4<true>(vb, v + (j0 + ks * 16 + (lane & 15)) * ldq + dp * 16 +
                                    (lane >> 4) * 8);
              mma_bf16(part[2 * dp], pa, vb[0], vb[1]);
              mma_bf16(part[2 * dp + 1], pa, vb[2], vb[3]);
            }
          }
          add_part(o, part);
        }
      }
    }
    // o (the streaming form's divided by l), rounded, over this task's q rows
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = STREAM ? l[h] : 1.0f;
        *reinterpret_cast<unsigned*>(q + (r0 + g + 8 * h) * ldq + n * 8 + 2 * t) =
            pack_bf16x2(STREAM ? o[n][2 * h] / d : o[n][2 * h],
                        STREAM ? o[n][2 * h + 1] / d : o[n][2 * h + 1]);
      }
  }
}

// One pre-LN transformer block of the bf16 resident body on the window's
// stream s (float32, row stride H+4), in place: LayerNorm into xb (bf16,
// bld(H)); per group of HG heads, q | k | v into the area (bld(32 HG) a row)
// with the pad rows Tp .. Tk-1 zeroed, attend16, and s += o W_o over the
// group's rows of W_o (+ bo with the first group, s rounded to bf16 after
// the last); LayerNorm into xb; the MLP in chunks of CC columns, gelu
// stored bf16 (bld(CC) a row) and s += that W2 (+ b2 with the first chunk,
// s rounded after the last).
template <bool STREAM>
__device__ void block16(const BlockW& w, float* s, bf16_t* xb, bf16_t* area,
                        int T, int Tp, int Tk, int H, int M, int HG) {
  const int ld = H + 4, ldx = bld(H), ldq = bld(HG * HD), heads = H / HD;
  const int KT = H / 16;   // k-steps of a product over H
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint2* wqkv = static_cast<const uint2*>(w.wqkv_f);
  const uint2* wo = static_cast<const uint2*>(w.wo_f);
  const uint2* w1 = static_cast<const uint2*>(w.w1_f);
  const uint2* w2 = static_cast<const uint2*>(w.w2_f);

  for (int r = warp; r < Tp; r += NWARP)
    ln_row16(s + r * ld, xb + r * ldx, w.ln1s, w.ln1b, H, lane);
  __syncthreads();
  for (int h0 = 0; h0 < heads; h0 += HG) {
    const int pad = (Tk - Tp) * ldq / 2;      // words of q's, k's, v's pad rows
    for (int i = tid; i < 3 * pad; i += NT)
      reinterpret_cast<unsigned*>(area + (i / pad * Tk + Tp) * ldq)[i % pad] = 0u;
    const float* bq = w.bqkv + h0 * 3 * HD;
    mma16_rows<3, 2>(xb, ldx, Tp, wqkv, KT, 12 * h0, 0, KT, 12 * HG,
                  [&](int row, int col, float v0, float v1) {
                    const int hl = col / (3 * HD), part = col % (3 * HD) / HD;
                    *reinterpret_cast<unsigned*>(area + (part * Tk + row) * ldq + hl * HD +
                                                 col % HD) =
                        pack_bf16x2(v0 + __ldg(bq + col), v1 + __ldg(bq + col + 1));
                  });
    __syncthreads();
    attend16<STREAM>(area, ldq, Tk, T, HG);
    __syncthreads();
    const bool first = h0 == 0, last = h0 + HG == heads;
    mma16_rows<2, 2>(area, ldq, Tp, wo, KT, 0, 2 * h0, 2 * HG, H / 8,
                  [&](int row, int col, float v0, float v1) {
                    float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                    float2 v = *dst;
                    v.x += first ? v0 + __ldg(w.bo + col) : v0;
                    v.y += first ? v1 + __ldg(w.bo + col + 1) : v1;
                    if (last) v = make_float2(rd<true>(v.x), rd<true>(v.y));
                    *dst = v;
                  });
    __syncthreads();
  }

  for (int r = warp; r < Tp; r += NWARP)
    ln_row16(s + r * ld, xb + r * ldx, w.ln2s, w.ln2b, H, lane);
  __syncthreads();
  bf16_t* h1 = area;
  constexpr int ldh = bld(CC);
  for (int c0 = 0; c0 < M; c0 += CC) {
    const float* b1 = w.b1 + c0;
    mma16_rows<2, 2>(xb, ldx, Tp, w1, KT, c0 / 8, 0, KT, CC / 8,
                  [&](int row, int col, float v0, float v1) {
                    *reinterpret_cast<unsigned*>(h1 + row * ldh + col) =
                        pack_bf16x2(gelu_tanh(v0 + __ldg(b1 + col)),
                                    gelu_tanh(v1 + __ldg(b1 + col + 1)));
                  });
    __syncthreads();
    const bool first = c0 == 0, last = c0 + CC >= M;
    mma16_rows<2, 2>(h1, ldh, Tp, w2, M / 16, 0, c0 / 16, CC / 16, H / 8,
                  [&](int row, int col, float v0, float v1) {
                    float2* dst = reinterpret_cast<float2*>(s + row * ld + col);
                    float2 v = *dst;
                    v.x += first ? v0 + __ldg(w.b2 + col) : v0;
                    v.y += first ? v1 + __ldg(w.b2 + col + 1) : v1;
                    if (last) v = make_float2(rd<true>(v.x), rd<true>(v.y));
                    *dst = v;
                  });
    __syncthreads();
  }
}

// The bf16 resident body: the float32 resident body's pass with block16 in
// place of transformer_block; the final norms run in place on s (float32),
// so the pooled summary and the output head read float32 rows.
template <typename IOT, bool STREAM>
__global__ void __launch_bounds__(NT)
fused_attention_bf16_kernel(const IOT* __restrict__ x,
                            const float* __restrict__ pos,   // [T, H]
                            IOT* __restrict__ resid, float* __restrict__ mse,
                            const AttnW W, int T, int Tp, int D, int H, int M,
                            int Z, int L, int use_ln, int with_resid, int HG) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4, Tk = (T + 15) & ~15;
  float* s = smem;                                              // [Tp][ld]
  bf16_t* xb = reinterpret_cast<bf16_t*>(s + Tp * ld);          // [Tp][bld(H)]
  float* small = reinterpret_cast<float*>(xb + Tp * bld(H));    // [SMALL]
  bf16_t* area = reinterpret_cast<bf16_t*>(small + SMALL);
  float* pooled = small;
  float* tok0 = small_tok0(small);
  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const IOT* xw = x + n * T * D;

  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    s[t * ld + c] = t < T ? enc_token<true>(xw, W.enc, pos, t, c, D, H) : 0.0f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l)
    block16<STREAM>(W.enc.layer[l], s, xb, area, T, Tp, Tk, H, M, HG);
  ln_rows(s, s, ld, T, W.enc.fs, W.enc.fb, H);
  __syncthreads();
  for (int c = tid; c < H; c += NT) {
    float a = 0.0f;
    for (int t = 0; t < T; ++t) a += s[t * ld + c];
    pooled[c] = a / T;
  }
  __syncthreads();
  latent_head<true>(W, small, H, Z, use_ln);
  for (int i = tid; i < Tp * H; i += NT) {
    const int t = i / H, c = i % H;
    s[t * ld + c] = t < T ? rd<true>(tok0[c] + __ldg(pos + t * H + c)) : 0.0f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l)
    block16<STREAM>(W.dec.layer[l], s, xb, area, T, Tp, Tk, H, M, HG);
  ln_rows(s, s, ld, T, W.dec.fs, W.dec.fb, H);
  __syncthreads();
  float part = 0.0f;
  for (int i = tid; i < T * D; i += NT) {
    const int t = i / D, d = i % D;
    const float e = ld_io(xw + i) - out_head<true>(s + t * ld, W, d, H, D);
    const float e2 = e * e;
    if (with_resid) st_io(resid + n * T * D + i, e2);
    part += e2;
  }
  store_mse(part, small_red(small), mse + n, T, D);
}

// ---------------------------------------------------------------- long body

// floats of the long body's shared area after its row tile: the larger of
// the attention buffers (a head's query rows, a key block of k and of v, its
// scores, three row vectors) and the MLP's (normalised rows, a hidden chunk)
__host__ __device__ constexpr int long_union_floats(int H) {
  return QL * HDP + 2 * KB * HDP + QL * (KB + 4) + 3 * QL >
                 QL * (H + 4) + QL * (CC + 4)
             ? QL * HDP + 2 * KB * HDP + QL * (KB + 4) + 3 * QL
             : QL * (H + 4) + QL * (CC + 4);
}

// rows [r0, r0 + rows) of a [*, H] matrix in device memory to and from a
// shared tile of row stride ld, 16 bytes a thread at a time
__device__ __forceinline__ void load_rows(float* tile, int ld, const float* g,
                                          int H, int r0, int rows) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < rows * q; i += NT) {
    const int r = i / q, c = i % q;
    *reinterpret_cast<float4*>(tile + r * ld + 4 * c) =
        reinterpret_cast<const float4*>(g + (size_t)(r0 + r) * H)[c];
  }
}
__device__ __forceinline__ void store_rows(float* g, const float* tile, int ld,
                                           int H, int r0, int rows) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < rows * q; i += NT) {
    const int r = i / q, c = i % q;
    reinterpret_cast<float4*>(g + (size_t)(r0 + r) * H)[c] =
        *reinterpret_cast<const float4*>(tile + r * ld + 4 * c);
  }
}

// One pre-LN transformer block of the long body on the window's stream gs
// [Tp, H] in its slot; gqkv [heads][3][Tp][HD] the slot's q | k | v.
template <bool BF>
__device__ void long_block(const BlockW& w, float* sm, float* gs, float* gqkv,
                           int T, int Tp, int H, int M, bool streaming) {
  const int ld = H + 4, heads = H / HD, KT = H / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int SLD = KB + 4;          // row stride of a key block's scores
  float* tile = sm;                    // [QL][ld] rows of s
  float* U = tile + QL * ld;
  float* qs = U;                       // [QL][HDP] a head's query rows, then o
  float* ks = qs + QL * HDP;           // [KB][HDP] a key block of k
  float* vs = ks + KB * HDP;           // [KB][HDP] and of v
  float* S = vs + KB * HDP;            // [QL][SLD] its scores
  float* rm = S + QL * SLD;            // [QL] running max
  float* rl = rm + QL;                 // [QL] denominator
  float* ra = rl + QL;                 // [QL] the block's alpha
  float* nrm = U;                      // [QL][ld] (MLP)
  float* h1 = nrm + QL * ld;           // [QL][CC+4]

  // (A) LayerNorm and q | k | v of every head, a tile of rows at a time
  for (int r0 = 0; r0 < Tp; r0 += QL) {
    const int rows = min(QL, Tp - r0);
    load_rows(tile, ld, gs, H, r0, rows);
    __syncthreads();
    ln_rows(tile, tile, ld, rows, w.ln1s, w.ln1b, H);
    __syncthreads();
    mma_rows<3, 2, BF>(tile, ld, rows, w.wqkv_f, KT, 0, 0, KT, 12 * heads,
                       [&](int row, int col, float v0, float v1) {
                         const int h = col / (3 * HD), part = col % (3 * HD) / HD;
                         float* dst = gqkv + ((size_t)(h * 3 + part) * Tp + r0 + row) * HD
                                      + col % HD;
                         *reinterpret_cast<float2*>(dst) =
                             make_float2(rd<BF>(v0 + __ldg(w.bqkv + col)),
                                         rd<BF>(v1 + __ldg(w.bqkv + col + 1)));
                       });
    __syncthreads();
  }

  // (B) a tile of query rows at a time: attention head by head, then the MLP
  for (int r0 = 0; r0 < Tp; r0 += QL) {
    const int rows = min(QL, Tp - r0);           // a multiple of TM
    load_rows(tile, ld, gs, H, r0, rows);
    for (int h = 0; h < heads; ++h) {
      const float* gq = gqkv + (size_t)h * 3 * Tp * HD;
      const float* gk = gq + (size_t)Tp * HD;
      const float* gv = gk + (size_t)Tp * HD;
      for (int i = tid; i < rows * (HD / 4); i += NT)
        *reinterpret_cast<float4*>(qs + (i / (HD / 4)) * HDP + 4 * (i % (HD / 4))) =
            reinterpret_cast<const float4*>(gq + (size_t)(r0 + i / (HD / 4)) * HD)[i % (HD / 4)];
      for (int i = tid; i < rows; i += NT) {
        rm[i] = -1e30f;
        rl[i] = 0.0f;
      }
      // a thread's o: P.V elements (row, 4 columns) tid and tid + NT
      float4 o[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                     make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
      // the packed form: pass 0 finds each row's max and denominator, pass
      // 1 forms P and P.V; the streaming form runs pass 1 alone
      for (int pass = streaming ? 1 : 0; pass < 2; ++pass) {
        for (int j0 = 0; j0 < T; j0 += KB) {
          const int kn = min(KB, T - j0);
          __syncthreads();                       // the last block is read
          for (int i = tid; i < kn * (HD / 4); i += NT) {
            const int r = i / (HD / 4), c = i % (HD / 4);
            *reinterpret_cast<float4*>(ks + r * HDP + 4 * c) =
                reinterpret_cast<const float4*>(gk + (size_t)(j0 + r) * HD)[c];
            if (pass == 1)
              *reinterpret_cast<float4*>(vs + r * HDP + 4 * c) =
                  reinterpret_cast<const float4*>(gv + (size_t)(j0 + r) * HD)[c];
          }
          __syncthreads();
          // scores S[i][j] = q[i] . k[j0+j]: a thread owns a key for 4 rows
          for (int t4 = tid; t4 < (rows / 4) * kn; t4 += NT) {
            const int j = t4 % kn, qg = t4 / kn;
            const float* kr = ks + j * HDP;
            const float* qr = qs + qg * 4 * HDP;
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
            for (int i = 0; i < 4; ++i) S[(qg * 4 + i) * SLD + j] = acc[i];
          }
          __syncthreads();
          // one warp a row
          for (int i = warp; i < rows; i += NWARP) {
            float* row = S + i * SLD;
            float m = rm[i], l = rl[i];
            if (streaming) {
              stream_block<BF>(row, 0, kn, lane, m, l, ra[i]);
            } else if (pass == 0) {
              float mx = -3.402823466e+38f;
              for (int j = lane; j < kn; j += 32) mx = fmaxf(mx, row[j]);
              const float m_new = fmaxf(m, warp_max(mx));
              float sum = 0.0f;
              for (int j = lane; j < kn; j += 32) sum += expf(row[j] - m_new);
              l = l * expf(m - m_new) + warp_sum(sum);
              m = m_new;
            } else {
              for (int j = lane; j < kn; j += 32)
                row[j] = rd<BF>(expf(row[j] - m) / l);
            }
            __syncwarp();
            if (lane == 0) {
              rm[i] = m;
              rl[i] = l;
            }
          }
          if (pass == 0) continue;
          __syncthreads();
          // P.V of the block: the streaming form sums it apart and rescales,
          // the packed form sums on in key order
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t4 = tid + e * NT;
            if (t4 >= rows * (HD / 4)) break;
            const int c4 = t4 % (HD / 4), i = t4 / (HD / 4);
            const float* p = S + i * SLD;
            if (streaming)
              o[e] = rescale_add(o[e], ra[i], pv_sum(make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                                                     p, vs + c4 * 4, 0, kn));
            else
              o[e] = pv_sum(o[e], p, vs + c4 * 4, 0, kn);
          }
        }
      }
      __syncthreads();                           // q is read for the last time
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t4 = tid + e * NT;
        if (t4 >= rows * (HD / 4)) break;
        const int c4 = t4 % (HD / 4), i = t4 / (HD / 4);
        const float l = streaming ? rl[i] : 1.0f;
        float4 r = o[e];
        if (streaming) r = make_float4(r.x / l, r.y / l, r.z / l, r.w / l);
        *reinterpret_cast<float4*>(qs + i * HDP + c4 * 4) =
            make_float4(rd<BF>(r.x), rd<BF>(r.y), rd<BF>(r.z), rd<BF>(r.w));
      }
      __syncthreads();
      // tile += o_h [rows,32] x wo[h*32 .. h*32+31, :] (+ bo with the first
      // head; under BF s rounded after the last)
      const float* bo = w.bo;
      const bool first = h == 0, last = h == heads - 1;
      mma_rows<4, 2, BF>(qs, HDP, rows, w.wo_f, KT, 0, h * (HD / 8), HD / 8, KT,
                         [&](int row, int col, float v0, float v1) {
                           float2* dst = reinterpret_cast<float2*>(tile + row * ld + col);
                           float2 v = *dst;
                           v.x += first ? v0 + __ldg(bo + col) : v0;
                           v.y += first ? v1 + __ldg(bo + col + 1) : v1;
                           if (BF && last) v = make_float2(rd<BF>(v.x), rd<BF>(v.y));
                           *dst = v;
                         });
      __syncthreads();
    }

    ln_rows(tile, nrm, ld, rows, w.ln2s, w.ln2b, H);
    __syncthreads();
    // MLP, the hidden layer in column chunks of CC
    constexpr int ldh = CC + 4;
    for (int c0 = 0; c0 < M; c0 += CC) {
      const float* b1 = w.b1 + c0;
      mma_rows<4, 2, BF>(nrm, ld, rows, w.w1_f, KT, c0 / 8, 0, KT, CC / 8,
                         [&](int row, int col, float v0, float v1) {
                           *reinterpret_cast<float2*>(h1 + row * ldh + col) =
                               make_float2(gelu_tanh(v0 + __ldg(b1 + col)),
                                           gelu_tanh(v1 + __ldg(b1 + col + 1)));
                         });
      __syncthreads();
      const float* b2 = w.b2;
      const bool first = c0 == 0, last = c0 + CC >= M;
      mma_rows<4, 2, BF>(h1, ldh, rows, w.w2_f, M / 8, 0, c0 / 8, CC / 8, KT,
                         [&](int row, int col, float v0, float v1) {
                           float2* dst = reinterpret_cast<float2*>(tile + row * ld + col);
                           float2 v = *dst;
                           v.x += first ? v0 + __ldg(b2 + col) : v0;
                           v.y += first ? v1 + __ldg(b2 + col + 1) : v1;
                           if (BF && last) v = make_float2(rd<BF>(v.x), rd<BF>(v.y));
                           *dst = v;
                         });
      __syncthreads();
    }
    store_rows(gs, tile, ld, H, r0, rows);
    __syncthreads();
  }
}

// The long body: a persistent grid, block b running windows b, b + grid, ...
// with `scratch + b * slot` its slot (the stream, then q | k | v).
template <bool BF, typename IOT>
__global__ void __launch_bounds__(NT)
fused_attention_long_kernel(const IOT* __restrict__ x,
                            const float* __restrict__ pos,   // [T, H]
                            IOT* __restrict__ resid, float* __restrict__ mse,
                            const AttnW W, int N, int T, int Tp, int D, int H,
                            int M, int Z, int L, int use_ln, int with_resid,
                            int streaming, float* __restrict__ scratch,
                            size_t slot) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4;
  float* tile = smem;                              // [QL][ld]
  float* small = smem + QL * ld + long_union_floats(H);
  float* pooled = small;
  float* tok0 = small_tok0(small);
  float* gs = scratch + blockIdx.x * slot;         // [Tp][H]
  float* gqkv = gs + (size_t)Tp * H;               // [heads][3][Tp][HD]
  const int tid = threadIdx.x;

  for (size_t n = blockIdx.x; n < (size_t)N; n += gridDim.x) {
    const IOT* xw = x + n * T * D;
    __syncthreads();                               // the last window is done
    for (int i = tid; i < Tp * H; i += NT) {
      const int t = i / H, c = i % H;
      gs[i] = t < T ? enc_token<BF>(xw, W.enc, pos, t, c, D, H) : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l)
      long_block<BF>(W.enc.layer[l], smem, gs, gqkv, T, Tp, H, M, streaming);

    // final norm and mean over the T real rows, a tile at a time; thread c
    // sums column c in step order
    float a = 0.0f;
    for (int r0 = 0; r0 < T; r0 += QL) {
      const int rows = min(QL, T - r0);
      load_rows(tile, ld, gs, H, r0, rows);
      __syncthreads();
      ln_rows(tile, tile, ld, rows, W.enc.fs, W.enc.fb, H);
      __syncthreads();
      if (tid < H)
        for (int t = 0; t < rows; ++t) a += tile[t * ld + tid];
      __syncthreads();
    }
    if (tid < H) pooled[tid] = a / T;
    __syncthreads();
    latent_head<BF>(W, small, H, Z, use_ln);
    for (int i = tid; i < Tp * H; i += NT) {
      const int t = i / H, c = i % H;
      gs[i] = t < T ? rd<BF>(tok0[c] + __ldg(pos + t * H + c)) : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l)
      long_block<BF>(W.dec.layer[l], smem, gs, gqkv, T, Tp, H, M, streaming);

    // final norm, output head, residual; thread tid takes the elements
    // i = tid mod NT, in order, as the resident body does
    float part = 0.0f;
    for (int r0 = 0; r0 < T; r0 += QL) {
      const int rows = min(QL, T - r0);
      load_rows(tile, ld, gs, H, r0, rows);
      __syncthreads();
      ln_rows(tile, tile, ld, rows, W.dec.fs, W.dec.fb, H);
      __syncthreads();
      const int i0 = r0 * D, i1 = (r0 + rows) * D;
      for (int i = i0 + (tid - i0 % NT + NT) % NT; i < i1; i += NT) {
        const int t = i / D, d = i % D;
        const float e = ld_io(xw + i) - out_head<BF>(tile + (t - r0) * ld, W, d, H, D);
        const float e2 = e * e;
        if (with_resid) st_io(resid + n * T * D + i, e2);
        part += e2;
      }
      __syncthreads();
    }
    store_mse(part, small_red(small), mse + n, T, D);
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

// Bytes of dynamic shared memory one window of T steps at width H needs in
// the resident body: the stream and its normalised copy, the per-window
// vectors, and the larger of one head's q | k | v with a score chunk and one
// chunk of the MLP's hidden layer. Past what a block may use, the wrapper's
// plan takes the long body.
extern "C" long long shm_fused_attention_smem_bytes(int T, int H) {
  const size_t Tp = padded_rows(T), Tld = (T + 3) & ~3;
  const size_t attn = 3 * Tp * HDP + QC * Tld;
  const size_t mlp = Tp * (CC + 4);
  return sizeof(float) *
         (2 * Tp * (H + 4) + SMALL + (attn > mlp ? attn : mlp));
}

// Bytes of dynamic shared memory the bf16 resident body needs for one window
// of T steps at width H with its heads in groups of HG: the stream (float32)
// and its normalised copy (bf16), the per-window vectors, and the larger of
// a group's q | k | v (bf16, Tk = T rounded up to 16 rows) and one bf16
// chunk of the MLP's hidden layer.
static long long bf16_smem_bytes(int T, int H, int HG) {
  const long long Tp = padded_rows(T), Tk = (T + 15) / 16 * 16;
  const long long attn = 3 * Tk * bld(HG * HD), mlp = Tp * bld(CC);
  return 4 * (Tp * (H + 4) + SMALL) + 2 * (Tp * bld(H) + (attn > mlp ? attn : mlp));
}

// The head group of the bf16 resident body at (T, H): the most heads (all,
// 2 or 1) whose buffers fit a block's shared memory; 0 when none does.
static int bf16_group(int T, int H) {
  for (int g = H / HD; g >= 1; g /= 2)
    if (bf16_smem_bytes(T, H, g) <= SMEM_LIMIT) return g;
  return 0;
}

// Bytes of dynamic shared memory the bf16 resident body takes for a window
// of T steps at width H (bf16_group's; one head a group where none fits).
// Past what a block may use, the wrapper's plan takes the long body.
extern "C" long long shm_fused_attention_smem_bytes_bf16(int T, int H) {
  const int g = bf16_group(T, H);
  return bf16_smem_bytes(T, H, g ? g : 1);
}

// Bytes of dynamic shared memory a block of the long body needs at width H,
// whatever T: a row tile, the larger of the attention and MLP buffers, the
// per-window vectors.
extern "C" long long shm_fused_attention_long_smem_bytes(int H) {
  return sizeof(float) * ((long long)QL * (H + 4) + long_union_floats(H) + SMALL);
}

// Floats of device memory a block of the long body keeps for its window:
// the stream [Tp, H] and every head's q | k | v [heads][3][Tp][32].
extern "C" long long shm_fused_attention_slot_floats(int T, int H) {
  return 4LL * padded_rows(T) * H;
}

namespace {

// the kernel instance at (BF, IOT) on the `w` pointers of the C entries:
// body 0 the resident body (STREAM from `streaming`), 1 the long body on
// `slots` blocks, each with its slot of `scratch`
template <bool BF, typename IOT>
int launch_gate(const IOT* x, const float* pos, IOT* resid, float* mse,
                const void* const* w, int n_w, int N, int T, int D, int H,
                int M, int Z, int L, int use_ln, int with_resid, int streaming,
                int body, float* scratch, int slots, void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || Z <= 0 ||
      Z > ZMAX || L < 1 || L > LMAX || H % HD || H < HD || H > HMAX ||
      M < CC || M % CC ||
      (with_resid && resid == nullptr) || (streaming != 0 && streaming != 1))
    return (int)cudaErrorInvalidValue;
  const int Tp = padded_rows(T);
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
      auto frag = [&] { return static_cast<const void*>(*p++); };
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (body == 0) {
    if constexpr (BF) {
      const int g = bf16_group(T, H);
      if (g == 0) return (int)cudaErrorInvalidValue;
      const int smem_bytes = (int)bf16_smem_bytes(T, H, g);
      auto kern = streaming ? fused_attention_bf16_kernel<IOT, true>
                            : fused_attention_bf16_kernel<IOT, false>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      kern<<<N, NT, smem_bytes, st>>>(x, pos, resid, mse, W, T, Tp, D, H, M,
                                      Z, L, use_ln, with_resid, g);
    } else {
      if (streaming && (T + KB - 1) / KB > NKB_RES) return (int)cudaErrorInvalidValue;
      const int smem_bytes = (int)shm_fused_attention_smem_bytes(T, H);
      auto kern = streaming ? fused_attention_gate_kernel<true>
                            : fused_attention_gate_kernel<false>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      kern<<<N, NT, smem_bytes, st>>>(x, pos, resid, mse, W, T, Tp, D, H, M, Z,
                                      L, use_ln, with_resid);
    }
    return (int)cudaGetLastError();
  }
  if (body != 1 || scratch == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)shm_fused_attention_long_smem_bytes(H);
  auto kern = fused_attention_long_kernel<BF, IOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<slots < N ? slots : N, NT, smem_bytes, st>>>(
      x, pos, resid, mse, W, N, T, Tp, D, H, M, Z, L, use_ln, with_resid,
      streaming, scratch, (size_t)shm_fused_attention_slot_floats(T, H));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes. `w` holds NUM_W = 80 device pointers: the encoder stack
// (in_w in_b, then per layer ln1s ln1b wqkv bqkv wo bo ln2s ln2b w1 b1 w2 b2
// and the fragments of wqkv wo w1 w2 (mma_rows; 16-byte aligned) for LMAX = 2
// layers, then final-norm scale and bias), ln_scale ln_bias mu_w
// mu_b z2h_w z2h_b, the decoder stack in the same order, out_w out_b
// (pointers of an absent layer or LayerNorm may be null); w1 is [H, M], b1
// [M] and w2 [M, H], M the MLP's width (a multiple of 128). `pos` is the
// [T, H] position table. `streaming` 1 runs the streaming softmax, 0 the
// packed one. `body` 0 runs the resident body; 1 the long body on
// min(N, slots) blocks, `scratch` holding `slots` slots of
// shm_fused_attention_slot_floats(T, H) floats (16-byte aligned). Returns
// cudaErrorInvalidValue for a shape or argument the kernel does not take,
// the error of cudaFuncSetAttribute for a window too long for the resident
// body's shared memory, else the launch's cudaGetLastError(), 0 on success.
extern "C" int shm_fused_attention_gate_f32(
    const float* x, const float* pos, float* resid, float* mse,
    const void* const* w, int n_w, int N, int T, int D, int H, int M, int Z,
    int L, int use_ln, int with_resid, int streaming, int body, float* scratch,
    int slots, void* stream) {
  return launch_gate<false, float>(x, pos, resid, mse, w, n_w, N, T, D, H, M,
                                   Z, L, use_ln, with_resid, streaming, body,
                                   scratch, slots, stream);
}

// The C entry of the bf16 instance: the arguments of
// shm_fused_attention_gate_f32 with `w`'s fragments those of the
// bf16-rounded weights, x and resid bf16 when io_bf16 is 1 and float32 when
// it is 0. Returns as shm_fused_attention_gate_f32 does.
extern "C" int shm_fused_attention_gate_bf16(
    const void* x, const float* pos, void* resid, float* mse,
    const void* const* w, int n_w, int N, int T, int D, int H, int M, int Z,
    int L, int use_ln, int with_resid, int streaming, int body, float* scratch,
    int slots, int io_bf16, void* stream) {
  if (io_bf16 == 1)
    return launch_gate<true, bf16_t>(
        static_cast<const bf16_t*>(x), pos, static_cast<bf16_t*>(resid), mse,
        w, n_w, N, T, D, H, M, Z, L, use_ln, with_resid, streaming, body,
        scratch, slots, stream);
  if (io_bf16 != 0) return (int)cudaErrorInvalidValue;
  return launch_gate<true, float>(
      static_cast<const float*>(x), pos, static_cast<float*>(resid), mse, w,
      n_w, N, T, D, H, M, Z, L, use_ln, with_resid, streaming, body, scratch,
      slots, stream);
}

// out = registers a thread, local memory (spill) bytes a thread, threads a
// block, dynamic shared bytes a block, blocks an SM at once, of the packed
// form's instance of `body` (0 resident at (T, H); 1 long at H), float32
// (bf16 0) or bf16 with float32 io (bf16 1).
extern "C" int shm_fused_attention_info(int T, int H, int body, int bf16, int* out) {
  if ((body != 0 && body != 1) || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const void* kern;
  long long smem_bytes;
  if (body == 0 && bf16) {
    kern = reinterpret_cast<const void*>(fused_attention_bf16_kernel<float, false>);
    smem_bytes = shm_fused_attention_smem_bytes_bf16(T, H);
  } else if (body == 0) {
    kern = reinterpret_cast<const void*>(fused_attention_gate_kernel<false>);
    smem_bytes = shm_fused_attention_smem_bytes(T, H);
  } else {
    kern = bf16 ? reinterpret_cast<const void*>(fused_attention_long_kernel<true, float>)
                : reinterpret_cast<const void*>(fused_attention_long_kernel<false, float>);
    smem_bytes = shm_fused_attention_long_smem_bytes(H);
  }
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, NT,
                                                      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = NT;
  out[3] = (int)smem_bytes;
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
