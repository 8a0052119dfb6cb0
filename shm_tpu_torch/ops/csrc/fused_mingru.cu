// Fused deterministic minGRU-VAE gate for Hopper (sm_90a), float32 with
// every gate product on the tensor cores in 3xTF32, and bf16.
//
// Replaces the Pallas TPU kernel shm_tpu/ops/fused_mingru.py::_kernel (:69),
// launched by fused_mingru_gate (:207, pallas_call at :293). Same function:
//
//   x [N,T,D] -> L-layer minGRU encoder (keep h_T of the last layer)
//     -> [LayerNorm eps 1e-5] -> mu = fc_mu(h_T) (z = mu)
//     -> dec_in = tanh(fc_latent_to_hidden(mu))
//     -> L-layer minGRU decoder fed dec_in at every step -> output head x_hat
//     -> resid = (x - x_hat)^2 [N,T,D] and mse = sum(resid) / (T*D) [N]
//
// A minGRU layer: g = W^T in_t + b [2H], z = sigmoid(g[:H]), h~ = g[H:],
// h_t = h_{t-1} + z * (h~ - h_{t-1}), h_0 = 0. The gates never see h_{t-1},
// so there is no recurrent product; the decoder's layer 0 has a constant
// input, so its z and h~ are computed once and only the sweep runs over T.
//
// L in 1..4, H in {32,64,128} (template), D <= 128, Z <= 128, any T.
// Weights come in the flax layout [in, out] (w_ih [in, 2H], the z half
// first), and each w_ih also as 3xTF32 fragments (below), which is what the
// kernel reads.
//
// Any other width h_real <= 128 runs the instance of the next width H on
// weights the wrapper pads with zeros (mingru_params_to_kernel_weights): a
// padded unit's gates are z = 1/2, h~ = 0, so its h stays exactly 0 from
// h_0 = 0, and the heads' padded rows and columns are zero. LayerNorm
// normalises h_T over the h_real real units (a kernel argument) and leaves
// the padded ones at 0. D and Z size the x tile and the mu buffer at run
// time, as in fused_vae.cu: rows of max(round_up(D, 8), 16) + 4 floats and
// max(Z, 32) rows of mu, so every D <= 16 and Z <= 32 keeps its bytes; the
// output head's slots past the registers' (D > 16) sum their e^2 in the x
// tile, free in the decoder, where the closing sum reads them. At L = 4,
// H = 128 and D = Z = 128 a block takes 183,296 bytes (SMEM_LIMIT 232,448).
//
// Bound on this card. Per window the gate products are, for the 4DOF preset
// (T=100, D=12, H=128, Z=16, L=2), T*2*2H*D (encoder layer 0) + T*2*2H*H
// (encoder layer 1) + 2*2H*H (decoder layer 0, once) + T*2*2H*H (decoder
// layer 1), 13.79 MFLOP; with the heads 14.1 MFLOP, ~77 GFLOP at N=5,440,
// ~1.15 ms at the 67 TFLOP/s float32 rate without tensor cores. In 3xTF32
// on the tensor cores (three TF32 products each, 495 TFLOP/s) the gate
// products take 0.455 ms at N=5,440 and 0.684 ms at the 8,192 bucket. The
// bytes (x, resid, weights once) are ~53 MB, ~16 us at 3.35 TB/s. So the
// kernel is bound by operations.
//
// Design (fused_mingru_tc_kernel<H, MT, TC, SUM>). One block owns BT = 16*MT
// windows and runs every layer over all T for them, so nothing but x, resid
// and mse touches device memory per window. Since the gates never see
// h_{t-1}, a layer's product for TC successive steps is one tile: the rows
// of a tile are TC steps x BT windows (R = TC*BT; m-tile s*MT + m is step
// t0+s of windows 16m..16m+15), and the layers advance one chunk of TC
// steps at a time:
//   * H/8 warps a block (4H threads, 512 at H=128). Warp w owns the n-tiles
//     w and H/8 + w of the [K, 2H] product: the z and h~ columns of units
//     8w..8w+7. The m16n8k8 accumulator puts (row g, cols 2t, 2t+1) and
//     (row g+8, cols 2t, 2t+1) in lane 4g+t, so each thread holds z and h~
//     of the same cells at the chunk's TC steps: the sweep
//     h <- h + z (h~ - h) runs over those steps in registers, from the h the
//     thread carried out of the last chunk (its own slots of shared memory).
//   * Every gate product (x_t W0, h_{l-1} W_l of both stacks, and the
//     decoder's once-per-window dec_in W0) runs on the tensor cores:
//     mma.sync m16n8k8 TF32 in 3xTF32, a * b = a_s b_b + a_b b_s + a_b b_b
//     with big = rna_tf32(x), small = rna_tf32(x - big). The tensor cores
//     truncate each mma's sum toward zero, so each pair of k-steps' six mma
//     are chained from zero and that partial added to the float32 sum to
//     nearest (TcSum, below), as fused_vae.cu does.
//   * B: the wrapper packs each w_ih once in fragment order, for each
//     (n-tile, k-step, lane) one float4 {b0 big, b1 big, b0 small, b1 small};
//     K padded with zero rows to a multiple of 8 (D=12 to 16). Each fragment
//     is loaded by one warp of the block once a chunk, through L2: a chunk of
//     TC steps reads the weights once, so the L2 stream (544 KiB a step a
//     block at TC=1 for the 4DOF preset) falls by TC.
//   * A: the x tile [R][D+4 padded] and two chunk buffers [R][H+4] that
//     ping-pong between layers (layer l reads buffer (l-1)&1 and writes l&1,
//     so any L runs on two), as [row][k]: conflict-free fragment loads. Each
//     A element is split once by two integer operations for the warp's two
//     n-tiles.
//   * Per chunk and layer: bias, products, sweep, barrier, h of every step
//     into the layer's buffer, barrier; the encoder's last layer keeps only
//     its carried h. The decoder's layer 0 keeps its z and h~ in registers
//     and runs its sweep alone. Sums run in a fixed order (bias, then the
//     k-step pairs in order; the MSE per (step slot, window, d) over the
//     chunks, then over the slots, then over d): two runs are equal bit for
//     bit.
//   * LayerNorm, the latent heads and the output head stay on the FMA pipes
//     (1.7 GFLOP at N=5,440), as do the sigmoids; the head for a chunk runs
//     TC*BT*D slots.
//
// The bf16 instance (C entry shm_fused_mingru_gate_bf16) is the TPU kernel
// with dtype=bf16 (fused_mingru.py:92-188): every product's two operands
// rounded to bf16 and summed in float32, the sum TC_BF16 of fused_vae.cu
// (A rounded to bf16 in place of the TF32 split, B fragments of the
// bf16-rounded weights, a_b b_b alone chained into the sum); the gate
// scratch z (after its sigmoid) and h~ rounded to bf16 as the TPU kernel
// stores them, but for the decoder's layer 0, whose constant gates stay
// float32; every stored h_t rounded (store_chunk); the output head's y
// rounded before the residual. The sweep's running h, the encoder's last h,
// LayerNorm and the mse stay float32. Its io is float32 or bf16 (template
// IOT), as fused_vae.cu's bf16 instance. Its bound at N=5,440 (4DOF preset)
// is the 76.7 GFLOP at the 989 TFLOP/s bf16 rate, 0.08 ms; one TF32 mma a
// product on m16n8k8 reaches the 495 TFLOP/s TF32 rate at best.
//
// The sigmoid's two forms (the JAX kernel's sigmoid_impl, fused_mingru.py:90,
// :265-266): the logistic 1/(1+exp(-x)), the default instances' unchanged,
// and the JAX default 0.5 * (tanh(0.5x) + 1), in a second instance of each
// precision and io type (template flag SIG_TANH, at the z sigmoid's two call
// sites: the sweep and the decoder's constant layer 0). A template keeps the
// default instances' code and bits; one option adds 9 instances. The
// decoder input stays tanhf, as in JAX.
//
// Accurate expf/tanhf (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int DMAX = 16;        // the output head's slots a thread sums in
                                // registers: DMAX * R
constexpr int ZMAX = 32;        // the fewest rows of the shared mu buffer
constexpr int DLIM = 128;       // the largest D and Z the kernel takes
constexpr int ZLIM = 128;
constexpr int LMAX = 4;
constexpr int NUM_W = 4 * LMAX + 8 + 2 * LMAX;   // 24 as given, 8 fragments

// padded row of the shared x tile [R][xp_of(D)]: D rounded up to 8 (at
// least 16, the width every D <= 16 had), plus 4 (4 mod 8: conflict-free
// fragment loads)
__host__ __device__ constexpr int xp_of(int D) {
  return ((D + 7) & ~7) > DMAX ? ((D + 7) & ~7) + 4 : DMAX + 4;
}
// rows of the shared mu buffer [zr_of(Z)][BT]
__host__ __device__ constexpr int zr_of(int Z) { return Z > ZMAX ? Z : ZMAX; }

typedef unsigned short bf16_t;  // raw bf16 bits

struct MinGruWeights {
  const float4* enc_f[LMAX];    // w_ih fragments
  const float* enc_b[LMAX];     // [2H]
  const float* ln_scale;
  const float* ln_bias;
  const float* mu_w;    // [H, Z]
  const float* mu_b;    // [Z]
  const float* z2h_w;   // [Z, H]
  const float* z2h_b;   // [H]
  const float4* dec_f[LMAX];
  const float* dec_b[LMAX];
  const float* out_w;   // [H, D]
  const float* out_b;   // [D]
};

// sigmoid in the logistic form, or under TANH_FORM in the JAX kernel's
// default sigmoid_impl="tanh" form 0.5 * (tanh(0.5x) + 1)
template <bool TANH_FORM>
__device__ __forceinline__ float sigmoid_f(float x) {
  if constexpr (TANH_FORM) return 0.5f * (tanhf(0.5f * x) + 1.0f);
  return 1.0f / (1.0f + expf(-x));
}

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

// the window tile and the residual in their io type: float32, or bf16 bits
__device__ __forceinline__ float ld_io(const float* p) { return *p; }
__device__ __forceinline__ float ld_io(const bf16_t* p) {
  return __uint_as_float((unsigned)*p << 16);
}
__device__ __forceinline__ void st_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_io(bf16_t* p, float v) {
  *p = (bf16_t)(__float_as_uint(rd<true>(v)) >> 16);
}

// entry l of a pointer array of the kernel's parameters, read with constant
// indices only (an index known at run time would copy the array to local
// memory)
template <typename P>
__device__ __forceinline__ P layer_ptr(P const (&a)[LMAX], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync: the same helpers as fused_vae.cu's tensor-core body,
// copied because each source builds alone (ops/_build.py keys a library by
// the hash of its one source)
// ---------------------------------------------------------------------------

// x rounded to TF32 to nearest, ties away from zero (the low 13 bits zero),
// in two integer operations: equal to cvt.rna.tf32.f32 for every finite x,
// and to the wrapper's tf32_round
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

// How the products reach the float32 sum. The tensor cores add each mma's
// products to its accumulator and truncate the sum toward zero, so a sum
// chained through every mma of a product drifts toward zero by up to an ulp
// an mma. The k-steps go in pairs (k, k+1), each pair's six mma small terms
// first: a_s b_b and a_b b_s of k, then of k+1, then a_b b_b of k and k+1.
//   TC_SPLIT:  a pair's six mma chained from zero and that partial added to
//              the sum with a float32 add (round to nearest): the shipping sum;
//   TC_CHAIN:  every mma chained into the one sum;
//   TC_ONE_TERM: a_b b_b alone into the one sum (a planted fault);
//   TC_BF16:   the bf16 instance's sum: A rounded to bf16 (small part zero),
//              B of bf16-rounded weights, a_b b_b alone as TC_ONE_TERM.
enum TcSum { TC_CHAIN = 0, TC_SPLIT = 1, TC_ONE_TERM = 2, TC_BF16 = 3 };

// the TF32 parts of this lane's A fragment at p (row stride lda), or zeros;
// under BF the bf16 rounding of each element as its big part
template <bool BF>
__device__ __forceinline__ void split_a(const float* p, int lda, bool load,
                                        unsigned (&big)[4], unsigned (&sml)[4]) {
  const float x[4] = {load ? p[0] : 0.0f, load ? p[8 * lda] : 0.0f,
                      load ? p[4] : 0.0f, load ? p[8 * lda + 4] : 0.0f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (BF) {
      big[r] = __float_as_uint(rd<true>(x[r]));
      sml[r] = 0u;
    } else {
      big[r] = tf32_round(x[r]);
      sml[r] = tf32_round(x[r] - __uint_as_float(big[r]));
    }
  }
}

// acc += the k-step pair's products (A parts of k and k+1; B fragments b0, b1)
template <int SUM>
__device__ __forceinline__ void mma_pair(float (&acc)[4], const unsigned (&big0)[4],
                                         const unsigned (&sml0)[4],
                                         const unsigned (&big1)[4],
                                         const unsigned (&sml1)[4], float4 b0,
                                         float4 b1) {
  if constexpr (SUM == TC_ONE_TERM || SUM == TC_BF16) {
    mma_tf32(acc, big0, b0.x, b0.y);
    mma_tf32(acc, big1, b1.x, b1.y);
  } else {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float (&s)[4] = SUM == TC_SPLIT ? part : acc;
    mma_tf32(s, sml0, b0.x, b0.y);                  // a_s b_b, k
    mma_tf32(s, big0, b0.z, b0.w);                  // a_b b_s, k
    mma_tf32(s, sml1, b1.x, b1.y);                  // a_s b_b, k+1
    mma_tf32(s, big1, b1.z, b1.w);                  // a_b b_s, k+1
    mma_tf32(s, big0, b0.x, b0.y);                  // a_b b_b, k
    mma_tf32(s, big1, b1.x, b1.y);                  // a_b b_b, k+1
    if constexpr (SUM == TC_SPLIT)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += part[r];
  }
}

// acc[m][q] += A[rows 16m..16m+15][k] W[k][q*H + 8*warp .. +7] over KT
// k-steps of 8, for NM m-tiles: A [16*NM][lda] in shared memory, W as packed
// fragments at Bf (n-tile nt, k-step kt, lane at (nt*KT + kt)*32 + lane; the
// z n-tiles first, then the h~ ones). The warp's two n-tiles are z and h~ of
// its 8 units; it loads each fragment once for its NM m-tiles and splits
// each A element once for both n-tiles; the k-steps go in pairs in order (an
// odd KT's last pair multiplies zeros), summed as SUM says, no atomics.
template <int H, int NM, int SUM>
__device__ __forceinline__ void gate_mma(float (&acc)[NM][2][4],
                                         const float4* __restrict__ Bf, int KT,
                                         const float* A, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* bw = Bf + (size_t)warp * KT * 32 + lane;
  const size_t half = (size_t)(H / 8) * KT * 32;
  const float* a0 = A + (lane >> 2) * lda + (lane & 3);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int ks = 0; ks < KT; ks += 2) {
    const bool two = ks + 1 < KT;
    float4 b0[2], b1[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      b0[q] = __ldg(bw + q * half + ks * 32);
      b1[q] = two ? __ldg(bw + q * half + (ks + 1) * 32) : zero;
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float* p = a0 + m * 16 * lda + ks * 8;
      unsigned big0[4], sml0[4], big1[4], sml1[4];
      split_a<SUM == TC_BF16>(p, lda, true, big0, sml0);
      split_a<SUM == TC_BF16>(p + 8, lda, two, big1, sml1);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        mma_pair<SUM>(acc[m][q], big0, sml0, big1, sml1, b0[q], b1[q]);
    }
  }
}

// acc = the bias of this thread's columns (units 8*warp + 2t, +1 of z, h~)
template <int H, int NM>
__device__ __forceinline__ void tc_bias(float (&acc)[NM][2][4], const float* b) {
  const int col = 8 * (threadIdx.x >> 5) + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float b0 = __ldg(b + q * H + col), b1 = __ldg(b + q * H + col + 1);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      acc[m][q][0] = b0; acc[m][q][1] = b1; acc[m][q][2] = b0; acc[m][q][3] = b1;
    }
  }
}

// The sweep of one layer over a chunk of TC steps (nv of them real): from
// the h this thread carried out of the last chunk (hc[m * NT], one float4
// of its four cells of m-tile m), h <- h + sigmoid(g_z) (g_h - h) at each
// step, h of step s into acc[s*MT + m][0], and the last back into hc. Steps
// past T leave h as it is. Under BF z and h~ are rounded to bf16 first, as
// the TPU kernel stores its gate scratch.
template <int MT, int TC, int NT, bool BF, bool SIG_TANH>
__device__ __forceinline__ void sweep(float (&acc)[TC * MT][2][4], float4* hc,
                                      int nv) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float4 c = hc[m * NT];
    float h[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int s = 0; s < TC; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float z = rd<BF>(sigmoid_f<SIG_TANH>(acc[s * MT + m][0][r]));
        const float hb = rd<BF>(acc[s * MT + m][1][r]);
        if (s < nv) h[r] = h[r] + z * (hb - h[r]);
        acc[s * MT + m][0][r] = h[r];
      }
    hc[m * NT] = make_float4(h[0], h[1], h[2], h[3]);
  }
}

// h of every row of the chunk (acc[.][0]) into the shared [R][H+4] buffer
// (rounded to bf16 under BF), between two barriers: the first ends the
// reads of what the buffer held (the next layer's product, or the output
// head of the last chunk), the second makes the chunk visible
template <int H, int NM, bool BF>
__device__ __forceinline__ void store_chunk(const float (&acc)[NM][2][4],
                                            float* buf) {
  constexpr int HP = H + 4;
  const int lane = threadIdx.x & 31;
  float* row = buf + (lane >> 2) * HP + 8 * (threadIdx.x >> 5) + 2 * (lane & 3);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    *reinterpret_cast<float2*>(row + m * 16 * HP) =
        make_float2(rd<BF>(acc[m][0][0]), rd<BF>(acc[m][0][1]));
    *reinterpret_cast<float2*>(row + (m * 16 + 8) * HP) =
        make_float2(rd<BF>(acc[m][0][2]), rd<BF>(acc[m][0][3]));
  }
  __syncthreads();
}

// shared floats: carried h [L][MT][NT] float4 | two chunk buffers [R][H+4] |
// x tile [R][xp_of(D)] | mu [zr_of(Z)][BT]
template <int H, int MT, int TC>
constexpr size_t tc_smem_floats(int L, int D, int Z) {
  constexpr int BT = 16 * MT, R = TC * BT;
  return (size_t)L * MT * 4 * H * 4 + 2 * R * (H + 4) + R * xp_of(D) + zr_of(Z) * BT;
}

template <int H, int MT, int TC, int SUM, typename IOT, bool SIG_TANH>
__global__ void __launch_bounds__(4 * H, 1)
fused_mingru_tc_kernel(const IOT* __restrict__ x, IOT* __restrict__ resid,
                       float* __restrict__ mse, const MinGruWeights Wt, int N,
                       int T, int D, int Z, int L, int use_ln, int with_resid,
                       int h_real) {
  constexpr bool BF = SUM == TC_BF16;   // stores and heads rounded too
  constexpr int NT = 4 * H;
  constexpr int BT = 16 * MT;
  constexpr int R = TC * BT;          // rows of a chunk tile
  constexpr int NM = TC * MT;         // m-tiles of a chunk tile
  constexpr int HP = H + 4;           // padded row of the chunk buffers
  constexpr int KH = H / 8;           // k-steps of a product over H
  constexpr int IO_SLOTS = (DMAX * R + NT - 1) / NT;   // slots in registers

  const int XP = xp_of(D);                                 // padded x row
  extern __shared__ __align__(16) float smem[];
  float4* const hcar = reinterpret_cast<float4*>(smem);    // [L][MT][NT]
  float* const buf0 = smem + (size_t)L * MT * NT * 4;     // buffers 0 and 1
  auto buf = [buf0](int i) { return buf0 + (i & 1) * (R * HP); };
  float* const xs = buf0 + 2 * R * HP;                     // [R][XP]
  float* const mus = xs + R * XP;                          // [zr_of(Z)][BT]
  // the output head's slot i = (d, window b, step slot s), d fastest; where
  // the closing sum reads its total: xs[(d * TC + s) * BT + b]
  auto slot_at = [D](int i) {
    const int d = i % D, b = (i / D) % BT, s = i / (D * BT);
    return (d * TC + s) * BT + b;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BT;
  const int DP = (D + 7) & ~7;                             // x's k, zero-padded
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int i = 0; i < L * MT; ++i) hcar[i * NT + tid] = zero4;

  // ---------------- encoder: every layer advances one chunk of TC steps
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int nv = min(TC, T - t0);
    // x tile: row s*BT + b is x[n0 + b, t0 + s]; i runs d, then s, then b,
    // so a window's TC*D contiguous floats are read together
    for (int i = tid; i < R * DP; i += NT) {
      const int d = i % DP, s = (i / DP) % TC, b = i / (DP * TC);
      const int n = n0 + b;
      xs[(s * BT + b) * XP + d] = (n < N && d < D && s < nv)
          ? ld_io(x + ((size_t)n * T + t0 + s) * D + d) : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      float acc[NM][2][4];
      tc_bias<H, NM>(acc, layer_ptr(Wt.enc_b, l));
      gate_mma<H, NM, SUM>(acc, layer_ptr(Wt.enc_f, l), l == 0 ? DP / 8 : KH,
                           l == 0 ? xs : buf(l - 1), l == 0 ? XP : HP);
      sweep<MT, TC, NT, BF, SIG_TANH>(acc, hcar + l * MT * NT + tid, nv);
      if (l + 1 < L) store_chunk<H, NM, BF>(acc, buf(l));
    }
    __syncthreads();      // the last layer's product has read its input
  }

  // ---------------- h_T of the last layer -> hl [BT][HP]; LayerNorm; mu
  float* const hl = buf(0);
  {
    const float4* hc = hcar + (L - 1) * MT * NT + tid;
    float* row = hl + (lane >> 2) * HP + 8 * warp + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 v = hc[m * NT];
      *reinterpret_cast<float2*>(row + m * 16 * HP) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(row + (m * 16 + 8) * HP) = make_float2(v.z, v.w);
    }
  }
  __syncthreads();
  if (use_ln) {                // over the h_real real units; padded ones stay 0
    if (tid < BT) {
      float* row = hl + tid * HP;
      float m = 0.0f;
      for (int k = 0; k < h_real; ++k) m += row[k];
      m /= h_real;
      float v = 0.0f;
      for (int k = 0; k < h_real; ++k) {
        const float dv = row[k] - m;
        v += dv * dv;
      }
      v /= h_real;
      const float r = 1.0f / sqrtf(v + 1e-5f);
      for (int k = 0; k < h_real; ++k)
        row[k] = (row[k] - m) * r * __ldg(Wt.ln_scale + k) + __ldg(Wt.ln_bias + k);
    }
    __syncthreads();
  }
  for (int i = tid; i < Z * BT; i += NT) {
    const int z = i % Z, b = i / Z;
    float s = __ldg(Wt.mu_b + z);
    for (int k = 0; k < H; ++k)
      s = fmaf(rd<BF>(__ldg(Wt.mu_w + k * Z + z)), rd<BF>(hl[b * HP + k]), s);
    mus[z * BT + b] = s;
  }
  __syncthreads();
  // decoder input tanh(fc_latent_to_hidden(mu)) -> buf[1] rows 0..BT-1
  float* const dec_in = buf(1);
  for (int i = tid; i < H * BT; i += NT) {
    const int k = i % H, b = i / H;
    float s = __ldg(Wt.z2h_b + k);
    for (int z = 0; z < Z; ++z)
      s = fmaf(rd<BF>(__ldg(Wt.z2h_w + z * H + k)), rd<BF>(mus[z * BT + b]), s);
    dec_in[b * HP + k] = tanhf(s);
  }
  __syncthreads();
  // decoder layer 0: constant input, so z and h~ once, kept in registers
  float z1[MT][4], hb1[MT][4];
  {
    float acc[MT][2][4];
    tc_bias<H, MT>(acc, Wt.dec_b[0]);
    gate_mma<H, MT, SUM>(acc, Wt.dec_f[0], KH, dec_in, HP);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        z1[m][r] = sigmoid_f<SIG_TANH>(acc[m][0][r]);
        hb1[m][r] = acc[m][1][r];
      }
  }
  for (int i = 0; i < L * MT; ++i) hcar[i * NT + tid] = zero4;
  for (int i = tid + IO_SLOTS * NT; i < D * R; i += NT) xs[slot_at(i)] = 0.0f;

  // ---------------- decoder sweep + output head + residual + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;
  const float* const hout = buf(L - 1);

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int nv = min(TC, T - t0);
    {
      // layer 0's sweep; store_chunk's first barrier also ends the reads of
      // dec_in (first chunk) and of the last chunk's output head (L == 1)
      float acc[NM][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 c = hcar[m * NT + tid];
        float h[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int s = 0; s < TC; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (s < nv) h[r] = h[r] + z1[m][r] * (hb1[m][r] - h[r]);
            acc[s * MT + m][0][r] = h[r];
          }
        hcar[m * NT + tid] = make_float4(h[0], h[1], h[2], h[3]);
      }
      store_chunk<H, NM, BF>(acc, buf(0));
    }
#pragma unroll 1
    for (int l = 1; l < L; ++l) {
      float acc[NM][2][4];
      tc_bias<H, NM>(acc, layer_ptr(Wt.dec_b, l));
      gate_mma<H, NM, SUM>(acc, layer_ptr(Wt.dec_f, l), KH, buf(l - 1), HP);
      sweep<MT, TC, NT, BF, SIG_TANH>(acc, hcar + l * MT * NT + tid, nv);
      store_chunk<H, NM, BF>(acc, buf(l));
    }
    // output head for the chunk: slot i runs d, then b, then s (rows of one
    // step are apart by HP floats: conflict-free); it reads hout before the
    // next chunk's first barrier, after which it may be overwritten
    auto head = [&](int i, float& acc) {
      const int d = i % D, b = (i / D) % BT, s = i / (D * BT);
      const int n = n0 + b;
      if (s < nv && n < N) {
        const float* hr = hout + (s * BT + b) * HP;
        float y = __ldg(Wt.out_b + d);
        for (int k = 0; k < H; ++k)
          y = fmaf(rd<BF>(__ldg(Wt.out_w + k * D + d)), rd<BF>(hr[k]), y);
        const size_t off = ((size_t)n * T + t0 + s) * D + d;
        const float e = ld_io(x + off) - rd<BF>(y);
        const float e2 = e * e;
        if (with_resid) st_io(resid + off, e2);
        acc += e2;
      }
    };
#pragma unroll
    for (int r = 0; r < IO_SLOTS; ++r) {
      const int i = tid + r * NT;
      if (i < D * R) head(i, acc_mse[r]);
    }
    for (int i = tid + IO_SLOTS * NT; i < D * R; i += NT) head(i, xs[slot_at(i)]);
  }

  // per-window MSE: each slot's sum over the chunks, then over the step
  // slots s, then over d, in order (xs is free in the decoder; the slots
  // past the registers' already in place)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) {
    const int i = tid + r * NT;
    if (i < D * R) xs[slot_at(i)] = acc_mse[r];
  }
  __syncthreads();
  if (tid < BT && n0 + tid < N) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) {
      float sd = 0.0f;
      for (int k = 0; k < TC; ++k) sd += xs[(d * TC + k) * BT + tid];
      s += sd;
    }
    mse[n0 + tid] = s / (float)(T * D);
  }
}

template <int H, int MT, int TC, int SUM, typename IOT = float,
          bool SIG_TANH = false>
cudaError_t launch_tc(const IOT* x, IOT* resid, float* mse,
                      const MinGruWeights& W, int N, int T, int D, int Z, int L,
                      int use_ln, int with_resid, cudaStream_t stream,
                      int h_real = H) {
  const size_t smem = sizeof(float) * tc_smem_floats<H, MT, TC>(L, D, Z);
  auto kern = fused_mingru_tc_kernel<H, MT, TC, SUM, IOT, SIG_TANH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BT = 16 * MT;
  kern<<<(N + BT - 1) / BT, 4 * H, smem, stream>>>(
      x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, h_real);
  return cudaGetLastError();
}

// The shipping instance: TC = 2 steps and MT = 2 m-tiles of 16 windows a
// tile, each pair of k-steps' six mma summed apart and added to the float32
// sum. Of the tiles the variant entry reaches, it is the fastest at the
// 8,192-window bucket whose chunk loop does not spill at 128 registers
// (H=128): TC = 4 with MT = 2 is a few percent faster but spills there
// (PERF.md §6).
constexpr int SHIP_TC = 2;
constexpr int SHIP_MT = 2;
constexpr int SHIP_SUM = TC_SPLIT;
constexpr int VARIANT_H = 128;    // the variant entry's width (the 4DOF preset)

// the shipping tile of a sum and io type: the logistic instance, or with
// sig_tanh the tanh-form one (template SIG_TANH: 9 instances beside the 9
// logistic ones, which keep their code and bits)
template <int H, int SUM, typename IOT>
cudaError_t launch_sig(const IOT* x, IOT* resid, float* mse,
                       const MinGruWeights& W, int N, int T, int D, int Z,
                       int L, int use_ln, int with_resid, int sig_tanh,
                       int h_real, cudaStream_t s) {
  if (sig_tanh)
    return launch_tc<H, SHIP_MT, SHIP_TC, SUM, IOT, true>(x, resid, mse, W, N, T, D, Z,
                                                          L, use_ln, with_resid, s, h_real);
  return launch_tc<H, SHIP_MT, SHIP_TC, SUM, IOT, false>(x, resid, mse, W, N, T, D, Z,
                                                         L, use_ln, with_resid, s, h_real);
}

template <int H>
cudaError_t launch_ship(const float* x, float* resid, float* mse,
                        const MinGruWeights& W, int N, int T, int D, int Z,
                        int L, int use_ln, int with_resid, int sig_tanh,
                        int h_real, cudaStream_t s) {
  return launch_sig<H, SHIP_SUM, float>(x, resid, mse, W, N, T, D, Z, L,
                                        use_ln, with_resid, sig_tanh, h_real, s);
}

// the bf16 instance, at the shipping tile, with float32 or bf16 io
template <int H>
cudaError_t launch_bf16(const void* x, void* resid, float* mse,
                        const MinGruWeights& W, int N, int T, int D, int Z,
                        int L, int use_ln, int with_resid, int sig_tanh,
                        int io_bf16, int h_real, cudaStream_t s) {
  if (io_bf16)
    return launch_sig<H, TC_BF16, bf16_t>(
        static_cast<const bf16_t*>(x), static_cast<bf16_t*>(resid), mse, W, N,
        T, D, Z, L, use_ln, with_resid, sig_tanh, h_real, s);
  return launch_sig<H, TC_BF16, float>(
      static_cast<const float*>(x), static_cast<float*>(resid), mse, W, N, T,
      D, Z, L, use_ln, with_resid, sig_tanh, h_real, s);
}

template <int H, int MT, int TC, int SUM = SHIP_SUM, typename IOT = float,
          bool SIG_TANH = false>
cudaError_t tc_info(int L, int D, int Z, int* out) {
  auto kern = fused_mingru_tc_kernel<H, MT, TC, SUM, IOT, SIG_TANH>;
  const size_t smem = sizeof(float) * tc_smem_floats<H, MT, TC>(L, D, Z);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 4 * H, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = 4 * H;
  out[3] = (int)smem;
  out[4] = 16 * MT;
  out[5] = blocks;
  out[6] = TC;
  return cudaSuccess;
}

bool unpack_weights(const void* const* w, int n_w, MinGruWeights& W) {
  if (n_w != NUM_W) return false;
  const float* const* p = reinterpret_cast<const float* const*>(w);
  for (int l = 0; l < LMAX; ++l) {
    W.enc_b[l] = p[LMAX + l];
    W.dec_b[l] = p[3 * LMAX + 6 + l];
    W.enc_f[l] = reinterpret_cast<const float4*>(p[4 * LMAX + 8 + l]);
    W.dec_f[l] = reinterpret_cast<const float4*>(p[5 * LMAX + 8 + l]);
  }
  W.ln_scale = p[2 * LMAX + 0];
  W.ln_bias = p[2 * LMAX + 1];
  W.mu_w = p[2 * LMAX + 2];
  W.mu_b = p[2 * LMAX + 3];
  W.z2h_w = p[2 * LMAX + 4];
  W.z2h_b = p[2 * LMAX + 5];
  W.out_w = p[4 * LMAX + 6];
  W.out_b = p[4 * LMAX + 7];
  return true;
}

bool valid_shape(int N, int T, int D, int Z, int L) {
  return N > 0 && T > 0 && D > 0 && D <= DLIM && Z > 0 && Z <= ZLIM &&
         L >= 1 && L <= LMAX;
}

}  // namespace

// C entry for ctypes. `w` holds NUM_W = 6*LMAX + 8 device pointers in the
// order
//   enc_w[0..3] enc_b[0..3] ln_scale ln_bias mu_w mu_b z2h_w z2h_b
//   dec_w[0..3] dec_b[0..3] out_w out_b, then the fragments (16-byte
//   aligned) of enc_w[0..3] and dec_w[0..3]
// (pointers of layers >= L and of an unused LayerNorm may be null; the
// w_ih as given are the plain version's, the kernel reads their fragments).
// H is the instance's width (32, 64 or 128) and the weights' with their
// padding; h_real <= H the model's, over which LayerNorm normalises.
// Launches the shipping instance; returns the launch's cudaGetLastError(),
// 0 on success.
extern "C" int shm_fused_mingru_gate_f32(const float* x, float* resid,
                                         float* mse, const void* const* w,
                                         int n_w, int N, int T, int D, int H,
                                         int h_real, int Z, int L, int use_ln,
                                         int with_resid, int sig_tanh,
                                         void* stream) {
  MinGruWeights W;
  if (!valid_shape(N, T, D, Z, L) || (with_resid && resid == nullptr) ||
      (sig_tanh != 0 && sig_tanh != 1) || h_real < 1 || h_real > H ||
      !unpack_weights(w, n_w, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (H) {
    case 32: return (int)launch_ship<32>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, h_real, s);
    case 64: return (int)launch_ship<64>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, h_real, s);
    case 128: return (int)launch_ship<128>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, h_real, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The C entry of the bf16 instance: the arguments of
// shm_fused_mingru_gate_f32 with `w`'s fragments those of the bf16-rounded
// weights, x and resid bf16 when io_bf16 is 1 and float32 when it is 0.
// Returns the launch's cudaGetLastError(), 0 on success.
extern "C" int shm_fused_mingru_gate_bf16(const void* x, void* resid,
                                          float* mse, const void* const* w,
                                          int n_w, int N, int T, int D, int H,
                                          int h_real, int Z, int L, int use_ln,
                                          int with_resid, int sig_tanh,
                                          int io_bf16, void* stream) {
  MinGruWeights W;
  if (!valid_shape(N, T, D, Z, L) || (with_resid && resid == nullptr) ||
      (sig_tanh != 0 && sig_tanh != 1) || (io_bf16 != 0 && io_bf16 != 1) ||
      h_real < 1 || h_real > H || !unpack_weights(w, n_w, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (H) {
    case 32: return (int)launch_bf16<32>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, io_bf16, h_real, s);
    case 64: return (int)launch_bf16<64>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, io_bf16, h_real, s);
    case 128: return (int)launch_bf16<128>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, sig_tanh, io_bf16, h_real, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The variants of the same body, gate-only (mse), at H = VARIANT_H, `w` as
// above: `sum` TC_CHAIN, TC_SPLIT or TC_ONE_TERM (0, 1, 2); `tc` steps and
// `mt` m-tiles a tile. TC_SPLIT takes tc in {1, 2, 4} and mt in {1, 2}; the
// other two sums the shipping tc and mt. Returns the launch's
// cudaGetLastError(), 0 on success.
extern "C" int shm_fused_mingru_variant(const float* x, float* mse,
                                        const void* const* w, int n_w, int N,
                                        int T, int D, int H, int Z, int L,
                                        int use_ln, int sum, int tc, int mt,
                                        void* stream) {
  MinGruWeights W;
  if (!valid_shape(N, T, D, Z, L) || H != VARIANT_H || !unpack_weights(w, n_w, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr int V = VARIANT_H;
  if (sum != TC_SPLIT) {
    if (tc != SHIP_TC || mt != SHIP_MT) return (int)cudaErrorInvalidValue;
    if (sum == TC_CHAIN)
      return (int)launch_tc<V, SHIP_MT, SHIP_TC, TC_CHAIN, float>(x, nullptr, mse, W, N, T, D, Z, L, use_ln, 0, s);
    if (sum == TC_ONE_TERM)
      return (int)launch_tc<V, SHIP_MT, SHIP_TC, TC_ONE_TERM, float>(x, nullptr, mse, W, N, T, D, Z, L, use_ln, 0, s);
    return (int)cudaErrorInvalidValue;
  }
#define SHM_MINGRU_SPLIT(TC_, MT_)                                            \
  if (tc == TC_ && mt == MT_)                                                 \
    return (int)launch_tc<V, MT_, TC_, TC_SPLIT, float>(x, nullptr, mse, W, N, \
                                                        T, D, Z, L, use_ln, 0, s);
  SHM_MINGRU_SPLIT(1, 1) SHM_MINGRU_SPLIT(1, 2)
  SHM_MINGRU_SPLIT(2, 1) SHM_MINGRU_SPLIT(2, 2)
  SHM_MINGRU_SPLIT(4, 1) SHM_MINGRU_SPLIT(4, 2)
#undef SHM_MINGRU_SPLIT
  return (int)cudaErrorInvalidValue;
}

template <int H, bool SIG_TANH>
cudaError_t ship_info_of(int L, int D, int Z, int bf16, int io_bf16, int* out) {
  if (!bf16) return tc_info<H, SHIP_MT, SHIP_TC, SHIP_SUM, float, SIG_TANH>(L, D, Z, out);
  if (io_bf16) return tc_info<H, SHIP_MT, SHIP_TC, TC_BF16, bf16_t, SIG_TANH>(L, D, Z, out);
  return tc_info<H, SHIP_MT, SHIP_TC, TC_BF16, float, SIG_TANH>(L, D, Z, out);
}

template <int H>
cudaError_t ship_info(int L, int D, int Z, int bf16, int io_bf16, int sig_tanh,
                      int* out) {
  return sig_tanh ? ship_info_of<H, true>(L, D, Z, bf16, io_bf16, out)
                  : ship_info_of<H, false>(L, D, Z, bf16, io_bf16, out);
}

// out = registers a thread, local memory (spill) bytes a thread, threads a
// block, dynamic shared bytes a block, windows a block, blocks an SM at
// once, and steps a tile of a shipping instance for windows of T steps of D
// features at width H with L layers and Z latents (its shared memory
// depends on H, L, D and Z): the float32 one (bf16 = 0) or the bf16 one
// with float32 or bf16 io, with the logistic (sig_tanh = 0) or the
// tanh-form sigmoid (1).
extern "C" int shm_fused_mingru_info(int T, int H, int L, int D, int Z,
                                     int bf16, int io_bf16, int sig_tanh,
                                     int* out) {
  if (T < 1 || L < 1 || L > LMAX || D < 1 || D > DLIM || Z < 1 || Z > ZLIM ||
      (bf16 != 0 && bf16 != 1) || (io_bf16 != 0 && io_bf16 != 1) ||
      (io_bf16 && !bf16) || (sig_tanh != 0 && sig_tanh != 1))
    return (int)cudaErrorInvalidValue;
  switch (H) {
    case 32: return (int)ship_info<32>(L, D, Z, bf16, io_bf16, sig_tanh, out);
    case 64: return (int)ship_info<64>(L, D, Z, bf16, io_bf16, sig_tanh, out);
    case 128: return (int)ship_info<128>(L, D, Z, bf16, io_bf16, sig_tanh, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
