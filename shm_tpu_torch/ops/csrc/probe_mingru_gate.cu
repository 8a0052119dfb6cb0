// Gate-only minGRU-VAE probe kernel for Hopper (sm_90a), project-then-sweep.
//
// Replaces the Pallas TPU kernel tools/probe_mingru_recur.py::make_gate's
// _kernel (:44, body :49), pallas_call at :184: a clone of the minGRU gate
// whose recurrence sweeps run `loop_T` steps instead of T, to attribute the
// gate's time to those serial loops. Same function, 2 layers, LayerNorm on:
//
//   encoder layer l: project every step, g = W^T in_t + b [2H] with
//     z = sigmoid(g[:H]) (tanh form) and h~ = g[H:] stored in bf16 over all T;
//     then the sweep h_t = h_{t-1} + z_t * (h~_t - h_{t-1}) from h = 0 for
//     loop_T steps (layer 0 stores h_t in bf16 for layer 1's projection);
//   LayerNorm (eps 1e-6, as the TPU probe has it at :114; the model and the
//     shipping kernel use 1e-5) -> mu -> dec_in = tanh(fc_latent_to_hidden(mu));
//   decoder layer 0: its gates from dec_in once, swept for loop_T steps
//     (h stored in bf16); layer 1 projected over all T and swept (stored);
//   y = out_w^T h + out_b over all T, stored in bf16; the output loop sums
//     (x_t - y_t)^2 over loop_T steps; mse = sum / (T*D).
//
// With loop_T = T this is the gate's MSE; with loop_T = 1 only step 0 counts
// (the rest of the scratch is never read for the result). Numerics as the
// TPU clone: windows and product operands in bf16, sums in float32, sigmoid
// as 0.5*(tanh(x/2)+1), the g / h / y scratch in bf16, the sweeps' carried h
// in float32.
//
// Bound on this card. The product work is that of fused_mingru.cu, ~14.1
// MFLOP a window: ~307 GFLOP at N=21,760, 0.31 ms at the 989 TFLOP/s bf16
// tensor-core rate (4.58 ms at the 67 TFLOP/s float32 FMA rate). The
// function's own bytes (x once, mse) are ~0.1 GB. But this structure, which
// the probe exists to time, moves its scratch through device memory: per
// window g is written by three projections and read by three sweeps (2 x 3
// x T*2H*2 bytes), h written by three sweeps and read by three projections
// (2 x 3 x T*H*2), y and x ~10 KB more: ~475 KB a window, ~10.3 GB a call
// at N=21,760, ~3.1 ms at 3.35 TB/s (~5.2 GB, ~1.5 ms with loop_T=1). The
// scratch cannot stay in L2: it is 2.56 MB a 32-window tile, 132 tiles in
// flight. So once the products run on the tensor cores, the scratch's bytes
// bind this kernel, not its operations.
//
// Design. The TPU kernel keeps its sequences in fast memory; one window's
// are 77 KB here, so the scratch lives in device memory, [tile][T][rows][32
// windows] in bf16, allocated by the wrapper. One block of 512 threads (16
// warps) owns a tile of 32 windows and runs the phases in order, with a
// barrier between phases (a block's global writes are visible to the block
// after __syncthreads):
//   * projections on the tensor cores: every product over all T steps
//     (encoder layer 0 with K = D padded to 16, encoder and decoder layer 1
//     with K = H, the output head with M = D padded to 16) is
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, g^T's rows the
//     weights' outputs (A = W^T, M x K) and its columns (step, window)
//     pairs. The wrapper packs each weight once as A fragments
//     ([m-tile][k-step][lane] x 16 bytes, ops/_gate.py::bf16_a_fragments);
//     warp w holds m-tile w's fragments in registers for the whole
//     projection (32 registers at K = H). A chunk of CS = 4 steps x 32
//     windows (16 n-tiles) of the input is staged in shared memory as bf16
//     in the scratch's own layout [step][k][window], each k-row padded to
//     80 bytes so the B fragments' ldmatrix.trans reads have no bank
//     conflicts: from the scratch by cp.async, two buffers, the next chunk
//     in flight while this one multiplies; from the windows (float32,
//     rounded) through registers, loaded a chunk ahead. Each warp walks its
//     m-tile over one step's 4 n-tiles at a time (16 accumulators and 16
//     partials), so the epilogue (bias, tanh-form sigmoid on rows < H, bf16
//     pack) stays in registers and stores two adjacent windows' values as
//     one 4-byte store into g[t][r][b]. The output head gives warp w n-tile
//     w of the chunk.
//   * sums: the tensor cores add each mma's products to its accumulator
//     and truncate the sum toward zero, so each pair of k-steps' two mma
//     are chained from zero and that partial added to the float32 sum with
//     a round-to-nearest add (TC_SPLIT of fused_mingru.cu and
//     probe_matmul_loop.cu); the bias is added after the sum. No atomics.
//   * sweeps: elementwise; thread (j, wg) owns unit j for 8 windows, h in
//     registers, z and h~ read as 16-byte loads (4 lanes cover a row's 32
//     windows, 64 contiguous bytes) and h stored the same way;
//   * LayerNorm, the heads mu and fc_latent_to_hidden and the decoder's
//     constant layer-0 gates (once a window) on the FMA pipes, as before.
// H = 128, D <= 16, Z <= 32. No library product.

#include <cuda_runtime.h>

namespace {

constexpr int H = 128;
constexpr int H2 = 2 * H;
constexpr int BT = 32;            // windows per block (one tile)
constexpr int NT = 512;           // threads: 16 warps, one m-tile of 2H each
constexpr int CS = 4;             // steps per staged chunk (16 n-tiles)
constexpr int DMAX = 16;
constexpr int ZMAX = 32;
constexpr int NUM_W = 16;
constexpr int RS = BT + 8;        // bf16 a staged k-row: 32 windows, 16 bytes of pad
constexpr int KS_H = H / 16;      // k-steps of a product over h (8)
constexpr int STAGE_H = CS * H * RS;              // bf16 of a chunk of h (40 KB)

typedef unsigned short bf16_t;

struct MinGruProbeWeights {       // biases, LayerNorm float32
  const uint4* enc_a[2];          // A fragments of enc w_ih^T [2H, K]
  const float* enc_b[2];
  const float* ln_scale;
  const float* ln_bias;
  const bf16_t* mu_w;             // bf16 [H, Z]
  const float* mu_b;
  const bf16_t* z2h_w;            // bf16 [Z, H]
  const float* z2h_b;
  const bf16_t* dec0_w;           // bf16 [H, 2H]: the constant gates, FMA
  const uint4* dec1_a;            // A fragments of dec1 w_ih^T [2H, H]
  const float* dec_b[2];
  const uint4* out_a;             // A fragments of out_w^T [D -> 16, H]
  const float* out_b;
};

__device__ __forceinline__ float bf(bf16_t v) { return __uint_as_float((unsigned)v << 16); }
__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bfr(float x) { return bf_lo(pack_bf16x2(x, x)); }
__device__ __forceinline__ float sig_tanh(float x) { return 0.5f * (tanhf(0.5f * x) + 1.0f); }

// h + z * (hb - h), rounded after each operation
__device__ __forceinline__ float sweep_step(float h, float z, float hb) {
  return __fadd_rn(h, __fmul_rn(z, __fsub_rn(hb, h)));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices of shared memory, transposed: lanes 8q..8q+7 give
// the rows of matrix q, and r[q] holds lane (g, t)'s {M_q[2t][g], M_q[2t+1][g]}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The sum of one product, k-step pair by pair: part = the pair's mma
// chained from zero (one mma where the pair has one k-step), then
// acc = acc + part rounded to nearest. The tensor cores truncate each mma's
// sum toward zero; chaining only two keeps that drift to a pair's partial.
__device__ __forceinline__ void add_pair(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
}

// this warp's A fragments: m-tile mt, KS k-steps, [mt][k-step][lane] x uint4
template <int KS>
__device__ __forceinline__ void load_a(unsigned (&a)[KS][4], const uint4* __restrict__ af,
                                       int mt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint4 q = __ldg(af + (mt * KS + ks) * 32 + lane);
    a[ks][0] = q.x; a[ks][1] = q.y; a[ks][2] = q.z; a[ks][3] = q.w;
  }
}

// g[t][r][b] for warp w's m-tile (rows 16w..16w+15 of 2H) and step t of the
// chunk staged at st ([step s][k][RS], K = 16 KS): the product over one
// step's 4 n-tiles (32 windows), bias, the tanh-form sigmoid on rows < H,
// stored in bf16, two windows a 4-byte store. (Pairing z and h~ of 8 units
// in each m-tile, so every warp takes the same share of the sigmoids, ran
// no faster: PERF.md §6.)
template <int KS>
__device__ __forceinline__ void gate_step(const unsigned (&a)[KS][4], float blo, float bhi,
                                          const bf16_t* st, int s, bf16_t* g, int t) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = lane >> 3, i = lane & 7;
  // ldmatrix row address of lane (q, i): k-row 8(q%2)+i, n-tiles 2h + q/2
  const bf16_t* row = st + (s * 16 * KS + 8 * (q & 1) + i) * RS + 8 * (q >> 1);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kp = 0; kp < (KS + 1) / 2; ++kp) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * kp + kk;
      if (ks >= KS) break;
      unsigned b01[4], b23[4];                    // {b0, b1} of n-tiles 0, 1 / 2, 3
      ldsm_x4_trans(b01, row + ks * 16 * RS);
      ldsm_x4_trans(b23, row + ks * 16 * RS + 16);
      mma_bf16(part[0], a[ks], b01[0], b01[1]);
      mma_bf16(part[1], a[ks], b01[2], b01[3]);
      mma_bf16(part[2], a[ks], b23[0], b23[1]);
      mma_bf16(part[3], a[ks], b23[2], b23[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) add_pair(acc[j], part[j]);
  }
  const bool gate = w < H / 16;                   // the z rows: sigmoid
  const int r0 = 16 * w + (lane >> 2), b0 = 2 * (lane & 3);
  bf16_t* out = g + ((size_t)t * H2 + r0) * BT + b0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[4] = {acc[j][0] + blo, acc[j][1] + blo, acc[j][2] + bhi, acc[j][3] + bhi};
    if (gate)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = sig_tanh(v[e]);
    *reinterpret_cast<unsigned*>(out + 8 * j) = pack_bf16x2(v[0], v[1]);
    *reinterpret_cast<unsigned*>(out + 8 * BT + 8 * j) = pack_bf16x2(v[2], v[3]);
  }
}

// stage rows (s, k) of the chunk at step t0 of a bf16 scratch [T][H][BT]
// into st [CS][H][RS] by cp.async, one commit group; steps past T are left
// as they are (their columns are never stored)
__device__ __forceinline__ void stage_h(bf16_t* st, const bf16_t* src, int t0, int T) {
  for (int i = threadIdx.x; i < CS * H * 4; i += NT) {
    const int piece = i & 3, rk = i >> 2, s = rk / H;
    if (t0 + s < T)
      cp_async16(st + rk * RS + 8 * piece, src + ((size_t)t0 * H + rk) * BT + 8 * piece);
  }
  cp_async_commit();
}

// chunk c of a bf16 scratch [T][H][BT] through two stage buffers: issues
// chunk c+1's copy (chunk 0's was issued before the loop), waits for chunk
// c's and returns its buffer once every thread's part is in place. The
// caller ends each chunk with a barrier, so no buffer is refilled while read.
__device__ __forceinline__ const bf16_t* next_chunk(bf16_t* stage, const bf16_t* src, int c,
                                                    int T) {
  if ((c + 1) * CS < T) {
    stage_h(stage + ((c + 1) & 1) * STAGE_H, src, (c + 1) * CS, T);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return stage + (c & 1) * STAGE_H;
}

// g = act(W^T in + b) over all T for a product over h (K = H), in = a bf16
// scratch [T][H][BT]
__device__ void project_h(bf16_t* stage, const uint4* __restrict__ af,
                          const float* __restrict__ bias, const bf16_t* src, bf16_t* g,
                          int T) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned a[KS_H][4];
  load_a<KS_H>(a, af, w);
  const float blo = __ldg(bias + 16 * w + (lane >> 2)), bhi = __ldg(bias + 16 * w + 8 + (lane >> 2));
  stage_h(stage, src, 0, T);
  for (int c = 0; c * CS < T; ++c) {
    const bf16_t* st = next_chunk(stage, src, c, T);
    for (int s = 0; s < CS && c * CS + s < T; ++s) gate_step<KS_H>(a, blo, bhi, st, s, g, c * CS + s);
    __syncthreads();
  }
}

// element j of this thread's share of a chunk of the windows: (window b,
// step s, k) with k fastest, 16 k a (window, step) of which D are real
__device__ __forceinline__ float x_value(const float* __restrict__ x, int e, int t0, int n0,
                                         int N, int T, int D) {
  const int k = e & 15, s = (e >> 4) % CS, b = e / (16 * CS), t = t0 + s, n = n0 + b;
  return k < D && t < T && n < N ? x[((size_t)n * T + t) * D + k] : 0.0f;
}

// g = act(W^T x_t + b) over all T for encoder layer 0 (K = D padded to 16,
// one k-step): each chunk of the windows rounded to bf16 into the stage
// [CS][16][RS], the next chunk's values loaded into registers meanwhile
__device__ void project_x(bf16_t* stage, const uint4* __restrict__ af,
                          const float* __restrict__ bias, const float* __restrict__ x,
                          bf16_t* g, int n0, int N, int T, int D) {
  constexpr int PER = CS * BT * 16 / NT;          // values a thread stages (4)
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned a[1][4];
  load_a<1>(a, af, w);
  const float blo = __ldg(bias + 16 * w + (lane >> 2)), bhi = __ldg(bias + 16 * w + 8 + (lane >> 2));
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = x_value(x, threadIdx.x + NT * j, 0, n0, N, T, D);
  for (int t0 = 0; t0 < T; t0 += CS) {
    __syncthreads();                              // the last chunk's reads done
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + NT * j, k = e & 15, s = (e >> 4) % CS, b = e / (16 * CS);
      stage[(s * 16 + k) * RS + b] = (bf16_t)(pack_bf16x2(v[j], 0.0f) & 0xffffu);
    }
    __syncthreads();
    if (t0 + CS < T)
#pragma unroll
      for (int j = 0; j < PER; ++j)
        v[j] = x_value(x, threadIdx.x + NT * j, t0 + CS, n0, N, T, D);
    for (int s = 0; s < CS && t0 + s < T; ++s) gate_step<1>(a, blo, bhi, stage, s, g, t0 + s);
  }
}

// y[t][d][b] = bf16(out_w[:, d]^T h[t][:, b] + out_b[d]) for d < D over all
// T: one m-tile (D padded to 16 rows), warp w takes n-tile w of each chunk
// (step w/4, windows 8(w%4)..+7)
__device__ void project_out(bf16_t* stage, const uint4* __restrict__ af,
                            const float* __restrict__ bias, const bf16_t* src, bf16_t* y,
                            int T, int D) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, i = lane & 7, s = w >> 2, nb = 8 * (w & 3);
  unsigned a[KS_H][4];
  load_a<KS_H>(a, af, 0);
  const int d0 = lane >> 2, d1 = d0 + 8, b0 = nb + 2 * (lane & 3);
  const float blo = d0 < D ? __ldg(bias + d0) : 0.0f, bhi = d1 < D ? __ldg(bias + d1) : 0.0f;
  stage_h(stage, src, 0, T);
  for (int c = 0; c * CS < T; ++c) {
    const bf16_t* st = next_chunk(stage, src, c, T);
    const int t = c * CS + s;
    if (t < T) {
      // lane (q, i): k-row 8q+i of k-steps 2kp, 2kp+1 -> {b0, b1} of each
      const bf16_t* row = st + (s * H + 8 * q + i) * RS + nb;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kp = 0; kp < KS_H / 2; ++kp) {
        unsigned b[4];
        ldsm_x4_trans(b, row + kp * 32 * RS);
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a[2 * kp], b[0], b[1]);
        mma_bf16(part, a[2 * kp + 1], b[2], b[3]);
        add_pair(acc, part);
      }
      if (d0 < D)
        *reinterpret_cast<unsigned*>(y + ((size_t)t * DMAX + d0) * BT + b0) =
            pack_bf16x2(acc[0] + blo, acc[1] + blo);
      if (d1 < D)
        *reinterpret_cast<unsigned*>(y + ((size_t)t * DMAX + d1) * BT + b0) =
            pack_bf16x2(acc[2] + bhi, acc[3] + bhi);
    }
    __syncthreads();
  }
}

// the sweep over loop_T steps of g [T][2H][BT]: thread (j, wg) owns unit j of
// windows wg*8..wg*8+7; stores h_t in bf16 to hout when it is not null;
// returns the last h in h[8]
__device__ void sweep(const bf16_t* g, bf16_t* hout, int loop_T, float (&h)[8]) {
  const int j = threadIdx.x / 4, wg = threadIdx.x % 4;
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = 0.0f;
  for (int t = 0; t < loop_T; ++t) {
    const uint4 zq = *reinterpret_cast<const uint4*>(g + ((size_t)t * H2 + j) * BT + wg * 8);
    const uint4 hq = *reinterpret_cast<const uint4*>(g + ((size_t)t * H2 + H + j) * BT + wg * 8);
    const unsigned zz[4] = {zq.x, zq.y, zq.z, zq.w}, hh[4] = {hq.x, hq.y, hq.z, hq.w};
    unsigned o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[2 * e] = sweep_step(h[2 * e], bf_lo(zz[e]), bf_lo(hh[e]));
      h[2 * e + 1] = sweep_step(h[2 * e + 1], bf_hi(zz[e]), bf_hi(hh[e]));
      o[e] = pack_bf16x2(h[2 * e], h[2 * e + 1]);
    }
    if (hout)
      *reinterpret_cast<uint4*>(hout + ((size_t)t * H + j) * BT + wg * 8) =
          make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(NT)
probe_mingru_gate_kernel(const float* __restrict__ x, float* __restrict__ mse,
                         const MinGruProbeWeights Wt, bf16_t* g_all, bf16_t* h_all,
                         bf16_t* y_all, int N, int T, int D, int Z, int loop_T) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* stage = reinterpret_cast<bf16_t*>(smem);  // two chunk buffers, 80 KB
  float* xs = reinterpret_cast<float*>(smem);       // aliased after the encoder
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BT;
  bf16_t* g = g_all + (size_t)blockIdx.x * T * H2 * BT;
  bf16_t* hseq = h_all + (size_t)blockIdx.x * T * H * BT;
  bf16_t* y = y_all + (size_t)blockIdx.x * T * DMAX * BT;
  const int j = tid / 4, wg = tid % 4;
  float h[8];

  // ---------------- encoder
  project_x(stage, Wt.enc_a[0], Wt.enc_b[0], x, g, n0, N, T, D);
  __syncthreads();
  sweep(g, hseq, loop_T, h);
  __syncthreads();
  project_h(stage, Wt.enc_a[1], Wt.enc_b[1], hseq, g, T);
  __syncthreads();
  sweep(g, nullptr, loop_T, h);

  // ---------------- LayerNorm (eps 1e-6), mu, dec_in (aliasing the stage)
  float* hl = xs;                                  // [H][BT]
  float* mus = xs + H * BT;                        // [ZMAX][BT]
  float* din = mus + ZMAX * BT;                    // [H][BT]
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 8; ++w) hl[j * BT + wg * 8 + w] = h[w];
  __syncthreads();
  if (tid < BT) {
    float m = 0.0f;
    for (int k = 0; k < H; ++k) m += hl[k * BT + tid];
    m /= H;
    float v = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float dv = hl[k * BT + tid] - m;
      v += dv * dv;
    }
    v /= H;
    const float r = rsqrtf(v + 1e-6f);
    for (int k = 0; k < H; ++k)
      hl[k * BT + tid] = bfr((hl[k * BT + tid] - m) * r * __ldg(Wt.ln_scale + k) +
                             __ldg(Wt.ln_bias + k));
  }
  __syncthreads();
  for (int i = tid; i < Z * BT; i += NT) {
    const int b = i % BT, z = i / BT;
    float s = 0.0f;
    for (int k = 0; k < H; ++k) s = fmaf(bf(__ldg(Wt.mu_w + k * Z + z)), hl[k * BT + b], s);
    mus[z * BT + b] = bfr(s + __ldg(Wt.mu_b + z));
  }
  __syncthreads();
  for (int i = tid; i < H * BT; i += NT) {
    const int b = i % BT, k = i / BT;
    float s = 0.0f;
    for (int z = 0; z < Z; ++z) s = fmaf(bf(__ldg(Wt.z2h_w + z * H + k)), mus[z * BT + b], s);
    din[k * BT + b] = bfr(tanhf(s + __ldg(Wt.z2h_b + k)));
  }
  __syncthreads();

  // ---------------- decoder layer 0: constant gates, then the sweep
  {
    float zg[8], hb[8];
    const float bz = __ldg(Wt.dec_b[0] + j), bh = __ldg(Wt.dec_b[0] + H + j);
#pragma unroll
    for (int w = 0; w < 8; ++w) zg[w] = hb[w] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float wz = bf(__ldg(Wt.dec0_w + k * H2 + j));
      const float wh = bf(__ldg(Wt.dec0_w + k * H2 + H + j));
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float v = din[k * BT + wg * 8 + w];
        zg[w] = fmaf(wz, v, zg[w]);
        hb[w] = fmaf(wh, v, hb[w]);
      }
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      zg[w] = sig_tanh(zg[w] + bz);
      hb[w] += bh;
      h[w] = 0.0f;
    }
    for (int t = 0; t < loop_T; ++t) {
      unsigned o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[2 * e] = sweep_step(h[2 * e], zg[2 * e], hb[2 * e]);
        h[2 * e + 1] = sweep_step(h[2 * e + 1], zg[2 * e + 1], hb[2 * e + 1]);
        o[e] = pack_bf16x2(h[2 * e], h[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(hseq + ((size_t)t * H + j) * BT + wg * 8) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // ---------------- decoder layer 1, output head, MSE over loop_T steps
  project_h(stage, Wt.dec1_a, Wt.dec_b[1], hseq, g, T);
  __syncthreads();
  sweep(g, hseq, loop_T, h);
  __syncthreads();
  project_out(stage, Wt.out_a, Wt.out_b, hseq, y, T, D);
  __syncthreads();
  float* part = xs;                                // [D][BT]
  for (int i = tid; i < D * BT; i += NT) {
    const int d = i / BT, b = i % BT, n = n0 + b;
    float s = 0.0f;
    if (n < N)
      for (int t = 0; t < loop_T; ++t) {
        const float e = bfr(x[((size_t)n * T + t) * D + d]) - bf(y[((size_t)t * DMAX + d) * BT + b]);
        s += e * e;
      }
    part[i] = s;
  }
  __syncthreads();
  if (tid < BT && n0 + tid < N) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s += part[d * BT + tid];
    mse[n0 + tid] = s / (float)(T * D);
  }
}

constexpr size_t SMEM_BYTES = 2 * STAGE_H * sizeof(bf16_t);   // 80 KB
static_assert(SMEM_BYTES >= sizeof(float) * (2 * H + ZMAX) * BT, "LayerNorm alias");

}  // namespace

// Bytes of bf16 scratch (g, h, y) shm_probe_mingru_gate needs for N windows.
extern "C" long long shm_probe_mingru_gate_scratch_bytes(int N, int T) {
  const long long tiles = (N + BT - 1) / BT;
  return tiles * T * (long long)(H2 + H + DMAX) * BT * 2;
}

// C entry for ctypes. x [N, T, D] float32; `w` holds NUM_W device pointers
//   enc_w0 enc_w1 enc_b0 enc_b1 ln_scale ln_bias mu_w mu_b z2h_w z2h_b
//   dec_w0 dec_w1 dec_b0 dec_b1 out_w out_b
// where enc_w0, enc_w1, dec_w1 and out_w are bf16 A fragments of W^T
// (ops/_gate.py::bf16_a_fragments: [ceil(M/16)][ceil(K/16)][32 lanes] x 16
// bytes, M = 2H or D, K = D or H, the padding zero), mu_w, z2h_w and dec_w0
// bf16 [in, out], the rest float32; `scratch` of
// shm_probe_mingru_gate_scratch_bytes(N, T) bytes. H = 128, 1 <= loop_T <= T.
// Returns the launch's cudaGetLastError().
extern "C" int shm_probe_mingru_gate(const float* x, float* mse, const void* const* w,
                                     int n_w, void* scratch, int N, int T, int D,
                                     int H_, int Z, int loop_T, void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || H_ != H ||
      Z <= 0 || Z > ZMAX || loop_T < 1 || loop_T > T || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  MinGruProbeWeights W;
  W.enc_a[0] = static_cast<const uint4*>(w[0]);
  W.enc_a[1] = static_cast<const uint4*>(w[1]);
  W.enc_b[0] = static_cast<const float*>(w[2]);
  W.enc_b[1] = static_cast<const float*>(w[3]);
  W.ln_scale = static_cast<const float*>(w[4]);
  W.ln_bias = static_cast<const float*>(w[5]);
  W.mu_w = static_cast<const bf16_t*>(w[6]);
  W.mu_b = static_cast<const float*>(w[7]);
  W.z2h_w = static_cast<const bf16_t*>(w[8]);
  W.z2h_b = static_cast<const float*>(w[9]);
  W.dec0_w = static_cast<const bf16_t*>(w[10]);
  W.dec1_a = static_cast<const uint4*>(w[11]);
  W.dec_b[0] = static_cast<const float*>(w[12]);
  W.dec_b[1] = static_cast<const float*>(w[13]);
  W.out_a = static_cast<const uint4*>(w[14]);
  W.out_b = static_cast<const float*>(w[15]);
  const long long tiles = (N + BT - 1) / BT;
  bf16_t* g = static_cast<bf16_t*>(scratch);
  bf16_t* h = g + tiles * T * H2 * BT;
  bf16_t* y = h + tiles * T * H * BT;
  cudaError_t err = cudaFuncSetAttribute(
      probe_mingru_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  probe_mingru_gate_kernel<<<(unsigned)tiles, NT, SMEM_BYTES,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      x, mse, W, g, h, y, N, T, D, Z, loop_T);
  return (int)cudaGetLastError();
}

// out = registers a thread, local memory (spill) bytes a thread, threads a
// block, dynamic shared bytes a block, windows a block, blocks an SM at once.
extern "C" int shm_probe_mingru_gate_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, probe_mingru_gate_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(probe_mingru_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_mingru_gate_kernel, NT,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = NT;
  out[3] = (int)SMEM_BYTES;
  out[4] = BT;
  out[5] = blocks;
  return (int)cudaSuccess;
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
