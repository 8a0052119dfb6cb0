// Two-layer LSTM training scans for Hopper (sm_90a), float32: forward and
// hand-written backward of the VAE's encoder and decoder stacks.
//
// Replaces the four Pallas TPU kernels of shm_tpu/ops/lstm_train.py:
//   _enc_fwd_kernel (:153, pallas_call :299)  -> lstm2_enc_fwd_kernel
//   _enc_bwd_kernel (:191, pallas_call :331)  -> lstm2_enc_bwd_kernel + the
//                                                parallel gradient pass below
//   _dec_fwd_kernel (:359, pallas_call :507)  -> lstm2_dec_fwd_kernel
//   _dec_bwd_kernel (:399, pallas_call :543)  -> lstm2_dec_bwd_kernel + the
//                                                parallel gradient pass below
// Same functions, same public layouts (batch last): xs [T,D,B], dropout mask
// dm [T,H,B] (inverted, constant; multiplies layer 0's output before layer 1),
// weights [4H,in] with gates i|f|g|o, biases [4H], stash of the PRE-step
// state (h0,c0,h1,c1) [T,4H,B], final state [4H,B].
//   encoder: xs -> h_last [H,B] (the top layer's last hidden state only);
//   decoder: dec_in [K,B], constant over T (its layer-0 projection is
//            computed once) -> recon [T,D,B] with the output head folded in.
// The backward recomputes the gate pre-activations from the stash with the
// same device function, in the same order, as the forward (gate_preact), so
// the gradient is that of exactly this forward.
//
// Bound on this card. At the 4DOF training shape (T=100, D=12, H=128, B=256)
// the encoder forward is 8H(D+3H)*T*B = 10.4 GFLOP, 0.16 ms at the 67 TFLOP/s
// float32 rate, and moves ~67 MB (x, mask, stash), 0.02 ms at 3.35 TB/s: it
// is bound by operations, and beyond that by latency, because the scan is a
// chain of 2*T dependent layer steps and a batch of 256 offers little to run
// beside it. The backward does the forward's products again (recompute),
// the transposed products for dh, and the weight-gradient products.
//
// Design (first version: right before fast).
//   * No sequential grid on this card, so the time loop lives inside the
//     block and the stash streams to device memory; there is no time chunking.
//   * The batch is small, so a block owns only BW=4 windows: B=256 gives 64
//     blocks on 64 of the 132 SMs. Each block streams a stack's weights from
//     L2 once per time step (one layer's f32 W_hh at H=128 is 256 KiB, more
//     than a block's shared memory), so a step costs what that stream's
//     latency costs, and the cure is loads in flight: the block has 4H
//     threads, one per gate row of the matrix products (one coalesced weight
//     load feeds 4 FMAs), each requesting its loads in explicit batches of 16
//     with the next batch requested before the current one is consumed; the
//     same threads then act as the H x 4 (unit, window) cell slots, with c
//     and the dh/dc carries in registers and the gates passed through shared
//     memory. (A first version with H threads, each owning the four gates of
//     a unit, took 3.0-3.4x as long as the 4H-thread one; leaving the batching
//     to `#pragma unroll 8` took 1.5x as long as this; PERF.md keeps the times.)
//   * The wrapper passes each matrix in the layout that makes the read
//     coalesced: [in,4H] for the gate products, the original [4H,in] for the
//     transposed products of the backward, whose 4H rows are split over four
//     thread groups and added in a fixed order.
//   * Weight gradients do not fit a block (one [4H,H] f32 accumulator is
//     256 KiB), and blocks run in no order. So the recurrent backward kernel
//     carries only the dh/dc chain and writes the gate gradients dg0, dg1
//     [T,4H,B]; a second, parallel pass contracts them over T*B against
//     x / h0 / h0*dm / h1 (all in the stash) with a tiled product, split over
//     T into partial sums that a last kernel adds in a fixed order. Bias
//     gradients, the decoder's layer-0 fold (dg0 summed over T first), the
//     head gradient, dx and d(dec_in) are the same kind of pass. There are no
//     float atomics anywhere: the same inputs give the same bits every run.
//   * A ragged last tile (B not a multiple of 4) is masked in the kernels.
// Against the bound: float32 FMA pipes, no tensor cores, half the SMs; the
// bf16/wgmma path and a tiling that fills the card are later work.
//
// Accurate expf/tanhf (no --use_fast_math); sigmoid(x) = 1/(1+exp(-x)).

#include <cuda_runtime.h>

namespace {

constexpr int BW = 4;        // windows per block
constexpr int DMAX = 32;     // widest encoder input / head output
constexpr int KMAX = 128;    // widest decoder input

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[w] += w * s4[0..3], s4 one broadcast float4 of a shared [.][BW] buffer
__device__ __forceinline__ void fma4(float (&acc)[BW], float w, const float* s4) {
  const float4 a = *reinterpret_cast<const float4*>(s4);
  acc[0] = fmaf(w, a.x, acc[0]);
  acc[1] = fmaf(w, a.y, acc[1]);
  acc[2] = fmaf(w, a.z, acc[2]);
  acc[3] = fmaf(w, a.w, acc[3]);
}

// acc[w] += sum_{k<K} Wt[k][r] * s[k][w]   (Wt row-major [K,4H]: the
// transposed weight, so a warp reads 32 neighbouring rows r of one k;
// s a shared [K][BW] buffer).
// The weight loads go out in explicit batches of RM_BATCH, the next batch
// before the FMAs of the current one (two register buffers), so that a
// thread keeps 2*RM_BATCH loads in flight against the L2 latency. Left to
// the compiler's scheduling of a `#pragma unroll` loop, the number in flight,
// and with it a kernel's time, swung 3x between neighbouring unroll depths.
// The sum runs over k in order whatever the batch.
constexpr int RM_BATCH = 16;

template <int H>
__device__ __forceinline__ void row_matvec(float (&acc)[BW],
                                           const float* __restrict__ Wt, int K,
                                           const float* s, int r) {
  constexpr int U = RM_BATCH;
  const float* wp = Wt + r;
  int k = 0;
  if (K >= U) {
    float w[U], wn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = __ldg(wp + (size_t)u * 4 * H);
#pragma unroll 1
    for (; k + U <= K; k += U) {
      const bool more = k + 2 * U <= K;
      if (more) {
#pragma unroll
        for (int u = 0; u < U; ++u) wn[u] = __ldg(wp + (size_t)(k + U + u) * 4 * H);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) fma4(acc, w[u], s + (k + u) * BW);
      if (more) {
#pragma unroll
        for (int u = 0; u < U; ++u) w[u] = wn[u];
      }
    }
  }
#pragma unroll 4
  for (; k < K; ++k) fma4(acc, __ldg(wp + (size_t)k * 4 * H), s + k * BW);
}

// Gate pre-activations of gate row r: acc = bias[r] + Wi[r,:]*in (+ Wh[r,:]*h).
// The ONE function both directions use, so the backward's recompute equals
// the forward bit for bit.
template <int H>
__device__ __forceinline__ void gate_preact(float (&acc)[BW],
                                            const float* __restrict__ bias,
                                            const float* __restrict__ Wi_t,
                                            int Ki, const float* in_s,
                                            const float* __restrict__ Wh_t,
                                            const float* h_s, int r) {
  const float b = __ldg(bias + r);
#pragma unroll
  for (int w = 0; w < BW; ++w) acc[w] = b;
  row_matvec<H>(acc, Wi_t, Ki, in_s, r);
  if (Wh_t != nullptr) row_matvec<H>(acc, Wh_t, H, h_s, r);
}

// acc = xp + Wh[r,:]*h: the decoder's layer 0, whose input projection xp is
// constant over T.
template <int H>
__device__ __forceinline__ void gate_preact_const(float (&acc)[BW],
                                                  const float (&xp)[BW],
                                                  const float* __restrict__ Wh_t,
                                                  const float* h_s, int r) {
#pragma unroll
  for (int w = 0; w < BW; ++w) acc[w] = xp[w];
  row_matvec<H>(acc, Wh_t, H, h_s, r);
}

__device__ __forceinline__ void store4(float* s, const float (&v)[BW], int row) {
  *reinterpret_cast<float4*>(s + row * BW) = make_float4(v[0], v[1], v[2], v[3]);
}

// One cell of (unit, window) slot `slot` = unit*BW + window from the gate
// pre-activations in shared gs[4H][BW].
template <int H>
__device__ __forceinline__ float cell_fwd(const float* gs, int slot, float& c) {
  const float i = sigmoid_f(gs[0 * H * BW + slot]);
  const float f = sigmoid_f(gs[1 * H * BW + slot]);
  const float gg = tanhf(gs[2 * H * BW + slot]);
  const float o = sigmoid_f(gs[3 * H * BW + slot]);
  c = f * c + i * gg;
  return o * tanhf(c);
}

// Backward through one cell from the recomputed pre-activations in gs and the
// stashed cell states: writes the four gate gradients of the slot to shared
// dgs[4H][BW] and to global dgo[4H][B]; dc <- dc * f.
template <int H>
__device__ __forceinline__ void cell_bwd(const float* gs, int slot, float dh,
                                         float& dc, float c_aft, float c_prev,
                                         float* dgs, float* __restrict__ dgo,
                                         int B, int unit, int b, bool live) {
  const float i = sigmoid_f(gs[0 * H * BW + slot]);
  const float f = sigmoid_f(gs[1 * H * BW + slot]);
  const float gg = tanhf(gs[2 * H * BW + slot]);
  const float o = sigmoid_f(gs[3 * H * BW + slot]);
  const float tc = tanhf(c_aft);
  const float d_o = dh * tc;
  const float d_c = dc + dh * o * (1.0f - tc * tc);
  const float dg[4] = {(d_c * gg) * i * (1.0f - i), (d_c * c_prev) * f * (1.0f - f),
                       (d_c * i) * (1.0f - gg * gg), d_o * o * (1.0f - o)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dgs[q * H * BW + slot] = dg[q];
    if (live) dgo[(size_t)(q * H + unit) * B + b] = dg[q];
  }
  dc = d_c * f;
}

// Partial sums of the transposed products for thread (unit j, row group rg):
//   pa[w] = sum_{r in group rg} Wa[r][j] * dgs[r][w]   (and pb with Wb)
// over the H rows of gate rg; W row-major [4H,H], coalesced over j. The
// four groups' partials are added in a fixed order by partial_sum.
// The loads go out in batches of WT_BATCH rows (one buffer: a second one
// costs the reverse scans more in registers than it hides).
constexpr int WT_BATCH = 16;

template <int H>
__device__ __forceinline__ void wt_partial(const float* __restrict__ Wa,
                                           const float* __restrict__ Wb,
                                           const float* dgs, int j, int rg,
                                           float* parts) {
  constexpr int U = WT_BATCH;
  static_assert(H % U == 0, "H is a multiple of the load batch");
  float pa[BW] = {0.0f, 0.0f, 0.0f, 0.0f}, pb[BW] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* ap = Wa + (size_t)rg * H * H + j;
  const float* bp = Wb == nullptr ? nullptr : Wb + (size_t)rg * H * H + j;
  const float* dg = dgs + rg * H * BW;
#pragma unroll 1
  for (int i = 0; i < H; i += U) {
    float wa[U], wb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wa[u] = __ldg(ap + (size_t)(i + u) * H);
      if (bp != nullptr) wb[u] = __ldg(bp + (size_t)(i + u) * H);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      fma4(pa, wa[u], dg + (i + u) * BW);
      if (bp != nullptr) fma4(pb, wb[u], dg + (i + u) * BW);
    }
  }
  store4(parts, pa, rg * H + j);
  if (Wb != nullptr) store4(parts + 4 * H * BW, pb, rg * H + j);
}

// sum over the four row groups, in order, of the partials of one slot
template <int H>
__device__ __forceinline__ float partial_sum(const float* parts, int slot) {
  return ((parts[0 * H * BW + slot] + parts[1 * H * BW + slot]) +
          parts[2 * H * BW + slot]) + parts[3 * H * BW + slot];
}

// [rows,B] tile of step data -> shared [rows][BW], zero past the batch edge
__device__ __forceinline__ void load_rows_shared(float* s, const float* p, int rows,
                                                 int B, int b0, int tid, int nt) {
  for (int i = tid; i < rows * BW; i += nt) {
    const int r = i / BW, w = i % BW;
    s[i] = (b0 + w < B) ? p[(size_t)r * B + b0 + w] : 0.0f;
  }
}

struct LstmW {           // one 2-layer stack
  const float* w0i_t;    // [in,4H]
  const float* w0h_t;    // [H,4H]
  const float* b0;       // [4H]
  const float* w1i_t;    // [H,4H]
  const float* w1h_t;    // [H,4H]
  const float* b1;       // [4H]
  const float* w0h;      // [4H,H]   (backward only)
  const float* w1i;      // [4H,H]   (backward only)
  const float* w1h;      // [4H,H]   (backward only)
};

// Every recurrent kernel runs 4H threads on a tile of BW = 4 windows. A
// thread plays two roles by turns: gate row r = tid of the matrix products,
// and cell slot (unit = tid / BW, window = tid % BW) of the elementwise
// update, whose c and gradient carries stay in its registers.
static_assert(BW == 4, "4H threads = H units x 4 windows");

// ------------------------------------------------------------------ encoder

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_enc_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ dm,
                     const LstmW W, float* __restrict__ stash,
                     float* __restrict__ hlast, float* __restrict__ fin, int T,
                     int D, int B) {
  __shared__ __align__(16) float h0s[H * BW], h0d[H * BW], h1s[H * BW];
  __shared__ __align__(16) float xsh[DMAX * BW];
  __shared__ __align__(16) float gs[4 * H * BW];
  const int tid = threadIdx.x;
  const int unit = tid / BW, b0 = blockIdx.x * BW, b = b0 + tid % BW;
  const bool live = b < B;
  float h0 = 0.0f, c0 = 0.0f, h1 = 0.0f, c1 = 0.0f;
  h0s[tid] = 0.0f;
  h1s[tid] = 0.0f;

  for (int t = 0; t < T; ++t) {
    load_rows_shared(xsh, xs + (size_t)t * D * B, D, B, b0, tid, 4 * H);
    if (stash != nullptr && live) {
      float* st = stash + (size_t)t * 4 * H * B + b;
      st[(size_t)(0 * H + unit) * B] = h0;
      st[(size_t)(1 * H + unit) * B] = c0;
      st[(size_t)(2 * H + unit) * B] = h1;
      st[(size_t)(3 * H + unit) * B] = c1;
    }
    const float m = (dm != nullptr && live)
                        ? dm[((size_t)t * H + unit) * B + b] : 1.0f;
    __syncthreads();                       // x_t, h0s, h1s visible
    float g[BW];
    gate_preact<H>(g, W.b0, W.w0i_t, D, xsh, W.w0h_t, h0s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h0s done
    h0 = cell_fwd<H>(gs, tid, c0);
    h0s[tid] = h0;
    h0d[tid] = h0 * m;
    __syncthreads();                       // h0 visible, reads of gs done
    gate_preact<H>(g, W.b1, W.w1i_t, H, h0d, W.w1h_t, h1s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h1s done
    h1 = cell_fwd<H>(gs, tid, c1);
    h1s[tid] = h1;
  }
  if (live) {
    hlast[(size_t)unit * B + b] = h1;
    fin[(size_t)(0 * H + unit) * B + b] = h0;
    fin[(size_t)(1 * H + unit) * B + b] = c0;
    fin[(size_t)(2 * H + unit) * B + b] = h1;
    fin[(size_t)(3 * H + unit) * B + b] = c1;
  }
}

// The shared buffers and per-slot carries of a reverse scan.
template <int H>
struct BwdShared {
  float h0ps[H * BW], h1ps[H * BW], h0ds[H * BW];
  float io[DMAX * BW];                 // x_t (encoder) or d(recon_t) (decoder)
  float gs0[4 * H * BW], gs1[4 * H * BW];
  float dgs[4 * H * BW];
  float parts[2 * 4 * H * BW];
};

// Steps 3-5 of one reverse step, common to both stacks: from the recomputed
// gates in S.gs0/S.gs1 and the carries, the gate gradients dg1, dg0 (to
// shared and to global) and the new dh0, dh1, dc0, dc1.
template <int H>
__device__ __forceinline__ void bwd_cells(BwdShared<H>& S, const LstmW& W, int tid,
                                          float m, float c0a, float c0p, float c1a,
                                          float c1p, float& dh0, float& dc0,
                                          float& dh1, float& dc1,
                                          float* __restrict__ dg0o,
                                          float* __restrict__ dg1o, int B, int b,
                                          bool live) {
  const int unit = tid / BW, j = tid % H, rg = tid / H;
  cell_bwd<H>(S.gs1, tid, dh1, dc1, c1a, c1p, S.dgs, dg1o, B, unit, b, live);
  __syncthreads();                         // dg1 visible
  wt_partial<H>(W.w1i, W.w1h, S.dgs, j, rg, S.parts);
  __syncthreads();                         // partials visible, reads of dgs done
  dh0 = dh0 + partial_sum<H>(S.parts, tid) * m;
  dh1 = partial_sum<H>(S.parts + 4 * H * BW, tid);
  cell_bwd<H>(S.gs0, tid, dh0, dc0, c0a, c0p, S.dgs, dg0o, B, unit, b, live);
  __syncthreads();                         // dg0 visible, reads of parts done
  wt_partial<H>(W.w0h, nullptr, S.dgs, j, rg, S.parts);
  __syncthreads();                         // partials visible
  dh0 = partial_sum<H>(S.parts, tid);
}

// Reverse scan of the encoder: the dh/dc chain only. Writes the gate
// gradients dg0, dg1 [T,4H,B] for the parallel pass.
template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_enc_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ dm,
                     const LstmW W, const float* __restrict__ stash,
                     const float* __restrict__ fin,
                     const float* __restrict__ dhl, float* __restrict__ dg0o,
                     float* __restrict__ dg1o, int T, int D, int B) {
  __shared__ __align__(16) BwdShared<H> S;
  const int tid = threadIdx.x;
  const int unit = tid / BW, b0 = blockIdx.x * BW, b = b0 + tid % BW;
  const bool live = b < B;
  const size_t at = (size_t)unit * B + b;          // [unit][b] of a [H,B] block
  float h0a = live ? fin[at] : 0.0f;
  float c0a = live ? fin[(size_t)H * B + at] : 0.0f;
  float c1a = live ? fin[(size_t)3 * H * B + at] : 0.0f;
  float dh1 = live ? dhl[at] : 0.0f;
  float dh0 = 0.0f, dc0 = 0.0f, dc1 = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const float* st = stash + (size_t)t * 4 * H * B;
    const float h0p = live ? st[at] : 0.0f;
    const float c0p = live ? st[(size_t)H * B + at] : 0.0f;
    const float h1p = live ? st[(size_t)2 * H * B + at] : 0.0f;
    const float c1p = live ? st[(size_t)3 * H * B + at] : 0.0f;
    const float m = (dm != nullptr && live) ? dm[(size_t)t * H * B + at] : 1.0f;
    S.h0ps[tid] = h0p;
    S.h1ps[tid] = h1p;
    S.h0ds[tid] = h0a * m;
    load_rows_shared(S.io, xs + (size_t)t * D * B, D, B, b0, tid, 4 * H);
    __syncthreads();
    float g[BW];
    gate_preact<H>(g, W.b0, W.w0i_t, D, S.io, W.w0h_t, S.h0ps, tid);
    store4(S.gs0, g, tid);
    gate_preact<H>(g, W.b1, W.w1i_t, H, S.h0ds, W.w1h_t, S.h1ps, tid);
    store4(S.gs1, g, tid);
    __syncthreads();                       // recomputed gates visible
    bwd_cells<H>(S, W, tid, m, c0a, c0p, c1a, c1p, dh0, dc0, dh1, dc1,
                 dg0o + (size_t)t * 4 * H * B, dg1o + (size_t)t * 4 * H * B, B, b,
                 live);
    h0a = h0p;
    c0a = c0p;
    c1a = c1p;
  }
}

// ------------------------------------------------------------------ decoder

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_dec_fwd_kernel(const float* __restrict__ din, const float* __restrict__ dm,
                     const LstmW W, const float* __restrict__ ow,
                     const float* __restrict__ ob, float* __restrict__ recon,
                     float* __restrict__ stash, float* __restrict__ fin, int T,
                     int D, int K, int B) {
  __shared__ __align__(16) float h0s[H * BW], h0d[H * BW], h1s[H * BW];
  __shared__ __align__(16) float gs[4 * H * BW];   // first holds dec_in
  __shared__ float ows[H * DMAX];                  // head weights, [k][d]
  const int tid = threadIdx.x;
  const int unit = tid / BW, b0 = blockIdx.x * BW, b = b0 + tid % BW;
  const bool live = b < B;
  float h0 = 0.0f, c0 = 0.0f, h1 = 0.0f, c1 = 0.0f;
  h0s[tid] = 0.0f;
  h1s[tid] = 0.0f;
  for (int i = tid; i < D * H; i += 4 * H) ows[(i % H) * D + i / H] = ow[i];
  load_rows_shared(gs, din, K, B, b0, tid, 4 * H);
  __syncthreads();
  float xp[BW];                            // layer-0 input projection, once
  gate_preact<H>(xp, W.b0, W.w0i_t, K, gs, nullptr, nullptr, tid);
  __syncthreads();                         // reads of dec_in done

  for (int t = 0; t < T; ++t) {
    if (stash != nullptr && live) {
      float* st = stash + (size_t)t * 4 * H * B + b;
      st[(size_t)(0 * H + unit) * B] = h0;
      st[(size_t)(1 * H + unit) * B] = c0;
      st[(size_t)(2 * H + unit) * B] = h1;
      st[(size_t)(3 * H + unit) * B] = c1;
    }
    const float m = (dm != nullptr && live)
                        ? dm[((size_t)t * H + unit) * B + b] : 1.0f;
    float g[BW];
    gate_preact_const<H>(g, xp, W.w0h_t, h0s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h0s done
    h0 = cell_fwd<H>(gs, tid, c0);
    h0s[tid] = h0;
    h0d[tid] = h0 * m;
    __syncthreads();                       // h0 visible, reads of gs done
    gate_preact<H>(g, W.b1, W.w1i_t, H, h0d, W.w1h_t, h1s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h1s done
    h1 = cell_fwd<H>(gs, tid, c1);
    h1s[tid] = h1;
    __syncthreads();                       // h1 visible, reads of gs done
    // output head of step t, from shared memory only (the weight stream of
    // the other warps' next step would make every global read of it miss);
    // h1s is next written three barriers from here
    for (int i = tid; i < D * BW; i += 4 * H) {
      const int w = i / D, d = i % D;
      if (b0 + w < B) {
        float y = __ldg(ob + d);
#pragma unroll 8
        for (int k = 0; k < H; ++k)
          y = fmaf(ows[k * D + d], h1s[k * BW + w], y);
        recon[((size_t)t * D + d) * B + b0 + w] = y;
      }
    }
  }
  if (live) {
    fin[(size_t)(0 * H + unit) * B + b] = h0;
    fin[(size_t)(1 * H + unit) * B + b] = c0;
    fin[(size_t)(2 * H + unit) * B + b] = h1;
    fin[(size_t)(3 * H + unit) * B + b] = c1;
  }
}

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_dec_bwd_kernel(const float* __restrict__ din, const float* __restrict__ dm,
                     const LstmW W, const float* __restrict__ ow,
                     const float* __restrict__ stash,
                     const float* __restrict__ fin,
                     const float* __restrict__ dr, float* __restrict__ dg0o,
                     float* __restrict__ dg1o, int T, int D, int K, int B) {
  __shared__ __align__(16) BwdShared<H> S;
  const int tid = threadIdx.x;
  const int unit = tid / BW, b0 = blockIdx.x * BW, b = b0 + tid % BW;
  const bool live = b < B;
  const size_t at = (size_t)unit * B + b;
  float xp[BW];
  load_rows_shared(S.parts, din, K, B, b0, tid, 4 * H);   // K*BW <= 8H*BW
  __syncthreads();
  gate_preact<H>(xp, W.b0, W.w0i_t, K, S.parts, nullptr, nullptr, tid);

  float h0a = live ? fin[at] : 0.0f;
  float c0a = live ? fin[(size_t)H * B + at] : 0.0f;
  float c1a = live ? fin[(size_t)3 * H * B + at] : 0.0f;
  float dh0 = 0.0f, dc0 = 0.0f, dh1 = 0.0f, dc1 = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    const float* st = stash + (size_t)t * 4 * H * B;
    const float h0p = live ? st[at] : 0.0f;
    const float c0p = live ? st[(size_t)H * B + at] : 0.0f;
    const float h1p = live ? st[(size_t)2 * H * B + at] : 0.0f;
    const float c1p = live ? st[(size_t)3 * H * B + at] : 0.0f;
    const float m = (dm != nullptr && live) ? dm[(size_t)t * H * B + at] : 1.0f;
    S.h0ps[tid] = h0p;
    S.h1ps[tid] = h1p;
    S.h0ds[tid] = h0a * m;
    load_rows_shared(S.io, dr + (size_t)t * D * B, D, B, b0, tid, 4 * H);
    __syncthreads();                       // also: reads of dec_in in parts done
    float g[BW];
    gate_preact_const<H>(g, xp, W.w0h_t, S.h0ps, tid);
    store4(S.gs0, g, tid);
    gate_preact<H>(g, W.b1, W.w1i_t, H, S.h0ds, W.w1h_t, S.h1ps, tid);
    store4(S.gs1, g, tid);
    // output head backward: dh1 += ow^T d(recon_t)
    for (int d = 0; d < D; ++d)
      dh1 = fmaf(__ldg(ow + (size_t)d * H + unit), S.io[d * BW + tid % BW], dh1);
    __syncthreads();                       // recomputed gates visible
    bwd_cells<H>(S, W, tid, m, c0a, c0p, c1a, c1p, dh0, dc0, dh1, dc1,
                 dg0o + (size_t)t * 4 * H * B, dg1o + (size_t)t * 4 * H * B, B, b,
                 live);
    h0a = h0p;
    c0a = c0p;
    c1a = c1p;
  }
}

// ------------------------------------------- the parallel gradient pass

// A [T,rows,B] stream of per-step matrices as the contraction reads it:
//   value(t,row,b) = src(t)[row*B + b] * (mask ? mask[t*mask_stride + row*B + b] : 1)
//   src(t) = p + t*stride                         when last == nullptr
//          = p + (t+1)*stride, or last at t = T-1 when last != nullptr
// The shifted form reads "the state AFTER step t" out of a stash of
// pre-step states: it is the next step's entry, or the final state.
struct Stream {
  const float* p;
  long long stride;
  const float* last;
  const float* mask;
  long long mask_stride;
  int rows;
};

__device__ __forceinline__ float stream_at(const Stream& s, int t, int T, int row,
                                           int b, int B) {
  const float* src = s.last == nullptr
                         ? s.p + (size_t)t * s.stride
                         : (t == T - 1 ? s.last : s.p + (size_t)(t + 1) * s.stride);
  float v = src[(size_t)row * B + b];
  if (s.mask != nullptr) v *= s.mask[(size_t)t * s.mask_stride + (size_t)row * B + b];
  return v;
}

constexpr int TILE = 64;     // output tile (rows of a x rows of c)
constexpr int KC = 32;       // batch entries per shared-memory chunk

// partial[s][r][c] = sum over t in split s, all b, of a(t,r,b) * c(t,c,b)
__global__ void __launch_bounds__(256)
contract_partial_kernel(const Stream a, const Stream c, int T, int B, int tper,
                        float* __restrict__ partial) {
  __shared__ float As[TILE][KC + 1], Cs[TILE][KC + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const int t_lo = blockIdx.z * tper;
  const int t_hi = min(T, t_lo + tper);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    for (int bb = 0; bb < B; bb += KC) {
      for (int i = threadIdx.x; i < TILE * KC; i += 256) {
        const int row = i / KC, kk = i % KC;
        const int b = bb + kk;
        As[row][kk] = (r0 + row < a.rows && b < B) ? stream_at(a, t, T, r0 + row, b, B) : 0.0f;
        Cs[row][kk] = (c0 + row < c.rows && b < B) ? stream_at(c, t, T, c0 + row, b, B) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float av[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = As[ty * 4 + i][kk];
          cv[i] = Cs[tx * 4 + i][kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], cv[k], acc[i][k]);
      }
      __syncthreads();
    }
  }
  float* out = partial + (size_t)blockIdx.z * a.rows * c.rows;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + ty * 4 + i, cc = c0 + tx * 4 + k;
      if (r < a.rows && cc < c.rows) out[(size_t)r * c.rows + cc] = acc[i][k];
    }
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order
__global__ void reduce_partial_kernel(const float* __restrict__ partial, int S,
                                      int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < S; ++k) s += partial[(size_t)k * n + i];
  out[i] = s;
}

// One block per row r of dg [T,R,B]: sumT[r][b] = sum_t dg[t][r][b] (written
// when sumT != nullptr) and rowsum[r] = sum_b sumT[r][b], by a fixed tree.
__global__ void __launch_bounds__(256)
sum_t_rowsum_kernel(const float* __restrict__ dg, int T, int R, int B,
                    float* __restrict__ sumT, float* __restrict__ rowsum) {
  __shared__ float red[256];
  const int r = blockIdx.x;
  float local = 0.0f;
  for (int b = threadIdx.x; b < B; b += 256) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += dg[((size_t)t * R + r) * B + b];
    if (sumT != nullptr) sumT[(size_t)r * B + b] = s;
    local += s;
  }
  red[threadIdx.x] = local;
  __syncthreads();
  for (int k = 128; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) rowsum[r] = red[0];
}

// out[t][c][b] = sum_r W[r][c] * dg[t][r][b]   (W row-major [R,C])
__global__ void wt_dg_kernel(const float* __restrict__ W,
                             const float* __restrict__ dg, int T, int R, int C,
                             int B, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)T * C * B) return;
  const int b = i % B;
  const int c = (i / B) % C;
  const int t = i / ((size_t)B * C);
  const float* g = dg + (size_t)t * R * B + b;
  float s = 0.0f;
  for (int r = 0; r < R; ++r)
    s = fmaf(__ldg(W + (size_t)r * C + c), g[(size_t)r * B], s);
  out[i] = s;
}

Stream plain_stream(const float* p, long long stride, int rows) {
  return Stream{p, stride, nullptr, nullptr, 0, rows};
}

// out [a.rows, c.rows] = sum_{t,b} a * c, through `partial` ([S, rows, rows])
cudaError_t contract(const Stream& a, const Stream& c, int T, int B, int S,
                     float* partial, float* out, cudaStream_t stream) {
  const int tper = (T + S - 1) / S;
  const dim3 grid((c.rows + TILE - 1) / TILE, (a.rows + TILE - 1) / TILE, S);
  contract_partial_kernel<<<grid, 256, 0, stream>>>(a, c, T, B, tper, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.rows * c.rows;
  reduce_partial_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, S, n, out);
  return cudaGetLastError();
}

cudaError_t sum_t_rowsum(const float* dg, int T, int R, int B, float* sumT,
                         float* rowsum, cudaStream_t stream) {
  sum_t_rowsum_kernel<<<R, 256, 0, stream>>>(dg, T, R, B, sumT, rowsum);
  return cudaGetLastError();
}

cudaError_t wt_dg(const float* W, const float* dg, int T, int R, int C, int B,
                  float* out, cudaStream_t stream) {
  const size_t n = (size_t)T * C * B;
  wt_dg_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(W, dg, T, R, C, B, out);
  return cudaGetLastError();
}

#define SHM_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

LstmW stack_weights(const float* const* w, bool backward) {
  LstmW W;
  W.w0i_t = w[0]; W.w0h_t = w[1]; W.b0 = w[2];
  W.w1i_t = w[3]; W.w1h_t = w[4]; W.b1 = w[5];
  W.w0h = backward ? w[7] : nullptr;
  W.w1i = backward ? w[8] : nullptr;
  W.w1h = backward ? w[9] : nullptr;
  return W;
}

template <int H>
cudaError_t enc_fwd(const float* xs, const float* dm, const float* const* w,
                    float* stash, float* hlast, float* fin, int T, int D, int B,
                    cudaStream_t s) {
  lstm2_enc_fwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      xs, dm, stack_weights(w, false), stash, hlast, fin, T, D, B);
  return cudaGetLastError();
}

// w: w0i_t w0h_t b0 w1i_t w1h_t b1 w0i w0h w1i w1h
// scratch: dg0 dg1 partial;  out: dx gw0i gw0h gb0 gw1i gw1h gb1
template <int H>
cudaError_t enc_bwd(const float* xs, const float* dm, const float* const* w,
                    const float* stash, const float* fin, const float* dhl,
                    float* const* scratch, float* const* out, int T, int D,
                    int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2];
  lstm2_enc_bwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      xs, dm, stack_weights(w, true), stash, fin, dhl, dg0, dg1, T, D, B);
  SHM_TRY(cudaGetLastError());
  const long long st = 4LL * H * B;
  const Stream g0 = plain_stream(dg0, st, 4 * H), g1 = plain_stream(dg1, st, 4 * H);
  const Stream h0d{stash, st, fin, dm, (long long)H * B, H};
  SHM_TRY(contract(g0, plain_stream(xs, (long long)D * B, D), T, B, S, partial, out[1], s));
  SHM_TRY(contract(g0, plain_stream(stash, st, H), T, B, S, partial, out[2], s));
  SHM_TRY(sum_t_rowsum(dg0, T, 4 * H, B, nullptr, out[3], s));
  SHM_TRY(contract(g1, h0d, T, B, S, partial, out[4], s));
  SHM_TRY(contract(g1, plain_stream(stash + 2LL * H * B, st, H), T, B, S, partial, out[5], s));
  SHM_TRY(sum_t_rowsum(dg1, T, 4 * H, B, nullptr, out[6], s));
  if (out[0] != nullptr) SHM_TRY(wt_dg(w[6], dg0, T, 4 * H, D, B, out[0], s));
  return cudaSuccess;
}

template <int H>
cudaError_t dec_fwd(const float* din, const float* dm, const float* const* w,
                    float* recon, float* stash, float* fin, int T, int D, int K,
                    int B, cudaStream_t s) {
  lstm2_dec_fwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      din, dm, stack_weights(w, false), w[10], w[11], recon, stash, fin, T, D, K, B);
  return cudaGetLastError();
}

// w: w0i_t w0h_t b0 w1i_t w1h_t b1 w0i w0h w1i w1h ow ob
// scratch: dg0 dg1 partial sum_t(dg0);  out: ddin gw0i gw0h gb0 gw1i gw1h gb1 gow gob
template <int H>
cudaError_t dec_bwd(const float* din, const float* dm, const float* const* w,
                    const float* stash, const float* fin, const float* dr,
                    float* const* scratch, float* const* out, int T, int D,
                    int K, int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2],
        *adg0 = scratch[3];
  lstm2_dec_bwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      din, dm, stack_weights(w, true), w[10], stash, fin, dr, dg0, dg1, T, D, K, B);
  SHM_TRY(cudaGetLastError());
  const long long st = 4LL * H * B;
  const Stream g0 = plain_stream(dg0, st, 4 * H), g1 = plain_stream(dg1, st, 4 * H);
  const Stream h0d{stash, st, fin, dm, (long long)H * B, H};
  const Stream h1a{stash + 2LL * H * B, st, fin + 2LL * H * B, nullptr, 0, H};
  // layer 0's input is constant over T: sum dg0 over T first, then fold once
  SHM_TRY(sum_t_rowsum(dg0, T, 4 * H, B, adg0, out[3], s));
  SHM_TRY(contract(plain_stream(adg0, 0, 4 * H), plain_stream(din, 0, K), 1, B, 1, partial, out[1], s));
  SHM_TRY(wt_dg(w[6], adg0, 1, 4 * H, K, B, out[0], s));
  SHM_TRY(contract(g0, plain_stream(stash, st, H), T, B, S, partial, out[2], s));
  SHM_TRY(contract(g1, h0d, T, B, S, partial, out[4], s));
  SHM_TRY(contract(g1, plain_stream(stash + 2LL * H * B, st, H), T, B, S, partial, out[5], s));
  SHM_TRY(sum_t_rowsum(dg1, T, 4 * H, B, nullptr, out[6], s));
  SHM_TRY(contract(plain_stream(dr, (long long)D * B, D), h1a, T, B, S, partial, out[7], s));
  SHM_TRY(sum_t_rowsum(dr, T, D, B, nullptr, out[8], s));
  return cudaSuccess;
}

bool bad_dims(int T, int D, int H, int B, int S) {
  return T <= 0 || D <= 0 || D > DMAX || B <= 0 || S <= 0 || S > T ||
         (H != 32 && H != 64 && H != 128);
}

}  // namespace

// C entries for ctypes. Every pointer is a device pointer to contiguous
// float32; `w`, `scratch` and `out` are host arrays of device pointers in the
// orders given above each launcher (a forward takes the same `w` array as its
// backward and reads the first six entries, the decoder also ow and ob).
// `dm` may be null (unit mask), `stash`
// null in the forwards (nothing kept for a backward) and out[0] null in the
// encoder backward (no dx wanted). Each returns the first cudaGetLastError()
// that is not 0, else 0. S is the number of splits over T of the contraction
// (partial holds S * 4H * max(H, K, D) floats).

extern "C" int shm_lstm2_enc_fwd_f32(const float* xs, const float* dm,
                                     const void* const* w, float* stash,
                                     float* hlast, float* fin, int T, int D,
                                     int H, int B, void* stream) {
  if (bad_dims(T, D, H, B, 1)) return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = enc_fwd<32>(xs, dm, wp, stash, hlast, fin, T, D, B, s); break;
    case 64: err = enc_fwd<64>(xs, dm, wp, stash, hlast, fin, T, D, B, s); break;
    default: err = enc_fwd<128>(xs, dm, wp, stash, hlast, fin, T, D, B, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_enc_bwd_f32(const float* xs, const float* dm,
                                     const void* const* w, const float* stash,
                                     const float* fin, const float* dhl,
                                     void* const* scratch, void* const* out,
                                     int T, int D, int H, int B, int S,
                                     void* stream) {
  if (bad_dims(T, D, H, B, S)) return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  float* const* sp = reinterpret_cast<float* const*>(scratch);
  float* const* op = reinterpret_cast<float* const*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = enc_bwd<32>(xs, dm, wp, stash, fin, dhl, sp, op, T, D, B, S, s); break;
    case 64: err = enc_bwd<64>(xs, dm, wp, stash, fin, dhl, sp, op, T, D, B, S, s); break;
    default: err = enc_bwd<128>(xs, dm, wp, stash, fin, dhl, sp, op, T, D, B, S, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_dec_fwd_f32(const float* din, const float* dm,
                                     const void* const* w, float* recon,
                                     float* stash, float* fin, int T, int D,
                                     int H, int K, int B, void* stream) {
  if (bad_dims(T, D, H, B, 1) || K <= 0 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = dec_fwd<32>(din, dm, wp, recon, stash, fin, T, D, K, B, s); break;
    case 64: err = dec_fwd<64>(din, dm, wp, recon, stash, fin, T, D, K, B, s); break;
    default: err = dec_fwd<128>(din, dm, wp, recon, stash, fin, T, D, K, B, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_dec_bwd_f32(const float* din, const float* dm,
                                     const void* const* w, const float* stash,
                                     const float* fin, const float* dr,
                                     void* const* scratch, void* const* out,
                                     int T, int D, int H, int K, int B, int S,
                                     void* stream) {
  if (bad_dims(T, D, H, B, S) || K <= 0 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  float* const* sp = reinterpret_cast<float* const*>(scratch);
  float* const* op = reinterpret_cast<float* const*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = dec_bwd<32>(din, dm, wp, stash, fin, dr, sp, op, T, D, K, B, S, s); break;
    case 64: err = dec_bwd<64>(din, dm, wp, stash, fin, dr, sp, op, T, D, K, B, S, s); break;
    default: err = dec_bwd<128>(din, dm, wp, stash, fin, dr, sp, op, T, D, K, B, S, s); break;
  }
  return (int)err;
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
