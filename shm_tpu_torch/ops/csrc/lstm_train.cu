// Two-layer LSTM training scans for Hopper (sm_90a), float32: forward and
// hand-written backward of the VAE's encoder and decoder stacks.
//
// Replaces the four Pallas TPU kernels of shm_tpu/ops/lstm_train.py:
//   _enc_fwd_kernel (:153, pallas_call :299)  -> lstm2_enc_fwd_kernel
//   _enc_bwd_kernel (:191, pallas_call :331)  -> lstm2_bwd_scan_kernel<H, false>
//                                                + the parallel gradient pass
//   _dec_fwd_kernel (:359, pallas_call :507)  -> lstm2_dec_fwd_kernel
//   _dec_bwd_kernel (:399, pallas_call :543)  -> lstm2_bwd_scan_kernel<H, true>
//                                                + the parallel gradient pass
// Same functions, same public layouts (batch last): xs [T,D,B], dropout mask
// dm [T,H,B] (inverted, constant; multiplies layer 0's output before layer 1),
// weights [4H,in] with gates i|f|g|o, biases [4H], stash of the PRE-step
// state (h0,c0,h1,c1) [T,4H,B], final state [4H,B].
//   encoder: xs -> h_last [H,B] (the top layer's last hidden state only);
//   decoder: dec_in [K,B], constant over T (its layer-0 projection is
//            computed once) -> recon [T,D,B] with the output head folded in.
// For a backward the forward also keeps the gate stash [T,2,4H,B]: the
// activations (i, f, g, o) of layer 0 and layer 1 at every step, the values
// it computed them as. The backward reads them and recomputes nothing of the
// forward but tanh(c), so its gradient is that of exactly this forward. (The
// TPU kernels recompute the gates, because a TPU's small VMEM made their
// stash pipeline-bound; on this card the gate stash is 105 MB a stack at the
// 4DOF shape, ~31 us of device memory each way, against 10.4 GFLOP of
// recompute.)
//
// Bound on this card. At the 4DOF training shape (T=100, D=12, H=128, B=256)
// the encoder forward is 8H(D+3H)*T*B = 10.4 GFLOP, 0.16 ms at the 67 TFLOP/s
// float32 rate, and moves ~170 MB (x, mask, stash, gate stash), 0.05 ms at
// 3.35 TB/s: it is bound by operations, and beyond that by latency, because
// the scan is a chain of 2*T dependent layer steps and a batch of 256 offers
// little to run beside it. The backward does the transposed products for dh
// and the weight-gradient products.
//
// Design of the forwards (first version: right before fast).
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
//     in registers and the gates passed through shared memory. (A first
//     version with H threads, each owning the four gates of a unit, took
//     3.0-3.4x as long as the 4H-thread one; leaving the batching to
//     `#pragma unroll 8` took 1.5x as long as this; PERF.md keeps the times.)
//   * The wrapper passes each matrix transposed, [in,4H], so that the read
//     is coalesced; the backward takes W0h, W1i, W1h as given, [4H,H].
// Design of the backwards: a reverse scan on 8-block clusters with its three
// [4H,H] matrices resident in shared memory (below), then a parallel pass.
//   * Weight gradients do not fit a block (one [4H,H] f32 accumulator is
//     256 KiB), and blocks run in no order. So the reverse scan carries only
//     the dh/dc chain and writes the gate gradients dg0, dg1 [T,4H,B]; a
//     second, parallel pass contracts them over T*B against x / h0 / h0*dm /
//     h1 (all in the stash) with a tiled product, split over T into partial
//     sums that a last kernel adds in a fixed order. Bias gradients, the
//     decoder's layer-0 fold (dg0 summed over T first), the head gradient, dx
//     and d(dec_in) are the same kind of pass. There are no float atomics
//     anywhere: the same inputs give the same bits every run.
//   * A ragged last tile (B not a multiple of 4, or of 20 in the reverse
//     scan) is masked in the kernels.
// Against the bound: float32 FMA pipes, no tensor cores; the bf16/wgmma path
// and the forwards on the cluster design are later work.
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
// pre-activations in shared gs[4H][BW]. With gq != nullptr the four
// activations i, f, g, o go to the gate stash: gq[q * H * B] for gate q.
template <int H>
__device__ __forceinline__ float cell_fwd(const float* gs, int slot, float& c,
                                          float* __restrict__ gq, int B) {
  const float i = sigmoid_f(gs[0 * H * BW + slot]);
  const float f = sigmoid_f(gs[1 * H * BW + slot]);
  const float gg = tanhf(gs[2 * H * BW + slot]);
  const float o = sigmoid_f(gs[3 * H * BW + slot]);
  if (gq != nullptr) {
    gq[0] = i;
    gq[(size_t)H * B] = f;
    gq[(size_t)2 * H * B] = gg;
    gq[(size_t)3 * H * B] = o;
  }
  c = f * c + i * gg;
  return o * tanhf(c);
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

// Each forward kernel runs 4H threads on a tile of BW = 4 windows. A
// thread plays two roles by turns: gate row r = tid of the matrix products,
// and cell slot (unit = tid / BW, window = tid % BW) of the elementwise
// update, whose c stays in its registers.
static_assert(BW == 4, "4H threads = H units x 4 windows");

// ------------------------------------------------------------------ encoder

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_enc_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ dm,
                     const LstmW W, float* __restrict__ stash,
                     float* __restrict__ gates, float* __restrict__ hlast,
                     float* __restrict__ fin, int T, int D, int B) {
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
    float* gq = (stash != nullptr && live)
                    ? gates + ((size_t)2 * t * 4 * H + unit) * B + b : nullptr;
    __syncthreads();                       // x_t, h0s, h1s visible
    float g[BW];
    gate_preact<H>(g, W.b0, W.w0i_t, D, xsh, W.w0h_t, h0s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h0s done
    h0 = cell_fwd<H>(gs, tid, c0, gq, B);
    h0s[tid] = h0;
    h0d[tid] = h0 * m;
    __syncthreads();                       // h0 visible, reads of gs done
    gate_preact<H>(g, W.b1, W.w1i_t, H, h0d, W.w1h_t, h1s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h1s done
    h1 = cell_fwd<H>(gs, tid, c1, gq == nullptr ? nullptr : gq + (size_t)4 * H * B, B);
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

// ------------------------------------------------------------------ decoder

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm2_dec_fwd_kernel(const float* __restrict__ din, const float* __restrict__ dm,
                     const LstmW W, const float* __restrict__ ow,
                     const float* __restrict__ ob, float* __restrict__ recon,
                     float* __restrict__ stash, float* __restrict__ gates,
                     float* __restrict__ fin, int T, int D, int K, int B) {
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
    float* gq = (stash != nullptr && live)
                    ? gates + ((size_t)2 * t * 4 * H + unit) * B + b : nullptr;
    float g[BW];
    gate_preact_const<H>(g, xp, W.w0h_t, h0s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h0s done
    h0 = cell_fwd<H>(gs, tid, c0, gq, B);
    h0s[tid] = h0;
    h0d[tid] = h0 * m;
    __syncthreads();                       // h0 visible, reads of gs done
    gate_preact<H>(g, W.b1, W.w1i_t, H, h0d, W.w1h_t, h1s, tid);
    store4(gs, g, tid);
    __syncthreads();                       // gates visible, reads of h1s done
    h1 = cell_fwd<H>(gs, tid, c1, gq == nullptr ? nullptr : gq + (size_t)4 * H * B, B);
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

// ------------------------------------- the reverse scan, on a block cluster
//
// Both stacks' backward recurrence (the dh/dc chain) in one body. A cluster
// of CL = 8 blocks takes NW = 20 windows; block k of it owns the units
// j in [k*H/8, (k+1)*H/8) of those windows, one thread per (unit, window)
// slot with c and the dh/dc carries in registers. At its start a block loads
// its column slices W1i[:,j], W1h[:,j], W0h[:,j] ([4H, H/8] each, 96 KiB at
// H=128) into shared memory, and no weight is read from device memory after
// that. Why 20 windows: at H=128 a block takes 223 KiB of shared memory, so
// an SM holds one, and an H100 80GB HBM3 places 15 such clusters at once
// (cudaOccupancyMaxActiveClusters), not 16. With 16 windows B=256 needed 16
// clusters, two waves (rows 3 and 5 took 1.2x as long); with 20 it needs 13,
// one wave. One reverse step:
//   1. layer-1 cell backward of the block's slots from the stashed gate
//      activations: its 4*H/8 rows of dg1;
//   2. those rows into the gather buffer of every block of the cluster
//      (distributed shared memory), then a cluster barrier;
//   3. dh0 += m * W1i[:,j]^T dg1 and the carry dh1 = W1h[:,j]^T dg1, over
//      all 4H gathered rows;
//   4. layer-0 cell backward: the block's rows of dg0, gathered the same
//      way into a second buffer, then a cluster barrier;
//   5. the carry dh0 = W0h[:,j]^T dg0.
// dg0 and dg1 also go to device memory [T,4H,B] for the gradient pass. The
// two gather buffers (one for dg1, one for dg0) make two cluster barriers a
// step enough: a block writes a peer's dg1 buffer only after the barrier
// that follows every block's reads of it in the step before, and the same
// holds for dg0. The transposed products are tiled 4 units x 4 windows a
// thread over RG = 16 groups of rows (each shared-memory float4 feeds 16 or
// 32 FMAs), summed over a group's rows in order and then over the groups in
// order: no atomics, the same bits every run. A cluster's windows past the
// batch edge compute on zeros and write nothing; a batch of more clusters
// than fit on the card runs in waves.

constexpr int CL = 8;        // blocks a cluster
constexpr int NW = 20;       // windows a cluster
constexpr int RG = 16;       // row groups of the transposed products

template <int H>
struct Rev {
  static constexpr int UB = H / CL;          // units a block
  static constexpr int G = 4 * H;            // gate rows
  static constexpr int NT = UB * NW;         // threads: one (unit, window) slot each
  static constexpr int TILES = NT / 16;      // 4 x 4 (unit, window) output tiles
  static constexpr int PF = (DMAX * NW + NT - 1) / NT;  // d(recon) prefetch a thread
  // dynamic shared memory, in floats
  static constexpr int WS = 0;                     // W1i | W1h | W0h slices [3][G][UB]
  static constexpr int GA = WS + 3 * G * UB;       // gathered dg1 [G][NW]
  static constexpr int GB = GA + G * NW;           // gathered dg0 [G][NW]
  static constexpr int PART = GB + G * NW;         // partial sums [2][RG][NT]
  static constexpr int OW = PART + 2 * RG * NT;    // head slice [DMAX][UB] (decoder)
  static constexpr int DR = OW + DMAX * UB;        // d(recon_t) tiles [2][DMAX][NW]
  static constexpr size_t BYTES = (size_t)(DR + 2 * DMAX * NW) * sizeof(float);
  static_assert(UB % 4 == 0 && NW % 4 == 0 && G % RG == 0, "4x4 tiles");
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders shared-memory writes
// before it (this block's and remote ones) before the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;"
               ::: "memory");
}

// the address of *p in the shared memory of cluster block `rank`
__device__ __forceinline__ float* peer_addr(float* p, unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out) : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<float*>(out);
}

// What a slot reads of step t: both layers' gate activations (i, f, g, o),
// the cells' pre-step states and the mask; zeros past the batch edge.
struct StepIn {
  float g0[4], g1[4], c0p, c1p, m;
};

template <int H>
__device__ __forceinline__ StepIn load_step(const float* __restrict__ stash,
                                            const float* __restrict__ gates,
                                            const float* __restrict__ dm, int t,
                                            int B, size_t at, bool live) {
  StepIn s;
  const size_t hb = (size_t)H * B, gb = 4 * hb;
  const float* gq = gates + 2 * (size_t)t * gb + at;
  const float* st = stash + (size_t)t * gb + at;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s.g0[q] = live ? gq[q * hb] : 0.0f;
    s.g1[q] = live ? gq[gb + q * hb] : 0.0f;
  }
  s.c0p = live ? st[hb] : 0.0f;
  s.c1p = live ? st[3 * hb] : 0.0f;
  s.m = (dm != nullptr && live) ? dm[(size_t)t * hb + at] : 1.0f;
  return s;
}

// Backward through one cell from its gate activations a = (i, f, g, o) and
// the cell state after (c_aft) and before (c_prev) the step: the four gate
// gradients; dc <- dc * f.
__device__ __forceinline__ void cell_bwd(const float (&a)[4], float dh, float& dc,
                                         float c_aft, float c_prev, float (&dg)[4]) {
  const float i = a[0], f = a[1], gg = a[2], o = a[3];
  const float tc = tanhf(c_aft);
  const float d_o = dh * tc;
  const float d_c = dc + dh * o * (1.0f - tc * tc);
  dg[0] = (d_c * gg) * i * (1.0f - i);
  dg[1] = (d_c * c_prev) * f * (1.0f - f);
  dg[2] = (d_c * i) * (1.0f - gg * gg);
  dg[3] = d_o * o * (1.0f - o);
  dc = d_c * f;
}

// The slot's four gate gradients to rows q*H + unit of device memory dgo
// [4H,B] and of the gather buffer buf [G][NW] of every block of the cluster:
// first into this block's own buffer, then the block's 4 runs of UB rows
// (NT floats each) as one float4 a thread to each of the 7 peers.
template <int H>
__device__ __forceinline__ void gather_rows(float* buf, const float (&dg)[4], int tid,
                                            unsigned k, float* __restrict__ dgo,
                                            size_t at, int B, bool live) {
  using R = Rev<H>;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    buf[(q * H + k * R::UB) * NW + tid] = dg[q];
    if (live) dgo[(size_t)q * H * B + at] = dg[q];
  }
  __syncthreads();                         // the block's own rows complete
  float* src = buf + ((tid / (R::NT / 4)) * H + k * R::UB) * NW + (tid % (R::NT / 4)) * 4;
  const float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
  for (unsigned r = 1; r < CL; ++r)
    *reinterpret_cast<float4*>(peer_addr(src, (k + r) % CL)) = v;
}

// part[p][g][slot] = sum over rows r = i*RG + g (i in order) of
// W_{p0+p}[r][unit] * dg[r][window], for the 4x4 (unit, window) tile of this
// thread in row group g; Ws holds the slices [3][G][UB], dg [G][NW].
template <int H, int NP>
__device__ __forceinline__ void tr_products(const float* Ws, int p0, const float* dg,
                                            float* part, int tid) {
  using R = Rev<H>;
  const int g = tid / R::TILES, tile = tid % R::TILES;
  const int jt = tile / (NW / 4), wt = tile % (NW / 4);
  float acc[NP][4][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][a][c] = 0.0f;
  const float* dp = dg + g * NW + wt * 4;
  const float* wp = Ws + (size_t)p0 * R::G * R::UB + g * R::UB + jt * 4;
#pragma unroll 4
  for (int i = 0; i < R::G / RG; ++i) {
    const float4 d = *reinterpret_cast<const float4*>(dp + i * RG * NW);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(wp + p * R::G * R::UB + i * RG * R::UB);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[p][x][y] = fmaf(av[x], dv[y], acc[p][x][y]);
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(part + (p * RG + g) * R::NT + (jt * 4 + x) * NW + wt * 4) =
          make_float4(acc[p][x][0], acc[p][x][1], acc[p][x][2], acc[p][x][3]);
}

// sum over the row groups, in order, of product p's partials of one slot
template <int H>
__device__ __forceinline__ float part_sum(const float* part, int p, int slot) {
  using R = Rev<H>;
  float s = part[p * RG * R::NT + slot];
#pragma unroll
  for (int g = 1; g < RG; ++g) s += part[(p * RG + g) * R::NT + slot];
  return s;
}

// seed: d h_last [H,B] (encoder) or d recon [T,D,B] (decoder, with ow [D,H])
template <int H, bool DEC>
__global__ void __launch_bounds__(Rev<H>::NT, 1)
lstm2_bwd_scan_kernel(const float* __restrict__ dm, const LstmW W,
                      const float* __restrict__ ow,
                      const float* __restrict__ stash,
                      const float* __restrict__ gates,
                      const float* __restrict__ fin,
                      const float* __restrict__ seed, float* __restrict__ dg0o,
                      float* __restrict__ dg1o, int T, int D, int B) {
  using R = Rev<H>;
  extern __shared__ __align__(16) float sm[];
  float *Ws = sm + R::WS, *ga = sm + R::GA, *gb = sm + R::GB, *part = sm + R::PART;
  float *ows = sm + R::OW, *drs = sm + R::DR;
  const int tid = threadIdx.x;
  const unsigned k = cluster_rank();
  const int unit = k * R::UB + tid / NW;
  const int b0 = (blockIdx.x / CL) * NW, b = b0 + tid % NW;
  const bool live = b < B;
  const size_t hb = (size_t)H * B, at = (size_t)unit * B + b;

  for (int i = tid; i < R::G * R::UB; i += R::NT) {
    const size_t src = (size_t)(i / R::UB) * H + k * R::UB + i % R::UB;
    Ws[i] = W.w1i[src];
    Ws[R::G * R::UB + i] = W.w1h[src];
    Ws[2 * R::G * R::UB + i] = W.w0h[src];
  }
  // d(recon_t) of the cluster's windows, tile [D][NW]
  auto dr_at = [&](int t, int e) {
    const int w = e % NW;
    return (e < D * NW && b0 + w < B) ? seed[((size_t)t * D + e / NW) * B + b0 + w] : 0.0f;
  };
  if (DEC) {
    for (int i = tid; i < D * R::UB; i += R::NT)
      ows[i] = ow[(size_t)(i / R::UB) * H + k * R::UB + i % R::UB];
    for (int e = tid; e < D * NW; e += R::NT)
      drs[((T - 1) & 1) * DMAX * NW + e] = dr_at(T - 1, e);
  }
  float c0a = live ? fin[hb + at] : 0.0f;
  float c1a = live ? fin[3 * hb + at] : 0.0f;
  float dh1 = (!DEC && live) ? seed[at] : 0.0f;
  float dh0 = 0.0f, dc0 = 0.0f, dc1 = 0.0f;
  StepIn cur = load_step<H>(stash, gates, dm, T - 1, B, at, live), nxt = cur;
  cluster_sync();                          // the cluster runs, its weights are in place

  for (int t = T - 1; t >= 0; --t) {
    // step t-1's inputs, in flight while step t computes
    float drn[R::PF];
    if (t > 0) {
      nxt = load_step<H>(stash, gates, dm, t - 1, B, at, live);
      if (DEC) {
#pragma unroll
        for (int q = 0; q < R::PF; ++q) drn[q] = dr_at(t - 1, tid + q * R::NT);
      }
    }
    if (DEC) {                             // output head: dh1 += ow^T d(recon_t)
      const float* dr = drs + (t & 1) * DMAX * NW + tid % NW;
      for (int d = 0; d < D; ++d) dh1 = fmaf(ows[d * R::UB + tid / NW], dr[d * NW], dh1);
    }
    float dg[4];
    cell_bwd(cur.g1, dh1, dc1, c1a, cur.c1p, dg);
    gather_rows<H>(ga, dg, tid, k, dg1o + (size_t)t * 4 * hb, at, B, live);
    if (DEC && t > 0) {
      float* next = drs + ((t - 1) & 1) * DMAX * NW;
#pragma unroll
      for (int q = 0; q < R::PF; ++q)
        if (tid + q * R::NT < DMAX * NW) next[tid + q * R::NT] = drn[q];
    }
    cluster_sync();                        // dg1 gathered
    tr_products<H, 2>(Ws, 0, ga, part, tid);
    __syncthreads();                       // partials visible
    dh0 = dh0 + part_sum<H>(part, 0, tid) * cur.m;
    dh1 = part_sum<H>(part, 1, tid);
    cell_bwd(cur.g0, dh0, dc0, c0a, cur.c0p, dg);
    gather_rows<H>(gb, dg, tid, k, dg0o + (size_t)t * 4 * hb, at, B, live);
    cluster_sync();                        // dg0 gathered, reads of part done
    tr_products<H, 1>(Ws, 2, gb, part, tid);
    __syncthreads();                       // partials visible
    dh0 = part_sum<H>(part, 0, tid);
    c0a = cur.c0p;
    c1a = cur.c1p;
    cur = nxt;
  }
  cluster_sync();                          // no block leaves while a peer may address it
}

// Set up one instance once (its shared memory above 48 KB) and read what
// the card makes of it: out = {clusters of CL blocks that fit at once,
// dynamic shared bytes a block, registers a thread, local (spill) bytes a
// thread, threads a block}.
template <int H, bool DEC>
cudaError_t bwd_scan_info(int* out) {
  using R = Rev<H>;
  static int info[5] = {-1, 0, 0, 0, 0};
  if (info[0] < 0) {
    auto kern = lstm2_bwd_scan_kernel<H, DEC>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)R::BYTES);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(R::NT);
    cfg.dynamicSmemBytes = R::BYTES;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    info[0] = n;
    info[1] = (int)R::BYTES;
    info[2] = fa.numRegs;
    info[3] = (int)fa.localSizeBytes;
    info[4] = R::NT;
  }
  for (int i = 0; i < 5; ++i) out[i] = info[i];
  return cudaSuccess;
}

// the reverse scan over B windows: ceil(B/NW) clusters of CL blocks
template <int H, bool DEC>
cudaError_t bwd_scan(const float* dm, const LstmW& W, const float* ow,
                     const float* stash, const float* gates, const float* fin,
                     const float* seed, float* dg0, float* dg1, int T, int D,
                     int B, cudaStream_t s) {
  using R = Rev<H>;
  int info[5];
  cudaError_t e = bwd_scan_info<H, DEC>(info);
  if (e != cudaSuccess) return e;
  if (info[0] == 0) return cudaErrorLaunchOutOfResources;   // no cluster fits
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + NW - 1) / NW) * CL);
  cfg.blockDim = dim3(R::NT);
  cfg.dynamicSmemBytes = R::BYTES;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lstm2_bwd_scan_kernel<H, DEC>, dm, W, ow, stash,
                         gates, fin, seed, dg0, dg1, T, D, B);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
                    float* stash, float* gates, float* hlast, float* fin, int T,
                    int D, int B, cudaStream_t s) {
  lstm2_enc_fwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      xs, dm, stack_weights(w, false), stash, gates, hlast, fin, T, D, B);
  return cudaGetLastError();
}

// w: w0i_t w0h_t b0 w1i_t w1h_t b1 w0i w0h w1i w1h
// scratch: dg0 dg1 partial;  out: dx gw0i gw0h gb0 gw1i gw1h gb1
template <int H>
cudaError_t enc_bwd(const float* xs, const float* dm, const float* const* w,
                    const float* stash, const float* gates, const float* fin,
                    const float* dhl, float* const* scratch, float* const* out,
                    int T, int D, int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2];
  SHM_TRY((bwd_scan<H, false>(dm, stack_weights(w, true), nullptr, stash, gates,
                              fin, dhl, dg0, dg1, T, D, B, s)));
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
                    float* recon, float* stash, float* gates, float* fin, int T,
                    int D, int K, int B, cudaStream_t s) {
  lstm2_dec_fwd_kernel<H><<<(B + BW - 1) / BW, 4 * H, 0, s>>>(
      din, dm, stack_weights(w, false), w[10], w[11], recon, stash, gates, fin,
      T, D, K, B);
  return cudaGetLastError();
}

// w: w0i_t w0h_t b0 w1i_t w1h_t b1 w0i w0h w1i w1h ow ob
// scratch: dg0 dg1 partial sum_t(dg0);  out: ddin gw0i gw0h gb0 gw1i gw1h gb1 gow gob
template <int H>
cudaError_t dec_bwd(const float* din, const float* dm, const float* const* w,
                    const float* stash, const float* gates, const float* fin,
                    const float* dr, float* const* scratch, float* const* out,
                    int T, int D, int K, int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2],
        *adg0 = scratch[3];
  SHM_TRY((bwd_scan<H, true>(dm, stack_weights(w, true), w[10], stash, gates,
                             fin, dr, dg0, dg1, T, D, B, s)));
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
// `dm` may be null (unit mask), `stash` and
// `gates` null in the forwards (nothing kept for a backward; a forward writes
// the gate stash [T,2,4H,B] only with a stash) and out[0] null in the
// encoder backward (no dx wanted). Each returns the first cudaGetLastError()
// that is not 0, else 0. S is the number of splits over T of the contraction
// (partial holds S * 4H * max(H, K, D) floats).

extern "C" int shm_lstm2_enc_fwd_f32(const float* xs, const float* dm,
                                     const void* const* w, float* stash,
                                     float* gates, float* hlast, float* fin,
                                     int T, int D, int H, int B, void* stream) {
  if (bad_dims(T, D, H, B, 1)) return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = enc_fwd<32>(xs, dm, wp, stash, gates, hlast, fin, T, D, B, s); break;
    case 64: err = enc_fwd<64>(xs, dm, wp, stash, gates, hlast, fin, T, D, B, s); break;
    default: err = enc_fwd<128>(xs, dm, wp, stash, gates, hlast, fin, T, D, B, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_enc_bwd_f32(const float* xs, const float* dm,
                                     const void* const* w, const float* stash,
                                     const float* gates, const float* fin,
                                     const float* dhl,
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
    case 32: err = enc_bwd<32>(xs, dm, wp, stash, gates, fin, dhl, sp, op, T, D, B, S, s); break;
    case 64: err = enc_bwd<64>(xs, dm, wp, stash, gates, fin, dhl, sp, op, T, D, B, S, s); break;
    default: err = enc_bwd<128>(xs, dm, wp, stash, gates, fin, dhl, sp, op, T, D, B, S, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_dec_fwd_f32(const float* din, const float* dm,
                                     const void* const* w, float* recon,
                                     float* stash, float* gates, float* fin,
                                     int T, int D, int H, int K, int B,
                                     void* stream) {
  if (bad_dims(T, D, H, B, 1) || K <= 0 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  const float* const* wp = reinterpret_cast<const float* const*>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = dec_fwd<32>(din, dm, wp, recon, stash, gates, fin, T, D, K, B, s); break;
    case 64: err = dec_fwd<64>(din, dm, wp, recon, stash, gates, fin, T, D, K, B, s); break;
    default: err = dec_fwd<128>(din, dm, wp, recon, stash, gates, fin, T, D, K, B, s); break;
  }
  return (int)err;
}

extern "C" int shm_lstm2_dec_bwd_f32(const float* din, const float* dm,
                                     const void* const* w, const float* stash,
                                     const float* gates, const float* fin,
                                     const float* dr,
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
    case 32: err = dec_bwd<32>(din, dm, wp, stash, gates, fin, dr, sp, op, T, D, K, B, S, s); break;
    case 64: err = dec_bwd<64>(din, dm, wp, stash, gates, fin, dr, sp, op, T, D, K, B, S, s); break;
    default: err = dec_bwd<128>(din, dm, wp, stash, gates, fin, dr, sp, op, T, D, K, B, S, s); break;
  }
  return (int)err;
}

// {clusters that fit at once, shared bytes a block, registers a thread,
// local bytes a thread, threads a block} of the reverse-scan instance of H
// for the encoder (dec = 0) or the decoder (dec = 1)
extern "C" int shm_lstm2_bwd_scan_info(int H, int dec, int* out) {
  if (H != 32 && H != 64 && H != 128) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (H * 2 + (dec != 0)) {
    case 64: err = bwd_scan_info<32, false>(out); break;
    case 65: err = bwd_scan_info<32, true>(out); break;
    case 128: err = bwd_scan_info<64, false>(out); break;
    case 129: err = bwd_scan_info<64, true>(out); break;
    case 256: err = bwd_scan_info<128, false>(out); break;
    default: err = bwd_scan_info<128, true>(out); break;
  }
  return (int)err;
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
