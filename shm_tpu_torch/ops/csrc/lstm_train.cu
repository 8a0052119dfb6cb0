// Two-layer LSTM training scans for Hopper (sm_90a), float32: forward and
// hand-written backward of the VAE's encoder and decoder stacks.
//
// Replaces the four Pallas TPU kernels of shm_tpu/ops/lstm_train.py:
//   _enc_fwd_kernel (:153, pallas_call :299)  -> lstm2_fwd_scan_kernel<H, false>
//   _enc_bwd_kernel (:191, pallas_call :331)  -> lstm2_bwd_scan_kernel<H, false>
//                                                + the parallel gradient pass
//   _dec_fwd_kernel (:359, pallas_call :507)  -> lstm2_fwd_scan_kernel<H, true>
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
// Both scans, forward and reverse, run on clusters of 8 blocks that hold the
// three [4H,H] matrices in shared memory, a slice a block (one [4H,H] f32
// matrix is 256 KiB at H=128, more than a block's shared memory), and gather
// what a step needs from the other blocks through distributed shared memory.
// The TPU kernels keep every weight in VMEM for the whole scan (`_const_spec`)
// over a batch tile of 256 windows; a cluster here takes 20 windows, so that
// B=256 needs 13 clusters and the card places 15 at once. The backward's
// weight gradients are a second, parallel pass. There are no float atomics
// anywhere: the same inputs give the same bits every run.
// Against the bound: float32 FMA pipes, no tensor cores; the bf16/wgmma path
// is later work.
//
// Accurate expf/tanhf (no --use_fast_math); sigmoid(x) = 1/(1+exp(-x)).

#include <cuda_runtime.h>

namespace {

constexpr int DMAX = 32;     // widest encoder input / head output
constexpr int KMAX = 128;    // widest decoder input
constexpr int CL = 8;        // blocks a cluster
constexpr int NW = 20;       // windows a cluster

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct LstmW {           // one 2-layer stack, every matrix as given, [4H,in]
  const float* w0i;
  const float* w0h;
  const float* b0;       // [4H]
  const float* w1i;
  const float* w1h;
  const float* b1;       // [4H]
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

// ------------------------------------------ the forwards, on a block cluster
//
// Both stacks' forward scan in one body (DEC: the decoder). A cluster of
// CL = 8 blocks takes NW = 20 windows; block rk of it owns the units
// j in [rk*UB, (rk+1)*UB), UB = H/8, of those windows, one thread per (unit,
// window) slot (thread u*NW + w) with c0, c1 and the slot's state in
// registers. At its start a block loads the gate rows {q*H + j} of W0h, W1i
// and W1h (96 KiB at H=128) and the encoder's W0i into shared memory as
// [unit][k][gate], so that one float4 gives the four gates of a unit at one
// input k; the decoder's head ow and its layer-0 projection b0 + W0i dec_in
// (constant over T, a slot's four values in registers) are made once. No
// weight is read from device memory after that.
//
// The products: thread (u, w) also owns the register tile of unit u's four
// gates x the four windows 4*(w/4).., over the inputs k = g, g+4, ... with
// g = w % 4, so one float4 of weights and one of h feed 16 FMAs. The four
// partial tiles of a quad of lanes are then summed by a fixed tree of
// shuffles that leaves each lane its own window's four gates: no partial sums
// in shared memory, no atomics, the same bits every run.
//
// The layers are skewed: phase s (0..T) computes layer 0 of step s and layer
// 1 of step s-1 together (layer 0 at s needs only h0_{s-1} and x_s), pushes
// h0_s, h0_s * m_s and h1_{s-1} into the gather buffers [H][NW] of every
// block of the cluster (distributed shared memory), and ends with the one
// cluster barrier of the phase. The buffers are double-buffered by parity: a
// block writes a peer's buffer of a parity only in the phase after the one
// whose barrier ends every read of it. The decoder's head recon_{s-2} =
// ob + ow h1_{s-2} reads the gathered h1 in phase s, before that buffer is
// written again; its D x NW outputs are split over the 8 blocks. Phase 0 has
// only layer 0 and phase T only layer 1 (what the other half computes there
// is discarded); stash[t] gets h0/c0 in phase t and h1/c1 in phase t+1, and
// so does the gate stash. A cluster's windows past the batch edge compute on
// zeros and write nothing; a batch of more clusters than the card places at
// once runs in waves.

template <int H, bool DEC>
struct Fwd {
  static constexpr int UB = H / CL;          // units a block
  static constexpr int NT = UB * NW;         // threads: one (unit, window) slot each
  static constexpr int HW = H * NW;          // one gather buffer [H][NW]
  static constexpr int PF = (DMAX * NW + NT - 1) / NT;  // x tile prefetch a thread
  // dynamic shared memory, in floats
  static constexpr int W0H = 0;                          // [UB][H][4] each
  static constexpr int W1I = W0H + 4 * UB * H;
  static constexpr int W1H = W1I + 4 * UB * H;
  static constexpr int W0I = W1H + 4 * UB * H;           // encoder: [UB][D][4]
  static constexpr int OW = W0I + (DEC ? 0 : 4 * UB * DMAX);   // decoder: ow [H][D]
  static constexpr int XS = OW + (DEC ? H * DMAX : 0);   // encoder: x_s [2][D][NW]
  static constexpr int H0 = XS + (DEC ? 0 : 2 * DMAX * NW);    // gathered h0 [2][H][NW]
  static constexpr int H0D = H0 + 2 * HW;                // gathered h0 * m [2][H][NW]
  static constexpr int H1 = H0D + 2 * HW;                // gathered h1 [2][H][NW]
  static constexpr size_t BYTES = (size_t)(H1 + 2 * HW) * sizeof(float);
  static_assert(NW % 4 == 0 && (DMAX * NW + CL - 1) / CL <= NT, "tiles, head");
};

// rows {q*H + rk*UB + u} of W [4H,K] -> shared [UB][K][4]
template <int H>
__device__ __forceinline__ void load_gate_rows(float* dst, const float* __restrict__ W,
                                               int K, unsigned rk, int tid, int nt) {
  constexpr int UB = H / CL;
  for (int i = tid; i < 4 * UB * K; i += nt) {
    const int k = i % K, u = (i / K) % UB, q = i / (K * UB);
    dst[(u * K + k) * 4 + q] = W[(size_t)(q * H + rk * UB + u) * K + k];
  }
}

struct Tile {
  float v[4][4];         // [gate][window of the quad]
};

// acc[p].v[q][x] += sum over k = g, g+4, ... < K of Ws[p][u][k][q] * in[p][k][4*wq + x]
// for NP products in one loop (independent FMA chains); Ws [UB][K][4], in [K][NW]
template <int NP>
__device__ __forceinline__ void tile_products(Tile* acc, const float* const (&Ws)[NP],
                                              const float* const (&in)[NP], int K,
                                              int u, int wq, int g) {
#pragma unroll 2
  for (int k = g; k < K; k += 4) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(Ws[p] + (u * K + k) * 4);
      const float4 h = *reinterpret_cast<const float4*>(in[p] + k * NW + wq * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[p].v[q][x] = fmaf(av[q], hv[x], acc[p].v[q][x]);
    }
  }
}

// out[q] = the sum over the quad's 4 lanes (g = lane % 4) of a.v[q][g]: lane
// g keeps its own window's four gates, by a fixed tree (lanes g^2, then g^1)
__device__ __forceinline__ void quad_sum(const Tile& a, float (&out)[4], int g,
                                         unsigned lanes) {
  const bool hi2 = g & 2, hi1 = g & 1;
  float r[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float lo = a.v[q][j], hi = a.v[q][2 + j];
      r[q][j] = (hi2 ? hi : lo) + __shfl_xor_sync(lanes, hi2 ? lo : hi, 2);
    }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = (hi1 ? r[q][1] : r[q][0]) + __shfl_xor_sync(lanes, hi1 ? r[q][0] : r[q][1], 1);
}

// One cell of a slot from its gate pre-activations; c updated, h returned.
// With gq != nullptr the activations i, f, g, o go to the gate stash gq[q*hb].
__device__ __forceinline__ float cell_fwd(const float (&pre)[4], float& c,
                                          float* __restrict__ gq, size_t hb) {
  const float i = sigmoid_f(pre[0]);
  const float f = sigmoid_f(pre[1]);
  const float gg = tanhf(pre[2]);
  const float o = sigmoid_f(pre[3]);
  if (gq != nullptr) {
    gq[0] = i;
    gq[hb] = f;
    gq[2 * hb] = gg;
    gq[3 * hb] = o;
  }
  c = f * c + i * gg;
  return o * tanhf(c);
}

// The block's rows (NT floats from rk*NT) of the three gather buffers b0,
// b1, b2, already in its own buffers and visible to the block, into the same
// rows of the 7 peers' buffers: one float4 a thread and peer.
template <int NT>
__device__ __forceinline__ void push_rows(float* b0, float* b1, float* b2, int tid,
                                          unsigned rk) {
  for (int i = tid; i < 3 * NT / 4; i += NT) {
    const int j = i / (NT / 4);            // a select, not an indexed array in local memory
    float* src = (j == 0 ? b0 : j == 1 ? b1 : b2) + rk * NT + (i % (NT / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (unsigned r = 1; r < CL; ++r)
      *reinterpret_cast<float4*>(peer_addr(src, (rk + r) % CL)) = v;
  }
}

// x: xs [T,D,B] (encoder) or dec_in [K,B] (decoder); out: h_last [H,B]
// (encoder) or recon [T,D,B] (decoder, with ow [D,H], ob [D])
template <int H, bool DEC>
__global__ void __launch_bounds__(Fwd<H, DEC>::NT, 1)
lstm2_fwd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dm,
                      const LstmW W, const float* __restrict__ ow,
                      const float* __restrict__ ob, float* __restrict__ stash,
                      float* __restrict__ gates, float* __restrict__ out,
                      float* __restrict__ fin, int T, int D, int K, int B) {
  using F = Fwd<H, DEC>;
  constexpr int UB = F::UB, NT = F::NT, HW = F::HW;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const unsigned rk = cluster_rank();
  const int u = tid / NW, w = tid % NW, wq = w / 4, g = tid % 4;
  const int unit = rk * UB + u;
  const int b0 = (blockIdx.x / CL) * NW, b = b0 + w;
  const bool live = b < B;
  const size_t hb = (size_t)H * B, at = (size_t)unit * B + b;
  // the lanes of this thread's warp (the last warp is partial at H=32)
  const unsigned lanes = (tid | 31) < NT ? 0xffffffffu : (1u << (NT % 32)) - 1u;

  load_gate_rows<H>(sm + F::W0H, W.w0h, H, rk, tid, NT);
  load_gate_rows<H>(sm + F::W1I, W.w1i, H, rk, tid, NT);
  load_gate_rows<H>(sm + F::W1H, W.w1h, H, rk, tid, NT);
  // layer 0's constant part of the pre-activations (encoder: b0; decoder:
  // b0 + W0i dec_in) and layer 1's bias, the slot's four gates each
  float pre0c[4], bias1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pre0c[q] = W.b0[q * H + unit];
    bias1[q] = W.b1[q * H + unit];
  }
  if (DEC) {
    for (int k = 0; k < K; ++k) {
      const float xv = live ? x[(size_t)k * B + b] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre0c[q] = fmaf(W.w0i[(size_t)(q * H + unit) * K + k], xv, pre0c[q]);
    }
    for (int i = tid; i < D * H; i += NT) sm[F::OW + (i % H) * D + i / H] = ow[i];
  } else {
    load_gate_rows<H>(sm + F::W0I, W.w0i, D, rk, tid, NT);
  }
  // the decoder head's output of this thread: recon[.][hd][b0 + hw]
  const int per = (D * NW + CL - 1) / CL, e = rk * per + tid;
  const bool head = DEC && tid < per && e < D * NW;
  const int hd = head ? e / NW : 0, hw = head ? e % NW : 0;
  const float hbias = head ? ob[hd] : 0.0f;
  auto run_head = [&](int t, const float* h1g) {
    if (!head) return;
    const float* hv = h1g + hw;
    const float* wv = sm + F::OW + hd;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < H; k += 4)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fmaf(wv[(k + j) * D], hv[(k + j) * NW], s[j]);
    if (b0 + hw < B)
      out[((size_t)t * D + hd) * B + b0 + hw] = hbias + ((s[0] + s[1]) + (s[2] + s[3]));
  };
  // the encoder's x_t tile [D][NW], zero past the batch edge
  auto x_at = [&](int t, int i) {
    const int ww = i % NW;
    return (i < D * NW && b0 + ww < B) ? x[((size_t)t * D + i / NW) * B + b0 + ww] : 0.0f;
  };
  for (int i = tid; i < 6 * HW; i += NT) sm[F::H0 + i] = 0.0f;   // h_{-1} = 0
  if (!DEC)
    for (int i = tid; i < D * NW; i += NT) sm[F::XS + i] = x_at(0, i);
  float h0 = 0.0f, c0 = 0.0f, h1 = 0.0f, c1 = 0.0f;
  cluster_sync();                          // the cluster runs; weights, zeros, x_0 in place

  for (int s = 0; s <= T; ++s) {
    const int p = s & 1, q = p ^ 1;        // parity of s, and of s-1 and s+1
    float xn[F::PF];                       // x_{s+1}, in flight during the phase
    if (!DEC && s + 1 < T) {
#pragma unroll
      for (int i = 0; i < F::PF; ++i) xn[i] = x_at(s + 1, tid + i * NT);
    }
    const float m = (dm != nullptr && live && s < T) ? dm[(size_t)s * hb + at] : 1.0f;
    const float* h1g = sm + F::H1 + p * HW;          // h1_{s-2}
    if (DEC && s >= 2) run_head(s - 2, h1g);

    Tile a[3] = {};
    if (!DEC) tile_products<1>(a, {sm + F::W0I}, {sm + F::XS + p * DMAX * NW}, D, u, wq, g);
    tile_products<3>(a, {sm + F::W0H, sm + F::W1I, sm + F::W1H},
                     {sm + F::H0 + q * HW, sm + F::H0D + q * HW, h1g}, H, u, wq, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[1].v[i][j] += a[2].v[i][j];
    float pre[4], pre1[4];
    quad_sum(a[0], pre, g, lanes);         // layer 0 of step s
    quad_sum(a[1], pre1, g, lanes);        // layer 1 of step s-1

    const bool keep = stash != nullptr && live;
    float* const bufs[3] = {sm + F::H0 + p * HW, sm + F::H0D + p * HW, sm + F::H1 + q * HW};
    if (s < T) {
      if (keep) {
        float* st = stash + (size_t)s * 4 * hb + at;
        st[0] = h0;
        st[hb] = c0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) pre[i] += pre0c[i];
      h0 = cell_fwd(pre, c0, keep ? gates + (size_t)2 * s * 4 * hb + at : nullptr, hb);
      bufs[0][rk * NT + tid] = h0;
      bufs[1][rk * NT + tid] = h0 * m;
    }
    if (s > 0) {
      if (keep) {
        float* st = stash + (size_t)(s - 1) * 4 * hb + at;
        st[2 * hb] = h1;
        st[3 * hb] = c1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) pre1[i] += bias1[i];
      h1 = cell_fwd(pre1, c1,
                    keep ? gates + (size_t)(2 * (s - 1) + 1) * 4 * hb + at : nullptr, hb);
      bufs[2][rk * NT + tid] = h1;
    }
    __syncthreads();                       // the block's own rows complete
    push_rows<NT>(bufs[0], bufs[1], bufs[2], tid, rk);
    if (!DEC && s + 1 < T) {
      float* xs_next = sm + F::XS + q * DMAX * NW;
#pragma unroll
      for (int i = 0; i < F::PF; ++i)
        if (tid + i * NT < D * NW) xs_next[tid + i * NT] = xn[i];
    }
    cluster_sync();                        // h0_s, h0_s * m_s, h1_{s-1} gathered
  }
  // The last barrier ended every write into this block's shared memory; what
  // follows reads only its own.
  if (DEC) run_head(T - 1, sm + F::H1 + ((T - 1) & 1) * HW);
  if (live) {
    if (!DEC) out[at] = h1;
    fin[at] = h0;
    fin[hb + at] = c0;
    fin[2 * hb + at] = h1;
    fin[3 * hb + at] = c1;
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

#define SHM_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

// ---------------------------------- setting up and launching the two scans

// A launch of `clusters` clusters of CL blocks of nt threads (cfg.attrs
// points into the object, so it is not copied).
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int clusters, int nt, size_t bytes, cudaStream_t s) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(clusters * CL);
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Set up one scan instance once (its shared memory above 48 KB) and read
// what the card makes of it: info = {clusters of CL blocks that fit at once,
// dynamic shared bytes a block, registers a thread, local (spill) bytes a
// thread, threads a block}; info[0] < 0 until then.
template <typename Kernel>
cudaError_t cluster_info(Kernel kern, size_t bytes, int nt, int* info) {
  if (info[0] >= 0) return cudaSuccess;
  SHM_TRY(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes));
  ClusterLaunch one(1, nt, bytes, 0);
  int n = 0;
  SHM_TRY(cudaOccupancyMaxActiveClusters(&n, kern, &one.cfg));
  cudaFuncAttributes fa;
  SHM_TRY(cudaFuncGetAttributes(&fa, kern));
  info[1] = (int)bytes;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = nt;
  info[0] = n;
  return cudaSuccess;
}

template <int H, bool DEC>
cudaError_t fwd_scan_info(int* out) {
  static int info[5] = {-1, 0, 0, 0, 0};
  SHM_TRY(cluster_info(lstm2_fwd_scan_kernel<H, DEC>, Fwd<H, DEC>::BYTES,
                       Fwd<H, DEC>::NT, info));
  for (int i = 0; i < 5; ++i) out[i] = info[i];
  return cudaSuccess;
}

template <int H, bool DEC>
cudaError_t bwd_scan_info(int* out) {
  static int info[5] = {-1, 0, 0, 0, 0};
  SHM_TRY(cluster_info(lstm2_bwd_scan_kernel<H, DEC>, Rev<H>::BYTES, Rev<H>::NT, info));
  for (int i = 0; i < 5; ++i) out[i] = info[i];
  return cudaSuccess;
}

// a scan over B windows: ceil(B/NW) clusters; refused where no cluster fits
template <typename Kernel, typename... Args>
cudaError_t cluster_launch(Kernel kern, const int* info, int B, cudaStream_t s,
                           Args... args) {
  if (info[0] == 0) return cudaErrorLaunchOutOfResources;
  ClusterLaunch l((B + NW - 1) / NW, info[4], info[1], s);
  SHM_TRY(cudaLaunchKernelEx(&l.cfg, kern, args...));
  return cudaGetLastError();
}

LstmW stack_weights(const float* const* w) {
  return LstmW{w[0], w[1], w[2], w[3], w[4], w[5]};
}

// The forward scan. w: w0i w0h b0 w1i w1h b1, and the decoder's ow ob;
// out: h_last (encoder) or recon (decoder)
template <int H, bool DEC>
cudaError_t fwd_scan(const float* x, const float* dm, const float* const* w,
                     float* stash, float* gates, float* out, float* fin, int T,
                     int D, int K, int B, cudaStream_t s) {
  int info[5];
  SHM_TRY((fwd_scan_info<H, DEC>(info)));
  return cluster_launch(lstm2_fwd_scan_kernel<H, DEC>, info, B, s, x, dm,
                        stack_weights(w), DEC ? w[6] : nullptr,
                        DEC ? w[7] : nullptr, stash, gates, out, fin, T, D, K, B);
}

// the reverse scan over B windows
template <int H, bool DEC>
cudaError_t bwd_scan(const float* dm, const LstmW& W, const float* ow,
                     const float* stash, const float* gates, const float* fin,
                     const float* seed, float* dg0, float* dg1, int T, int D,
                     int B, cudaStream_t s) {
  int info[5];
  SHM_TRY((bwd_scan_info<H, DEC>(info)));
  return cluster_launch(lstm2_bwd_scan_kernel<H, DEC>, info, B, s, dm, W, ow, stash,
                        gates, fin, seed, dg0, dg1, T, D, B);
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

// w: w0i w0h b0 w1i w1h b1
// scratch: dg0 dg1 partial;  out: dx gw0i gw0h gb0 gw1i gw1h gb1
template <int H>
cudaError_t enc_bwd(const float* xs, const float* dm, const float* const* w,
                    const float* stash, const float* gates, const float* fin,
                    const float* dhl, float* const* scratch, float* const* out,
                    int T, int D, int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2];
  SHM_TRY((bwd_scan<H, false>(dm, stack_weights(w), nullptr, stash, gates,
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
  if (out[0] != nullptr) SHM_TRY(wt_dg(w[0], dg0, T, 4 * H, D, B, out[0], s));
  return cudaSuccess;
}

// w: w0i w0h b0 w1i w1h b1 ow ob
// scratch: dg0 dg1 partial sum_t(dg0);  out: ddin gw0i gw0h gb0 gw1i gw1h gb1 gow gob
template <int H>
cudaError_t dec_bwd(const float* din, const float* dm, const float* const* w,
                    const float* stash, const float* gates, const float* fin,
                    const float* dr, float* const* scratch, float* const* out,
                    int T, int D, int K, int B, int S, cudaStream_t s) {
  float *dg0 = scratch[0], *dg1 = scratch[1], *partial = scratch[2],
        *adg0 = scratch[3];
  SHM_TRY((bwd_scan<H, true>(dm, stack_weights(w), w[6], stash, gates,
                             fin, dr, dg0, dg1, T, D, B, s)));
  const long long st = 4LL * H * B;
  const Stream g0 = plain_stream(dg0, st, 4 * H), g1 = plain_stream(dg1, st, 4 * H);
  const Stream h0d{stash, st, fin, dm, (long long)H * B, H};
  const Stream h1a{stash + 2LL * H * B, st, fin + 2LL * H * B, nullptr, 0, H};
  // layer 0's input is constant over T: sum dg0 over T first, then fold once
  SHM_TRY(sum_t_rowsum(dg0, T, 4 * H, B, adg0, out[3], s));
  SHM_TRY(contract(plain_stream(adg0, 0, 4 * H), plain_stream(din, 0, K), 1, B, 1, partial, out[1], s));
  SHM_TRY(wt_dg(w[0], adg0, 1, 4 * H, K, B, out[0], s));
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
// orders given above fwd_scan, enc_bwd and dec_bwd (a forward takes the same
// `w` array as its backward: the matrices as given, [4H,in]).
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
    case 32: err = fwd_scan<32, false>(xs, dm, wp, stash, gates, hlast, fin, T, D, 0, B, s); break;
    case 64: err = fwd_scan<64, false>(xs, dm, wp, stash, gates, hlast, fin, T, D, 0, B, s); break;
    default: err = fwd_scan<128, false>(xs, dm, wp, stash, gates, hlast, fin, T, D, 0, B, s); break;
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
    case 32: err = fwd_scan<32, true>(din, dm, wp, stash, gates, recon, fin, T, D, K, B, s); break;
    case 64: err = fwd_scan<64, true>(din, dm, wp, stash, gates, recon, fin, T, D, K, B, s); break;
    default: err = fwd_scan<128, true>(din, dm, wp, stash, gates, recon, fin, T, D, K, B, s); break;
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
// local bytes a thread, threads a block} of the forward-scan instance of H
// for the encoder (dec = 0) or the decoder (dec = 1), set up at the first call
extern "C" int shm_lstm2_fwd_scan_info(int H, int dec, int* out) {
  if (H != 32 && H != 64 && H != 128) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (H * 2 + (dec != 0)) {
    case 64: err = fwd_scan_info<32, false>(out); break;
    case 65: err = fwd_scan_info<32, true>(out); break;
    case 128: err = fwd_scan_info<64, false>(out); break;
    case 129: err = fwd_scan_info<64, true>(out); break;
    case 256: err = fwd_scan_info<128, false>(out); break;
    default: err = fwd_scan_info<128, true>(out); break;
  }
  return (int)err;
}

// the same of the reverse-scan instance
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
