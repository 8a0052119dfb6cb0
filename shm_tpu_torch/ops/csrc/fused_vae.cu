// Fused deterministic LSTM-VAE gate for Hopper (sm_90a), float32 and bf16,
// and the numerics variants that attribute its time.
//
// Replaces the Pallas TPU kernel shm_tpu/ops/fused_vae.py::_kernel (:125),
// launched by fused_vae_gate (:292, pallas_call at :402). Same function:
//
//   x [N,T,D] -> L-layer LSTM encoder (keep h_T) -> [LayerNorm eps 1e-5]
//     -> mu = fc_mu(h_T) (z = mu) -> dec_in = tanh(fc_latent_to_hidden(mu))
//     -> decoder layer-0 input projection, computed ONCE (the decoder input
//        is constant over T) -> L-layer LSTM decoder -> output head x_hat
//     -> resid = (x - x_hat)^2 [N,T,D] and mse = sum(resid) / (T*D) [N]
//
// L in {1,2}, H in {32,64,128} (template), D <= 128, Z <= 128, any T.
// Weights come in the flax layout [in, out] (LSTM: w_ih [in,4H],
// w_hh [H,4H], gate order i|f|g|o, bias = b_ih + b_hh), and every LSTM
// weight also as 3xTF32 fragments (below).
//
// Any other width H_real <= 128 runs the instance of the next width H, on
// weights the wrapper pads with zeros (vae_params_to_kernel_weights): a
// padded unit has zero weights in and out and a zero bias, so its gates are
// i = f = o = 1/2, g = 0, and c and h stay exactly 0 from c = h = 0; the
// heads' padded rows and columns are zero too. Only LayerNorm sees the
// width: it normalises h_T over the h_real real units (a kernel argument)
// and leaves the padded ones at 0.
//
// D and Z size the x tile and the mu buffer at run time (dynamic shared
// memory): a row of XPD = max(round_up(D, 8), 16) + 4 floats (4 mod 8, so
// the fragment loads stay conflict-free) and max(Z, 32) rows of mu, so every
// shape of D <= 16 and Z <= 32 keeps the bytes it had. The output head's
// first DMAX * BT slots keep their e^2 sums in registers; the slots past
// them (D > 16) keep theirs in the x tile, free in the decoder, at the
// place the closing sum reads them.
//
// Bound on this card. Per window the matmul work is, for the 4DOF preset
// (T=100, D=12, H=128, Z=16, L=2), 2*T*4H*(D+H) + 2*T*4H*2H (encoder)
// + 2*2*H*Z + 2*4H*H (heads, decoder input) + T*(2*4H*H + 2*4H*2H + 2*D*H)
// (decoder scan and head), about 80.3 MFLOP; at N=5,440 that is about
// 437 GFLOP, which is ~6.5 ms at the 67 TFLOP/s float32 rate without tensor
// cores. The LSTM gate products are ~99% of it: in 3xTF32 on the tensor
// cores (three TF32 products each, 495 TFLOP/s) ~2.65 ms. The bytes are
// ~53 MB in and out (x, resid, weights once), ~16 us at 3.35 TB/s. So the
// kernel is bound by operations, and the serial chain of 2*L*T dependent
// cell steps bounds its latency as well.
//
// Design of the shipping body (fused_vae_tc_kernel). One block owns a tile
// of BT = 16*MT windows (MT m16 row tiles) and runs the whole T-step loop of
// every layer for it, so nothing but x, resid and mse touches device memory
// per window:
//   * H/8 warps a block (4H threads, 512 at H=128). Warp w owns the n-tiles
//     w, w + H/8, w + 2H/8, w + 3H/8 of the [K, 4H] gate product: the i, f,
//     g, o columns of units 8w .. 8w+7. The m16n8k8 accumulator puts (row g,
//     cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1) in lane 4g+t, so each
//     thread holds all four gates of units 8w+2t, 8w+2t+1 for windows g and
//     g+8 of each row tile: the cell update runs in registers with no gate
//     round trip, and c stays in registers for the whole loop.
//   * Every LSTM gate product of both stacks (x_t W0i, h0 W0h, h0 W1i, h1 W1h
//     each step, and the decoder's once-per-window dec_in W0i) runs on the
//     tensor cores: mma.sync m16n8k8 TF32 in 3xTF32, a * b = a_s b_b +
//     a_b b_s + a_b b_b with big = rna_tf32(x) and small = rna_tf32(x - big)
//     (round to nearest, ties away from zero): relative error ~2^-21 a
//     product, near float32's own. The tensor cores truncate each mma's sum
//     toward zero, so a sum chained through all 3*K/8 mma of a product drifts
//     toward zero (8e-6 relative on the mse of real windows, 10x a float32
//     order change): each pair of k-steps' six mma are chained from zero and
//     that partial is added to the float32 sum to nearest (TcSum, below).
//   * B: the wrapper packs each LSTM weight once in fragment order, for each
//     (n-tile, k-step, lane) one float4 {b0 big, b1 big, b0 small, b1 small},
//     so one coalesced 16-byte load gives a lane its whole B fragment; K is
//     padded with zero rows to a multiple of 8. Each fragment is loaded by
//     exactly one warp of the block, once a step, through L2 (one layer's
//     packed W_hh is 512 KiB at H=128; all of them, 3.2 MB, sit in L2).
//   * A: h of each layer and the x_t tile live in shared memory as
//     [window][k] with a padded row (H+4, and 20 for x, D padded with zero
//     columns to a multiple of 8), which makes the fragment loads
//     conflict-free (lane (g, t) hits bank 4g + t). Each A element is split
//     once by two integer operations (as the wrapper rounds the weights;
//     cvt.rna.tf32.f32 costs four) and used for the warp's four n-tiles.
//   * The decoder's constant layer-0 projection is kept in shared memory in
//     the accumulators' own order and loaded as each step's first sum.
//   * Per step, as the FMA body: products, cell update, barrier, store h,
//     barrier. Sums run in a fixed order (bias, then k in order, a pair of
//     k-steps' six mma apart, then added; the MSE over t, then d): two runs
//     are equal bit for bit.
//   * LayerNorm, the latent heads and the output head stay on the FMA pipes
//     (<1% of the FLOPs), as do the cell nonlinearities.
//
// The float32 FMA body (fused_vae_fma_kernel) is the template of the probe
// variants, which time it against the shipping body. It replaces the TPU
// probe kernel tools/probe_vpu_bound.py::_make_gate_kernel (:51, body :76),
// launched by gate_variant (:166, pallas_call at :191): the gate-only
// 2-layer pass with LayerNorm at H=128, with the probe's numerics and knobs
// as template knobs of the one FMA body (struct Variant); every knob off is
// the instance F32:
//   * WT = bf16: the product weights kept in bf16 in device memory (half the
//     L2 weight stream), widened to float32 as they are loaded;
//   * RND: every product operand rounded to bf16, as the TPU probe's `mm`
//     (windows, each stored h, the LayerNorm output, mu, the decoder input);
//     the encoder's last h stays float32 as LayerNorm's input;
//   * SIG_TANH: sigmoid(x) = 0.5 * (tanh(0.5x) + 1) (one tanhf, no expf);
//   * ACT_BF16: the gates rounded to bf16 before the activations, each
//     activation's result rounded, c rounded before its tanh; with SIG_TANH
//     also the tanh form's sum (probe_vpu_bound.py:64-73, as bf16 arithmetic
//     rounds);
//   * IL = 2: each thread advances two independent groups of 8 windows in
//     one loop (a block owns 64 windows, not 32): every weight load then
//     feeds 64 FMAs, not 32, and the two groups' chains interleave (the TPU
//     probe's two sub-tiles per program); it doubles the accumulators, c and
//     the decoder's constant projection held by each thread.
// The probe entry also reaches the tensor-core body (float32 only) with each
// of its three sums, so the probe table shows the shipping instance beside
// F32 and the card holds the sums apart. LayerNorm's eps is an argument:
// the model's 1e-5 for the gate; the TPU probe has 1e-6
// (probe_vpu_bound.py:118), which its port keeps.
// FMA body design: threads = 4*H; thread (j, g) owns hidden unit j for the
// BW=8 windows of group g (of each sub-tile) and all four gates of unit j;
// h of every layer lives in shared memory as [H][BT+4]; weights [in, out]
// are read from global memory through L1/L2 (thread j reads column q*H+j of
// row k). It cannot pass the ~6.5 ms f32 FMA bound.
//
// The bf16 instance (C entry shm_fused_vae_gate_bf16) is the TPU kernel with
// dtype=bf16 (fused_vae.py:153-163, :225-230): every product's two operands
// rounded to bf16, the products summed in float32; h, c, LayerNorm and the
// mse stay float32. It is the tensor-core body with the sum TC_BF16: each A
// element rounded to bf16 (cvt.rn.bf16x2.f32) in place of the TF32 split,
// the B fragments packed by the wrapper from bf16-rounded weights (their
// small parts zero), a_b b_b alone chained into the sum as TC_ONE_TERM does.
// A bf16 value is exact in TF32 and a product of two is exact in float32,
// so each mma adds the TPU's own products. The heads on the FMA pipes (mu,
// z2h, output) round both operands. Its io is float32 or bf16 (template IOT):
// with bf16 the window tile is read as bf16 wherever it is read (the
// residual's x - y too) and the residual is stored as bf16; the mse sums the
// float32 squares. Its bound at N=5,440 (4DOF preset) is the gate products'
// FLOPs at the 989 TFLOP/s bf16 rate; this instance, at one TF32 mma a
// product on m16n8k8, runs them at the 495 TFLOP/s TF32 rate at best.
//
// The activation forms (the JAX kernel's sigmoid_impl / tanh_impl,
// fused_vae.py:299-307). The default forms, sigmoid(x) = 1/(1+exp(-x)) and
// tanhf, are what the default instances compute, unchanged. The JAX kernel's
// others, the tanh-form sigmoid 0.5 * (tanh(0.5x) + 1) and the clamped R(7,6)
// rational tanh (JAX's constants and Horner order, one IEEE division), run
// in a second instance of each precision and io type (template flag FORMS:
// 9 instances beside the 9 default ones, not 27), which reads the forms from
// the kernel argument `act` at run time: one value for the whole grid, so
// the switch costs a uniform branch in the cell update and never diverges.
// The choice keeps the default instances' code, registers and bits as they
// were, and the build at 9 more instances rather than 27.
//
// The residual layout (the JAX kernel's residual_layout, fused_vae.py:350,
// :411-417): "transposed" is [T][Dp][N], Dp = D rounded up to 16 with the
// rows past D zero; the kernel argument `tr` remaps the output head's slots
// so that stores run along n (TrSlot, below), in every instance, and the mse
// keeps its bits.
//
// Accurate expf/tanhf (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int BW = 8;           // windows per thread per sub-tile
constexpr int NG = 4;           // window groups per sub-tile (threads = NG*H)
constexpr int SUB = NG * BW;    // windows per sub-tile (32)
constexpr int DMAX = 16;         // the probe body's D; the slots a thread
                                 // sums in registers
constexpr int ZMAX = 32;         // the probe body's Z; the fewest mu rows
constexpr int DLIM = 128;        // the largest D and Z the gate takes
constexpr int ZLIM = 128;
constexpr int NUM_W = 28;       // 20 as given, then the 8 LSTM fragments
constexpr int PROBE_H = 128;    // the probe variants' width (the 4DOF preset)

typedef unsigned short bf16_t;  // raw bf16 bits

template <typename WT_, bool RND_, bool SIG_TANH_, bool ACT_BF16_, int IL_>
struct Variant {
  using WT = WT_;
  static constexpr bool RND = RND_;
  static constexpr bool SIG_TANH = SIG_TANH_;
  static constexpr bool ACT_BF16 = ACT_BF16_;
  static constexpr int IL = IL_;
};
using F32 = Variant<float, false, false, false, 1>;

template <typename WT>
struct VaeWeights {             // product weights WT [in, out]; the rest float32
  const WT* enc_wih[2];
  const WT* enc_whh[2];
  const float* enc_b[2];
  const float* ln_scale;
  const float* ln_bias;
  const WT* mu_w;     // [H, Z]
  const float* mu_b;  // [Z]
  const WT* z2h_w;    // [Z, H]
  const float* z2h_b; // [H]
  const WT* dec_wih[2];
  const WT* dec_whh[2];
  const float* dec_b[2];
  const WT* out_w;    // [H, D]
  const float* out_b; // [D]
  // the LSTM weights as 3xTF32 fragments (the tensor-core body reads these)
  const float4* enc_wih_f[2];
  const float4* enc_whh_f[2];
  const float4* dec_wih_f[2];
  const float4* dec_whh_f[2];
};

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const bf16_t* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}

// float32 -> nearest bf16 (ties to even), as a float32
__device__ __forceinline__ float bfr(float x) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r << 16);
}

template <bool R>
__device__ __forceinline__ float rd(float x) {
  if constexpr (R) return bfr(x);
  return x;
}

// the window tile and the residual in their io type: float32, or bf16 bits
__device__ __forceinline__ float ld_io(const float* p) { return *p; }
__device__ __forceinline__ float ld_io(const bf16_t* p) {
  return __uint_as_float((unsigned)*p << 16);
}
__device__ __forceinline__ void st_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_io(bf16_t* p, float v) {
  *p = (bf16_t)(__float_as_uint(bfr(v)) >> 16);
}

template <class V>
__device__ __forceinline__ float sig(float x) {
  if constexpr (V::SIG_TANH) {
    if constexpr (V::ACT_BF16) return 0.5f * bfr(bfr(tanhf(0.5f * x)) + 1.0f);
    return 0.5f * (tanhf(0.5f * x) + 1.0f);
  } else {
    return rd<V::ACT_BF16>(1.0f / (1.0f + expf(-x)));
  }
}

template <class V>
__device__ __forceinline__ float act_tanh(float x) {
  return rd<V::ACT_BF16>(tanhf(x));
}

// acc[s][q][w] += sum_k W[k][q*H + j] * buf[k][s*SUB + g*BW + w] for k < K
// (W row-major [K, 4H]; buf is a shared [K][ld] buffer).
template <int H, class V>
__device__ __forceinline__ void gate_matvec(float (&acc)[V::IL][4][BW],
                                            const typename V::WT* __restrict__ W,
                                            int K, const float* buf, int ld,
                                            int j, int g) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const typename V::WT* wr = W + (size_t)k * 4 * H + j;
    const float w0 = ldw(wr), w1 = ldw(wr + H), w2 = ldw(wr + 2 * H),
                w3 = ldw(wr + 3 * H);
#pragma unroll
    for (int s = 0; s < V::IL; ++s) {
      const float* p = buf + k * ld + s * SUB + g * BW;
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      const float v[BW] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int w = 0; w < BW; ++w) {
        acc[s][0][w] = fmaf(w0, v[w], acc[s][0][w]);
        acc[s][1][w] = fmaf(w1, v[w], acc[s][1][w]);
        acc[s][2][w] = fmaf(w2, v[w], acc[s][2][w]);
        acc[s][3][w] = fmaf(w3, v[w], acc[s][3][w]);
      }
    }
  }
}

template <int H, int IL>
__device__ __forceinline__ void set_bias(float (&acc)[IL][4][BW],
                                         const float* b, int j) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float bq = __ldg(b + q * H + j);
#pragma unroll
    for (int s = 0; s < IL; ++s)
#pragma unroll
      for (int w = 0; w < BW; ++w) acc[s][q][w] = bq;
  }
}

template <class V>
__device__ __forceinline__ void cell_update(const float (&acc)[V::IL][4][BW],
                                            float (&c)[V::IL][BW],
                                            float (&h)[V::IL][BW]) {
#pragma unroll
  for (int s = 0; s < V::IL; ++s)
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      const float i = sig<V>(rd<V::ACT_BF16>(acc[s][0][w]));
      const float f = sig<V>(rd<V::ACT_BF16>(acc[s][1][w]));
      const float gg = act_tanh<V>(rd<V::ACT_BF16>(acc[s][2][w]));
      const float o = sig<V>(rd<V::ACT_BF16>(acc[s][3][w]));
      c[s][w] = f * c[s][w] + i * gg;
      h[s][w] = o * act_tanh<V>(rd<V::ACT_BF16>(c[s][w]));
    }
}

// h into the shared [H][ld] buffer, rounded to bf16 under RND unless `exact`
template <class V>
__device__ __forceinline__ void store_h(float* hs, const float (&h)[V::IL][BW],
                                        int ld, int j, int g, bool exact) {
#pragma unroll
  for (int s = 0; s < V::IL; ++s) {
    float v[BW];
#pragma unroll
    for (int w = 0; w < BW; ++w) v[w] = (V::RND && !exact) ? bfr(h[s][w]) : h[s][w];
    float4* p = reinterpret_cast<float4*>(hs + j * ld + s * SUB + g * BW);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <class V>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * PROBE_H * (V::IL * SUB + 4) + (DMAX + ZMAX) * V::IL * SUB);
}

// The probe's fixed shape: H = PROBE_H, 2 layers, LayerNorm on, no residual.
template <class V>
__global__ void __launch_bounds__(NG * PROBE_H)
fused_vae_fma_kernel(const float* __restrict__ x, float* __restrict__ mse,
                     const VaeWeights<typename V::WT> Wt, int N, int T, int D,
                     int Z, float ln_eps) {
  constexpr int H = PROBE_H;
  constexpr int IL = V::IL;
  constexpr int NT = NG * H;
  constexpr int BT = IL * SUB;
  constexpr int BTP = BT + 4;     // padded row of the shared h buffers
  constexpr int IO_SLOTS = (DMAX * BT + NT - 1) / NT;

  // 43 KB at IL = 1; 82 KB at IL = 2 (past the 48 KB static limit)
  extern __shared__ __align__(16) float smem[];
  float* const hs[2] = {smem, smem + H * BTP};
  float* const xs = smem + 2 * H * BTP;             // [DMAX][BT]
  float* const mus = xs + DMAX * BT;                // [ZMAX][BT]

  const int tid = threadIdx.x;
  const int j = tid % H;
  const int g = tid / H;
  const int n0 = blockIdx.x * BT;

  for (int i = tid; i < 2 * H * BTP; i += NT) smem[i] = 0.0f;
  float c[2][IL][BW];
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int s = 0; s < IL; ++s)
#pragma unroll
      for (int w = 0; w < BW; ++w) c[l][s][w] = 0.0f;
  __syncthreads();

  // ---------------- encoder: both layers advance inside one time loop
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < D * BT; i += NT) {         // x_t tile -> xs[d][b]
      const int b = i % BT, d = i / BT;
      const int n = n0 + b;
      xs[d * BT + b] = n < N ? rd<V::RND>(x[((size_t)n * T + t) * D + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      float acc[IL][4][BW];
      set_bias<H, IL>(acc, Wt.enc_b[l], j);
      if (l == 0)
        gate_matvec<H, V>(acc, Wt.enc_wih[0], D, xs, BT, j, g);
      else
        gate_matvec<H, V>(acc, Wt.enc_wih[1], H, hs[0], BTP, j, g);
      gate_matvec<H, V>(acc, Wt.enc_whh[l], H, hs[l], BTP, j, g);
      float h[IL][BW];
      cell_update<V>(acc, c[l], h);
      __syncthreads();                                // reads of h(t-1) done
      // the last layer's last h is LayerNorm's input: kept in float32
      store_h<V>(hs[l], h, BTP, j, g, l == 1 && t == T - 1);
      __syncthreads();                                // h(t) visible
    }
  }

  // ---------------- LayerNorm over H + latent head (z = mu)
  float* const hl = hs[1];
  if (tid < BT) {
    float m = 0.0f;
    for (int k = 0; k < H; ++k) m += hl[k * BTP + tid];
    m /= H;
    float v = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float dv = hl[k * BTP + tid] - m;
      v += dv * dv;
    }
    v /= H;
    const float r = 1.0f / sqrtf(v + ln_eps);
    for (int k = 0; k < H; ++k)
      hl[k * BTP + tid] = (hl[k * BTP + tid] - m) * r * __ldg(Wt.ln_scale + k) +
                          __ldg(Wt.ln_bias + k);
  }
  __syncthreads();
  for (int i = tid; i < Z * BT; i += NT) {
    const int b = i % BT, z = i / BT;
    float s = __ldg(Wt.mu_b + z);
    for (int k = 0; k < H; ++k)
      s = fmaf(ldw(Wt.mu_w + k * Z + z), rd<V::RND>(hl[k * BTP + b]), s);
    mus[z * BT + b] = rd<V::RND>(s);
  }
  __syncthreads();
  // decoder input tanh(fc_latent_to_hidden(mu)) -> hs[0] (encoder state is dead)
  for (int i = tid; i < H * BT; i += NT) {
    const int b = i % BT, k = i / BT;
    float s = __ldg(Wt.z2h_b + k);
    for (int z = 0; z < Z; ++z) s = fmaf(ldw(Wt.z2h_w + z * H + k), mus[z * BT + b], s);
    hs[0][k * BTP + b] = rd<V::RND>(tanhf(s));
  }
  __syncthreads();
  // decoder layer-0 input projection, once: xpc = dec_in @ W_ih0 + b0
  float xpc[IL][4][BW];
  set_bias<H, IL>(xpc, Wt.dec_b[0], j);
  gate_matvec<H, V>(xpc, Wt.dec_wih[0], H, hs[0], BTP, j, g);
  __syncthreads();
  for (int i = tid; i < 2 * H * BTP; i += NT) smem[i] = 0.0f;
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int s = 0; s < IL; ++s)
#pragma unroll
      for (int w = 0; w < BW; ++w) c[l][s][w] = 0.0f;
  __syncthreads();

  // ---------------- decoder scan + output head + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      float acc[IL][4][BW];
      if (l == 0) {
#pragma unroll
        for (int s = 0; s < IL; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int w = 0; w < BW; ++w) acc[s][q][w] = xpc[s][q][w];
      } else {
        set_bias<H, IL>(acc, Wt.dec_b[1], j);
        gate_matvec<H, V>(acc, Wt.dec_wih[1], H, hs[0], BTP, j, g);
      }
      gate_matvec<H, V>(acc, Wt.dec_whh[l], H, hs[l], BTP, j, g);
      float h[IL][BW];
      cell_update<V>(acc, c[l], h);
      __syncthreads();
      store_h<V>(hs[l], h, BTP, j, g, false);
      __syncthreads();
    }
    // output head for step t: thread slot (b, d); reads hl before the next
    // step's first barrier, after which it may be overwritten
#pragma unroll
    for (int r = 0; r < IO_SLOTS; ++r) {
      const int i = tid + r * NT;
      if (i < D * BT) {
        const int b = i % BT, d = i / BT;
        const int n = n0 + b;
        float y = __ldg(Wt.out_b + d);
        for (int k = 0; k < H; ++k) y = fmaf(ldw(Wt.out_w + k * D + d), hl[k * BTP + b], y);
        if (n < N) {
          const float e = rd<V::RND>(x[((size_t)n * T + t) * D + d]) - y;
          acc_mse[r] += e * e;
        }
      }
    }
  }

  // per-window MSE: sum the D partials of each window
  __syncthreads();
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) {
    const int i = tid + r * NT;
    if (i < D * BT) xs[i] = acc_mse[r];               // xs[d*BT + b]
  }
  __syncthreads();
  if (tid < BT && n0 + tid < N) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s += xs[d * BT + tid];
    mse[n0 + tid] = s / (float)(T * D);
  }
}

// ---------------------------------------------------------------------------
// The shipping body: every LSTM gate product on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

// padded row of the shared x_t tile [BT][xp_of(D)]: D rounded up to 8 (at
// least 16, the width every D <= 16 had), plus 4
__host__ __device__ constexpr int xp_of(int D) {
  return ((D + 7) & ~7) > DMAX ? ((D + 7) & ~7) + 4 : DMAX + 4;
}
// rows of the shared mu buffer [zr_of(Z)][BT]
__host__ __device__ constexpr int zr_of(int Z) { return Z > ZMAX ? Z : ZMAX; }

// x rounded to TF32 to nearest, ties away from zero (the low 13 bits zero),
// in two integer operations: equal to cvt.rna.tf32.f32 for every finite x,
// which is all the kernel feeds it, and to the wrapper's tf32_round
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
// products to its accumulator and truncate the sum toward zero (not to
// nearest), so a sum chained through every mma of a product drifts toward
// zero by up to an ulp an mma. The k-steps go in pairs (k, k+1), each pair's
// six mma small terms first: a_s b_b and a_b b_s of k, then of k+1, then
// a_b b_b of k and of k+1.
//   TC_SPLIT:  a pair's six mma chained from zero and that partial added to
//              the sum with a float32 add (round to nearest): the truncation
//              acts on the partial only (the shipping sum);
//   TC_CHAIN:  every mma chained into the one sum;
//   TC_ONE_TERM: a_b b_b alone into the one sum (the probe's planted fault);
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
      big[r] = __float_as_uint(bfr(x[r]));
      sml[r] = 0u;
    } else {
      big[r] = tf32_round(x[r]);
      sml[r] = tf32_round(x[r] - __uint_as_float(big[r]));
    }
  }
}

// acc += the k-step pair's products (A parts a0, a1; B fragments b0, b1)
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

// acc[m][q] += A[rows of tile m][k] W[k][q*H + 8*warp .. +7] over KT k-steps
// of 8: A [BT][lda] in shared memory, W as packed fragments at Bf (n-tile
// nt, k-step kt, lane at (nt*KT + kt)*32 + lane). The warp's four n-tiles
// are the four gates of its 8 units; it loads each fragment once for its MT
// row tiles and splits each A element once for its four n-tiles; the
// k-steps go in pairs in order (an odd KT's last pair multiplies zeros),
// summed as SUM says, no atomics.
template <int H, int MT, int SUM>
__device__ __forceinline__ void gate_mma(float (&acc)[MT][4][4],
                                         const float4* __restrict__ Bf, int KT,
                                         const float* A, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* bw = Bf + (size_t)warp * KT * 32 + lane;
  const size_t gate_stride = (size_t)(H / 8) * KT * 32;
  const float* a0 = A + (lane >> 2) * lda + (lane & 3);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int ks = 0; ks < KT; ks += 2) {
    const bool two = ks + 1 < KT;
    float4 b0[4], b1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b0[q] = __ldg(bw + q * gate_stride + ks * 32);
      b1[q] = two ? __ldg(bw + q * gate_stride + (ks + 1) * 32) : zero;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* p = a0 + m * 16 * lda + ks * 8;
      unsigned big0[4], sml0[4], big1[4], sml1[4];
      split_a<SUM == TC_BF16>(p, lda, true, big0, sml0);
      split_a<SUM == TC_BF16>(p + 8, lda, two, big1, sml1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma_pair<SUM>(acc[m][q], big0, sml0, big1, sml1, b0[q], b1[q]);
    }
  }
}

// acc = the bias of this thread's columns (units 8*warp + 2t, +1 of gate q)
template <int H, int MT>
__device__ __forceinline__ void tc_bias(float (&acc)[MT][4][4], const float* b) {
  const int col = 8 * (threadIdx.x >> 5) + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float b0 = __ldg(b + q * H + col), b1 = __ldg(b + q * H + col + 1);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][q][0] = b0; acc[m][q][1] = b1; acc[m][q][2] = b0; acc[m][q][3] = b1;
    }
  }
}

// The activation forms of the JAX kernel (fused_vae.py:77-121, :146-151),
// chosen by the kernel argument `act`, the same for every thread: bit 0 the
// tanh-form sigmoid 0.5 * (tanh(0.5x) + 1), bit 1 the rational tanh (x
// clamped to +-7, R(7,6) by Horner in JAX's order, one IEEE division) in
// every tanh: the cell's g and c, the tanh-form sigmoid's, and the decoder
// input's. act = 0 is the logistic and tanhf, which the default instances
// (FORMS = false) compute with no switch at all.
constexpr int ACT_SIG_TANH = 1, ACT_TANH_RATIONAL = 2;

__device__ __forceinline__ float tanh_rational(float x) {
  x = fminf(fmaxf(x, -7.0f), 7.0f);
  const float x2 = x * x;
  const float p = x * (0.999996935f + x2 * (0.123091227f + x2 * (2.28254070e-3f
                                                                 + x2 * 3.95225241e-6f)));
  const float q = 1.0f + x2 * (0.456412385f + x2 * (2.10997819e-2f + x2 * 1.42908691e-4f));
  return p / q;
}

__device__ __forceinline__ float form_tanh(float x, int act) {
  return (act & ACT_TANH_RATIONAL) ? tanh_rational(x) : tanhf(x);
}

__device__ __forceinline__ float form_sig(float x, int act) {
  if (act & ACT_SIG_TANH) return 0.5f * (form_tanh(0.5f * x, act) + 1.0f);
  return 1.0f / (1.0f + expf(-x));
}

// the cell update of this thread's 4*MT cells, then h into the shared
// [BT][H+4] buffer hs (after the barrier that ends the reads of h(t-1));
// FORMS: in the forms of `act`, else the logistic and tanhf
template <int H, int MT, bool FORMS>
__device__ __forceinline__ void tc_cell_store(const float (&acc)[MT][4][4],
                                              float (&c)[MT][4], float* hs,
                                              int act) {
  constexpr int HP = H + 4;
  float h[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (FORMS) {
        const float i = form_sig(acc[m][0][r], act);
        const float f = form_sig(acc[m][1][r], act);
        const float gg = form_tanh(acc[m][2][r], act);
        const float o = form_sig(acc[m][3][r], act);
        c[m][r] = f * c[m][r] + i * gg;
        h[m][r] = o * form_tanh(c[m][r], act);
      } else {
        const float i = 1.0f / (1.0f + expf(-acc[m][0][r]));
        const float f = 1.0f / (1.0f + expf(-acc[m][1][r]));
        const float gg = tanhf(acc[m][2][r]);
        const float o = 1.0f / (1.0f + expf(-acc[m][3][r]));
        c[m][r] = f * c[m][r] + i * gg;
        h[m][r] = o * tanhf(c[m][r]);
      }
    }
  __syncthreads();                                  // reads of h(t-1) done
  const int lane = threadIdx.x & 31;
  float* row = hs + (lane >> 2) * HP + 8 * (threadIdx.x >> 5) + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    *reinterpret_cast<float2*>(row + m * 16 * HP) = make_float2(h[m][0], h[m][1]);
    *reinterpret_cast<float2*>(row + (m * 16 + 8) * HP) = make_float2(h[m][2], h[m][3]);
  }
  __syncthreads();                                  // h(t) visible
}

template <int H, int MT>
constexpr size_t tc_smem_bytes(int D, int Z) {
  constexpr int BT = 16 * MT;
  return sizeof(float) * (2 * BT * (H + 4) + BT * 4 * H + BT * xp_of(D) + zr_of(Z) * BT);
}

// The residual's two layouts: [N][T][D] (tr = 0), or (tr = 1) [T][DPT][N]
// with DPT = D rounded up to 16 (the rows past D written as zeros), as the
// JAX kernel's residual_layout="transposed" returns its tile. Only the output
// head's slots change: with tr = 0 slot i is (b = i / D, d = i % D); with
// tr = 1 a warp's 32 slots are 8 windows x 4 rows d (TrSlot), so each of its
// stores is 8 consecutive n of one (t, d) and the lanes of one window read
// the same h row (a broadcast). Each slot sums its e^2 over t in order and
// the mse sums a window's slots over d in order either way, so the mse is
// the same bit for bit.
template <int BT>
struct TrSlot {
  int b, d;
  __device__ __forceinline__ explicit TrSlot(int i)
      : b((i & 7) + 8 * ((i >> 5) % (BT / 8))),
        d(((i >> 3) & 3) + 4 * ((i >> 5) / (BT / 8))) {}
};

template <int H, int MT, int SUM, typename IOT, bool FORMS>
__global__ void __launch_bounds__(4 * H, 1)
fused_vae_tc_kernel(const IOT* __restrict__ x, IOT* __restrict__ resid,
                    float* __restrict__ mse, const VaeWeights<float> Wt, int N,
                    int T, int D, int Z, int L, int use_ln, int with_resid,
                    float ln_eps, int act, int tr, int h_real) {
  constexpr bool BF = SUM == TC_BF16;   // the heads' operands rounded too
  constexpr int NT = 4 * H;
  constexpr int BT = 16 * MT;
  constexpr int HP = H + 4;       // padded row of the shared h buffers
  constexpr int KH = H / 8;       // k-steps of a product over H
  constexpr int IO_SLOTS = (DMAX * BT + NT - 1) / NT;   // slots in registers

  const int XPD = xp_of(D);       // padded row of the x tile
  extern __shared__ __align__(16) float smem[];
  float* const hs[2] = {smem, smem + BT * HP};      // [BT][HP] each
  float* const xpc = smem + 2 * BT * HP;            // [BT*4H], accumulator order
  float* const xs = xpc + BT * 4 * H;               // [BT][XPD]
  float* const mus = xs + BT * XPD;                 // [zr_of(Z)][BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BT;
  const int DP = (D + 7) & ~7;                      // x's k, zero-padded
  const int DPT = (D + 15) & ~15;                   // rows of a transposed residual
  const int slots = (tr ? DPT : D) * BT;            // the output head's slots
  // the output head's slot i: thread slot (b, d), d fastest, or under tr
  // TrSlot's; a slot past the registers' sums its e^2 in xs[d * BT + b]
  auto slot_of = [&](int i, int& b, int& d) {
    const TrSlot<BT> ts(i);
    d = tr ? ts.d : i % D;
    b = tr ? ts.b : i / D;
  };

  for (int i = tid; i < 2 * BT * HP; i += NT) smem[i] = 0.0f;
  float c[2][MT][4];
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[l][m][r] = 0.0f;
  __syncthreads();

  // ---------------- encoder: all layers advance inside one time loop
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < BT * DP; i += NT) {       // x_t tile -> xs[b][d]
      const int d = i % DP, b = i / DP;
      const int n = n0 + b;
      xs[b * XPD + d] = (n < N && d < D) ? ld_io(x + ((size_t)n * T + t) * D + d) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
      float acc[MT][4][4];
      tc_bias<H, MT>(acc, Wt.enc_b[l]);
      if (l == 0)
        gate_mma<H, MT, SUM>(acc, Wt.enc_wih_f[0], DP / 8, xs, XPD);
      else
        gate_mma<H, MT, SUM>(acc, Wt.enc_wih_f[1], KH, hs[0], HP);
      gate_mma<H, MT, SUM>(acc, Wt.enc_whh_f[l], KH, hs[l], HP);
      tc_cell_store<H, MT, FORMS>(acc, c[l], hs[l], act);
    }
  }

  // ---------------- LayerNorm over the h_real real units + latent head
  // (z = mu); a padded unit's h stays 0
  float* const hl = smem + (L - 1) * BT * HP;       // hs[L - 1]
  if (use_ln) {
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
      const float r = 1.0f / sqrtf(v + ln_eps);
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
  // decoder input tanh(fc_latent_to_hidden(mu)) -> hs[0] (encoder state is dead)
  for (int i = tid; i < H * BT; i += NT) {
    const int k = i % H, b = i / H;
    float s = __ldg(Wt.z2h_b + k);
    for (int z = 0; z < Z; ++z)
      s = fmaf(rd<BF>(__ldg(Wt.z2h_w + z * H + k)), rd<BF>(mus[z * BT + b]), s);
    if constexpr (FORMS)
      hs[0][b * HP + k] = form_tanh(s, act);
    else
      hs[0][b * HP + k] = tanhf(s);
  }
  __syncthreads();
  // decoder layer-0 input projection, once: xpc = dec_in @ W_ih0 + b0, kept
  // in shared memory in this thread's accumulator order
  {
    float acc[MT][4][4];
    tc_bias<H, MT>(acc, Wt.dec_b[0]);
    gate_mma<H, MT, SUM>(acc, Wt.dec_wih_f[0], KH, hs[0], HP);
    float4* dst = reinterpret_cast<float4*>(xpc) + warp * MT * 4 * 32 + lane;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[(m * 4 + q) * 32] = make_float4(acc[m][q][0], acc[m][q][1],
                                            acc[m][q][2], acc[m][q][3]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * BT * HP; i += NT) smem[i] = 0.0f;
  for (int i = tid + IO_SLOTS * NT; i < slots; i += NT) {   // xs is free now
    int b, d;
    slot_of(i, b, d);
    if (d < D) xs[d * BT + b] = 0.0f;
  }
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[l][m][r] = 0.0f;
  __syncthreads();

  // ---------------- decoder scan + output head + residual + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;
  const float* const hout = hl;
  const float4* const xpc_t = reinterpret_cast<const float4*>(xpc) + warp * MT * 4 * 32 + lane;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
      float acc[MT][4][4];
      if (l == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = xpc_t[(m * 4 + q) * 32];
            acc[m][q][0] = v.x; acc[m][q][1] = v.y; acc[m][q][2] = v.z; acc[m][q][3] = v.w;
          }
      } else {
        tc_bias<H, MT>(acc, Wt.dec_b[1]);
        gate_mma<H, MT, SUM>(acc, Wt.dec_wih_f[1], KH, hs[0], HP);
      }
      gate_mma<H, MT, SUM>(acc, Wt.dec_whh_f[l], KH, hs[l], HP);
      tc_cell_store<H, MT, FORMS>(acc, c[l], hs[l], act);
    }
    // output head for step t: reads hout before the next step's first
    // barrier, after which it may be overwritten
    auto head = [&](int i, float& acc) {
      int b, d;
      slot_of(i, b, d);
      const int n = n0 + b;
      if (d >= D) {                                 // a transposed pad row
        if (with_resid && n < N) st_io(resid + ((size_t)t * DPT + d) * N + n, 0.0f);
        return;
      }
      float y = __ldg(Wt.out_b + d);
      for (int k = 0; k < H; ++k)
        y = fmaf(rd<BF>(__ldg(Wt.out_w + k * D + d)), rd<BF>(hout[b * HP + k]), y);
      if (n < N) {
        const size_t off = ((size_t)n * T + t) * D + d;
        const float e = ld_io(x + off) - y;
        const float e2 = e * e;
        if (with_resid)
          st_io(resid + (tr ? ((size_t)t * DPT + d) * N + n : off), e2);
        acc += e2;
      }
    };
#pragma unroll
    for (int r = 0; r < IO_SLOTS; ++r) {
      const int i = tid + r * NT;
      if (i < slots) head(i, acc_mse[r]);
    }
    for (int i = tid + IO_SLOTS * NT; i < slots; i += NT) {
      int b, d;
      slot_of(i, b, d);
      head(i, xs[(d < D ? d : 0) * BT + b]);        // a pad row adds nothing
    }
  }

  // per-window MSE: sum the D partials of each window, d in order (the
  // slots past the registers' already in place)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) {
    const int i = tid + r * NT;
    if (i < slots) {
      int b, d;
      slot_of(i, b, d);
      if (d < D) xs[d * BT + b] = acc_mse[r];
    }
  }
  __syncthreads();
  if (tid < BT && n0 + tid < N) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s += xs[d * BT + tid];
    mse[n0 + tid] = s / (float)(T * D);
  }
}

template <int H, int MT, int SUM, typename IOT = float, bool FORMS = false>
cudaError_t launch_tc(const IOT* x, IOT* resid, float* mse,
                      const VaeWeights<float>& W, int N, int T, int D, int Z,
                      int L, int use_ln, int with_resid, float ln_eps,
                      cudaStream_t stream, int act = 0, int tr = 0,
                      int h_real = H) {
  const size_t smem = tc_smem_bytes<H, MT>(D, Z);
  auto kern = fused_vae_tc_kernel<H, MT, SUM, IOT, FORMS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BT = 16 * MT;
  kern<<<(N + BT - 1) / BT, 4 * H, smem, stream>>>(
      x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, ln_eps, act, tr,
      h_real);
  return cudaGetLastError();
}

template <typename WT>
VaeWeights<WT> unpack_weights(const void* const* p) {
  VaeWeights<WT> W;
  for (int l = 0; l < 2; ++l) {
    W.enc_wih[l] = static_cast<const WT*>(p[3 * l + 0]);
    W.enc_whh[l] = static_cast<const WT*>(p[3 * l + 1]);
    W.enc_b[l] = static_cast<const float*>(p[3 * l + 2]);
    W.dec_wih[l] = static_cast<const WT*>(p[12 + 3 * l + 0]);
    W.dec_whh[l] = static_cast<const WT*>(p[12 + 3 * l + 1]);
    W.dec_b[l] = static_cast<const float*>(p[12 + 3 * l + 2]);
  }
  W.ln_scale = static_cast<const float*>(p[6]);
  W.ln_bias = static_cast<const float*>(p[7]);
  W.mu_w = static_cast<const WT*>(p[8]);
  W.mu_b = static_cast<const float*>(p[9]);
  W.z2h_w = static_cast<const WT*>(p[10]);
  W.z2h_b = static_cast<const float*>(p[11]);
  W.out_w = static_cast<const WT*>(p[18]);
  W.out_b = static_cast<const float*>(p[19]);
  for (int l = 0; l < 2; ++l) {
    W.enc_wih_f[l] = static_cast<const float4*>(p[20 + 2 * l]);
    W.enc_whh_f[l] = static_cast<const float4*>(p[21 + 2 * l]);
    W.dec_wih_f[l] = static_cast<const float4*>(p[24 + 2 * l]);
    W.dec_whh_f[l] = static_cast<const float4*>(p[25 + 2 * l]);
  }
  return W;
}

// a probe variant of the FMA body (H = PROBE_H, 2 layers, LayerNorm on)
template <class V>
cudaError_t launch_probe(const float* x, float* mse, const void* const* w, int N,
                         int T, int D, int Z, float ln_eps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<V>();
  auto kern = fused_vae_fma_kernel<V>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int BT = V::IL * SUB;
  kern<<<(N + BT - 1) / BT, NG * PROBE_H, smem, stream>>>(
      x, mse, unpack_weights<typename V::WT>(w), N, T, D, Z, ln_eps);
  return cudaGetLastError();
}

template <int IL>
cudaError_t launch_probe_rnd(const float* x, float* mse, const void* const* w,
                             int N, int T, int D, int Z, int sig_tanh,
                             int act_bf16, float eps, cudaStream_t s) {
  if (sig_tanh)
    return act_bf16
        ? launch_probe<Variant<bf16_t, true, true, true, IL>>(x, mse, w, N, T, D, Z, eps, s)
        : launch_probe<Variant<bf16_t, true, true, false, IL>>(x, mse, w, N, T, D, Z, eps, s);
  return act_bf16
      ? launch_probe<Variant<bf16_t, true, false, true, IL>>(x, mse, w, N, T, D, Z, eps, s)
      : launch_probe<Variant<bf16_t, true, false, false, IL>>(x, mse, w, N, T, D, Z, eps, s);
}

// The shipping instance: 2 row tiles a block (32 windows), each pair of
// k-steps' six mma summed apart and added to the float32 sum to nearest.
constexpr int SHIP_MT = 2;
constexpr int SHIP_SUM = TC_SPLIT;

// the shipping instance of a sum and io type at width H: the default one
// for act = 0, the forms' one (FORMS, act read at run time) for any other
template <int H, int SUM, typename IOT>
cudaError_t launch_act(const IOT* x, IOT* resid, float* mse,
                       const VaeWeights<float>& W, int N, int T, int D, int Z,
                       int L, int use_ln, int with_resid, float ln_eps,
                       int act, int tr, int h_real, cudaStream_t s) {
  if (act == 0)
    return launch_tc<H, SHIP_MT, SUM, IOT, false>(x, resid, mse, W, N, T, D, Z, L, use_ln,
                                                  with_resid, ln_eps, s, 0, tr, h_real);
  return launch_tc<H, SHIP_MT, SUM, IOT, true>(x, resid, mse, W, N, T, D, Z, L, use_ln,
                                               with_resid, ln_eps, s, act, tr, h_real);
}

template <int H>
cudaError_t launch_ship(const float* x, float* resid, float* mse,
                        const VaeWeights<float>& W, int N, int T, int D, int Z,
                        int L, int use_ln, int with_resid, float ln_eps,
                        int act, int tr, int h_real, cudaStream_t s) {
  return launch_act<H, SHIP_SUM, float>(x, resid, mse, W, N, T, D, Z, L, use_ln,
                                        with_resid, ln_eps, act, tr, h_real, s);
}

// the bf16 instance, at the shipping tile, with float32 or bf16 io
template <int H>
cudaError_t launch_bf16(const void* x, void* resid, float* mse,
                        const VaeWeights<float>& W, int N, int T, int D, int Z,
                        int L, int use_ln, int with_resid, int io_bf16,
                        float ln_eps, int act, int tr, int h_real, cudaStream_t s) {
  if (io_bf16)
    return launch_act<H, TC_BF16, bf16_t>(
        static_cast<const bf16_t*>(x), static_cast<bf16_t*>(resid), mse, W, N,
        T, D, Z, L, use_ln, with_resid, ln_eps, act, tr, h_real, s);
  return launch_act<H, TC_BF16, float>(
      static_cast<const float*>(x), static_cast<float*>(resid), mse, W, N, T,
      D, Z, L, use_ln, with_resid, ln_eps, act, tr, h_real, s);
}

template <int H, int MT, int SUM, typename IOT, bool FORMS>
cudaError_t tc_info(int D, int Z, int* out) {
  auto kern = fused_vae_tc_kernel<H, MT, SUM, IOT, FORMS>;
  const size_t smem = tc_smem_bytes<H, MT>(D, Z);
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
  return cudaSuccess;
}

}  // namespace

// C entry for ctypes. `w` holds NUM_W device pointers in the order
//   enc_wih0 enc_whh0 enc_b0 enc_wih1 enc_whh1 enc_b1 ln_scale ln_bias
//   mu_w mu_b z2h_w z2h_b dec_wih0 dec_whh0 dec_b0 dec_wih1 dec_whh1 dec_b1
//   out_w out_b, then the fragments (16-byte aligned) of enc_wih0 enc_whh0
//   enc_wih1 enc_whh1 dec_wih0 dec_whh0 dec_wih1 dec_whh1
// (layer-1 and LayerNorm pointers may be null when unused; the LSTM
// matrices as given are the plain version's, the kernel reads their
// fragments). H is the instance's width (32, 64 or 128) and the weights'
// with their padding; h_real <= H the model's, over which LayerNorm
// normalises. `act` is the activation forms (0 to 3: ACT_SIG_TANH |
// ACT_TANH_RATIONAL), `layout` the residual's (0: [N][T][D]; 1:
// [T][DPT][N], DPT = D rounded up to 16). Launches the tensor-core body;
// returns the launch's cudaGetLastError(), 0 on success.
static bool gate_args_ok(int n_w, int N, int T, int D, int H, int h_real,
                         int Z, int L, int with_resid, const void* resid,
                         int act, int layout) {
  return n_w == NUM_W && N > 0 && T > 0 && D > 0 && D <= DLIM && Z > 0 &&
         Z <= ZLIM && L >= 1 && L <= 2 && !(with_resid && resid == nullptr) &&
         act >= 0 && act <= 3 && (layout == 0 || layout == 1) && h_real >= 1 &&
         h_real <= H;
}

extern "C" int shm_fused_vae_gate_f32(const float* x, float* resid, float* mse,
                                      const void* const* w, int n_w, int N,
                                      int T, int D, int H, int h_real, int Z,
                                      int L, int use_ln, int with_resid,
                                      int act, int layout, void* stream) {
  if (!gate_args_ok(n_w, N, T, D, H, h_real, Z, L, with_resid, resid, act, layout))
    return (int)cudaErrorInvalidValue;
  const VaeWeights<float> W = unpack_weights<float>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr float eps = 1e-5f;                        // the model's LayerNorm
  switch (H) {
    case 32: return (int)launch_ship<32>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, act, layout, h_real, s);
    case 64: return (int)launch_ship<64>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, act, layout, h_real, s);
    case 128: return (int)launch_ship<128>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, act, layout, h_real, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The C entry of the bf16 instance: the arguments of shm_fused_vae_gate_f32
// with `w`'s fragments those of the bf16-rounded weights, x and resid bf16
// when io_bf16 is 1 and float32 when it is 0. Returns the launch's
// cudaGetLastError(), 0 on success.
extern "C" int shm_fused_vae_gate_bf16(const void* x, void* resid, float* mse,
                                       const void* const* w, int n_w, int N,
                                       int T, int D, int H, int h_real, int Z,
                                       int L, int use_ln, int with_resid,
                                       int act, int layout, int io_bf16,
                                       void* stream) {
  if (!gate_args_ok(n_w, N, T, D, H, h_real, Z, L, with_resid, resid, act, layout) ||
      (io_bf16 != 0 && io_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const VaeWeights<float> W = unpack_weights<float>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr float eps = 1e-5f;                        // the model's LayerNorm
  switch (H) {
    case 32: return (int)launch_bf16<32>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, io_bf16, eps, act, layout, h_real, s);
    case 64: return (int)launch_bf16<64>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, io_bf16, eps, act, layout, h_real, s);
    case 128: return (int)launch_bf16<128>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, io_bf16, eps, act, layout, h_real, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H, bool FORMS>
cudaError_t ship_info_of(int D, int Z, int bf16, int io_bf16, int* out) {
  if (!bf16) return tc_info<H, SHIP_MT, SHIP_SUM, float, FORMS>(D, Z, out);
  if (io_bf16) return tc_info<H, SHIP_MT, TC_BF16, bf16_t, FORMS>(D, Z, out);
  return tc_info<H, SHIP_MT, TC_BF16, float, FORMS>(D, Z, out);
}

template <int H>
cudaError_t ship_info(int D, int Z, int bf16, int io_bf16, int forms, int* out) {
  return forms ? ship_info_of<H, true>(D, Z, bf16, io_bf16, out)
               : ship_info_of<H, false>(D, Z, bf16, io_bf16, out);
}

// out = registers a thread, local memory (spill) bytes a thread, threads a
// block, dynamic shared bytes a block, windows a block and blocks an SM at
// once of a shipping instance for windows of T steps of D features at width
// H with L layers and Z latents (its registers depend on H alone, its shared
// memory on H, D and Z): the float32 one (bf16 = 0) or the bf16 one with
// float32 or bf16 io, of the default forms (forms = 0) or of the others
// (forms = 1).
extern "C" int shm_fused_vae_info(int T, int H, int L, int D, int Z, int bf16,
                                  int io_bf16, int forms, int* out) {
  if (T < 1 || L < 1 || L > 2 || D < 1 || D > DLIM || Z < 1 || Z > ZLIM ||
      (bf16 != 0 && bf16 != 1) || (io_bf16 != 0 && io_bf16 != 1) ||
      (io_bf16 && !bf16) || (forms != 0 && forms != 1))
    return (int)cudaErrorInvalidValue;
  switch (H) {
    case 32: return (int)ship_info<32>(D, Z, bf16, io_bf16, forms, out);
    case 64: return (int)ship_info<64>(D, Z, bf16, io_bf16, forms, out);
    case 128: return (int)ship_info<128>(D, Z, bf16, io_bf16, forms, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry of the probe variants (gate-only, 2 layers, LayerNorm on, H = 128),
// `w` as above. `numerics`: 0 = float32 on the FMA pipes (the instance F32),
// 1 = bf16 weights only, 2 = bf16 weights and operands (the TPU probe's),
// 3, 4, 5 = the tensor-core body with its sum TC_CHAIN, TC_SPLIT (the
// shipping instance), TC_ONE_TERM (interleave 1). sig_tanh and act_bf16 take
// numerics 2; interleave is 1 or 2. Returns the launch's cudaGetLastError(),
// 0 on success.
extern "C" int shm_fused_vae_probe(const float* x, float* mse, const void* const* w,
                                   int n_w, int N, int T, int D, int H, int Z,
                                   int numerics, int sig_tanh, int interleave,
                                   int act_bf16, float ln_eps, void* stream) {
  if (n_w != NUM_W || N <= 0 || T < 1 || D <= 0 || D > DMAX || H != PROBE_H ||
      Z <= 0 || Z > ZMAX || numerics < 0 || numerics > 5 ||
      (interleave != 1 && interleave != 2) || (numerics >= 3 && interleave != 1) ||
      (numerics != 2 && (sig_tanh || act_bf16)) || !(ln_eps > 0.0f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (numerics >= 3) {
    const VaeWeights<float> W = unpack_weights<float>(w);
    switch (numerics - 3) {
      case TC_CHAIN:
        return (int)launch_tc<PROBE_H, SHIP_MT, TC_CHAIN, float>(x, nullptr, mse, W, N, T, D, Z, 2, 1, 0, ln_eps, s);
      case TC_SPLIT:
        return (int)launch_tc<PROBE_H, SHIP_MT, TC_SPLIT, float>(x, nullptr, mse, W, N, T, D, Z, 2, 1, 0, ln_eps, s);
      default:
        return (int)launch_tc<PROBE_H, SHIP_MT, TC_ONE_TERM, float>(x, nullptr, mse, W, N, T, D, Z, 2, 1, 0, ln_eps, s);
    }
  }
  if (numerics == 2)
    return (int)(interleave == 1
                     ? launch_probe_rnd<1>(x, mse, w, N, T, D, Z, sig_tanh, act_bf16, ln_eps, s)
                     : launch_probe_rnd<2>(x, mse, w, N, T, D, Z, sig_tanh, act_bf16, ln_eps, s));
  if (numerics == 1)
    return (int)(interleave == 1
                     ? launch_probe<Variant<bf16_t, false, false, false, 1>>(x, mse, w, N, T, D, Z, ln_eps, s)
                     : launch_probe<Variant<bf16_t, false, false, false, 2>>(x, mse, w, N, T, D, Z, ln_eps, s));
  return (int)(interleave == 1
                   ? launch_probe<F32>(x, mse, w, N, T, D, Z, ln_eps, s)
                   : launch_probe<Variant<float, false, false, false, 2>>(x, mse, w, N, T, D, Z, ln_eps, s));
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
