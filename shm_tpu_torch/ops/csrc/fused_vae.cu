// Fused deterministic LSTM-VAE gate for Hopper (sm_90a), float32, and the
// numerics variants that attribute its time.
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
// L in {1,2}, H in {32,64,128} (template), D <= 16, Z <= 32, any T.
// Weights come in the flax layout [in, out] (LSTM: w_ih [in,4H],
// w_hh [H,4H], gate order i|f|g|o, bias = b_ih + b_hh).
//
// It also replaces the TPU probe kernel tools/probe_vpu_bound.py::
// _make_gate_kernel (:51, body :76), launched by gate_variant (:166,
// pallas_call at :191): the gate-only 2-layer pass with LayerNorm at H=128,
// with the probe's numerics and knobs. They are template knobs of this one
// kernel body (struct Variant), so every variant times the shipping kernel's
// own code; the shipping gate is the instance with every knob off:
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
// LayerNorm's eps is an argument: the model's 1e-5 for the gate; the TPU
// probe has 1e-6 (probe_vpu_bound.py:118), which its port keeps.
//
// Bound on this card. Per window the matmul work is, for the 4DOF preset
// (T=100, D=12, H=128, Z=16, L=2), 2*T*4H*(D+H) + 2*T*4H*2H (encoder)
// + 2*2*H*Z + 2*4H*H (heads, decoder input) + T*(2*4H*H + 2*4H*2H + 2*D*H)
// (decoder scan and head), about 80.3 MFLOP; at N=5,440 that is about
// 437 GFLOP, which is ~6.5 ms at the 67 TFLOP/s float32 rate without tensor
// cores (~0.44 ms if it ran in bf16 on the tensor cores at 989 TFLOP/s).
// The bytes are ~53 MB in and out (x, resid, weights once), ~16 us at
// 3.35 TB/s. So the kernel is bound by operations, and the serial chain of
// 2*L*T dependent cell steps bounds its latency as well. The probe variants
// with bf16 operands have the bf16 bound (1.77 ms at the probe's N=21,760)
// but still run their products on the FMA pipes.
//
// Design (first, simple version: right before fast). One thread block owns a
// tile of BT=32*IL windows and runs the whole T-step loop of every layer for
// it, so nothing but x, resid and mse touches device memory per window:
//   * threads = 4*H; thread (j, g) owns hidden unit j for the BW=8 windows of
//     group g (of each sub-tile). It accumulates all four gates i|f|g|o of
//     unit j (4*8 sums in registers), so the cell update runs in registers
//     with no gate round trip through shared memory, and c stays in
//     registers for the whole loop;
//   * h of every layer lives in shared memory as [H][BT+4] (the pad keeps the
//     float4 stores conflict-free); the matvec reads h[k][8 windows] as two
//     float4 broadcasts per k and each weight once per k, so every weight
//     load feeds 8*IL FMAs and every shared load 4;
//   * weights are read from global memory through L1/L2 (coalesced: thread j
//     reads column q*H+j of row k). At H=128 one layer's f32 W_hh is 256 KiB,
//     more than the 227 KiB of shared memory a block can hold, while all the
//     weights together (~1.3 MB) sit in the 50 MB L2;
//   * BT=32 gives 170 blocks at N=5,440, more than the 132 SMs.
// Against the bound: it runs the f32 FMA pipes, not the tensor cores, so it
// cannot pass the ~6.5 ms f32 bound; wgmma with bf16 operands, TMA and
// weights resident in shared memory across a cluster are later work.
//
// Accurate expf/tanhf (no --use_fast_math); sigmoid(x) = 1/(1+exp(-x)).

#include <cuda_runtime.h>

namespace {

constexpr int BW = 8;           // windows per thread per sub-tile
constexpr int NG = 4;           // window groups per sub-tile (threads = NG*H)
constexpr int SUB = NG * BW;    // windows per sub-tile (32)
constexpr int DMAX = 16;
constexpr int ZMAX = 32;
constexpr int NUM_W = 20;
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
using Shipping = Variant<float, false, false, false, 1>;

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

template <int H, class V>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * H * (V::IL * SUB + 4) + (DMAX + ZMAX) * V::IL * SUB);
}

template <int H, class V>
__global__ void __launch_bounds__(NG * H)
fused_vae_gate_kernel(const float* __restrict__ x, float* __restrict__ resid,
                      float* __restrict__ mse, const VaeWeights<typename V::WT> Wt,
                      int N, int T, int D, int Z, int L, int use_ln,
                      int with_resid, float ln_eps) {
  constexpr int IL = V::IL;
  constexpr int NT = NG * H;
  constexpr int BT = IL * SUB;
  constexpr int BTP = BT + 4;     // padded row of the shared h buffers
  constexpr int IO_SLOTS = (DMAX * BT + NT - 1) / NT;

  // 43 KB at IL = 1 and H = 128; 82 KB at IL = 2 (past the 48 KB static limit)
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

  // ---------------- encoder: all layers advance inside one time loop
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < D * BT; i += NT) {         // x_t tile -> xs[d][b]
      const int b = i % BT, d = i / BT;
      const int n = n0 + b;
      xs[d * BT + b] = n < N ? rd<V::RND>(x[((size_t)n * T + t) * D + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
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
      store_h<V>(hs[l], h, BTP, j, g, l == L - 1 && t == T - 1);
      __syncthreads();                                // h(t) visible
    }
  }

  // ---------------- LayerNorm over H + latent head (z = mu)
  float* const hl = smem + (L - 1) * H * BTP;
  if (use_ln) {
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
  }
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

  // ---------------- decoder scan + output head + residual + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;
  const float* const hout = hl;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
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
    // output head for step t: thread slot (b, d); reads hout before the next
    // step's first barrier, after which it may be overwritten
#pragma unroll
    for (int r = 0; r < IO_SLOTS; ++r) {
      const int i = tid + r * NT;
      if (i < D * BT) {
        const int b = i % BT, d = i / BT;
        const int n = n0 + b;
        float y = __ldg(Wt.out_b + d);
        for (int k = 0; k < H; ++k) y = fmaf(ldw(Wt.out_w + k * D + d), hout[k * BTP + b], y);
        if (n < N) {
          const size_t off = ((size_t)n * T + t) * D + d;
          const float e = rd<V::RND>(x[off]) - y;
          const float e2 = e * e;
          if (with_resid) resid[off] = e2;
          acc_mse[r] += e2;
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

template <int H, class V>
cudaError_t launch(const float* x, float* resid, float* mse,
                   const VaeWeights<typename V::WT>& W, int N, int T, int D,
                   int Z, int L, int use_ln, int with_resid, float ln_eps,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H, V>();
  auto kern = fused_vae_gate_kernel<H, V>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int BT = V::IL * SUB;
  kern<<<(N + BT - 1) / BT, NG * H, smem, stream>>>(
      x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, ln_eps);
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
  return W;
}

// a probe variant: 2 layers, LayerNorm on, no residual, H = PROBE_H
template <class V>
cudaError_t launch_probe(const float* x, float* mse, const void* const* w, int N,
                         int T, int D, int Z, float ln_eps, cudaStream_t s) {
  return launch<PROBE_H, V>(x, nullptr, mse, unpack_weights<typename V::WT>(w), N,
                            T, D, Z, 2, 1, 0, ln_eps, s);
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

}  // namespace

// C entry for ctypes. `w` holds NUM_W device pointers in the order
//   enc_wih0 enc_whh0 enc_b0 enc_wih1 enc_whh1 enc_b1 ln_scale ln_bias
//   mu_w mu_b z2h_w z2h_b dec_wih0 dec_whh0 dec_b0 dec_wih1 dec_whh1 dec_b1
//   out_w out_b
// (layer-1 and LayerNorm pointers may be null when unused). Returns the
// launch's cudaGetLastError(), 0 on success.
extern "C" int shm_fused_vae_gate_f32(const float* x, float* resid, float* mse,
                                      const void* const* w, int n_w, int N,
                                      int T, int D, int H, int Z, int L,
                                      int use_ln, int with_resid,
                                      void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || Z <= 0 ||
      Z > ZMAX || L < 1 || L > 2 || (with_resid && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  const VaeWeights<float> W = unpack_weights<float>(w);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr float eps = 1e-5f;                        // the model's LayerNorm
  cudaError_t err;
  switch (H) {
    case 32: err = launch<32, Shipping>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, s); break;
    case 64: err = launch<64, Shipping>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, s); break;
    case 128: err = launch<128, Shipping>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// C entry of the probe variants (gate-only, 2 layers, LayerNorm on, H = 128),
// `w` as above. `numerics`: 0 = float32 (the shipping instance), 1 = bf16
// weights only, 2 = bf16 weights and operands (the TPU probe's). sig_tanh and
// act_bf16 take numerics 2; interleave is 1 or 2. Returns the launch's
// cudaGetLastError(), 0 on success.
extern "C" int shm_fused_vae_probe(const float* x, float* mse, const void* const* w,
                                   int n_w, int N, int T, int D, int H, int Z,
                                   int numerics, int sig_tanh, int interleave,
                                   int act_bf16, float ln_eps, void* stream) {
  if (n_w != NUM_W || N <= 0 || T < 1 || D <= 0 || D > DMAX || H != PROBE_H ||
      Z <= 0 || Z > ZMAX || numerics < 0 || numerics > 2 ||
      (interleave != 1 && interleave != 2) ||
      (numerics != 2 && (sig_tanh || act_bf16)) || !(ln_eps > 0.0f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (numerics == 2)
    return (int)(interleave == 1
                     ? launch_probe_rnd<1>(x, mse, w, N, T, D, Z, sig_tanh, act_bf16, ln_eps, s)
                     : launch_probe_rnd<2>(x, mse, w, N, T, D, Z, sig_tanh, act_bf16, ln_eps, s));
  if (numerics == 1)
    return (int)(interleave == 1
                     ? launch_probe<Variant<bf16_t, false, false, false, 1>>(x, mse, w, N, T, D, Z, ln_eps, s)
                     : launch_probe<Variant<bf16_t, false, false, false, 2>>(x, mse, w, N, T, D, Z, ln_eps, s));
  return (int)(interleave == 1
                   ? launch_probe<Shipping>(x, mse, w, N, T, D, Z, ln_eps, s)
                   : launch_probe<Variant<float, false, false, false, 2>>(x, mse, w, N, T, D, Z, ln_eps, s));
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
