// Fused deterministic LSTM-VAE gate for Hopper (sm_90a), float32.
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
// Bound on this card. Per window the matmul work is, for the 4DOF preset
// (T=100, D=12, H=128, Z=16, L=2), 2*T*4H*(D+H) + 2*T*4H*2H (encoder)
// + 2*2*H*Z + 2*4H*H (heads, decoder input) + T*(2*4H*H + 2*4H*2H + 2*D*H)
// (decoder scan and head), about 80.3 MFLOP; at N=5,440 that is about
// 437 GFLOP, which is ~6.5 ms at the 67 TFLOP/s float32 rate without tensor
// cores (~0.44 ms if it ran in bf16 on the tensor cores at 989 TFLOP/s).
// The bytes are ~53 MB in and out (x, resid, weights once), ~16 us at
// 3.35 TB/s. So the kernel is bound by operations, and the serial chain of
// 2*L*T dependent cell steps bounds its latency as well.
//
// Design (first, simple version: right before fast). One thread block owns a
// tile of BT=32 windows and runs the whole T-step loop of every layer for it,
// so nothing but x, resid and mse touches device memory per window:
//   * threads = 4*H; thread (j, g) owns hidden unit j for the BW=8 windows of
//     group g. It accumulates all four gates i|f|g|o of unit j (4*8 sums in
//     registers), so the cell update runs in registers with no gate round
//     trip through shared memory, and c stays in registers for the whole loop;
//   * h of every layer lives in shared memory as [H][BT+4] (the pad keeps the
//     float4 stores conflict-free); the matvec reads h[k][8 windows] as two
//     float4 broadcasts per k and each weight once per k, so every weight
//     load feeds 8 FMAs and every shared load 4;
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

constexpr int BT = 32;          // windows per block
constexpr int BW = 8;           // windows per thread
constexpr int NG = BT / BW;     // window groups per block (threads = NG*H)
constexpr int BTP = BT + 4;     // padded row of the shared h buffers
constexpr int DMAX = 16;
constexpr int ZMAX = 32;
constexpr int NUM_W = 20;

struct VaeWeights {
  const float* enc_wih[2];
  const float* enc_whh[2];
  const float* enc_b[2];
  const float* ln_scale;
  const float* ln_bias;
  const float* mu_w;    // [H, Z]
  const float* mu_b;    // [Z]
  const float* z2h_w;   // [Z, H]
  const float* z2h_b;   // [H]
  const float* dec_wih[2];
  const float* dec_whh[2];
  const float* dec_b[2];
  const float* out_w;   // [H, D]
  const float* out_b;   // [D]
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[q][w] += sum_k W[k][q*H + j] * s[k][g*BW + w] for k < K
// (W row-major [K, 4H]; s is a shared [K][ld] buffer).
template <int H>
__device__ __forceinline__ void gate_matvec(float (&acc)[4][BW],
                                            const float* __restrict__ W, int K,
                                            const float* s, int ld, int j,
                                            int g) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* wr = W + (size_t)k * 4 * H + j;
    const float w0 = __ldg(wr), w1 = __ldg(wr + H), w2 = __ldg(wr + 2 * H),
                w3 = __ldg(wr + 3 * H);
    const float4 a = *reinterpret_cast<const float4*>(s + k * ld + g * BW);
    const float4 b = *reinterpret_cast<const float4*>(s + k * ld + g * BW + 4);
    const float v[BW] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      acc[0][w] = fmaf(w0, v[w], acc[0][w]);
      acc[1][w] = fmaf(w1, v[w], acc[1][w]);
      acc[2][w] = fmaf(w2, v[w], acc[2][w]);
      acc[3][w] = fmaf(w3, v[w], acc[3][w]);
    }
  }
}

__device__ __forceinline__ void cell_update(const float (&acc)[4][BW],
                                            float (&c)[BW], float (&h)[BW]) {
#pragma unroll
  for (int w = 0; w < BW; ++w) {
    const float i = sigmoid_f(acc[0][w]);
    const float f = sigmoid_f(acc[1][w]);
    const float gg = tanhf(acc[2][w]);
    const float o = sigmoid_f(acc[3][w]);
    c[w] = f * c[w] + i * gg;
    h[w] = o * tanhf(c[w]);
  }
}

__device__ __forceinline__ void store_h(float* hs, const float (&h)[BW], int j,
                                        int g) {
  float4* p = reinterpret_cast<float4*>(hs + j * BTP + g * BW);
  p[0] = make_float4(h[0], h[1], h[2], h[3]);
  p[1] = make_float4(h[4], h[5], h[6], h[7]);
}

template <int H>
__global__ void __launch_bounds__(NG * H)
fused_vae_gate_kernel(const float* __restrict__ x, float* __restrict__ resid,
                      float* __restrict__ mse, const VaeWeights Wt, int N,
                      int T, int D, int Z, int L, int use_ln,
                      int with_resid) {
  constexpr int NT = NG * H;
  constexpr int IO_SLOTS = (DMAX * BT + NT - 1) / NT;

  __shared__ __align__(16) float hs[2][H * BTP];
  __shared__ __align__(16) float xs[DMAX * BT];
  __shared__ float mus[ZMAX * BT];

  const int tid = threadIdx.x;
  const int j = tid % H;
  const int g = tid / H;
  const int n0 = blockIdx.x * BT;

  for (int i = tid; i < 2 * H * BTP; i += NT) (&hs[0][0])[i] = 0.0f;
  float c[2][BW];
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int w = 0; w < BW; ++w) c[l][w] = 0.0f;
  __syncthreads();

  // ---------------- encoder: all layers advance inside one time loop
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < D * BT; i += NT) {         // x_t tile -> xs[d][b]
      const int b = i % BT, d = i / BT;
      const int n = n0 + b;
      xs[d * BT + b] = n < N ? x[((size_t)n * T + t) * D + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
      float acc[4][BW];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float bq = __ldg(Wt.enc_b[l] + q * H + j);
#pragma unroll
        for (int w = 0; w < BW; ++w) acc[q][w] = bq;
      }
      if (l == 0)
        gate_matvec<H>(acc, Wt.enc_wih[0], D, xs, BT, j, g);
      else
        gate_matvec<H>(acc, Wt.enc_wih[1], H, hs[0], BTP, j, g);
      gate_matvec<H>(acc, Wt.enc_whh[l], H, hs[l], BTP, j, g);
      float h[BW];
      cell_update(acc, c[l], h);
      __syncthreads();                                // reads of h(t-1) done
      store_h(hs[l], h, j, g);
      __syncthreads();                                // h(t) visible
    }
  }

  // ---------------- LayerNorm over H + latent head (z = mu)
  float* hl = hs[L - 1];
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
      const float r = 1.0f / sqrtf(v + 1e-5f);
      for (int k = 0; k < H; ++k)
        hl[k * BTP + tid] = (hl[k * BTP + tid] - m) * r * __ldg(Wt.ln_scale + k) +
                            __ldg(Wt.ln_bias + k);
    }
    __syncthreads();
  }
  for (int i = tid; i < Z * BT; i += NT) {
    const int b = i % BT, z = i / BT;
    float s = __ldg(Wt.mu_b + z);
    for (int k = 0; k < H; ++k) s = fmaf(__ldg(Wt.mu_w + k * Z + z), hl[k * BTP + b], s);
    mus[z * BT + b] = s;
  }
  __syncthreads();
  // decoder input tanh(fc_latent_to_hidden(mu)) -> hs[0] (encoder state is dead)
  for (int i = tid; i < H * BT; i += NT) {
    const int b = i % BT, k = i / BT;
    float s = __ldg(Wt.z2h_b + k);
    for (int z = 0; z < Z; ++z) s = fmaf(__ldg(Wt.z2h_w + z * H + k), mus[z * BT + b], s);
    hs[0][k * BTP + b] = tanhf(s);
  }
  __syncthreads();
  // decoder layer-0 input projection, once: xpc = dec_in @ W_ih0 + b0
  float xpc[4][BW];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float bq = __ldg(Wt.dec_b[0] + q * H + j);
#pragma unroll
    for (int w = 0; w < BW; ++w) xpc[q][w] = bq;
  }
  gate_matvec<H>(xpc, Wt.dec_wih[0], H, hs[0], BTP, j, g);
  __syncthreads();
  for (int i = tid; i < 2 * H * BTP; i += NT) (&hs[0][0])[i] = 0.0f;
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int w = 0; w < BW; ++w) c[l][w] = 0.0f;
  __syncthreads();

  // ---------------- decoder scan + output head + residual + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;
  const float* hout = hs[L - 1];

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l >= L) break;
      float acc[4][BW];
      if (l == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int w = 0; w < BW; ++w) acc[q][w] = xpc[q][w];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float bq = __ldg(Wt.dec_b[1] + q * H + j);
#pragma unroll
          for (int w = 0; w < BW; ++w) acc[q][w] = bq;
        }
        gate_matvec<H>(acc, Wt.dec_wih[1], H, hs[0], BTP, j, g);
      }
      gate_matvec<H>(acc, Wt.dec_whh[l], H, hs[l], BTP, j, g);
      float h[BW];
      cell_update(acc, c[l], h);
      __syncthreads();
      store_h(hs[l], h, j, g);
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
        for (int k = 0; k < H; ++k) y = fmaf(__ldg(Wt.out_w + k * D + d), hout[k * BTP + b], y);
        if (n < N) {
          const size_t off = ((size_t)n * T + t) * D + d;
          const float e = x[off] - y;
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

template <int H>
cudaError_t launch(const float* x, float* resid, float* mse,
                   const VaeWeights& W, int N, int T, int D, int Z, int L,
                   int use_ln, int with_resid, cudaStream_t stream) {
  const dim3 grid((N + BT - 1) / BT);
  fused_vae_gate_kernel<H><<<grid, NG * H, 0, stream>>>(
      x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid);
  return cudaGetLastError();
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
  VaeWeights W;
  const float* const* p = reinterpret_cast<const float* const*>(w);
  for (int l = 0; l < 2; ++l) {
    W.enc_wih[l] = p[3 * l + 0];
    W.enc_whh[l] = p[3 * l + 1];
    W.enc_b[l] = p[3 * l + 2];
  }
  W.ln_scale = p[6];
  W.ln_bias = p[7];
  W.mu_w = p[8];
  W.mu_b = p[9];
  W.z2h_w = p[10];
  W.z2h_b = p[11];
  for (int l = 0; l < 2; ++l) {
    W.dec_wih[l] = p[12 + 3 * l + 0];
    W.dec_whh[l] = p[12 + 3 * l + 1];
    W.dec_b[l] = p[12 + 3 * l + 2];
  }
  W.out_w = p[18];
  W.out_b = p[19];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 32: err = launch<32>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, s); break;
    case 64: err = launch<64>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, s); break;
    case 128: err = launch<128>(x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
