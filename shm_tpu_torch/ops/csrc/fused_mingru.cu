// Fused deterministic minGRU-VAE gate for Hopper (sm_90a), float32.
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
// L in 1..4, H in {32,64,128} (template), D <= 16, Z <= 32, any T. Weights
// come in the flax layout [in, out] (w_ih [in, 2H], the z half first).
//
// Bound on this card. Per window the product work is, for the 4DOF preset
// (T=100, D=12, H=128, Z=16, L=2), T*2*2H*(D+H) (encoder) + 2*2*H*Z (heads)
// + 2*2H*H (decoder layer 0, once) + T*(2*2H*H + 2*D*H) (decoder layer 1 and
// head), about 14.1 MFLOP; at N=5,440 that is about 77 GFLOP, ~1.15 ms at the
// 67 TFLOP/s float32 rate without tensor cores. The bytes (x, resid, weights
// once) are ~53 MB, ~16 us at 3.35 TB/s. So the kernel is bound by
// operations.
//
// Design (first, simple version: right before fast). The TPU kernel runs a
// layer over all T before the next one and keeps the [H, T*Bt] gate and
// hidden sequences in its large fast memory; a block here has 227 KB, and one
// window's hidden sequence alone is 51 KB. Since layer l at step t needs only
// layer l-1 at step t, the layers are interleaved inside ONE time loop
// instead, which is the same arithmetic and keeps no sequence at all:
//   * one block owns BT=32 windows; threads = 4*H; thread (j, g) owns hidden
//     unit j for the BW=8 windows of group g and both of its gates, and keeps
//     h of every layer in registers for the whole loop;
//   * the current h of every layer lives in shared memory as [H][BT+4] for
//     the next layer's product, which reads it as two float4 broadcasts per
//     k and each weight once per k (every weight load feeds 8 FMAs);
//   * weights (0.45 MB for the whole 4DOF model) are read from global memory
//     through L1/L2, coalesced: thread j reads column q*H+j of row k;
//   * BT=32 gives 170 blocks at N=5,440, more than the 132 SMs.
// It runs the f32 FMA pipes, so it cannot pass the f32 bound; a tiled product
// over several steps at once and bf16 wgmma are later work.
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
constexpr int LMAX = 4;
constexpr int NUM_W = 4 * LMAX + 8;

struct MinGruWeights {
  const float* enc_w[LMAX];   // [in, 2H]
  const float* enc_b[LMAX];   // [2H]
  const float* ln_scale;
  const float* ln_bias;
  const float* mu_w;    // [H, Z]
  const float* mu_b;    // [Z]
  const float* z2h_w;   // [Z, H]
  const float* z2h_b;   // [H]
  const float* dec_w[LMAX];
  const float* dec_b[LMAX];
  const float* out_w;   // [H, D]
  const float* out_b;   // [D]
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[q][w] = b[q*H + j] + sum_k W[k][q*H + j] * s[k][g*BW + w] for k < K
// (W row-major [K, 2H]; s is a shared [K][ld] buffer).
template <int H>
__device__ __forceinline__ void gate_matvec(float (&acc)[2][BW],
                                            const float* __restrict__ W,
                                            const float* __restrict__ b, int K,
                                            const float* s, int ld, int j,
                                            int g) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float bq = __ldg(b + q * H + j);
#pragma unroll
    for (int w = 0; w < BW; ++w) acc[q][w] = bq;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* wr = W + (size_t)k * 2 * H + j;
    const float w0 = __ldg(wr), w1 = __ldg(wr + H);
    const float4 a = *reinterpret_cast<const float4*>(s + k * ld + g * BW);
    const float4 c = *reinterpret_cast<const float4*>(s + k * ld + g * BW + 4);
    const float v[BW] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      acc[0][w] = fmaf(w0, v[w], acc[0][w]);
      acc[1][w] = fmaf(w1, v[w], acc[1][w]);
    }
  }
}

// h <- h + sigmoid(g_z) * (g_h - h), then h -> hs[j][g*BW ..]
__device__ __forceinline__ void cell_update_store(const float (&acc)[2][BW],
                                                  float (&h)[BW], float* hs,
                                                  int j, int g) {
#pragma unroll
  for (int w = 0; w < BW; ++w) {
    const float z = sigmoid_f(acc[0][w]);
    h[w] = h[w] + z * (acc[1][w] - h[w]);
  }
  float4* p = reinterpret_cast<float4*>(hs + j * BTP + g * BW);
  p[0] = make_float4(h[0], h[1], h[2], h[3]);
  p[1] = make_float4(h[4], h[5], h[6], h[7]);
}

template <int H>
__global__ void __launch_bounds__(NG * H)
fused_mingru_gate_kernel(const float* __restrict__ x, float* __restrict__ resid,
                         float* __restrict__ mse, const MinGruWeights Wt, int N,
                         int T, int D, int Z, int L, int use_ln,
                         int with_resid) {
  constexpr int NT = NG * H;
  constexpr int IO_SLOTS = (DMAX * BT + NT - 1) / NT;

  // hs[L][H*BTP] | xs[DMAX*BT] | mus[ZMAX*BT]
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* xs = hs + L * H * BTP;
  float* mus = xs + DMAX * BT;

  const int tid = threadIdx.x;
  const int j = tid % H;
  const int g = tid / H;
  const int n0 = blockIdx.x * BT;

  float h[LMAX][BW];
#pragma unroll
  for (int l = 0; l < LMAX; ++l)
#pragma unroll
    for (int w = 0; w < BW; ++w) h[l][w] = 0.0f;

  // ---------------- encoder: all layers advance inside one time loop
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < D * BT; i += NT) {         // x_t tile -> xs[d][b]
      const int b = i % BT, d = i / BT;
      const int n = n0 + b;
      xs[d * BT + b] = n < N ? x[((size_t)n * T + t) * D + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l >= L) break;
      float acc[2][BW];
      if (l == 0)
        gate_matvec<H>(acc, Wt.enc_w[0], Wt.enc_b[0], D, xs, BT, j, g);
      else
        gate_matvec<H>(acc, Wt.enc_w[l], Wt.enc_b[l], H,
                       hs + (l - 1) * H * BTP, BTP, j, g);
      cell_update_store(acc, h[l], hs + l * H * BTP, j, g);
      __syncthreads();                                // h_l(t) visible
    }
  }

  // ---------------- LayerNorm over H + latent head (z = mu)
  float* hl = hs + (L - 1) * H * BTP;
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
    hs[k * BTP + b] = tanhf(s);
  }
  __syncthreads();
  // decoder layer 0: constant input, so z1 and h~1 once
  float z1[BW], hb1[BW];
  {
    float acc[2][BW];
    gate_matvec<H>(acc, Wt.dec_w[0], Wt.dec_b[0], H, hs, BTP, j, g);
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      z1[w] = sigmoid_f(acc[0][w]);
      hb1[w] = acc[1][w];
    }
  }
#pragma unroll
  for (int l = 0; l < LMAX; ++l)
#pragma unroll
    for (int w = 0; w < BW; ++w) h[l][w] = 0.0f;
  __syncthreads();                                    // reads of dec_in done

  // ---------------- decoder sweep + output head + residual + MSE
  float acc_mse[IO_SLOTS];
#pragma unroll
  for (int r = 0; r < IO_SLOTS; ++r) acc_mse[r] = 0.0f;
  const float* hout = hs + (L - 1) * H * BTP;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l >= L) break;
      if (l == 0) {
#pragma unroll
        for (int w = 0; w < BW; ++w) h[0][w] = h[0][w] + z1[w] * (hb1[w] - h[0][w]);
        float4* p = reinterpret_cast<float4*>(hs + j * BTP + g * BW);
        p[0] = make_float4(h[0][0], h[0][1], h[0][2], h[0][3]);
        p[1] = make_float4(h[0][4], h[0][5], h[0][6], h[0][7]);
      } else {
        float acc[2][BW];
        gate_matvec<H>(acc, Wt.dec_w[l], Wt.dec_b[l], H,
                       hs + (l - 1) * H * BTP, BTP, j, g);
        cell_update_store(acc, h[l], hs + l * H * BTP, j, g);
      }
      __syncthreads();
    }
    // output head for step t: thread slot (b, d) reads the last layer's h
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
    // with one layer the head reads the buffer that the next step's layer 0
    // overwrites; deeper stacks have a barrier in between already
    if (L == 1) __syncthreads();
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
                   const MinGruWeights& W, int N, int T, int D, int Z, int L,
                   int use_ln, int with_resid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)L * H * BTP + DMAX * BT + ZMAX * BT);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mingru_gate_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BT - 1) / BT);
  fused_mingru_gate_kernel<H><<<grid, NG * H, smem, stream>>>(
      x, resid, mse, W, N, T, D, Z, L, use_ln, with_resid);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. `w` holds NUM_W = 4*LMAX + 8 device pointers in the order
//   enc_w[0..3] enc_b[0..3] ln_scale ln_bias mu_w mu_b z2h_w z2h_b
//   dec_w[0..3] dec_b[0..3] out_w out_b
// (pointers of layers >= L and of an unused LayerNorm may be null). Returns
// the launch's cudaGetLastError(), 0 on success.
extern "C" int shm_fused_mingru_gate_f32(const float* x, float* resid,
                                         float* mse, const void* const* w,
                                         int n_w, int N, int T, int D, int H,
                                         int Z, int L, int use_ln,
                                         int with_resid, void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || Z <= 0 ||
      Z > ZMAX || L < 1 || L > LMAX || (with_resid && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  MinGruWeights W;
  const float* const* p = reinterpret_cast<const float* const*>(w);
  for (int l = 0; l < LMAX; ++l) {
    W.enc_w[l] = p[l];
    W.enc_b[l] = p[LMAX + l];
    W.dec_w[l] = p[2 * LMAX + 6 + l];
    W.dec_b[l] = p[3 * LMAX + 6 + l];
  }
  W.ln_scale = p[2 * LMAX + 0];
  W.ln_bias = p[2 * LMAX + 1];
  W.mu_w = p[2 * LMAX + 2];
  W.mu_b = p[2 * LMAX + 3];
  W.z2h_w = p[2 * LMAX + 4];
  W.z2h_b = p[2 * LMAX + 5];
  W.out_w = p[4 * LMAX + 6];
  W.out_b = p[4 * LMAX + 7];
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
