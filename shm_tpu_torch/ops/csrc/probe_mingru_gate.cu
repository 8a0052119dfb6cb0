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
// MFLOP a window: ~307 GFLOP at N=21,760, 4.58 ms at the 67 TFLOP/s float32
// rate. This structure also moves its scratch through device memory: g
// (T*2H*2 bytes a window), h (T*H*2, written and read twice) and y, about
// 80 KB a window written and ~100 KB read, 3.9 GB at N=21,760 (1.2 ms at
// 3.35 TB/s) if none of it stayed in L2.
//
// Design (first, simple version: right before fast). The TPU kernel keeps
// its sequences in fast memory; one window's are 77 KB here, so the scratch
// lives in device memory, [tile][T][rows][32 windows] in bf16, allocated by
// the wrapper. One block of 512 threads owns a tile of 32 windows and runs
// the phases in order, with a barrier between phases (a block's global
// writes are visible to the block after __syncthreads):
//   * projections: a simple tiled FMA product. Four steps x 32 windows = 128
//     columns of the input are staged in shared memory as float32 (64 KB);
//     thread (rg, cg) computes 8 rows x 8 columns (columns cg*4.. and
//     64+cg*4.., so a warp's float4 reads are contiguous), each bf16 weight
//     row read as one 16-byte load;
//   * sweeps: elementwise; thread (j, wg) owns unit j for 8 windows, h in
//     registers, z and h~ read as 16-byte loads (4 lanes cover a row's 32
//     windows, 64 contiguous bytes) and h stored the same way;
//   * LayerNorm, heads and the decoder's constant gates as fused_mingru.cu.
// H = 128, D <= 16, Z <= 32. It runs the FMA pipes; no library product.

#include <cuda_runtime.h>

namespace {

constexpr int H = 128;
constexpr int H2 = 2 * H;
constexpr int BT = 32;            // windows per block (one tile)
constexpr int NT = 512;
constexpr int CS = 4;             // steps per staged chunk
constexpr int CC = CS * BT;       // columns per chunk (128)
constexpr int DMAX = 16;
constexpr int ZMAX = 32;
constexpr int NUM_W = 16;

typedef unsigned short bf16_t;

struct MinGruProbeWeights {       // matmul weights bf16 [in, out]; the rest float32
  const bf16_t* enc_w[2];         // [in, 2H]
  const float* enc_b[2];
  const float* ln_scale;
  const float* ln_bias;
  const bf16_t* mu_w;             // [H, Z]
  const float* mu_b;
  const bf16_t* z2h_w;            // [Z, H]
  const float* z2h_b;
  const bf16_t* dec_w[2];
  const float* dec_b[2];
  const bf16_t* out_w;            // [H, D]
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

// Stage columns [t0*BT, t0*BT + CC) of the input into xs[K][CC] as float32
// bf16 values: from the windows (x [N,T,D] float32, rounded) or from a bf16
// scratch [T][K][BT].
__device__ void stage(float* xs, const float* __restrict__ x, const bf16_t* src,
                      int K, int t0, int n0, int N, int T, int D) {
  for (int i = threadIdx.x; i < K * CC; i += NT) {
    const int k = i / CC, c = i % CC, t = t0 + c / BT, b = c % BT;
    float v = 0.0f;
    if (t < T) {
      if (x) v = n0 + b < N ? bfr(x[((size_t)(n0 + b) * T + t) * D + k]) : 0.0f;
      else v = bf(src[((size_t)t * K + k) * BT + b]);
    }
    xs[i] = v;
  }
}

// g[t][r][b] = bf16(act(W[:, r]^T in[:, (t, b)] + bias[r])) for every t, 2H rows
// (act = tanh-form sigmoid on rows < H); in = the windows or a bf16 scratch
__device__ void project(float* xs, const bf16_t* __restrict__ W, const float* __restrict__ bias,
                        int K, const float* __restrict__ x, const bf16_t* src,
                        bf16_t* g, int n0, int N, int T, int D) {
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int r0 = rg * 8;
  for (int t0 = 0; t0 < T; t0 += CS) {
    __syncthreads();                              // the last chunk's reads done
    stage(xs, x, src, K, t0, n0, N, T, D);
    __syncthreads();
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const uint4 wq = __ldg(reinterpret_cast<const uint4*>(W + (size_t)k * H2 + r0));
      const float wv[8] = {bf_lo(wq.x), bf_hi(wq.x), bf_lo(wq.y), bf_hi(wq.y),
                           bf_lo(wq.z), bf_hi(wq.z), bf_lo(wq.w), bf_hi(wq.w)};
      const float4 a = *reinterpret_cast<const float4*>(xs + k * CC + cg * 4);
      const float4 b = *reinterpret_cast<const float4*>(xs + k * CC + 64 + cg * 4);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(wv[i], v[c], acc[i][c]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 64 + cg * 4;           // 4 windows of one step
      const int t = t0 + c / BT, b = c % BT;
      if (t >= T) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = acc[i][half * 4 + e] + __ldg(bias + r);
          o[e] = r < H ? sig_tanh(s) : s;
        }
        *reinterpret_cast<uint2*>(g + ((size_t)t * H2 + r) * BT + b) =
            make_uint2(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]));
      }
    }
  }
}

// y[t][d][b] = bf16(out_w[:, d]^T h[t][:, b] + out_b[d]) for every t
__device__ void project_out(float* xs, const bf16_t* __restrict__ W, const float* __restrict__ bias,
                            const bf16_t* hsrc, bf16_t* y, int T, int D) {
  for (int t0 = 0; t0 < T; t0 += CS) {
    __syncthreads();
    stage(xs, nullptr, hsrc, H, t0, 0, 0, T, D);
    __syncthreads();
    for (int i = threadIdx.x; i < D * CC; i += NT) {
      const int d = i / CC, c = i % CC, t = t0 + c / BT, b = c % BT;
      if (t >= T) continue;
      float s = 0.0f;
      for (int k = 0; k < H; ++k) s = fmaf(bf(__ldg(W + k * D + d)), xs[k * CC + c], s);
      y[((size_t)t * DMAX + d) * BT + b] = (bf16_t)(pack_bf16x2(s + __ldg(bias + d), 0.f) & 0xffffu);
    }
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
  extern __shared__ __align__(16) float xs[];     // [H][CC] float32, 64 KB
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BT;
  bf16_t* g = g_all + (size_t)blockIdx.x * T * H2 * BT;
  bf16_t* hseq = h_all + (size_t)blockIdx.x * T * H * BT;
  bf16_t* y = y_all + (size_t)blockIdx.x * T * DMAX * BT;
  const int j = tid / 4, wg = tid % 4;
  float h[8];

  // ---------------- encoder
  project(xs, Wt.enc_w[0], Wt.enc_b[0], D, x, nullptr, g, n0, N, T, D);
  __syncthreads();
  sweep(g, hseq, loop_T, h);
  __syncthreads();
  project(xs, Wt.enc_w[1], Wt.enc_b[1], H, nullptr, hseq, g, n0, N, T, D);
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
      const float wz = bf(__ldg(Wt.dec_w[0] + k * H2 + j));
      const float wh = bf(__ldg(Wt.dec_w[0] + k * H2 + H + j));
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
  project(xs, Wt.dec_w[1], Wt.dec_b[1], H, nullptr, hseq, g, n0, N, T, D);
  __syncthreads();
  sweep(g, hseq, loop_T, h);
  __syncthreads();
  project_out(xs, Wt.out_w, Wt.out_b, hseq, y, T, D);
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

constexpr size_t SMEM_BYTES = sizeof(float) * H * CC;      // 64 KB

}  // namespace

// Bytes of bf16 scratch (g, h, y) shm_probe_mingru_gate needs for N windows.
extern "C" long long shm_probe_mingru_gate_scratch_bytes(int N, int T) {
  const long long tiles = (N + BT - 1) / BT;
  return tiles * T * (long long)(H2 + H + DMAX) * BT * 2;
}

// C entry for ctypes. x [N, T, D] float32; `w` holds NUM_W device pointers
//   enc_w0 enc_w1 enc_b0 enc_b1 ln_scale ln_bias mu_w mu_b z2h_w z2h_b
//   dec_w0 dec_w1 dec_b0 dec_b1 out_w out_b
// with the matmul weights in bf16 and the rest in float32; `scratch` of
// shm_probe_mingru_gate_scratch_bytes(N, T) bytes. H = 128, 1 <= loop_T <= T.
// Returns the launch's cudaGetLastError().
extern "C" int shm_probe_mingru_gate(const float* x, float* mse, const void* const* w,
                                     int n_w, void* scratch, int N, int T, int D,
                                     int H_, int Z, int loop_T, void* stream) {
  if (n_w != NUM_W || N <= 0 || T <= 0 || D <= 0 || D > DMAX || H_ != H ||
      Z <= 0 || Z > ZMAX || loop_T < 1 || loop_T > T || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  MinGruProbeWeights W;
  W.enc_w[0] = static_cast<const bf16_t*>(w[0]);
  W.enc_w[1] = static_cast<const bf16_t*>(w[1]);
  W.enc_b[0] = static_cast<const float*>(w[2]);
  W.enc_b[1] = static_cast<const float*>(w[3]);
  W.ln_scale = static_cast<const float*>(w[4]);
  W.ln_bias = static_cast<const float*>(w[5]);
  W.mu_w = static_cast<const bf16_t*>(w[6]);
  W.mu_b = static_cast<const float*>(w[7]);
  W.z2h_w = static_cast<const bf16_t*>(w[8]);
  W.z2h_b = static_cast<const float*>(w[9]);
  W.dec_w[0] = static_cast<const bf16_t*>(w[10]);
  W.dec_w[1] = static_cast<const bf16_t*>(w[11]);
  W.dec_b[0] = static_cast<const float*>(w[12]);
  W.dec_b[1] = static_cast<const float*>(w[13]);
  W.out_w = static_cast<const bf16_t*>(w[14]);
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

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
