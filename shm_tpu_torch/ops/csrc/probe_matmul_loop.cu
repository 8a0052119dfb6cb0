// Recurrent-product probe for Hopper (sm_90a): T steps of g = W h, then
// h = tanh(g[0:H]) * 0.25 + h * 0.75, in four modes.
//
// Replaces the Pallas TPU kernel tools/probe_f32_cliff.py::matmul_loop_kernel
// (:50), launched by matmul_loop (:77, pallas_call at :79). Same function,
// per tile of BT=256 columns of x [4H, ncols] (H=128), h_0 = x[0:H]:
//
//   vpu    : h = h * 1.000001 + x[0:H]                  (no product)
//   f32    : g = W h, W [4H, H] float32, float32 sums
//   bf16   : g = bf16(W) bf16(h), float32 sums
//   bf16x3 : g = W_hi h_hi + W_hi h_lo + W_lo h_hi, W_hi = bf16(W),
//            W_lo = bf16(W - W_hi) (h likewise): about float32 accuracy
//            from three bf16 products
//
// and h = tanh(g[0:H]) * 0.25 + h * 0.75 for the three product modes. The
// full [4H, H] x [H, BT] product is computed every step, as the TPU kernel
// does, though only rows 0:H feed h: rows H:4H are summed into a per-thread
// checksum written to `sink`, so the compiler cannot drop them.
//
// Bound on this card. 2*4H*H*BT*T = 3.36 GFLOP per tile at T=100, 70.5 GFLOP
// over 21 tiles: 1.05 ms at the 67 TFLOP/s float32 rate, 0.071 ms at the
// 989 TFLOP/s bf16 tensor-core rate (three times that for bf16x3). One
// block owns a tile, so 21 tiles fill only 21 of 132 SMs and the per-SM
// bound is 6.6 ms float32 and 0.45 ms bf16. Bytes (W, x once, out) are
// ~6 MB, ~2 us. The T steps are a serial chain inside each block.
//
// Design (first, simple version: right before fast). One block of 512
// threads (16 warps) per tile, the time loop inside the block.
//   * f32 runs on the FMA pipes: Hopper has no full-float32 tensor-core
//     path. h lives in shared memory as [H][BT] float32 (128 KiB); W
//     (256 KiB in float32, more than a block's 227 KB) streams through
//     L1/L2 as in fused_vae.cu. Thread (rg, cg) computes an 8-row x 8-column
//     tile of each 128-row gate chunk (columns cg*4.. and 128+cg*4.., so the
//     float4 reads of a warp are contiguous); a W row is read as float4 along
//     k, warp-uniform (broadcast). Chunks 1-3 go to the checksum, chunk 0 is
//     kept in registers until a barrier, then updates h in place.
//   * bf16 and bf16x3 run on the tensor cores through inline PTX
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, in the transposed
//     form g^T = h^T W^T: warp w owns window columns [16w, 16w+16) of the
//     tile (one m-tile) and walks the 64 n-tiles of 8 W rows. Then the
//     accumulator of n-tile j holds exactly the elements of h that the A
//     fragment of k-step j/2 needs (the register reuse of flash attention),
//     so h never passes through shared memory. h itself (float32, 64 values
//     a thread) sits in a per-warp scratch in device memory (L2), read once
//     and written once a step as float4; the bf16 A fragments of all 8
//     k-steps are built from it once a step and kept in registers.
//   * W_hi (bf16, 128 KiB) is made once per call by a small kernel in
//     fragment order ([n-tile][k-step pair][lane] x 16 bytes) and copied
//     into every block's shared memory, so each lane's B fragments for two
//     k-steps are one conflict-free 16-byte load. bf16x3's W_lo (another
//     128 KiB) does not fit beside it and streams from L2 in the same order,
//     coalesced. h_lo fragments (32 more registers) are built beside h_hi.
//   * vpu runs the elementwise loop in registers.
//
// Accurate tanhf (no --use_fast_math); the h update rounds after each
// multiply and after the add, as the reference does (no contraction).

#include <cuda_runtime.h>

namespace {

constexpr int H = 128;
constexpr int G = 4 * H;          // rows of W
constexpr int BT = 256;           // columns per tile (one block)
constexpr int NT = 512;           // threads per block
constexpr int NTILES_N = G / 8;   // n-tiles of the tensor-core product (64)
constexpr int KP = H / 32;        // k-step pairs (4)
constexpr int WF_UINT4 = NTILES_N * KP * 32;   // 16-byte words of a W fragment array
constexpr int HC_FLOAT4 = 16 * 32 * 16;        // float4 of h a warp-set holds per tile

enum Mode { VPU = 0, F32 = 1, BF16 = 2, BF16X3 = 3 };

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;  // lower half <- lo (the element of lower index), RN
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// d += a (16x16, row) * b (16x8, col), bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float h_update(float g, float h) {
  return __fadd_rn(__fmul_rn(tanhf(g), 0.25f), __fmul_rn(h, 0.75f));
}

// W [G, H] float32 -> B fragments of W_hi = bf16(W) and W_lo = bf16(W - W_hi),
// [n-tile nt][k-step pair kp][lane] x uint4 {b0(2kp), b1(2kp), b0(2kp+1),
// b1(2kp+1)}: lane (g = lane/4, t = lane%4) holds W[8nt + g][16s + 2t + {0,1}]
// and W[8nt + g][16s + 8 + 2t + {0,1}] for k-step s.
__global__ void w_fragments(const float* __restrict__ w, uint4* __restrict__ hi,
                            uint4* __restrict__ lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WF_UINT4) return;
  const int lane = i % 32, kp = (i / 32) % KP, nt = i / (32 * KP);
  const float* row = w + (size_t)(nt * 8 + lane / 4) * H;
  unsigned vh[4], vl[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = (2 * kp + q / 2) * 16 + (q % 2) * 8 + (lane % 4) * 2;
    const float a = row[k], b = row[k + 1];
    vh[q] = pack_bf16x2(a, b);
    vl[q] = pack_bf16x2(a - bf_lo(vh[q]), b - bf_hi(vh[q]));
  }
  hi[i] = make_uint4(vh[0], vh[1], vh[2], vh[3]);
  lo[i] = make_uint4(vl[0], vl[1], vl[2], vl[3]);
}

__global__ void __launch_bounds__(NT)
vpu_loop(const float* __restrict__ x, float* __restrict__ out, int ncols, int T) {
  const int c0 = blockIdx.x * BT;
  for (int i = threadIdx.x; i < H * BT; i += NT) {
    const int r = i / BT, c = c0 + i % BT;
    const float x0 = x[(size_t)r * ncols + c];
    float h = x0;
    for (int t = 0; t < T; ++t) h = __fadd_rn(__fmul_rn(h, 1.000001f), x0);
    out[(size_t)r * ncols + c] = h;
  }
}

__global__ void __launch_bounds__(NT)
f32_loop(const float* __restrict__ w, const float* __restrict__ x,
         float* __restrict__ out, float* __restrict__ sink, int ncols, int T) {
  extern __shared__ __align__(16) float hs[];     // [H][BT]
  const int tid = threadIdx.x;
  const int cg = tid % 32, rg = tid / 32;
  const int c0 = blockIdx.x * BT;
  for (int i = tid; i < H * BT; i += NT)
    hs[i] = x[(size_t)(i / BT) * ncols + c0 + i % BT];
  __syncthreads();
  float chk = 0.0f;

  for (int t = 0; t < T; ++t) {
    float acc[8][8];
    for (int q = 3; q >= 0; --q) {                 // gate chunk 0 last: kept
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
      const float* wr = w + (size_t)(q * H + rg * 8) * H;
#pragma unroll 1
      for (int k = 0; k < H; k += 4) {
        float4 wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wv[i] = __ldg(reinterpret_cast<const float4*>(wr + i * H + k));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(hs + (k + kk) * BT + cg * 4);
          const float4 b = *reinterpret_cast<const float4*>(hs + (k + kk) * BT + 128 + cg * 4);
          const float hv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float wk = kk == 0 ? wv[i].x : kk == 1 ? wv[i].y : kk == 2 ? wv[i].z : wv[i].w;
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(wk, hv[c], acc[i][c]);
          }
        }
      }
      if (q > 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) chk += acc[i][c];
      }
    }
    __syncthreads();                               // every read of h(t) done
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* hr = hs + (rg * 8 + i) * BT;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = c < 4 ? cg * 4 + c : 128 + cg * 4 + c - 4;
        hr[col] = h_update(acc[i][c], hr[col]);
      }
    }
    __syncthreads();                               // h(t+1) visible
  }
  for (int i = tid; i < H * BT; i += NT)
    out[(size_t)(i / BT) * ncols + c0 + i % BT] = hs[i];
  sink[blockIdx.x * NT + tid] = chk;
}

template <int MODE>
__global__ void __launch_bounds__(NT)
mma_loop(const uint4* __restrict__ wf_hi, const uint4* __restrict__ wf_lo,
         const float* __restrict__ x, float* __restrict__ out,
         float4* __restrict__ hc_all, float* __restrict__ sink, int ncols,
         int T) {
  extern __shared__ __align__(16) uint4 wsh[];    // W_hi fragments, 128 KiB
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  for (int i = tid; i < WF_UINT4; i += NT) wsh[i] = wf_hi[i];

  // this thread's h in C-fragment order: hc[j] = h[8j+2tq+{0,1}][col gq, gq+8]
  float4* hc = hc_all + (size_t)blockIdx.x * HC_FLOAT4 + (warp * 16) * 32 + lane;
  const int colA = blockIdx.x * BT + warp * 16 + gq, colB = colA + 8;
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const int u = 8 * j + 2 * tq;
    hc[j * 32] = make_float4(x[(size_t)u * ncols + colA], x[(size_t)(u + 1) * ncols + colA],
                             x[(size_t)u * ncols + colB], x[(size_t)(u + 1) * ncols + colB]);
  }
  __syncthreads();
  float chk = 0.0f;

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    // A fragments of h^T for the 8 k-steps: k-step s reads n-tiles 2s, 2s+1
    unsigned ahi[8][4], alo[MODE == BF16X3 ? 8 : 1][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float4 p = hc[(2 * s) * 32], q = hc[(2 * s + 1) * 32];
      ahi[s][0] = pack_bf16x2(p.x, p.y);
      ahi[s][1] = pack_bf16x2(p.z, p.w);
      ahi[s][2] = pack_bf16x2(q.x, q.y);
      ahi[s][3] = pack_bf16x2(q.z, q.w);
      if constexpr (MODE == BF16X3) {
        alo[s][0] = pack_bf16x2(p.x - bf_lo(ahi[s][0]), p.y - bf_hi(ahi[s][0]));
        alo[s][1] = pack_bf16x2(p.z - bf_lo(ahi[s][1]), p.w - bf_hi(ahi[s][1]));
        alo[s][2] = pack_bf16x2(q.x - bf_lo(ahi[s][2]), q.y - bf_hi(ahi[s][2]));
        alo[s][3] = pack_bf16x2(q.z - bf_lo(ahi[s][3]), q.w - bf_hi(ahi[s][3]));
      }
    }
    // two n-tiles at a time (two independent accumulator chains)
#pragma unroll 1
    for (int nt = 0; nt < NTILES_N; nt += 2) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = ((nt + e) * KP + kp) * 32 + lane;
          const uint4 bh = wsh[f];
          mma_bf16(acc[e], ahi[2 * kp], bh.x, bh.y);
          mma_bf16(acc[e], ahi[2 * kp + 1], bh.z, bh.w);
          if constexpr (MODE == BF16X3) {
            const uint4 bl = __ldg(wf_lo + f);
            mma_bf16(acc[e], alo[2 * kp], bh.x, bh.y);        // W_hi h_lo
            mma_bf16(acc[e], alo[2 * kp + 1], bh.z, bh.w);
            mma_bf16(acc[e], ahi[2 * kp], bl.x, bl.y);        // W_lo h_hi
            mma_bf16(acc[e], ahi[2 * kp + 1], bl.z, bl.w);
          }
        }
      }
      if (nt < H / 8) {                            // rows 0:H update h
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 o = hc[(nt + e) * 32];
          hc[(nt + e) * 32] = make_float4(h_update(acc[e][0], o.x), h_update(acc[e][1], o.y),
                                          h_update(acc[e][2], o.z), h_update(acc[e][3], o.w));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) chk += (acc[e][0] + acc[e][1]) + (acc[e][2] + acc[e][3]);
      }
    }
  }
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const int u = 8 * j + 2 * tq;
    const float4 v = hc[j * 32];
    out[(size_t)u * ncols + colA] = v.x;
    out[(size_t)(u + 1) * ncols + colA] = v.y;
    out[(size_t)u * ncols + colB] = v.z;
    out[(size_t)(u + 1) * ncols + colB] = v.w;
  }
  sink[blockIdx.x * NT + tid] = chk;
}

constexpr size_t SMEM_BYTES = (size_t)H * BT * sizeof(float);   // 128 KiB, both
static_assert(SMEM_BYTES == (size_t)WF_UINT4 * sizeof(uint4), "one smem size");

}  // namespace

// Bytes of device scratch shm_probe_matmul_loop needs for `ncols` columns in
// `mode`: the two W fragment arrays and h of every tile (tensor-core modes).
extern "C" long long shm_probe_matmul_loop_scratch_bytes(int ncols, int mode) {
  if (mode != BF16 && mode != BF16X3) return 0;
  return 2LL * WF_UINT4 * sizeof(uint4) + (long long)(ncols / BT) * HC_FLOAT4 * sizeof(float4);
}

// C entry for ctypes. w [4H, H], x [4H, ncols], out [H, ncols] float32
// row-major, ncols a positive multiple of 256, H = 128; scratch of
// shm_probe_matmul_loop_scratch_bytes(ncols, mode) bytes (16-byte aligned);
// sink [ncols / 256 * 512] float32 (f32 and tensor-core modes). mode: 0 vpu,
// 1 f32, 2 bf16, 3 bf16x3. Returns the launches' cudaGetLastError().
extern "C" int shm_probe_matmul_loop(const float* w, const float* x, float* out,
                                     void* scratch, float* sink, int ncols,
                                     int T, int mode, void* stream) {
  if (ncols <= 0 || ncols % BT != 0 || T < 0 || mode < VPU || mode > BF16X3 ||
      (mode != VPU && sink == nullptr) ||
      ((mode == BF16 || mode == BF16X3) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(ncols / BT);
  cudaError_t err;
  if (mode == VPU) {
    vpu_loop<<<grid, NT, 0, s>>>(x, out, ncols, T);
    return (int)cudaGetLastError();
  }
  if (mode == F32) {
    err = cudaFuncSetAttribute(f32_loop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    f32_loop<<<grid, NT, SMEM_BYTES, s>>>(w, x, out, sink, ncols, T);
    return (int)cudaGetLastError();
  }
  uint4* hi = reinterpret_cast<uint4*>(scratch);
  uint4* lo = hi + WF_UINT4;
  float4* hc = reinterpret_cast<float4*>(lo + WF_UINT4);
  w_fragments<<<(WF_UINT4 + 255) / 256, 256, 0, s>>>(w, hi, lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kern = mode == BF16 ? mma_loop<BF16> : mma_loop<BF16X3>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, SMEM_BYTES, s>>>(hi, lo, x, out, hc, sink, ncols, T);
  return (int)cudaGetLastError();
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
