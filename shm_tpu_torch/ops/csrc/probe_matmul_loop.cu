// Recurrent-product probe for Hopper (sm_90a): T steps of g = W h, then
// h = tanh(g[0:H]) * 0.25 + h * 0.75, in four modes.
//
// Replaces the Pallas TPU kernel tools/probe_f32_cliff.py::matmul_loop_kernel
// (:50), launched by matmul_loop (:77, pallas_call at :79). Same function,
// on x [4H, ncols] (H=128, ncols a multiple of the TPU probe's BT=256-column
// tile), h_0 = x[0:H]:
//
//   vpu    : h = h * 1.000001 + x[0:H]                  (no product)
//   f32    : g = W h, W [4H, H] float32, float32 sums
//   bf16   : g = bf16(W) bf16(h), float32 sums
//   bf16x3 : g = W_hi h_hi + W_hi h_lo + W_lo h_hi, W_hi = bf16(W),
//            W_lo = bf16(W - W_hi) (h likewise): about float32 accuracy
//            from three bf16 products
//
// and h = tanh(g[0:H]) * 0.25 + h * 0.75 for the three product modes. The
// full [4H, H] x [H, ncols] product is computed every step, as the TPU kernel
// does, though only rows 0:H feed h: rows H:4H are summed into a per-thread
// checksum written to a sink in the scratch, so the compiler cannot drop them.
//
// Bound on this card. 2*4H*H*ncols*T = 70.5 GFLOP over 21 tiles at T=100:
// 1.05 ms at the 67 TFLOP/s float32 rate, 0.071 ms at the 989 TFLOP/s bf16
// tensor-core rate (three times that for bf16x3). Bytes (W, x once, out) are
// ~6 MB, ~2 us. The T steps are a serial chain; each column of x is its own
// chain (h[:, c] depends only on h[:, c] and W), so the columns are what can
// spread over the 132 SMs.
//
// Design. The TPU kernel's grid is one program per 256-column tile, run in
// order on one core; on this card that grid filled 21 of 132 SMs. Here a
// block owns CB columns (SHIP_CB below, chosen among 32, 48 and 64 by
// measurement at the probe's 5,376 columns: PERF.md §6), so 21 tiles launch
// ceil(5376 / CB) blocks, the time loop inside each block; a ragged last
// block computes on zero columns and stores none of them. No output's sum
// depends on the grid (its operands and order are a column's own), so vpu,
// f32 and the tensor-core modes' TC_CHAIN instance give the 256-column
// kernel's output bit for bit.
//   * f32 runs on the FMA pipes: Hopper has no full-float32 tensor-core
//     path. h lives in shared memory as [H][CB] float32. W (256 KiB in
//     float32, more than a block's 227 KB) streams from L2 every step: W^T
//     [H][4H] (made once a call by a small kernel) is copied 8 k-rows (16
//     KiB) at a time by cp.async into a ring of 3 stages in shared memory,
//     two stages ahead of the FMAs, one barrier a stage; so each block reads
//     W once a step, and no warp waits on L2. A warp owns 128 rows (row
//     block w % 4) x 16 columns; lane (rl = lane % 16, cl = lane / 16) an
//     8-row x 8-column tile: rows 4rl.., 64+4rl.. of the row block, columns
//     4cl.., 8+4cl.., so at one k it reads two 256-byte runs of W and two
//     32-byte broadcasts of h for 64 FMAs (F32_TC, F32_RL; an 8-row x
//     4-column tile ran slower: PERF.md §6). Each output is one fmaf chain
//     over k = 0..127 in order. Row block 0 (rows 0:H) updates h after a
//     barrier; the others add to the checksum.
//   * bf16 and bf16x3 run on the tensor cores through inline PTX
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, in the transposed
//     form g^T = h^T W^T: the block owns MT = CB/16 m-tiles of 16 columns and
//     4 warps per m-tile, each walking 16 of the 64 n-tiles of 8 W rows, four
//     accumulators at a time (groups of 4 n-tiles dealt round the 4 warps,
//     so each warp holds 4 of the n-tiles 0-15, rows 0:H, and updates their
//     h first). The accumulator of n-tile j holds exactly the elements of h
//     that the A fragment of k-step j/2 needs, so the update writes h in
//     that order. h (float32, in fragment order [m-tile][n-tile 0-15][lane]
//     x float4, 8 KiB an m-tile) sits in shared memory twice: step t reads
//     one copy and writes the other, so one barrier a step orders both.
//     Every warp builds the bf16 A fragments of its m-tile's 8 k-steps from
//     it once a step.
//   * W_hi (bf16, 128 KiB) is made once per call by a small kernel in
//     fragment order ([n-tile][k-step pair][lane] x 16 bytes) and copied
//     into every block's shared memory, so each lane's B fragments for two
//     k-steps are one conflict-free 16-byte load. bf16x3's W_lo (another
//     128 KiB) does not fit beside it and streams from L2 in the same order,
//     coalesced, shared in L1 by the block's MT warps that hold the same
//     n-tiles. h_lo fragments (32 more registers) are built beside h_hi.
//   * vpu runs the elementwise loop in registers, one block a 256-column
//     tile as before.
//   * How the tensor-core sums reach h (mma_loop<MODE, SUM>). The tensor
//     cores add each mma's products to its accumulator and truncate the sum
//     toward zero, so a sum chained through every mma of a product drifts
//     toward zero by up to an ulp an mma (PERF.md §6). The k-steps go in
//     pairs; TC_SPLIT (shipped) chains each pair's mma from zero, two for
//     bf16 and six for bf16x3 (small terms first: W_hi h_lo
//     and W_lo h_hi of k, then of k+1, then W_hi h_hi of k and of k+1, the
//     order of fused_vae.cu), and adds that partial to the float32 sum with
//     a round-to-nearest add; TC_CHAIN chains every mma into the one sum in
//     k order (the body before the split, kept as a probe instance that
//     the C entry reaches only when asked). No atomics.
//
// Accurate tanhf (no --use_fast_math); the h update rounds after each
// multiply and after the add, as the reference does (no contraction).

#include <cuda_runtime.h>

namespace {

constexpr int H = 128;
constexpr int G = 4 * H;          // rows of W
constexpr int BT = 256;           // the TPU probe's tile: ncols' unit, vpu's block
constexpr int NT_VPU = 512;       // threads of a vpu block
constexpr int NTILES_N = G / 8;   // n-tiles of the tensor-core product (64)
constexpr int KP = H / 32;        // k-step pairs (4)
constexpr int WF_UINT4 = NTILES_N * KP * 32;   // 16-byte words of a W fragment array
constexpr int HF_FLOAT4 = 16 * 32;             // float4 of h an m-tile holds
constexpr int WPM = 4;            // warps an m-tile (16 n-tiles each)
constexpr int NC = 4;             // accumulators a warp carries at once

// columns a block of every product mode (PERF.md §6)
constexpr int SHIP_CB = 48;

enum Mode { VPU = 0, F32 = 1, BF16 = 2, BF16X3 = 3 };
enum TcSum { TC_CHAIN = 0, TC_SPLIT = 1 };

// f32 thread tile: a lane owns 8 rows x F32_TC columns, a warp F32_RL lanes
// down the rows x 32 / F32_RL across the columns
constexpr int F32_TC = 8, F32_RL = 16;
constexpr int F32_NTHR = G / (8 * F32_RL) * (SHIP_CB / (32 / F32_RL * F32_TC)) * 32;
constexpr int MT = SHIP_CB / 16;  // tensor-core modes: m-tiles a block
constexpr int MMA_NTHR = MT * WPM * 32;
static_assert(SHIP_CB % (32 / F32_RL * F32_TC) == 0 && SHIP_CB % 16 == 0, "SHIP_CB");
constexpr int KS_F32 = 8;         // f32: W^T k-rows a ring stage (16 KiB)
constexpr int NS_F32 = 3;         // f32: ring stages in flight

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

// acc += the k-step pair's products, summed as SUM says: A fragments of
// h_hi (and h_lo) for k-steps 2kp, 2kp+1 in a0 / a1 (l0 / l1); B fragments
// of W_hi (and W_lo) for both in bh (bl), {b0, b1} of 2kp then of 2kp+1
template <int MODE, int SUM>
__device__ __forceinline__ void mma_pair(float (&acc)[4], const unsigned (&a0)[4],
                                         const unsigned (&a1)[4], const unsigned (&l0)[4],
                                         const unsigned (&l1)[4], uint4 bh, uint4 bl) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float (&s)[4] = SUM == TC_SPLIT ? part : acc;
  if constexpr (MODE == BF16X3) {
    if constexpr (SUM == TC_SPLIT) {
      mma_bf16(s, l0, bh.x, bh.y);                  // W_hi h_lo, k
      mma_bf16(s, a0, bl.x, bl.y);                  // W_lo h_hi, k
      mma_bf16(s, l1, bh.z, bh.w);                  // W_hi h_lo, k+1
      mma_bf16(s, a1, bl.z, bl.w);                  // W_lo h_hi, k+1
      mma_bf16(s, a0, bh.x, bh.y);                  // W_hi h_hi, k
      mma_bf16(s, a1, bh.z, bh.w);                  // W_hi h_hi, k+1
    } else {                                        // the order before the split
      mma_bf16(s, a0, bh.x, bh.y);
      mma_bf16(s, a1, bh.z, bh.w);
      mma_bf16(s, l0, bh.x, bh.y);
      mma_bf16(s, l1, bh.z, bh.w);
      mma_bf16(s, a0, bl.x, bl.y);
      mma_bf16(s, a1, bl.z, bl.w);
    }
  } else {
    mma_bf16(s, a0, bh.x, bh.y);
    mma_bf16(s, a1, bh.z, bh.w);
  }
  if constexpr (SUM == TC_SPLIT)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
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

// W [G, H] -> W^T [H, G] (coalesced writes)
__global__ void w_transpose(const float* __restrict__ w, float* __restrict__ wt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < G * H) wt[i] = w[(size_t)(i % G) * H + i / G];
}

__global__ void __launch_bounds__(NT_VPU)
vpu_loop(const float* __restrict__ x, float* __restrict__ out, int ncols, int T) {
  const int c0 = blockIdx.x * BT;
  for (int i = threadIdx.x; i < H * BT; i += NT_VPU) {
    const int r = i / BT, c = c0 + i % BT;
    const float x0 = x[(size_t)r * ncols + c];
    float h = x0;
    for (int t = 0; t < T; ++t) h = __fadd_rn(__fmul_rn(h, 1.000001f), x0);
    out[(size_t)r * ncols + c] = h;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// W^T k-rows [KS][G] of ring stage g (W^T stage g % (H / KS)) into `ring`
__device__ __forceinline__ void f32_stage(float* ring, const float* __restrict__ wt, int g) {
  float* dst = ring + (g % NS_F32) * KS_F32 * G;
  const float* src = wt + (size_t)(g % (H / KS_F32)) * KS_F32 * G;
  for (int i = threadIdx.x; i < KS_F32 * G / 4; i += F32_NTHR) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__global__ void __launch_bounds__(F32_NTHR)
f32_loop(const float* __restrict__ wt, const float* __restrict__ x,
         float* __restrict__ out, float* __restrict__ sink, int ncols, int T) {
  constexpr int CB = SHIP_CB, TC = F32_TC, RL = F32_RL, CL = 32 / RL;
  constexpr int RBLOCKS = G / (8 * RL), NTHR = F32_NTHR, NSTAGE = H / KS_F32;
  extern __shared__ __align__(16) float hs[];      // h [H][CB], then the W^T ring
  float* ring = hs + H * CB;                       // [NS_F32][KS_F32][G]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rb = warp % RBLOCKS;                   // row block of 8*RL rows
  const int r0 = rb * 8 * RL + 4 * (lane % RL);    // rows r0.., r0+4RL..
  const int c0 = (warp / RBLOCKS) * CL * TC + 4 * (lane / RL);   // columns c0.., c0+4CL..
  const int col0 = blockIdx.x * CB;
  for (int g = 0; g < NS_F32 - 1; ++g) f32_stage(ring, wt, g);
  for (int i = tid; i < H * CB; i += NTHR) {
    const int c = col0 + i % CB;
    hs[i] = c < ncols ? x[(size_t)(i / CB) * ncols + c] : 0.0f;
  }
  float chk = 0.0f;
  int g = 0;                                       // ring stage, over all steps

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    float acc[8][TC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] = 0.0f;
#pragma unroll 1
    for (int st = 0; st < NSTAGE; ++st, ++g) {
      cp_async_wait<NS_F32 - 2>();                 // this thread's part of stage g
      __syncthreads();                             // all of it; stage g-1 read
      f32_stage(ring, wt, g + NS_F32 - 1);
      const float* ws = ring + (g % NS_F32) * KS_F32 * G + r0;
      const float* hk = hs + st * KS_F32 * CB + c0;
#pragma unroll
      for (int kk = 0; kk < KS_F32; ++kk) {
        const float4 wa = *reinterpret_cast<const float4*>(ws + kk * G);
        const float4 wb = *reinterpret_cast<const float4*>(ws + kk * G + 4 * RL);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        float hv[TC];
#pragma unroll
        for (int c4 = 0; c4 < TC / 4; ++c4) {
          const float4 a = *reinterpret_cast<const float4*>(hk + kk * CB + 4 * CL * c4);
          hv[4 * c4] = a.x; hv[4 * c4 + 1] = a.y; hv[4 * c4 + 2] = a.z; hv[4 * c4 + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(wv[i], hv[c], acc[i][c]);
      }
    }
    __syncthreads();                               // every read of h(t) done
    // rows 0:H update h; the next stage's barrier publishes it
    if (rb < H / (8 * RL)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* hr = hs + (r0 + (i < 4 ? i : 4 * RL - 4 + i)) * CB + c0;
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const int col = c < 4 ? c : 4 * CL - 4 + c;
          hr[col] = h_update(acc[i][c], hr[col]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) chk += acc[i][c];
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                 // h(T) visible
  for (int i = tid; i < H * CB; i += NTHR) {
    const int c = col0 + i % CB;
    if (c < ncols) out[(size_t)(i / CB) * ncols + c] = hs[i];
  }
  sink[blockIdx.x * NTHR + tid] = chk;
}

template <int MODE, int SUM>
__global__ void __launch_bounds__(MMA_NTHR)
mma_loop(const uint4* __restrict__ wf_hi, const uint4* __restrict__ wf_lo,
         const float* __restrict__ x, float* __restrict__ out,
         float* __restrict__ sink, int ncols, int T) {
  constexpr int NTHR = MMA_NTHR;
  extern __shared__ __align__(16) uint4 wsh[];    // W_hi fragments, 128 KiB
  float4* hbuf = reinterpret_cast<float4*>(wsh + WF_UINT4);   // [2][MT][16][32]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = warp / WPM, wq = warp % WPM;
  const int col0 = blockIdx.x * MT * 16;
  for (int i = tid; i < WF_UINT4; i += NTHR) wsh[i] = wf_hi[i];
  // h in C-fragment order: entry (m, j, l) = h[8j+2tq+{0,1}][col gq, gq+8]
  // of m-tile m, for lane l = 4gq + tq
  for (int i = tid; i < MT * HF_FLOAT4; i += NTHR) {
    const int l = i % 32, j = (i / 32) % 16, m = i / HF_FLOAT4;
    const int u = 8 * j + 2 * (l % 4);
    const int ca = col0 + 16 * m + l / 4, cb = ca + 8;
    const float* xa = x + (size_t)u * ncols;
    hbuf[i] = make_float4(ca < ncols ? xa[ca] : 0.f, ca < ncols ? xa[ncols + ca] : 0.f,
                          cb < ncols ? xa[cb] : 0.f, cb < ncols ? xa[ncols + cb] : 0.f);
  }
  __syncthreads();
  float chk = 0.0f;

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float4* hr = hbuf + ((t & 1) * MT + mt) * HF_FLOAT4 + lane;
    float4* hw = hbuf + ((~t & 1) * MT + mt) * HF_FLOAT4 + lane;
    // A fragments of h^T for the 8 k-steps: k-step s reads n-tiles 2s, 2s+1
    unsigned ahi[8][4], alo[MODE == BF16X3 ? 8 : 1][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float4 p = hr[(2 * s) * 32], q = hr[(2 * s + 1) * 32];
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
    // NC n-tiles at a time (NC independent accumulator chains), groups of NC
    // dealt round the m-tile's warps so that each updates NC n-tiles of h
    // first; each chain takes its k-step pairs in order, summed as SUM says
#pragma unroll 1
    for (int nt = wq * NC; nt < NTILES_N; nt += WPM * NC) {
      float acc[NC][4];
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int f = ((nt + e) * KP + kp) * 32 + lane;
          const uint4 bh = wsh[f];
          const uint4 bl = MODE == BF16X3 ? __ldg(wf_lo + f) : bh;
          mma_pair<MODE, SUM>(acc[e], ahi[2 * kp], ahi[2 * kp + 1],
                              alo[MODE == BF16X3 ? 2 * kp : 0],
                              alo[MODE == BF16X3 ? 2 * kp + 1 : 0], bh, bl);
        }
      }
      if (nt < H / 8) {                            // rows 0:H update h
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const float4 o = hr[(nt + e) * 32];
          hw[(nt + e) * 32] = make_float4(h_update(acc[e][0], o.x), h_update(acc[e][1], o.y),
                                          h_update(acc[e][2], o.z), h_update(acc[e][3], o.w));
        }
      } else {
#pragma unroll
        for (int e = 0; e < NC; ++e) chk += (acc[e][0] + acc[e][1]) + (acc[e][2] + acc[e][3]);
      }
    }
    __syncthreads();                               // h(t+1) written, h(t) read
  }
  const float4* hf = hbuf + (T & 1) * MT * HF_FLOAT4;
  for (int i = tid; i < MT * HF_FLOAT4; i += NTHR) {
    const int l = i % 32, j = (i / 32) % 16, m = i / HF_FLOAT4;
    const int u = 8 * j + 2 * (l % 4);
    const int ca = col0 + 16 * m + l / 4, cb = ca + 8;
    float* oa = out + (size_t)u * ncols;
    const float4 v = hf[i];
    if (ca < ncols) { oa[ca] = v.x; oa[ncols + ca] = v.y; }
    if (cb < ncols) { oa[cb] = v.z; oa[ncols + cb] = v.w; }
  }
  sink[blockIdx.x * NTHR + tid] = chk;
}

int block_cols(int mode) { return mode == VPU ? BT : SHIP_CB; }

int block_threads(int mode) {
  return mode == VPU ? NT_VPU : mode == F32 ? F32_NTHR : MMA_NTHR;
}

cudaError_t launch_f32(const float* wt, const float* x, float* out, float* sink,
                       int ncols, int T, cudaStream_t s) {
  const size_t smem = ((size_t)H * SHIP_CB + NS_F32 * KS_F32 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(f32_loop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  f32_loop<<<(ncols + SHIP_CB - 1) / SHIP_CB, F32_NTHR, smem, s>>>(wt, x, out, sink, ncols, T);
  return cudaGetLastError();
}

template <int MODE, int SUM>
cudaError_t launch_mma(const uint4* hi, const uint4* lo, const float* x, float* out,
                       float* sink, int ncols, int T, cudaStream_t s) {
  const size_t smem = (size_t)WF_UINT4 * sizeof(uint4) + 2 * MT * HF_FLOAT4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(mma_loop<MODE, SUM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mma_loop<MODE, SUM><<<(ncols + SHIP_CB - 1) / SHIP_CB, MMA_NTHR, smem, s>>>(
      hi, lo, x, out, sink, ncols, T);
  return cudaGetLastError();
}

}  // namespace

// Blocks the C entry launches for `ncols` columns in `mode`, or -1 for
// arguments the entry refuses.
extern "C" int shm_probe_matmul_loop_blocks(int ncols, int mode) {
  if (ncols <= 0 || ncols % BT != 0 || mode < VPU || mode > BF16X3) return -1;
  return (ncols + block_cols(mode) - 1) / block_cols(mode);
}

// Bytes of device scratch shm_probe_matmul_loop needs: W^T (f32) or the two
// W fragment arrays (tensor-core modes), then the checksum sink (a float a
// thread); 0 for vpu, -1 for arguments the entry refuses.
extern "C" long long shm_probe_matmul_loop_scratch_bytes(int ncols, int mode) {
  const int blocks = shm_probe_matmul_loop_blocks(ncols, mode);
  if (blocks < 0) return -1;
  if (mode == VPU) return 0;
  const long long w = mode == F32 ? (long long)G * H * sizeof(float)
                                  : 2LL * WF_UINT4 * sizeof(uint4);
  return w + (long long)blocks * block_threads(mode) * sizeof(float);
}

// C entry for ctypes. w [4H, H], x [4H, ncols], out [H, ncols] float32
// row-major, ncols a positive multiple of 256, H = 128; scratch of
// shm_probe_matmul_loop_scratch_bytes(ncols, mode) bytes (16-byte aligned;
// none for vpu). mode: 0 vpu, 1 f32, 2 bf16, 3 bf16x3. tc_sum: how the
// tensor-core modes sum, 1 TC_SPLIT (the shipped sum) or 0 TC_CHAIN (a
// probe instance); vpu and f32 take 1 only. Returns the launches'
// cudaGetLastError().
extern "C" int shm_probe_matmul_loop(const float* w, const float* x, float* out,
                                     void* scratch, int ncols, int T, int mode,
                                     int tc_sum, void* stream) {
  if (shm_probe_matmul_loop_blocks(ncols, mode) < 0 || T < 0 ||
      (mode != VPU && scratch == nullptr) || (tc_sum != TC_SPLIT && tc_sum != TC_CHAIN) ||
      (tc_sum == TC_CHAIN && mode != BF16 && mode != BF16X3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mode == VPU) {
    vpu_loop<<<ncols / BT, NT_VPU, 0, s>>>(x, out, ncols, T);
    return (int)cudaGetLastError();
  }
  cudaError_t err;
  if (mode == F32) {
    float* wt = reinterpret_cast<float*>(scratch);
    w_transpose<<<G * H / 256, 256, 0, s>>>(w, wt);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)launch_f32(wt, x, out, wt + G * H, ncols, T, s);
  }
  uint4* hi = reinterpret_cast<uint4*>(scratch);
  uint4* lo = hi + WF_UINT4;
  float* sink = reinterpret_cast<float*>(lo + WF_UINT4);
  w_fragments<<<(WF_UINT4 + 255) / 256, 256, 0, s>>>(w, hi, lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (tc_sum == TC_CHAIN)
    return (int)(mode == BF16 ? launch_mma<BF16, TC_CHAIN>(hi, lo, x, out, sink, ncols, T, s)
                              : launch_mma<BF16X3, TC_CHAIN>(hi, lo, x, out, sink, ncols, T, s));
  return (int)(mode == BF16 ? launch_mma<BF16, TC_SPLIT>(hi, lo, x, out, sink, ncols, T, s)
                            : launch_mma<BF16X3, TC_SPLIT>(hi, lo, x, out, sink, ncols, T, s));
}

extern "C" const char* shm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
