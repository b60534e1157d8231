// Mamba2 chunked SSD scan for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (`ssd_scan_pallas` :79, `_kernel` :26), entered through
// src/repro/kernels/ops.py::ssd_scan.  It computes the same function and two
// things the model's prefill needs that the Pallas kernel lacks: an optional
// initial state and the final state.  Per chunk of Q steps, with
// a_cum = cumsum(log_da) over the chunk:
//
//   W[i][j] = (C_i . B_j) * exp(a_cum_i - a_cum_j)   for i >= j, else 0
//   y       = W x + exp(a_cum) * (C S^T)
//   S      <- exp(a_last) S + x^T (B * exp(a_last - a_cum))
//
// The exponential is taken only on and below the diagonal (above it the
// difference is positive and may overflow; the Pallas kernel computes it
// everywhere and selects).
//
// Layout: x/y (B, S, H, P) and B/C (B, S, N) in fp32 or bf16 (one dtype),
// log_da (B, S, H) fp32, state0/state_out (B, H, P, N) fp32, all contiguous.
// B and C form one group shared by all heads.  P and N are multiples of 8 up
// to 128; Q (the chunk) is 64 or 128.  A ragged S is masked in the kernels,
// with the semantics of zero padding: steps past S load x, B, C and log_da
// as 0 (so they add nothing and keep the state), and rows past S write
// nothing.  The TPU's grid walks the chunks in order with the state in VMEM
// scratch; blocks on the card run in no order, so each path below makes the
// chunk order explicit.
//
// bf16: Mamba2's chunk-parallel split (Dao & Gu, arXiv:2405.21060, section
// 6-7; mamba_ssm's chunk_state -> state_passing -> chunk_scan), with every
// product on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums) and
// every tile arriving by cp.async (zero-filled past S, P and N) into
// XOR-swizzled bf16 rows that ldmatrix reads without bank conflicts (the
// helpers in bf16_tiles.cuh, which the backward shares):
//
//   1. ssd_chunk_state, one block of 4 warps per (head, chunk, batch row):
//      S_loc[c] = x^T (B * dout), dout_j = exp(a_last - a_cum_j), fp32
//      (P, N) scratch, and exp(a_last) of the chunk.  Q / 64 more blocks per
//      (chunk, batch row) compute G = C B^T, which every head shares (B and
//      C form one group), once, in fp32, on and below the diagonal.
//   2. ssd_state_pass, the only serial pass and an elementwise one, one block
//      per (slice of P*N, head, batch row): S_in[0] = state0 (or 0),
//      S_in[c+1] = exp(a_last_c) S_in[c] + S_loc[c] in fp32; S_in is stored
//      in bf16, the last state in fp32 as state_out.
//   3. ssd_chunk_scan, one block of 8 warps per (head, chunk, batch row):
//      y = (L * G) x + diag(exp(a_cum)) C S_in[c]^T.  Each warp reads its
//      rows of G from L2 straight into registers in the accumulator layout,
//      weights them by exp(a_cum_i - a_cum_j) on and below the diagonal only,
//      and skips 16-step groups past its rows.
//
// Rounding points, all others fp32: B * dout rounded to bf16 for S_loc; S_in
// rounded to bf16 as an operand of C S_in^T (mamba_ssm stores it in C's
// dtype); W = G * L fed as a bf16 pair hi + lo = W - hi, two products, so W
// keeps about 16 bits.  The state carried between chunks is fp32 throughout,
// and the two terms of y add in fp32 and round to bf16 once.  W rounded once
// to bf16 (as the reference's XLA twin does, src/repro/models/ssm.py:84)
// passes each call's bar, but carries mamba2-780m's 48-layer prefill past
// chip_smoke.py's end-to-end gate; of the three roundings only W's moves it.
//
// fp32: the first version of this kernel, unchanged, so fp32 inputs meet
// the reference's 2e-5 bar: true fp32 products on the CUDA cores.  A
// pre-pass ssd_cb computes C B^T once per (batch row, chunk) into fp32
// scratch; then one ssd_fwd block per (batch row, head, tile of 32 state
// rows) walks the chunks in order with the state in shared memory.  No fp32
// input lies on the serving path.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at mamba2-780m's
// serving prefill (x (4,512,48,64) bf16, B/C (4,512,128) bf16, state0 and
// state_out (4,48,64,128) fp32) the inputs and outputs cross HBM once in
// 39.2 MB (11.7 us), while the products need 5.7 GFLOP over the causal
// triangle (5.7 us at the bf16 tensor-core peak): the function is bound by
// bytes, about 0.012 ms (chip_smoke.py computes both from the run's shapes).
// The split moves more than that: x is read twice, S_loc crosses in fp32
// twice and S_in in bf16 twice, about 126 MB in all, part of which stays in
// the 50 MB L2 between the kernels; its products, with W's second product,
// are about 8 GFLOP at mma.sync rates.  So the design stays bound by memory,
// and wgmma, which pays where products bound a kernel, is not needed here.
// What limits it now: within a block, loads, products and stores follow one
// another, and each grid is only 1.5 to 3 waves of resident blocks, so the
// phases overlap little across blocks (in ssd_chunk_state the loads, the
// products and the fp32 S_loc store cost about what they cost alone, added
// up); ssd_state_pass runs near the memory rate for its bytes.  Fewer bytes
// (S_loc in bf16, or phases 1 and 2 fused) or a pipeline across work items
// that keeps as many warps resident is the next step.  Shared memory per
// block at P = 64, N = 128, Q = 128: phase 1 48.5 KB (4 blocks an SM),
// phase 3 64.5 KB (2 blocks of 8 warps an SM).
//
// One call of repro_ssd_scan_fwd launches the three bf16 kernels (or
// ssd_cb, then ssd_fwd, for fp32); the wrapper counts it as one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_tiles.cuh"

namespace {

// ------------------------------------------------------------ fp32 kernels

constexpr int PT = 32;        // state rows (columns p of x) per scan block
constexpr int NT = 256;       // threads per ssd_cb block
constexpr int NT_SCAN = 512;  // threads per scan block: 16 warps to hide latency
constexpr int NMAX = 128;     // largest state width N

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

template <int Q>
size_t scan_smem_bytes(int n) {
  // C^T, B^T [n][Q]; W^T [Q][Q]; x [Q][PT]; state^T [n][PT]; a_cum, decays [Q] x 3
  return sizeof(float) * ((size_t)2 * n * Q + (size_t)Q * Q + (size_t)Q * PT +
                          (size_t)n * PT + (size_t)3 * Q);
}

template <int Q>
size_t cb_smem_bytes(int n) { return sizeof(float) * (size_t)2 * n * Q; }  // C^T, B^T

// 8 neighbouring fp32 elements: two 16-byte loads where p is 16-byte
// aligned, 8 scalar loads otherwise.
__device__ __forceinline__ void load8(const float* p, bool vec, float* out) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = p[e];
  }
}

// B and C of steps t0 .. t0+Q-1 (zero past s) into bt, ct [n][Q], widened to
// fp32.  Lanes walk time, so the stores are conflict-free; each thread reads
// 8 neighbouring n of one step, as one vector where the rows are 16-byte
// aligned (n is a multiple of 8, so they are whenever the base pointers are).
template <typename T, int Q>
__device__ __forceinline__ void load_bc(const T* __restrict__ bb, const T* __restrict__ cb,
                                        float* bt, float* ct, int t0, int s, int n) {
  const bool vec = ((reinterpret_cast<size_t>(bb) | reinterpret_cast<size_t>(cb)) & 15) == 0;
  for (int idx = threadIdx.x; idx < Q * (n / 8); idx += blockDim.x) {
    const int j = idx % Q, n8 = (idx / Q) * 8;
    float bv[8], cv[8];
    if (t0 + j < s) {
      const size_t off = (size_t)(t0 + j) * n + n8;
      load8(bb + off, vec, bv);
      load8(cb + off, vec, cv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) bv[e] = cv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bt[(n8 + e) * Q + j] = bv[e];
      ct[(n8 + e) * Q + j] = cv[e];
    }
  }
}

// C B^T of one (batch row, chunk), which every head shares (one group):
// gt[j * Q + i] = C_i . B_j for i >= j.  Entries above the diagonal are never
// read.  Thread (ti, tj) owns rows i0..i0+TI-1 and columns j0..j0+TI-1; tiles
// wholly above the diagonal do nothing.
template <typename T, int Q>
__global__ void __launch_bounds__(NT) ssd_cb(
    const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ gt, int s, int n) {
  constexpr int TI = Q / 16;
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);  // [n][Q]
  float* bt = ct + (size_t)n * Q;               // [n][Q]
  const int c = blockIdx.x, b = blockIdx.y;
  load_bc<T, Q>(bm + (size_t)b * s * n, cm + (size_t)b * s * n, bt, ct, c * Q, s, n);
  __syncthreads();

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  if (tj > ti) return;
  const int i0 = ti * TI, j0 = tj * TI;
  float acc[TI][TI];
#pragma unroll
  for (int r = 0; r < TI; ++r)
#pragma unroll
    for (int q = 0; q < TI; ++q) acc[r][q] = 0.f;
#pragma unroll 4
  for (int nn = 0; nn < n; ++nn) {
    float cv[TI], bv[TI];
#pragma unroll
    for (int r = 0; r < TI; r += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(&ct[nn * Q + i0 + r]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bt[nn * Q + j0 + r]);
      cv[r] = c4.x; cv[r + 1] = c4.y; cv[r + 2] = c4.z; cv[r + 3] = c4.w;
      bv[r] = b4.x; bv[r + 1] = b4.y; bv[r + 2] = b4.z; bv[r + 3] = b4.w;
    }
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
      for (int q = 0; q < TI; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
  }
  float* g = gt + ((size_t)b * gridDim.x + c) * Q * Q;
#pragma unroll
  for (int q = 0; q < TI; ++q)
#pragma unroll
    for (int r = 0; r < TI; r += 4)
      *reinterpret_cast<float4*>(&g[(j0 + q) * Q + i0 + r]) =
          make_float4(acc[r][q], acc[r + 1][q], acc[r + 2][q], acc[r + 3][q]);
}

template <typename T, int Q>
__global__ void __launch_bounds__(NT_SCAN, 1) ssd_fwd(
    const T* __restrict__ x, const float* __restrict__ la, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ gt, const float* __restrict__ state0,
    T* __restrict__ y, float* __restrict__ state_out, int s, int h, int p, int n) {
  constexpr int WARPS = NT_SCAN / 32;
  constexpr int RPT = Q / (NT_SCAN / 8);  // y rows per thread (row groups x 8 column groups)
  constexpr int KN = NMAX / WARPS;        // state columns per thread: n = warp + WARPS * k
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);  // [n][Q]  C^T
  float* bt = ct + (size_t)n * Q;               // [n][Q]  B^T, then B^T * exp(a_last - a_cum)
  float* wt = bt + (size_t)n * Q;               // [Q][Q]  W^T: wt[j * Q + i] = W[i][j]
  float* xs = wt + Q * Q;                       // [Q][PT]
  float* st = xs + Q * PT;                      // [n][PT] state^T
  float* ac = st + (size_t)n * PT;              // [Q] a_cum
  float* din = ac + Q;                          // [Q] exp(a_cum)
  float* dout = din + Q;                        // [Q] exp(a_last - a_cum)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * PT;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;

  const size_t row = (size_t)h * p;  // elements between time steps of x and y
  const T* xb = x + (size_t)b * s * row + (size_t)hh * p + p0;
  T* yb = y + (size_t)b * s * row + (size_t)hh * p + p0;
  const float* lab = la + (size_t)b * s * h + hh;
  const T* bb = bm + (size_t)b * s * n;
  const T* cb = cm + (size_t)b * s * n;
  const size_t sbase = ((size_t)b * h + hh) * p * n;

  for (int idx = tid; idx < PT * n; idx += NT_SCAN) {
    const int pp = idx / n, nn = idx % n;
    float v = 0.f;
    if (state0 != nullptr && p0 + pp < p) v = state0[sbase + (size_t)(p0 + pp) * n + nn];
    st[nn * PT + pp] = v;
  }

  const int nchunks = (s + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk's readers are done with every tile

    for (int idx = tid; idx < Q * PT; idx += NT_SCAN) {
      const int j = idx / PT, pp = idx % PT;
      float v = 0.f;
      if (t0 + j < s && p0 + pp < p) v = to_f32(xb[(size_t)(t0 + j) * row + pp]);
      xs[idx] = v;
    }
    load_bc<T, Q>(bb, cb, bt, ct, t0, s, n);
    if (warp == 0) {
      constexpr int E = Q / 32;  // steps per lane
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        run += (t0 + j < s) ? lab[(size_t)(t0 + j) * h] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float off = incl - run;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        const float cum = v[e] + off;
        ac[j] = cum;
        din[j] = expf(cum);
        dout[j] = expf(last - cum);
      }
    }
    __syncthreads();

    // W^T from the shared C B^T (ssd_cb), weighted by L on and below the diagonal.
    {
      const float* g = gt + ((size_t)b * nchunks + c) * Q * Q;
      for (int idx = tid; idx < Q * Q; idx += NT_SCAN) {
        const int j = idx / Q, i = idx % Q;
        wt[idx] = i >= j ? g[idx] * expf(ac[i] - ac[j]) : 0.f;
      }
    }
    __syncthreads();

    // Fold exp(a_last - a_cum_j) into B^T for the state update; y reads no B.
    for (int idx = tid; idx < n * Q; idx += NT_SCAN) bt[idx] *= dout[idx % Q];

    // y: thread (ty, tx) owns rows i0..i0+RPT-1 and columns 4*tx..4*tx+3.
    {
      const int ty = tid / 8, tx = tid % 8;
      const int i0 = ty * RPT, c0 = tx * 4;
      float yi[RPT][4], ys[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[r][e] = ys[r][e] = 0.f;
      for (int j = 0; j < i0 + RPT; ++j) {  // W[i][j] = 0 for j > i
        const float4 xv = *reinterpret_cast<const float4*>(&xs[j * PT + c0]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float w = wt[j * Q + i0 + r];
          yi[r][0] = fmaf(w, xv.x, yi[r][0]);
          yi[r][1] = fmaf(w, xv.y, yi[r][1]);
          yi[r][2] = fmaf(w, xv.z, yi[r][2]);
          yi[r][3] = fmaf(w, xv.w, yi[r][3]);
        }
      }
#pragma unroll 4
      for (int nn = 0; nn < n; ++nn) {
        const float4 sv = *reinterpret_cast<const float4*>(&st[nn * PT + c0]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float cv = ct[nn * Q + i0 + r];
          ys[r][0] = fmaf(cv, sv.x, ys[r][0]);
          ys[r][1] = fmaf(cv, sv.y, ys[r][1]);
          ys[r][2] = fmaf(cv, sv.z, ys[r][2]);
          ys[r][3] = fmaf(cv, sv.w, ys[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int t = t0 + i0 + r;
        if (t >= s) continue;
        const float di = din[i0 + r];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p0 + c0 + e < p) store_out(&yb[(size_t)t * row + c0 + e], yi[r][e] + di * ys[r][e]);
      }
    }
    __syncthreads();

    // S <- exp(a_last) S + x^T (B * exp(a_last - a_cum)): lane = row p,
    // warp w owns columns n = w + 16k.
    {
      const float e_last = din[Q - 1];
      float acc[KN];
#pragma unroll
      for (int k = 0; k < KN; ++k) acc[k] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        const float x0 = xs[(j + 0) * PT + lane];
        const float x1 = xs[(j + 1) * PT + lane];
        const float x2 = xs[(j + 2) * PT + lane];
        const float x3 = xs[(j + 3) * PT + lane];
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          const int nn = warp + WARPS * k;
          if (nn < n) {
            const float4 b4 = *reinterpret_cast<const float4*>(&bt[nn * Q + j]);
            float a = acc[k];
            a = fmaf(x0, b4.x, a);
            a = fmaf(x1, b4.y, a);
            a = fmaf(x2, b4.z, a);
            a = fmaf(x3, b4.w, a);
            acc[k] = a;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const int nn = warp + WARPS * k;
        if (nn < n) st[nn * PT + lane] = fmaf(e_last, st[nn * PT + lane], acc[k]);
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < PT * n; idx += NT_SCAN) {
    const int pp = idx / n, nn = idx % n;
    if (p0 + pp < p) state_out[sbase + (size_t)(p0 + pp) * n + nn] = st[nn * PT + pp];
  }
}

template <typename T, int Q>
cudaError_t launch(const void* x, const float* la, const void* bm, const void* cm,
                   float* gt, const float* state0, void* y, float* state_out, int b, int s,
                   int h, int p, int n, cudaStream_t stream) {
  const size_t cb_smem = cb_smem_bytes<Q>(n), scan_smem = scan_smem_bytes<Q>(n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_fwd<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_smem);
  if (err != cudaSuccess) return err;
  const T* bmt = static_cast<const T*>(bm);
  const T* cmt = static_cast<const T*>(cm);
  ssd_cb<T, Q><<<dim3((s + Q - 1) / Q, b), NT, cb_smem, stream>>>(bmt, cmt, gt, s, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p + PT - 1) / PT, h, b);
  ssd_fwd<T, Q><<<grid, NT_SCAN, scan_smem, stream>>>(
      static_cast<const T*>(x), la, bmt, cmt, gt, state0, static_cast<T*>(y), state_out,
      s, h, p, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* la, const void* bm, const void* cm,
                     float* gt, const float* state0, void* y, float* state_out, int b, int s,
                     int h, int p, int n, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 64: return launch<T, 64>(x, la, bm, cm, gt, state0, y, state_out, b, s, h, p, n, stream);
    case 128: return launch<T, 128>(x, la, bm, cm, gt, state0, y, state_out, b, s, h, p, n, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------ bf16 kernels

constexpr int TNT = 128;    // threads of ssd_chunk_state: 4 warps
constexpr int TROWS = 64;   // rows of a 64 x 64 tile of C B^T
constexpr int SP_NT = 256;  // threads of ssd_state_pass
constexpr int SP_EL = 4;    // state elements per ssd_state_pass thread

// G = C B^T of one (batch row, chunk), fp32, which every head shares (B and
// C form one group): computed once on the tensor cores, on and below the
// diagonal, in 64 x 64 tiles, and read by ssd_chunk_scan straight into
// registers.  One block per (row tile it, chunk c, batch row b), run as extra
// blocks of ssd_chunk_state's launch; warp w owns rows 16w..16w+15 of the
// tile.  C comes by plain ldmatrix as the A operand, B ([step][n], i.e. B^T
// column-major) by plain ldmatrix as the B operand; on the diagonal tile a
// warp skips 16-step groups past its rows, which the scan never reads.
template <int Q, int NW>
__device__ __forceinline__ void chunk_cb(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                                         float* __restrict__ gm, int s, int n, int vec, int it,
                                         int c, int b, int nc, unsigned char* smem) {
  using LN = Rows<NW>;
  constexpr int KN = NW / 16;  // k16 steps over N
  const uint32_t s_c = smem_u32(smem);          // [64][NW]  C rows of the tile
  const uint32_t s_b = s_c + TROWS * LN::BYTES;  // [Q][NW]   B
  const int t0 = c * Q, i0 = it * TROWS;
  if (t0 + i0 >= s) return;  // every row of this tile lies past s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  load_rows<NW>(s_c, cm + ((size_t)b * s + t0 + i0) * n, n, TROWS, s - t0 - i0, n / 8, vec);
  load_rows<NW>(s_b, bm + ((size_t)b * s + t0) * n, n, i0 + TROWS, s - t0, n / 8, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t cf[KN][4];
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
    ldmatrix_x4(cf[kk], s_c + LN::off(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
  float* gw = gm + ((size_t)b * nc + c) * Q * Q + (size_t)(i0 + 16 * warp) * Q;
  for (int jt = 0; jt <= it; ++jt) {
    const bool diag = jt == it;
    // Matrices (steps 16sb+0-7, chunk 2kk), (16sb+0-7, 2kk+1), (16sb+8-15,
    // 2kk), (16sb+8-15, 2kk+1) are b0, b1 of step tiles 2sb, 2sb+1.
    float sc[TROWS / 8][4];
#pragma unroll
    for (int st = 0; st < TROWS / 8; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[st][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
#pragma unroll
      for (int sb = 0; sb < TROWS / 16; ++sb) {
        if (diag && sb > warp) continue;
        uint32_t bk[4];
        ldmatrix_x4(bk, s_b + LN::off(jt * TROWS + 16 * sb + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * sb], cf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * sb + 1], cf[kk], bk[2], bk[3]);
      }
    // sc[st][e] is row g + 8 (e / 2) of the warp, step 64 jt + 8 st + 2t + (e % 2)
#pragma unroll
    for (int st = 0; st < TROWS / 8; ++st)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (!(diag && (st >> 1) > warp))
          *reinterpret_cast<float2*>(&gw[(size_t)(g + 8 * r) * Q + jt * TROWS + 8 * st + 2 * t]) =
              make_float2(sc[st][2 * r], sc[st][2 * r + 1]);
  }
}

// Phase 1.  S_loc[c] = X^T (B * dout), dout_j = exp(a_last - a_cum_j), the
// chunk's own contribution to the state, in fp32 (P, N); and decay[c] =
// exp(a_last).  One block per (head, chunk, batch row), and Q / 64 more per
// (chunk, batch row) for G = C B^T (chunk_cb above); warp w owns the
// 16-row tiles w, w + 4, .. of P and every column n.  B * dout is rounded to
// bf16 in shared memory; X^T comes by ldmatrix .trans from X's [step][p]
// rows, B by ldmatrix .trans from its [step][n] rows.
template <int Q, int PW, int NW>
__global__ void __launch_bounds__(TNT, 2) ssd_chunk_state(
    const bf16* __restrict__ x, const float* __restrict__ la, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, float* __restrict__ gm, float* __restrict__ s_loc,
    float* __restrict__ decay, int s, int h, int p, int n, int vec) {
  using LX = Rows<PW>;
  using LB = Rows<NW>;
  constexpr int MT = PW / 64;  // 16-row tiles of P per warp
  constexpr int NN = NW / 8;   // n8 tiles of N
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_x = smem_u32(smem);
  const uint32_t s_b = s_x + Q * LX::BYTES;
  float* ac2 = reinterpret_cast<float*>(smem + Q * (LX::BYTES + LB::BYTES));

  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  if (hh >= h) {
    chunk_cb<Q, NW>(bm, cm, gm, s, n, vec, hh - h, c, b, nc, smem);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = c * Q;
  const size_t row = (size_t)h * p;
  load_rows<PW>(s_x, x + ((size_t)b * s + t0) * row + (size_t)hh * p, row, Q, s - t0, p / 8, vec);
  load_rows<NW>(s_b, bm + ((size_t)b * s + t0) * n, n, Q, s - t0, n / 8, vec);
  cp_async_commit();
  if (warp == 0) {
    const float last = chunk_cumsum<Q>(la + (size_t)b * s * h + hh, h, t0, s, ac2);
    __syncwarp();
    for (int j = lane; j < Q; j += 32) ac2[j] = exp2_ftz(last - ac2[j]);  // now dout_j
    if (lane == 0) decay[((size_t)b * h + hh) * nc + c] = exp2_ftz(last);
  }
  cp_async_wait<0>();
  __syncthreads();

  // B * dout, rounded to bf16, in place
  for (int i = threadIdx.x; i < Q * LB::NCH; i += TNT) {
    const int j = i / LB::NCH;
    uint4* q4 = reinterpret_cast<uint4*>(smem + Q * LX::BYTES + LB::off(j, i % LB::NCH));
    uint4 u = *q4;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
    const float d = ac2[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      w[k] = pack_bf16(f.x * d, f.y * d);
    }
    *q4 = u;
  }
  __syncthreads();

  float acc[MT][NN][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    // A = X^T, rows p, k = steps 16kk..: matrices (steps +0-7, p chunk 2mt),
    // (steps +0-7, 2mt+1), (steps +8-15, 2mt), (steps +8-15, 2mt+1) are
    // a[0..3] under .trans.
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      ldmatrix_x4_trans(a[mi], s_x + LX::off(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                             2 * (warp + 4 * mi) + ((lane >> 3) & 1)));
    // B = B * dout, [step][n]: matrices (steps +0-7, chunk 2dn), (+8-15, 2dn),
    // (+0-7, 2dn+1), (+8-15, 2dn+1) are b0, b1 of n-tiles 2dn and 2dn+1.
#pragma unroll
    for (int dn = 0; dn < NN / 2; ++dn) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, s_b + LB::off(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                          2 * dn + (lane >> 4)));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][2 * dn], a[mi], bv[0], bv[1]);
        mma_bf16(acc[mi][2 * dn + 1], a[mi], bv[2], bv[3]);
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
  float* out = s_loc + (((size_t)b * nc + c) * h + hh) * p * n;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = 16 * (warp + 4 * mi) + g + 8 * r, col = 8 * nt + 2 * t;
        if (pr < p && col < n)
          *reinterpret_cast<float2*>(&out[(size_t)pr * n + col]) =
              make_float2(acc[mi][nt][2 * r], acc[mi][nt][2 * r + 1]);
      }
}

// Phase 2, the only serial pass: S_in[0] = state0 (or 0),
// S_in[c+1] = exp(a_last_c) S_in[c] + S_loc[c], elementwise in fp32 over the
// chunks; S_in is stored in bf16 for phase 3, the last state in fp32.  One
// block per (slice of P*N, head, batch row); each thread carries SP_EL
// elements, SP_NT apart, so every load and store is coalesced.
__global__ void __launch_bounds__(SP_NT) ssd_state_pass(
    const float* __restrict__ s_loc, const float* __restrict__ decay,
    const float* __restrict__ state0, bf16* __restrict__ s_in, float* __restrict__ state_out,
    int h, int pn, int nc) {
  const int hh = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * h + hh;
  const int e0 = blockIdx.x * SP_NT * SP_EL + threadIdx.x;
  float st[SP_EL];
#pragma unroll
  for (int k = 0; k < SP_EL; ++k) {
    const int e = e0 + k * SP_NT;
    st[k] = state0 != nullptr && e < pn ? state0[bh * pn + e] : 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t base = (((size_t)b * nc + c) * h + hh) * pn;
    const float d = decay[bh * nc + c];
#pragma unroll
    for (int k = 0; k < SP_EL; ++k) {
      const int e = e0 + k * SP_NT;
      if (e < pn) {
        s_in[base + e] = __float2bfloat16_rn(st[k]);
        st[k] = fmaf(d, st[k], s_loc[base + e]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SP_EL; ++k) {
    const int e = e0 + k * SP_NT;
    if (e < pn) state_out[bh * pn + e] = st[k];
  }
}

// Phase 3.  y = (L * C B^T) X + diag(exp(a_cum)) C S_in[c]^T for one chunk.
// One block of Q / 16 warps per (head, chunk, batch row); warp w owns rows
// 16w..16w+15, so it reads S_in and X once per chunk.  The
// inter-chunk term C S_in^T takes C by plain ldmatrix (A) and S_in, stored
// [p][n], by plain ldmatrix (B = S_in^T column-major).  For the intra-chunk
// term, the warp loads its rows of G = C B^T (chunk_cb) from L2 into
// registers in the m16n8k16 accumulator layout, one 64-step tile at a time up
// to its diagonal, the first while C S_in^T runs; weights them by
// exp(a_cum_i - a_cum_j) on and below the diagonal only, and splits W into a
// bf16 pair hi + lo in place as A operands (the accumulator layout is the A
// layout), so W X is two products, X by ldmatrix .trans.  Both terms add in
// fp32 and y is rounded once, staged through shared memory so each thread
// writes 16 bytes.
template <int Q, int PW, int NW>
__global__ void __launch_bounds__(2 * Q, (PW == 64 ? 4 : 2) * 64 / Q) ssd_chunk_scan(
    const bf16* __restrict__ x, const float* __restrict__ la, const bf16* __restrict__ cm,
    const float* __restrict__ gm, const bf16* __restrict__ s_in, bf16* __restrict__ y, int s,
    int h, int p, int n, int vec) {
  using LX = Rows<PW>;
  using LN = Rows<NW>;
  constexpr int TILES = Q / TROWS;  // 64-step tiles of the chunk
  constexpr int KN = NW / 16;     // k16 steps over N
  constexpr int NP = PW / 8;      // n8 tiles of y's columns
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_c = smem_u32(smem);      // [Q][NW]   C
  const uint32_t s_s = s_c + Q * LN::BYTES;  // [PW][NW]  S_in
  const uint32_t s_x = s_s + PW * LN::BYTES;  // [Q][PW]   X, then y's rows
  float* ac2 = reinterpret_cast<float*>(smem + (Q + PW) * LN::BYTES + Q * LX::BYTES);

  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)h * p;
  const bf16* xb = x + ((size_t)b * s + t0) * row + (size_t)hh * p;

  // group 0: C and S_in; group 1 + jt: X of steps 64jt .. 64jt+63
  load_rows<NW>(s_c, cm + ((size_t)b * s + t0) * n, n, Q, s - t0, n / 8, vec);
  load_rows<NW>(s_s, s_in + (((size_t)b * nc + c) * h + hh) * p * n, n, PW, p, n / 8, true);
  cp_async_commit();
#pragma unroll
  for (int jt = 0; jt < TILES; ++jt) {
    const int j0 = jt * TROWS;
    load_rows<PW>(s_x + j0 * LX::BYTES, xb + (size_t)j0 * row, row, TROWS, s - t0 - j0, p / 8, vec);
    cp_async_commit();
  }
  if (warp == 0) chunk_cumsum<Q>(la + (size_t)b * s * h + hh, h, t0, s, ac2);

  const int wr = 16 * warp;                         // the warp's first row in the chunk
  const int wt = wr / TROWS, wq = wr % TROWS / 16;  // its step tile and place in it
  const bool live = t0 + wr < s;  // G has no rows for a warp wholly past s
  const float* gw = gm + ((size_t)b * nc + c) * Q * Q + (size_t)wr * Q;
  // G of step tile jt: sc[st][e] is row wr + g + 8 (e / 2), step
  // 64 jt + 8 st + 2t + (e % 2); groups past the diagonal are 0, never read.
  float sc[TROWS / 8][4];
  auto load_g = [&](int jt) {
#pragma unroll
    for (int st = 0; st < TROWS / 8; ++st)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(0.f, 0.f);
        if (live && !(jt == wt && (st >> 1) > wq))
          v = *reinterpret_cast<const float2*>(&gw[(size_t)(g + 8 * r) * Q + jt * TROWS + 8 * st + 2 * t]);
        sc[st][2 * r] = v.x;
        sc[st][2 * r + 1] = v.y;
      }
  };
  load_g(0);
  cp_async_wait<TILES>();
  __syncthreads();

  // Inter-chunk term: matrices (p 16pb+0-7, chunk 2kk), (16pb+0-7, 2kk+1),
  // (16pb+8-15, 2kk), (16pb+8-15, 2kk+1) are b0, b1 of p-tiles 2pb, 2pb+1.
  float acc[NP][4];
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[np][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    uint32_t cf[4];
    ldmatrix_x4(cf, s_c + LN::off(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int pb = 0; pb < NP / 2; ++pb) {
      uint32_t bs[4];
      ldmatrix_x4(bs, s_s + LN::off(16 * pb + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * pb], cf, bs[0], bs[1]);
      mma_bf16(acc[2 * pb + 1], cf, bs[2], bs[3]);
    }
  }
  const float ai[2] = {ac2[wr + g], ac2[wr + g + 8]};
  {
    const float di[2] = {exp2_ftz(ai[0]), exp2_ftz(ai[1])};
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[np][e] *= di[e >> 1];
  }

  // Intra-chunk term over the step tiles jt <= wt.
#pragma unroll
  for (int jt = 0; jt < TILES; ++jt) {
    if (jt > 0 && jt <= wt) load_g(jt);
    if (jt == 0) cp_async_wait<TILES - 1>();
    else cp_async_wait<0>();
    __syncthreads();
    if (jt > wt) continue;
    const int j0 = jt * TROWS;
    const bool diag = jt == wt;  // the tile that holds the warp's diagonal
#pragma unroll
    for (int st = 0; st < TROWS / 8; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = wr + g + 8 * (e >> 1), j = j0 + 8 * st + 2 * t + (e & 1);
        sc[st][e] = j <= i ? sc[st][e] * exp2_ftz(ai[e >> 1] - ac2[j]) : 0.f;
      }
    // y += W X, W = hi + lo: the accumulators of step tiles 2kk, 2kk+1 are
    // W's A fragment for steps 16kk..16kk+15; X [step][p] by .trans:
    // matrices (steps 16kk+0-7, chunk 2dp), (16kk+8-15, 2dp), (16kk+0-7,
    // 2dp+1), (16kk+8-15, 2dp+1) are b0, b1 of p-tiles 2dp, 2dp+1.
#pragma unroll
    for (int kk = 0; kk < TROWS / 16; ++kk) {
      if (diag && kk > wq) continue;
      uint32_t wh[4], wl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], wh[0], wl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], wh[1], wl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], wh[2], wl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], wh[3], wl[3]);
#pragma unroll
      for (int dp = 0; dp < NP / 2; ++dp) {
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, s_x + LX::off(j0 + 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                            2 * dp + (lane >> 4)));
        mma_bf16(acc[2 * dp], wh, bx[0], bx[1]);
        mma_bf16(acc[2 * dp + 1], wh, bx[2], bx[3]);
        mma_bf16(acc[2 * dp], wl, bx[0], bx[1]);
        mma_bf16(acc[2 * dp + 1], wl, bx[2], bx[3]);
      }
    }
  }

  // Stage the warp's 16 rows of y in its rows of X (after every warp is done
  // with X), then write them out as 16-byte chunks.
  __syncthreads();
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t a = s_x + LX::off(16 * warp + g + 8 * r, np) + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                   "r"(pack_bf16(acc[np][2 * r], acc[np][2 * r + 1])));
    }
  __syncwarp();
  bf16* yb = y + ((size_t)b * s + t0 + wr) * row + (size_t)hh * p;
  for (int i = lane; i < 16 * NP; i += 32) {
    const int r = i / NP, ch = i % NP;
    if (t0 + wr + r < s && ch < p / 8) {
      uint4 u;
      asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                   : "r"(s_x + LX::off(16 * warp + r, ch)));
      *reinterpret_cast<uint4*>(yb + (size_t)r * row + ch * 8) = u;
    }
  }
}

template <int Q, int PW, int NW>
constexpr int state_smem() {  // the larger of a state block's and a C B^T block's
  return Q * (PW + NW) * 2 + Q * 4 > (TROWS + Q) * NW * 2 ? Q * (PW + NW) * 2 + Q * 4
                                                          : (TROWS + Q) * NW * 2;
}
template <int Q, int PW, int NW>
constexpr int scan_smem() { return (Q + PW) * NW * 2 + Q * PW * 2 + Q * 4; }

template <typename K>
cudaError_t prefer_shared(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int Q, int PW, int NW>
cudaError_t launch_bf16(const bf16* x, const float* la, const bf16* bm, const bf16* cm,
                        float* gm, float* s_loc, bf16* s_in, float* decay, const float* state0,
                        bf16* y, float* state_out, int b, int s, int h, int p, int n, int vec,
                        cudaStream_t stream) {
  constexpr int sts = state_smem<Q, PW, NW>(), scs = scan_smem<Q, PW, NW>();
  cudaError_t err = prefer_shared(ssd_chunk_state<Q, PW, NW>, sts);
  if (err != cudaSuccess) return err;
  err = prefer_shared(ssd_chunk_scan<Q, PW, NW>, scs);
  if (err != cudaSuccess) return err;
  const int nc = (s + Q - 1) / Q;
  ssd_chunk_state<Q, PW, NW><<<dim3(h + Q / TROWS, nc, b), TNT, sts, stream>>>(
      x, la, bm, cm, gm, s_loc, decay, s, h, p, n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn = p * n;
  ssd_state_pass<<<dim3((pn + SP_NT * SP_EL - 1) / (SP_NT * SP_EL), h, b), SP_NT, 0, stream>>>(
      s_loc, decay, state0, s_in, state_out, h, pn, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<Q, PW, NW><<<dim3(h, nc, b), 2 * Q, scs, stream>>>(
      x, la, cm, gm, s_in, y, s, h, p, n, vec);
  return cudaGetLastError();
}

template <int Q>
cudaError_t dispatch_bf16(const bf16* x, const float* la, const bf16* bm, const bf16* cm,
                          float* gm, float* s_loc, bf16* s_in, float* decay, const float* state0, bf16* y,
                          float* state_out, int b, int s, int h, int p, int n, int vec,
                          cudaStream_t st) {
#define REPRO_SSD_CASE(PW, NW)                                                                   \
  return launch_bf16<Q, PW, NW>(x, la, bm, cm, gm, s_loc, s_in, decay, state0, y, state_out, b, s, \
                                h, p, n, vec, st)
  if (p <= 64) {
    if (n <= 64) REPRO_SSD_CASE(64, 64);
    REPRO_SSD_CASE(64, 128);
  }
  if (n <= 64) REPRO_SSD_CASE(128, 64);
  REPRO_SSD_CASE(128, 128);
#undef REPRO_SSD_CASE
}

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// The scratch one call needs, carved from `base` when it is not null: C B^T
// of each (batch row, chunk), b * nc * chunk^2 floats; for bf16 also S_loc
// (b, nc, h, p, n) fp32, S_in (b, nc, h, p, n) bf16 and decay (b, h, nc)
// fp32; each on a 256-byte boundary.
size_t scratch_layout(int b, int s, int h, int p, int n, int chunk, int is_bf16, char* base,
                      float** cb, float** s_loc, bf16** s_in, float** decay) {
  const size_t nc = (size_t)(s + chunk - 1) / chunk;
  const size_t cb_bytes = align256(sizeof(float) * b * nc * chunk * chunk);
  if (base != nullptr) *cb = reinterpret_cast<float*>(base);
  if (!is_bf16) return cb_bytes;
  const size_t states = (size_t)b * nc * h * p * n;
  const size_t loc_bytes = align256(sizeof(float) * states);
  const size_t in_bytes = align256(sizeof(bf16) * states);
  if (base != nullptr) {
    *s_loc = reinterpret_cast<float*>(base + cb_bytes);
    *s_in = reinterpret_cast<bf16*>(base + cb_bytes + loc_bytes);
    *decay = reinterpret_cast<float*>(base + cb_bytes + loc_bytes + in_bytes);
  }
  return cb_bytes + loc_bytes + in_bytes + align256(sizeof(float) * b * h * nc);
}

bool valid_shape(int b, int s, int h, int p, int n, int chunk) {
  return b > 0 && s > 0 && h > 0 && p > 0 && p <= 128 && p % 8 == 0 && n > 0 && n <= NMAX &&
         n % 8 == 0 && (chunk == 64 || chunk == 128) && b <= 65535 &&
         (s + chunk - 1) / chunk <= 65535;
}

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).

// Bytes of scratch that repro_ssd_scan_fwd needs for this shape (0 for a
// shape it refuses).
extern "C" size_t repro_ssd_scan_scratch_bytes(int b, int s, int h, int p, int n, int chunk,
                                               int is_bf16) {
  if (!valid_shape(b, s, h, p, n, chunk)) return 0;
  return scratch_layout(b, s, h, p, n, chunk, is_bf16, nullptr, nullptr, nullptr, nullptr,
                        nullptr);
}

// `state0` may be null (a zero initial state).  `scratch` holds
// repro_ssd_scan_scratch_bytes(...) bytes on a 256-byte boundary.  Returns a
// cudaError_t: 0 when every launch was accepted.  The wrapper checks devices,
// dtypes, shapes and contiguity before it calls this.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const float* log_da, const void* bmat, const void* cmat, void* scratch,
    const float* state0, void* y, float* state_out, int b, int s, int h, int p, int n,
    int chunk, int is_bf16, void* stream) {
  if (!valid_shape(b, s, h, p, n, chunk)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(scratch) & 255) || (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *cb = nullptr, *s_loc = nullptr, *decay = nullptr;
  bf16* s_in = nullptr;
  scratch_layout(b, s, h, p, n, chunk, is_bf16, static_cast<char*>(scratch), &cb, &s_loc, &s_in,
                 &decay);
  if (!is_bf16)
    return (int)dispatch<float>(x, log_da, bmat, cmat, cb, state0, y, state_out, b, s, h, p, n,
                                chunk, st);
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bmat) |
                    reinterpret_cast<uintptr_t>(cmat)) & 15) == 0;
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(bmat),
             *cb16 = static_cast<const bf16*>(cmat);
  bf16* yb = static_cast<bf16*>(y);
  return (int)(chunk == 64
      ? dispatch_bf16<64>(xb, log_da, bb, cb16, cb, s_loc, s_in, decay, state0, yb, state_out, b, s, h, p, n, vec, st)
      : dispatch_bf16<128>(xb, log_da, bb, cb16, cb, s_loc, s_in, decay, state0, yb, state_out, b, s, h, p, n, vec, st));
}
