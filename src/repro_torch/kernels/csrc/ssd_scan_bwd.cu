// Mamba2 chunked SSD scan for Hopper (sm_90a): the backward pass.
//
// Replaces jax.grad of the reference's XLA twin of the scan,
// src/repro/models/ssm.py::ssd_chunked (:49), which is what the reference
// differentiates when it trains: its Pallas kernel
// (src/repro/kernels/ssd_scan.py) has no gradient, and no Pallas kernel of
// the reference has one.  The forward stays csrc/ssd_scan.cu; this file is
// the backward that kernels/ops.py binds to it as a torch.autograd.Function.
//
// Per head and chunk of Q steps, with a_i = cumsum(log_da) within the chunk,
// A = a_{Q-1}, S the chunk's incoming state (P x N) and S' its outgoing one,
// the forward is
//
//   y_i = sum_{j<=i} e^{a_i-a_j} (c_i.b_j) x_j + e^{a_i} S c_i
//   S'  = e^A S + sum_j e^{A-a_j} x_j b_j^T
//
// and, given dy and dS', the backward is
//
//   dx_j = sum_{i>=j} e^{a_i-a_j} (c_i.b_j) dy_i + e^{A-a_j} dS' b_j
//   db_j = sum_{i>=j} e^{a_i-a_j} (dy_i.x_j) c_i + e^{A-a_j} dS'^T x_j   (summed over heads)
//   dc_i = sum_{j<=i} e^{a_i-a_j} (dy_i.x_j) b_j + e^{a_i} S^T dy_i      (summed over heads)
//   dS   = e^A dS' + sum_i e^{a_i} dy_i c_i^T
//
// and with G_ij = e^{a_i-a_j} (c_i.b_j)(dy_i.x_j) (j <= i), R_i = c_i.(e^{a_i}
// S^T dy_i) and T_j = x_j.(e^{A-a_j} dS' b_j):
//
//   da_k = sum_j G_kj - sum_i G_ik + R_k - T_k,  plus e^A <dS', S> + sum_j T_j at k = Q-1,
//
// and dlog_da is the reverse cumulative sum of da within the chunk.  A ragged
// S has the semantics of zero padding, as in the forward: steps past S load
// x, dy, B, C and log_da as 0 and write nothing, and the term at k = Q-1
// reaches the real steps through the reverse cumulative sum.
//
// Layout: x/dy/dx (B, S, H, P) and B/C/dB/dC (B, S, N) in fp32 or bf16 (one
// dtype), log_da/dlog_da (B, S, H) fp32, state0/dstate/dstate0 (B, H, P, N)
// fp32, all contiguous; B and C form one group shared by all heads.  P and N
// are multiples of 8 up to 128; Q is 64 or 128.  No kernel uses atomics, and
// every sum runs in a fixed order, so two calls on the same inputs return the
// same bits.
//
// bf16: Mamba2's chunk-parallel split on the tensor cores, in five kernels.
// Every product is mma.sync m16n8k16 with bf16 operands and fp32 sums; tiles
// arrive by cp.async (zero-filled past S, P and N; element loads where an
// input is not 16-byte aligned) into XOR-swizzled bf16 rows read by ldmatrix
// (bf16_tiles.cuh, shared with the forward), and only the causal triangle of
// each Q x Q product is computed, in 16-step tiles.
//
//   1. tc_chunk_state, one 4-warp block per (head, chunk, batch row) for the
//      chunk's local state S_loc = X^T diag(e^{A-a}) B, one for its local
//      U_loc = dY^T diag(e^a) C (both fp32 (P, N) scratch), and Q/64 per
//      (chunk, batch row) for C B^T, which every head shares, once, in fp32,
//      transposed ([j][i] = c_i.b_j) and only on and above the diagonal;
//   2. tc_state_pass, the only serial pass and an elementwise one, one block
//      per (slice of P*N, head, batch row): S_in forward over the chunks and
//      dS' backward, both carried in fp32 and stored in bf16 for the
//      products; S_in also as the bf16 remainder S_in - hi, so <dS', S_in>
//      is summed in fp32 from dS' and hi + lo (one partial sum per warp and
//      chunk); dstate0;
//   3. tc_chunk_dx, one block of Q/16 warps per (group of HG heads, chunk,
//      batch row), the heads in turn, B, C and the chunk's (C B^T)^T loaded
//      once; a warp owns 16 rows as j: M^T = L * (C B^T)^T and dY X^T's
//      transpose for the triangle's tiles i >= j, G's row sums within the
//      warp and its column sums across warps in shared memory (fixed
//      order), dx = M^T dY + diag(e^{A-a}) B dS'^T with T from the second
//      term, R from (C S_in^T) . dy, <dS', S>, da and dlog_da;
//   4. tc_chunk_dbdc, one block of 2Q/16 warps per (group of HG heads, chunk,
//      batch row): warp w < Q/16 sums dB's rows j, the others dC's rows i,
//      over the group's heads in order, in fp32 registers: E = L * dY X^T
//      (recomputed by each side in its own orientation, so it never crosses
//      shared memory) times C or B, and (X e^{A-a}) dS' or (dY e^a) S_in;
//   5. bwd_head_sum: dB and dC, the sum of the groups' partials in group order.
//
// Rounding points of the bf16 path, all others fp32.  The products of the
// original inputs (C B^T, dY X^T and the local states' X and dY) round
// nothing: their operands are bf16 already.  New roundings appear only where
// an fp32 value becomes a bf16 operand: B e^{A-a} and C e^a (S_loc, U_loc),
// S_in and dS' (every product with a state), M and E, and X e^{A-a} and
// dY e^a (the inter-chunk terms of dB and dC).  G's row and column sums, R,
// T and <dS', S> come from fp32 values: the cancelling reverse cumulative sum
// of dlog_da never sees a rounded operand.  dx, dB and dC round once to bf16
// on the way out.  tests/test_torch_ssm.py repeats these roundings on the CPU
// (_split_scan_bwd(rounded=True)) and holds them within the bf16 bar of
// autograd of the plain scan and of jax.grad of the reference's twin; the
// worst error there is a tenth of the bar, so M and E need no hi + lo pair.
//
// Shared memory at Q 128, P 64, N 128: tc_chunk_state 48.5 KB (4 blocks an
// SM); tc_chunk_dx 170.5 KB (B, C, the sums, (C B^T)^T's 36 tiles, one
// head's X, dY, S_in and dS'; 1 block of 8 warps; at P = N = 128 the tiles
// do not fit and are read from L2); tc_chunk_dbdc 128.5 KB (1 block of 16
// warps, which fill the register file).  A block walks its group's heads
// with one stage of shared memory; a second stage, to load the next head
// while this one computes, ran slower in trial builds on the H100 (it
// leaves too little L1 for the reads that repeat across the group's heads),
// so tc_chunk_dx instead loads the next head's S_in and dS' during the
// triangle, which reads no state.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at mamba2-780m's
// training shape (x (2,4096,48,64) bf16, N 128) the inputs and outputs cross
// HBM once in about 170 MB (0.05 ms), and the products over the causal
// triangle and the state terms are about 52 GFLOP (0.05 ms at the bf16
// tensor-core peak); chip_smoke.py computes both from the run's shapes.  The
// split moves more: x and dy are read three times, and the scratch (C B^T
// 4.2 MB; S_loc and U_loc 201 MB in fp32; S_in hi and lo and dS' 151 MB in
// bf16; the groups' dB and dC partials 50 MB in fp32; 408 MB allocated in
// all, against 604 MB for the fp32 layout) crosses HBM in about 0.96 GB a
// call: S_loc and U_loc written and read, the bf16 states written, S_in's
// pair read back by the pass, S_in and dS' read by kernels 3 and 4, the
// partials written and read.  With x and dy (three reads) and dx, about
// 1.3 GB (0.39 ms at the HBM rate) cross HBM a call.  Its products, with
// dY X^T computed three times over the triangle, are about 67 GFLOP at
// mma.sync rates, and its ldmatrix reads about as many bytes of shared
// memory per product as the SM can deliver.  tc_chunk_dx and tc_chunk_dbdc,
// one block an SM, reach neither bound; trial builds that removed parts of
// them point at the latency of their ldmatrix -> mma chains and block-wide
// barriers rather than at bytes.  tc_state_pass runs near the HBM rate.
// Less scratch (S_loc and U_loc in fp32 are half of it) and wgmma, whose B
// operand is read from shared memory once per warpgroup, are the next levers.
//
// fp32: four kernels on the CUDA cores, instantiated for float only, so fp32
// inputs meet the 2e-5 bar: every product as fp32 FMAs over the full Q x Q
// square, operands streamed from device
// memory in K tiles of 32 through one staging buffer, M and E resident in
// shared memory, the chunks' states and per-head dB and dC partials in fp32
// scratch (bwd_chunk_state, bwd_state_pass, bwd_chunk, bwd_head_sum).  No fp32
// input lies on the training path.
//
// One call of repro_ssd_scan_bwd launches five kernels (bf16) or four (fp32);
// the wrapper counts it as one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_tiles.cuh"

namespace {

// ================================================================= fp32 path

constexpr int NT = 256;      // threads of bwd_chunk_state and bwd_chunk: a 16 x 16 grid
constexpr int KT = 32;       // depth of one staged K tile
constexpr int SP_NT = 256;   // threads of bwd_state_pass
constexpr int SP_EL = 4;     // state elements per bwd_state_pass thread
constexpr int HS_NT = 256;   // threads of bwd_head_sum

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// A strided matrix in device memory: element (u, v) at p[u * su + v * sv],
// zero where u >= nu or v >= nv, times uscale[u] (shared memory) if given.
template <typename T>
struct View {
  const T* p;
  long long su, sv;
  int nu, nv;
  const float* uscale;
  __device__ __forceinline__ float get(int u, int v) const {
    if (u >= nu || v >= nv) return 0.f;
    const float x = ld(p + u * su + v * sv);
    return uscale != nullptr ? x * uscale[u] : x;
  }
};

// Stage A(r, k0 + kk) for r < RM, kk < KT into as[r][KT + 1].  Lanes walk the
// index along which A is contiguous, so the loads coalesce; the row padding
// keeps the stores free of bank conflicts either way.
template <int RM, typename T>
__device__ __forceinline__ void stage_a(float* as, const View<T>& a, int k0) {
  if (a.sv == 1) {
    for (int idx = threadIdx.x; idx < RM * KT; idx += NT) {
      const int r = idx / KT, kk = idx % KT;
      as[r * (KT + 1) + kk] = a.get(r, k0 + kk);
    }
  } else {
    for (int idx = threadIdx.x; idx < RM * KT; idx += NT) {
      const int kk = idx / RM, r = idx % RM;
      as[r * (KT + 1) + kk] = a.get(r, k0 + kk);
    }
  }
}

// Stage B(k0 + kk, c) for kk < KT, c < CM into bs[kk][CM + 1].
template <int CM, typename T>
__device__ __forceinline__ void stage_b(float* bs, const View<T>& b, int k0) {
  if (b.sv == 1) {
    for (int idx = threadIdx.x; idx < KT * CM; idx += NT) {
      const int kk = idx / CM, c = idx % CM;
      bs[kk * (CM + 1) + c] = b.get(k0 + kk, c);
    }
  } else {
    for (int idx = threadIdx.x; idx < KT * CM; idx += NT) {
      const int c = idx / KT, kk = idx % KT;
      bs[kk * (CM + 1) + c] = b.get(k0 + kk, c);
    }
  }
}

// acc[i][j] += sum_{k < K} A(r_i, k) B(k, c_j), with r_i = ty * RM/16 + i and
// c_j = tx + 16 j for thread (ty, tx) of the 16 x 16 grid; both operands
// streamed from device memory.
template <int RM, int CM, typename TA, typename TB>
__device__ __forceinline__ void gemm_gg(float (&acc)[RM / 16][CM / 16], const View<TA>& a,
                                        const View<TB>& b, int k_len, float* as, float* bs) {
  constexpr int RT = RM / 16, CT = CM / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < k_len; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    stage_a<RM>(as, a, k0);
    stage_b<CM>(bs, b, k0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float av[RT], bv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = as[(ty * RT + i) * (KT + 1) + kk];
#pragma unroll
      for (int j = 0; j < CT; ++j) bv[j] = bs[kk * (CM + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The same with A resident in shared memory: A(r, k) = a_sm[r * ars + k * aks].
template <int RM, int CM, typename TB>
__device__ __forceinline__ void gemm_sg(float (&acc)[RM / 16][CM / 16], const float* a_sm, int ars,
                                        int aks, const View<TB>& b, int k_len, float* bs) {
  constexpr int RT = RM / 16, CT = CM / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < k_len; k0 += KT) {
    __syncthreads();
    stage_b<CM>(bs, b, k0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float av[RT], bv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = a_sm[(ty * RT + i) * ars + (k0 + kk) * aks];
#pragma unroll
      for (int j = 0; j < CT; ++j) bv[j] = bs[kk * (CM + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <int RT, int CT>
__device__ __forceinline__ void zero(float (&acc)[RT][CT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
}

// a_cum of the chunk (zero past s) into ac[Q], e^{a} into win and
// e^{A - a} into wout; one warp, as the forward's scan computes it.
template <int Q>
__device__ __forceinline__ void chunk_decays(const float* __restrict__ lab, int h, int nvalid,
                                             float* ac, float* win, float* wout) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  constexpr int E = Q / 32;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    run += j < nvalid ? lab[(size_t)j * h] : 0.f;
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
    win[j] = expf(cum);
    wout[j] = expf(last - cum);
  }
}

// ---------------------------------------------------------------- phase 1
// S_loc = X^T diag(e^{A-a}) B and U_loc = dY^T diag(e^{a}) C of one
// (head, chunk, batch row), each (P, N) fp32; and e^A.
template <typename T, int Q, int PW, int NW>
__global__ void __launch_bounds__(NT, 2) bwd_chunk_state(
    const T* __restrict__ x, const float* __restrict__ la, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ dy, float* __restrict__ s_loc,
    float* __restrict__ u_loc, float* __restrict__ decay, int s, int h, int p, int n) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [PW][KT + 1]
  float* bs = as + PW * (KT + 1);                // [KT][NW + 1]
  float* ac = bs + KT * (NW + 1);                // [Q]
  float* win = ac + Q;                           // [Q]
  float* wout = win + Q;                         // [Q]
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * Q, nvalid = min(Q, s - t0);
  const long long hp = (long long)h * p;
  const size_t xbase = ((size_t)b * s + t0) * hp + (size_t)hh * p;
  const size_t bbase = ((size_t)b * s + t0) * n;
  chunk_decays<Q>(la + ((size_t)b * s + t0) * h + hh, h, nvalid, ac, win, wout);
  __syncthreads();
  if (threadIdx.x == 0) decay[((size_t)b * h + hh) * nc + c] = win[Q - 1];

  constexpr int RT = PW / 16, CT = NW / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t sbase = (((size_t)b * nc + c) * h + hh) * (size_t)p * n;
  float acc[RT][CT];
  for (int which = 0; which < 2; ++which) {
    // which 0: A = X^T (r = p, k = j), B = diag(e^{A-a}) B;  1: dY^T and diag(e^a) C
    const View<T> a{(which ? dy : x) + xbase, 1, hp, p, nvalid, nullptr};
    const View<T> bv{(which ? cm : bm) + bbase, n, 1, nvalid, n, which ? win : wout};
    zero(acc);
    gemm_gg<PW, NW>(acc, a, bv, Q, as, bs);
    float* out = (which ? u_loc : s_loc) + sbase;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        if (r < p && col < n) out[(size_t)r * n + col] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------- phase 2
// In place: s_io[c] holds S_loc[c] and becomes S_in[c]; u_io[c] holds
// U_loc[c] and becomes dS_out[c].  S_in[0] = state0 (or 0), S_in[c+1] =
// e^{A_c} S_in[c] + S_loc[c]; dS_out[nc-1] = dstate (or 0), dS_out[c-1] =
// e^{A_c} dS_out[c] + U_loc[c]; dstate0 = e^{A_0} dS_out[0] + U_loc[0].
__global__ void __launch_bounds__(SP_NT) bwd_state_pass(
    float* __restrict__ s_io, float* __restrict__ u_io, const float* __restrict__ decay,
    const float* __restrict__ state0, const float* __restrict__ dstate,
    float* __restrict__ dstate0, int h, int pn, int nc) {
  const int hh = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * h + hh;
  const int e0 = blockIdx.x * SP_NT * SP_EL + threadIdx.x;
  float v[SP_EL];
#pragma unroll
  for (int k = 0; k < SP_EL; ++k) {
    const int e = e0 + k * SP_NT;
    v[k] = state0 != nullptr && e < pn ? state0[bh * pn + e] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const size_t base = (((size_t)b * nc + c) * h + hh) * pn;
    const float d = decay[bh * nc + c];
#pragma unroll
    for (int k = 0; k < SP_EL; ++k) {
      const int e = e0 + k * SP_NT;
      if (e < pn) {
        const float loc = s_io[base + e];
        s_io[base + e] = v[k];
        v[k] = fmaf(d, v[k], loc);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SP_EL; ++k) {
    const int e = e0 + k * SP_NT;
    v[k] = dstate != nullptr && e < pn ? dstate[bh * pn + e] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const size_t base = (((size_t)b * nc + c) * h + hh) * pn;
    const float d = decay[bh * nc + c];
#pragma unroll
    for (int k = 0; k < SP_EL; ++k) {
      const int e = e0 + k * SP_NT;
      if (e < pn) {
        const float loc = u_io[base + e];
        u_io[base + e] = v[k];
        v[k] = fmaf(d, v[k], loc);
      }
    }
  }
  if (dstate0 != nullptr) {
#pragma unroll
    for (int k = 0; k < SP_EL; ++k) {
      const int e = e0 + k * SP_NT;
      if (e < pn) dstate0[bh * pn + e] = v[k];
    }
  }
}

// ---------------------------------------------------------------- phase 3
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int Q, int PW, int NW>
constexpr size_t chunk_smem() {
  constexpr int CM = cmax(Q, cmax(PW, NW));
  return sizeof(float) * ((size_t)2 * Q * (Q + 1) + (size_t)Q * (KT + 1) + (size_t)KT * (CM + 1) +
                          (size_t)2 * 16 * Q + (size_t)5 * Q + 32);
}

template <int Q, int PW, int NW>
constexpr size_t state_smem() {
  return sizeof(float) * ((size_t)PW * (KT + 1) + (size_t)KT * (NW + 1) + (size_t)3 * Q);
}

template <typename T, int Q, int PW, int NW>
__global__ void __launch_bounds__(NT, 1) bwd_chunk(
    const T* __restrict__ x, const float* __restrict__ la, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ dy, const float* __restrict__ s_in,
    const float* __restrict__ ds_out, T* __restrict__ dx, float* __restrict__ dla,
    float* __restrict__ dbp, float* __restrict__ dcp, int s, int h, int p, int n) {
  constexpr int LDQ = Q + 1;
  constexpr int RT = Q / 16;
  extern __shared__ float4 smem4[];
  float* msm = reinterpret_cast<float*>(smem4);  // [Q][Q + 1]  M = L * C B^T
  float* esm = msm + Q * LDQ;                    // [Q][Q + 1]  E = L * dY X^T
  float* as = esm + Q * LDQ;                     // [Q][KT + 1]
  float* bs = as + Q * (KT + 1);                 // [KT][CM + 1]
  float* part_r = bs + KT * (cmax(Q, cmax(PW, NW)) + 1);  // [16][Q] partial sums by row
  float* part_c = part_r + 16 * Q;               // [16][Q]
  float* ac = part_c + 16 * Q;                   // [Q] a_cum
  float* win = ac + Q;                           // [Q] e^{a}
  float* wout = win + Q;                         // [Q] e^{A - a}
  float* da = wout + Q;                          // [Q]
  float* tv = da + Q;                            // [Q] T
  float* red = tv + Q;                           // [32] block reduction

  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * Q, nvalid = min(Q, s - t0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long hp = (long long)h * p;
  const size_t xbase = ((size_t)b * s + t0) * hp + (size_t)hh * p;
  const size_t bbase = ((size_t)b * s + t0) * n;
  const size_t sbase = (((size_t)b * nc + c) * h + hh) * (size_t)p * n;
  const size_t pbase = (((size_t)b * h + hh) * s + t0) * n;  // per-head dB / dC partials
  const T* xb = x + xbase;
  const T* dyb = dy + xbase;
  const T* bb = bm + bbase;
  const T* cb = cm + bbase;
  const float* sb = s_in + sbase;
  const float* gb = ds_out + sbase;

  chunk_decays<Q>(la + ((size_t)b * s + t0) * h + hh, h, nvalid, ac, win, wout);
  __syncthreads();

  // ---- M = L * C B^T, E = L * dY X^T, and the row and column sums of G = M * dY X^T
  {
    constexpr int CT = Q / 16;
    float acc[RT][CT];
    zero(acc);
    gemm_gg<Q, Q>(acc, View<T>{cb, n, 1, nvalid, n, nullptr}, View<T>{bb, 1, n, n, nvalid, nullptr},
                  n, as, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        msm[r * LDQ + col] = r >= col ? acc[i][j] * expf(ac[r] - ac[col]) : 0.f;
      }
    }
    zero(acc);
    gemm_gg<Q, Q>(acc, View<T>{dyb, hp, 1, nvalid, p, nullptr}, View<T>{xb, 1, hp, p, nvalid, nullptr},
                  p, as, bs);
    float colp[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) colp[j] = 0.f;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
      float rowp = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        const float l = r >= col ? expf(ac[r] - ac[col]) : 0.f;
        esm[r * LDQ + col] = l * acc[i][j];
        const float g = msm[r * LDQ + col] * acc[i][j];
        rowp += g;
        colp[j] += g;
      }
      part_r[tx * Q + r] = rowp;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) part_c[ty * Q + tx + 16 * j] = colp[j];
    __syncthreads();
    for (int t = tid; t < Q; t += NT) {
      float rs = 0.f, cs = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        rs += part_r[k * Q + t];
        cs += part_c[k * Q + t];
      }
      da[t] = rs - cs;
    }
    __syncthreads();
  }

  // ---- dx = M^T dY + diag(e^{A-a}) B dS'^T; T_j = x_j . (e^{A-a_j} dS' b_j)
  {
    constexpr int CT = PW / 16;
    float acc[RT][CT];
    zero(acc);
    gemm_gg<Q, PW>(acc, View<T>{bb, n, 1, nvalid, n, nullptr}, View<float>{gb, 1, n, n, p, nullptr},
                   n, as, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
      const float w = wout[r];
      float tp = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        acc[i][j] *= w;
        if (r < nvalid && col < p) tp = fmaf(acc[i][j], ld(xb + r * hp + col), tp);
      }
      part_r[tx * Q + r] = tp;
    }
    gemm_sg<Q, PW>(acc, msm, 1, LDQ, View<T>{dyb, hp, 1, nvalid, p, nullptr}, Q, bs);
    T* dxb = dx + xbase;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        if (r < nvalid && col < p) st(dxb + r * hp + col, acc[i][j]);
      }
    }
  }

  // ---- db (this head's part) = E^T C + diag(e^{A-a}) X dS'
  {
    constexpr int CT = NW / 16;
    float acc[RT][CT];
    zero(acc);
    gemm_gg<Q, NW>(acc, View<T>{xb, hp, 1, nvalid, p, nullptr}, View<float>{gb, n, 1, p, n, nullptr},
                   p, as, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float w = wout[ty * RT + i];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] *= w;
    }
    gemm_sg<Q, NW>(acc, esm, 1, LDQ, View<T>{cb, n, 1, nvalid, n, nullptr}, Q, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        if (r < nvalid && col < n) dbp[pbase + (size_t)r * n + col] = acc[i][j];
      }
    }
  }

  // ---- dc (this head's part) = E B + diag(e^a) dY S; R_i = c_i . (e^{a_i} S^T dy_i)
  {
    constexpr int CT = NW / 16;
    float acc[RT][CT];
    zero(acc);
    gemm_gg<Q, NW>(acc, View<T>{dyb, hp, 1, nvalid, p, nullptr}, View<float>{sb, n, 1, p, n, nullptr},
                   p, as, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
      const float w = win[r];
      float rp = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        acc[i][j] *= w;
        if (r < nvalid && col < n) rp = fmaf(acc[i][j], ld(cb + (size_t)r * n + col), rp);
      }
      part_c[tx * Q + r] = rp;
    }
    gemm_sg<Q, NW>(acc, esm, LDQ, 1, View<T>{bb, n, 1, nvalid, n, nullptr}, Q, bs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = tx + 16 * j;
        if (r < nvalid && col < n) dcp[pbase + (size_t)r * n + col] = acc[i][j];
      }
    }
  }

  // ---- <dS', S>, then da and its reverse cumulative sum
  {
    const int pn = p * n;
    float dot = 0.f;
    for (int e = tid; e < pn; e += NT) dot = fmaf(gb[e], sb[e], dot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((tid & 31) == 0) red[tid >> 5] = dot;
    __syncthreads();  // also publishes part_r (T) and part_c (R)
    for (int t = tid; t < Q; t += NT) {
      float ts = 0.f, rs = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        ts += part_r[k * Q + t];
        rs += part_c[k * Q + t];
      }
      tv[t] = ts;
      da[t] += rs - ts;
    }
    __syncthreads();
    if (tid < 32) {
      const int lane = tid;
      constexpr int E = Q / 32;
      float tsum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) tsum += tv[lane * E + e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) total += red[w];
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = da[lane * E + e];
      if (lane == 31) v[E - 1] += win[Q - 1] * total + tsum;
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        run += v[e];
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float off = incl - run;
      float* dlab = dla + ((size_t)b * s + t0) * h + hh;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        if (j < nvalid) dlab[(size_t)j * h] = v[e] + off;
      }
    }
  }
}

// ---------------------------------------------------------------- phase 4
// dB and dC (B, S, N): the per-head partials summed in head order.
template <typename T>
__global__ void __launch_bounds__(HS_NT) bwd_head_sum(
    const float* __restrict__ dbp, const float* __restrict__ dcp, T* __restrict__ db,
    T* __restrict__ dc, int h, long long sn, long long total) {
  const long long idx = (long long)blockIdx.x * HS_NT + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / sn, rem = idx % sn;
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    const size_t o = ((size_t)b * h + hh) * sn + rem;
    sb += dbp[o];
    sc += dcp[o];
  }
  st(db + idx, sb);
  st(dc + idx, sc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int Q, int PW, int NW>
cudaError_t launch(const T* x, const float* la, const T* bm, const T* cm, const T* dy,
                   const float* state0, const float* dstate, float* s_io, float* u_io,
                   float* decay, float* dbp, float* dcp, T* dx, float* dla, T* db, T* dc,
                   float* dstate0, int b, int s, int h, int p, int n, cudaStream_t stream) {
  constexpr size_t ss = state_smem<Q, PW, NW>(), cs = chunk_smem<Q, PW, NW>();
  cudaError_t err = allow_smem(bwd_chunk_state<T, Q, PW, NW>, ss);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_chunk<T, Q, PW, NW>, cs);
  if (err != cudaSuccess) return err;
  const int nc = (s + Q - 1) / Q;
  bwd_chunk_state<T, Q, PW, NW><<<dim3(h, nc, b), NT, ss, stream>>>(
      x, la, bm, cm, dy, s_io, u_io, decay, s, h, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn = p * n;
  bwd_state_pass<<<dim3((pn + SP_NT * SP_EL - 1) / (SP_NT * SP_EL), h, b), SP_NT, 0, stream>>>(
      s_io, u_io, decay, state0, dstate, dstate0, h, pn, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_chunk<T, Q, PW, NW><<<dim3(h, nc, b), NT, cs, stream>>>(
      x, la, bm, cm, dy, s_io, u_io, dx, dla, dbp, dcp, s, h, p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long sn = (long long)s * n, total = (long long)b * sn;
  bwd_head_sum<T><<<(unsigned)((total + HS_NT - 1) / HS_NT), HS_NT, 0, stream>>>(
      dbp, dcp, db, dc, h, sn, total);
  return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t dispatch_q(const T* x, const float* la, const T* bm, const T* cm, const T* dy,
                       const float* state0, const float* dstate, float* s_io, float* u_io,
                       float* decay, float* dbp, float* dcp, T* dx, float* dla, T* db, T* dc,
                       float* dstate0, int b, int s, int h, int p, int n, cudaStream_t st) {
#define REPRO_SSD_BWD_CASE(PW, NW)                                                               \
  return launch<T, Q, PW, NW>(x, la, bm, cm, dy, state0, dstate, s_io, u_io, decay, dbp, dcp, dx, \
                              dla, db, dc, dstate0, b, s, h, p, n, st)
  if (p <= 64) {
    if (n <= 64) REPRO_SSD_BWD_CASE(64, 64);
    REPRO_SSD_BWD_CASE(64, 128);
  }
  if (n <= 64) REPRO_SSD_BWD_CASE(128, 64);
  REPRO_SSD_BWD_CASE(128, 128);
#undef REPRO_SSD_BWD_CASE
}

template <typename T>
cudaError_t dispatch(const void* x, const float* la, const void* bm, const void* cm,
                     const void* dy, const float* state0, const float* dstate, float* s_io,
                     float* u_io, float* decay, float* dbp, float* dcp, void* dx, float* dla,
                     void* db, void* dc, float* dstate0, int b, int s, int h, int p, int n,
                     int chunk, cudaStream_t st) {
  const T *xt = static_cast<const T*>(x), *bt = static_cast<const T*>(bm),
          *ct = static_cast<const T*>(cm), *dyt = static_cast<const T*>(dy);
  T *dxt = static_cast<T*>(dx), *dbt = static_cast<T*>(db), *dct = static_cast<T*>(dc);
  if (chunk == 64)
    return dispatch_q<T, 64>(xt, la, bt, ct, dyt, state0, dstate, s_io, u_io, decay, dbp, dcp, dxt,
                             dla, dbt, dct, dstate0, b, s, h, p, n, st);
  return dispatch_q<T, 128>(xt, la, bt, ct, dyt, state0, dstate, s_io, u_io, decay, dbp, dcp, dxt,
                            dla, dbt, dct, dstate0, b, s, h, p, n, st);
}

// ================================================================= bf16 path

constexpr int TC_NT = 128;  // threads of tc_chunk_state: 4 warps
constexpr int HG = 8;       // heads one tc_chunk_dx or tc_chunk_dbdc block walks
constexpr int DPART_MAX = 128;  // tc_state_pass warps a (head, chunk): 8 for each 1,024 of P*N <= 128^2

template <int N8>
__device__ __forceinline__ void zero_tiles(float (&acc)[N8][4]) {
#pragma unroll
  for (int i = 0; i < N8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Two bf16 values at a shared-memory address, widened.
__device__ __forceinline__ float2 smem_bf16x2(uint32_t addr) {
  uint32_t u;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// A packed bf16 pair times w, rounded to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * w, f.y * w);
}

// acc[nt] += A B^T for the 16 rows of the swizzled [.][KW] tile at s_a (A) and
// the N8 * 8 rows of the one at s_b (B^T, i.e. rows of s_b are output
// columns), summed over their KW columns; both bases sit on a row that is a
// multiple of 8.  A by plain ldmatrix; the matrices (rows 16pb+0-7, chunk
// 2kk), (+0-7, 2kk+1), (+8-15, 2kk), (+8-15, 2kk+1) of s_b are b0, b1 of
// n-tiles 2pb, 2pb+1.  acc[nt][e] is row g + 8 (e / 2), column 8 nt + 2t + (e % 2).
template <int KW, int N8>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[N8][4], uint32_t s_a, uint32_t s_b) {
  using L = Rows<KW>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, s_a + L::off(lane & 15, 2 * kk + (lane >> 4)));
#pragma unroll
    for (int pb = 0; pb < N8 / 2; ++pb) {
      uint32_t bs[4];
      ldmatrix_x4(bs, s_b + L::off(16 * pb + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * pb], af, bs[0], bs[1]);
      mma_bf16(acc[2 * pb + 1], af, bs[2], bs[3]);
    }
  }
}

// acc[nt] += a B for a 16 x 16 A fragment `a` over steps k0..k0+15 and the
// rows k0..k0+15 of the swizzled [.][W] tile at s_b = row k0 (k = row, n =
// column), by ldmatrix .trans: matrices (k +0-7, chunk 2dn), (+8-15, 2dn),
// (+0-7, 2dn+1), (+8-15, 2dn+1) are b0, b1 of n-tiles 2dn, 2dn+1.
template <int W, int N8>
__device__ __forceinline__ void mma_frag_rows(float (&acc)[N8][4], const uint32_t (&a)[4], uint32_t s_b) {
  using L = Rows<W>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dn = 0; dn < N8 / 2; ++dn) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, s_b + L::off((lane & 7) + (((lane >> 3) & 1) << 3), 2 * dn + (lane >> 4)));
    mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
    mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
  }
}

// The 16 x 16 accumulator tile v[st][e] (row g + 8 (e / 2), column 8 st + 2t
// + (e % 2)) as the A fragment of an m16n8k16 product over its 16 columns.
__device__ __forceinline__ void tile_to_frag(const float (&v)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(v[0][0], v[0][1]);
  a[1] = pack_bf16(v[0][2], v[0][3]);
  a[2] = pack_bf16(v[1][0], v[1][1]);
  a[3] = pack_bf16(v[1][2], v[1][3]);
}

// (C B^T)^T of one (batch row, chunk), fp32: cbt[j][i] = c_i . b_j for the
// 16 x 16 tiles on and above the diagonal (i >= j up to the tile), which
// every head's tc_chunk_dx reads.  One block per 64 rows j0 = 64 it.. of
// the chunk (as the forward's chunk_cb: B's 64 rows and C's rows from j0 on
// fit in a state block's shared memory); warp w owns rows j0 + 16w.. and the
// column tiles from its own on.  B by plain ldmatrix as A, C by plain
// ldmatrix as B^T.  Rows past S are zero and written as such.
template <int Q, int NW>
__device__ __forceinline__ void chunk_bct(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                                          float* __restrict__ cbt, int s, int n, int vec, int it, int c,
                                          int b, int nc, unsigned char* smem) {
  using LN = Rows<NW>;
  const int t0 = c * Q, j0 = 64 * it;
  const uint32_t s_b = smem_u32(smem);        // [64][NW]      B rows j0..j0+63
  const uint32_t s_c = s_b + 64 * LN::BYTES;  // [Q - j0][NW]  C rows j0..Q-1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  load_rows<NW>(s_b, bm + ((size_t)b * s + t0 + j0) * n, n, 64, s - t0 - j0, n / 8, vec);
  load_rows<NW>(s_c, cm + ((size_t)b * s + t0 + j0) * n, n, Q - j0, s - t0 - j0, n / 8, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = cbt + ((size_t)b * nc + c) * Q * Q;
  const int rt = j0 / 16 + warp;
  for (int ct = rt; ct < Q / 16; ++ct) {
    float acc[2][4];
    zero_tiles(acc);
    mma_rows_rows<NW, 2>(acc, s_b + 16 * warp * LN::BYTES, s_c + (16 * ct - j0) * LN::BYTES);
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(&out[(size_t)(16 * rt + g + 8 * r) * Q + 16 * ct + 8 * st + 2 * t]) =
            make_float2(acc[st][2 * r], acc[st][2 * r + 1]);
  }
}

template <int Q, int PW, int NW>
constexpr int tc_state_smem() {
  return cmax(Q * (PW + NW) * 2 + Q * 4, (64 + Q) * NW * 2);
}

// Phase 1.  Block x = head < h: S_loc = X^T (B e^{A-a}) and decay = e^A;
// head + h: U_loc = dY^T (C e^a); 2h + it: rows 64 it.. of C B^T (chunk_bct).  The forward's
// ssd_chunk_state, twice: the weighted B or C rounded to bf16 in shared
// memory; X^T (dY^T) by ldmatrix .trans from its [step][p] rows, the weighted
// B (C) by ldmatrix .trans from its [step][n] rows; warp w owns the 16-row
// tiles w, w + 4 of P and every column n; fp32 out.
template <int Q, int PW, int NW>
__global__ void __launch_bounds__(TC_NT, PW == 64 ? 4 : 2) tc_chunk_state(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ la,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, float* __restrict__ cbt,
    float* __restrict__ s_loc, float* __restrict__ u_loc, float* __restrict__ decay, int s, int h,
    int p, int n, int vec) {
  using LX = Rows<PW>;
  using LB = Rows<NW>;
  constexpr int MT = PW / 64;  // 16-row tiles of P per warp
  constexpr int NN = NW / 8;   // n8 tiles of N
  extern __shared__ __align__(128) unsigned char smem[];
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  if (hh >= 2 * h) {
    chunk_bct<Q, NW>(bm, cm, cbt, s, n, vec, hh - 2 * h, c, b, nc, smem);
    return;
  }
  const bool fwd = hh < h;  // S_loc from X and B e^{A-a}; else U_loc from dY and C e^{a}
  const int head = fwd ? hh : hh - h;
  const uint32_t s_x = smem_u32(smem);
  const uint32_t s_b = s_x + Q * LX::BYTES;
  float* w = reinterpret_cast<float*>(smem + Q * (LX::BYTES + LB::BYTES));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = c * Q;
  const size_t row = (size_t)h * p;
  load_rows<PW>(s_x, (fwd ? x : dy) + ((size_t)b * s + t0) * row + (size_t)head * p, row, Q, s - t0,
                p / 8, vec);
  load_rows<NW>(s_b, (fwd ? bm : cm) + ((size_t)b * s + t0) * n, n, Q, s - t0, n / 8, vec);
  cp_async_commit();
  if (warp == 0) {
    const float last = chunk_cumsum<Q>(la + (size_t)b * s * h + head, h, t0, s, w);
    __syncwarp();
    for (int j = lane; j < Q; j += 32) w[j] = exp2_ftz(fwd ? last - w[j] : w[j]);
    if (fwd && lane == 0) decay[((size_t)b * h + head) * nc + c] = exp2_ftz(last);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = threadIdx.x; i < Q * LB::NCH; i += TC_NT) {
    const int j = i / LB::NCH;
    uint4* q4 = reinterpret_cast<uint4*>(smem + Q * LX::BYTES + LB::off(j, i % LB::NCH));
    uint4 u = *q4;
    uint32_t* v = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = scale_bf16x2(v[k], w[j]);
    *q4 = u;
  }
  __syncthreads();

  float acc[MT][NN][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) zero_tiles(acc[mi]);
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      ldmatrix_x4_trans(a[mi], s_x + LX::off(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                             2 * (warp + 4 * mi) + ((lane >> 3) & 1)));
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) mma_frag_rows<NW, NN>(acc[mi], a[mi], s_b + 16 * kk * LB::BYTES);
  }
  const int g = lane >> 2, t = lane & 3;
  float* out = (fwd ? s_loc : u_loc) + (((size_t)b * nc + c) * h + head) * p * n;
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

// Phase 2, the only serial pass: S_in[0] = state0 (or 0), S_in[c+1] =
// e^{A_c} S_in[c] + S_loc[c], stored as the bf16 pair hi (the products'
// operand) and lo = S_in - hi; then dS'[nc-1] = dstate (or 0), dS'[c-1] =
// e^{A_c} dS'[c] + U_loc[c], stored in bf16, and each warp's share of
// <dS'[c], hi + lo> into dpart[(b, head, c)][slice * 8 + warp]; dstate0 =
// e^{A_0} dS'[0] + U_loc[0].  Both carries stay fp32.  One block per (slice
// of SP_NT * 4 elements of P*N, head, batch row); each thread carries 4
// neighbouring elements (P*N is a multiple of 64), one 16-byte load or 8-byte
// store per array and chunk, and no array is both read and written, so the
// loads of later chunks are not held behind this one's stores.
__global__ void __launch_bounds__(SP_NT) tc_state_pass(
    const float* __restrict__ s_loc, const float* __restrict__ u_loc, const float* __restrict__ decay,
    const float* __restrict__ state0, const float* __restrict__ dstate, bf16* __restrict__ s_hi,
    bf16* __restrict__ s_lo, bf16* __restrict__ g16, float* __restrict__ dpart,
    float* __restrict__ dstate0, int h, int pn, int nc) {
  const int hh = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * h + hh;
  const int e = (blockIdx.x * SP_NT + threadIdx.x) * 4;
  const bool live = e < pn;
  const int nparts = gridDim.x * (SP_NT / 32);
  const int part = blockIdx.x * (SP_NT / 32) + (threadIdx.x >> 5);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = state0 != nullptr && live ? state0[bh * pn + e + k] : 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t base = (((size_t)b * nc + c) * h + hh) * pn + e;
    const float d = decay[bh * nc + c];
    if (live) {
      const float4 l = *reinterpret_cast<const float4*>(s_loc + base);
      uint2 hi, lo;
      split_bf16(v[0], v[1], hi.x, lo.x);
      split_bf16(v[2], v[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(s_hi + base) = hi;
      *reinterpret_cast<uint2*>(s_lo + base) = lo;
      v[0] = fmaf(d, v[0], l.x);
      v[1] = fmaf(d, v[1], l.y);
      v[2] = fmaf(d, v[2], l.z);
      v[3] = fmaf(d, v[3], l.w);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = dstate != nullptr && live ? dstate[bh * pn + e + k] : 0.f;
#pragma unroll 4
  for (int c = nc - 1; c >= 0; --c) {
    const size_t base = (((size_t)b * nc + c) * h + hh) * pn + e;
    const float d = decay[bh * nc + c];
    float dot = 0.f;
    if (live) {
      const float4 u = *reinterpret_cast<const float4*>(u_loc + base);
      const uint2 hi = *reinterpret_cast<const uint2*>(s_hi + base);
      const uint2 lo = *reinterpret_cast<const uint2*>(s_lo + base);
      const float2 h01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.x));
      const float2 h23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.y));
      const float2 l01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.x));
      const float2 l23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.y));
      dot = fmaf(v[0], h01.x + l01.x, dot);
      dot = fmaf(v[1], h01.y + l01.y, dot);
      dot = fmaf(v[2], h23.x + l23.x, dot);
      dot = fmaf(v[3], h23.y + l23.y, dot);
      *reinterpret_cast<uint2*>(g16 + base) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      v[0] = fmaf(d, v[0], u.x);
      v[1] = fmaf(d, v[1], u.y);
      v[2] = fmaf(d, v[2], u.z);
      v[3] = fmaf(d, v[3], u.w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((threadIdx.x & 31) == 0) dpart[(bh * nc + c) * nparts + part] = dot;
  }
  if (dstate0 != nullptr && live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dstate0[bh * pn + e + k] = v[k];
  }
}

// Shared memory of tc_chunk_dx and tc_chunk_dbdc, which walk a group of HG
// heads of one (chunk, batch row): B and C once, EXTRA bytes of the kernel's
// own, then one head's X, dY, S_in, dS' and a_cum.  One stage only: a second,
// to load the next head while this one computes, measured slower on the H100
// (it leaves too little L1 for the reads that repeat across the group's heads).
template <int Q, int PW, int NW, int EXTRA>
struct GroupSmem {
  static constexpr int BASE = 2 * Q * NW * 2 + EXTRA;                  // the head's tiles
  static constexpr int ACO = BASE + 2 * Q * PW * 2 + 2 * PW * NW * 2;  // its a_cum
  static constexpr int BYTES = ACO + Q * 4;
};

// One head's S_in and dS' (`sg`), or its X and dY and, by warp 0, its
// a_cum * log2(e), into the group's stage by cp.async (one commit group).
// tc_chunk_dx's triangle reads no state, so it loads the next head's S_in
// and dS' while the triangle runs.
template <int Q, int PW, int NW, typename SM>
__device__ __forceinline__ void group_load(bool sg, const bf16* __restrict__ x, const float* __restrict__ la,
                                           const bf16* __restrict__ dy, const bf16* __restrict__ s16,
                                           const bf16* __restrict__ g16, unsigned char* smem, int hh, int b,
                                           int c, int nc, int s, int h, int p, int n, int vec) {
  using LX = Rows<PW>;
  using LN = Rows<NW>;
  const int t0 = c * Q;
  const uint32_t base = smem_u32(smem) + SM::BASE;
  if (sg) {
    const size_t so = (((size_t)b * nc + c) * h + hh) * (size_t)p * n;
    load_rows<NW>(base + 2 * Q * LX::BYTES, s16 + so, n, PW, p, n / 8, true);
    load_rows<NW>(base + 2 * Q * LX::BYTES + PW * LN::BYTES, g16 + so, n, PW, p, n / 8, true);
  } else {
    const size_t row = (size_t)h * p;
    const size_t xo = ((size_t)b * s + t0) * row + (size_t)hh * p;
    load_rows<PW>(base, x + xo, row, Q, s - t0, p / 8, vec);
    load_rows<PW>(base + Q * LX::BYTES, dy + xo, row, Q, s - t0, p / 8, vec);
  }
  cp_async_commit();
  if (!sg && (threadIdx.x >> 5) == 0)
    chunk_cumsum<Q>(la + (size_t)b * s * h + hh, h, t0, s, reinterpret_cast<float*>(smem + SM::ACO));
}

// B and C of the chunk into the first 2 Q rows of shared memory; the caller commits.
template <int Q, int NW>
__device__ __forceinline__ void group_load_bc(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                                              unsigned char* smem, int b, int c, int s, int n, int vec) {
  using LN = Rows<NW>;
  const int t0 = c * Q;
  load_rows<NW>(smem_u32(smem), bm + ((size_t)b * s + t0) * n, n, Q, s - t0, n / 8, vec);
  load_rows<NW>(smem_u32(smem) + Q * LN::BYTES, cm + ((size_t)b * s + t0) * n, n, Q, s - t0, n / 8, vec);
}

// tc_chunk_dx's shared memory after B and C: its sums (part, cg, rv, tv, dv),
// then, where it fits, the chunk's (C B^T)^T as the Q/16 (Q/16 + 1) / 2
// 16 x 16 fp32 tiles on and above the diagonal (1 KB each).
template <int Q>
__host__ __device__ constexpr int tc_dx_sums() { return 4 * (Q / 16 + 4) * Q; }
template <int Q>
__host__ __device__ constexpr int tc_cb_tiles() { return Q / 16 * (Q / 16 + 1) / 2 * 1024; }
template <int Q, int PW, int NW>
__host__ __device__ constexpr bool tc_cb_in_smem() {
  return GroupSmem<Q, PW, NW, tc_dx_sums<Q>() + tc_cb_tiles<Q>()>::BYTES <= 227 * 1024;
}
template <int Q, int PW, int NW>
__host__ __device__ constexpr int tc_dx_extra() {
  return tc_dx_sums<Q>() + (tc_cb_in_smem<Q, PW, NW>() ? tc_cb_tiles<Q>() : 0);
}

// Phase 3.  dx and dlog_da of each head of one (group of HG heads, chunk,
// batch row), the heads in turn.  Warp w owns the 16-row tile rt of the
// chunk and treats its rows as j; row tiles go to warps so that each of the
// SM's four schedulers (warp % 4) gets tiles rt and Q/16 - 1 - rt, the same
// share of the triangle.  Per head: R = e^a (C S_in^T) . dy; dx_inter =
// diag(e^{A-a}) B dS'^T starts dx's accumulator, and T = x . dx_inter.  Then
// (the next head's S_in and dS' loading meanwhile) over the column tiles
// i >= rt: the tile of dY X^T's transpose (X rows j by plain ldmatrix as A,
// dY rows i as B^T) and M^T = L * (C B^T)^T (fp32, from the group's copy in
// shared memory, or from L2 where it does not fit), G^T = M^T * (dY X^T)^T
// summed over i in registers (G's column sums) and over the tile's rows into
// part[rt][i] (G's row sums, added over row tiles in order later), and
// dx += M^T dY (M^T rounded to bf16 in the accumulator layout, which is the
// A layout; dY by ldmatrix .trans).  dx is staged in the warp's own rows of
// X (no other warp reads them) and stored as 16-byte chunks; a thread a row
// adds da = rowsum G - colsum G + R - T, and warp 0 adds e^A <dS', S> +
// sum T at the last step and writes the reverse cumulative sum while the
// others start the next head.
template <int Q, int PW, int NW>
__global__ void __launch_bounds__(2 * Q, 1) tc_chunk_dx(
    const bf16* __restrict__ x, const float* __restrict__ la, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const bf16* __restrict__ dy, const float* __restrict__ cbt,
    const bf16* __restrict__ s16, const bf16* __restrict__ g16, const float* __restrict__ dpart,
    int nparts, bf16* __restrict__ dx, float* __restrict__ dla, int s, int h, int p, int n, int vec) {
  using LX = Rows<PW>;
  using LN = Rows<NW>;
  using SM = GroupSmem<Q, PW, NW, tc_dx_extra<Q, PW, NW>()>;
  constexpr bool CBS = tc_cb_in_smem<Q, PW, NW>();  // (C B^T)^T's tiles in shared memory
  constexpr int W = Q / 16;   // row tiles, one warp each
  constexpr int NP = PW / 8;  // n8 tiles of dx's columns
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_b = smem_u32(smem);       // [Q][NW]  B
  const uint32_t s_c = s_b + Q * LN::BYTES;  // [Q][NW]  C
  float* part = reinterpret_cast<float*>(smem + 2 * Q * LN::BYTES);  // [W][Q]  G's row sums by row tile
  float* cg = part + W * Q;  // [Q]     G's column sums
  float* rv = cg + Q;        // [Q]     R
  float* tv = rv + Q;        // [Q]     T
  float* dv = tv + Q;        // [Q]     da before the chunk-end term
  float* cbs = dv + Q;       // (C B^T)^T's tiles (if CBS): tile (rt, kt) at rt W - rt (rt - 1) / 2 + kt - rt

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int h0 = grp * HG, h1 = min(h, h0 + HG);
  const int t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rt = warp < W / 2 ? warp : 3 * W / 2 - 1 - warp;  // row tile
  const int r0 = 16 * rt;
  const size_t row = (size_t)h * p;
  const float* cbw = cbt + ((size_t)b * nc + c) * Q * Q;
  group_load_bc<Q, NW>(bm, cm, smem, b, c, s, n, vec);
  if constexpr (CBS) {
    // the tiles' rows as 16-byte chunks; chunk q of tile row rho lands at
    // q ^ 2 ((rho >> 1) & 1), so the float2 reads below are conflict-free
    for (int i = threadIdx.x; i < W * (W + 1) / 2 * 64; i += blockDim.x) {
      const int tile = i >> 6, rho = (i >> 2) & 15, q = i & 3;
      int trow = 0, rem = tile;
      while (rem >= W - trow) rem -= W - trow++;
      cp_async16(smem_u32(cbs) + tile * 1024 + rho * 64 + ((q ^ (((rho >> 1) & 1) << 1)) << 4),
                 cbw + (size_t)(16 * trow + rho) * Q + 16 * (trow + rem) + 4 * q, true);
    }
  }
  cp_async_commit();
  group_load<Q, PW, NW, SM>(false, x, la, dy, s16, g16, smem, h0, b, c, nc, s, h, p, n, vec);
  group_load<Q, PW, NW, SM>(true, x, la, dy, s16, g16, smem, h0, b, c, nc, s, h, p, n, vec);
  for (int hh = h0; hh < h1; ++hh) {
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t s_x = s_b + SM::BASE;        // [Q][PW]  X, then dx's rows
    const uint32_t s_dy = s_x + Q * LX::BYTES;  // [Q][PW]  dY
    const uint32_t s_s = s_dy + Q * LX::BYTES;  // [PW][NW] S_in
    const uint32_t s_g = s_s + PW * LN::BYTES;  // [PW][NW] dS'
    const float* ac2 = reinterpret_cast<const float*>(smem + SM::ACO);
    const size_t xo = ((size_t)b * s + t0) * row + (size_t)hh * p;
    const float arow[2] = {ac2[r0 + g], ac2[r0 + g + 8]};
    const float last = ac2[Q - 1];
    // loads issued now and used late: the first triangle tile of (C B^T)^T
    // (from shared memory, or from L2 where it does not fit), and (warp 0)
    // the state pass's partial sums of <dS', S>
    float2 cbn[2][2];
    auto load_cbt = [&](int kt) {
      const float* tile = cbs + (rt * W - rt * (rt - 1) / 2 + kt - rt) * 256;
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          cbn[st][r] = CBS ? *reinterpret_cast<const float2*>(tile + (g + 8 * r) * 16 + ((8 * st + 2 * t) ^ ((g & 2) << 2)))
                           : *reinterpret_cast<const float2*>(&cbw[(size_t)(r0 + g + 8 * r) * Q + 16 * kt + 8 * st + 2 * t]);
    };
    load_cbt(rt);
    float dpv[DPART_MAX / 32];
#pragma unroll
    for (int q = 0; q < DPART_MAX / 32; ++q) {
      const int kp = lane + 32 * q;
      dpv[q] = warp == 0 && kp < nparts ? dpart[(((size_t)b * h + hh) * nc + c) * nparts + kp] : 0.f;
    }

    // R_r = e^{a_r} sum_p dy_rp (C S_in^T)_rp
    float rsum[2] = {0.f, 0.f};
    {
      float acc[NP][4];
      zero_tiles(acc);
      mma_rows_rows<NW, NP>(acc, s_c + r0 * LN::BYTES, s_s);
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = smem_bf16x2(s_dy + LX::off(r0 + g + 8 * r, np) + 4 * t);
          rsum[r] = fmaf(acc[np][2 * r], v.x, fmaf(acc[np][2 * r + 1], v.y, rsum[r]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) rsum[r] *= exp2_ftz(arow[r]);
    }

    // dx_inter = e^{A-a_r} (B dS'^T)_r starts dx's accumulator; T_r = x_r . dx_inter_r
    float acc[NP][4];
    zero_tiles(acc);
    mma_rows_rows<NW, NP>(acc, s_b + r0 * LN::BYTES, s_g);
    float tsum[2] = {0.f, 0.f};
    {
      const float wo[2] = {exp2_ftz(last - arow[0]), exp2_ftz(last - arow[1])};
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[np][2 * r] *= wo[r];
          acc[np][2 * r + 1] *= wo[r];
          const float2 v = smem_bf16x2(s_x + LX::off(r0 + g + 8 * r, np) + 4 * t);
          tsum[r] = fmaf(acc[np][2 * r], v.x, fmaf(acc[np][2 * r + 1], v.y, tsum[r]));
        }
    }

    __syncthreads();  // every warp is done with S_in and dS': the next head's load
    if (hh + 1 < h1) group_load<Q, PW, NW, SM>(true, x, la, dy, s16, g16, smem, hh + 1, b, c, nc, s, h, p, n, vec);

    // The triangle: column tiles i >= the row tile's rows j.
    float colg[2] = {0.f, 0.f};
    for (int kt = rt; kt < W; ++kt) {
      float2 cur[2][2];
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int r = 0; r < 2; ++r) cur[st][r] = cbn[st][r];
      if (kt + 1 < W) load_cbt(kt + 1);
      float d[2][4];
      zero_tiles(d);
      mma_rows_rows<PW, 2>(d, s_x + r0 * LX::BYTES, s_dy + 16 * kt * LX::BYTES);
      float mt[2][4];
      float gc[2][2];
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = r0 + g + 8 * r;
          const int i0 = 16 * kt + 8 * st + 2 * t;
          const float cv[2] = {cur[st][r].x, cur[st][r].y};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = i0 + q;
            const float m = i >= j ? cv[q] * exp2_ftz(ac2[i] - arow[r]) : 0.f;
            const float gg = m * d[st][2 * r + q];
            mt[st][2 * r + q] = m;
            colg[r] += gg;
            gc[st][q] = r == 0 ? gg : gc[st][q] + gg;
          }
        }
      // G's row sums: the tile's 16 rows j of column i, into part[rt][i]
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = gc[st][q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) part[rt * Q + 16 * kt + 8 * st + 2 * t + q] = v;
        }
      uint32_t ma[4];
      tile_to_frag(mt, ma);
      mma_frag_rows<PW, NP>(acc, ma, s_dy + 16 * kt * LX::BYTES);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        colg[r] += __shfl_xor_sync(0xffffffffu, colg[r], o);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], o);
        tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], o);
      }
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r0 + g + 8 * r;
        cg[j] = colg[r];
        rv[j] = rsum[r];
        tv[j] = tsum[r];
      }

    // dx: staged in the warp's own rows of X (no other warp reads them), then
    // 16-byte chunks out
    __syncwarp();
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t a = s_x + LX::off(r0 + g + 8 * r, np) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(pack_bf16(acc[np][2 * r], acc[np][2 * r + 1])));
      }
    __syncwarp();
    bf16* dxb = dx + xo + (size_t)r0 * row;
    for (int i = lane; i < 16 * NP; i += 32) {
      const int r = i / NP, ch = i % NP;
      if (t0 + r0 + r < s && ch < p / 8) {
        uint4 u;
        asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                     : "r"(s_x + LX::off(r0 + r, ch)));
        *reinterpret_cast<uint4*>(dxb + (size_t)r * row + ch * 8) = u;
      }
    }
    __syncthreads();  // publishes part, cg, rv, tv
    if (threadIdx.x < Q) {  // da_j before the chunk-end term, a thread a row
      const int j = threadIdx.x;
      float rs = 0.f;
      for (int w = 0; w <= j / 16; ++w) rs += part[w * Q + j];
      dv[j] = rs - cg[j] + rv[j] - tv[j];
    }
    __syncthreads();  // ... and with X, dY and a_cum: the next head's
    if (hh + 1 < h1) group_load<Q, PW, NW, SM>(false, x, la, dy, s16, g16, smem, hh + 1, b, c, nc, s, h, p, n, vec);

    if (warp == 0) {
      constexpr int E = Q / 32;
      float dsum = 0.f, tall = 0.f;
#pragma unroll
      for (int q = 0; q < DPART_MAX / 32; ++q) dsum += dpv[q];
#pragma unroll
      for (int e = 0; e < E; ++e) tall += tv[lane * E + e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
        tall += __shfl_xor_sync(0xffffffffu, tall, o);
      }
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = dv[lane * E + e];
      if (lane == 31) v[E - 1] += exp2_ftz(last) * dsum + tall;
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        run += v[e];
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float off = incl - run;
      const int nvalid = min(Q, s - t0);
      float* dlab = dla + ((size_t)b * s + t0) * h + hh;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        if (j < nvalid) dlab[(size_t)j * h] = v[e] + off;
      }
    }
  }
}

// Phase 4.  dB and dC of one (group of HG heads, chunk, batch row), summed
// over the group's heads in head order in fp32 registers.  Warp w < Q/16
// ("up") owns dB's rows j = 16w.., the others dC's rows i = 16(w - Q/16)..,
// all N columns.  Per head: the inter-chunk term, X e^{A-a} (dY e^a) rows as
// A (ldmatrix, scaled and rounded to bf16 in registers) times dS' (S_in)
// [p][n] by .trans; then over the triangle's column tiles (i >= j up, j <= i
// down) the tile of dY X^T in the warp's orientation (its own rows of X or dY
// as A, the tile's rows of the other as B^T), E = L * that tile rounded to
// bf16 as A, times C (B) rows by .trans.
template <int Q, int PW, int NW>
__global__ void __launch_bounds__(4 * Q, 1) tc_chunk_dbdc(
    const bf16* __restrict__ x, const float* __restrict__ la, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const bf16* __restrict__ dy, const bf16* __restrict__ s16,
    const bf16* __restrict__ g16, float* __restrict__ dbp, float* __restrict__ dcp, int s, int h,
    int p, int n, int vec) {
  using LX = Rows<PW>;
  using LN = Rows<NW>;
  using SM = GroupSmem<Q, PW, NW, 0>;
  constexpr int W = Q / 16;
  constexpr int NN = NW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_b = smem_u32(smem);
  const uint32_t s_c = s_b + Q * LN::BYTES;
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y, ng = gridDim.x;
  const int h0 = grp * HG, h1 = min(h, h0 + HG);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool up = warp < W;  // dB: rows j, steps i >= j; else dC: rows i, steps j <= i
  const int wr = warp % W, r0 = 16 * wr;
  const int t0 = c * Q;
  group_load_bc<Q, NW>(bm, cm, smem, b, c, s, n, vec);
  cp_async_commit();
  float acc[NN][4];
  zero_tiles(acc);
  group_load<Q, PW, NW, SM>(false, x, la, dy, s16, g16, smem, h0, b, c, nc, s, h, p, n, vec);
  group_load<Q, PW, NW, SM>(true, x, la, dy, s16, g16, smem, h0, b, c, nc, s, h, p, n, vec);
  for (int hh = h0; hh < h1; ++hh) {
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t s_x = s_b + SM::BASE;
    const uint32_t s_dy = s_x + Q * LX::BYTES;
    const uint32_t s_s = s_dy + Q * LX::BYTES;
    const uint32_t s_g = s_s + PW * LN::BYTES;
    const float* ac = reinterpret_cast<const float*>(smem + SM::ACO);
    const float arow[2] = {ac[r0 + g], ac[r0 + g + 8]};
    const float last = ac[Q - 1];
    const uint32_t s_own = up ? s_x : s_dy;    // the warp's rows as A
    const uint32_t s_oth = up ? s_dy : s_x;    // the tile's rows as B^T
    {
      const float wgt[2] = {exp2_ftz(up ? last - arow[0] : arow[0]),
                            exp2_ftz(up ? last - arow[1] : arow[1])};
      const uint32_t s_st = up ? s_g : s_s;  // [p][n], k = p
#pragma unroll
      for (int kp = 0; kp < PW / 16; ++kp) {
        uint32_t af[4];
        ldmatrix_x4(af, s_own + LX::off(r0 + (lane & 15), 2 * kp + (lane >> 4)));
        af[0] = scale_bf16x2(af[0], wgt[0]);
        af[1] = scale_bf16x2(af[1], wgt[1]);
        af[2] = scale_bf16x2(af[2], wgt[0]);
        af[3] = scale_bf16x2(af[3], wgt[1]);
        mma_frag_rows<NW, NN>(acc, af, s_st + 16 * kp * LN::BYTES);
      }
    }
    const uint32_t s_k = up ? s_c : s_b;  // [step][n], k = step
    const int k_lo = up ? wr : 0, k_hi = up ? W - 1 : wr;
    for (int kt = k_lo; kt <= k_hi; ++kt) {
      float d[2][4];
      zero_tiles(d);
      mma_rows_rows<PW, 2>(d, s_own + r0 * LX::BYTES, s_oth + 16 * kt * LX::BYTES);
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = r0 + g + 8 * (e >> 1), col = 16 * kt + 8 * st + 2 * t + (e & 1);
          const bool in = up ? col >= rr : col <= rr;
          d[st][e] = in ? d[st][e] * exp2_ftz(up ? ac[col] - arow[e >> 1] : arow[e >> 1] - ac[col]) : 0.f;
        }
      uint32_t ea[4];
      tile_to_frag(d, ea);
      mma_frag_rows<NW, NN>(acc, ea, s_k + 16 * kt * LN::BYTES);
    }
    __syncthreads();  // every warp is done with this head's tiles: the next head's
    if (hh + 1 < h1) {
      group_load<Q, PW, NW, SM>(false, x, la, dy, s16, g16, smem, hh + 1, b, c, nc, s, h, p, n, vec);
      group_load<Q, PW, NW, SM>(true, x, la, dy, s16, g16, smem, hh + 1, b, c, nc, s, h, p, n, vec);
    }
  }
  float* out = (up ? dbp : dcp) + ((size_t)b * ng + grp) * (size_t)s * n;
#pragma unroll
  for (int nt = 0; nt < NN; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + g + 8 * r, col = 8 * nt + 2 * t;
      if (t0 + rr < s && col < n)
        *reinterpret_cast<float2*>(&out[(size_t)(t0 + rr) * n + col]) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
}

// The bf16 path's scratch, carved from one allocation.
struct TcScratch {
  float* cbt;    // (b, nc, Q, Q) fp32: (C B^T)^T
  float* s_loc;  // (b, nc, h, p, n) fp32
  float* u_loc;  // (b, nc, h, p, n) fp32
  bf16* s_hi;    // (b, nc, h, p, n): S_in in bf16
  bf16* s_lo;    // (b, nc, h, p, n): S_in - s_hi in bf16
  bf16* g16;     // (b, nc, h, p, n): dS' in bf16
  float* decay;  // (b, h, nc)
  float* dpart;  // (b, h, nc, nparts): <dS', S_in> by state-pass warp
  float* dbp;    // (b, ng, s, n) fp32: dB by head group
  float* dcp;    // (b, ng, s, n) fp32: dC by head group
  int nparts, ng;
};

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// Bytes of the bf16 path's scratch; with `base`, also the pieces, each on a
// 256-byte boundary.
size_t tc_scratch_layout(int b, int s, int h, int p, int n, int chunk, char* base, TcScratch* sc) {
  const size_t nc = (size_t)(s + chunk - 1) / chunk;
  const size_t states = (size_t)b * nc * h * p * n;
  const int nparts = (p * n + SP_NT * 4 - 1) / (SP_NT * 4) * (SP_NT / 32);
  const int ng = (h + HG - 1) / HG;
  const size_t sizes[10] = {
      align256(sizeof(float) * b * nc * chunk * chunk), align256(sizeof(float) * states),
      align256(sizeof(float) * states), align256(sizeof(bf16) * states),
      align256(sizeof(bf16) * states), align256(sizeof(bf16) * states),
      align256(sizeof(float) * b * h * nc), align256(sizeof(float) * b * h * nc * nparts),
      align256(sizeof(float) * b * ng * (size_t)s * n), align256(sizeof(float) * b * ng * (size_t)s * n)};
  size_t off[10], total = 0;
  for (int i = 0; i < 10; ++i) {
    off[i] = total;
    total += sizes[i];
  }
  if (base != nullptr) {
    sc->cbt = reinterpret_cast<float*>(base + off[0]);
    sc->s_loc = reinterpret_cast<float*>(base + off[1]);
    sc->u_loc = reinterpret_cast<float*>(base + off[2]);
    sc->s_hi = reinterpret_cast<bf16*>(base + off[3]);
    sc->s_lo = reinterpret_cast<bf16*>(base + off[4]);
    sc->g16 = reinterpret_cast<bf16*>(base + off[5]);
    sc->decay = reinterpret_cast<float*>(base + off[6]);
    sc->dpart = reinterpret_cast<float*>(base + off[7]);
    sc->dbp = reinterpret_cast<float*>(base + off[8]);
    sc->dcp = reinterpret_cast<float*>(base + off[9]);
    sc->nparts = nparts;
    sc->ng = ng;
  }
  return total;
}

template <int Q, int PW, int NW>
cudaError_t launch_tc(const bf16* x, const float* la, const bf16* bm, const bf16* cm, const bf16* dy,
                      const float* state0, const float* dstate, const TcScratch& sc, bf16* dx,
                      float* dla, bf16* db, bf16* dc, float* dstate0, int b, int s, int h, int p, int n,
                      int vec, cudaStream_t stream) {
  constexpr int ss = tc_state_smem<Q, PW, NW>();
  constexpr int xs = GroupSmem<Q, PW, NW, tc_dx_extra<Q, PW, NW>()>::BYTES;
  constexpr int ds = GroupSmem<Q, PW, NW, 0>::BYTES;
  cudaError_t err = allow_smem(tc_chunk_state<Q, PW, NW>, ss);
  if (err == cudaSuccess) err = allow_smem(tc_chunk_dx<Q, PW, NW>, xs);
  if (err == cudaSuccess) err = allow_smem(tc_chunk_dbdc<Q, PW, NW>, ds);
  if (err != cudaSuccess) return err;
  const int nc = (s + Q - 1) / Q;
  tc_chunk_state<Q, PW, NW><<<dim3(2 * h + Q / 64, nc, b), TC_NT, ss, stream>>>(
      x, dy, la, bm, cm, sc.cbt, sc.s_loc, sc.u_loc, sc.decay, s, h, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = p * n;
  tc_state_pass<<<dim3((pn + SP_NT * 4 - 1) / (SP_NT * 4), h, b), SP_NT, 0, stream>>>(
      sc.s_loc, sc.u_loc, sc.decay, state0, dstate, sc.s_hi, sc.s_lo, sc.g16, sc.dpart, dstate0, h,
      pn, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tc_chunk_dx<Q, PW, NW><<<dim3(sc.ng, nc, b), 2 * Q, xs, stream>>>(
      x, la, bm, cm, dy, sc.cbt, sc.s_hi, sc.g16, sc.dpart, sc.nparts, dx, dla, s, h, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tc_chunk_dbdc<Q, PW, NW><<<dim3(sc.ng, nc, b), 4 * Q, ds, stream>>>(
      x, la, bm, cm, dy, sc.s_hi, sc.g16, sc.dbp, sc.dcp, s, h, p, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long sn = (long long)s * n, total = (long long)b * sn;
  bwd_head_sum<bf16><<<(unsigned)((total + HS_NT - 1) / HS_NT), HS_NT, 0, stream>>>(
      sc.dbp, sc.dcp, db, dc, sc.ng, sn, total);
  return cudaGetLastError();
}

template <int Q>
cudaError_t dispatch_tc(const bf16* x, const float* la, const bf16* bm, const bf16* cm, const bf16* dy,
                        const float* state0, const float* dstate, const TcScratch& sc, bf16* dx,
                        float* dla, bf16* db, bf16* dc, float* dstate0, int b, int s, int h, int p,
                        int n, int vec, cudaStream_t st) {
#define REPRO_SSD_TC_CASE(PW, NW)                                                                \
  return launch_tc<Q, PW, NW>(x, la, bm, cm, dy, state0, dstate, sc, dx, dla, db, dc, dstate0, b, \
                              s, h, p, n, vec, st)
  if (p <= 64) {
    if (n <= 64) REPRO_SSD_TC_CASE(64, 64);
    REPRO_SSD_TC_CASE(64, 128);
  }
  if (n <= 64) REPRO_SSD_TC_CASE(128, 64);
  REPRO_SSD_TC_CASE(128, 128);
#undef REPRO_SSD_TC_CASE
}

// The fp32 path's scratch, carved from `base` when it is not null: the
// chunks' states S_loc -> S_in and U_loc -> dS_out, (b, nc, h, p, n) fp32
// each; decay (b, h, nc) fp32; the per-head dB and dC partials (b, h, s, n)
// fp32 each; every piece on a 256-byte boundary.
size_t fp32_scratch_layout(int b, int s, int h, int p, int n, int chunk, char* base, float** s_io,
                           float** u_io, float** decay, float** dbp, float** dcp) {
  const size_t nc = (size_t)(s + chunk - 1) / chunk;
  const size_t states = align256(sizeof(float) * b * nc * h * p * n);
  const size_t dec = align256(sizeof(float) * b * h * nc);
  const size_t parts = align256(sizeof(float) * b * h * (size_t)s * n);
  if (base != nullptr) {
    *s_io = reinterpret_cast<float*>(base);
    *u_io = reinterpret_cast<float*>(base + states);
    *decay = reinterpret_cast<float*>(base + 2 * states);
    *dbp = reinterpret_cast<float*>(base + 2 * states + dec);
    *dcp = reinterpret_cast<float*>(base + 2 * states + dec + parts);
  }
  return 2 * states + dec + 2 * parts;
}

bool valid_shape(int b, int s, int h, int p, int n, int chunk) {
  return b > 0 && s > 0 && h > 0 && p > 0 && p <= 128 && p % 8 == 0 && n > 0 && n <= 128 &&
         n % 8 == 0 && (chunk == 64 || chunk == 128) && b <= 65535 &&
         (s + chunk - 1) / chunk <= 65535;
}

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).

// Bytes of scratch that repro_ssd_scan_bwd needs for this shape and dtype (0
// for a shape it refuses).
extern "C" size_t repro_ssd_scan_bwd_scratch_bytes(int b, int s, int h, int p, int n, int chunk,
                                                   int is_bf16) {
  if (!valid_shape(b, s, h, p, n, chunk)) return 0;
  if (is_bf16) return tc_scratch_layout(b, s, h, p, n, chunk, nullptr, nullptr);
  return fp32_scratch_layout(b, s, h, p, n, chunk, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr);
}

// `state0` and `dstate` may be null (zero); `dstate0` may be null (not
// wanted).  `scratch` holds repro_ssd_scan_bwd_scratch_bytes(..., is_bf16)
// bytes on a 256-byte boundary; for bf16, dx is 16-byte aligned.  Returns a
// cudaError_t: 0 when every launch was accepted.  The wrapper checks devices,
// dtypes, shapes and contiguity.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const float* log_da, const void* bmat, const void* cmat, const float* state0,
    const void* dy, const float* dstate, void* scratch, void* dx, float* dlog_da, void* db,
    void* dc, float* dstate0, int b, int s, int h, int p, int n, int chunk, int is_bf16,
    void* stream) {
  if (!valid_shape(b, s, h, p, n, chunk)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(scratch) & 255) || (is_bf16 && (reinterpret_cast<uintptr_t>(dx) & 15)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    TcScratch sc;
    tc_scratch_layout(b, s, h, p, n, chunk, static_cast<char*>(scratch), &sc);
    const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                      reinterpret_cast<uintptr_t>(bmat) | reinterpret_cast<uintptr_t>(cmat)) & 15) == 0;
    const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
               *bb = static_cast<const bf16*>(bmat), *cb = static_cast<const bf16*>(cmat);
    bf16 *dxb = static_cast<bf16*>(dx), *dbb = static_cast<bf16*>(db), *dcb = static_cast<bf16*>(dc);
    return (int)(chunk == 64 ? dispatch_tc<64>(xb, log_da, bb, cb, dyb, state0, dstate, sc, dxb, dlog_da,
                                               dbb, dcb, dstate0, b, s, h, p, n, vec, st)
                             : dispatch_tc<128>(xb, log_da, bb, cb, dyb, state0, dstate, sc, dxb, dlog_da,
                                                dbb, dcb, dstate0, b, s, h, p, n, vec, st));
  }
  float *s_io = nullptr, *u_io = nullptr, *decay = nullptr, *dbp = nullptr, *dcp = nullptr;
  fp32_scratch_layout(b, s, h, p, n, chunk, static_cast<char*>(scratch), &s_io, &u_io, &decay, &dbp,
                      &dcp);
  return (int)dispatch<float>(x, log_da, bmat, cmat, dy, state0, dstate, s_io, u_io, decay, dbp, dcp,
                              dx, dlog_da, db, dc, dstate0, b, s, h, p, n, chunk, st);
}
