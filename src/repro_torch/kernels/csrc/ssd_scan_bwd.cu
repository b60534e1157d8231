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
// are multiples of 8 up to 128; Q is 64 or 128.
//
// Design: Mamba2's chunk-parallel split, as the forward's bf16 path, in four
// kernels, all arithmetic in fp32 on the CUDA cores for both dtypes, no
// atomics, so every result is deterministic:
//
//   1. bwd_chunk_state, one block per (head, chunk, batch row): the chunk's
//      local state S_loc = sum_j e^{A-a_j} x_j b_j^T and its local
//      U_loc = sum_i e^{a_i} dy_i c_i^T, fp32 (P, N) scratch, and e^A;
//   2. bwd_state_pass, the only serial pass and an elementwise one, one block
//      per (slice of P*N, head, batch row): forward over the chunks for each
//      chunk's incoming S (written over S_loc), backward for each chunk's
//      outgoing dS' (written over U_loc), and dstate0;
//   3. bwd_chunk, one block per (head, chunk, batch row): C B^T and dY X^T
//      of the chunk, M = L * C B^T and E = L * dY X^T (L_ij = e^{a_i-a_j} on
//      and below the diagonal only: above it the exponent is positive and
//      may overflow) kept in shared memory with the row and column sums of
//      G = M * dY X^T, then dx = M^T dY + diag(e^{A-a}) B dS'^T,
//      db = E^T C + diag(e^{A-a}) X dS', dc = E B + diag(e^a) dY S, R, T,
//      <dS', S> and dlog_da; db and dc per head into fp32 scratch;
//   4. bwd_head_sum: dB and dC, the sum of the per-head partials in head order.
//
// The chunk's operands do not fit in shared memory at once (x, dy, B, C, S,
// dS' at Q 128, P 64, N 128 in fp32 come to 256 KB), so each product streams
// its operands from device memory in K tiles of 32 through one staging
// buffer, and only the two Q x Q matrices M and E stay resident (132 KB at
// Q 128).  A block of 256 threads owns the whole (Q, width) output of each
// product, each thread a register tile of Q/16 rows by width/16 columns.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at mamba2-780m's
// training shape (x (2,4096,48,64) bf16, N 128) the inputs and outputs cross
// HBM once in about 170 MB (0.05 ms), and the products over the causal
// triangle and the state terms are about 40 GFLOP (0.04 ms at the bf16
// tensor-core peak): bound by bytes.  This first kernel runs every product on
// the CUDA cores in fp32 (67 TFLOP/s peak) from shared memory, moves about
// 0.8 GB of fp32 scratch (the chunks' states twice, the per-head dB and dC
// partials) and computes the full Q x Q products where only the triangle is
// needed; chip_smoke.py measures how far that leaves it from the bound.  The
// tensor cores (mma.sync or wgmma), bf16 scratch and the triangle are the
// next step.
//
// One call of repro_ssd_scan_bwd launches the four kernels; the wrapper counts
// it as one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;      // threads of bwd_chunk_state and bwd_chunk: a 16 x 16 grid
constexpr int KT = 32;       // depth of one staged K tile
constexpr int SP_NT = 256;   // threads of bwd_state_pass
constexpr int SP_EL = 4;     // state elements per bwd_state_pass thread
constexpr int HS_NT = 256;   // threads of bwd_head_sum

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
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

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// The scratch one call needs, carved from `base` when it is not null: the
// chunks' states S_loc -> S_in and U_loc -> dS_out, (b, nc, h, p, n) fp32
// each; decay (b, h, nc) fp32; the per-head dB and dC partials (b, h, s, n)
// fp32 each; every piece on a 256-byte boundary.
size_t scratch_layout(int b, int s, int h, int p, int n, int chunk, char* base, float** s_io,
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

// Bytes of scratch that repro_ssd_scan_bwd needs for this shape (0 for a
// shape it refuses).
extern "C" size_t repro_ssd_scan_bwd_scratch_bytes(int b, int s, int h, int p, int n, int chunk) {
  if (!valid_shape(b, s, h, p, n, chunk)) return 0;
  return scratch_layout(b, s, h, p, n, chunk, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
}

// `state0` and `dstate` may be null (zero); `dstate0` may be null (not
// wanted).  `scratch` holds repro_ssd_scan_bwd_scratch_bytes(...) bytes on a
// 256-byte boundary.  Returns a cudaError_t: 0 when every launch was
// accepted.  The wrapper checks devices, dtypes, shapes and contiguity.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const float* log_da, const void* bmat, const void* cmat, const float* state0,
    const void* dy, const float* dstate, void* scratch, void* dx, float* dlog_da, void* db,
    void* dc, float* dstate0, int b, int s, int h, int p, int n, int chunk, int is_bf16,
    void* stream) {
  if (!valid_shape(b, s, h, p, n, chunk)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) & 255) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *s_io = nullptr, *u_io = nullptr, *decay = nullptr, *dbp = nullptr, *dcp = nullptr;
  scratch_layout(b, s, h, p, n, chunk, static_cast<char*>(scratch), &s_io, &u_io, &decay, &dbp,
                 &dcp);
  if (is_bf16)
    return (int)dispatch<bf16>(x, log_da, bmat, cmat, dy, state0, dstate, s_io, u_io, decay, dbp,
                               dcp, dx, dlog_da, db, dc, dstate0, b, s, h, p, n, chunk, st);
  return (int)dispatch<float>(x, log_da, bmat, cmat, dy, state0, dstate, s_io, u_io, decay, dbp,
                              dcp, dx, dlog_da, db, dc, dstate0, b, s, h, p, n, chunk, st);
}
