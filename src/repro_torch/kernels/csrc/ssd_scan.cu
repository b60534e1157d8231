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
// everywhere and selects).  The fp32 (P, N) state carries across chunks.
//
// Layout: x/y (B, S, H, P) and B/C (B, S, N) in fp32 or bf16 (one dtype),
// log_da (B, S, H) fp32, state0/state_out (B, H, P, N) fp32, all contiguous.
// B and C form one group shared by all heads.  P and N are multiples of 8 up
// to 128; Q (the chunk) is 64 or 128.  Every product runs in true fp32 on the
// CUDA cores, bf16 inputs widened on load, so fp32 inputs meet the
// reference's 2e-5 bar.  A ragged S is masked in the kernel, with the
// semantics of zero padding: steps past S load x, B, C and log_da as 0 (so
// they add nothing and keep the state), and rows past S write nothing.
//
// Design.  The TPU's grid walks the chunks in order and keeps the state in
// VMEM scratch; blocks on the card run in no order, so one block owns one
// (batch row, head, tile of 32 state rows) and loops over the chunks itself,
// with the state tile in shared memory.  State row p depends on x[:, p]
// alone, so tiles of P are independent.  B and C form one group, so C B^T is
// the same for every head and tile of a batch row: a first kernel, ssd_cb,
// computes its lower triangle once per (batch row, chunk) into fp32 scratch
// (each thread an 8x8 tile, Q = 128), and the scan reads it from L2.  Per
// chunk the scan block loads x, B^T, C^T (fp32) and log_da into shared
// memory, takes a_cum with a warp scan, weights C B^T by L into W^T, then
// computes y (each thread 2 rows x 4 columns), then the new state (each warp
// 8 state columns n, each lane one row p).  At Q = 128, N = 128 this is
// 225.5 KB of shared memory, so one block of 16 warps per SM.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// without tensor cores): at mamba2-780m's serving prefill (x (4,512,48,64)
// bf16, B/C (4,512,128) bf16, state0 and state_out (4,48,64,128) fp32) the
// inputs and outputs cross HBM once in 39.2 MB (11.7 us), while the products
// need 5.7 GFLOP over the causal triangle (5.7 us at the bf16 tensor-core
// peak): the kernel is bound by memory, about 0.012 ms (chip_smoke.py
// computes both from the run's shapes).  This version takes its products in
// fp32 on the CUDA cores, where the same FLOPs need 0.085 ms even at peak,
// so it is bound by its instruction issue and far from the memory bound; the
// products for y and for the new state take most of a block's time.  B and C
// are read 8 neighbouring n at a time, one 16-byte vector per thread where
// aligned: a scalar read per lane touches 32 lines per instruction.
// Tensor-core products (mma.sync, then wgmma) on bf16 tiles, less shared
// memory per block, and Mamba2's chunk-parallel split (local states, then a
// state-passing pass) that keeps more blocks in flight are the later work
// that closes the gap.
//
// One call of repro_ssd_scan_fwd launches ssd_cb, then the scan; the
// wrapper counts it as one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int PT = 32;        // state rows (columns p of x) per scan block
constexpr int NT = 256;       // threads per ssd_cb block
constexpr int NT_SCAN = 512;  // threads per scan block: 16 warps to hide latency
constexpr int NMAX = 128;     // largest state width N

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int Q>
size_t scan_smem_bytes(int n) {
  // C^T, B^T [n][Q]; W^T [Q][Q]; x [Q][PT]; state^T [n][PT]; a_cum, decays [Q] x 3
  return sizeof(float) * ((size_t)2 * n * Q + (size_t)Q * Q + (size_t)Q * PT +
                          (size_t)n * PT + (size_t)3 * Q);
}

template <int Q>
size_t cb_smem_bytes(int n) { return sizeof(float) * (size_t)2 * n * Q; }  // C^T, B^T

// 8 neighbouring elements widened to fp32: one 16-byte load for bf16, two
// for fp32, where p is 16-byte aligned; 8 scalar loads otherwise.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec, float* out) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(p[e]);
  }
}

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

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).
// `state0` may be null (a zero initial state).  `cb_scratch` is fp32 scratch
// of b * ceil(s / chunk) * chunk * chunk floats for the shared C B^T.
// Returns a cudaError_t: 0 when both launches were accepted.  The wrapper
// checks devices, dtypes, shapes and contiguity before it calls this.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const float* log_da, const void* bmat, const void* cmat,
    float* cb_scratch, const float* state0, void* y, float* state_out, int b, int s, int h,
    int p, int n, int chunk, int is_bf16, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > 128 || p % 8 != 0 || n <= 0 ||
      n > NMAX || n % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? dispatch<__nv_bfloat16>(x, log_da, bmat, cmat, cb_scratch, state0, y, state_out, b, s, h, p, n, chunk, st)
      : dispatch<float>(x, log_da, bmat, cmat, cb_scratch, state0, y, state_out, b, s, h, p, n, chunk, st));
}
