// Causal / non-causal GQA flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_kernel`, `flash_attention_pallas`), entered through
// src/repro/kernels/ops.py::flash_attention.  It computes the same function:
// q is scaled by sm_scale in fp32, scores, running max, denominator and
// accumulator are fp32 (an online softmax over K/V tiles), keys at or past the
// true seq_kv are masked, and with `causal` query row i sees keys at
// positions <= q_offset + i.  The output is acc / max(l, 1e-37) in the input
// dtype.  Inputs are fp32 or bf16; both compute in true fp32 on the CUDA
// cores (no TF32), so fp32 inputs meet the reference's 2e-5 bar.
//
// Layout: q/o (B, Sq, H, D), k/v (B, Skv, KVH, D), all contiguous; q-head h
// reads kv-head h * KVH / H.  D is any multiple of 8 up to 128; the kernel is
// instantiated for D rounded up to 32, 64, 96 or 128, with the lanes past the
// true D loaded as zeros (they add nothing to q.k) and never stored.
//
// Design.  One block per (q tile of 64 rows, q head, batch); a loop inside
// the block walks the K/V tiles of 32 keys through shared memory, up to the
// causal diagonal, in place of the TPU's sequential grid axis.  Nothing is
// carried between blocks.  128 threads: thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3 and, of each score tile, keys tx + 8*j (j < 4); of the output
// it owns columns 32*c + 4*tx .. +3.  Row max and row sum reduce over the 8
// threads of a row with warp shuffles.  Blocks of the last q tiles, which
// walk the most keys under a causal mask, are launched first.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at the serving
// shape of qwen2-1.5b's cached prefill, q (4,512,12,128) and k/v
// (4,544,2,128) in bf16, q, k, v and o cross HBM once in 14.8 MB (4.42 us),
// and the causal products need 3.23 GFLOP (3.26 us at the bf16 peak), so the
// kernel is bound by memory (chip_smoke.py computes both from the run's
// shapes).  This first version runs its products on the CUDA cores in fp32,
// about 0.27 ms there: far from the bound, and limited in practice by its
// instruction rate.  Tensor-core products (mma.sync, then wgmma) and TMA
// loads are the later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per K/V tile
constexpr int NT = 128;  // threads: 16 row groups (ty) x 8 column groups (tx)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int DP>
constexpr size_t smem_floats() {
  // q tile transposed [DP][BQ], k tile [BK][DP+1], v tile [BK][DP], p [BK][BQ]
  return (size_t)DP * BQ + (size_t)BK * (DP + 1) + (size_t)BK * DP + (size_t)BK * BQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int skv, int h, int kvh, int d, int causal,
    int q_offset, float sm_scale) {
  constexpr int NC = DP / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][BQ], pre-scaled
  float* ks = qt + DP * BQ;                     // [BK][DP + 1]
  float* vs = ks + BK * (DP + 1);               // [BK][DP]
  float* pt = vs + BK * DP;                     // [BK][BQ], probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq * kvh / h;
  const int q0 = q_tile * BQ;

  const size_t q_stride = (size_t)h * d;   // elements between query rows
  const size_t kv_stride = (size_t)kvh * d;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)hq * d;
  const T* kb = k + (size_t)b * skv * kv_stride + (size_t)hk * d;
  const T* vb = v + (size_t)b * skv * kv_stride + (size_t)hk * d;
  T* ob = o + (size_t)b * sq * q_stride + (size_t)hq * d;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_f32(qb[(size_t)(q0 + r) * q_stride + c]) * sm_scale;
    qt[c * BQ + r] = x;
  }

  // Keys past kv_end are masked for every row of this tile.
  int kv_end = skv;
  if (causal) kv_end = min(skv, q_offset + min(q0 + BQ, sq));

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with ks, vs, pt
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv && c < d) {
        const size_t off = (size_t)(k0 + r) * kv_stride + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[r * (DP + 1) + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    // s[i][j]: row 4*ty + i, key k0 + tx + 8*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[c * BQ + ty * 4]);
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 8 * j) * (DP + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(qv.x, kv[j], s[0][j]);
        s[1][j] = fmaf(qv.y, kv[j], s[1][j]);
        s[2][j] = fmaf(qv.z, kv[j], s[2][j]);
        s[3][j] = fmaf(qv.w, kv[j], s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < skv && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mt));
      // A row with no valid key yet keeps m = -inf; exponentiate against 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx + 8 * j) * BQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[kk * BQ + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[kk * DP + c * 32 + tx * 4]);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float li = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 32 + tx * 4 + e;
        if (col < d) store_out(&ob[(size_t)r * q_stride + col], acc[i][c][e] / li);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int skv, int h, int kvh, int d, int causal,
                   int q_offset, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, h, kvh, d, causal, q_offset, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int b,
                     int sq, int skv, int h, int kvh, int d, int causal,
                     int q_offset, float sm_scale, cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 32>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, stream);
    case 2: return launch<T, 64>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, stream);
    case 3: return launch<T, 96>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, stream);
    case 4: return launch<T, 128>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).
// Returns a cudaError_t: 0 when the launch was accepted.  The wrapper checks
// devices, dtypes, shapes and contiguity before it calls this.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
    int h, int kvh, int d, int causal, int q_offset, float sm_scale, int is_bf16,
    void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      d <= 0 || d > 128 || d % 8 != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? dispatch<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, s)
      : dispatch<float>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, s));
}
