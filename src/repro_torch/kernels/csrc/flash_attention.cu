// Causal / non-causal GQA flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_pallas` :89, `_kernel` :29), entered through
// src/repro/kernels/ops.py::flash_attention.  It computes the same function:
// scores, running max, denominator and accumulator are fp32 (an online
// softmax over K/V tiles), keys at or past the true seq_kv are masked, and
// with `causal` query row i sees keys at positions <= q_offset + i.  A row
// with no valid key yet keeps m = -inf and exponentiates against 0.  The
// output is acc / max(l, 1e-37) in the input dtype.
//
// Layout: q/o (B, Sq, H, D), k/v (B, Skv, KVH, D), all contiguous; q-head h
// reads kv-head h * KVH / H.  D is any multiple of 8 up to 128; each kernel
// is instantiated for D rounded up to DP = 32, 64, 96 or 128, with the lanes
// past the true D zero (they add nothing to q.k) and never stored.
//
// Two kernels, chosen by dtype:
//
// * bf16: `flash_fwd_bf16`, FlashAttention-2's design on the tensor cores.
//   One block of 4 warps per (q tile of 64 rows, q head, batch row); each
//   warp owns 16 query rows.  Both products are mma.sync m16n8k16 on bf16
//   fragments with fp32 accumulators: Q's fragments are loaded once by
//   ldmatrix and held in registers; the scores S = Q K^T stay in registers,
//   the online softmax runs on them (row max and sum over the 4 lanes of a
//   quad), and P is packed to bf16 in place as the A operand of O += P V,
//   since the m16n8k16 accumulator layout of S is the A layout of P.  K and
//   V tiles of 64 keys arrive by cp.async (16 bytes a thread, zero-filled
//   past Skv and past D) into a ring of STAGES buffers, so the copy of tile
//   j+1 runs while tile j's products do.  Shared rows are XOR-swizzled by
//   16-byte chunk so every ldmatrix phase (8 rows, one chunk) hits 8
//   distinct bank groups.  Only tiles that cross the causal diagonal or Skv
//   are masked; a warp skips tiles wholly above its rows' diagonal.
//   Numerics, against the reference's fp32 kernel: q is used unscaled (exact
//   for bf16 inputs) and sm_scale * log2(e) is applied to the fp32 scores
//   before exp2, so q * sm_scale is never rounded; P is rounded to bf16 for
//   the P V product, as the port's plain chunked route does; l sums the fp32
//   P.  Each is far inside the bf16 bar of 2e-2.
//   The wrapper passes 16-byte-aligned q, k, v and o (cp.async needs it;
//   rows stay aligned because D * 2 bytes is a multiple of 16).
//
// * fp32: `flash_fwd_f32`, the first version of this kernel, unchanged:
//   true fp32 products on the CUDA cores (no TF32), so fp32 inputs meet the
//   reference's 2e-5 bar.  No fp32 input lies on the serving path.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at the serving
// shape of qwen2-1.5b's cached prefill, q (4,512,12,128) and k/v
// (4,544,2,128) in bf16, q, k, v and o cross HBM once in 14.8 MB (4.42 us),
// and the causal products need 3.23 GFLOP (3.26 us at the bf16 peak), so the
// kernel is bound by bytes (chip_smoke.py computes both from the run's
// shapes).  The design reads each K/V tile from HBM or L2 once per block, the
// 6 q heads of a kv head run in neighbouring blocks so their K/V reads hit
// L2, and the products run on the tensor cores instead of at the 67 TFLOP/s
// of fp32 FMAs, which alone would take 48 us here.
//
// Why mma.sync and not wgmma: at this shape the bound is bytes, and the
// products at mma.sync's rate (about two thirds of the bf16 peak) take about
// 5 us beside the 4.4 us of bytes.  What holds this kernel back is neither:
// every warp reads the whole K and V tile from shared memory by ldmatrix for
// its 16 rows, so each byte read feeds only 16 rows of products.  wgmma reads
// its B operand from shared memory once for a warpgroup's 64 rows;
// scaled_dot_product_attention on this card dispatches to such a kernel
// (cuDNN's), and wgmma with TMA loads is the next step for this one, and the
// one that pays at long prompts, where the products grow as Sq^2 and the
// bytes as Sq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ fp32 kernel

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per K/V tile
constexpr int NT = 128;  // threads: 16 row groups (ty) x 8 column groups (tx)

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

// One block per (q tile of 64 rows, q head, batch); a loop inside the block
// walks the K/V tiles of 32 keys through shared memory, up to the causal
// diagonal.  Thread (ty, tx) owns query rows 4*ty .. 4*ty+3 and, of each
// score tile, keys tx + 8*j (j < 4); of the output it owns columns
// 32*c + 4*tx .. +3.  Row max and row sum reduce over the 8 threads of a row
// with warp shuffles.  Blocks of the last q tiles launch first.
template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int sq, int skv, int h, int kvh, int d, int causal,
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
  const float* qb = q + (size_t)b * sq * q_stride + (size_t)hq * d;
  const float* kb = k + (size_t)b * skv * kv_stride + (size_t)hk * d;
  const float* vb = v + (size_t)b * skv * kv_stride + (size_t)hk * d;
  float* ob = o + (size_t)b * sq * q_stride + (size_t)hq * d;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = qb[(size_t)(q0 + r) * q_stride + c] * sm_scale;
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
        kx = kb[off];
        vx = vb[off];
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
        if (col < d) ob[(size_t)r * q_stride + col] = acc[i][c][e] / li;
      }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b,
                       int sq, int skv, int h, int kvh, int d, int causal,
                       int q_offset, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_f32<DP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, skv, h, kvh, d, causal, q_offset, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 kernel

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;      // query rows per block: 4 warps x 16
constexpr int TK = 64;      // keys per K/V tile
constexpr int TNT = 128;    // threads
constexpr int STAGES = 2;   // K/V tiles in the cp.async ring

// Shared-memory geometry for rows of DP bf16 values, cut into 16-byte chunks.
template <int DP>
struct Tile {
  static constexpr int NCH = DP / 8;             // chunks a row
  static constexpr int ROW_BYTES = DP * 2;
  static constexpr int Q_BYTES = TQ * ROW_BYTES;
  static constexpr int KV_BYTES = TK * ROW_BYTES;  // one K or one V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES;

  // Byte offset of chunk c of row r.  Chunks in whole groups of 8 are XORed
  // with r & 7; a trailing group of 4 (DP 32 or 96, where rows are 64 or 192
  // bytes, so two rows share a 128-byte line) with (r >> 1) & 3.  Either
  // way the 8 rows r0..r0+7 (r0 % 8 == 0) of one logical chunk land in 8
  // distinct 16-byte bank groups: an ldmatrix phase is conflict-free.
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    constexpr int FULL = NCH & ~7;
    const int pc = c < FULL ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
    return (uint32_t)(r * ROW_BYTES + pc * 16);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the 16
// bytes are zero-filled (source size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix .x4: lanes 8i .. 8i+7 give the row addresses of 8x8 matrix i;
// lane L receives in r[i] the elements (row L/4, cols 2(L%4), 2(L%4)+1) of
// matrix i, or with .trans (rows 2(L%4), 2(L%4)+1; col L/4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 in, fp32 accumulate.  With g = lane / 4 and
// t = lane % 4, the fragments hold:
//   a[0] (row g,   k 2t..2t+1)   a[1] (row g+8, k 2t..2t+1)
//   a[2] (row g,   k 2t+8..+9)   a[3] (row g+8, k 2t+8..+9)
//   b0   (k 2t..2t+1,   col g)   b1   (k 2t+8..+9, col g)
//   d[0], d[1] (row g, cols 2t, 2t+1)   d[2], d[3] (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0.  exp2f wraps the
// same instruction in a path for denormal results that costs more than the
// instruction itself on this loop's critical path.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows row0 .. row0+ROWS-1 of a (rows, D) bf16 slab with the given row stride
// into a swizzled tile; rows at or past `rows_valid` and chunks at or past
// `chunks_valid` are zero-filled.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t stride, int row0,
                                          int rows_valid, int chunks_valid, int tid) {
  using L = Tile<DP>;
  static_assert(ROWS * L::NCH % TNT == 0, "whole passes of the block");
#pragma unroll
  for (int it = 0; it < ROWS * L::NCH / TNT; ++it) {
    const int i = tid + it * TNT;
    const int r = i / L::NCH, c = i % L::NCH;
    const bool ok = r < rows_valid && c < chunks_valid;
    const bf16* p = ok ? src + (size_t)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + L::off(r, c), p, ok);
  }
}

// Tree reductions over a thread's NS values of one row (short dependency chains).
template <int N>
__device__ __forceinline__ float tree_max(float (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = fmaxf(x[i], x[i + w]);
  return x[0];
}
template <int N>
__device__ __forceinline__ float tree_sum(float (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] += x[i + w];
  return x[0];
}

template <int DP>
__global__ void __launch_bounds__(TNT, 2) flash_fwd_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int sq, int skv, int h, int kvh, int d, int causal, int q_offset,
    float sm_scale) {
  using L = Tile<DP>;
  constexpr int KSTEPS = DP / 16;  // k16 steps of Q K^T
  constexpr int NS = TK / 8;       // n8 tiles of S (keys)
  constexpr int NO = DP / 8;       // n8 tiles of O (head lanes)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + L::Q_BYTES;  // stage s: K at + 2s KV_BYTES, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Grid (h, b, q tiles): the q heads of one kv head run side by side and
  // share its K/V in L2; the last causal q tiles, which walk the most keys,
  // launch first.
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = hq * kvh / h;
  const size_t q_stride = (size_t)h * d, kv_stride = (size_t)kvh * d;
  const bf16* qb = q + (size_t)b * sq * q_stride + (size_t)hq * d;
  const bf16* kb = k + (size_t)b * skv * kv_stride + (size_t)hk * d;
  const bf16* vb = v + (size_t)b * skv * kv_stride + (size_t)hk * d;
  bf16* ob = o + (size_t)b * sq * q_stride + (size_t)hq * d;
  const int d_chunks = d / 8;

  // Keys at or past kv_end are masked for every row of this tile.
  const int kv_end = causal ? min(skv, q_offset + min(q0 + TQ, sq)) : skv;
  const int n_tiles = (kv_end + TK - 1) / TK;

  auto load_kv = [&](int j) {
    const uint32_t st = s_kv + (uint32_t)((j % STAGES) * 2 * L::KV_BYTES);
    load_tile<DP, TK>(st, kb, kv_stride, j * TK, skv - j * TK, d_chunks, tid);
    load_tile<DP, TK>(st + L::KV_BYTES, vb, kv_stride, j * TK, skv - j * TK, d_chunks, tid);
  };

  // Q rides in the first group with K/V tile 0.
  load_tile<DP, TQ>(s_q, qb, q_stride, q0, sq - q0, d_chunks, tid);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  const int wrow = q0 + warp * 16;    // this warp's first row
  const bool live = wrow < sq;        // a warp wholly past Sq computes nothing
  const int wpos = q_offset + wrow;   // its position against the keys
  // Keys this warp's rows may see: below wkv_end.
  const int wkv_end = causal ? min(skv, wpos + 16) : skv;
  const float scale_log2 = sm_scale * 1.4426950408889634f;

  uint32_t qf[KSTEPS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // Softmax state of rows g (index 0) and g + 8 (index 1) of the warp; l is
  // this lane's partial sum over its columns, reduced over the quad at the end.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and, at j = 0, Q) has landed
    __syncthreads();              // for every thread; all are done with tile j - 1
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();

    if (j == 0) {
      // A fragments of Q, rows 16 warp .. +15, k16 step kk: matrices
      // (rows 0-7, chunk 2kk), (rows 8-15, 2kk), (rows 0-7, 2kk+1),
      // (rows 8-15, 2kk+1) are a[0..3].
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], s_q + L::off(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const int k0 = j * TK;
    if (!live || k0 >= wkv_end) continue;  // no key of this tile is visible to the warp
    const uint32_t s_k = s_kv + (uint32_t)((j % STAGES) * 2 * L::KV_BYTES);
    const uint32_t s_v = s_k + L::KV_BYTES;

    // S = Q K^T.  K is stored [key][d], i.e. K^T column-major, so plain
    // ldmatrix gives B fragments: matrices (keys 16nb+0-7, chunk 2kk),
    // (keys 16nb+0-7, 2kk+1), (keys 16nb+8-15, 2kk), (keys 16nb+8-15, 2kk+1)
    // are b0, b1 of n-tile 2nb and b0, b1 of n-tile 2nb+1.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nb = 0; nb < NS / 2; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, s_k + L::off(nb * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * nb], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * nb + 1], qf[kk], bk[2], bk[3]);
      }

    // s[n][e] is row g + 8 (e / 2), key k0 + 8n + 2t + (e % 2).  Only tiles
    // that cross Skv or the warp's causal diagonal are masked.
    if (k0 + TK > skv || (causal && k0 + TK - 1 > wpos)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int pos = wpos + g + 8 * (e >> 1);
          if (key >= skv || (causal && key > pos)) s[n][e] = -INFINITY;
        }
    }

    // Online softmax in base 2 on the fp32 scores; a row lives in one quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
      float mx = tree_max(x);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      // A row with no valid key yet keeps m = -inf; exponentiate against 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_ftz(m[r] - m_use);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = exp2_ftz(fmaf(s[n][2 * r], scale_log2, -m_use));
        s[n][2 * r + 1] = exp2_ftz(fmaf(s[n][2 * r + 1], scale_log2, -m_use));
        x[n] = s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * alpha + tree_sum(x);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V.  The accumulators of S n-tiles 2kk and 2kk+1 are the A
    // fragment of P for keys 16kk .. 16kk+15: a[0], a[1] from tile 2kk's
    // (d[0],d[1]), (d[2],d[3]); a[2], a[3] from tile 2kk+1's.  V is stored
    // [key][d], row-major as B, so ldmatrix .trans gives B fragments:
    // matrices (keys 16kk+0-7, chunk 2dn), (keys 16kk+8-15, 2dn),
    // (keys 16kk+0-7, 2dn+1), (keys 16kk+8-15, 2dn+1) are b0, b1 of d-tile
    // 2dn and b0, b1 of d-tile 2dn+1.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, s_v + L::off(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           2 * dn + (lane >> 4)));
        mma_bf16(acc[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
  }

  if (!live) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    inv[r] = 1.f / fmaxf(lr, 1e-37f);
  }
  // Stage the warp's 16 output rows in its own rows of the Q tile (only this
  // warp read them), then write them out as 16-byte chunks.
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<__nv_bfloat162*>(smem + L::off(row, n) + 4 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < L::NCH / 2; ++it) {  // 16 rows x NCH chunks over 32 lanes
    const int i = lane + 32 * it;
    const int r = i / L::NCH, c = i % L::NCH;
    if (wrow + r < sq && c < d_chunks)
      *reinterpret_cast<uint4*>(ob + (size_t)(wrow + r) * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + L::off(warp * 16 + r, c));
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int sq,
                        int skv, int h, int kvh, int d, int causal, int q_offset,
                        float sm_scale, cudaStream_t stream) {
  constexpr int smem = Tile<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_bf16<DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, b, (sq + TQ - 1) / TQ);
  flash_fwd_bf16<DP><<<grid, TNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, skv, h, kvh, d, causal, q_offset, sm_scale);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq,
                     int skv, int h, int kvh, int d, int causal, int q_offset, float sm_scale,
                     cudaStream_t s) {
#define REPRO_FLASH_CASE(DP)                                                                  \
  return BF16 ? launch_bf16<DP>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, \
                                s)                                                            \
              : launch_f32<DP>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, s)
  switch ((d + 31) / 32) {
    case 1: REPRO_FLASH_CASE(32);
    case 2: REPRO_FLASH_CASE(64);
    case 3: REPRO_FLASH_CASE(96);
    case 4: REPRO_FLASH_CASE(128);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).
// Returns a cudaError_t: 0 when the launch was accepted.  The wrapper checks
// devices, dtypes, shapes, contiguity and (for bf16) 16-byte alignment
// before it calls this.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
    int h, int kvh, int d, int causal, int q_offset, float sm_scale, int is_bf16,
    void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      d <= 0 || d > 128 || d % 8 != 0 || q_offset < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? dispatch<true>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, s)
      : dispatch<false>(q, k, v, o, b, sq, skv, h, kvh, d, causal, q_offset, sm_scale, s));
}
