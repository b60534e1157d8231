// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the SSD
// scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu) kernels:
// XOR-swizzled shared-memory rows, cp.async tile loads zero-filled past the
// valid rows and columns, ldmatrix, mma.sync m16n8k16 with bf16 operands and
// fp32 sums, bf16 packing, and a chunk's cumulative log-decay by one warp.
// Everything here has internal linkage: each source that includes it builds
// into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory rows of W bf16 values (W = 64 or 128), cut into 16-byte
// chunks.  Chunk c of row r sits at chunk c ^ (r & 7) of its group of 8, so
// the 8 rows r0..r0+7 (r0 % 8 == 0) of one logical chunk land in 8 distinct
// 16-byte bank groups: every ldmatrix phase is conflict-free.
template <int W>
struct Rows {
  static constexpr int NCH = W / 8;
  static constexpr int BYTES = W * 2;
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    return (uint32_t)(r * BYTES + ((c ^ (r & 7)) * 16));
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

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0.
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

// (a, b) as a bf16 pair hi plus a bf16 pair lo = (a, b) - hi, which
// together carry about 16 bits of each value's mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Rows 0 .. rows-1 of a bf16 slab (row stride `stride` elements) into a
// swizzled tile; rows at or past `rows_valid` and chunks at or past
// `chunks_valid` are zero-filled.  With `vec` (the slab is 16-byte aligned)
// each chunk is one cp.async; otherwise a chunk is read as 8 scalars and
// stored at once, so a misaligned input costs speed, not correctness.
template <int W>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, size_t stride, int rows,
                                          int rows_valid, int chunks_valid, bool vec) {
  using L = Rows<W>;
  for (int i = threadIdx.x; i < rows * L::NCH; i += blockDim.x) {
    const int r = i / L::NCH, c = i % L::NCH;
    const bool ok = r < rows_valid && c < chunks_valid;
    const uint32_t d = dst + L::off(r, c);
    if (vec || !ok) {
      cp_async16(d, ok ? src + (size_t)r * stride + c * 8 : src, ok);
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(src + (size_t)r * stride + c * 8);
      uint32_t u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = (uint32_t)e[2 * k] | ((uint32_t)e[2 * k + 1] << 16);
      asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(d), "r"(u[0]), "r"(u[1]),
                   "r"(u[2]), "r"(u[3]));
    }
  }
}

// a_cum * log2(e) of the chunk's Q steps (log_da 0 past s) into ac2[Q], by
// warp 0: E steps a lane, then a warp scan.  Returns a_last * log2(e) to
// warp 0's lanes.
template <int Q>
__device__ __forceinline__ float chunk_cumsum(const float* __restrict__ lab, size_t step, int t0,
                                              int s, float* ac2) {
  constexpr int E = Q / 32;
  const int lane = threadIdx.x & 31;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = t0 + lane * E + e;
    run += t < s ? lab[(size_t)t * step] : 0.f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float off = incl - run;
#pragma unroll
  for (int e = 0; e < E; ++e) ac2[lane * E + e] = (v[e] + off) * LOG2E;
  return __shfl_sync(0xffffffffu, incl, 31) * LOG2E;
}

}  // namespace
