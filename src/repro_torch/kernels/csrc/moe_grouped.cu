// The experts' products of a dropless mixture of experts, grouped over the
// routed entries sorted by expert, for Hopper (sm_90a), forward only.
//
// No TPU kernel of the reference computes this: src/repro/models/moe.py keeps
// C = max(ceil(T·k/E·1.25), 8) entries an expert, drops the rest and leaves
// the batched products over (E, C+1, D) buffers to XLA.  The port's dropless
// route (src/repro_torch/models/moe.py::dropless_moe, published OLMoE)
// computes every one of the T·k entries.  Batched products could do that only
// with C = T (64 experts x 32,641 rows at a 8 x 4,080 prefill: 8 x the work),
// and in decode they read every expert's weights for a few tokens.  So the
// entries are sorted by expert on the device (src: each sorted row's token;
// dst: its entry; offsets: where each expert's rows start, all in device
// memory) and these kernels run each expert's products over its own rows:
//
//   phase 1, per sorted row r of expert e (x_r = x[src[r]]):
//     h[r] = bf16(x_r W_in[e]) * silu(bf16(x_r W_gate[e]))     (r, F)
//   phase 2:
//     y[dst[r]] = bf16(h[r] W_out[e])                          (entry order, D)
//
// Rounding as the capacity route's plain products (moe.py::experts): each
// product sums in fp32 and rounds once to bf16, silu takes jax.nn.silu's
// steps x * (1 / (1 + exp(-x))) each rounded to bf16, and the gate product
// rounds too.  The products' fp32 sums run in the tensor cores' order, so a
// sum that lies on a bf16 rounding boundary may round the other way.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at a prefill every
// expert sees thousands of rows (8 x 4,080 tokens, top 8 of 64: about 4,080
// an expert), 6 x 261,120 x 2,048 x 1,024 = 3.29 TFLOP a layer against 0.4 GB
// of weights and 2.1 GB of rows in and out: operations bound it (3.3 ms).
// In decode (8 tokens: 64 entries, about 41 experts hit) the products are a
// few rows against each hit expert's 12.6 MB of weights: bytes bound it.
//
// Design: one device function computes a tile of up to BM sorted rows of one
// expert by 128 output columns on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 sums), its A rows gathered by index straight from x (phase 1) or
// read from h (phase 2), so no gathered copy of the rows is made; A and B
// tiles come in through a ring of cp.async stages in XOR-swizzled shared
// memory (bf16_tiles.cuh) and reach the tensor cores by ldmatrix.  In phase 1
// the B tile's first 64 columns come from W_gate and the last 64 from W_in at
// the same F columns, and a warp holds both halves of its columns, so the
// epilogue pairs the gate and up sums of an element in registers and writes
// h once.  Phase 2 writes each row at its entry (dst), in the order the
// combine reads.  Two entry points, with their own __global__ names so a
// profile tells them apart, each launched once a phase under a fixed grid:
//
//   moe_grouped_prefill<PHASE>: tiles of 128 rows, 8 warps of 32 x 64; the
//     grid's y runs over ceil(R / 128) + E tiles, enough for any split of R
//     rows among E experts; each block walks the offsets to find its expert
//     and tile (blocks past the last tile return at once); x runs over the
//     column blocks, so the blocks in flight share their rows and their
//     expert's weights in L2.  3 stages of 32 KB, 2 blocks an SM.
//   moe_grouped_decode<PHASE>: one block per (column block, expert), 4 warps
//     of 16 x 32, tiles of 16 rows; a block whose expert has no rows returns
//     at once, so the weights of empty experts are never read, and the grid
//     does not depend on the routing (a CUDA graph captures it).  2 stages of
//     18 KB, under the 48 KB that needs no attribute.
//
// Layouts (all contiguous, bf16 unless named): x (T, D); W_in, W_gate
// (E, D, F); W_out (E, F, D); src, dst (R,) and offsets (E + 1,) int32,
// offsets[E] = R; h (R, F) scratch; y (R, D).  D is a multiple of 128 and F of
// 64; every bf16 operand starts on a 16-byte boundary.

#include "bf16_tiles.cuh"

namespace {

constexpr int BK = 64;   // depth of a k step: one 128-byte row of the A tile
constexpr int BN = 128;  // columns of the B tile and of a block's output
constexpr int PREFILL_BM = 128;
constexpr int DECODE_BM = 16;

// ------------------------------------------------------------ bf16x2 steps

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// fp32 (l, h) rounded to nearest even into one bf16 pair, l in the low half.
__device__ __forceinline__ uint32_t pack2(float l, float h) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
  return d;
}

// jax.nn.silu's steps, x * (1 / (1 + exp(-x))), each rounded to bf16.
__device__ __forceinline__ uint32_t silu2(uint32_t x) {
  const uint32_t e = pack2(expf(-lo(x)), expf(-hi(x)));
  const uint32_t d = add2(e, 0x3f803f80u);  // 1 + e (0x3f80 is 1.0)
  const uint32_t r = pack2(1.0f / lo(d), 1.0f / hi(d));
  return mul2(x, r);
}

struct Args {
  const bf16* x;       // (T, D)
  const bf16* w_in;    // (E, D, F)
  const bf16* w_gate;  // (E, D, F)
  const bf16* w_out;   // (E, F, D)
  const int* src;      // (R,) token of each sorted row
  const int* dst;      // (R,) entry of each sorted row
  const int* offsets;  // (E + 1,)
  bf16* h;             // (R, F)
  bf16* y;             // (R, D)
  int e, d, f;
};

// A tile shape: BM rows in WM x WN warps, STAGES deep.
template <int BM, int WM, int WN, int STAGES>
struct Shape {
  static constexpr int NT = WM * WN * 32;
  static constexpr int MT = BM / WM / 16;  // m16 tiles of a warp
  static constexpr int NH = 64 / WN / 8;   // n8 tiles of a warp in each half of the 128 columns
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int A_CH = BM * (BK / 8);  // 16-byte chunks of an A tile
  static constexpr int A_PER = (A_CH + NT - 1) / NT;
  static constexpr int B_CH = BK * (BN / 8);
  static constexpr int B_PER = B_CH / NT;
  static_assert(MT >= 1 && NH >= 2 && NH % 2 == 0 && B_CH % NT == 0, "tile shape");
};

// One tile: sorted rows row0 .. row0 + rows - 1 (rows <= BM) of expert e by
// output column block nb (phase 1: h's columns nb * 64 .., phase 2: y's
// columns nb * 128 ..).  Every thread of the block calls it; it leaves shared
// memory free for the next call.
template <int PHASE, int BM, int WM, int WN, int STAGES>
__device__ __forceinline__ void tile(const Args& a, int e, int row0, int rows, int nb,
                                     uint32_t smem) {
  using S = Shape<BM, WM, WN, STAGES>;
  using LA = Rows<BK>;
  using LB = Rows<BN>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int ksteps = (PHASE == 1 ? a.d : a.f) / BK;
  const size_t ldb = PHASE == 1 ? (size_t)a.f : (size_t)a.d;

  // each thread's 16-byte chunks of the A and B tiles: the same (row, chunk)
  // at every k step, their sources advancing by BK columns (A) or rows (B)
  const bf16* a_src[S::A_PER];
  uint32_t a_dst[S::A_PER];
  bool a_ok[S::A_PER];
#pragma unroll
  for (int i = 0; i < S::A_PER; ++i) {
    const int idx = tid + i * S::NT;
    const int r = idx / (BK / 8), c = idx % (BK / 8);
    a_ok[i] = idx < S::A_CH && r < rows;
    a_dst[i] = LA::off(r, c);
    a_src[i] = a.x;
    if (a_ok[i])
      a_src[i] = PHASE == 1 ? a.x + (size_t)a.src[row0 + r] * a.d + c * 8
                            : a.h + (size_t)(row0 + r) * a.f + c * 8;
  }
  const bf16* b_src[S::B_PER];
  uint32_t b_dst[S::B_PER];
#pragma unroll
  for (int i = 0; i < S::B_PER; ++i) {
    const int idx = tid + i * S::NT;
    const int kr = idx / (BN / 8), c = idx % (BN / 8);
    b_dst[i] = LB::off(kr, c);
    if (PHASE == 1)
      b_src[i] = (c < 8 ? a.w_gate : a.w_in) + (size_t)e * a.d * a.f + (size_t)kr * a.f + nb * 64 +
                 (c & 7) * 8;
    else
      b_src[i] = a.w_out + (size_t)e * a.f * a.d + (size_t)kr * a.d + nb * BN + c * 8;
  }

  auto load = [&](int ks, int slot) {
    const uint32_t sa = smem + slot * S::STAGE, sb = sa + S::A_BYTES;
#pragma unroll
    for (int i = 0; i < S::A_PER; ++i)
      if (tid + i * S::NT < S::A_CH)
        cp_async16(sa + a_dst[i], a_ok[i] ? a_src[i] + ks * BK : a_src[i], a_ok[i]);
#pragma unroll
    for (int i = 0; i < S::B_PER; ++i) cp_async16(sb + b_dst[i], b_src[i] + (size_t)ks * BK * ldb, true);
  };

  float acc[S::MT][2 * S::NH][4];
#pragma unroll
  for (int m = 0; m < S::MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * S::NH; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage ks has landed for every thread; stage ks - 1 is free
    const int next = ks + STAGES - 1;
    if (next < ksteps) load(next, next % STAGES);
    cp_async_commit();
    const uint32_t sa = smem + (ks % STAGES) * S::STAGE, sb = sa + S::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[S::MT][4];
#pragma unroll
      for (int m = 0; m < S::MT; ++m)
        ldmatrix_x4(af[m], sa + LA::off(wm * S::MT * 16 + m * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int jp = 0; jp < S::NH / 2; ++jp) {
          const int chunk = (hf * 64 + wn * S::NH * 8 + jp * 16) / 8 + (lane >> 4);
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sb + LB::off(kk * 16 + (lane & 15), chunk));
          const int n = hf * S::NH + jp * 2;
#pragma unroll
          for (int m = 0; m < S::MT; ++m) {
            mma_bf16(acc[m][n], af[m], bf[0], bf[1]);
            mma_bf16(acc[m][n + 1], af[m], bf[2], bf[3]);
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with shared memory before the next tile loads

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int m = 0; m < S::MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * S::MT * 16 + m * 16 + g + half * 8;
      if (r >= rows) continue;
      if (PHASE == 1) {
        bf16* out = a.h + (size_t)(row0 + r) * a.f + nb * 64 + wn * S::NH * 8 + t2;
#pragma unroll
        for (int j = 0; j < S::NH; ++j) {
          const uint32_t gate = pack2(acc[m][j][half * 2], acc[m][j][half * 2 + 1]);
          const uint32_t up = pack2(acc[m][S::NH + j][half * 2], acc[m][S::NH + j][half * 2 + 1]);
          *reinterpret_cast<uint32_t*>(out + j * 8) = mul2(up, silu2(gate));
        }
      } else {
        bf16* out = a.y + (size_t)a.dst[row0 + r] * a.d + nb * BN + wn * S::NH * 8 + t2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int j = 0; j < S::NH; ++j) {
            const float* v = acc[m][hf * S::NH + j];
            *reinterpret_cast<uint32_t*>(out + hf * 64 + j * 8) = pack2(v[half * 2], v[half * 2 + 1]);
          }
      }
    }
}

using Prefill = Shape<PREFILL_BM, 4, 2, 3>;
using Decode = Shape<DECODE_BM, 1, 4, 2>;

template <int PHASE>
__global__ void __launch_bounds__(Prefill::NT, 2) moe_grouped_prefill(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // tiles of PREFILL_BM rows, expert by expert: find this block's
  const int id = blockIdx.y;
  int e = 0, before = 0;
  for (; e < a.e; ++e) {
    const int tiles = (a.offsets[e + 1] - a.offsets[e] + PREFILL_BM - 1) / PREFILL_BM;
    if (id < before + tiles) break;
    before += tiles;
  }
  if (e == a.e) return;
  const int row0 = a.offsets[e] + (id - before) * PREFILL_BM;
  tile<PHASE, PREFILL_BM, 4, 2, 3>(a, e, row0, min(PREFILL_BM, a.offsets[e + 1] - row0), blockIdx.x,
                                   smem_u32(smem));
}

template <int PHASE>
__global__ void __launch_bounds__(Decode::NT) moe_grouped_decode(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.y;
  const int lo_row = a.offsets[e], hi_row = a.offsets[e + 1];
  for (int row0 = lo_row; row0 < hi_row; row0 += DECODE_BM)
    tile<PHASE, DECODE_BM, 1, 4, 2>(a, e, row0, min(DECODE_BM, hi_row - row0), blockIdx.x,
                                    smem_u32(smem));
}

int column_blocks(const Args& a, int phase) { return phase == 1 ? a.f / 64 : a.d / BN; }

template <int PHASE>
cudaError_t launch_prefill(const Args& a, int r, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(moe_grouped_prefill<PHASE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Prefill::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(moe_grouped_prefill<PHASE>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(column_blocks(a, PHASE), (r + PREFILL_BM - 1) / PREFILL_BM + a.e);
  moe_grouped_prefill<PHASE><<<grid, Prefill::NT, Prefill::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int PHASE>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  static_assert(Decode::SMEM <= 48 * 1024, "the decode entry point sets no shared-memory attribute");
  const dim3 grid(column_blocks(a, PHASE), a.e);
  moe_grouped_decode<PHASE><<<grid, Decode::NT, Decode::SMEM, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).
// Returns a cudaError_t: 0 when both launches were accepted.  x (t, d);
// w_in, w_gate (e, d, f); w_out (e, f, d); src, dst (r,), offsets (e + 1,)
// int32; h (r, f) scratch; y (r, d).  With `decode` the entry point for a
// few rows an expert, else the one for many.  The wrapper checks devices,
// dtypes, shapes and contiguity before it calls this.
extern "C" int repro_moe_grouped_mm(const void* x, const void* w_in, const void* w_gate,
                                    const void* w_out, const int* src, const int* dst,
                                    const int* offsets, void* h, void* y, int t, int r, int e,
                                    int d, int f, int decode, void* stream) {
  if (t <= 0 || r <= 0 || e <= 0 || e > 65535 || d <= 0 || d % BN || f <= 0 || f % 64 ||
      (r + PREFILL_BM - 1) / PREFILL_BM + e > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w_in) || !aligned16(w_gate) || !aligned16(w_out) || !aligned16(h) ||
      !aligned16(y))
    return (int)cudaErrorMisalignedAddress;
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
               static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_out), src, dst, offsets,
               static_cast<bf16*>(h), static_cast<bf16*>(y), e, d, f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = decode ? launch_decode<1>(a, st) : launch_prefill<1>(a, r, st);
  if (err != cudaSuccess) return (int)err;
  return (int)(decode ? launch_decode<2>(a, st) : launch_prefill<2>(a, r, st));
}
