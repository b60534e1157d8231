// The Mamba2 mixer's elementwise chain around the SSD scan, fused into two
// kernels for Hopper (sm_90a), forward only.
//
// No TPU kernel of the reference computes this: src/repro/models/ssm.py
// leaves the chain to XLA, which fuses it.  PyTorch runs it eagerly, one
// pass over device memory per operation (about 30 GB a layer at
// mamba2-780m's prompt-2k prefill), so these two kernels replace it in the
// port's serving path (src/repro_torch/models/ssm.py::_mixer): the
// in-projection's products, the scan and the out-projection stay where they
// were.
//
//   ssm_conv_gate_in (before the scan), per (batch row, position, channel):
//     xs   = silu(conv(x) + b_x)          B = silu(conv(B) + b_B)
//     C    = silu(conv(C) + b_C)          dt' = softplus(dt + dt_bias) (fp32)
//     xbar = xs * bf16(dt')               log_da = dt' * (-exp(a_log))  (fp32)
//   where conv is the causal depthwise convolution of K taps along the
//   sequence, its K-1 inputs before the first position taken from the conv
//   state (the cache's last K-1 inputs, fp32 holding bf16 values) or zeros,
//   and it also writes the new conv state, the last K-1 inputs.
//
//   ssm_gate_norm (after the scan), per token row of the inner width:
//     g   = (y + xs * bf16(D)) * silu(z)
//     out = g * rsqrt(mean(g^2) + eps) * scale   (or g, without a scale)
//
// Rounding: the plain chain (kernels/ref.py) runs each step as one PyTorch
// operation on bf16 tensors, which computes in fp32 and rounds the result to
// bf16.  These kernels round at every one of those steps, in the same order:
// each conv product and partial sum, the bias, silu's four steps (exp(-x),
// 1 + e, 1 / d, x * r; jax.nn.silu's own), xbar, the skip product and sum,
// and the gate.  A product or sum of two bf16 values rounded from fp32 to
// bf16 equals the same operation rounded once to bf16 (fp32's 24 bits are
// more than twice bf16's 8 plus 2, so the double rounding is innocuous), so
// those steps run as bf16x2 instructions with explicit round-to-nearest
// (mul.rn / add.rn, which the compiler never contracts into an fma).  exp,
// log1p and 1 / d run in fp32 with expf, log1pf and IEEE division (no fast
// math), as PyTorch's kernels do, and are rounded to bf16 where the chain
// rounds them.  softplus, log_da and the norm stay fp32 as in the chain; the
// norm's sum of squares is the one sum taken in another order (each thread's
// channels in order, a butterfly across the warp, then the warps in order).
// So the front kernel's outputs equal the plain chain's on the card, and the
// back kernel's differ only where that fp32 row sum tips a rounding.
//
// Bound on the H100 (3.35 TB/s HBM): both kernels do a few tens of
// instructions per element, so bytes bound them.  At prompt-2k's shape
// (65,024 tokens, inner width 3,072, state 128, 48 heads) the front kernel
// reads x, B, C and dt and writes xs, xbar, B, C and log_da, 1.28 GB (0.38
// ms); the back kernel reads y, xs and z and writes the output, 1.60 GB (0.48
// ms).  Design: every load and store moves 16 bytes (8 channels) a thread,
// neighbouring threads on neighbouring channels.  In the front kernel each
// thread walks 64 positions of its 8 channels, keeping the K-1 previous
// inputs in registers, so each input is read once (and K-1 rows more per 64,
// mostly from L2); it loads 2 rows ahead of the arithmetic, and 6 blocks of
// 128 threads share an SM (at prompt-2k's shape 0.56 ms against 0.65 with
// 2 blocks of 256 and 4 rows ahead: the arithmetic needs warps to hide it).  In the back
// kernel one block of 128 threads holds one token row in registers (as the
// rounded bf16 gate) between the sum of squares and the scaling, so the row
// is read once and written once.
//
// Layouts (all contiguous): x, xs, xbar (B, S, Ci) with Ci = H * P; B, C
// (B, S, N); dt (B, S, H) bf16; log_da (B, S, H) fp32; conv weights (K, width)
// and biases (width) bf16; dt_bias, a_log (H) fp32; conv states (B, K-1,
// width) fp32 in, bf16 out.  y, xs, z, out (rows, Ci) bf16, d_skip (H) and
// scale (Ci) fp32.  Ci, N and P are multiples of 8; K is 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 4;           // conv taps: Mamba2's d_conv, every configuration's ssm_conv
constexpr int FRONT_NT = 128;  // threads per front block, 6 blocks an SM (<= 80 registers)
constexpr int TPOS = 64;       // positions one front thread walks
constexpr int AHEAD = 2;       // rows a front thread loads before it computes on them
constexpr int BACK_NT = 128;   // threads per back block (one token row)
constexpr int BACK_GMAX = 8;   // groups of 8 channels a back thread holds: width <= 8,192

// ------------------------------------------------------------ bf16x2 steps

// Two bf16 values in one 32-bit word, the lower address in the low half.
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

// fp32 (lo, hi) rounded to nearest even into one bf16 pair.
__device__ __forceinline__ uint32_t pack2(float l, float h) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
  return d;
}

__device__ __forceinline__ uint32_t splat(float v) { return pack2(v, v); }

// jax.nn.silu's steps, x * (1 / (1 + exp(-x))), each rounded to bf16.
__device__ __forceinline__ uint32_t silu2(uint32_t x) {
  const uint32_t e = pack2(expf(-lo(x)), expf(-hi(x)));
  const uint32_t d = add2(e, 0x3f803f80u);  // 1 + e (0x3f80 is 1.0)
  const uint32_t r = pack2(1.0f / lo(d), 1.0f / hi(d));
  return mul2(x, r);
}

struct Vec8 {
  uint32_t w[4];
};

__device__ __forceinline__ Vec8 load8(const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return {{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ void store8(bf16* p, const Vec8& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

// 8 fp32 values rounded to bf16 (the conv state's `state.to(bf16)`).
__device__ __forceinline__ Vec8 load8_f32(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return {{pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w)}};
}

// ------------------------------------------------------------ front kernel

// One stream of the convolution: x (with the inner width), B or C.
struct Stream {
  const bf16* in;       // (B, S, width)
  const bf16* w;        // (K, width)
  const bf16* bias;     // (width)
  const float* state;   // (B, K-1, width) or null: zeros
  bf16* out;            // (B, S, width)
  bf16* new_state;      // (B, K-1, width)
  int width;
};

struct FrontArgs {
  Stream x, b, c;
  const bf16* dt;        // (B, S, H)
  const float* dt_bias;  // (H)
  const float* a_log;    // (H)
  bf16* xbar;            // (B, S, H * P)
  float* log_da;         // (B, S, H)
  int s, h, p;
};

// Thread (group, tile) of batch row blockIdx.y: 8 channels of one stream
// (groups 0 .. Ci/8-1 are x's, then N/8 of B, then N/8 of C) over positions
// tile * TPOS .. +TPOS-1.
__global__ void __launch_bounds__(FRONT_NT, 6) ssm_conv_gate_in(const FrontArgs a) {
  const int gx = a.x.width / 8, gn = a.b.width / 8;
  const int groups = gx + 2 * gn;
  const int tiles = (a.s + TPOS - 1) / TPOS;
  const long long idx = (long long)blockIdx.x * FRONT_NT + threadIdx.x;
  if (idx >= (long long)groups * tiles) return;
  const int g = (int)(idx % groups), tile = (int)(idx / groups);
  const int which = g < gx ? 0 : (g < gx + gn ? 1 : 2);
  const Stream st = which == 0 ? a.x : (which == 1 ? a.b : a.c);
  const int c0 = 8 * (which == 0 ? g : (which == 1 ? g - gx : g - gx - gn));
  const int width = st.width;
  const size_t row0 = (size_t)blockIdx.y * a.s;  // this batch row's first token

  Vec8 w[K], bias = load8(st.bias + c0);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = load8(st.w + (size_t)i * width + c0);

  // win[0 .. K-2]: the K-1 inputs before the next position, oldest first
  const int t0 = tile * TPOS;
  Vec8 win[K - 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int pos = t0 - (K - 1) + j;
    if (pos >= 0) {
      win[j] = load8(st.in + (row0 + pos) * width + c0);
    } else if (st.state != nullptr) {
      win[j] = load8_f32(st.state + ((size_t)blockIdx.y * (K - 1) + (K - 1) + pos) * width + c0);
    } else {
      win[j] = Vec8{};
    }
  }

  const bool is_x = which == 0;
  const int head = is_x ? c0 / a.p : 0;
  const bool writes_la = is_x && c0 % a.p == 0;  // one thread per (head, position)
  const float dt_bias = is_x ? a.dt_bias[head] : 0.0f;
  const float neg_a = is_x ? -expf(a.a_log[head]) : 0.0f;
  const int t_end = min(t0 + TPOS, a.s);

  for (int t = t0; t < t_end; t += AHEAD) {
    Vec8 cur[AHEAD];
    float dtv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (t + u < t_end) {
        cur[u] = load8(st.in + (row0 + t + u) * width + c0);
        dtv[u] = is_x ? __bfloat162float(a.dt[(row0 + t + u) * a.h + head]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (t + u < t_end) {
        const size_t row = row0 + t + u;
        Vec8 o;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t y = mul2(win[0].w[q], w[0].w[q]);
#pragma unroll
          for (int i = 1; i < K; ++i) y = add2(y, mul2(i < K - 1 ? win[i].w[q] : cur[u].w[q], w[i].w[q]));
          o.w[q] = silu2(add2(y, bias.w[q]));
        }
#pragma unroll
        for (int j = 0; j + 1 < K - 1; ++j) win[j] = win[j + 1];
        win[K - 2] = cur[u];
        store8(st.out + row * width + c0, o);
        if (is_x) {
          const float v = dtv[u] + dt_bias;
          const float dsp = v > 20.0f ? v : log1pf(expf(v));  // F.softplus, beta 1, threshold 20
          const uint32_t d2 = splat(dsp);
          Vec8 xb;
#pragma unroll
          for (int q = 0; q < 4; ++q) xb.w[q] = mul2(o.w[q], d2);
          store8(a.xbar + row * width + c0, xb);
          if (writes_la) a.log_da[row * a.h + head] = dsp * neg_a;
        }
      }
    }
  }
  if (t_end == a.s) {  // the last tile: its window is the new conv state
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
      store8(st.new_state + ((size_t)blockIdx.y * (K - 1) + j) * width + c0, win[j]);
  }
}

// ------------------------------------------------------------ back kernel

// One block per token row; thread t holds channel groups t, t + 128, ...
template <int G>
__global__ void __launch_bounds__(BACK_NT) ssm_gate_norm(const bf16* __restrict__ y, const bf16* __restrict__ xs,
                                                        const bf16* __restrict__ z,
                                                        const float* __restrict__ d_skip,
                                                        const float* __restrict__ scale, bf16* __restrict__ out,
                                                        int c, int p, float eps) {
  const size_t base = (size_t)blockIdx.x * c;
  const int t = threadIdx.x;
  Vec8 yv[G], xv[G], zv[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c0 = (j * BACK_NT + t) * 8;
    if (c0 < c) {
      yv[j] = load8(y + base + c0);
      xv[j] = load8(xs + base + c0);
      zv[j] = load8(z + base + c0);
    }
  }
  Vec8 gv[G];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c0 = (j * BACK_NT + t) * 8;
    if (c0 < c) {
      const uint32_t d2 = splat(d_skip[c0 / p]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t sum = add2(yv[j].w[q], mul2(xv[j].w[q], d2));
        const uint32_t gate = mul2(sum, silu2(zv[j].w[q]));
        gv[j].w[q] = gate;
        ss += lo(gate) * lo(gate);  // exact products of bf16 values
        ss += hi(gate) * hi(gate);
      }
    }
  }
  if (scale == nullptr) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c0 = (j * BACK_NT + t) * 8;
      if (c0 < c) store8(out + base + c0, gv[j]);
    }
    return;
  }
  __shared__ float part[BACK_NT / 32];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  ss = part[0];
#pragma unroll
  for (int i = 1; i < BACK_NT / 32; ++i) ss += part[i];
  const float inv = rsqrtf(ss * (1.0f / (float)c) + eps);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c0 = (j * BACK_NT + t) * 8;
    if (c0 < c) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + c0);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + c0 + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      Vec8 o;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o.w[q] = pack2((lo(gv[j].w[q]) * inv) * sc[2 * q], (hi(gv[j].w[q]) * inv) * sc[2 * q + 1]);
      store8(out + base + c0, o);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool stream_ok(const Stream& s) {
  return aligned16(s.in) && aligned16(s.w) && aligned16(s.bias) && aligned16(s.out) &&
         aligned16(s.new_state) && (s.state == nullptr || aligned16(s.state));
}

cudaError_t launch_front(const FrontArgs& a, int b, cudaStream_t stream) {
  const long long groups = a.x.width / 8 + 2 * (a.b.width / 8);
  const long long threads = groups * ((a.s + TPOS - 1) / TPOS);
  const dim3 grid((unsigned)((threads + FRONT_NT - 1) / FRONT_NT), b);
  ssm_conv_gate_in<<<grid, FRONT_NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_back(const bf16* y, const bf16* xs, const bf16* z, const float* d_skip,
                        const float* scale, bf16* out, int rows, int c, int p, float eps,
                        cudaStream_t stream) {
  ssm_gate_norm<G><<<rows, BACK_NT, 0, stream>>>(y, xs, z, d_skip, scale, out, c, p, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (src/repro_torch/kernels/ops.py).  Each
// returns a cudaError_t: 0 when the launch was accepted.  The wrappers check
// devices, dtypes, shapes, contiguity and alignment before they call these.

// x (b, s, ci), bm / cm (b, s, n), dt (b, s, h) bf16; conv weights (k, width)
// and biases bf16; dt_bias, a_log (h) fp32; conv states sx / sb / sc (b, k-1,
// width) fp32, each null for zeros.  Writes xs (b, s, ci), bm_out / cm_out
// (b, s, n), xbar (b, s, ci) bf16, log_da (b, s, h) fp32 and the new conv
// states (b, k-1, width) bf16.
extern "C" int repro_ssm_conv_gate_in(
    const void* x, const void* bm, const void* cm, const void* dt, const void* wx, const void* bx,
    const void* wb, const void* bb, const void* wc, const void* bc, const float* dt_bias,
    const float* a_log, const float* sx, const float* sb, const float* sc, void* xs, void* bm_out,
    void* cm_out, void* xbar, float* log_da, void* nsx, void* nsb, void* nsc, int b, int s, int ci,
    int n, int h, int k, void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || ci <= 0 || ci % h || (ci / h) % 8 || n <= 0 ||
      n % 8 || k != K)
    return (int)cudaErrorInvalidValue;
  FrontArgs a;
  a.x = {static_cast<const bf16*>(x), static_cast<const bf16*>(wx), static_cast<const bf16*>(bx), sx,
         static_cast<bf16*>(xs), static_cast<bf16*>(nsx), ci};
  a.b = {static_cast<const bf16*>(bm), static_cast<const bf16*>(wb), static_cast<const bf16*>(bb), sb,
         static_cast<bf16*>(bm_out), static_cast<bf16*>(nsb), n};
  a.c = {static_cast<const bf16*>(cm), static_cast<const bf16*>(wc), static_cast<const bf16*>(bc), sc,
         static_cast<bf16*>(cm_out), static_cast<bf16*>(nsc), n};
  a.dt = static_cast<const bf16*>(dt);
  a.dt_bias = dt_bias;
  a.a_log = a_log;
  a.xbar = static_cast<bf16*>(xbar);
  a.log_da = log_da;
  a.s = s;
  a.h = h;
  a.p = ci / h;
  if (!stream_ok(a.x) || !stream_ok(a.b) || !stream_ok(a.c) || !aligned16(xbar))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_front(a, b, st);
}

// y, xs, z, out (rows, c) bf16 with c = h * p; d_skip (h) fp32; scale (c)
// fp32, or null for the gate alone.
extern "C" int repro_ssm_gate_norm(const void* y, const void* xs, const void* z, const float* d_skip,
                                   const float* scale, void* out, int rows, int c, int h, float eps,
                                   void* stream) {
  if (rows <= 0 || h <= 0 || c <= 0 || c % h || (c / h) % 8 || c > BACK_NT * 8 * BACK_GMAX)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(y) || !aligned16(xs) || !aligned16(z) || !aligned16(out) ||
      (scale != nullptr && !aligned16(scale)))
    return (int)cudaErrorMisalignedAddress;
  const bf16 *yb = static_cast<const bf16*>(y), *xb = static_cast<const bf16*>(xs),
             *zb = static_cast<const bf16*>(z);
  bf16* ob = static_cast<bf16*>(out);
  const int p = c / h;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((c + BACK_NT * 8 - 1) / (BACK_NT * 8)) {
#define REPRO_BACK_CASE(G) \
  case G: return (int)launch_back<G>(yb, xb, zb, d_skip, scale, ob, rows, c, p, eps, st)
    REPRO_BACK_CASE(1);
    REPRO_BACK_CASE(2);
    REPRO_BACK_CASE(3);
    REPRO_BACK_CASE(4);
    REPRO_BACK_CASE(5);
    REPRO_BACK_CASE(6);
    REPRO_BACK_CASE(7);
    default: return (int)launch_back<8>(yb, xb, zb, d_skip, scale, ob, rows, c, p, eps, st);
#undef REPRO_BACK_CASE
  }
}
