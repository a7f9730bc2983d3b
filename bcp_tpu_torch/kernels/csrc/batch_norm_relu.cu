// Train-mode bias + grouped BatchNorm + ReLU of a 3^3 conv's output, forward
// and backward, written by hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA, which
// fuses it into the convs' neighbours. Eager PyTorch runs it as ~8 passes
// forward and ~12 backward (a bias add, an f32 copy, two means, a bf16 mul
// and add, the ReLU and their gradients), over a (G, n/G, C, D, H, W) view of
// a channels_last tensor against (G, 1, C, 1, 1, 1) operands, which
// TensorIterator walks with strided, non-vectorised kernels. This file does
// the same arithmetic in the least passes the data allows.
//
// Layout: y, out, g and dy are dense channels_last (NDHWC, or NHWC) bf16 of
// logical shape (N, C, ...): a (rows = N * spatial, C) matrix, C innermost.
// The batch is G concatenated groups of N / G samples, so group g is rows
// [g * rows_g, (g + 1) * rows_g). Statistics are per (group, channel).
//
// Semantics (bcp_tpu_torch/models/layers.py::TorchBatchNorm in train mode
// after Conv3x3x3's bias add, then ReLU; the plain version is
// bcp_tpu_torch/ops/bn_relu.py):
//   z    = bf16(y + bf16(conv bias))
//   mean = E[z], mean2 = E[z^2] over the group's rows, in f32
//   d    = mean2 - mean^2, inv = rsqrt(max(d, 0) + eps)
//   mul  = bf16(inv * weight), add = bf16(bias - mean * inv * weight)
//   out  = relu(bf16(bf16(z * mul) + add))
// and the gradient of that chain as autograd takes it through the means:
//   go   = g where out > 0, else 0
//   S1 = sum go, S2 = sum go * (z - mean) (per group, channel, f32)
//   dz   = go * mul + A + B * (z - mean), with A, B from S1, S2 and the
//          statistics (batch_norm_relu_grad_finalize), rounded once to bf16
//   the conv bias' gradient is sum dz over every row, the BatchNorm
//   weight's and bias' gradients sums over the groups of S1, S2 terms.
// Autograd's sums are of go and go * z; centring on the mean is the same
// in exact arithmetic and keeps the weight's gradient and the variance's
// term from cancelling where a channel's mean is large against its
// spread.
//
// Bound on the H100: bytes, about one operation a byte against the card's
// ~295. Forward: z is read twice (statistics, then apply) and out written
// once, 6 bytes an element; backward: g and y read twice (reduce, then
// apply) and dz written once, 10 bytes an element. The passes:
//   batch_norm_relu_stats          reads y: per-block partial sums of z, z^2
//   batch_norm_relu_finalize       the partials in a fixed order
//                                  (chunk_sums), the statistics, mul and add,
//                                  the running averages (momentum folded
//                                  group by group, unbiased variance) and
//                                  num_batches_tracked += G
//   batch_norm_relu_apply          reads y, writes out
//   batch_norm_relu_grad_reduce    reads g, y: per-block partials of S1, S2
//                                  (z and the ReLU mask recomputed in the
//                                  forward's exact roundings)
//   batch_norm_relu_grad_finalize  the coefficients A, B; the BatchNorm
//                                  weight's and bias' gradients
//   batch_norm_relu_grad_apply     reads g, y, writes dz; per-block partials
//                                  of sum dz
//   batch_norm_relu_bias_grad      the conv bias' gradient from them
// Design against the bound: a thread owns 8 channels (one 16-byte load of a
// row) for the whole block's rows, so its bias, mul, add, A and B sit in
// registers and no per-element index arithmetic divides; each thread keeps
// UNROLL rows' loads in flight before it computes; a block takes a
// contiguous chunk of one group's rows and a tile of up to 256 channels, and
// the wrapper (ops/bn_relu.py::bn_geometry) cuts rows into enough chunks to
// put ~8 blocks of 256 threads on every SM.
//
// Deterministic: no atomics. Each block reduces its threads' sums in a
// fixed order through shared memory and writes its partials; the finalize
// kernels add the blocks' partials in a fixed order (chunk_sums). Two runs
// give the same bits, so a rematerialised forward equals its first run and
// a CUDA graph's replays are exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;      // bf16 channels of a 16-byte load
constexpr int UNROLL = 4;   // rows a thread has in flight
constexpr int MAX_CTILE = 256;

struct BnGeom {
  long long rows_g;  // rows of one group
  int C;             // channels, the row length
  int G;             // groups
  int chunks;        // blocks a group's rows are cut into
  int ctile;         // channels of a block: a multiple of VEC dividing C
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack(const uint4& v, float f[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[VEC]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Where a block works: its group, its rows [lo, hi), the thread's 8
// channels (col) and its first row offset r0 of rb rows a step.
struct Slice {
  int g, lane, r0, rb, tpr, col;
  long long lo, hi;
  bool active;
};

__device__ __forceinline__ Slice slice_of(const BnGeom& q) {
  Slice s;
  s.tpr = q.ctile / VEC;
  s.rb = THREADS / s.tpr;
  s.lane = threadIdx.x % s.tpr;
  s.r0 = threadIdx.x / s.tpr;
  s.active = s.r0 < s.rb;
  s.g = blockIdx.x / q.chunks;
  const int k = blockIdx.x % q.chunks;
  const long long span = (q.rows_g + q.chunks - 1) / q.chunks;
  const long long base = (long long)s.g * q.rows_g;
  s.lo = base + min((long long)k * span, q.rows_g);
  s.hi = base + min((long long)(k + 1) * span, q.rows_g);
  s.col = blockIdx.y * q.ctile + s.lane * VEC;
  return s;
}

// The block's NQ sums of its 8 channels a thread, added over the block's
// rows in a fixed order, to part[(blockIdx.x * NQ + q) * C + channel].
template <int NQ>
__device__ __forceinline__ void block_partials(const float (&acc)[NQ][VEC],
                                               const Slice& s,
                                               const BnGeom& q, float* part) {
  __shared__ float red[NQ * THREADS * VEC];
  const int ct = q.ctile;
  if (s.active) {
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red[(n * s.rb + s.r0) * ct + s.lane * VEC + j] = acc[n][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NQ * ct; i += THREADS) {
    const int n = i / ct, c = i % ct;
    float t = 0.f;
    for (int r = 0; r < s.rb; ++r) t += red[(n * s.rb + r) * ct + c];
    part[((size_t)blockIdx.x * NQ + n) * q.C + blockIdx.y * ct + c] = t;
  }
}

// The finalize kernels: a block takes FIN_CH channels (a warp's lanes, one
// 128-byte row of partials) and FIN_KL lanes of blocks k, each adding the
// partials of k = lane, lane + FIN_KL, ... in order; the FIN_KL sums are
// then added in lane order. Fixed, so deterministic, and FIN_KL loads in
// flight a channel where one thread a channel would walk every block's
// partial alone.
constexpr int FIN_CH = 32;
constexpr int FIN_KL = 16;
constexpr int FIN_THREADS = FIN_CH * FIN_KL;

// tot[n] = sum over k < count of part[((first + k) * NQ + n) * C + c], the
// same in every thread of the block's channel c
template <int NQ>
__device__ __forceinline__ void chunk_sums(const float* __restrict__ part,
                                           int first, int count, int C, int c,
                                           double (&tot)[NQ]) {
  __shared__ double red[NQ][FIN_KL][FIN_CH];
  const int lane = threadIdx.x % FIN_CH, kl = threadIdx.x / FIN_CH;
  double acc[NQ] = {};
  if (c < C)
    for (int k = kl; k < count; k += FIN_KL)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        acc[n] += part[((size_t)(first + k) * NQ + n) * C + c];
#pragma unroll
  for (int n = 0; n < NQ; ++n) red[n][kl][lane] = acc[n];
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    double t = 0.0;
    for (int l = 0; l < FIN_KL; ++l) t += red[n][l][lane];
    tot[n] = t;
  }
  __syncthreads();  // red is the next call's
}

// the 8 channels' values of a (5 or 2, G, C) f32 table's row `which`
__device__ __forceinline__ void table(const float* t, int which,
                                      const BnGeom& q, const Slice& s,
                                      float f[VEC]) {
  const float* p = t + ((size_t)which * q.G + s.g) * q.C + s.col;
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = p[j];
}

__device__ __forceinline__ void bias_of(const __nv_bfloat16* cb,
                                        const Slice& s, float f[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = __bfloat162float(cb[s.col + j]);
}

// rows of the statistics table st (5, G, C): mean, inv, mul, add, d
enum { ST_MEAN, ST_INV, ST_MUL, ST_ADD, ST_D, ST_ROWS };

__global__ void __launch_bounds__(THREADS)
    batch_norm_relu_stats(const __nv_bfloat16* __restrict__ y,
                          const __nv_bfloat16* __restrict__ cb, float* part,
                          BnGeom q) {
  const Slice s = slice_of(q);
  float acc[2][VEC] = {};
  if (s.active) {
    float b[VEC];
    bias_of(cb, s, b);
    const long long step = (long long)s.rb * UNROLL;
    for (long long r = s.lo + s.r0; r < s.hi; r += step) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * s.rb;
        if (rr < s.hi)
          v[u] = __ldg(reinterpret_cast<const uint4*>(y + rr * q.C + s.col));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * s.rb >= s.hi) break;
        float f[VEC];
        unpack(v[u], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float z = bf(__fadd_rn(f[j], b[j]));
          acc[0][j] += z;
          acc[1][j] = fmaf(z, z, acc[1][j]);
        }
      }
    }
  }
  block_partials<2>(acc, s, q, part);
}

__global__ void __launch_bounds__(FIN_THREADS) batch_norm_relu_finalize(
    const float* __restrict__ part, const float* __restrict__ weight,
    const float* __restrict__ bias, float* running_mean, float* running_var,
    long long* num_batches_tracked, float* st, BnGeom q, float eps,
    float momentum, float one_minus, float unbias, int update) {
  const int c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const bool writer = threadIdx.x < FIN_CH && c < q.C;
  const size_t gc = (size_t)q.G * q.C;
  float rm = 0.f, rv = 0.f, scale = 0.f, shift = 0.f;
  if (writer) {
    rm = update ? running_mean[c] : 0.f;
    rv = update ? running_var[c] : 0.f;
    scale = weight[c], shift = bias[c];
  }
  for (int g = 0; g < q.G; ++g) {
    double tot[2];
    chunk_sums<2>(part, g * q.chunks, q.chunks, q.C, c, tot);
    if (!writer) continue;
    const float mean = (float)(tot[0] / (double)q.rows_g);
    const float mean2 = (float)(tot[1] / (double)q.rows_g);
    const float d = __fsub_rn(mean2, __fmul_rn(mean, mean));
    const float var = fmaxf(d, 0.f);
    const float inv = rsqrtf(__fadd_rn(var, eps));
    const float mul = bf(__fmul_rn(inv, scale));
    const float add = bf(__fsub_rn(shift, __fmul_rn(__fmul_rn(mean, inv),
                                                    scale)));
    const size_t at = (size_t)g * q.C + c;
    st[ST_MEAN * gc + at] = mean;
    st[ST_INV * gc + at] = inv;
    st[ST_MUL * gc + at] = mul;
    st[ST_ADD * gc + at] = add;
    st[ST_D * gc + at] = d;
    if (update) {
      const float var_u = __fmul_rn(var, unbias);
      rm = __fadd_rn(__fmul_rn(momentum, rm), __fmul_rn(one_minus, mean));
      rv = __fadd_rn(__fmul_rn(momentum, rv), __fmul_rn(one_minus, var_u));
    }
  }
  if (update && writer) {
    running_mean[c] = rm;
    running_var[c] = rv;
    if (c == 0) *num_batches_tracked += q.G;
  }
}

__global__ void __launch_bounds__(THREADS)
    batch_norm_relu_apply(const __nv_bfloat16* __restrict__ y,
                          const __nv_bfloat16* __restrict__ cb,
                          const float* __restrict__ st,
                          __nv_bfloat16* __restrict__ out, BnGeom q) {
  const Slice s = slice_of(q);
  if (!s.active) return;
  float b[VEC], mul[VEC], add[VEC];
  bias_of(cb, s, b);
  table(st, ST_MUL, q, s, mul);
  table(st, ST_ADD, q, s, add);
  const long long step = (long long)s.rb * UNROLL;
  for (long long r = s.lo + s.r0; r < s.hi; r += step) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * s.rb;
      if (rr < s.hi)
        v[u] = __ldg(reinterpret_cast<const uint4*>(y + rr * q.C + s.col));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * s.rb;
      if (rr >= s.hi) break;
      float f[VEC];
      unpack(v[u], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float z = bf(__fadd_rn(f[j], b[j]));
        const float o = bf(__fadd_rn(bf(__fmul_rn(z, mul[j])), add[j]));
        f[j] = o < 0.f ? 0.f : o;  // torch's relu: NaN and -0 pass
      }
      *reinterpret_cast<uint4*>(out + rr * q.C + s.col) = pack(f);
    }
  }
}

// The backward's per-element work on one loaded row: z, the ReLU's mask
// from the forward's roundings, go.
__device__ __forceinline__ void grad_row(const uint4& gv, const uint4& yv,
                                         const float b[VEC],
                                         const float mul[VEC],
                                         const float add[VEC], float go[VEC],
                                         float z[VEC]) {
  float gf[VEC];
  unpack(gv, gf);
  unpack(yv, z);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    z[j] = bf(__fadd_rn(z[j], b[j]));
    const float o = bf(__fadd_rn(bf(__fmul_rn(z[j], mul[j])), add[j]));
    go[j] = o <= 0.f ? 0.f : gf[j];  // torch's threshold_backward
  }
}

__global__ void __launch_bounds__(THREADS)
    batch_norm_relu_grad_reduce(const __nv_bfloat16* __restrict__ g,
                                const __nv_bfloat16* __restrict__ y,
                                const __nv_bfloat16* __restrict__ cb,
                                const float* __restrict__ st, float* part,
                                BnGeom q) {
  const Slice s = slice_of(q);
  float acc[2][VEC] = {};
  if (s.active) {
    float b[VEC], mul[VEC], add[VEC], mean[VEC];
    bias_of(cb, s, b);
    table(st, ST_MUL, q, s, mul);
    table(st, ST_ADD, q, s, add);
    table(st, ST_MEAN, q, s, mean);
    const long long step = (long long)s.rb * UNROLL;
    for (long long r = s.lo + s.r0; r < s.hi; r += step) {
      uint4 gv[UNROLL], yv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * s.rb;
        if (rr < s.hi) {
          gv[u] = __ldg(reinterpret_cast<const uint4*>(g + rr * q.C + s.col));
          yv[u] = __ldg(reinterpret_cast<const uint4*>(y + rr * q.C + s.col));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * s.rb >= s.hi) break;
        float go[VEC], z[VEC];
        grad_row(gv[u], yv[u], b, mul, add, go, z);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[0][j] += go[j];
          acc[1][j] = fmaf(go[j], z[j] - mean[j], acc[1][j]);
        }
      }
    }
  }
  block_partials<2>(acc, s, q, part);
}

// gc (2, G, C): A, B of dz = go * mul + A + B * (z - mean); dweight, dbias
// (C) f32
__global__ void __launch_bounds__(FIN_THREADS) batch_norm_relu_grad_finalize(
    const float* __restrict__ part, const float* __restrict__ st,
    const float* __restrict__ weight, float* gc, float* dweight,
    float* dbias, BnGeom q) {
  const int c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const bool writer = threadIdx.x < FIN_CH && c < q.C;
  const size_t n = (size_t)q.G * q.C;
  const float scale = writer ? weight[c] : 0.f;
  const float m = (float)q.rows_g;
  float dw = 0.f, db = 0.f;
  for (int g = 0; g < q.G; ++g) {
    double tot[2];
    chunk_sums<2>(part, g * q.chunks, q.chunks, q.C, c, tot);
    if (!writer) continue;
    const size_t at = (size_t)g * q.C + c;
    const float mean = st[ST_MEAN * n + at], inv = st[ST_INV * n + at];
    const float d = st[ST_D * n + at];
    // g_add = S1; g_mul = sum go * z = S2 + mean * S1
    const float g_add = (float)tot[0], s2 = (float)tot[1];
    // mul = bf16(inv * scale), add = bf16(bias - mean * inv * scale)
    dw += s2 * inv;
    db += g_add;
    const float g_inv = s2 * scale;
    const float g_mean = -g_add * inv * scale;
    // inv = rsqrt(max(d, 0) + eps); clamp's gradient passes where d >= 0
    const float g_var = d >= 0.f ? -0.5f * g_inv * inv * inv * inv : 0.f;
    // mean = E[z], mean2 = E[z^2]: dz += (g_mean + 2 g_var (z - mean)) / M
    gc[at] = g_mean / m;
    gc[n + at] = 2.f * g_var / m;
  }
  if (writer) {
    dweight[c] = dw;
    dbias[c] = db;
  }
}

__global__ void __launch_bounds__(THREADS)
    batch_norm_relu_grad_apply(const __nv_bfloat16* __restrict__ g,
                               const __nv_bfloat16* __restrict__ y,
                               const __nv_bfloat16* __restrict__ cb,
                               const float* __restrict__ st,
                               const float* __restrict__ gc,
                               __nv_bfloat16* __restrict__ dz, float* part,
                               BnGeom q) {
  const Slice s = slice_of(q);
  float acc[1][VEC] = {};
  if (s.active) {
    float b[VEC], mul[VEC], add[VEC], mean[VEC], ca[VEC], cz[VEC];
    bias_of(cb, s, b);
    table(st, ST_MUL, q, s, mul);
    table(st, ST_ADD, q, s, add);
    table(st, ST_MEAN, q, s, mean);
    table(gc, 0, q, s, ca);
    table(gc, 1, q, s, cz);
    const long long step = (long long)s.rb * UNROLL;
    for (long long r = s.lo + s.r0; r < s.hi; r += step) {
      uint4 gv[UNROLL], yv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * s.rb;
        if (rr < s.hi) {
          gv[u] = __ldg(reinterpret_cast<const uint4*>(g + rr * q.C + s.col));
          yv[u] = __ldg(reinterpret_cast<const uint4*>(y + rr * q.C + s.col));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * s.rb;
        if (rr >= s.hi) break;
        float go[VEC], z[VEC];
        grad_row(gv[u], yv[u], b, mul, add, go, z);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          go[j] = bf(fmaf(go[j], mul[j], fmaf(cz[j], z[j] - mean[j], ca[j])));
          acc[0][j] += go[j];
        }
        *reinterpret_cast<uint4*>(dz + rr * q.C + s.col) = pack(go);
      }
    }
  }
  block_partials<1>(acc, s, q, part);
}

__global__ void __launch_bounds__(FIN_THREADS)
    batch_norm_relu_bias_grad(const float* __restrict__ part, float* dcb,
                              int blocks, int C) {
  const int c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  double tot[1];
  chunk_sums<1>(part, 0, blocks, C, c, tot);
  if (threadIdx.x < FIN_CH && c < C) dcb[c] = (float)tot[0];
}

bool valid(const BnGeom& q, const void* const* vecs, int n) {
  if (q.rows_g < 1 || q.G < 1 || q.chunks < 1 || q.C < VEC ||
      q.C % VEC != 0 || q.ctile < VEC || q.ctile > MAX_CTILE ||
      q.ctile % VEC != 0 || q.C % q.ctile != 0 ||
      (long long)q.chunks > q.rows_g)
    return false;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)vecs[i] % 16 != 0) return false;
  return true;
}

dim3 grid_of(const BnGeom& q) {
  return dim3((unsigned)(q.G * q.chunks), (unsigned)(q.C / q.ctile));
}

BnGeom geom(long long rows_g, int C, int G, int chunks, int ctile) {
  return BnGeom{rows_g, C, G, chunks, ctile};
}

}  // namespace

// Forward statistics: the partials of z and z^2 into part (G * chunks, 2, C)
// f32, then the (5, G, C) table st and, with update, the running averages
// and num_batches_tracked.
extern "C" int batch_norm_relu_stats_bf16(
    const void* y, const void* cb, const float* weight, const float* bias,
    float* running_mean, float* running_var, long long* num_batches_tracked,
    float* part, float* st, long long rows_g, int C, int G, int chunks,
    int ctile, float eps, float momentum, float one_minus, float unbias,
    int update, void* stream) {
  const BnGeom q = geom(rows_g, C, G, chunks, ctile);
  const void* vecs[] = {y};
  if (!valid(q, vecs, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* bb = static_cast<const __nv_bfloat16*>(cb);
  batch_norm_relu_stats<<<grid_of(q), THREADS, 0, s>>>(yb, bb, part, q);
  const int fin = (C + FIN_CH - 1) / FIN_CH;
  batch_norm_relu_finalize<<<fin, FIN_THREADS, 0, s>>>(
      part, weight, bias, running_mean, running_var, num_batches_tracked, st,
      q, eps, momentum, one_minus, unbias, update);
  return (int)cudaGetLastError();
}

// Forward apply: out = relu(bf16(bf16(z * mul) + add)) from the table st.
extern "C" int batch_norm_relu_apply_bf16(const void* y, const void* cb,
                                          const float* st, void* out,
                                          long long rows_g, int C, int G,
                                          int chunks, int ctile,
                                          void* stream) {
  const BnGeom q = geom(rows_g, C, G, chunks, ctile);
  const void* vecs[] = {y, out};
  if (!valid(q, vecs, 2)) return (int)cudaErrorInvalidValue;
  batch_norm_relu_apply<<<grid_of(q), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(cb), st,
      static_cast<__nv_bfloat16*>(out), q);
  return (int)cudaGetLastError();
}

// Backward: dz (bf16, y's layout), the conv bias' gradient dcb, the
// BatchNorm weight's and bias' gradients (f32, C each). part holds
// G * chunks * 2 * C floats, gc 2 * G * C.
extern "C" int batch_norm_relu_backward_bf16(
    const void* g, const void* y, const void* cb, const float* weight,
    const float* st, float* part, float* gc, void* dz, float* dweight,
    float* dbias, float* dcb, long long rows_g, int C, int G, int chunks,
    int ctile, void* stream) {
  const BnGeom q = geom(rows_g, C, G, chunks, ctile);
  const void* vecs[] = {g, y, dz};
  if (!valid(q, vecs, 3)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* bb = static_cast<const __nv_bfloat16*>(cb);
  batch_norm_relu_grad_reduce<<<grid_of(q), THREADS, 0, s>>>(gb, yb, bb, st,
                                                             part, q);
  const int fin = (C + FIN_CH - 1) / FIN_CH;
  batch_norm_relu_grad_finalize<<<fin, FIN_THREADS, 0, s>>>(
      part, st, weight, gc, dweight, dbias, q);
  // the reduce's partials are read: part is free for sum dz
  batch_norm_relu_grad_apply<<<grid_of(q), THREADS, 0, s>>>(
      gb, yb, bb, st, gc, static_cast<__nv_bfloat16*>(dz), part, q);
  batch_norm_relu_bias_grad<<<fin, FIN_THREADS, 0, s>>>(
      part, dcb, G * chunks, C);
  return (int)cudaGetLastError();
}
