// Shifted-window attention with a relative position bias (SwinUNETR's
// WindowAttention after its qkv layer), forward and backward, written by
// hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package has no SwinUNETR. Eager
// PyTorch writes each block's (windows, heads, N, N) f32 scores, the bias
// gathered into the same shape, the mask added, the softmax and its bf16
// copy, about eight times forward and again backward. This file keeps the
// scores on chip.
//
// Layout: qkv is the qkv layer's output, (B * windows, N, 3, heads, 16)
// bf16 dense; O, dO are (B * windows, N, heads, 16); the log-sum-exp and
// the rows' delta (B * windows, heads, N) f32; the table is handed over
// transposed, (heads, 13^3) f32, and its gradient comes back (13^3, heads).
// Windows are each sample's in turn, so window bw's region ids are row
// bw % windows of the (windows, N) uint8 table (null: an unshifted block,
// no mask).
//
// Semantics (bcp_tpu_torch/ops/window_attn.py; the plain version is
// plain_window_attn there): with code(t) = (d * 13 + h) * 13 + w of token
// t's coordinates in the full 7^3 window (a clipped window takes its first
// N ordinals, MONAI's index[:N, :N]),
//   A[n, m] = (q_n . k_m) / 4 + T[code(n) - code(m) + 1098, h]
//             + (region(n) != region(m) ? -100 : 0)
//   O_n = sum_m bf16(exp(A[n, m] - M_n)) v_m / sum_m exp(A[n, m] - M_n)
//   lse_n = M_n + log sum_m exp(A[n, m] - M_n)
// and the backward, with P = exp(A - lse) recomputed:
//   dP = dO V^T, D_n = dO_n . O_n, dS = P (dP - D)
//   dQ = dS K / 4, dK = dS^T Q / 4, dV = bf16(P)^T dO,
//   dT[code(n) - code(m) + 1098, h] += dS[n, m] over all windows.
// Scores, softmax and sums are f32 (tensor-core MMAs m16n8k16 with f32
// accumulation); the MMAs' operands are bf16 (P, and dS for dQ and dK,
// rounded); dT sums the f32 dS.
//
// Bound on the H100: neither operations nor bytes. Per window, head and
// query-key pair the MMAs do 4 operations (q.k and p.v) forward and 10
// backward at 989 TFLOP/s, but the softmax's exponential, the bias'
// gather and the mask take a few instructions a pair on the CUDA cores;
// the bytes are q, k, v, O and the log-sum-exp forward, and those with dO,
// dQ, dK, dV and the table's partials backward, some 200 bytes a token.
// The passes:
//   window_attn_fwd      one block per (query tile of 64, head, window):
//                        K and V of the window in shared memory (V
//                        transposed, so P V's operand pairs are adjacent),
//                        the head's table column, each key's code and
//                        region; a warp's 16 rows go over the keys 64 at a
//                        time with an online softmax
//   window_attn_bwd_dq   one block per (head, window slot), looping over
//                        its windows: dQ and the rows' delta; each warp
//                        adds its dS into its own copy of the table's
//                        gradient in shared memory (see below), and the
//                        block writes the sum of its warps' copies in a
//                        fixed order as its partial
//   window_attn_bwd_dkdv one block per (key tile of 64, head, window): Q,
//                        dO (and both transposed), the log-sum-exp and the
//                        delta of every query in shared memory; a warp's
//                        16 keys go over the queries 64 at a time
//   window_attn_dt_sum   the partials in a fixed order
// No atomics: each warp stages a 16 x 64 tile of dS in shared memory and
// its lanes add one column each into the warp's copy, a row at a time. For
// one query row the 64 keys give 64 different table entries, so no two
// lanes touch one entry in a step, and __syncwarp orders the steps; two
// calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 16;                                  // head width
constexpr int WT = 7;                                   // the table's window
constexpr int TSIDE = 2 * WT - 1;                       // 13
constexpr int TBL = TSIDE * TSIDE * TSIDE;              // 2197 entries
constexpr int OFF = (WT - 1) * (TSIDE * TSIDE + TSIDE + 1);  // 1098
constexpr int MAXN = WT * WT * WT;                      // 343 tokens
constexpr int KB = 64;          // keys (or queries) a warp takes a step
constexpr int RS = 24;          // halves a row of a [token][16] tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * 16;  // rows of a forward or dK/dV block
constexpr int STG = 72;         // floats a row of a warp's dS tile
constexpr float MASKED = -100.f;
constexpr float SCALE = 0.25f;  // 1 / sqrt(16)

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ int code_of(int t) {
  return (t / (WT * WT)) * TSIDE * TSIDE + ((t / WT) % WT) * TSIDE + t % WT;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// tokens [0, nk) of one head as rows of 16 halves (stride RS) from src
// (a token every `stride` halves), zeros past n
__device__ void load_rows(bf16* dst, const bf16* src, long stride, int n,
                          int nk) {
  for (int i = threadIdx.x; i < nk * 2; i += blockDim.x) {
    const int t = i >> 1, part = i & 1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < n)
      v = *reinterpret_cast<const uint4*>(src + (long)t * stride + part * 8);
    *reinterpret_cast<uint4*>(dst + t * RS + part * 8) = v;
  }
}

// the same tokens transposed: dst[d * (nk + 8) + t]
__device__ void load_cols(bf16* dst, const bf16* src, long stride, int n,
                          int nk) {
  const int ld = nk + 8;
  for (int i = threadIdx.x; i < nk * 2; i += blockDim.x) {
    const int t = i >> 1, part = i & 1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < n)
      v = *reinterpret_cast<const uint4*>(src + (long)t * stride + part * 8);
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(part * 8 + j) * ld + t] = h[j];
  }
}

// each token's code (0 past n) and region id (0 without a mask)
__device__ void load_tokens(int* codes, unsigned char* reg,
                            const unsigned char* wreg, int n, int nk) {
  for (int t = threadIdx.x; t < nk; t += blockDim.x) {
    codes[t] = t < n ? code_of(t) : 0;
    reg[t] = (wreg != nullptr && t < n) ? wreg[t] : 0;
  }
}

// the A fragment (16 rows x 16) of rows r0 + g, r0 + g + 8 of a token
// matrix with `stride` halves a row; zero rows past n
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* src,
                                       long stride, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  a[0] = ra < n ? ld32(src + ra * stride + 2 * tq) : 0u;
  a[1] = rb < n ? ld32(src + rb * stride + 2 * tq) : 0u;
  a[2] = ra < n ? ld32(src + ra * stride + 2 * tq + 8) : 0u;
  a[3] = rb < n ? ld32(src + rb * stride + 2 * tq + 8) : 0u;
}

// the 8 n-tiles of a 16 x 64 product of A with rows kb.. of a [token][RS]
// tile (B = the tile's rows transposed)
__device__ __forceinline__ void row_products(float (*s)[4], const uint32_t* a,
                                             const bf16* tile, int kb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bf16* r = tile + (kb + j * 8 + g) * RS + 2 * tq;
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma(s[j], a, ld32(r), ld32(r + 8));
  }
}

// acc (16 x 16) += X (16 x 64, the n-tiles of row_products) times rows
// kb.. of a transposed tile cols (cols[d * ld + t])
__device__ __forceinline__ void col_products(float (*acc)[4],
                                             const float (*x)[4],
                                             const bf16* cols, int ld,
                                             int kb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack(x[2 * kk][0], x[2 * kk][1]),
                           pack(x[2 * kk][2], x[2 * kk][3]),
                           pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const bf16* c = cols + (nt * 8 + g) * ld + kb + kk * 16 + 2 * tq;
      mma(acc[nt], a, ld32(c), ld32(c + 8));
    }
  }
}

// write a 16 x 16 f32 accumulator times `mul` as bf16 rows r0 + g, + 8
__device__ __forceinline__ void store_rows(bf16* dst, long stride,
                                           const float (*acc)[4], float mul,
                                           int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (ra < n)
      *reinterpret_cast<uint32_t*>(dst + ra * stride + nt * 8 + 2 * tq) =
          pack(acc[nt][0] * mul, acc[nt][1] * mul);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(dst + rb * stride + nt * 8 + 2 * tq) =
          pack(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

}  // namespace

struct Fwd {
  int nk;
  __device__ __host__ Fwd(int n) : nk((n + KB - 1) / KB * KB) {}
  __device__ __host__ int k() const { return 0; }
  __device__ __host__ int vt() const { return k() + round16(nk * RS * 2); }
  __device__ __host__ int tab() const {
    return vt() + round16(HD * (nk + 8) * 2);
  }
  __device__ __host__ int codes() const { return tab() + round16(TBL * 4); }
  __device__ __host__ int reg() const { return codes() + round16(nk * 4); }
  __device__ __host__ int bytes() const { return reg() + round16(nk); }
};

__global__ void __launch_bounds__(THREADS)
    window_attn_fwd(const bf16* __restrict__ qkv,
                    const float* __restrict__ table_t,
                    const unsigned char* __restrict__ regions,
                    bf16* __restrict__ out, float* __restrict__ lse, int n,
                    int heads, int windows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Fwd L(n);
  const int nk = L.nk, ld = nk + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k());
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt());
  float* ts = reinterpret_cast<float*>(smem + L.tab());
  int* codes = reinterpret_cast<int*>(smem + L.codes());
  unsigned char* reg = smem + L.reg();
  const int bw = blockIdx.z, h = blockIdx.y, C = heads * HD;
  const long row3 = 3L * C;
  const bf16* base = qkv + (long)bw * n * row3 + h * HD;
  const unsigned char* wreg =
      regions ? regions + (long)(bw % windows) * n : nullptr;
  load_rows(ks, base + C, row3, n, nk);
  load_cols(vt, base + 2 * C, row3, n, nk);
  for (int r = threadIdx.x; r < TBL; r += THREADS)
    ts[r] = table_t[h * TBL + r];
  load_tokens(codes, reg, wreg, n, nk);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * QT + warp * 16;
  if (r0 >= n) return;
  const int ra = r0 + g, rb = ra + 8;
  uint32_t qa[4];
  load_a(qa, base, row3, r0, n);
  const int ca = (ra < n ? code_of(ra) : 0) + OFF;
  const int cb = (rb < n ? code_of(rb) : 0) + OFF;
  const unsigned char ga = (wreg && ra < n) ? wreg[ra] : 0;
  const unsigned char gb = (wreg && rb < n) ? wreg[rb] : 0;
  float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kb = 0; kb < nk; kb += KB) {
    float s[8][4];
    row_products(s, qa, ks, kb);
    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = kb + j * 8 + 2 * tq + e;
        const int cm = codes[m];
        float a = s[j][e] * SCALE + ts[ca - cm];
        float b = s[j][2 + e] * SCALE + ts[cb - cm];
        if (wreg) {
          if (reg[m] != ga) a += MASKED;
          if (reg[m] != gb) b += MASKED;
        }
        if (m >= n) a = b = -INFINITY;
        s[j][e] = a;
        s[j][2 + e] = b;
        xa = fmaxf(xa, a);
        xb = fmaxf(xb, b);
      }
    const float na = fmaxf(ma, group_max(xa)), nb = fmaxf(mb, group_max(xb));
    const float fa = __expf(ma - na), fb = __expf(mb - nb);
    ma = na;
    mb = nb;
    la *= fa;
    lb *= fb;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      o[nt][0] *= fa;
      o[nt][1] *= fa;
      o[nt][2] *= fb;
      o[nt][3] *= fb;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - na);
        s[j][2 + e] = __expf(s[j][2 + e] - nb);
        la += s[j][e];
        lb += s[j][2 + e];
      }
    col_products(o, s, vt, ld, kb);
  }
  la = group_sum(la);
  lb = group_sum(lb);
  bf16* ob = out + (long)bw * n * C + h * HD;
  const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (ra < n)
      *reinterpret_cast<uint32_t*>(ob + (long)ra * C + nt * 8 + 2 * tq) =
          pack(o[nt][0] * ia, o[nt][1] * ia);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(ob + (long)rb * C + nt * 8 + 2 * tq) =
          pack(o[nt][2] * ib, o[nt][3] * ib);
  }
  if (tq == 0) {
    float* lrow = lse + ((long)bw * heads + h) * n;
    if (ra < n) lrow[ra] = ma + logf(la);
    if (rb < n) lrow[rb] = mb + logf(lb);
  }
}

struct Dq {
  int nk;
  __device__ __host__ Dq(int n) : nk((n + KB - 1) / KB * KB) {}
  __device__ __host__ int k() const { return 0; }
  __device__ __host__ int v() const { return k() + round16(nk * RS * 2); }
  __device__ __host__ int kt() const { return v() + round16(nk * RS * 2); }
  __device__ __host__ int tab() const {
    return kt() + round16(HD * (nk + 8) * 2);
  }
  __device__ __host__ int acc() const { return tab() + round16(TBL * 4); }
  __device__ __host__ int stage() const {
    return acc() + round16(WARPS * TBL * 4);
  }
  __device__ __host__ int codes() const {
    return stage() + round16(WARPS * 16 * STG * 4);
  }
  __device__ __host__ int reg() const { return codes() + round16(nk * 4); }
  __device__ __host__ int bytes() const { return reg() + round16(nk); }
};

__global__ void __launch_bounds__(THREADS)
    window_attn_bwd_dq(const bf16* __restrict__ qkv,
                       const float* __restrict__ table_t,
                       const unsigned char* __restrict__ regions,
                       const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dqkv,
                       float* __restrict__ part, int bwn, int n, int heads,
                       int windows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dq L(n);
  const int nk = L.nk, ld = nk + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k());
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v());
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kt());
  float* ts = reinterpret_cast<float*>(smem + L.tab());
  float* acc = reinterpret_cast<float*>(smem + L.acc());
  float* stage = reinterpret_cast<float*>(smem + L.stage());
  int* codes = reinterpret_cast<int*>(smem + L.codes());
  unsigned char* reg = smem + L.reg();
  const int h = blockIdx.x, slot = blockIdx.y, slots = gridDim.y;
  const int C = heads * HD;
  const long row3 = 3L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  for (int r = threadIdx.x; r < TBL; r += THREADS) {
    ts[r] = table_t[h * TBL + r];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc[w * TBL + r] = 0.f;
  }
  float* my = acc + warp * TBL;
  float* st = stage + warp * 16 * STG;
  for (int bw = slot; bw < bwn; bw += slots) {
    __syncthreads();  // the last window's tiles are read
    const bf16* base = qkv + (long)bw * n * row3 + h * HD;
    const unsigned char* wreg =
        regions ? regions + (long)(bw % windows) * n : nullptr;
    load_rows(ks, base + C, row3, n, nk);
    load_rows(vs, base + 2 * C, row3, n, nk);
    load_cols(kt, base + C, row3, n, nk);
    load_tokens(codes, reg, wreg, n, nk);
    __syncthreads();
    const bf16* ob = out + (long)bw * n * C + h * HD;
    const bf16* db = dout + (long)bw * n * C + h * HD;
    const float* lrow = lse + ((long)bw * heads + h) * n;
    float* drow = delta + ((long)bw * heads + h) * n;
    for (int r0 = warp * 16; r0 < n; r0 += WARPS * 16) {
      const int ra = r0 + g, rb = ra + 8;
      uint32_t qa[4], da[4], oa[4];
      load_a(qa, base, row3, r0, n);
      load_a(da, db, C, r0, n);
      load_a(oa, ob, C, r0, n);
      float Da = 0.f, Db = 0.f;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const float2 d0 = unpack(da[i]), o0 = unpack(oa[i]);
        const float2 d1 = unpack(da[i + 1]), o1 = unpack(oa[i + 1]);
        Da += d0.x * o0.x + d0.y * o0.y;
        Db += d1.x * o1.x + d1.y * o1.y;
      }
      Da = group_sum(Da);
      Db = group_sum(Db);
      if (tq == 0) {
        if (ra < n) drow[ra] = Da;
        if (rb < n) drow[rb] = Db;
      }
      const float La = ra < n ? lrow[ra] : 0.f, Lb = rb < n ? lrow[rb] : 0.f;
      const int ca = (ra < n ? code_of(ra) : 0) + OFF;
      const int cb = (rb < n ? code_of(rb) : 0) + OFF;
      const unsigned char ga = (wreg && ra < n) ? wreg[ra] : 0;
      const unsigned char gb = (wreg && rb < n) ? wreg[rb] : 0;
      float dq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kb = 0; kb < nk; kb += KB) {
        float s[8][4], dp[8][4];
        row_products(s, qa, ks, kb);
        row_products(dp, da, vs, kb);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = kb + j * 8 + 2 * tq + e;
            const int cm = codes[m];
            float a = s[j][e] * SCALE + ts[ca - cm];
            float b = s[j][2 + e] * SCALE + ts[cb - cm];
            if (wreg) {
              if (reg[m] != ga) a += MASKED;
              if (reg[m] != gb) b += MASKED;
            }
            const bool ok = m < n;
            const float pa = (ok && ra < n) ? __expf(a - La) : 0.f;
            const float pb = (ok && rb < n) ? __expf(b - Lb) : 0.f;
            s[j][e] = pa * (dp[j][e] - Da);
            s[j][2 + e] = pb * (dp[j][2 + e] - Db);
          }
        col_products(dq, s, kt, ld, kb);
        // the table's gradient: the dS tile through shared memory, a
        // column a lane, a row a step
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            st[g * STG + j * 8 + 2 * tq + e] = s[j][e];
            st[(g + 8) * STG + j * 8 + 2 * tq + e] = s[j][2 + e];
          }
        __syncwarp();
        for (int i = 0; i < 16; ++i) {
          const int r = r0 + i;
          if (r < n) {
            const int cr = code_of(r) + OFF;
#pragma unroll
            for (int c = lane; c < KB; c += 32) {
              const int m = kb + c;
              if (m < n) my[cr - codes[m]] += st[i * STG + c];
            }
          }
          __syncwarp();
        }
      }
      store_rows(dqkv + (long)bw * n * row3 + h * HD, row3, dq, SCALE, r0,
                 n);
    }
  }
  __syncthreads();
  float* p = part + ((long)slot * heads + h) * TBL;
  for (int r = threadIdx.x; r < TBL; r += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += acc[w * TBL + r];
    p[r] = v;
  }
}

struct Dkdv {
  int nk;
  __device__ __host__ Dkdv(int n) : nk((n + KB - 1) / KB * KB) {}
  __device__ __host__ int q() const { return 0; }
  __device__ __host__ int d() const { return q() + round16(nk * RS * 2); }
  __device__ __host__ int qt() const { return d() + round16(nk * RS * 2); }
  __device__ __host__ int dt() const {
    return qt() + round16(HD * (nk + 8) * 2);
  }
  __device__ __host__ int tab() const {
    return dt() + round16(HD * (nk + 8) * 2);
  }
  __device__ __host__ int lse() const { return tab() + round16(TBL * 4); }
  __device__ __host__ int delta() const { return lse() + round16(nk * 4); }
  __device__ __host__ int codes() const { return delta() + round16(nk * 4); }
  __device__ __host__ int reg() const { return codes() + round16(nk * 4); }
  __device__ __host__ int bytes() const { return reg() + round16(nk); }
};

__global__ void __launch_bounds__(THREADS)
    window_attn_bwd_dkdv(const bf16* __restrict__ qkv,
                         const float* __restrict__ table_t,
                         const unsigned char* __restrict__ regions,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dqkv, int n, int heads,
                         int windows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dkdv L(n);
  const int nk = L.nk, ld = nk + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q());
  bf16* ds = reinterpret_cast<bf16*>(smem + L.d());
  bf16* qt = reinterpret_cast<bf16*>(smem + L.qt());
  bf16* dt = reinterpret_cast<bf16*>(smem + L.dt());
  float* ts = reinterpret_cast<float*>(smem + L.tab());
  float* ls = reinterpret_cast<float*>(smem + L.lse());
  float* dl = reinterpret_cast<float*>(smem + L.delta());
  int* codes = reinterpret_cast<int*>(smem + L.codes());
  unsigned char* reg = smem + L.reg();
  const int bw = blockIdx.z, h = blockIdx.y, C = heads * HD;
  const long row3 = 3L * C;
  const bf16* base = qkv + (long)bw * n * row3 + h * HD;
  const bf16* db = dout + (long)bw * n * C + h * HD;
  const unsigned char* wreg =
      regions ? regions + (long)(bw % windows) * n : nullptr;
  load_rows(qs, base, row3, n, nk);
  load_rows(ds, db, C, n, nk);
  load_cols(qt, base, row3, n, nk);
  load_cols(dt, db, C, n, nk);
  for (int r = threadIdx.x; r < TBL; r += THREADS)
    ts[r] = table_t[h * TBL + r];
  const long at = ((long)bw * heads + h) * n;
  for (int t = threadIdx.x; t < nk; t += THREADS) {
    ls[t] = t < n ? lse[at + t] : 0.f;
    dl[t] = t < n ? delta[at + t] : 0.f;
  }
  load_tokens(codes, reg, wreg, n, nk);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * QT + warp * 16;
  if (m0 >= n) return;
  const int ma = m0 + g, mb = ma + 8;
  uint32_t ka[4], va[4];
  load_a(ka, base + C, row3, m0, n);
  load_a(va, base + 2 * C, row3, m0, n);
  const int ca = OFF - (ma < n ? code_of(ma) : 0);
  const int cb = OFF - (mb < n ? code_of(mb) : 0);
  const unsigned char ga = (wreg && ma < n) ? wreg[ma] : 0;
  const unsigned char gb = (wreg && mb < n) ? wreg[mb] : 0;
  float dk[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float dv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int qb = 0; qb < nk; qb += KB) {
    float s[8][4], dp[8][4];
    row_products(s, ka, qs, qb);
    row_products(dp, va, ds, qb);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = qb + j * 8 + 2 * tq + e;
        const int cq = codes[q];
        float a = s[j][e] * SCALE + ts[cq + ca];
        float b = s[j][2 + e] * SCALE + ts[cq + cb];
        if (wreg) {
          if (reg[q] != ga) a += MASKED;
          if (reg[q] != gb) b += MASKED;
        }
        const bool ok = q < n;
        const float pa = ok ? __expf(a - ls[q]) : 0.f;
        const float pb = ok ? __expf(b - ls[q]) : 0.f;
        s[j][e] = pa;
        s[j][2 + e] = pb;
        dp[j][e] = pa * (dp[j][e] - dl[q]);
        dp[j][2 + e] = pb * (dp[j][2 + e] - dl[q]);
      }
    col_products(dv, s, dt, ld, qb);
    col_products(dk, dp, qt, ld, qb);
  }
  bf16* gb_ = dqkv + (long)bw * n * row3 + h * HD;
  store_rows(gb_ + C, row3, dk, SCALE, m0, n);
  store_rows(gb_ + 2 * C, row3, dv, 1.f, m0, n);
}

__global__ void window_attn_dt_sum(const float* __restrict__ part,
                                   float* __restrict__ dtable, int heads,
                                   int slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= TBL * heads) return;
  const int r = i / heads, h = i % heads;
  float v = 0.f;
  for (int s = 0; s < slots; ++s) v += part[((long)s * heads + h) * TBL + r];
  dtable[i] = v;
}

// each kernel's shared memory limit raised once, to what the largest
// window (N = 343) takes
namespace {

template <typename K>
cudaError_t opt_in(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = e == cudaSuccess;
  return e;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Forward: O (bf16) and the log-sum-exp (f32) of bwn windows of n tokens.
extern "C" int window_attn_fwd_bf16(const void* qkv, const float* table_t,
                                    const unsigned char* regions, void* out,
                                    float* lse, int bwn, int n, int heads,
                                    int windows, void* stream) {
  if (n < 1 || n > MAXN || heads < 1 || bwn < 1 || windows < 1 ||
      !aligned(qkv) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const Fwd L(n);
  static bool done = false;
  const cudaError_t e = opt_in(window_attn_fwd, Fwd(MAXN).bytes(), &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + QT - 1) / QT), (unsigned)heads,
                  (unsigned)bwn);
  window_attn_fwd<<<grid, THREADS, L.bytes(), (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), table_t, regions,
      static_cast<bf16*>(out), lse, n, heads, windows);
  return (int)cudaGetLastError();
}

// Backward: dqkv (bf16, qkv's layout) and the table's gradient (f32,
// (13^3, heads)); delta holds bwn * heads * n floats, part slots * heads *
// 13^3.
extern "C" int window_attn_bwd_bf16(
    const void* qkv, const float* table_t, const unsigned char* regions,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dqkv, float* part, float* dtable, int bwn, int n, int heads,
    int windows, int slots, void* stream) {
  if (n < 1 || n > MAXN || heads < 1 || bwn < 1 || windows < 1 ||
      slots < 1 || !aligned(qkv) || !aligned(out) || !aligned(dout) ||
      !aligned(dqkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dq A(n);
  const Dkdv B(n);
  static bool done_dq = false, done_dkdv = false;
  cudaError_t e = opt_in(window_attn_bwd_dq, Dq(MAXN).bytes(), &done_dq);
  if (e == cudaSuccess)
    e = opt_in(window_attn_bwd_dkdv, Dkdv(MAXN).bytes(), &done_dkdv);
  if (e != cudaSuccess) return (int)e;
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* d = static_cast<const bf16*>(dout);
  auto* g = static_cast<bf16*>(dqkv);
  window_attn_bwd_dq<<<dim3((unsigned)heads, (unsigned)slots), THREADS,
                       A.bytes(), s>>>(q, table_t, regions,
                                       static_cast<const bf16*>(out), d, lse,
                                       delta, g, part, bwn, n, heads,
                                       windows);
  const dim3 grid((unsigned)((n + QT - 1) / QT), (unsigned)heads,
                  (unsigned)bwn);
  window_attn_bwd_dkdv<<<grid, THREADS, B.bytes(), s>>>(
      q, table_t, regions, d, lse, delta, g, n, heads, windows);
  window_attn_dt_sum<<<(TBL * heads + 255) / 256, 256, 0, s>>>(part, dtable,
                                                                heads, slots);
  return (int)cudaGetLastError();
}
