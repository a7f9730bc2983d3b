// 3x3x3 stride-1 zero-padded SAME convolution (forward, no bias), written
// by hand for Hopper.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/conv3d.py::_pallas_call_merged
// (body `_make_kernel`, entry `conv3x3x3_same`). The TPU kernel's z
// block-Toeplitz packing and its 128-lane / Y % 8 / 128 % C rules exist for
// the TPU's (8, 128) tiling; this kernel is written from the math instead.
//
// Layout: x is NDHWC (a torch channels_last_3d tensor of logical shape
// (B, Ci, X, Y, Z)), w is (27, Ci, Co) with tap t = 9*i + 3*j + k, y is
// NDHWC. Implicit GEMM:
//     M = B*X*Y*Z output voxels, N = Co, K = 27*Ci
//     A[m, (t, ci)] = x[b, x+i-1, y+j-1, z+k-1, ci]   (0 outside the volume)
//     B[(t, ci), co] = w[t, ci, co]
// A is never materialised.
//
// Bound on the H100: operations at the V-Net's shapes (2*M*27*Ci*Co FLOP
// against (Ci+Co)*2 bytes per voxel in bf16: 27*Ci*Co/(Ci+Co) >= 216
// FLOP/byte at Ci = Co = 16, above the card's ~295 from Ci = Co = 32).
//
// bf16 (the inference path): one CTA owns a box of TX*TY*TZ <= 128 output
// voxels of one batch element (the box is picked per volume shape by the
// wrapper) and BN output channels. For each chunk of 16 input channels it
// stages the box's halo, (TX+2)(TY+2)(TZ+2) voxels, zero outside the
// volume, and the chunk's weights for all 27 taps in shared memory; then
// each of the 27 taps is one k16 step of mma.sync (bf16 in, f32 out) whose
// A rows are gathered from the halo by ldmatrix row addresses: tap (i,j,k)
// of output voxel (tx,ty,tz) is halo voxel (tx+i, ty+j, tz+k). Each input
// voxel is read from device memory about (halo / box) ~ 3 times instead
// of 27. f32 accumulators stay in registers; the result is rounded once to
// bf16.
// f32 (a tight check of the indexing on the card, and the f32 path):
// CUDA-core FMAs, each tap's shifted rows gathered straight from L1/L2.
// Simple on purpose: no wgmma, TMA or software pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Geom {
  int B, X, Y, Z, Ci, Co;
};

// Decode output voxel m of the flat (b, x, y, z) index.
__device__ __forceinline__ void decode(long long m, const Geom& g, int& b,
                                       int& x, int& y, int& z) {
  z = (int)(m % g.Z);
  m /= g.Z;
  y = (int)(m % g.Y);
  m /= g.Y;
  x = (int)(m % g.X);
  b = (int)(m / g.X);
}

// Offset of x[b, sx, sy, sz, ci], or -1 when (sx, sy, sz) is padding.
__device__ __forceinline__ long long src_offset(const Geom& g, int b, int sx,
                                                int sy, int sz, int ci) {
  if ((unsigned)sx >= (unsigned)g.X || (unsigned)sy >= (unsigned)g.Y ||
      (unsigned)sz >= (unsigned)g.Z)
    return -1;
  return ((((long long)b * g.X + sx) * g.Y + sy) * g.Z + sz) * g.Ci + ci;
}

// ---------------------------------------------------------------- bf16 --
constexpr int BM = 128;        // output voxels of one CTA (8 warps x 16)
constexpr int KC = 16;         // input channels per chunk = one mma k step
constexpr int LDA = KC + 8;    // halo row stride, bf16: 48 B, no ldmatrix
                               // bank conflicts
constexpr int MAX_HALO = 640;  // halo voxels the wrapper may ask for

struct Box {
  int tx, ty, tz;   // output box of one CTA
  int nbx, nby, nbz;  // boxes along each axis
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// WARPS_M x WARPS_N warps; each owns (BM/WARPS_M) rows x (BN/WARPS_N)
// columns as FM x FN mma tiles of 16 x 8.
template <int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xin,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ yout, Geom g, Box bx) {
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "warp layout");
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 8;
  static_assert(FN % 2 == 0, "B fragments load in pairs");
  constexpr int LDB = BN + 8;  // weight row stride, bf16
  extern __shared__ __align__(16) unsigned char smem[];

  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  const int halo = (bx.tx + 2) * HY * HZ;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + halo * LDA;

  // which box: blockIdx.x = ((b * nbx + ix) * nby + iy) * nbz + iz
  int t = blockIdx.x;
  const int iz = t % bx.nbz;
  t /= bx.nbz;
  const int iy = t % bx.nby;
  t /= bx.nby;
  const int ix = t % bx.nbx;
  const int b = t / bx.nbx;
  const int x0 = ix * bx.tx, y0 = iy * bx.ty, z0 = iz * bx.tz;
  const int n0 = blockIdx.y * BN;
  const int box_n = bx.tx * bx.ty * bx.tz;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  // this lane's ldmatrix row of each A fragment: its halo voxel at tap 0
  int a_base[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    int r = wm * WM + i * 16 + (lane & 15);
    if (r >= box_n) r = 0;  // rows past the box: any valid row, not stored
    const int rz = r % bx.tz, ry = (r / bx.tz) % bx.ty, rx = r / (bx.tz * bx.ty);
    a_base[i] = (rx * HY + ry) * HZ + rz;
  }
  const int koff = (lane >> 4) * 8;  // k half of the ldmatrix row

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int ci0 = 0; ci0 < g.Ci; ci0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    // halo of this channel chunk: 2 x 16 B per voxel, zero outside
    for (int idx = tid; idx < halo * 2; idx += THREADS) {
      const int hv = idx >> 1, half = idx & 1;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off = src_offset(g, b, x0 + hx - 1, y0 + hy - 1,
                                       z0 + hz - 1, ci0 + half * 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) v = *reinterpret_cast<const uint4*>(xin + off);
      *reinterpret_cast<uint4*>(As + hv * LDA + half * 8) = v;
    }
    // weights of this chunk for all 27 taps: rows (tap, ci), BN columns
    constexpr int VPR = BN / 8;  // 16 B vectors per row
    for (int idx = tid; idx < 27 * KC * VPR; idx += THREADS) {
      const int row = idx / VPR, c = (idx % VPR) * 8;
      const int tap = row / KC, ci = row % KC;
      *reinterpret_cast<uint4*>(Bs + row * LDB + c) =
          *reinterpret_cast<const uint4*>(
              w + ((long long)tap * g.Ci + ci0 + ci) * g.Co + n0 + c);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 27; ++tap) {
      const int di = tap / 9, dj = (tap / 3) % 3, dk = tap % 3;
      const int toff = (di * HY + dj) * HZ + dk;
      uint32_t af[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(af[i], smem_u32(As + (a_base[i] + toff) * LDA + koff));
      uint32_t bfr[FN][2];
#pragma unroll
      for (int j = 0; j < FN; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(Bs + (tap * KC + (lane & 15)) * LDB +
                                      wn * WN + j * 8 + koff));
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0],
                                              bfr[j][1]);
    }
  }

  // epilogue: each lane holds rows lane/4 and lane/4 + 8 of every fragment,
  // two neighbouring columns each
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * WM + i * 16 + (lane >> 2) + h * 8;
      if (r >= box_n) continue;
      const int rz = r % bx.tz, ry = (r / bx.tz) % bx.ty,
                rx = r / (bx.tz * bx.ty);
      const int ox = x0 + rx, oy = y0 + ry, oz = z0 + rz;
      if (ox >= g.X || oy >= g.Y || oz >= g.Z) continue;
      __nv_bfloat16* dst =
          yout + ((((long long)b * g.X + ox) * g.Y + oy) * g.Z + oz) * g.Co +
          n0 + wn * WN + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < FN; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

template <int BN, int WARPS_M, int WARPS_N>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                __nv_bfloat16* y, const Geom& g, const Box& bx,
                cudaStream_t s) {
  auto kernel = conv3x3x3_bf16_kernel<BN, WARPS_M, WARPS_N>;
  const int halo = (bx.tx + 2) * (bx.ty + 2) * (bx.tz + 2);
  const size_t smem =
      (size_t)(halo * LDA + 27 * KC * (BN + 8)) * sizeof(__nv_bfloat16);
  static bool opted_in = false;
  if (!opted_in) {
    const size_t most =
        (size_t)(MAX_HALO * LDA + 27 * KC * (BN + 8)) * sizeof(__nv_bfloat16);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)g.B * bx.nbx * bx.nby * bx.nbz,
                  (unsigned)(g.Co / BN));
  kernel<<<grid, THREADS, smem, s>>>(x, w, y, g, bx);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --
// CTA tile 64 x BN, K step 16; each thread a 4 x (BN/16) register tile.
constexpr int BM32 = 64;
constexpr int BK32 = 16;

template <int BN>
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_f32_kernel(const float* __restrict__ xin,
                         const float* __restrict__ w,
                         float* __restrict__ yout, Geom g) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[BK32][BM32 + 4];  // transposed: [k][m]
  __shared__ __align__(16) float Bs[BK32][BN];

  const int tid = threadIdx.x;
  const long long M = (long long)g.B * g.X * g.Y * g.Z;
  const long long m0 = (long long)blockIdx.x * BM32;
  const int n0 = blockIdx.y * BN;

  // A gather: thread owns 4 channels of one tile row for all K steps
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 4;
  const bool row_ok = m0 + a_row < M;
  int vb, vx, vy, vz;
  decode(row_ok ? m0 + a_row : 0, g, vb, vx, vy, vz);

  const int tr = tid / 16;  // rows tr*4 .. tr*4+3
  const int tc = tid % 16;  // cols tc*TN .. tc*TN+TN-1
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nci = g.Ci / BK32;
  const int ksteps = 27 * nci;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int tap = ks / nci;
    const int ci0 = (ks - tap * nci) * BK32;
    const int di = tap / 9 - 1, dj = (tap / 3) % 3 - 1, dk = tap % 3 - 1;

    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      const long long off =
          src_offset(g, vb, vx + di, vy + dj, vz + dk, ci0 + a_col);
      if (off >= 0) v = *reinterpret_cast<const float4*>(xin + off);
    }
    As[a_col + 0][a_row] = v.x;
    As[a_col + 1][a_row] = v.y;
    As[a_col + 2][a_row] = v.z;
    As[a_col + 3][a_row] = v.w;

    constexpr int B_VECS = BK32 * BN / 4;
    if (tid < B_VECS) {
      const int r = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const long long off = ((long long)tap * g.Ci + ci0 + r) * g.Co + n0 + c;
      *reinterpret_cast<float4*>(&Bs[r][c]) =
          *reinterpret_cast<const float4*>(w + off);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tc * TN + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tr * 4 + i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        yout[m * g.Co + n0 + tc * TN + j] = acc[i][j];
    }
  }
}

// Widest N tile that divides Co (the wrapper guarantees Co % 16 == 0).
int pick_bn(int co) { return co % 64 == 0 ? 64 : (co % 32 == 0 ? 32 : 16); }

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// (tx, ty, tz): the output box of one CTA, at most 128 voxels with a halo of
// at most 640; bn: output channels of one CTA, 64, 32 or 16 dividing Co.
extern "C" int conv3x3x3_bf16(const void* x, const void* w, void* y, int B,
                              int X, int Y, int Z, int Ci, int Co, int tx,
                              int ty, int tz, int bn, void* stream) {
  if (Ci % KC != 0 || Co % bn != 0 || tx < 1 || ty < 1 || tz < 1 ||
      tx * ty * tz > BM || (tx + 2) * (ty + 2) * (tz + 2) > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, Ci, Co};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  switch (bn) {
    case 64: return launch_bf16<64, 4, 2>(xb, wb, yb, g, bx, s);
    case 32: return launch_bf16<32, 4, 2>(xb, wb, yb, g, bx, s);
    case 16: return launch_bf16<16, 8, 1>(xb, wb, yb, g, bx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int conv3x3x3_f32(const float* x, const float* w, float* y, int B,
                             int X, int Y, int Z, int Ci, int Co,
                             void* stream) {
  if (Ci % BK32 != 0 || Co % 16 != 0) return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, Ci, Co};
  const long long M = (long long)B * X * Y * Z;
  const int bn = pick_bn(Co);
  const dim3 grid((unsigned)((M + BM32 - 1) / BM32), (unsigned)(Co / bn));
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 64)
    conv3x3x3_f32_kernel<64><<<grid, THREADS, 0, s>>>(x, w, y, g);
  else if (bn == 32)
    conv3x3x3_f32_kernel<32><<<grid, THREADS, 0, s>>>(x, w, y, g);
  else
    conv3x3x3_f32_kernel<16><<<grid, THREADS, 0, s>>>(x, w, y, g);
  return (int)cudaGetLastError();
}
