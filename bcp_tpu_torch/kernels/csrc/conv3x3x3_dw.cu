// Weight gradient of the 3x3x3 stride-1 zero-padded SAME convolution,
// written by hand for Hopper:
//     dW[i, j, k, ci, co] = sum over (b, x, y, z) of
//         x_pad[b, x+i, y+j, z+k, ci] * dy[b, x, y, z, co]
// accumulated in f32.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/conv3d.py::_conv3x3x3_dw_pallas
// (body `_make_dw_kernel`, fold `_fold_toeplitz_grad`). The TPU kernel sums
// every grid step into one VMEM-resident block over a sequential grid; on
// the GPU blocks run in parallel, so the voxel reduction is split over CTAs
// and summed by a second, fixed-order pass (no float atomics: two runs on
// the same input give the same bits).
//
// Layout: x is NDHWC (B, X, Y, Z, Ci), dy is NDHWC (B, X, Y, Z, Co), the
// result is (27, Ci, Co) f32 with tap t = 9*i + 3*j + k. Implicit GEMM:
//     M = 27*Ci rows (tap, ci), N = Co, K = B*X*Y*Z voxels
//     A[(t, ci), m] = x[b, x+i-1, y+j-1, z+k-1, ci]   (0 outside the volume)
//     B[m, co]      = dy[b, x, y, z, co]
//
// Grid: (Ci / 16, Co / BN, splits). A CTA owns 16 input channels, all 27
// taps and BN output channels: a (27*16) x BN block of f32 accumulators in
// registers, split over 9 warps, warp w = 3*i + j owning taps (i, j, 0..2).
// It walks the output boxes b = split, split + splits, ... of the volume
// (the forward's box geometry, picked by the wrapper's `halo_box`): for
// each box it stages the box's x halo (its 16 channels, zero outside the
// volume) and the box's dy rows (BN channels, zero outside the volume) in
// shared memory, then runs one k16 step of mma.sync (bf16 in, f32 out) per
// 16 box voxels and tap. A fragments are x-halo rows read transposed
// (ldmatrix.trans: the halo holds voxels as rows, the GEMM wants channels
// as rows); the dy fragment of a k step is shared by the warp's three taps.
// With splits > 1 each CTA writes its partial block to a workspace slice
// and `dw_reduce_kernel` sums the slices in split order.
//
// Bound on the H100: operations at the V-Net's deep stages and bytes (x and
// dy read once) at the 16-channel full-resolution stage; see chip_smoke.py.
// f32: the same CTA walk on CUDA cores (a tight check of the indexing, and
// the f32 slice). Simple on purpose: no wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;          // input channels of one CTA = mma M tile
constexpr int WARPS = 9;        // warp 3*i + j owns taps (i, j, 0..2)
constexpr int THREADS = WARPS * 32;
constexpr int BOX = 128;        // most output voxels of one box
constexpr int MAX_HALO = 640;   // most halo voxels of one box
constexpr int LDA = KC + 8;     // bf16 halo row stride: no ldmatrix bank
                                // conflicts

struct Geom {
  int B, X, Y, Z, Ci, Co;
};

struct Box {
  int tx, ty, tz;     // output box
  int nbx, nby, nbz;  // boxes along each axis
};

// Offset of t[b, sx, sy, sz, c] in an NDHWC tensor of C channels, or -1
// outside the volume.
__device__ __forceinline__ long long offset(const Geom& g, int C, int b,
                                            int sx, int sy, int sz, int c) {
  if ((unsigned)sx >= (unsigned)g.X || (unsigned)sy >= (unsigned)g.Y ||
      (unsigned)sz >= (unsigned)g.Z)
    return -1;
  return ((((long long)b * g.X + sx) * g.Y + sy) * g.Z + sz) * C + c;
}

// Box number -> batch element and origin.
__device__ __forceinline__ void box_origin(int t, const Box& bx, int& b,
                                           int& x0, int& y0, int& z0) {
  const int iz = t % bx.nbz;
  t /= bx.nbz;
  const int iy = t % bx.nby;
  t /= bx.nby;
  const int ix = t % bx.nbx;
  b = t / bx.nbx;
  x0 = ix * bx.tx;
  y0 = iy * bx.ty;
  z0 = iz * bx.tz;
}

// Halo index of box voxel r at tap (0, 0, 0); tap (i, j, k) adds
// (i*HY + j)*HZ + k.
__device__ __forceinline__ int row_base(int r, const Box& bx) {
  const int rz = r % bx.tz, ry = (r / bx.tz) % bx.ty, rx = r / (bx.tz * bx.ty);
  return (rx * (bx.ty + 2) + ry) * (bx.tz + 2) + rz;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// ---------------------------------------------------------------- bf16 --
template <int BN>
__global__ void __launch_bounds__(THREADS)
    dw_bf16_kernel(const void* __restrict__ x_, const void* __restrict__ dy_,
                   float* __restrict__ out, Geom g, Box bx, int n_boxes,
                   int splits, long long split_stride) {
  const auto* xin = static_cast<const __nv_bfloat16*>(x_);
  const auto* dy = static_cast<const __nv_bfloat16*>(dy_);
  constexpr int NT = BN / 8;   // mma n tiles; every warp covers all BN
  constexpr int LDB = BN + 8;  // dy row stride, bf16
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rbase[BOX];

  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  const int halo = (bx.tx + 2) * HY * HZ;
  const int box_n = bx.tx * bx.ty * bx.tz;
  const int rows = (box_n + 15) & ~15;  // k steps of 16 voxels
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + halo * LDA;

  const int ci0 = blockIdx.x * KC;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int toff = ((warp / 3) * HY + warp % 3) * HZ;  // tap (i, j, 0)

  for (int r = tid; r < BOX; r += THREADS)
    rbase[r] = r < box_n ? row_base(r, bx) : 0;  // rows past the box: any
                                                 // valid row (dy is 0 there)

  float acc[3][NT][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;

  constexpr int VPR = BN / 8;  // 16-byte vectors per dy row
  for (int kb = split; kb < n_boxes; kb += splits) {
    int b, x0, y0, z0;
    box_origin(kb, bx, b, x0, y0, z0);
    __syncthreads();  // the previous box's reads are done (and rbase set)
    for (int idx = tid; idx < halo * 2; idx += THREADS) {
      const int hv = idx >> 1, half = idx & 1;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off = offset(g, g.Ci, b, x0 + hx - 1, y0 + hy - 1,
                                   z0 + hz - 1, ci0 + half * 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) v = *reinterpret_cast<const uint4*>(xin + off);
      *reinterpret_cast<uint4*>(As + hv * LDA + half * 8) = v;
    }
    for (int idx = tid; idx < rows * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < box_n) {
        const int rz = r % bx.tz, ry = (r / bx.tz) % bx.ty,
                  rx = r / (bx.tz * bx.ty);
        const long long off =
            offset(g, g.Co, b, x0 + rx, y0 + ry, z0 + rz, n0 + c);
        if (off >= 0) v = *reinterpret_cast<const uint4*>(dy + off);
      }
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int k0 = 0; k0 < rows; k0 += 16) {
      // dy fragments of voxels k0..k0+15, shared by the warp's three taps
      uint32_t bfr[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(Bs + (k0 + (lane & 15)) * LDB + j * 8 +
                                      (lane >> 4) * 8));
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
      // A = x halo rows (voxels) read transposed: matrix q = lane / 8 holds
      // voxels k0 + (q / 2) * 8 + 0..7 and channels (q % 2) * 8 + 0..7
      const int kr = k0 + (lane & 7) + ((lane >> 4) << 3);
      const int hrow = rbase[kr] + toff;
      const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, smem_u32(As + (hrow + t) * LDA + col));
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[t][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  }

  // each lane holds rows (ci) lane/4 and lane/4 + 8 of every tile, two
  // neighbouring columns (co) each
  float* dst = out + (long long)split * split_stride;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int tap = warp * 3 + t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + (lane >> 2) + h * 8;
      float* row = dst + ((long long)tap * g.Ci + ci) * g.Co + n0 +
                   (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(acc[t][j][2 * h], acc[t][j][2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------- f32 --
// Same walk; lane = (co half, ci): each thread a 3 x (BN/2) register tile.
template <int BN>
__global__ void __launch_bounds__(THREADS)
    dw_f32_kernel(const void* __restrict__ x_, const void* __restrict__ dy_,
                  float* __restrict__ out, Geom g, Box bx, int n_boxes,
                  int splits, long long split_stride) {
  const auto* xin = static_cast<const float*>(x_);
  const auto* dy = static_cast<const float*>(dy_);
  constexpr int CPT = BN / 2;  // output channels of one thread
  extern __shared__ __align__(16) float smf[];
  __shared__ int rbase[BOX];

  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  const int halo = (bx.tx + 2) * HY * HZ;
  const int box_n = bx.tx * bx.ty * bx.tz;
  float* Hs = smf;              // [halo][16]
  float* Ds = smf + halo * KC;  // [BOX][BN]

  const int ci0 = blockIdx.x * KC;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ci = lane & 15;
  const int c0 = (lane >> 4) * CPT;
  const int toff = ((warp / 3) * HY + warp % 3) * HZ;

  for (int r = tid; r < BOX; r += THREADS)
    rbase[r] = r < box_n ? row_base(r, bx) : 0;

  float acc[3][CPT];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[t][c] = 0.0f;

  constexpr int VPR = BN / 4;  // float4 per dy row
  for (int kb = split; kb < n_boxes; kb += splits) {
    int b, x0, y0, z0;
    box_origin(kb, bx, b, x0, y0, z0);
    __syncthreads();
    for (int idx = tid; idx < halo * 4; idx += THREADS) {
      const int hv = idx >> 2, q = idx & 3;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off = offset(g, g.Ci, b, x0 + hx - 1, y0 + hy - 1,
                                   z0 + hz - 1, ci0 + q * 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off >= 0) v = *reinterpret_cast<const float4*>(xin + off);
      *reinterpret_cast<float4*>(Hs + hv * KC + q * 4) = v;
    }
    for (int idx = tid; idx < box_n * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * 4;
      const int rz = r % bx.tz, ry = (r / bx.tz) % bx.ty,
                rx = r / (bx.tz * bx.ty);
      const long long off =
          offset(g, g.Co, b, x0 + rx, y0 + ry, z0 + rz, n0 + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off >= 0) v = *reinterpret_cast<const float4*>(dy + off);
      *reinterpret_cast<float4*>(Ds + r * BN + c) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < box_n; ++r) {
      const float* h = Hs + (rbase[r] + toff) * KC + ci;
      const float a0 = h[0], a1 = h[KC], a2 = h[2 * KC];
      const float* d = Ds + r * BN + c0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float dv = d[c];
        acc[0][c] = fmaf(a0, dv, acc[0][c]);
        acc[1][c] = fmaf(a1, dv, acc[1][c]);
        acc[2][c] = fmaf(a2, dv, acc[2][c]);
      }
    }
  }

  float* dst = out + (long long)split * split_stride;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* row =
        dst + ((long long)(warp * 3 + t) * g.Ci + ci0 + ci) * g.Co + n0 + c0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[c] = acc[t][c];
  }
}

// out[i] = sum of ws[s * n + i] over s = 0 .. splits-1, in that order.
__global__ void dw_reduce_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, long long n,
                                 int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[(long long)k * n + i];
    out[i] = s;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

using DwKernel = void (*)(const void*, const void*, float*, Geom, Box, int,
                         int, long long);

// Launch the main kernel into `ws` (splits > 1) or straight into `out`,
// then the fixed-order reduce. `most` is the kernel's largest dynamic
// shared memory; above 48 KB the kernel opts in once (`opted_in`).
int launch(DwKernel kernel, size_t smem, size_t most, bool& opted_in,
           const void* x, const void* dy, float* ws, float* out,
           const Geom& g, const Box& bx, int bn, int splits, cudaStream_t s) {
  if (!opted_in) {
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in = true;
  }
  const long long n = 27LL * g.Ci * g.Co;
  const int n_boxes = g.B * bx.nbx * bx.nby * bx.nbz;
  const dim3 grid((unsigned)(g.Ci / KC), (unsigned)(g.Co / bn),
                  (unsigned)splits);
  float* dst = splits > 1 ? ws : out;
  kernel<<<grid, THREADS, smem, s>>>(x, dy, dst, g, bx, n_boxes, splits, n);
  int e = (int)cudaGetLastError();
  if (e != 0 || splits == 1) return e;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}

bool bad_args(int Ci, int Co, int tx, int ty, int tz, int bn, int splits) {
  return Ci % KC != 0 || (bn != 16 && bn != 32) || Co % bn != 0 || tx < 1 ||
         ty < 1 || tz < 1 || tx * ty * tz > BOX ||
         (tx + 2) * (ty + 2) * (tz + 2) > MAX_HALO || splits < 1;
}

}  // namespace

// x (B, X, Y, Z, Ci), dy (B, X, Y, Z, Co) bf16 NDHWC; out (27, Ci, Co) f32;
// ws: splits * 27 * Ci * Co f32 when splits > 1 (else unused). (tx, ty, tz)
// is the output box, bn (16 or 32) the output channels of one CTA.
extern "C" int conv3x3x3_dw_bf16(const void* x, const void* dy, void* ws,
                                 void* out, int B, int X, int Y, int Z,
                                 int Ci, int Co, int tx, int ty, int tz,
                                 int bn, int splits, void* stream) {
  if (bad_args(Ci, Co, tx, ty, tz, bn, splits))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, Ci, Co};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  const int halo = (tx + 2) * (ty + 2) * (tz + 2);
  const int rows = (tx * ty * tz + 15) & ~15;
  auto smem = [&](int h, int r, int n) {
    return (size_t)(h * LDA + r * (n + 8)) * sizeof(__nv_bfloat16);
  };
  cudaStream_t s = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  static bool opted[2] = {false, false};
  if (bn == 32)
    return launch(dw_bf16_kernel<32>, smem(halo, rows, 32),
                  smem(MAX_HALO, BOX, 32), opted[1], x, dy, w, o, g, bx, bn,
                  splits, s);
  return launch(dw_bf16_kernel<16>, smem(halo, rows, 16),
                smem(MAX_HALO, BOX, 16), opted[0], x, dy, w, o, g, bx, bn,
                splits, s);
}

extern "C" int conv3x3x3_dw_f32(const void* x, const void* dy, void* ws,
                                void* out, int B, int X, int Y, int Z, int Ci,
                                int Co, int tx, int ty, int tz, int bn,
                                int splits, void* stream) {
  if (bad_args(Ci, Co, tx, ty, tz, bn, splits))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, Ci, Co};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  const int halo = (tx + 2) * (ty + 2) * (tz + 2);
  auto smem = [&](int h, int n) {
    return (size_t)(h * KC + BOX * n) * sizeof(float);
  };
  cudaStream_t s = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  static bool opted[2] = {false, false};
  if (bn == 32)
    return launch(dw_f32_kernel<32>, smem(halo, 32), smem(MAX_HALO, 32),
                  opted[1], x, dy, w, o, g, bx, bn, splits, s);
  return launch(dw_f32_kernel<16>, smem(halo, 16), smem(MAX_HALO, 16),
                opted[0], x, dy, w, o, g, bx, bn, splits, s);
}
