// Fused backward of the 3x3x3 stride-1 zero-padded SAME convolution with
// Ci == Co == C, written by hand for Hopper: one pass over x and dy gives
//     dx[b, v, ci]        = sum over taps t, co of
//                           dy_pad[b, v + t, co] * wt[t, co, ci]
//     dW[t, ci, co] (f32) = sum over (b, v) of
//                           x_pad[b, v + t, ci] * dy[b, v, co]
// where wt is the spatially flipped, io-transposed weight (the SAME conv of
// dy with wt is dx) and tap t = 9*i + 3*j + k.
//
// Replaces the Pallas TPU kernel
// bcp_tpu/ops/conv3d.py::_conv3x3x3_dxdw_pallas (body `_make_dxdw_kernel`,
// wrapper `conv3x3x3_dxdw`). The TPU kernel accumulates dW in one
// VMEM-resident block over a sequential grid and builds a 9*(G+2)*C-lane
// im2col with Toeplitz weights for a 128-lane matrix unit; neither exists
// here. What it keeps out of device memory is kept here too: each dy tile
// is staged once (as a halo tile) and serves both as dx's shifted operand
// and, through its centre, as dW's operand.
//
// Layout: x, dy, dx are NDHWC (B, X, Y, Z, C); wt is (27, C, C) rows
// (tap, co), columns ci; dW is (27, C, C) f32 rows (tap, ci), columns co.
//
// Grid: (C / 16, C / CG, splits). A CTA owns 16 input channels (dx's
// columns and dW's rows), a group of CG = 16 or 32 output channels (dx's
// reduction slice and dW's columns) and every splits-th output box of the
// volume (the forward's box geometry, at most 128 voxels with a halo of at
// most 640). Its wt block (27 x CG x 16) is staged once. Per box it stages
// dy's halo (CG channels) and x's halo (16 channels), zero outside the
// volume; then
//   dx: warps 0-7 own 16 box voxels each; per tap and 16 channels of the
//       group one mma.sync k16 step whose A rows are dy-halo rows gathered
//       by ldmatrix row addresses (tap (i,j,k) of box voxel (x,y,z) is halo
//       voxel (x+i, y+j, z+k)); the box's 128 x 16 block is written out at
//       once;
//   dW: the nine warps own taps (i, j, 0..2) each, as the dW kernel does:
//       A fragments are x-halo rows read transposed, B fragments are the
//       dy halo's centre rows, indexed inside the staged halo (no second
//       load of dy); 27*16 x CG f32 accumulators stay in registers across
//       the CTA's boxes.
// What crosses CTAs goes through a workspace and one fixed-order second
// pass (no float atomics: two runs on the same input give the same bits):
// dW's partial sums over splits, and, when C > CG, dx's partial sums over
// the channel groups (f32, rounded to x's dtype once, after the sum). At
// C = 16 and 32, where dx is largest, one group holds all channels and dx
// is written directly. (Groups of 64 channels were tried: fewer, fatter
// CTAs were no faster at C = 64 and slower at the deep stages.)
//
// Bound on the H100: operations (2 * 2 * M * 27 * C^2 FLOP against
// 3 * M * C elements moved) from C = 32 up in bf16, bytes at C = 16; see
// chip_smoke.py. The design reads dy C / 16 times and x C / CG times
// (from L2 at the deep stages, whose tensors are small) and runs one CTA
// per SM without software pipelining: simple on purpose, no wgmma or TMA
// yet. f32: the same walk on CUDA cores (a tight check of the indexing,
// and the f32 slice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;          // input channels of one CTA
constexpr int WARPS = 9;        // warp 3*i + j owns dW taps (i, j, 0..2)
constexpr int THREADS = WARPS * 32;
constexpr int BOX = 128;        // most output voxels of one box
constexpr int MAX_HALO = 640;   // most halo voxels of one box
constexpr int LDA = KC + 8;     // bf16 row stride of the x halo and of wt:
                                // 48 B, no ldmatrix bank conflicts

struct Geom {
  int B, X, Y, Z, C;
};

struct Box {
  int tx, ty, tz;     // output box
  int nbx, nby, nbz;  // boxes along each axis
};

// Offset of t[b, sx, sy, sz, c] in an NDHWC tensor, or -1 outside the
// volume.
__device__ __forceinline__ long long offset(const Geom& g, int b, int sx,
                                            int sy, int sz, int c) {
  if ((unsigned)sx >= (unsigned)g.X || (unsigned)sy >= (unsigned)g.Y ||
      (unsigned)sz >= (unsigned)g.Z)
    return -1;
  return ((((long long)b * g.X + sx) * g.Y + sy) * g.Z + sz) * g.C + c;
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

// Box voxel r -> its coordinates inside the box.
__device__ __forceinline__ void box_voxel(int r, const Box& bx, int& rx,
                                          int& ry, int& rz) {
  rz = r % bx.tz;
  ry = (r / bx.tz) % bx.ty;
  rx = r / (bx.tz * bx.ty);
}

// Rows of the staged halos that box voxel r reads: xrow[r] is its halo
// voxel at tap (0, 0, 0) (tap (i, j, k) adds (i*HY + j)*HZ + k), dyrow[r]
// its own (centre) halo voxel. Rows past the box read halo voxel 0 of x and
// the all-zero row `zero_row` of dy, so they add nothing to dW.
__device__ __forceinline__ void fill_rows(int* xrow, int* dyrow,
                                          const Box& bx, int box_n,
                                          int zero_row) {
  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  for (int r = threadIdx.x; r < BOX; r += THREADS) {
    int rx, ry, rz;
    box_voxel(r, bx, rx, ry, rz);
    const int base = (rx * HY + ry) * HZ + rz;
    xrow[r] = r < box_n ? base : 0;
    dyrow[r] = r < box_n ? base + (HY + 1) * HZ + 1 : zero_row;
  }
}

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

// What every kernel of this file is handed. dx goes to `dx` (x's dtype)
// when the grid has one channel group, else as f32 partial sums to
// `dx_ws + group * dx_stride`; dW goes to `dw + split * dw_stride` (the
// launcher points `dw` at the result when splits == 1, else at the
// workspace).
struct Args {
  const void* x;
  const void* dy;
  const void* wt;
  void* dx;
  float* dx_ws;
  float* dw;
  Geom g;
  Box bx;
  int n_boxes, splits;
  long long dw_stride, dx_stride;
};

// ---------------------------------------------------------------- bf16 --
template <int CG>
__global__ void __launch_bounds__(THREADS) dxdw_bf16_kernel(Args a) {
  const auto* xin = static_cast<const __nv_bfloat16*>(a.x);
  const auto* dy = static_cast<const __nv_bfloat16*>(a.dy);
  const auto* wt = static_cast<const __nv_bfloat16*>(a.wt);
  const Geom g = a.g;
  const Box bx = a.bx;
  constexpr int NT = CG / 8;    // dW's mma n tiles: every warp covers CG
  constexpr int LDD = CG + 8;   // dy halo row stride, bf16 (80 or 48 B)
  constexpr int VPD = CG / 8;   // 16-byte vectors per dy row
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int xrow[BOX];
  __shared__ int dyrow[BOX];

  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  const int halo = (bx.tx + 2) * HY * HZ;
  const int box_n = bx.tx * bx.ty * bx.tz;
  const int rows = (box_n + 15) & ~15;  // dW's k steps of 16 voxels
  __nv_bfloat16* Dys = reinterpret_cast<__nv_bfloat16*>(smem);  // halo + 1
  __nv_bfloat16* Xs = Dys + (halo + 1) * LDD;                   // halo
  __nv_bfloat16* Ws = Xs + halo * LDA;                          // 27 * CG

  const int ci0 = blockIdx.x * KC;
  const int n0 = blockIdx.y * CG;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wtoff = ((warp / 3) * HY + warp % 3) * HZ;  // dW tap (i, j, 0)
  const int koff = (lane >> 4) * 8;

  fill_rows(xrow, dyrow, bx, box_n, halo);
  for (int c = tid; c < LDD; c += THREADS)
    Dys[halo * LDD + c] = __float2bfloat16(0.0f);
  // this CTA's weights, once: rows (tap, co of the group), 16 ci columns
  for (int idx = tid; idx < 27 * CG * 2; idx += THREADS) {
    const int row = idx >> 1, half = idx & 1;
    const int tap = row / CG, co = row % CG;
    *reinterpret_cast<uint4*>(Ws + row * LDA + half * 8) =
        *reinterpret_cast<const uint4*>(
            wt + ((long long)tap * g.C + n0 + co) * g.C + ci0 + half * 8);
  }

  float acc[3][NT][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;

  for (int kb = split; kb < a.n_boxes; kb += a.splits) {
    int b, x0, y0, z0;
    box_origin(kb, bx, b, x0, y0, z0);
    __syncthreads();  // the previous box's reads are done (and rows set)
    for (int idx = tid; idx < halo * VPD; idx += THREADS) {
      const int hv = idx / VPD, c = (idx % VPD) * 8;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off =
          offset(g, b, x0 + hx - 1, y0 + hy - 1, z0 + hz - 1, n0 + c);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) v = *reinterpret_cast<const uint4*>(dy + off);
      *reinterpret_cast<uint4*>(Dys + hv * LDD + c) = v;
    }
    for (int idx = tid; idx < halo * 2; idx += THREADS) {
      const int hv = idx >> 1, half = idx & 1;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off =
          offset(g, b, x0 + hx - 1, y0 + hy - 1, z0 + hz - 1, ci0 + half * 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) v = *reinterpret_cast<const uint4*>(xin + off);
      *reinterpret_cast<uint4*>(Xs + hv * LDA + half * 8) = v;
    }
    __syncthreads();

    // ---- dx: 128 box voxels x 16 ci, reduced over 27 taps x CG co
    if (warp < 8 && warp * 16 < box_n) {
      float dacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[j][e] = 0.0f;
      const int arow = xrow[warp * 16 + (lane & 15)];
#pragma unroll 1
      for (int tap = 0; tap < 27; ++tap) {
        const int toff = ((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3;
#pragma unroll
        for (int kc = 0; kc < CG; kc += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, smem_u32(Dys + (arow + toff) * LDD + kc + koff));
          ldmatrix_x4_trans(
              bf, smem_u32(Ws + (tap * CG + kc + (lane & 15)) * LDA + koff));
          mma_bf16(dacc[0], af, bf[0], bf[1]);
          mma_bf16(dacc[1], af, bf[2], bf[3]);
        }
      }
      // each lane holds rows lane/4 and lane/4 + 8, two neighbouring
      // columns of each of the two n tiles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + h * 8;
        if (r >= box_n) continue;
        int rx, ry, rz;
        box_voxel(r, bx, rx, ry, rz);
        const long long off =
            offset(g, b, x0 + rx, y0 + ry, z0 + rz, ci0 + (lane & 3) * 2);
        if (off < 0) continue;
        if (gridDim.y == 1) {
          auto* dst = static_cast<__nv_bfloat16*>(a.dx) + off;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
                __floats2bfloat162_rn(dacc[j][2 * h], dacc[j][2 * h + 1]);
        } else {
          float* dst = a.dx_ws + (long long)blockIdx.y * a.dx_stride + off;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(dst + j * 8) =
                make_float2(dacc[j][2 * h], dacc[j][2 * h + 1]);
        }
      }
    }

    // ---- dW: (27 taps x 16 ci) x CG co, reduced over the box's voxels
#pragma unroll 1
    for (int k0 = 0; k0 < rows; k0 += 16) {
      // dy centre rows of voxels k0..k0+15, shared by the warp's three taps
      uint32_t bfr[NT][2];
      const int drow = dyrow[k0 + (lane & 15)];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(Dys + drow * LDD + j * 8 + koff));
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
      // A = x halo rows (voxels) read transposed: matrix q = lane / 8 holds
      // voxels k0 + (q / 2) * 8 + 0..7 and channels (q % 2) * 8 + 0..7
      const int kr = k0 + (lane & 7) + ((lane >> 4) << 3);
      const int hrow = xrow[kr] + wtoff;
      const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, smem_u32(Xs + (hrow + t) * LDA + col));
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[t][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  }

  // each lane holds rows (ci) lane/4 and lane/4 + 8 of every tile, two
  // neighbouring columns (co) each
  float* dst = a.dw + (long long)split * a.dw_stride;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int tap = warp * 3 + t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + (lane >> 2) + h * 8;
      float* row = dst + ((long long)tap * g.C + ci) * g.C + n0 +
                   (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(row + j * 8) =
            make_float2(acc[t][j][2 * h], acc[t][j][2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------- f32 --
// Same walk on CUDA cores. dW: lane = (co half, ci), each thread a
// 3 x (CG/2) register tile. dx: thread = (box voxel, ci half), 8 sums.
template <int CG>
__global__ void __launch_bounds__(THREADS) dxdw_f32_kernel(Args a) {
  const auto* xin = static_cast<const float*>(a.x);
  const auto* dy = static_cast<const float*>(a.dy);
  const auto* wt = static_cast<const float*>(a.wt);
  const Geom g = a.g;
  const Box bx = a.bx;
  constexpr int CPT = CG / 2;   // dW's output channels of one thread
  constexpr int LDD = CG + 4;   // dy halo row stride, f32
  constexpr int VPD = CG / 4;   // float4 per dy row
  extern __shared__ __align__(16) float smf[];
  __shared__ int xrow[BOX];
  __shared__ int dyrow[BOX];

  const int HY = bx.ty + 2, HZ = bx.tz + 2;
  const int halo = (bx.tx + 2) * HY * HZ;
  const int box_n = bx.tx * bx.ty * bx.tz;
  float* Dys = smf;                // [halo][LDD]
  float* Xs = Dys + halo * LDD;    // [halo][16]
  float* Ws = Xs + halo * KC;      // [27 * CG][16]

  const int ci0 = blockIdx.x * KC;
  const int n0 = blockIdx.y * CG;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ci = lane & 15;
  const int c0 = (lane >> 4) * CPT;
  const int wtoff = ((warp / 3) * HY + warp % 3) * HZ;

  fill_rows(xrow, dyrow, bx, box_n, 0);
  for (int idx = tid; idx < 27 * CG * 4; idx += THREADS) {
    const int row = idx >> 2, q = idx & 3;
    const int tap = row / CG, co = row % CG;
    *reinterpret_cast<float4*>(Ws + row * KC + q * 4) =
        *reinterpret_cast<const float4*>(
            wt + ((long long)tap * g.C + n0 + co) * g.C + ci0 + q * 4);
  }

  float acc[3][CPT];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[t][c] = 0.0f;

  for (int kb = split; kb < a.n_boxes; kb += a.splits) {
    int b, x0, y0, z0;
    box_origin(kb, bx, b, x0, y0, z0);
    __syncthreads();
    for (int idx = tid; idx < halo * VPD; idx += THREADS) {
      const int hv = idx / VPD, c = (idx % VPD) * 4;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off =
          offset(g, b, x0 + hx - 1, y0 + hy - 1, z0 + hz - 1, n0 + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off >= 0) v = *reinterpret_cast<const float4*>(dy + off);
      *reinterpret_cast<float4*>(Dys + hv * LDD + c) = v;
    }
    for (int idx = tid; idx < halo * 4; idx += THREADS) {
      const int hv = idx >> 2, q = idx & 3;
      const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
      const long long off =
          offset(g, b, x0 + hx - 1, y0 + hy - 1, z0 + hz - 1, ci0 + q * 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off >= 0) v = *reinterpret_cast<const float4*>(xin + off);
      *reinterpret_cast<float4*>(Xs + hv * KC + q * 4) = v;
    }
    __syncthreads();

    // ---- dx: thread = (box voxel, 8 of the 16 ci)
    const int v = tid >> 1, half = tid & 1;
    if (v < box_n) {
      int rx, ry, rz;
      box_voxel(v, bx, rx, ry, rz);
      const long long off =
          offset(g, b, x0 + rx, y0 + ry, z0 + rz, ci0 + half * 8);
      if (off >= 0) {
        float dacc[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) dacc[q] = 0.0f;
#pragma unroll 1
        for (int tap = 0; tap < 27; ++tap) {
          const int toff = ((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3;
          const float* drow = Dys + (xrow[v] + toff) * LDD;
          const float* wrow = Ws + tap * CG * KC + half * 8;
#pragma unroll 4
          for (int co = 0; co < CG; ++co) {
            const float dv = drow[co];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              dacc[q] = fmaf(dv, wrow[co * KC + q], dacc[q]);
          }
        }
        float* dst = gridDim.y == 1
                         ? static_cast<float*>(a.dx) + off
                         : a.dx_ws + (long long)blockIdx.y * a.dx_stride + off;
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = dacc[q];
      }
    }

    // ---- dW
#pragma unroll 1
    for (int r = 0; r < box_n; ++r) {
      const float* h = Xs + (xrow[r] + wtoff) * KC + ci;
      const float a0 = h[0], a1 = h[KC], a2 = h[2 * KC];
      const float* d = Dys + dyrow[r] * LDD + c0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float dv = d[c];
        acc[0][c] = fmaf(a0, dv, acc[0][c]);
        acc[1][c] = fmaf(a1, dv, acc[1][c]);
        acc[2][c] = fmaf(a2, dv, acc[2][c]);
      }
    }
  }

  float* dst = a.dw + (long long)split * a.dw_stride;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* row =
        dst + ((long long)(warp * 3 + t) * g.C + ci0 + ci) * g.C + n0 + c0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[c] = acc[t][c];
  }
}

// The fixed-order second pass: dw[i] = sum of dw_ws[s * n_dw + i] over
// splits s in order (when splits > 1), dx[i] = sum of dx_ws[q * n_dx + i]
// over channel groups q in order, rounded to T (when groups > 1).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void dxdw_reduce_kernel(const float* __restrict__ dw_ws,
                                   float* __restrict__ dw, long long n_dw,
                                   int splits,
                                   const float* __restrict__ dx_ws,
                                   T* __restrict__ dx, long long n_dx,
                                   int groups) {
  const long long first = splits > 1 ? n_dw : 0;
  const long long total = first + (groups > 1 ? n_dx : 0);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (i < first) {
      for (int k = 0; k < splits; ++k) s += dw_ws[(long long)k * n_dw + i];
      dw[i] = s;
    } else {
      const long long j = i - first;
      for (int k = 0; k < groups; ++k) s += dx_ws[(long long)k * n_dx + j];
      store(dx + j, s);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

using Kernel = void (*)(Args);

// Launch the main kernel and, when sums cross CTAs, the second pass.
// `most` is the kernel's largest dynamic shared memory; above 48 KB the
// kernel opts in once (`opted_in`).
template <typename T>
int launch(Kernel kernel, size_t smem, size_t most, bool& opted_in,
           const void* x, const void* dy, const void* wt, void* dx,
           void* dx_ws, void* dw_ws, void* dw, const Geom& g, const Box& bx,
           int cg, int splits, cudaStream_t s) {
  if (!opted_in) {
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in = true;
  }
  const int groups = g.C / cg;
  const long long n_dw = 27LL * g.C * g.C;
  const long long n_dx = (long long)g.B * g.X * g.Y * g.Z * g.C;
  Args a;
  a.x = x;
  a.dy = dy;
  a.wt = wt;
  a.dx = dx;
  a.dx_ws = static_cast<float*>(dx_ws);
  a.dw = static_cast<float*>(splits > 1 ? dw_ws : dw);
  a.g = g;
  a.bx = bx;
  a.n_boxes = g.B * bx.nbx * bx.nby * bx.nbz;
  a.splits = splits;
  a.dw_stride = n_dw;
  a.dx_stride = n_dx;
  const dim3 grid((unsigned)(g.C / KC), (unsigned)groups, (unsigned)splits);
  kernel<<<grid, THREADS, smem, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e != 0 || (splits == 1 && groups == 1)) return e;
  const long long total = (splits > 1 ? n_dw : 0) + (groups > 1 ? n_dx : 0);
  const int blocks = (int)((total + 255) / 256 < 2048 ? (total + 255) / 256
                                                       : 2048);
  dxdw_reduce_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(dw_ws), static_cast<float*>(dw), n_dw, splits,
      static_cast<const float*>(dx_ws), static_cast<T*>(dx), n_dx, groups);
  return (int)cudaGetLastError();
}

bool bad_args(int C, int tx, int ty, int tz, int cg, int splits) {
  return C % KC != 0 || (cg != 16 && cg != 32) || C % cg != 0 || tx < 1 ||
         ty < 1 || tz < 1 || tx * ty * tz > BOX ||
         (tx + 2) * (ty + 2) * (tz + 2) > MAX_HALO || splits < 1;
}

}  // namespace

// x, dy (B, X, Y, Z, C) NDHWC and wt (27, C, C) [tap][co][ci] of one dtype;
// dx (B, X, Y, Z, C) of that dtype; dw (27, C, C) f32 [tap][ci][co].
// dx_ws: (C / cg) * B*X*Y*Z*C f32 when C > cg; dw_ws: splits * 27*C*C f32
// when splits > 1 (each unused otherwise). (tx, ty, tz) is the output box,
// cg (16 or 32) the output channels of one CTA.
extern "C" int conv3x3x3_dxdw_bf16(const void* x, const void* dy,
                                   const void* wt, void* dx, void* dx_ws,
                                   void* dw_ws, void* dw, int B, int X, int Y,
                                   int Z, int C, int tx, int ty, int tz,
                                   int cg, int splits, void* stream) {
  if (bad_args(C, tx, ty, tz, cg, splits)) return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, C};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  const int halo = (tx + 2) * (ty + 2) * (tz + 2);
  auto smem = [](int h, int n) {
    return (size_t)((h + 1) * (n + 8) + h * LDA + 27 * n * LDA) *
           sizeof(__nv_bfloat16);
  };
  cudaStream_t s = (cudaStream_t)stream;
  static bool opted[2] = {false, false};
  if (cg == 32)
    return launch<__nv_bfloat16>(dxdw_bf16_kernel<32>, smem(halo, 32),
                                 smem(MAX_HALO, 32), opted[1], x, dy, wt, dx,
                                 dx_ws, dw_ws, dw, g, bx, cg, splits, s);
  return launch<__nv_bfloat16>(dxdw_bf16_kernel<16>, smem(halo, 16),
                               smem(MAX_HALO, 16), opted[0], x, dy, wt, dx,
                               dx_ws, dw_ws, dw, g, bx, cg, splits, s);
}

extern "C" int conv3x3x3_dxdw_f32(const void* x, const void* dy,
                                  const void* wt, void* dx, void* dx_ws,
                                  void* dw_ws, void* dw, int B, int X, int Y,
                                  int Z, int C, int tx, int ty, int tz,
                                  int cg, int splits, void* stream) {
  if (bad_args(C, tx, ty, tz, cg, splits)) return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, C};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  const int halo = (tx + 2) * (ty + 2) * (tz + 2);
  auto smem = [](int h, int n) {
    return (size_t)(h * (n + 4) + h * KC + 27 * n * KC) * sizeof(float);
  };
  cudaStream_t s = (cudaStream_t)stream;
  static bool opted[2] = {false, false};
  if (cg == 32)
    return launch<float>(dxdw_f32_kernel<32>, smem(halo, 32),
                         smem(MAX_HALO, 32), opted[1], x, dy, wt, dx, dx_ws,
                         dw_ws, dw, g, bx, cg, splits, s);
  return launch<float>(dxdw_f32_kernel<16>, smem(halo, 16),
                       smem(MAX_HALO, 16), opted[0], x, dy, wt, dx, dx_ws,
                       dw_ws, dw, g, bx, cg, splits, s);
}
