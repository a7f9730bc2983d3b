// Fused backward of the 3x3x3 stride-1 zero-padded SAME convolution with
// Ci == Co == C, written by hand for Hopper: one pass over x and dy gives
//     dx[b, v, ci]        = sum over taps t, co of
//                           dy_pad[b, v + t, co] * w[co, ci, 26 - t]
//     dW[t, ci, co] (f32) = sum over (b, v) of
//                           x_pad[b, v + t, ci] * dy[b, v, co]
// (dx is the SAME conv of dy with the spatially flipped, io-transposed
// weights), tap t = 9*i + 3*j + k, shift (i - 1, j - 1, k - 1).
//
// Replaces the Pallas TPU kernel
// bcp_tpu/ops/conv3d.py::_conv3x3x3_dxdw_pallas (body `_make_dxdw_kernel`,
// wrapper `conv3x3x3_dxdw`). The TPU kernel accumulates dW in one
// VMEM-resident block over a sequential grid and builds a 9*(G+2)*C-lane
// im2col with Toeplitz weights for a 128-lane matrix unit; neither exists
// here. What it keeps out of device memory is kept here too: each dy tile
// is staged once and serves both products.
//
// Layout: x, dy, dx are NDHWC (B, X, Y, Z, C); w is the conv's weights
// (C, C, 27) [co][ci][tap]; dW is (27, C, C) f32 [tap][ci][co].
//
// Bound on the H100: operations from C = 32 up (2 * 2 * M * 27 * C^2 FLOP
// against 3 * M * C bf16 elements moved), bytes at C = 16. Like kernel B,
// what holds it below that is feeding the tensor cores from shared memory:
// every staged voxel is read by 27 taps of each product.
//
// bf16 (the main path), `dxdw_bf16_kernel<CI, CG, MINB>`:
//
// - Work. A box is MT = 3 tiles (z planes of 8 x 8 voxels, the m64 tile of
//   kernel B). A CTA of three warpgroups owns CI input channels (dx's
//   columns, dW's rows), a group of CG output channels (dx's reduction
//   slice, dW's columns) and every splits-th box of the volume
//   (blockIdx.x); grid (splits, C/CI * C/CG).
// - One staging of dy for both products. A ring stage holds one box's dy
//   slab (CG channels, 10 x 10 x 5 voxels) and x slab (CI channels, 10 x
//   10 x 6, the last plane zero), laid out [plane][8-channel group][x][y]
//   in 16-byte entries (`Slab`, conv_common.cuh), zero outside the volume
//   (cp.async with a source size of 0). Both GEMMs read them from shared
//   memory by descriptor; no thread gathers anything:
//   dx: warpgroup w multiplies tile w: M = its 64 voxels, N = CI, K = (tap,
//       16 channels of the group): A is the dy slab K-major, a tap a shift
//       of its start address, as in kernel B; B the packed weights.
//   dW: `DwEngine` (conv_common.cuh): warpgroup w owns taps (w, j, k):
//       M = (z tap, ci), 64 / CI z taps of CI channels per m64 tile (rows of
//       taps past k = 2 are computed and dropped: a quarter of the dW math
//       at CI = 16 and 32), N = CG, K = the box's voxels; the x slab
//       shifted by the tap and the dy slab's centre are both MN-major
//       (transposed) operands: 8 channels of one voxel are a core row, 8
//       voxels along y a core matrix. Voxels of a ragged box outside the
//       volume hold dy = 0 and add nothing.
//   The dW sums (27 * CI * CG f32, 3 * (CG/2) * passes registers a thread)
//   stay in registers across the CTA's boxes; dx's stay for one box.
// - Which sums cross CTAs. dW's must persist across boxes for a fixed (ci
//   tile, co group); dx's sum over all co. One of the two goes through a
//   workspace:
//   dx (this design): (C / CG) f32 copies of dx when C > CG, written once
//   and read once by the second pass: 4 * M * C * (C/CG) bytes each way;
//   none at 4x16@112x112x80 (CG = 16), 4x32@56x56x40 (CG = 32) and
//   4x64@28x28x20 (CG = 64, where CG = 32 would write 32 MB), 16 MB at
//   4x128@14x14x10 and 8 MB at 4x256@7x7x5 (CG = 32);
//   dW instead (CTAs own boxes and every co): dW partials per box group,
//   27 * C^2 * 4 bytes each: at C = 64 and 33 box groups 14.6 MB, but the
//   (27 * CI * C) f32 of a CTA do not fit in registers beyond C = 64,
//   so they would be written per box: 448 boxes * 442 KB = 198 MB at 4x64.
//   dW's own partials over the splits (splits * 27 * C^2 f32) are added by
//   the same second pass.
// - Ring. Boxes go through 2..4 stages (cp.async, all threads): box n+1's
//   slabs land while box n is multiplied. Per box: the dx wgmma of each
//   warpgroup in one commit group, the dW wgmma in the next; wait for all
//   but the newest (dx is done, dW of this box still runs), write dx out,
//   then a barrier: the stage of box n-1, whose dW is complete, is reloaded.
// - Weights. Packed by `pack_weights` (launched first) into wgmma's
//   core-matrix order, flipped, with each CTA's (ci tile, co group) one
//   contiguous run of 27 * CG * CI bf16: one bulk copy per CTA, on an
//   mbarrier, kept for every box (no per-launch copy in PyTorch).
// - Deterministic: no atomics; the second pass adds the splits' dW and the
//   groups' dx in a fixed order and rounds dx to bf16 once.
//
// Which (CI, CG, stages, splits) runs is chosen per shape by the wrapper
// (bcp_tpu_torch/ops/conv3d.py::dxdw_variant).
//
// f32 (a tight check of the indexing on the card, and the f32 path): CUDA
// cores over the boxes of ops/conv3d.py::halo_box, each CTA 16 input
// channels and CG = 16 or 32 output channels; warp 3*i + j owns dW taps
// (i, j, 0..2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace {

struct Geom {
  int B, X, Y, Z, C;
};

// ---------------------------------------------------------------- bf16 --
constexpr int MT = 3;          // tiles (z planes) of a box
constexpr int WGS = MT;        // warpgroup w: dx of tile w, dW taps (w, ., .)
constexpr int THREADS16 = 128 * WGS;

struct Walk {
  int nbx, nby, nbz;  // boxes of TX x TY x MT voxels along each axis
  int nboxes;
  int stages;         // ring depth, 2..MAX_STAGES
  int splits;         // CTAs that share the boxes of one (ci tile, group)
  long long n_dx;     // B*X*Y*Z*C: one dx partial's stride
};

template <int CI, int CG>
struct DxdwShape {
  using E = DwEngine<CI, CG, MT>;
  static constexpr int XBYTES = E::XSlab::BYTES;
  static constexpr int STAGE = XBYTES + E::DySlab::BYTES;
  static constexpr int WBYTES = TAPS * CG * CI * 2;  // a CTA's weights
  static int smem(int stages) { return BAR_BYTES + WBYTES + stages * STAGE; }
};

template <int CI, int CG, int MINB>
__global__ void __launch_bounds__(THREADS16, MINB)
    dxdw_bf16_kernel(const __nv_bfloat16* __restrict__ xin,
                     const __nv_bfloat16* __restrict__ dy,
                     const __nv_bfloat16* __restrict__ wpk,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ dx_ws, float* __restrict__ dw,
                     Geom g, Walk wk) {
  using S = DxdwShape<CI, CG>;
  using E = typename S::E;
  using XS = typename E::XSlab;
  using DS = typename E::DySlab;
  constexpr int GX = CI / 8, GD = CG / 8;
  constexpr int NCH = CG / 16;  // dx's k steps per tap
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wgid = tid >> 7;
  const int t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int split = blockIdx.x;
  const int tiles = g.C / CI;
  const int ci_tile = blockIdx.y % tiles, grp = blockIdx.y / tiles;
  const int ci0 = ci_tile * CI, co0 = grp * CG;
  const bool one_group = g.C == CG;
  const uint32_t bar = smem_u32(smem);
  const uint32_t wsm = bar + BAR_BYTES;
  const uint32_t ring0 = wsm + S::WBYTES;
  const int items =
      split < wk.nboxes ? (wk.nboxes - split + wk.splits - 1) / wk.splits : 0;

  auto origin = [&](int box, int& b, int& x0, int& y0, int& z0) {
    z0 = (box % wk.nbz) * MT;
    box /= wk.nbz;
    y0 = (box % wk.nby) * TY;
    box /= wk.nby;
    x0 = (box % wk.nbx) * TX;
    b = box / wk.nbx;
  };

  // start the copies of item `it` (box split + it * splits) into its stage:
  // entries in the order of memory (group, then z, y, x), zero outside
  auto load_item = [&](int it) {
    const uint32_t st = ring0 + (it % wk.stages) * S::STAGE;
    int b, x0, y0, z0;
    origin(split + it * wk.splits, b, x0, y0, z0);
    const long long vol = (long long)b * g.X * g.Y * g.Z;
    for (int v = tid; v < DS::VECS; v += THREADS16) {
      const int q = v % GD, r = v / GD;
      const int hz = r % (MT + 2), hy = (r / (MT + 2)) % HY,
                hx = r / ((MT + 2) * HY);
      const int sx = x0 + hx - 1, sy = y0 + hy - 1, sz = z0 + hz - 1;
      const bool ok = (unsigned)sx < (unsigned)g.X &&
                      (unsigned)sy < (unsigned)g.Y &&
                      (unsigned)sz < (unsigned)g.Z;
      const long long off =
          ok ? (vol + ((long long)sx * g.Y + sy) * g.Z + sz) * g.C + co0 +
                   q * 8
             : 0;
      cp_async16(st + S::XBYTES + DS::at(hx, hy, hz, q), dy + off,
                 ok ? 16 : 0);
    }
    for (int v = tid; v < XS::VECS; v += THREADS16) {
      const int q = v % GX, r = v / GX;
      const int hz = r % (MT + 3), hy = (r / (MT + 3)) % HY,
                hx = r / ((MT + 3) * HY);
      const int sx = x0 + hx - 1, sy = y0 + hy - 1, sz = z0 + hz - 1;
      const bool ok = hz < MT + 2 && (unsigned)sx < (unsigned)g.X &&
                      (unsigned)sy < (unsigned)g.Y &&
                      (unsigned)sz < (unsigned)g.Z;
      const long long off =
          ok ? (vol + ((long long)sx * g.Y + sy) * g.Z + sz) * g.C + ci0 +
                   q * 8
             : 0;
      cp_async16(st + XS::at(hx, hy, hz, q), xin + off, ok ? 16 : 0);
    }
  };

  // the sums: the first product of each replaces what they hold (no
  // zeroing by other instructions, which would serialise the wgmma)
  float acc[3][E::PASSES][E::NR];
  float dacc[CI / 2];

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // this CTA's (ci tile, co group) of the packed weights: one run
    mbar_expect_tx(bar, S::WBYTES);
    bulk_copy(wsm,
              wpk + ((long long)ci_tile * (g.C / KC) + grp * NCH) *
                        (TAPS * KC * CI),
              S::WBYTES, bar);
  }
  for (int s = 0; s < wk.stages - 1; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }

  for (int it = 0; it < items; ++it) {
    if (wk.stages == 2)
      cp_async_wait<0>();
    else if (wk.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<2>();
    fence_async_shared();
    __syncthreads();  // every thread's copies of item `it` have landed
    if (it == 0) mbar_wait(bar, 0);

    const uint32_t xs = ring0 + (it % wk.stages) * S::STAGE;
    const uint32_t dys = xs + S::XBYTES;
    wgmma_fence();
    // dx of tile wgid: tap (a, b, c) of its voxel (vx, vy) is dy halo voxel
    // (vx + a, vy + b, wgid + c)
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint64_t a = kmajor_desc(
            dys + DS::at(tap / 9, (tap / 3) % 3, wgid + tap % 3, 2 * c),
            SLAB_PLANE, HY * 16);
        const uint64_t b =
            kmajor_desc(wsm + (c * TAPS + tap) * 2 * CI * 16, CI * 16, 128);
        Wgmma<CI>::run(dacc, a, b, (tap | c) != 0 ? 1 : 0);
      }
    wgmma_commit();
    E::run(acc, xs, dys, wgid, it != 0);
    wgmma_commit();
    wgmma_wait<1>();  // dx of this box is done; its dW may still run

    // dx out: each lane holds rows lane/4 and lane/4 + 8 of its warp's 16,
    // two neighbouring columns of every 8; row r is voxel (r / 8, r % 8)
    int b, x0, y0, z0;
    origin(split + it * wk.splits, b, x0, y0, z0);
    const int oz = z0 + wgid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      const int ox = x0 + (r >> 3), oy = y0 + (r & 7);
      if (ox >= g.X || oy >= g.Y || oz >= g.Z) continue;
      const long long off =
          ((((long long)b * g.X + ox) * g.Y + oy) * g.Z + oz) * g.C + ci0 +
          (lane & 3) * 2;
      if (one_group) {
#pragma unroll
        for (int j = 0; j < CI / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dx + off + j * 8) =
              __floats2bfloat162_rn(dacc[4 * j + 2 * h],
                                    dacc[4 * j + 2 * h + 1]);
      } else {
        float* dst = dx_ws + grp * wk.n_dx + off;
#pragma unroll
        for (int j = 0; j < CI / 8; ++j)
          *reinterpret_cast<float2*>(dst + j * 8) =
              make_float2(dacc[4 * j + 2 * h], dacc[4 * j + 2 * h + 1]);
      }
    }
    // every warpgroup is past its wait: the wgmma of box it-1 are complete,
    // and its stage takes box it + stages - 1
    __syncthreads();
    if (it + wk.stages - 1 < items) load_item(it + wk.stages - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // dW out: acc[j][p] row r is tap (wgid, j, ZT*p + r / CI), channel
  // ci0 + r % CI; columns co0 + 8*n + 2*(lane % 4) + 0..1 (zeros from a
  // split that had no box)
  float* dst = dw + (long long)split * TAPS * g.C * g.C;
  const bool any = items > 0;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int p = 0; p < E::PASSES; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + h * 8;
        const int k = E::ZT * p + r / CI;
        if (k > 2) continue;
        const int tap = 9 * wgid + 3 * j + k;
        float* row = dst + ((long long)tap * g.C + ci0 + r % CI) * g.C + co0 +
                     (lane & 3) * 2;
#pragma unroll
        for (int n = 0; n < CG / 8; ++n)
          *reinterpret_cast<float2*>(row + n * 8) =
              make_float2(any ? acc[j][p][4 * n + 2 * h] : 0.0f,
                          any ? acc[j][p][4 * n + 2 * h + 1] : 0.0f);
      }
}

// The weights in the order dx's wgmma reads them, flipped, a CTA's share in
// one run:
//     wpk[ci tile][chunk][tap][half][n][e]
//         = w[co = 16*chunk + 8*half + e][ci = ci_tile*CI + n][26 - tap]
// for w (C, C, 27) contiguous: K-major core matrices (8 ci rows of 8 co).
// One thread per 16-byte vector.
__global__ void __launch_bounds__(256)
    pack_weights(const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ wpk, int C, int CI) {
  const long long v = (long long)blockIdx.x * 256 + threadIdx.x;
  if (v >= (long long)TAPS * C * C / 8) return;
  const int n = (int)(v % CI);
  long long r = v / CI;
  const int half = (int)(r % 2);
  r /= 2;
  const int tap = (int)(r % TAPS);
  r /= TAPS;
  const int chunk = (int)(r % (C / KC));
  const int ci_tile = (int)(r / (C / KC));
  const int ci = ci_tile * CI + n;
  __align__(16) __nv_bfloat16 e8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    e8[e] = w[((long long)(chunk * KC + half * 8 + e) * C + ci) * TAPS +
              TAPS - 1 - tap];
  *reinterpret_cast<uint4*>(wpk + v * 8) = *reinterpret_cast<const uint4*>(e8);
}

// ----------------------------------------------------------------- f32 --
constexpr int WARPS = 9;        // warp 3*i + j owns dW taps (i, j, 0..2)
constexpr int THREADS = WARPS * 32;
constexpr int BOX = 128;        // most output voxels of one box
constexpr int MAX_HALO = 640;   // most halo voxels of one box

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

// What the f32 kernel is handed. dx goes to `dx` when the grid has one
// channel group, else as f32 partial sums to `dx_ws + group * dx_stride`;
// dW goes to `dw + split * dw_stride` (the launcher points `dw` at the
// result when splits == 1, else at the workspace).
struct Args {
  const void* x;
  const void* dy;
  const void* w;
  void* dx;
  float* dx_ws;
  float* dw;
  Geom g;
  Box bx;
  int n_boxes, splits;
  long long dw_stride, dx_stride;
};

// Same walk on CUDA cores. dW: lane = (co half, ci), each thread a
// 3 x (CG/2) register tile. dx: thread = (box voxel, ci half), 8 sums.
template <int CG>
__global__ void __launch_bounds__(THREADS) dxdw_f32_kernel(Args a) {
  const auto* xin = static_cast<const float*>(a.x);
  const auto* dy = static_cast<const float*>(a.dy);
  const auto* w = static_cast<const float*>(a.w);
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
  // this CTA's weights, flipped and io-transposed from w (C, C, 27):
  // Ws[tap][co][ci] = w[co][ci][26 - tap]
  for (int idx = tid; idx < 27 * CG * KC; idx += THREADS) {
    const int row = idx / KC, ci = idx % KC;
    const int tap = row / CG, co = row % CG;
    Ws[idx] = w[((long long)(n0 + co) * g.C + ci0 + ci) * 27 + 26 - tap];
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

// The fixed-order second pass, when sums cross CTAs.
template <typename T>
int reduce(void* dx_ws, void* dw_ws, void* dw, void* dx, const Geom& g,
           int groups, int splits, cudaStream_t s) {
  if (splits == 1 && groups == 1) return 0;
  const long long n_dw = 27LL * g.C * g.C;
  const long long n_dx = (long long)g.B * g.X * g.Y * g.Z * g.C;
  const long long total = (splits > 1 ? n_dw : 0) + (groups > 1 ? n_dx : 0);
  const int blocks = (int)((total + 255) / 256 < 2048 ? (total + 255) / 256
                                                       : 2048);
  dxdw_reduce_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(dw_ws), static_cast<float*>(dw), n_dw, splits,
      static_cast<const float*>(dx_ws), static_cast<T*>(dx), n_dx, groups);
  return (int)cudaGetLastError();
}

template <int CI, int CG, int MINB>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                const __nv_bfloat16* wpk, __nv_bfloat16* dx, float* dx_ws,
                float* dw, const Geom& g, const Walk& wk, cudaStream_t s) {
  auto kernel = dxdw_bf16_kernel<CI, CG, MINB>;
  const int smem = DxdwShape<CI, CG>::smem(wk.stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)wk.splits, (unsigned)((g.C / CI) * (g.C / CG)));
  kernel<<<grid, THREADS16, (size_t)smem, s>>>(x, dy, wpk, dx, dx_ws, dw, g,
                                                wk);
  return (int)cudaGetLastError();
}

// Launch the f32 kernel and, when sums cross CTAs, the second pass.
// `most` is the kernel's largest dynamic shared memory; above 48 KB the
// kernel opts in once (`opted_in`).
int launch_f32(void (*kernel)(Args), size_t smem, size_t most,
               bool& opted_in, const void* x, const void* dy, const void* w,
               void* dx, void* dx_ws, void* dw_ws, void* dw, const Geom& g,
               const Box& bx, int cg, int splits, cudaStream_t s) {
  if (!opted_in) {
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in = true;
  }
  const int groups = g.C / cg;
  Args a;
  a.x = x;
  a.dy = dy;
  a.w = w;
  a.dx = dx;
  a.dx_ws = static_cast<float*>(dx_ws);
  a.dw = static_cast<float*>(splits > 1 ? dw_ws : dw);
  a.g = g;
  a.bx = bx;
  a.n_boxes = g.B * bx.nbx * bx.nby * bx.nbz;
  a.splits = splits;
  a.dw_stride = 27LL * g.C * g.C;
  a.dx_stride = (long long)g.B * g.X * g.Y * g.Z * g.C;
  const dim3 grid((unsigned)(g.C / KC), (unsigned)groups, (unsigned)splits);
  kernel<<<grid, THREADS, smem, s>>>(a);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce<float>(dx_ws, dw_ws, dw, dx, g, groups, splits, s);
}

}  // namespace

// The bf16 launch, as the wrapper fills it (`ops/conv3d.py::_DxdwArgs`):
// the shape; ci_tile (CI), co_group (CG): (16, 16), (32, 32) or (16, 64),
// each dividing C; stages: ring depth, 2..4;
// splits: CTAs sharing the boxes of one (ci tile, co group).
struct DxdwArgs {
  int B, X, Y, Z, C, ci_tile, co_group, stages, splits;
};

// w (C, C, 27) bf16 contiguous -> wpk (27*C*C bf16) in the order
// dxdw_bf16_kernel reads it for a ci tile of `ci_tile` channels.
extern "C" int conv3x3x3_dxdw_pack(const void* w, void* wpk, int C,
                                   int ci_tile, void* stream) {
  if (C % KC != 0 || ci_tile < 8 || C % ci_tile != 0)
    return (int)cudaErrorInvalidValue;
  const long long vecs = 27LL * C * C / 8;
  pack_weights<<<(unsigned)((vecs + 255) / 256), 256, 0,
                 (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wpk),
      C, ci_tile);
  return (int)cudaGetLastError();
}

// x, dy (B, X, Y, Z, C) NDHWC bf16; w (C, C, 27) bf16 contiguous, the
// conv's weights; wpk: workspace of 27*C*C bf16 for them packed; dx
// (B, X, Y, Z, C) bf16; dw (27, C, C) f32 [tap][ci][co]. dx_ws: (C / CG) *
// B*X*Y*Z*C f32 when C > CG; dw_ws: splits * 27*C*C f32 when splits > 1
// (each unused otherwise).
extern "C" int conv3x3x3_dxdw_bf16(const void* x, const void* dy,
                                   const void* w, void* wpk, void* dx,
                                   void* dx_ws, void* dw_ws, void* dw,
                                   const DxdwArgs* a, void* stream) {
  const int C = a->C, ci = a->ci_tile, cg = a->co_group;
  if (C % KC != 0 || C % ci != 0 || C % cg != 0 || a->stages < 2 ||
      a->stages > MAX_STAGES || a->splits < 1 ||
      (C > cg && dx_ws == nullptr) || (a->splits > 1 && dw_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geom g{a->B, a->X, a->Y, a->Z, C};
  Walk wk{};
  wk.nbx = ceil_div(g.X, TX), wk.nby = ceil_div(g.Y, TY);
  wk.nbz = ceil_div(g.Z, MT);
  wk.nboxes = g.B * wk.nbx * wk.nby * wk.nbz;
  wk.stages = a->stages, wk.splits = a->splits;
  wk.n_dx = (long long)g.B * g.X * g.Y * g.Z * C;
  cudaStream_t s = (cudaStream_t)stream;
  int e = conv3x3x3_dxdw_pack(w, wpk, C, ci, stream);
  if (e != 0) return e;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* db = static_cast<const __nv_bfloat16*>(dy);
  const auto* wb = static_cast<const __nv_bfloat16*>(wpk);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  auto* dxw = static_cast<float*>(dx_ws);
  auto* dwo = static_cast<float*>(a->splits > 1 ? dw_ws : dw);
  switch (ci * 100 + cg) {
    case 1616:
      e = launch_bf16<16, 16, 2>(xb, db, wb, dxb, dxw, dwo, g, wk, s);
      break;
    case 3232:
      e = launch_bf16<32, 32, 1>(xb, db, wb, dxb, dxw, dwo, g, wk, s);
      break;
    case 1664:
      e = launch_bf16<16, 64, 1>(xb, db, wb, dxb, dxw, dwo, g, wk, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return reduce<__nv_bfloat16>(dx_ws, dw_ws, dw, dx, g, C / cg, a->splits, s);
}

// The same in f32 on CUDA cores over boxes (tx, ty, tz) of
// ops/conv3d.py::halo_box, cg (16 or 32) output channels per CTA; w (C, C,
// 27) f32 contiguous.
extern "C" int conv3x3x3_dxdw_f32(const void* x, const void* dy,
                                  const void* w, void* dx, void* dx_ws,
                                  void* dw_ws, void* dw, int B, int X, int Y,
                                  int Z, int C, int tx, int ty, int tz,
                                  int cg, int splits, void* stream) {
  if (C % KC != 0 || (cg != 16 && cg != 32) || C % cg != 0 || tx < 1 ||
      ty < 1 || tz < 1 || tx * ty * tz > BOX ||
      (tx + 2) * (ty + 2) * (tz + 2) > MAX_HALO || splits < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, C};
  const Box bx{tx, ty, tz, ceil_div(X, tx), ceil_div(Y, ty), ceil_div(Z, tz)};
  const int halo = (tx + 2) * (ty + 2) * (tz + 2);
  auto smem = [](int h, int n) {
    return (size_t)(h * (n + 4) + h * KC + 27 * n * KC) * sizeof(float);
  };
  cudaStream_t s = (cudaStream_t)stream;
  static bool opted[2] = {false, false};
  if (cg == 32)
    return launch_f32(dxdw_f32_kernel<32>, smem(halo, 32),
                      smem(MAX_HALO, 32), opted[1], x, dy, w, dx, dx_ws,
                      dw_ws, dw, g, bx, cg, splits, s);
  return launch_f32(dxdw_f32_kernel<16>, smem(halo, 16), smem(MAX_HALO, 16),
                    opted[0], x, dy, w, dx, dx_ws, dw_ws, dw, g, bx, cg,
                    splits, s);
}
