// Weight gradient of the 3x3x3 stride-1 zero-padded SAME convolution,
// written by hand for Hopper:
//     dW[co, ci, i, j, k] = sum over (b, x, y, z) of
//         x_pad[b, x+i, y+j, z+k, ci] * dy[b, x, y, z, co]
// accumulated in f32.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/conv3d.py::_conv3x3x3_dw_pallas
// (body `_make_dw_kernel`, fold `_fold_toeplitz_grad`). The TPU kernel sums
// every grid step into one VMEM-resident block over a sequential grid; on
// the GPU blocks run in parallel, so where the voxel reduction is split
// over CTAs a second, fixed-order pass adds the partial sums (no float
// atomics: two runs on the same input give the same bits).
//
// Layout: x is NDHWC (B, X, Y, Z, Ci), dy is NDHWC (B, X, Y, Z, Co). The
// bf16 path writes (Co, Ci, 27) f32, the layout the wrapper returns as
// (Co, Ci, 3, 3, 3), tap t = 9*i + 3*j + k; the f32 path (27, Ci, Co).
//
// Bound on the H100: bytes at 16 channels (x and dy read once, 2 * M * C
// bf16 against 2 * 27 * M * C^2 FLOP: 27 * C / 2 FLOP a byte, under the
// card's ~295 at C = 16), operations from 32 channels up. Like kernels B
// and D, what holds it below that is feeding the tensor cores from shared
// memory: every staged x voxel is read by 27 taps.
//
// bf16 (the main path), `dw_bf16_kernel<CI, CG, MT, MINB>`, on `wgmma`
// through the dW engine of kernel D (`DwEngine`, conv_common.cuh):
//
// - Work. A box is MT = 3 or 4 z planes of 8 x 8 voxels (the m64 tile of B
//   and D). A CTA of three warpgroups owns CI input channels (dW's rows), a
//   group of CG output channels (dW's columns) and every splits-th box of
//   the volumes (blockIdx.x); grid (splits, Ci/CI * Co/CG). Warpgroup i
//   owns taps (i, ., .): M = (z tap, ci), 64 / CI z taps of CI channels per
//   m64 tile (the fourth z tap's rows are computed and dropped: a quarter
//   of the math), N = CG, K = the box's voxels, 16 (two x lines) per wgmma.
// - One staging serves every tap. A ring stage holds the box's x slab (CI
//   channels, 10 x 10 halo over MT + 3 planes, the last zero) and its dy
//   centre (CG channels, 8 x 8 over MT planes, `Centre`: C has no dx half,
//   so no dy halo, 2.6x fewer dy bytes than D's slab at MT = 3), both laid
//   out [plane][8-channel group][x][y] in 16-byte entries, zero outside
//   the volume (cp.async with a source size of 0). Both are MN-major
//   (transposed) operands read by descriptor; a tap is a shift of x's
//   start address; no thread gathers anything. At MT = 4 a box stages 7 x
//   planes for 4 output planes (6 for 3 at MT = 3), and 4 divides the
//   V-Net's Z = 80, 40, 20.
// - Ring of 3 or 4 stages, all threads copying (cp.async): box n + stages
//   - 2 is copied into the stage of box n - 2 before box n's products are
//   issued, while the tensor cores still work through box n - 1's. One
//   barrier per box: box n has landed, and every warpgroup has waited for
//   the products of box n - 2 (they wait for those of n - 1 after issuing
//   n's). Non-wgmma code between a box's products made ptxas insert waits
//   (C7519) and spill, so they go out as one run.
// - The dW sums stay in registers across the CTA's boxes: 3 * PASSES *
//   CG/2 f32 a thread. At the end they go through shared memory (the ring,
//   no longer needed) into (Co, Ci, 27) order and out in 16-byte stores:
//   each output channel's CI * 27 sums are one contiguous run. Where the
//   boxes are split over CTAs, the splits of one thread-block cluster (2
//   CTAs, launch attribute) first add their tiles through distributed
//   shared memory in rank order, each CTA a share of the runs; each
//   cluster then writes one partial in that order to a workspace and
//   `dw_reduce_kernel` adds them in cluster order. Either way the wrapper
//   returns the result as it is, with no permuted copy.
// - Registers and shared memory of each instantiated (CI, CG), three
//   warpgroups (384 threads): one CTA per SM leaves 168 registers a
//   thread, two 80. Sums a thread, bytes of a ring stage (x slab + dy
//   centre) at MT = 3 and 4, and of the epilogue's tile (27 * CI * CG f32):
//       (16, 16): 24, 26592 / 32064, 27648; two CTAs per SM
//       (32, 32): 96, 53184 / 64128, 110592
//   A CTA takes the larger of its ring and its tile, at most 232448 bytes
//   (four stages of (32, 32) at MT = 3: 212736; three at MT = 4: 192384).
//   (16, 16) takes every Ci, Co; (32, 32) where 32 divides both. Other
//   tiles lost the sweep (scripts/torch_conv_variants.py --dw): (16, 32)
//   and (32, 16) were never faster than these two on the V-Net's shapes;
//   CI = 64 would drop no rows, but (64, 32)'s 144 sums a thread spilled
//   1316 bytes at 168 registers and (64, 16) runs at N = 16; CG = 64 needs
//   192 or 288 sums a thread.
//
// Which (CI, CG, stages, splits, MT, cluster) runs is chosen per shape by
// the wrapper (bcp_tpu_torch/ops/conv3d.py::dw_variant).
//
// f32 (a tight check of the indexing on the card, and the f32 path): CUDA
// cores over output boxes of the wrapper's `halo_box`, each CTA 16 input
// channels, all 27 taps and BN output channels, warp w = 3*i + j owning
// taps (i, j, 0..2); the splits' partial sums go to a workspace slice and
// `dw_reduce_kernel` adds them in split order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace {

constexpr int WARPS = 9;        // f32: warp 3*i + j owns taps (i, j, 0..2)
constexpr int THREADS = WARPS * 32;
constexpr int BOX = 128;        // f32: most output voxels of one box
constexpr int MAX_HALO = 640;   // f32: most halo voxels of one box

struct Geom {
  int B, X, Y, Z, Ci, Co;
};

// ---------------------------------------------------------------- bf16 --
constexpr int THREADS16 = 384;  // warpgroup i: taps (i, ., .)

struct Walk {
  int nbx, nby, nbz;  // boxes of TX x TY x MT voxels along each axis
  int nboxes;
  int stages;         // ring depth, 3..MAX_STAGES
  int splits;         // CTAs that share the boxes of one (ci tile, group)
  int cluster;        // of them, those of one cluster (dividing splits)
};

// every thread of the cluster's CTAs has arrived; this CTA's shared-memory
// writes before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the 16 bytes at shared address `addr` of the cluster's CTA `rank`
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

template <int CI, int CG, int MT>
struct DwShape {
  using DS = Centre<CG / 8, MT>;
  using E = DwEngine<CI, CG, MT, DS>;
  static constexpr int XBYTES = E::XSlab::BYTES;
  static constexpr int STAGE = XBYTES + DS::BYTES;
  static constexpr int TILE = TAPS * CI * CG * 4;  // the epilogue's sums
  static int smem(int stages) {
    return stages * STAGE > TILE ? stages * STAGE : TILE;
  }
};

template <int CI, int CG, int MT, int MINB>
__global__ void __launch_bounds__(THREADS16, MINB)
    dw_bf16_kernel(const __nv_bfloat16* __restrict__ xin,
                   const __nv_bfloat16* __restrict__ dy,
                   float* __restrict__ out, Geom g, Walk wk) {
  using S = DwShape<CI, CG, MT>;
  using E = typename S::E;
  using XS = typename E::XSlab;
  using DS = typename S::DS;
  constexpr int GX = CI / 8, GD = CG / 8, XP = XS::PLANES;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wgid = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int ci_tiles = g.Ci / CI;
  const int ci0 = (blockIdx.y % ci_tiles) * CI;
  const int co0 = (blockIdx.y / ci_tiles) * CG;
  const uint32_t ring0 = smem_u32(smem);
  const int items =
      split < wk.nboxes ? (wk.nboxes - split + wk.splits - 1) / wk.splits : 0;

  // start the copies of item `it` (box split + it * splits) into its stage:
  // entries in the order of memory (group, then z, y, x), zero outside
  auto load_item = [&](int it) {
    const uint32_t st = ring0 + (it % wk.stages) * S::STAGE;
    int box = split + it * wk.splits;
    const int z0 = (box % wk.nbz) * MT;
    box /= wk.nbz;
    const int y0 = (box % wk.nby) * TY;
    box /= wk.nby;
    const int x0 = (box % wk.nbx) * TX;
    const long long vol = (long long)(box / wk.nbx) * g.X * g.Y * g.Z;
    for (int v = tid; v < DS::VECS; v += THREADS16) {
      const int q = v % GD, r = v / GD;
      const int t = r % MT, vy = (r / MT) % TY, vx = r / (MT * TY);
      const int sx = x0 + vx, sy = y0 + vy, sz = z0 + t;
      const bool ok = sx < g.X && sy < g.Y && sz < g.Z;
      const long long off =
          ok ? (vol + ((long long)sx * g.Y + sy) * g.Z + sz) * g.Co + co0 +
                   q * 8
             : 0;
      cp_async16(st + S::XBYTES + DS::at(vx, vy, t, q), dy + off,
                 ok ? 16 : 0);
    }
    for (int v = tid; v < XS::VECS; v += THREADS16) {
      const int q = v % GX, r = v / GX;
      const int hz = r % XP, hy = (r / XP) % HY, hx = r / (XP * HY);
      const int sx = x0 + hx - 1, sy = y0 + hy - 1, sz = z0 + hz - 1;
      const bool ok = hz < MT + 2 && (unsigned)sx < (unsigned)g.X &&
                      (unsigned)sy < (unsigned)g.Y &&
                      (unsigned)sz < (unsigned)g.Z;
      const long long off =
          ok ? (vol + ((long long)sx * g.Y + sy) * g.Z + sz) * g.Ci + ci0 +
                   q * 8
             : 0;
      cp_async16(st + XS::at(hx, hy, hz, q), xin + off, ok ? 16 : 0);
    }
  };

  // the sums: the first product of each replaces what they hold (no
  // zeroing by other instructions, which would serialise the wgmma)
  float acc[3][E::PASSES][E::NR];

  // items ahead of the one multiplied: stages - 2 in flight, so that the
  // stage loaded at item `it` held item it - 2, whose products every
  // warpgroup has waited for before the barrier of `it`
  const int ahead = wk.stages - 2;
  for (int s = 0; s < ahead; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }
  for (int it = 0; it < items; ++it) {
    if (wk.stages == 3)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();  // item `it` has landed, item it - 2 is multiplied
    // the copies of item it + ahead go out first, while the tensor cores
    // work through the products of item it - 1
    if (it + ahead < items) load_item(it + ahead);
    cp_async_commit();

    const uint32_t xs = ring0 + (it % wk.stages) * S::STAGE;
    wgmma_fence();
    E::run(acc, xs, xs + S::XBYTES, wgid, it != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the products of item it - 1 are done
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the tile of sums

  // acc[j][p] row r is tap (wgid, j, ZT*p + r / CI), channel r % CI;
  // columns 8*n + 2*(lane % 4) + 0..1 (zeros from a split that had no
  // box); into tile[co][ci][tap]
  float* tile = reinterpret_cast<float*>(smem);
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
        float* col = tile + (r % CI) * TAPS + 9 * wgid + 3 * j + k;
#pragma unroll
        for (int n = 0; n < CG / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            col[(8 * n + (lane & 3) * 2 + e) * CI * TAPS] =
                any ? acc[j][p][4 * n + 2 * h + e] : 0.0f;
      }
  __syncthreads();
  // each output channel's CI * 27 sums are one run of (Co, Ci, 27); a
  // cluster's CTAs add their tiles in rank order, each CTA a share of the
  // runs, and write one partial per cluster
  float* dst = out + (long long)(split / wk.cluster) * TAPS * g.Ci * g.Co;
  constexpr int RUN = CI * TAPS / 4;  // 16-byte vectors of one run
  constexpr int VECS = CG * RUN;
  auto put = [&](int v, float4 val) {
    const int co = v / RUN, u = v % RUN;
    *reinterpret_cast<float4*>(dst + ((long long)(co0 + co) * g.Ci + ci0) *
                                         TAPS + u * 4) = val;
  };
  if (wk.cluster == 1) {
    for (int v = tid; v < VECS; v += THREADS16)
      put(v, reinterpret_cast<const float4*>(tile)[v]);
    return;
  }
  cluster_sync();  // every tile of the cluster is complete
  const uint32_t rank = cluster_rank(), base = smem_u32(tile);
  const int lo = (int)rank * VECS / wk.cluster;
  const int hi = ((int)rank + 1) * VECS / wk.cluster;
  for (int v = lo + tid; v < hi; v += THREADS16) {
    float4 sum = ld_cluster(base + v * 16, 0);
    for (int q = 1; q < wk.cluster; ++q) {
      const float4 w = ld_cluster(base + v * 16, q);
      sum.x += w.x, sum.y += w.y, sum.z += w.z, sum.w += w.w;
    }
    put(v, sum);
  }
  cluster_sync();  // no CTA leaves while another reads its tile
}

// ----------------------------------------------------------------- f32 --
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

// A CTA (16 input channels, BN output channels, one split) walks boxes
// split, split + splits, ...: per box it stages the x halo and the dy rows
// in shared memory, then lane = (co half, ci) of warp 3*i + j adds to a
// 3 x (BN/2) register tile of taps (i, j, 0..2).
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

// The fixed-order second pass, when splits > 1.
int reduce(const float* ws, float* out, long long n, int splits,
           cudaStream_t s) {
  if (splits == 1) return 0;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}

template <int CI, int CG, int MT, int MINB>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* dst,
                const Geom& g, const Walk& wk, cudaStream_t s) {
  auto kernel = dw_bf16_kernel<CI, CG, MT, MINB>;
  const int smem = DwShape<CI, CG, MT>::smem(wk.stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)wk.splits,
                     (unsigned)((g.Ci / CI) * (g.Co / CG)));
  cfg.blockDim = dim3(THREADS16);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)wk.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = wk.cluster > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x, dy, dst, g, wk);
}

using DwKernel = void (*)(const void*, const void*, float*, Geom, Box, int,
                         int, long long);

// Launch the f32 kernel into `ws` (splits > 1) or straight into `out`,
// then the fixed-order reduce. `most` is the kernel's largest dynamic
// shared memory; above 48 KB the kernel opts in once (`opted_in`).
int launch_f32(DwKernel kernel, size_t smem, size_t most, bool& opted_in,
               const void* x, const void* dy, float* ws, float* out,
               const Geom& g, const Box& bx, int bn, int splits,
               cudaStream_t s) {
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
  kernel<<<grid, THREADS, smem, s>>>(x, dy, splits > 1 ? ws : out, g, bx,
                                     n_boxes, splits, n);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce(ws, out, n, splits, s);
}

}  // namespace

// The bf16 launch, as the wrapper fills it (`ops/conv3d.py::_DwArgs`): the
// shape; (ci_tile, co_group) = (CI, CG): (16, 16), or (32, 32) where 32
// divides Ci and Co; stages: ring depth, 3 or 4; splits: CTAs sharing the
// boxes of one (ci tile, co group); tiles: z planes of a box, 3 or 4;
// cluster: of the splits, those of one thread-block cluster, 1..8,
// dividing splits.
struct DwArgs {
  int B, X, Y, Z, Ci, Co, ci_tile, co_group, stages, splits, tiles, cluster;
};

// x (B, X, Y, Z, Ci), dy (B, X, Y, Z, Co) bf16 NDHWC; out (Co, Ci, 27) f32;
// ws: splits / cluster * 27 * Ci * Co f32 when splits > cluster (else
// unused).
extern "C" int conv3x3x3_dw_bf16(const void* x, const void* dy, void* ws,
                                 void* out, const DwArgs* a, void* stream) {
  const int ci = a->ci_tile, cg = a->co_group;
  if (a->Ci % KC != 0 || a->Co % KC != 0 || ci < KC || a->Ci % ci != 0 ||
      a->Co % cg != 0 || a->stages < 3 || a->stages > MAX_STAGES ||
      a->splits < 1 || a->cluster < 1 || a->cluster > 8 ||
      a->splits % a->cluster != 0)
    return (int)cudaErrorInvalidValue;
  const int parts = a->splits / a->cluster;  // partial sums to add
  if (parts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Geom g{a->B, a->X, a->Y, a->Z, a->Ci, a->Co};
  Walk wk{};
  wk.nbx = ceil_div(g.X, TX), wk.nby = ceil_div(g.Y, TY);
  wk.nbz = ceil_div(g.Z, a->tiles);
  wk.nboxes = g.B * wk.nbx * wk.nby * wk.nbz;
  wk.stages = a->stages, wk.splits = a->splits, wk.cluster = a->cluster;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* db = static_cast<const __nv_bfloat16*>(dy);
  float* dst = static_cast<float*>(parts > 1 ? ws : out);
  int e;
  switch (a->tiles * 10000 + ci * 100 + cg) {
    case 31616:
      e = launch_bf16<16, 16, 3, 2>(xb, db, dst, g, wk, s);
      break;
    case 33232:
      e = launch_bf16<32, 32, 3, 1>(xb, db, dst, g, wk, s);
      break;
    case 41616:
      e = launch_bf16<16, 16, 4, 2>(xb, db, dst, g, wk, s);
      break;
    case 43232:
      e = launch_bf16<32, 32, 4, 1>(xb, db, dst, g, wk, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return reduce(static_cast<const float*>(ws), static_cast<float*>(out),
                27LL * g.Ci * g.Co, parts, s);
}

// The same in f32 on CUDA cores: out (27, Ci, Co); (tx, ty, tz) is the
// output box, bn (16 or 32) the output channels of one CTA.
extern "C" int conv3x3x3_dw_f32(const void* x, const void* dy, void* ws,
                                void* out, int B, int X, int Y, int Z, int Ci,
                                int Co, int tx, int ty, int tz, int bn,
                                int splits, void* stream) {
  if (Ci % KC != 0 || (bn != 16 && bn != 32) || Co % bn != 0 || tx < 1 ||
      ty < 1 || tz < 1 || tx * ty * tz > BOX ||
      (tx + 2) * (ty + 2) * (tz + 2) > MAX_HALO || splits < 1)
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
    return launch_f32(dw_f32_kernel<32>, smem(halo, 32), smem(MAX_HALO, 32),
                      opted[1], x, dy, w, o, g, bx, bn, splits, s);
  return launch_f32(dw_f32_kernel<16>, smem(halo, 16), smem(MAX_HALO, 16),
                    opted[0], x, dy, w, o, g, bx, bn, splits, s);
}
