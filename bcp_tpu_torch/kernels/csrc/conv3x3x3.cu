// 3x3x3 stride-1 zero-padded SAME convolution (forward, no bias), written
// by hand for Hopper.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/conv3d.py::_pallas_call_merged
// (body `_make_kernel`, entry `conv3x3x3_same`). The TPU kernel's z
// block-Toeplitz packing and its 128-lane / Y % 8 / 128 % C rules exist for
// the TPU's (8, 128) tiling; this kernel is written from the math instead.
//
// Layout: x is NDHWC (a torch channels_last_3d tensor of logical shape
// (B, Ci, X, Y, Z)), y is NDHWC. Implicit GEMM:
//     M = B*X*Y*Z output voxels, N = Co, K = 27*Ci
//     A[m, (t, ci)] = x[b, x+i-1, y+j-1, z+k-1, ci]   (0 outside the volume)
//     B[(t, ci), co] = w[t, ci, co],  tap t = 9*i + 3*j + k
// A is never materialised.
//
// Bound on the H100: operations from Ci = Co = 32 up (2*M*27*Ci*Co FLOP
// against (Ci+Co)*2 bytes per voxel in bf16 is 27*Ci*Co/(Ci+Co) FLOP/byte:
// 216 at 16 channels, below the card's ~295, and 432 at 32); bytes at
// Ci = Co = 16. What holds an implicit GEMM of this shape below that bound
// is feeding the tensor cores, not the tensor cores: every input voxel is an
// A row of 27 taps, so A is fetched from shared memory 27 times (2 KB for
// each m64 k16 step, against N/2 cycles of math: at N <= 64 the 128 bytes a
// cycle of shared memory bound the kernel, not the math); the weights
// (27*Ci*Co*2 bytes, up to 3.5 MB) are as large as a CTA's share of the
// input and come from L2; and the deep stages are small volumes (8 x 7x7x5
// voxels) with a long K (6912).
//
// bf16 (the main path), `conv3x3x3_bf16_kernel<BN, WG, MT>`:
//
// - Work. An m64 tile is 8 x 8 voxels of one z plane. A warpgroup owns a
//   box of MT such tiles (MT = 2 or 4 planes above each other) of one batch
//   element and BN output channels. A CTA has WG warpgroups (2 or 4) that
//   take neighbouring boxes and share one weight tile. The CTA is
//   persistent: it walks groups of boxes blockIdx.x, blockIdx.x + gridDim.x,
//   ... for its (co tile, K split).
// - Math. wgmma.mma_async m64nBNk16, bf16 in, f32 out, both operands read
//   from shared memory by descriptor, so no thread gathers anything. The
//   halo of a box (10 x 10 x (MT+2) voxels of 16 channels) is laid out as
//   [k half][z][x][y] entries of 16 bytes: 8 voxels along y are the 128
//   contiguous bytes of a core matrix, the 8 lines along x of a tile lie a
//   constant 160 bytes apart, and tap (dx, dy, dz) of tile i is the same
//   descriptor with its start address moved to halo voxel (dx, dy, i + dz).
//   The weights are packed (`pack_weights`, launched with the conv) as
//   [chunk][co tile][tap][k half][co][8 ci]: K-major core matrices too, and
//   a CTA's (chunk, co tile) one contiguous run. The 27 * MT wgmma of an
//   item go out back to back in one commit group. One warpgroup alone gets
//   a small-N wgmma through every 60-90 cycles (measured: the operand fetch
//   of one warpgroup is not pipelined); four resident warpgroups per SM
//   reach the shared-memory bound (20, 24, 32 cycles at N = 16, 32, 64), so
//   the variants aim at four.
// - Ring. The unit of loading is an item = (box group, chunk of 16 input
//   channels): each warpgroup's halo, zero outside the volume (cp.async with
//   a source size of 0), and, where the weights are streamed, the chunk's
//   27*16*BN weights (one bulk copy, cp.async.bulk, counted on the stage's
//   mbarrier). Items go through a ring of 2..4 stages: items n+1..n+S-1 are
//   in flight while item n is multiplied, across chunk and box boundaries
//   alike. The wgmma of item n are started before the stage of item n-1 is
//   given back (wgmma.wait_group 1, then a barrier), so the tensor cores
//   keep work while the next copies are started.
// - Weights once per CTA. Where 27*Ci*BN*2 bytes (of this CTA's K split) fit
//   beside the ring, the CTA loads its weight slab once and keeps it for
//   every box it walks (`persist_w`); the ring then carries halos only and
//   the warpgroups of a CTA run independently (barriers of 128 threads).
//   Otherwise a stage's weight chunk is shared by the CTA's WG boxes: up to
//   1024 voxels for each load from L2.
// - Small volumes get parallelism from K, not from narrow N tiles: the Ci
//   chunks are split over blockIdx.y, each split writes f32 partial sums to
//   a workspace, and `reduce_splits` adds them in split order and rounds
//   once to bf16 (no atomics: two runs give the same bits).
// - Epilogue. A warp stages its 16 rows of a tile in its quarter of the
//   halo just multiplied and writes them out as whole 16-byte vectors.
//
// Which (MT, BN, WG, stages, persist_w, K split, grid) runs is chosen per
// shape by the wrapper (bcp_tpu_torch/ops/conv3d.py::conv_variant).
//
// f32 (a tight check of the indexing on the card, and the f32 path):
// CUDA-core FMAs, each tap's shifted rows gathered straight from L1/L2,
// weights as (27, Ci, Co).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace {

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
// (the tile, its halo, the copy and wgmma helpers: conv_common.cuh)
struct Plan {
  int nbx, nby, nbz;  // boxes along each axis
  int nboxes;         // B * nbx * nby * nbz
  int stages;         // ring depth, 2..MAX_STAGES
  int persist_w;      // weights staged once per CTA, not per item
  int ksplit;         // splits of the Ci chunks over blockIdx.y
  int flip;           // read the weights of tap 26 - t at tap t (dx)
};

// Origin (b, x0, y0, z0) of box number `box` = ((b*nbx + ix)*nby + iy)*nbz
// + iz, of TX x TY x mt voxels.
__device__ __forceinline__ void box_origin(const Plan& p, int mt, int box,
                                           int& b, int& x0, int& y0,
                                           int& z0) {
  z0 = (box % p.nbz) * mt;
  box /= p.nbz;
  y0 = (box % p.nby) * TY;
  box /= p.nby;
  x0 = (box % p.nbx) * TX;
  b = box / p.nbx;
}

template <int BN, int WG, int MT>
__global__ void __launch_bounds__(128 * WG,
                                  WG == 2 && BN * MT <= 64 ? 2 : 1)
    conv3x3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xin,
                          const __nv_bfloat16* __restrict__ wpk,
                          __nv_bfloat16* __restrict__ yout,
                          float* __restrict__ partial, Geom g, Plan p) {
  using H = Halo<MT>;
  constexpr int WVECS = TAPS * 2 * BN;  // 16-byte vectors of a weight chunk
  constexpr int WBYTES = WVECS * 16;
  constexpr int NR = BN / 2;  // accumulator registers of one m64 tile
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wgid = tid >> 7;  // warpgroup = which box of the group
  const int t = tid & 127;
  const int lane = tid & 31;
  const int warp = t >> 5;  // warp of the warpgroup: rows 16*warp ..
  const int ncm = g.Ci / KC / p.ksplit;  // chunks of this CTA's K split
  const int split = blockIdx.y % p.ksplit;
  const int n0 = (blockIdx.y / p.ksplit) * BN;
  const int c0 = split * ncm;
  const int w_in_stage = p.persist_w ? 0 : WBYTES;
  const int stage_bytes = WG * H::BYTES + w_in_stage;
  // mbarriers first: bars + 8*s for the weights of ring stage s, bars +
  // 8*MAX_STAGES for the persistent slab
  const uint32_t bars = smem_u32(smem);
  const uint32_t smem0 = bars + BAR_BYTES;
  const uint32_t ring0 = smem0 + (p.persist_w ? ncm * WBYTES : 0);
  // the epilogue's 16 staging rows of each warp lie in its quarter of the
  // warpgroup's halo of the stage just multiplied
  constexpr int SROW = BN * 2 + 16;  // padded: a warp's pairs hit 32 banks
  constexpr int SWARP = (H::BYTES / 4) & ~15;
  static_assert(SWARP >= 16 * SROW, "staging rows do not fit in the halo");

  // the groups of WG boxes this CTA walks, and its items
  const int ngroups = (p.nboxes + WG - 1) / WG;
  const int mine =
      (int)blockIdx.x < ngroups
          ? (ngroups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int items = mine * ncm;

  // this thread's halo vectors: vector t + 128*k is half (idx & 1) of halo
  // voxel idx >> 1, z fastest as in x; its coordinates in the halo, packed,
  // or -1
  int hvec[H::PER_THREAD];
#pragma unroll
  for (int k = 0; k < H::PER_THREAD; ++k) {
    const int idx = t + 128 * k;
    const int hv = idx >> 1;
    hvec[k] = idx < H::VECS ? (hv / (H::HZ * HY)) | (((hv / H::HZ) % HY) << 8) |
                                  ((hv % H::HZ) << 16)
                            : -1;
  }

  // the weights of `n` chunks from c on, of this CTA's co tile: each one
  // contiguous run, copied by the bulk copy engine at one thread's request
  auto load_weights = [&](uint32_t dst, int c, int n, uint32_t bar) {
    if (tid != 0) return;
    mbar_expect_tx(bar, n * WBYTES);
    for (int k = 0; k < n; ++k)
      bulk_copy(
          dst + k * WBYTES,
          wpk + ((long long)(c + k) * (g.Co / BN) + n0 / BN) * (WVECS * 8),
          WBYTES, bar);
  };

  // start the copies of item `it` into its stage
  auto load_item = [&](int it) {
    const uint32_t st = ring0 + (it % p.stages) * stage_bytes;
    const int gi = it / ncm;
    const int c = c0 + (it - gi * ncm);
    if (!p.persist_w) load_weights(st, c, 1, bars + 8 * (it % p.stages));
    const int box = ((int)blockIdx.x + gi * (int)gridDim.x) * WG + wgid;
    if (box >= p.nboxes) return;
    int b, x0, y0, z0;
    box_origin(p, MT, box, b, x0, y0, z0);
    const uint32_t hs = st + w_in_stage + wgid * H::BYTES;
    const __nv_bfloat16* xb =
        xin + (long long)b * g.X * g.Y * g.Z * g.Ci + c * KC;
#pragma unroll
    for (int k = 0; k < H::PER_THREAD; ++k) {
      if (hvec[k] < 0) continue;
      const int half = (t + 128 * k) & 1;
      const int hx = hvec[k] & 255, hy = (hvec[k] >> 8) & 255,
                hz = hvec[k] >> 16;
      const int sx = x0 + hx - 1, sy = y0 + hy - 1, sz = z0 + hz - 1;
      const bool ok = (unsigned)sx < (unsigned)g.X &&
                      (unsigned)sy < (unsigned)g.Y &&
                      (unsigned)sz < (unsigned)g.Z;
      const long long off =
          ok ? (((long long)sx * g.Y + sy) * g.Z + sz) * g.Ci + half * 8 : 0;
      cp_async16(hs + half * H::HALF + hz * H::PLANE + (hx * HY + hy) * 16,
                 xb + off, ok ? 16 : 0);
    }
  };

  float acc[MT][NR];

  if (tid == 0) {
    for (int s = 0; s <= MAX_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // prologue: the persistent weight slab, on an mbarrier of its own
  if (p.persist_w) load_weights(smem0, c0, ncm, bars + 8 * MAX_STAGES);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }

  for (int it = 0; it < items; ++it) {
    // item `it` has landed: all but the newest stages-2 groups are complete
    if (p.stages == 2)
      cp_async_wait<0>();
    else if (p.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<2>();
    fence_async_shared();
    warpgroup_sync(wgid);  // the warpgroup's copies of item `it` have landed
    if (!p.persist_w)
      mbar_wait(bars + 8 * (it % p.stages), (it / p.stages) & 1);
    else if (it == 0)
      mbar_wait(bars + 8 * MAX_STAGES, 0);

    const int gi = it / ncm;
    const int c = c0 + (it - gi * ncm);
    const int box = ((int)blockIdx.x + gi * (int)gridDim.x) * WG + wgid;
    const bool active = box < p.nboxes;  // else: no box in the tail's group
    if (active) {
      const uint32_t st = ring0 + (it % p.stages) * stage_bytes;
      const uint32_t hs = st + w_in_stage + wgid * H::BYTES;
      const uint64_t adesc = kmajor_desc(hs, H::HALF, HY * 16);
      const uint64_t bdesc = kmajor_desc(
          p.persist_w ? smem0 + (c - c0) * WBYTES : st, BN * 16, 128);
      // all taps of all tiles in one group: tile i at tap (dx, dy, dz) is
      // the descriptor shifted to halo voxel (dx, dy, i + dz)
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const uint64_t wtile =
            (uint64_t)((p.flip ? TAPS - 1 - tap : tap) * 2 * BN);
        const int scale_d = (tap != 0 || c != c0) ? 1 : 0;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int aoff = (i + tap % 3) * H::PLANE +
                           ((tap / 9) * HY + (tap / 3) % 3) * 16;
          Wgmma<BN>::run(acc[i], adesc + (uint64_t)(aoff >> 4), bdesc + wtile,
                         scale_d);
        }
      }
      wgmma_commit();
      // the stage of item it-1 is free once its wgmma are complete; those
      // of item `it` keep the tensor cores busy meanwhile
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    // everyone who read item it-1's stage is done with it: the warpgroup
    // its halo, all warpgroups the weights streamed into it
    if (p.persist_w)
      warpgroup_sync(wgid);
    else
      __syncthreads();
    if (it + p.stages - 1 < items) load_item(it + p.stages - 1);
    cp_async_commit();

    if (!active || c != c0 + ncm - 1) continue;
    wgmma_wait<0>();
    warpgroup_sync(wgid);  // all four warps are done with this item's halo

    // epilogue: each lane holds rows lane/4 and lane/4 + 8 of its warp's 16
    // rows of each tile, two neighbouring columns of every 8; row r of tile
    // i is voxel (r / 8, r % 8, i) of the box
    int b, x0, y0, z0;
    box_origin(p, MT, box, b, x0, y0, z0);
    const long long vox0 = ((long long)b * g.X * g.Y) * g.Z;
    if (p.ksplit == 1) {
      // bf16: through the warp's staging rows, so that a row leaves as whole
      // 16-byte vectors (4-byte stores of a lane's own pairs write half
      // sectors and cost as much as the math)
      constexpr int VPR = BN / 8;      // 16-byte vectors of one row
      constexpr int RPI = 32 / VPR;    // rows one store instruction covers
      const uint32_t stg = ring0 + (it % p.stages) * stage_bytes +
                           w_in_stage + wgid * H::BYTES + warp * SWARP;
      unsigned char* stg_ptr = smem + (stg - bars);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                stg_ptr + ((lane >> 2) + h * 8) * SROW +
                ((lane & 3) * 2 + j * 8) * 2) =
                __floats2bfloat162_rn(acc[i][4 * j + 2 * h],
                                      acc[i][4 * j + 2 * h + 1]);
        __syncwarp();
        const int oz = z0 + i;
#pragma unroll
        for (int k = 0; k < 16 / RPI; ++k) {
          const int rl = k * RPI + lane / VPR;  // row of the warp's 16
          const int r = warp * 16 + rl;
          const int ox = x0 + (r >> 3), oy = y0 + (r & 7);
          if (ox >= g.X || oy >= g.Y || oz >= g.Z) continue;
          const long long vox = vox0 + ((long long)ox * g.Y + oy) * g.Z + oz;
          *reinterpret_cast<uint4*>(yout + vox * g.Co + n0 +
                                    (lane % VPR) * 8) =
              *reinterpret_cast<const uint4*>(stg_ptr + rl * SROW +
                                              (lane % VPR) * 16);
        }
      }
    } else {
      // f32 partial sums of this K split: a lane's pairs of 4 neighbouring
      // lanes are whole 32-byte sectors
      const long long M = (long long)g.B * g.X * g.Y * g.Z;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + h * 8;
          const int ox = x0 + (r >> 3), oy = y0 + (r & 7), oz = z0 + i;
          if (ox >= g.X || oy >= g.Y || oz >= g.Z) continue;
          const long long vox = vox0 + ((long long)ox * g.Y + oy) * g.Z + oz;
          float* dst = partial + ((long long)split * M + vox) * g.Co + n0 +
                       (lane & 3) * 2;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<float2*>(dst + j * 8) = make_float2(
                acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
        }
    }
  }
  cp_async_wait<0>();
}

// The weights in the order wgmma reads them, a CTA's share in one run:
//     wpk[chunk][co / bn][tap][half][co % bn][e]
//         = w[co][16*chunk + 8*half + e][tap]
// for w of logical shape (Co, Ci, 27) with element strides (sco, sci, 1).
// One CTA per (co, chunk): its 16 x 27 values go through shared memory, so
// that the reads follow w's rows and the writes are 16-byte vectors.
__global__ void __launch_bounds__(64)
    pack_weights(const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ wpk, int Co, int bn,
                 long long sco, long long sci) {
  __shared__ __align__(16) __nv_bfloat16 tile[KC][TAPS + 1];
  const int co = blockIdx.x, chunk = blockIdx.y;
  const __nv_bfloat16* src = w + co * sco + (long long)chunk * KC * sci;
  for (int i = threadIdx.x; i < KC * TAPS; i += 64)
    tile[i / TAPS][i % TAPS] = src[(i / TAPS) * sci + i % TAPS];
  __syncthreads();
  if (threadIdx.x < 2 * TAPS) {
    const int tap = threadIdx.x >> 1, half = threadIdx.x & 1;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[half * 8 + e][tap];
    const long long run = (long long)chunk * (Co / bn) + co / bn;
    *reinterpret_cast<uint4*>(
        wpk + (((run * TAPS + tap) * 2 + half) * bn + co % bn) * 8) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// y = bf16(sum over the K splits, in split order, of their f32 partials);
// one thread per 4 neighbouring values
__global__ void __launch_bounds__(256)
    reduce_splits(const float4* __restrict__ partial,
                  uint2* __restrict__ yout, long long n4, int ksplit) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int k = 1; k < ksplit; ++k) {
    const float4 v = partial[k * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 out;
  out.x = *reinterpret_cast<const uint32_t*>(&lo);
  out.y = *reinterpret_cast<const uint32_t*>(&hi);
  yout[i] = out;
}

template <int BN, int WG, int MT>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                __nv_bfloat16* y, float* partial, const Geom& g,
                const Plan& p, int gx, cudaStream_t s) {
  auto kernel = conv3x3x3_bf16_kernel<BN, WG, MT>;
  const long long wbytes = (long long)TAPS * 2 * BN * 16;
  const long long slab = p.persist_w ? (g.Ci / KC / p.ksplit) * wbytes : 0;
  const long long stage =
      (long long)WG * Halo<MT>::BYTES + (p.persist_w ? 0 : wbytes);
  const long long smem = BAR_BYTES + slab + p.stages * stage;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)gx, (unsigned)(g.Co / BN * p.ksplit));
  kernel<<<grid, 128 * WG, (size_t)smem, s>>>(x, w, y, partial, g, p);
  if (p.ksplit > 1) {
    const long long n4 = (long long)g.B * g.X * g.Y * g.Z * g.Co / 4;
    reduce_splits<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<uint2*>(y),
        n4, p.ksplit);
  }
  return (int)cudaGetLastError();
}

template <int BN, int WG>
int launch_bf16_mt(int mt, const __nv_bfloat16* x, const __nv_bfloat16* w,
                   __nv_bfloat16* y, float* partial, const Geom& g,
                   const Plan& p, int gx, cudaStream_t s) {
  if (mt == 2) return launch_bf16<BN, WG, 2>(x, w, y, partial, g, p, gx, s);
  // four warpgroups have 128 registers a thread: 64 accumulators at most
  if constexpr (WG * BN <= 128) {
    if (mt == 4) return launch_bf16<BN, WG, 4>(x, w, y, partial, g, p, gx, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- f32 --
// CTA tile 64 x BN, K step 16; each thread a 4 x (BN/16) register tile.
constexpr int THREADS = 256;
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

// The launch of the bf16 kernel, as the wrapper fills it
// (`ops/conv3d.py::_ConvArgs`): the shape; sco, sci: element strides of the
// weights' logical (Co, Ci, 27); mt: m64 tiles (z planes of 8 x 8 voxels) of
// one warpgroup's box, 2 or 4; bn: output channels of one CTA, 64, 32 or 16
// dividing Co; wg: warpgroups (boxes) of one CTA, 2 or 4 (4 tiles with 4
// warpgroups only up to bn = 32: registers); stages: ring depth, 2..4;
// persist_w: weights staged once per CTA; ksplit: splits of the Ci/16 chunks
// (divides them); flip: tap t uses the weights of tap 26 - t (the spatial
// flip of the conv's dx); gx: CTAs per (co tile, split), at most the groups
// of wg boxes.
struct ConvArgs {
  int B, X, Y, Z, Ci, Co;
  long long sco, sci;
  int mt, bn, wg, stages, persist_w, ksplit, flip, gx;
};

// x: NDHWC bf16; w: the weights, (Co, Ci, 27) by strides; wpk: workspace of
// 27*Ci*Co bf16 for the weights packed as [Ci/16][Co/bn][27][2][bn][8]
// (chunk, co tile, tap, k half, output channel, 8 input channels); y: NDHWC
// bf16; partial: f32 workspace of ksplit * B*X*Y*Z*Co values (unused when
// ksplit == 1).
extern "C" int conv3x3x3_bf16(const void* x, const void* w, void* wpk,
                              void* y, void* partial, const ConvArgs* a,
                              void* stream) {
  const int B = a->B, X = a->X, Y = a->Y, Z = a->Z, Ci = a->Ci, Co = a->Co;
  const int mt = a->mt, bn = a->bn, wg = a->wg, stages = a->stages;
  const int persist_w = a->persist_w, ksplit = a->ksplit, flip = a->flip;
  const int gx = a->gx;
  const long long sco = a->sco, sci = a->sci;
  if (Ci % KC != 0 || Co % bn != 0 || mt < 1 || stages < 2 ||
      stages > MAX_STAGES || ksplit < 1 || (Ci / KC) % ksplit != 0 || gx < 1 ||
      (ksplit > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, X, Y, Z, Ci, Co};
  Plan p{};
  p.nbx = ceil_div(X, TX), p.nby = ceil_div(Y, TY), p.nbz = ceil_div(Z, mt);
  p.nboxes = B * p.nbx * p.nby * p.nbz;
  p.stages = stages, p.persist_w = persist_w ? 1 : 0, p.ksplit = ksplit;
  p.flip = flip ? 1 : 0;
  if (gx > ceil_div(p.nboxes, wg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* wb = static_cast<__nv_bfloat16*>(wpk);
  pack_weights<<<dim3((unsigned)Co, (unsigned)(Ci / KC)), 64, 0, s>>>(
      static_cast<const __nv_bfloat16*>(w), wb, Co, bn, sco, sci);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pf = static_cast<float*>(partial);
  switch (bn * 10 + wg) {
    case 644: return launch_bf16_mt<64, 4>(mt, xb, wb, yb, pf, g, p, gx, s);
    case 324: return launch_bf16_mt<32, 4>(mt, xb, wb, yb, pf, g, p, gx, s);
    case 164: return launch_bf16_mt<16, 4>(mt, xb, wb, yb, pf, g, p, gx, s);
    case 642: return launch_bf16_mt<64, 2>(mt, xb, wb, yb, pf, g, p, gx, s);
    case 322: return launch_bf16_mt<32, 2>(mt, xb, wb, yb, pf, g, p, gx, s);
    case 162: return launch_bf16_mt<16, 2>(mt, xb, wb, yb, pf, g, p, gx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w: (27, Ci, Co) f32.
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
