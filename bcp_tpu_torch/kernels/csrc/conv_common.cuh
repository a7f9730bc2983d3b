// What the hand-written 3x3x3 conv kernels share: kernel B
// (conv3x3x3.cu, forward and dx), kernel C (conv3x3x3_dw.cu, the weight
// gradient) and kernel D (conv3x3x3_dxdw.cu, the fused backward), and the
// dW engine that C and D run.
//
// - the m64 tile of 8 x 8 voxels of one z plane and its halo;
// - cp.async (16-byte, zero-filling), mbarrier and bulk-copy helpers;
// - shared-memory descriptors of K-major and MN-major operands without
//   swizzle, and wgmma.mma_async m64nNk16 (bf16 in, f32 out) from two
//   descriptors, K-major or transposed;
// - `Slab`, D's staged layout [plane][8-channel group][x][y] of 16-byte
//   entries, `Centre`, the same without the halo (C's dy), and `DwEngine`,
//   which multiplies an x slab shifted by a tap with a dy slab's centre
//   over the voxels of a box: dW = shift(x)^T * dy with both operands read
//   transposed from the slabs, no thread-side gather.
//
// The header is included by each kernel source inside nothing: its names
// live in an anonymous namespace of their own, as each source's do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;      // input channels per chunk = one wgmma k step
constexpr int TX = 8;       // an m64 tile: 8 x 8 voxels of one z plane
constexpr int TY = 8;
constexpr int HX = TX + 2;  // the tile's halo
constexpr int HY = TY + 2;
constexpr int TAPS = 27;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int BAR_BYTES = 128;      // of it, the mbarriers' share

// The halo of one box (TX x TY x MT output voxels) in shared memory, for one
// chunk of 16 channels: [k half][hz][hx][hy] entries of 16 bytes (8
// channels). 8 voxels along y are then 128 contiguous bytes, a wgmma core
// matrix, and the 8 lines along x of a tile lie HY * 16 bytes apart: an m64
// tile at any tap is one shared-memory descriptor, and a tap is a shift of
// its start address. Planes and halves are padded so that the 16-byte
// copies of a warp (along z, then the two halves) spread over the banks.
template <int MT>
struct Halo {
  static constexpr int HZ = MT + 2;
  static constexpr int PLANE = (HX * HY + 6) * 16;  // 106 units = 2 (mod 8)
  static constexpr int HALF =
      HZ * PLANE + ((1 + 8 - (HZ * (PLANE / 16)) % 8) % 8) * 16;
  static constexpr int BYTES = 2 * HALF;
  static constexpr int VECS = 2 * HX * HY * HZ;  // 16-byte vectors
  static constexpr int PER_THREAD = (VECS + 127) / 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// mbarrier of one ring stage's weights (and of the persistent slab)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the bulk copy engine; the
// bytes count on `bar` as they land
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier of one warpgroup's 128 threads (named barrier 1 + its number)
__device__ __forceinline__ void warpgroup_sync(int wgid) {
  asm volatile("bar.sync %0, 128;" ::"r"(wgid + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8 x 16-byte core matrices of 128 contiguous bytes; `lbo` bytes between
// the core matrices of the two k halves, `sbo` bytes between groups of 8
// rows (voxels of A, output channels of B).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The same of an MN-major (transposed) operand without swizzle: a core
// matrix is 8 rows of K, each 16 bytes = 8 consecutive elements along M (or
// N), 128 contiguous bytes; `k_stride` bytes between the core matrices
// along K, `mn_stride` bytes between those along M or N (CUTLASS's
// INTERLEAVE canonical layout ((T,1,m),(8,k)):((1,T,SBO),(1T,LBO))).
// scripts/wgmma_mn_probe.cu holds this against a host product.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t k_stride,
                                                 uint32_t mn_stride) {
  return kmajor_desc(addr, k_stride, mn_stride);
}

// d (64 x N, f32, registers) = a (64 x 16, bf16, shared) * b (16 x N, bf16,
// shared) + (scale_d ? d : 0); both operands K-major (TRANS = 0) or both
// MN-major (TRANS = 1: wgmma's imm-trans-a and imm-trans-b)
template <int N, int TRANS = 0>
struct Wgmma;

template <int TRANS>
struct Wgmma<16, TRANS> {
  __device__ static __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, %11, %11;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS));
  }
};

template <int TRANS>
struct Wgmma<32, TRANS> {
  __device__ static __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "%16, %17, p, 1, 1, %19, %19;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS));
  }
};

template <int TRANS>
struct Wgmma<64, TRANS> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "%32, %33, p, 1, 1, %35, %35;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS));
  }
};

// ------------------------------------------------------- D's slabs, dW --
// One (plane, 8-channel group) of a slab: the HX x HY halo entries of 16
// bytes, padded to 106 units (= 2 mod 8) so that the copies of a warp
// spread over the banks.
constexpr int SLAB_PLANE = (HX * HY + 6) * 16;

// A box's halo of G 8-channel groups over PLANES z planes, laid out
// [plane][group][hx][hy]. Every group lies SLAB_PLANE bytes after the one
// before it, also across planes, so that an m64 operand whose rows are
// channels may run on from one plane into the next (DwEngine's z taps).
// As a K-major operand with voxels as rows (dx's A): 8 voxels along y are a
// core matrix, x lines HY * 16 bytes apart, k halves (groups) SLAB_PLANE
// apart. As an MN-major operand with channels as rows (dW's): 8 channels of
// a voxel are a core row, 8 voxels along y a core matrix, groups
// SLAB_PLANE apart along M or N, x lines HY * 16 bytes apart along K.
template <int G, int P>
struct Slab {
  static constexpr int GROUPS = G;
  static constexpr int PLANES = P;
  static constexpr int BYTES = P * G * SLAB_PLANE;
  static constexpr int VECS = P * G * HX * HY;  // 16-byte entries
  // as dW's B operand: bytes between x lines (K) and between groups (N)
  static constexpr uint32_t K_STRIDE = HY * 16;
  static constexpr uint32_t G_STRIDE = SLAB_PLANE;
  // the entry of halo voxel (hx, hy, hz), group g
  __device__ static __forceinline__ uint32_t at(int hx, int hy, int hz,
                                                int g) {
    return (uint32_t)((hz * G + g) * SLAB_PLANE + (hx * HY + hy) * 16);
  }
  // box voxel (2s, 0, t), group 0: the first of dW's k step s on tile t
  __device__ static __forceinline__ uint32_t centre(int t, int s) {
    return at(2 * s + 1, 1, t + 1, 0);
  }
};

// A box's own voxels without a halo (kernel C's dy, which only dW reads):
// G 8-channel groups over P z planes of TX x TY voxels, laid out
// [plane][group][x][y] in 16-byte entries, each (plane, group) padded to 65
// units (= 1 mod 8) so that the copies of a warp, groups fastest, spread
// over the banks. 2.6x fewer bytes than a Slab of P + 2 halo planes at P =
// 3. As dW's B operand: x lines TY * 16 bytes apart along K, groups
// CENTRE_PLANE apart along N.
constexpr int CENTRE_PLANE = (TX * TY + 1) * 16;

template <int G, int P>
struct Centre {
  static constexpr int BYTES = P * G * CENTRE_PLANE;
  static constexpr int VECS = P * G * TX * TY;
  static constexpr uint32_t K_STRIDE = TY * 16;
  static constexpr uint32_t G_STRIDE = CENTRE_PLANE;
  // the entry of box voxel (vx, vy, t), group g
  __device__ static __forceinline__ uint32_t at(int vx, int vy, int t,
                                                int g) {
    return (uint32_t)((t * G + g) * CENTRE_PLANE + (vx * TY + vy) * 16);
  }
  // box voxel (2s, 0, t), group 0: the first of dW's k step s on tile t
  __device__ static __forceinline__ uint32_t centre(int t, int s) {
    return at(2 * s, 0, t, 0);
  }
};

// The dW engine. Over the MT tiles (z planes of 8 x 8 voxels) of one box,
// adds to acc[j][p] the product dW[(z tap, ci), co] = sum over voxels v of
// x[v + tap, ci] * dy[v, co] for the taps (i, j, ZT*p + 0..ZT-1), where:
//   xs:  an x slab of CI channels, Slab<CI/8, MT + 3>, halo voxel (0, 0, 0)
//        at voxel (-1, -1, -1) of the box (its last plane is never a real
//        tap: it feeds the unused rows of the last z pass);
//   dys: a dy slab of CG channels, DS: D's Slab<CG/8, MT + 2> with the same
//        origin, or C's Centre<CG/8, MT> of the box's own voxels; zero
//        outside the volume (so are the box's voxels past its edge), so
//        that those voxels add nothing.
// M = 64 rows: ZT = 64 / CI z taps of CI channels each, row r is tap
// ZT*p + r / CI, channel r % CI (rows of taps past 2 are discarded by the
// caller); N = CG output channels; K = the box's voxels, 16 (two x lines)
// per wgmma. Both operands MN-major from the slabs, the tap a shift of x's
// start address. With `scale_d` 0 the first product of each tile replaces
// acc instead of adding to it (so acc needs no zeroing: non-wgmma writes
// to accumulators in flight would serialise the wgmma). The caller fences,
// commits and waits.
template <int CI, int CG, int MT, class DS = Slab<CG / 8, MT + 2>>
struct DwEngine {
  static constexpr int ZT = 64 / CI;                 // z taps per m64 tile
  static constexpr int PASSES = (3 + ZT - 1) / ZT;   // m64 tiles per (i, j)
  static constexpr int NR = CG / 2;                  // registers per tile
  using XSlab = Slab<CI / 8, MT + 3>;
  using DySlab = DS;
  static_assert(CI == 16 || CI == 32 || CI == 64, "CI: 16, 32 or 64");

  __device__ static __forceinline__ void run(float (&acc)[3][PASSES][NR],
                                             uint32_t xs, uint32_t dys,
                                             int i, int scale_d) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int s = 0; s < TX / 2; ++s) {
        const uint64_t b = mnmajor_desc(dys + DS::centre(t, s),
                                        DS::K_STRIDE, DS::G_STRIDE);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int p = 0; p < PASSES; ++p) {
            const uint64_t a = mnmajor_desc(
                xs + XSlab::at(2 * s + i, j, t + ZT * p, 0), HY * 16,
                SLAB_PLANE);
            Wgmma<CG, 1>::run(acc[j][p], a, b,
                              (t | s) != 0 ? 1 : scale_d);
          }
      }
  }
};

}  // namespace
