// Sliding-window overlap-add for 3-D inference, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/scatter.py::scatter_add_windows
// (body `_kernel`). For each window w of a chunk, IN ORDER:
//     score[sx:sx+px, sy:sy+py, sz:sz+pz, :] += probs[w]
// score (X, Y, Z, C) f32, updated in place; probs (B, px, py, pz, C) f32.
// Two entries share one templated kernel:
//   scatter_add_windows_f32          adds probs[w], the direct port;
//   softmax_scatter_add_windows_f32  adds softmax(logits[w]) over C for the
//       first n_valid windows. It takes in the evaluator's two passes before
//       the overlap-add (the softmax, and the multiply by the chunk's valid
//       mask): a padded window would add +0.0 to a score that started at
//       +0.0 and only grows, which is the identity, so it is not read.
//
// Bound on the H100: bytes. Per LA chunk (8 windows of 112x112x80x2 into a
// 240x200x96x2 map) the kernel must read 64.2 MB of probs or logits and
// read and write the 11.05 MB of covered score once each: 0.0258 ms at
// 3.35 TB/s. The adds (and the softmax's few f32 operations a logit) are
// far below the card's f32 rate. The design is about bytes in flight and
// the L2:
//   - output-stationary, no atomics: each score element is read once, the
//     covering windows' values are added in window order with __fadd_rn,
//     and it is written once, so the probs entry is the in-order loop bit
//     for bit and every run gives the same bits;
//   - rows, not elements: a block takes a few (x, y) rows of the chunk's
//     bounding box, and one warp per row decides once which windows cover
//     it (a ballot keeps them in window order), with each window's z range
//     and the 64-bit offset of its row; threads run along the row's
//     contiguous (z, c) floats with 32-bit offsets from there;
//   - a thread owns a unit of U = lcm(VEC, C) floats, read as 16-, 8- or
//     4-byte vectors (VEC, a template argument picked by
//     overlap_add_vector_width for the launch's alignment), and issues the
//     loads of all its covering windows (up to 8 at once) before its first
//     add: 8 x 16 bytes in flight a thread instead of one 4-byte load
//     behind a branch. The probs entry takes U = VEC floats whatever C is;
//     the fused entry is specialised for C = 2, the class count of every
//     configuration that runs this 3-D evaluator (LA and pancreas), and
//     takes any other C in a generic kernel that holds one voxel a thread
//     and loops over its classes at run time;
//   - probs and logits are read once, with an evict-first hint (__ldcs),
//     so they do not push the score box, which the next chunk's box
//     mostly shares, out of the 50 MB L2;
//   - the softmax is done per voxel over its C classes (in registers for
//     C = 2), in torch's order: m = max, e_c = expf(l_c - m), s = sum over c from 0
//     up, p_c = e_c / s (accurate expf, IEEE division).
// Window origins travel by value in the kernel's parameters (no device
// copy, no host synchronisation); the launcher clips the grid to the
// chunk's bounding box.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WINDOWS 64
#define THREADS 256
#define ROWS_MAX 8

struct WindowStarts {
  int s[MAX_WINDOWS][3];
};

struct Geometry {
  int Y, zc;                 // score map: Y, and Z * C floats a row
  int px, py, pzc;           // window extent; pz * C floats a window row
  long long win;             // floats a window
  int cls;                   // C
  int bx0, by0, bzc0;        // bounding box origin (z in floats: z * C)
  int byn, rows;             // its y extent, and its x * y rows
  int units;                 // units of U floats along a box row
  int rows_per_block;
  int n_windows;
};

__host__ __device__ constexpr int gcd_c(int a, int b) {
  return b == 0 ? a : gcd_c(b, a % b);
}
__host__ __device__ constexpr int lcm_c(int a, int b) {
  return a / gcd_c(a, b) * b;
}

template <int VEC, int U>
__device__ __forceinline__ void load_stream(float (&v)[U], const float* p) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int i = 0; i < U / 4; ++i) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int i = 0; i < U / 2; ++i) {
      const float2 t = __ldcs(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = t.x; v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = __ldcs(p + i);
  }
}

template <int VEC, int U>
__device__ __forceinline__ void load_plain(float (&v)[U], const float* p) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int i = 0; i < U / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int i = 0; i < U / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x; v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = p[i];
  }
}

template <int VEC, int U>
__device__ __forceinline__ void store_plain(float* p, const float (&v)[U]) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int i = 0; i < U / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int i = 0; i < U / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) p[i] = v[i];
  }
}

// softmax over the two classes of each voxel of a unit, in torch's order
template <int U>
__device__ __forceinline__ void softmax2_unit(float (&v)[U]) {
#pragma unroll
  for (int p = 0; p < U / 2; ++p) {
    float* l = v + 2 * p;
    // the larger class's exponent is expf(m - m): 1 where m is finite,
    // else NaN, which is (m - m) + 1 bit for bit; so one expf a voxel
    const bool first = l[0] > l[1];
    const float m = first ? l[0] : l[1];
    const float one = __fadd_rn(__fsub_rn(m, m), 1.0f);
    const float e = expf(__fsub_rn(first ? l[1] : l[0], m));
    const float e0 = first ? one : e, e1 = first ? e : one;
    const float s = __fadd_rn(__fadd_rn(0.0f, e0), e1);
    l[0] = __fdiv_rn(e0, s);
    l[1] = __fdiv_rn(e1, s);
  }
}

// any class count: add softmax(l) over c classes to dst[0 .. c), in
// torch's order (m = max, s = sum of expf(l - m) from class 0 up)
__device__ __forceinline__ void softmax_add_voxel(float* dst, const float* l,
                                                  int c) {
  float m = l[0];
  for (int k = 1; k < c; ++k) m = m > l[k] ? m : l[k];
  float s = 0.0f;
  for (int k = 0; k < c; ++k) s = __fadd_rn(s, expf(__fsub_rn(l[k], m)));
  for (int k = 0; k < c; ++k)
    dst[k] = __fadd_rn(dst[k], __fdiv_rn(expf(__fsub_rn(l[k], m)), s));
}

// VEC: floats a vector access. C: 1 for the probs entry (its unit is one
// vector, whatever the class count); 2 for the fused entry's two-class
// kernel; 0 for its generic kernel (VEC 1, one voxel of g.cls floats a
// unit). 16-byte launches are held to 64 registers, four blocks an SM
// (LA's fused entry: 0.0397 against 0.0428 ms); narrower ones lost a
// quarter under that cap and keep theirs.
template <int VEC, int C, bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, VEC == 4 ? 4 : 1)
    overlap_add_kernel(
    float* __restrict__ score, const float* __restrict__ src,
    const __grid_constant__ WindowStarts starts, const Geometry g) {
  constexpr bool GENERIC = C == 0;
  constexpr int U = lcm_c(VEC, GENERIC ? 1 : C);
  const int unit = GENERIC ? g.cls : U;   // floats a thread owns
  // windows whose loads are in flight together: 8 where a unit is small
  constexpr int G = U <= 4 ? 8 : U <= 8 ? 4 : U <= 16 ? 2 : 1;
  __shared__ long long s_off[ROWS_MAX][MAX_WINDOWS];  // window row - bzc0
  __shared__ int2 s_rng[ROWS_MAX][MAX_WINDOWS];       // its units [lo, hi)
  __shared__ long long s_row[ROWS_MAX];               // score row + bzc0
  __shared__ int s_n[ROWS_MAX];                       // windows covering it

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * g.rows_per_block;
  const int nrows = min(g.rows_per_block, g.rows - row0);

  // one warp per row: which windows cover (x, y), in window order
  for (int r = threadIdx.x >> 5; r < nrows; r += blockDim.x >> 5) {
    const int q = row0 + r;
    const int x = g.bx0 + q / g.byn, y = g.by0 + q % g.byn;
    int count = 0;
    for (int w0 = 0; w0 < g.n_windows; w0 += 32) {
      const int w = w0 + lane;
      bool cov = false;
      long long off = 0;
      int lo = 0;
      if (w < g.n_windows) {
        const int lx = x - starts.s[w][0], ly = y - starts.s[w][1];
        cov = (unsigned)lx < (unsigned)g.px && (unsigned)ly < (unsigned)g.py;
        const int szc = starts.s[w][2] * g.cls;
        off = (long long)w * g.win + ((long long)lx * g.py + ly) * g.pzc -
              szc + g.bzc0;
        lo = (szc - g.bzc0) / unit;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, cov);
      if (cov) {
        const int at = count + __popc(mask & ((1u << lane) - 1u));
        s_off[r][at] = off;
        s_rng[r][at] = make_int2(lo, lo + g.pzc / unit);
      }
      count += __popc(mask);
    }
    if (lane == 0) {
      s_n[r] = count;
      s_row[r] = ((long long)x * g.Y + y) * g.zc + g.bzc0;
    }
  }
  __syncthreads();

  for (int it = threadIdx.x; it < nrows * g.units; it += blockDim.x) {
    const int r = it / g.units;
    const int u = it - r * g.units;
    const int n = s_n[r];
    bool covered = false;
    for (int k = 0; k < n; ++k) {
      const int2 rg = s_rng[r][k];
      covered |= rg.x <= u && u < rg.y;
    }
    if (!covered) continue;
    if constexpr (GENERIC) {
      // each covering window's softmax added in place, in window order
      float* dst = score + s_row[r] + u * unit;
      for (int k = 0; k < n; ++k) {
        const int2 rg = s_rng[r][k];
        if (rg.x <= u && u < rg.y)
          softmax_add_voxel(dst, src + s_off[r][k] + u * unit, g.cls);
      }
      continue;
    }
    float* dst = score + s_row[r] + u * U;
    float acc[U];
    load_plain<VEC, U>(acc, dst);
    for (int k0 = 0; k0 < n; k0 += G) {
      float v[G][U];
      bool in[G];
      // every covering window's load first ...
#pragma unroll
      for (int j = 0; j < G; ++j) {
        in[j] = false;
        if (k0 + j < n) {
          const int2 rg = s_rng[r][k0 + j];
          in[j] = rg.x <= u && u < rg.y;
          if (in[j]) load_stream<VEC, U>(v[j], src + s_off[r][k0 + j] + u * U);
        }
      }
      // ... then the adds, in window order: the in-order loop's rounding
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (in[j]) {
          if constexpr (SOFTMAX) softmax2_unit<U>(v[j]);
#pragma unroll
          for (int e = 0; e < U; ++e) acc[e] = __fadd_rn(acc[e], v[j][e]);
        }
      }
    }
    store_plain<VEC, U>(dst, acc);
  }
}

// The widest vector (4, 2 or 1 floats) that every access of the launch is
// aligned to: Z * C, pz * C, each window's z * C and both base pointers.
extern "C" int overlap_add_vector_width(
    const float* score, const float* src, const int* starts_host,
    int n_windows, int Z, int C, int pz) {
  for (int vec = 4; vec > 1; vec /= 2) {
    bool ok = (Z * C) % vec == 0 && (pz * C) % vec == 0 &&
              (uintptr_t)score % (4 * vec) == 0 &&
              (uintptr_t)src % (4 * vec) == 0;
    for (int w = 0; ok && w < n_windows; ++w)
      ok = (starts_host[w * 3 + 2] * C) % vec == 0;
    if (ok) return vec;
  }
  return 1;
}

template <int VEC, int C, bool SOFTMAX>
static int launch(float* score, const float* src, const int* starts_host,
                  int n_windows, int X, int Y, int Z, int cls, int px, int py,
                  int pz, void* stream) {
  const int unit = C == 0 ? cls : lcm_c(VEC, C);
  WindowStarts ws;
  int lo[3] = {X, Y, Z}, hi[3] = {0, 0, 0};
  const int ext[3] = {px, py, pz};
  for (int w = 0; w < n_windows; ++w) {
    for (int a = 0; a < 3; ++a) {
      const int s = starts_host[w * 3 + a];
      ws.s[w][a] = s;
      lo[a] = s < lo[a] ? s : lo[a];
      hi[a] = s + ext[a] > hi[a] ? s + ext[a] : hi[a];
    }
  }
  Geometry g;
  g.Y = Y; g.zc = Z * cls;
  g.px = px; g.py = py; g.pzc = pz * cls;
  g.win = (long long)px * py * pz * cls;
  g.cls = cls;
  g.bx0 = lo[0]; g.by0 = lo[1]; g.bzc0 = lo[2] * cls;
  g.byn = hi[1] - lo[1];
  g.rows = (hi[0] - lo[0]) * g.byn;
  g.units = (hi[2] - lo[2]) * cls / unit;
  int rpb = THREADS / g.units;
  g.rows_per_block = rpb < 1 ? 1 : rpb > ROWS_MAX ? ROWS_MAX : rpb;
  g.n_windows = n_windows;
  long long busy = (long long)g.rows_per_block * g.units;
  const int threads = busy >= THREADS ? THREADS : (int)((busy + 31) / 32 * 32);
  const int blocks = (g.rows + g.rows_per_block - 1) / g.rows_per_block;
  overlap_add_kernel<VEC, C, SOFTMAX>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(score, src, ws, g);
  return (int)cudaGetLastError();
}

template <int C, bool SOFTMAX>
static int launch_vec(int vec, float* score, const float* src,
                      const int* starts_host, int n_windows, int X, int Y,
                      int Z, int cls, int px, int py, int pz, void* stream) {
  if (vec == 4)
    return launch<4, C, SOFTMAX>(score, src, starts_host, n_windows, X, Y, Z,
                                 cls, px, py, pz, stream);
  if (vec == 2)
    return launch<2, C, SOFTMAX>(score, src, starts_host, n_windows, X, Y, Z,
                                 cls, px, py, pz, stream);
  return launch<1, C, SOFTMAX>(score, src, starts_host, n_windows, X, Y, Z,
                               cls, px, py, pz, stream);
}

static bool valid_launch(int n_windows, int X, int Y, int Z, int C, int px,
                         int py, int pz) {
  return n_windows >= 1 && n_windows <= MAX_WINDOWS && C >= 1 && px >= 1 &&
         py >= 1 && pz >= 1 && px <= X && py <= Y && pz <= Z;
}

extern "C" int scatter_add_windows_f32(
    float* score, const float* probs, const int* starts_host, int n_windows,
    int X, int Y, int Z, int C, int px, int py, int pz, void* stream) {
  if (!valid_launch(n_windows, X, Y, Z, C, px, py, pz))
    return (int)cudaErrorInvalidValue;
  const int vec = overlap_add_vector_width(score, probs, starts_host,
                                           n_windows, Z, C, pz);
  return launch_vec<1, false>(vec, score, probs, starts_host, n_windows, X,
                              Y, Z, C, px, py, pz, stream);
}

// windows n_valid .. B-1 of the chunk are padding: only the first n_valid
// starts are read
extern "C" int softmax_scatter_add_windows_f32(
    float* score, const float* logits, const int* starts_host, int n_valid,
    int X, int Y, int Z, int C, int px, int py, int pz, void* stream) {
  if (!valid_launch(n_valid, X, Y, Z, C, px, py, pz))
    return (int)cudaErrorInvalidValue;
  if (C != 2)
    return launch<1, 0, true>(score, logits, starts_host, n_valid, X, Y, Z,
                              C, px, py, pz, stream);
  const int vec = overlap_add_vector_width(score, logits, starts_host,
                                           n_valid, Z, C, pz);
  return launch_vec<2, true>(vec, score, logits, starts_host, n_valid, X, Y,
                             Z, C, px, py, pz, stream);
}
