// Sliding-window overlap-add for 3-D inference, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel bcp_tpu/ops/scatter.py::scatter_add_windows
// (body `_kernel`). For each window w of a chunk, IN ORDER:
//     score[sx:sx+px, sy:sy+py, sz:sz+pz, :] += probs[w]
// score (X, Y, Z, C) f32, updated in place; probs (B, px, py, pz, C) f32.
//
// Design: output-stationary. The windows of a chunk overlap (LA: 112x112x80
// windows at stride 18/18/4), so a per-window scatter with atomicAdd would
// sum each voxel in whatever order the blocks happen to run and the result
// would drift from the in-order loop in the last f32 bit. Here each thread
// owns one score element inside the chunk's bounding box, reads it once,
// adds the covering windows' probs in window order, and writes it once:
// bit-for-bit the in-order loop, with no atomics.
//
// Bound on the H100: bytes. Per chunk it must read every window's probs
// once and read and write each covered score element once; one f32 add per
// probs element is far below the card's f32 rate. Neighbouring threads own
// neighbouring (z, c) elements, so every probs and score access is coalesced.
// The window origins travel by value in the kernel's parameters (no device
// copy, no host synchronisation); the launcher clips the grid to the chunk's
// bounding box.

#include <cuda_runtime.h>

#define MAX_WINDOWS 64

struct WindowStarts {
  int s[MAX_WINDOWS][3];
};

__global__ void scatter_add_windows_kernel(
    float* __restrict__ score, const float* __restrict__ probs,
    WindowStarts starts, int n_windows, int Y, int Z, int C,
    int px, int py, int pz, int bx0, int by0, int bz0,
    int bxn, int byn, int bzn) {
  // one thread per (x, y, z, c) element of the bounding box, (z, c) fastest
  const long long zc_n = (long long)bzn * C;
  const long long total = (long long)bxn * byn * zc_n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int zc = (int)(idx % zc_n);
  const long long rest = idx / zc_n;
  const int y = by0 + (int)(rest % byn);
  const int x = bx0 + (int)(rest / byn);
  const int z = bz0 + zc / C;
  const int c = zc % C;

  const long long out_off = (((long long)x * Y + y) * Z + z) * C + c;
  const long long win_elems = (long long)px * py * pz * C;
  float acc = 0.0f;
  bool covered = false;
  for (int w = 0; w < n_windows; ++w) {
    const int lx = x - starts.s[w][0];
    const int ly = y - starts.s[w][1];
    const int lz = z - starts.s[w][2];
    if ((unsigned)lx < (unsigned)px && (unsigned)ly < (unsigned)py &&
        (unsigned)lz < (unsigned)pz) {
      if (!covered) {
        acc = score[out_off];
        covered = true;
      }
      // plain f32 add in window order: the same rounding as the loop
      acc = __fadd_rn(acc, probs[w * win_elems +
                                 (((long long)lx * py + ly) * pz + lz) * C + c]);
    }
  }
  if (covered) score[out_off] = acc;
}

extern "C" int scatter_add_windows_f32(
    float* score, const float* probs, const int* starts_host, int n_windows,
    int X, int Y, int Z, int C, int px, int py, int pz, void* stream) {
  if (n_windows < 1 || n_windows > MAX_WINDOWS) return (int)cudaErrorInvalidValue;
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
  const long long total =
      (long long)(hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2]) * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  scatter_add_windows_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      score, probs, ws, n_windows, Y, Z, C, px, py, pz, lo[0], lo[1], lo[2],
      hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]);
  (void)X;
  return (int)cudaGetLastError();
}
