// Probe of wgmma.mma_async with both operands MN-major (transposed) in
// shared memory, on which kernel D's dW rests
// (bcp_tpu_torch/kernels/csrc/conv_common.cuh: mnmajor_desc, DwEngine).
//
// 1. One m64nNk16 product (N = 16, 32, 64) whose A (64 x 16) and B (16 x N)
//    lie in shared memory as D's slabs hold them: 8 consecutive M (or N)
//    elements of one k in 16 bytes, 8 k rows of one core matrix 16 bytes
//    apart, core matrices 1696 bytes apart along M or N and 160 bytes apart
//    along K. Run with the descriptor's two byte offsets assigned as
//    mnmajor_desc assigns them (LBO = along K, SBO = along M/N) and the
//    other way round; each against the product taken on the host.
// 2. DwEngine itself on one tile (MT = 1) of random x and dy slabs, for
//    (CI, CG) = (16, 16), (16, 32), (32, 16), (32, 32) and each tap row
//    i = 0..2, against the sums of its definition taken on the host.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//         -I bcp_tpu_torch/kernels/csrc -o wgmma_mn_probe \
//         scripts/wgmma_mn_probe.cu
//     ./wgmma_mn_probe      # exit 0 when every check passes
//
// Each line: the check, its largest |wgmma - host| and the largest |host|.
// The products are of bf16 values with f32 sums, so the two agree to f32
// rounding of sums in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>

#include <vector>

#include "conv_common.cuh"

namespace {

constexpr int K_STRIDE = HY * 16;  // 160 bytes: x lines of a slab
constexpr int SMEM = 64 * 1024;

float bf(uint16_t v) {
  const uint32_t u = (uint32_t)v << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

uint16_t to_bf(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

// thread tid's registers of an m64nN f32 tile -> out[row][col]
template <int N>
__device__ void store_tile(const float (&d)[N / 2], float* out) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(warp * 16 + (lane >> 2) + h * 8) * N + j * 8 + (lane & 3) * 2 +
            e] = d[4 * j + 2 * h + e];
}

template <int N>
__global__ void raw_kernel(const uint4* image, int vecs, int b_off,
                           uint32_t lbo, uint32_t sbo, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = image[i];
  fence_async_shared();
  __syncthreads();
  const uint32_t base = smem_u32(smem);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
  Wgmma<N, 1>::run(d, kmajor_desc(base, lbo, sbo),
                   kmajor_desc(base + b_off, lbo, sbo), 0);
  wgmma_commit();
  wgmma_wait<0>();
  store_tile<N>(d, out);
}

template <int CI, int CG>
__global__ void engine_kernel(const uint4* image, int vecs, int dy_off, int i,
                              float* out) {
  using E = DwEngine<CI, CG, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  for (int k = threadIdx.x; k < vecs; k += blockDim.x)
    reinterpret_cast<uint4*>(smem)[k] = image[k];
  fence_async_shared();
  __syncthreads();
  const uint32_t base = smem_u32(smem);
  float acc[3][E::PASSES][E::NR];
  for (int j = 0; j < 3; ++j)
    for (int p = 0; p < E::PASSES; ++p)
      for (int r = 0; r < E::NR; ++r) acc[j][p][r] = 0.f;
  wgmma_fence();
  E::run(acc, base, base + dy_off, i, 1);
  wgmma_commit();
  wgmma_wait<0>();
  for (int j = 0; j < 3; ++j)
    for (int p = 0; p < E::PASSES; ++p)
      store_tile<CG>(acc[j][p], out + (j * E::PASSES + p) * 64 * CG);
}

bool report(const char* what, const std::vector<float>& got,
            const std::vector<double>& want) {
  double err = 0, big = 0;
  for (size_t k = 0; k < want.size(); ++k) {
    err = fmax(err, fabs(got[k] - want[k]));
    big = fmax(big, fabs(want[k]));
  }
  const bool ok = err <= 1e-4 * fmax(big, 1.0);
  printf("%s: max |wgmma - host| %.3g, max |host| %.3g: %s\n", what, err,
         big, ok ? "ok" : "MISMATCH");
  return ok;
}

template <int N>
bool raw_check(bool as_designed) {
  // A (m, k) and B (k, n) in the slab layout; B after A
  const int a_bytes = 8 * SLAB_PLANE, b_off = a_bytes;
  const int bytes = b_off + (N / 8) * SLAB_PLANE;
  std::vector<uint16_t> img(bytes / 2, 0);
  std::vector<float> A(64 * 16), B(16 * N);
  for (int m = 0; m < 64; ++m)
    for (int k = 0; k < 16; ++k) {
      const uint16_t v = to_bf((float)(rand() % 17 - 8) / 8.f);
      A[m * 16 + k] = bf(v);
      img[((m / 8) * SLAB_PLANE + (k / 8) * K_STRIDE + (k % 8) * 16 +
           (m % 8) * 2) / 2] = v;
    }
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < N; ++n) {
      const uint16_t v = to_bf((float)(rand() % 17 - 8) / 8.f);
      B[k * N + n] = bf(v);
      img[(b_off + (n / 8) * SLAB_PLANE + (k / 8) * K_STRIDE + (k % 8) * 16 +
           (n % 8) * 2) / 2] = v;
    }
  std::vector<double> want(64 * N, 0.0);
  for (int m = 0; m < 64; ++m)
    for (int n = 0; n < N; ++n)
      for (int k = 0; k < 16; ++k)
        want[m * N + n] += (double)A[m * 16 + k] * B[k * N + n];
  uint4* dimg;
  float* dout;
  cudaMalloc(&dimg, bytes);
  cudaMalloc(&dout, 64 * N * 4);
  cudaMemcpy(dimg, img.data(), bytes, cudaMemcpyHostToDevice);
  cudaFuncSetAttribute(raw_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const uint32_t lbo = as_designed ? K_STRIDE : SLAB_PLANE;
  const uint32_t sbo = as_designed ? SLAB_PLANE : K_STRIDE;
  raw_kernel<N><<<1, 128, SMEM>>>(dimg, bytes / 16, b_off, lbo, sbo, dout);
  const cudaError_t e = cudaDeviceSynchronize();
  std::vector<float> got(64 * N);
  cudaMemcpy(got.data(), dout, 64 * N * 4, cudaMemcpyDeviceToHost);
  cudaFree(dimg);
  cudaFree(dout);
  char what[160];
  snprintf(what, sizeof what,
           "raw m64n%dk16 MN-major, LBO = %s, SBO = %s (%s)", N,
           as_designed ? "along K" : "along M/N",
           as_designed ? "along M/N" : "along K", cudaGetErrorString(e));
  return report(what, got, want) && e == cudaSuccess;
}

template <int CI, int CG>
bool engine_check(int i) {
  using E = DwEngine<CI, CG, 1>;
  using XS = typename E::XSlab;
  using DS = typename E::DySlab;
  const int dy_off = XS::BYTES, bytes = XS::BYTES + DS::BYTES;
  std::vector<uint16_t> img(bytes / 2, 0);
  // x[hx][hy][hz][c] and dy likewise, random, written into their slabs
  auto fill = [&](int off, int G, int planes, std::vector<float>& v) {
    v.assign(HX * HY * planes * G * 8, 0.f);
    for (int hx = 0; hx < HX; ++hx)
      for (int hy = 0; hy < HY; ++hy)
        for (int hz = 0; hz < planes; ++hz)
          for (int c = 0; c < G * 8; ++c) {
            const uint16_t b = to_bf((float)(rand() % 17 - 8) / 8.f);
            v[((hx * HY + hy) * planes + hz) * G * 8 + c] = bf(b);
            img[(off + (hz * G + c / 8) * SLAB_PLANE + (hx * HY + hy) * 16 +
                 (c % 8) * 2) / 2] = b;
          }
  };
  std::vector<float> xv, dv;
  fill(0, CI / 8, 4, xv);
  fill(dy_off, CG / 8, 3, dv);
  std::vector<double> want(3 * E::PASSES * 64 * CG, 0.0);
  for (int j = 0; j < 3; ++j)
    for (int p = 0; p < E::PASSES; ++p)
      for (int r = 0; r < 64; ++r) {
        const int k = E::ZT * p + r / CI, ci = r % CI;
        for (int co = 0; co < CG; ++co) {
          double s = 0;
          for (int vx = 0; vx < 8; ++vx)
            for (int vy = 0; vy < 8; ++vy)
              s += (double)xv[(((vx + i) * HY + vy + j) * 4 + k) * CI + ci] *
                   dv[(((vx + 1) * HY + vy + 1) * 3 + 1) * CG + co];
          want[((j * E::PASSES + p) * 64 + r) * CG + co] = s;
        }
      }
  uint4* dimg;
  float* dout;
  cudaMalloc(&dimg, bytes);
  cudaMalloc(&dout, want.size() * 4);
  cudaMemcpy(dimg, img.data(), bytes, cudaMemcpyHostToDevice);
  cudaFuncSetAttribute(engine_kernel<CI, CG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  engine_kernel<CI, CG><<<1, 128, SMEM>>>(dimg, bytes / 16, dy_off, i, dout);
  const cudaError_t e = cudaDeviceSynchronize();
  std::vector<float> got(want.size());
  cudaMemcpy(got.data(), dout, want.size() * 4, cudaMemcpyDeviceToHost);
  cudaFree(dimg);
  cudaFree(dout);
  char what[160];
  snprintf(what, sizeof what, "DwEngine<CI=%d, CG=%d, MT=1> taps (%d, j, k) (%s)",
           CI, CG, i, cudaGetErrorString(e));
  return report(what, got, want) && e == cudaSuccess;
}

}  // namespace

int main() {
  srand(7);
  bool ok = true;
  ok &= raw_check<16>(true);
  ok &= raw_check<32>(true);
  ok &= raw_check<64>(true);
  raw_check<16>(false);  // the other assignment, for the record
  for (int i = 0; i < 3; ++i) {
    ok &= engine_check<16, 16>(i);
    ok &= engine_check<16, 32>(i);
    ok &= engine_check<32, 16>(i);
    ok &= engine_check<32, 32>(i);
  }
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s: %s\n", prop.name, ok ? "all checks pass" : "FAILED");
  return ok ? 0 : 1;
}
