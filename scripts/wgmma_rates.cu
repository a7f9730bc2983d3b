// Rates of Hopper's wgmma.mma_async m64nNk16 (bf16 in, f32 out) on one
// SM, by N, by the source of A (shared memory by descriptor, "SS", or
// registers, "RS"), by the number of independent accumulator tiles a
// warpgroup rotates over (MT) and by the warpgroups resident on the SM.
// The design of bcp_tpu_torch/kernels/csrc/conv3x3x3.cu rests on what it
// prints: one warpgroup gets a wgmma through every 60-90 cycles whatever N
// and MT, and only about four warpgroups per SM reach the shared-memory
// bound (20, 24, 32 cycles at N = 16, 32, 64 in SS mode); layout pitches and
// swizzle modes do not change the rate. The operands are whatever shared
// memory holds: this measures time, not results.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//         -o wgmma_rates scripts/wgmma_rates.cu
//     ./wgmma_rates
//
// Each line: cycles (clock64) per wgmma per SM, 132 CTAs, 20 groups of
// 27 * MT wgmma per warpgroup, beside the tensor cores' N/2.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template<int N, int RS> struct W;
template<> struct W<16,0> { __device__ static __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) : "l"(a), "l"(b), "r"(1)); } };
template<> struct W<16,1> { __device__ static __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(b), "r"(1)); } };
template<> struct W<32,0> { __device__ static __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) : "l"(a), "l"(b), "r"(1)); } };
template<> struct W<32,1> { __device__ static __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(b), "r"(1)); } };
template<> struct W<64,0> { __device__ static __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) : "l"(a), "l"(b), "r"(1)); } };
template<> struct W<64,1> { __device__ static __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(b), "r"(1)); } };
template<> struct W<128,0> { __device__ static __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) : "l"(a), "l"(b), "r"(1)); } };
template<> struct W<128,1> { __device__ static __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, const uint32_t (&r)[4]) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(b), "r"(1)); } };
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swz) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
}
// each warpgroup starts `iters` groups of 27 * MT wgmma, round robin over MT
// independent accumulator tiles, then waits
template<int N, int RS, int MT>
__global__ void bench(long long* out, int iters, int per, int ashift, int asbo, int bsbo, int swz) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float d[MT][N/2];
  for (int m = 0; m < MT; ++m) for (int i = 0; i < N/2; ++i) d[m][i] = 0.f;
  uint32_t r[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int wg = threadIdx.x >> 7;
  const uint64_t a0 = desc(base + wg * 16384, 8192, asbo, swz);
  const uint64_t b0 = desc(base + 65536, N * 16, bsbo, swz);
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    #pragma unroll
    for (int k = 0; k < 27; ++k)
      #pragma unroll
      for (int m = 0; m < MT; ++m)
        W<N,RS>::run(d[m], a0 + (uint64_t)(((k % 9) * ashift + m * 2048) >> 4), b0 + (uint64_t)((k % 3) * 2 * N), r);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  long long t1 = clock64();
  float s = 0; for (int m = 0; m < MT; ++m) for (int i = 0; i < N/2; ++i) s += d[m][i];
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
  if (s == 123.456f) out[0] = 0;
}
template<int N, int RS, int MT>
void run(const char* name, int wgs, int ashift, int asbo, int bsbo, int swz) {
  long long* out; cudaMalloc(&out, 1024 * 8);
  auto k = bench<N, RS, MT>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000);
  const int iters = 20;
  k<<<132, 128 * wgs, 200000>>>(out, iters, 0, ashift, asbo, bsbo, swz);
  k<<<132, 128 * wgs, 200000>>>(out, iters, 0, ashift, asbo, bsbo, swz);
  const cudaError_t refused = cudaGetLastError();
  cudaError_t e = cudaDeviceSynchronize();
  if (refused != cudaSuccess) {  // 4 warpgroups leave 128 registers a thread
    printf("%s N=%d %s MT=%d wgs=%d: not launched (%s)\n", name, N, RS ? "RS" : "SS", MT, wgs, cudaGetErrorString(refused));
    cudaFree(out);
    return;
  }
  long long h[132]; cudaMemcpy(h, out, 132 * 8, cudaMemcpyDeviceToHost);
  double cyc = (double)h[5] / (iters * 27 * MT * wgs);
  printf("%s N=%d %s MT=%d wgs=%d ashift=%d asbo=%d bsbo=%d swz=%d: %.1f cycles per wgmma per SM (ideal %.1f) err=%d\n", name, N, RS ? "RS" : "SS", MT, wgs, ashift, asbo, bsbo, swz, cyc, N / 2.0, (int)e);
  cudaFree(out);
}
#define ROW(N, RS, wgs) run<N,RS,1>("", wgs, 16, 160, 128, 0); run<N,RS,2>("", wgs, 16, 160, 128, 0); run<N,RS,4>("", wgs, 16, 160, 128, 0);
int main() {
  for (int wgs = 1; wgs <= 4; wgs *= 2) {
    ROW(16, 0, wgs) ROW(32, 0, wgs) ROW(64, 0, wgs) ROW(16, 1, wgs) ROW(64, 1, wgs)
  }
  run<64,0,2>("a128", 2, 0, 128, 128, 0); run<64,0,2>("a144", 2, 16, 144, 128, 0);
  run<64,0,2>("b144", 2, 16, 160, 144, 0);
  run<64,0,2>("swz128", 2, 0, 1024, 1024, 1); run<64,0,2>("swz64", 2, 0, 512, 512, 2); run<64,0,2>("swz32", 2, 0, 256, 256, 3);
  run<16,0,4>("swz32", 2, 0, 256, 256, 3); run<32,0,4>("swz32", 2, 0, 256, 256, 3); run<16,0,4>("swz32", 4, 0, 256, 256, 3);
  run<128,0,2>("swz128", 2, 0, 1024, 1024, 1); run<128,0,2>("noswz", 2, 16, 160, 128, 0); run<128,0,1>("noswz", 2, 16, 160, 128, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  return 0;
}
