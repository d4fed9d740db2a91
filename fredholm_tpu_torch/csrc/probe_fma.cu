// FMA-chain throughput probe (P1), in float32 and bfloat16.
//
// Replaces tools/probe_bf16.py `make_fma_kernel` (the reference's probe of
// its chip's vector FMA rate). Plain twin:
// fredholm_tpu_torch/tools/probe_bf16.py `fma_chain_twin`.
//
// One thread per element (float32) or per pair of elements (bfloat16, as
// __nv_bfloat162: the reference's bf16 tiles hold twice the elements of
// its f32 ones). kChains independent accumulators seeded x + k, each
// taking kUnroll / kChains + kInner - 1 steps a <- a * c + d as one fused
// multiply-add (fmaf, __hfma2), then summed in chain order. The chains hide
// the FMA latency, so the kernel is bound by the card's FMA issue rate:
// 2 * (kUnroll + (kInner - 1) * kChains) flops an element (the reference's
// count) against 4 or 2 bytes read and written.
#include <cuda_bf16.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 512;
constexpr int kInner = 8;
constexpr int kSteps = kUnroll / kChains + kInner - 1;

__global__ void __launch_bounds__(kBlock)
    k_fma_f32(const float* __restrict__ x, float* __restrict__ out, long long n, float c,
              float d) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = xi + (float)k;
#pragma unroll 8
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) a[k] = fmaf(a[k], c, d);
  }
  float o = a[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) o = o + a[k];
  out[i] = o;
}

__global__ void __launch_bounds__(kBlock)
    k_fma_bf16(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out,
               long long n2, float c, float d) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 xi = x[i];
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c), d2 = __float2bfloat162_rn(d);
  __nv_bfloat162 a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = __hadd2(xi, __float2bfloat162_rn((float)k));
#pragma unroll 8
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) a[k] = __hfma2(a[k], c2, d2);
  }
  __nv_bfloat162 o = a[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) o = __hadd2(o, a[k]);
  out[i] = o;
}

}  // namespace

// n elements of x into out; bf16 != 0: both are bfloat16 and n is even.
// c and d are the chain's constants, already rounded to the element type.
extern "C" int fh_probe_fma(const void* x, void* out, long long n, int bf16, float c, float d,
                            cudaStream_t stream) {
  if (n < 1 || (bf16 && n % 2)) return (int)cudaErrorInvalidValue;
  const long long lanes = bf16 ? n / 2 : n;
  const long long grid = (lanes + kBlock - 1) / kBlock;
  if (bf16)
    k_fma_bf16<<<grid, kBlock, 0, stream>>>(static_cast<const __nv_bfloat162*>(x),
                                           static_cast<__nv_bfloat162*>(out), lanes, c, d);
  else
    k_fma_f32<<<grid, kBlock, 0, stream>>>(static_cast<const float*>(x),
                                          static_cast<float*>(out), lanes, c, d);
  return (int)cudaGetLastError();
}
