// Dense closest-hit: every ray against every triangle.
//
// Replaces fredholm_tpu/accel/pallas_dense.py `_closest_kernel` (via
// `_closest_call`; entry `intersect_closest_pallas_c`). Plain twin:
// fredholm_tpu_torch/accel/dense.py `intersect_closest_twin`.
//
// Contract: Moller-Trumbore with |det| > 1e-12, u, v >= 0, u + v <= 1 and
// t > 0; a strict t < best_t from tmax, so on an equal t the lowest prim
// wins; a miss or a dead lane (tmax <= 0) gives prim -1, t = tmax, u = v = 0.
//
// Bound on the H100, the larger of two terms. Bytes: a dead ray reads its
// tmax (4 B), a live one 28 B, and every ray writes 16 B. Operations: ~40
// float operations a live ray-triangle pair over the card's 67 TFLOP/s.
// On metric 1's d = 1 bounce buffer ([7, 1,048,576] rays, 58% live, 36
// triangles) they are 0.011 ms and 0.013 ms; at d >= 2 (fewer live rays)
// bytes lead. The build is -fmad=false, so every product and sum issues on
// its own, and the operation term at the unfused rate (half) is twice that.
//
// The design, for what held the first one (one thread a ray, a static 36 KB
// SoA table; each step measured in turns against it, PERF.md):
// - Live rays are compacted inside each block (a warp ballot, prefix counts
//   over the block's warps, a shared list of live lanes), so the warps that
//   sweep hold live rays only: a block's sweep costs its live warps, not
//   its 8. Dead lanes write their outputs at once, and a block with no live
//   ray stages nothing. This took the d >= 1 bounces from ~0.08 ms to
//   0.03-0.07 ms; at d = 0, where every ray is live, it changes nothing.
// - Triangles are 16-byte records (v0, e1, e2, each padded to four floats)
//   in dynamic shared memory sized to F (48 B a triangle: 1.7 KB for the
//   Cornell box, 48 KB at the 1024-face limit, no opt-in), read as three
//   broadcast 16-byte loads; the live list shares the buffer before the
//   records are staged.
// - Every pair takes the whole test, operation for operation as the twin
//   (common.cuh moller_trumbore), so the results are bit-equal to it. An
//   exact early reject (det's sign against the u, v and t numerators, with
//   care for signed zero, underflow and NaN) was measured: equal at d = 0,
//   1.2-1.6x slower at d >= 1. The sweep issues ~100 instructions a pair,
//   and the divergent branches cost more than the divides they skip.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// the live list and the warps' counts, before the records take the buffer
constexpr int kListBytes = (kBlock + kWarps) * 4;

__host__ __device__ constexpr int smem_bytes(int f) {
  return 48 * f > kListBytes ? 48 * f : kListBytes;
}

__global__ void __launch_bounds__(kBlock)
    k_dense_closest(const float* __restrict__ rays, long long stride, int m,
                    const float* __restrict__ tri, int f, float* __restrict__ t_out,
                    int* __restrict__ prim_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  extern __shared__ float4 s_buf[];
  int* s_list = reinterpret_cast<int*>(s_buf);
  int* s_count = s_list + kBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kBlock;

  // ---- compact the block's live lanes
  const long long i = base + threadIdx.x;
  const float tmax = i < m ? rays[6 * stride + i] : -1.0f;
  const bool live = tmax > 0.0f;
  if (i < m && !live) {
    t_out[i] = tmax;
    prim_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (live) s_list[offset + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();
  if (total == 0) return;  // the whole block: no live ray, nothing to stage
  const int mine = (int)threadIdx.x < total ? s_list[threadIdx.x] : -1;
  __syncthreads();  // the list is read; the records take the buffer

  // ---- stage the triangle records
  for (int k = threadIdx.x; k < f; k += kBlock) {
    s_buf[3 * k] = make_float4(tri[k], tri[f + k], tri[2 * f + k], 0.0f);
    s_buf[3 * k + 1] = make_float4(tri[3 * f + k], tri[4 * f + k], tri[5 * f + k], 0.0f);
    s_buf[3 * k + 2] = make_float4(tri[6 * f + k], tri[7 * f + k], tri[8 * f + k], 0.0f);
  }
  __syncthreads();
  if (mine < 0) return;

  // ---- sweep: the warps hold live rays only
  const long long j = base + mine;
  const float ox = rays[j], oy = rays[stride + j], oz = rays[2 * stride + j];
  const float dx = rays[3 * stride + j], dy = rays[4 * stride + j], dz = rays[5 * stride + j];
  float best_t = rays[6 * stride + j];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
#pragma unroll 2
  for (int s = 0; s < f; ++s) {
    const float4 v0 = s_buf[3 * s];
    const float4 e1 = s_buf[3 * s + 1];
    const float4 e2 = s_buf[3 * s + 2];
    MtHit h = moller_trumbore(ox, oy, oz, dx, dy, dz, v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x,
                              e2.y, e2.z);
    // strict <: on equal t the lowest prim index wins
    if (h.valid && h.t < best_t) {
      best_t = h.t;
      best = s;
      bu = h.u;
      bv = h.v;
    }
  }
  t_out[j] = best_t;  // tmax on a miss
  prim_out[j] = best;
  u_out[j] = bu;
  v_out[j] = bv;
}

}  // namespace

extern "C" int fh_dense_closest(const float* rays, long long stride, int m, const float* tri, int f,
                                float* t, int* prim, float* u, float* v, cudaStream_t stream) {
  if (f < 1 || f > kDenseMaxTris || m < 1) return (int)cudaErrorInvalidValue;
  k_dense_closest<<<(m + kBlock - 1) / kBlock, kBlock, smem_bytes(f), stream>>>(rays, stride, m,
                                                                               tri, f, t, prim, u, v);
  return (int)cudaGetLastError();
}
