// Dense closest-hit: every ray against every triangle.
//
// Replaces fredholm_tpu/accel/pallas_dense.py `_closest_kernel` (via
// `_closest_call`; entry `intersect_closest_pallas_c`). Plain twin:
// fredholm_tpu_torch/accel/dense.py `intersect_closest_twin`.
//
// One thread per ray; each 256-thread block stages the triangle SoA
// (9 x F floats, 36 KB at the 1024-face limit) into shared memory once,
// then every thread sweeps all F triangles with Moller-Trumbore, reading
// each triangle as a broadcast (all lanes of a warp read the same word).
// Bounds on the H100: compute, about 30 flops per ray-triangle test, so
// N*F*30 flops per call (1M rays x 36 triangles is ~1 GFLOP, a few tens of
// microseconds); device memory traffic is the ray buffer once in (28 B a
// ray) and the hit planes once out (16 B a ray). Dead lanes (tmax <= 0)
// skip the sweep but still take part in the block's staging barrier.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    k_dense_closest(const float* __restrict__ rays, long long stride, int m,
                    const float* __restrict__ tri, int f, float* __restrict__ t_out,
                    int* __restrict__ prim_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  __shared__ float s_tri[9 * kDenseMaxTris];
  stage_tri_soa(s_tri, tri, f);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float tmax = rays[6 * stride + i];
  float best_t = tmax;
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  if (tmax > 0.0f) {
    float ox = rays[i], oy = rays[stride + i], oz = rays[2 * stride + i];
    float dx = rays[3 * stride + i], dy = rays[4 * stride + i], dz = rays[5 * stride + i];
    for (int s = 0; s < f; ++s) {
      MtHit h = mt_staged(s_tri, s, ox, oy, oz, dx, dy, dz);
      // strict <: on equal t the lowest prim index wins
      if (h.valid && h.t < best_t) {
        best_t = h.t;
        best = s;
        bu = h.u;
        bv = h.v;
      }
    }
  }
  t_out[i] = best_t;  // tmax on a miss or a dead lane
  prim_out[i] = best;
  u_out[i] = bu;
  v_out[i] = bv;
}

}  // namespace

extern "C" int fh_dense_closest(const float* rays, long long stride, int m, const float* tri, int f,
                                float* t, int* prim, float* u, float* v, cudaStream_t stream) {
  if (f < 1 || f > kDenseMaxTris || m < 1) return (int)cudaErrorInvalidValue;
  k_dense_closest<<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(rays, stride, m, tri, f, t, prim,
                                                                   u, v);
  return (int)cudaGetLastError();
}
