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

constexpr int kMaxTris = 1024;
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    k_dense_closest(const float* __restrict__ rays, long long stride, int m,
                    const float* __restrict__ tri, int f, float* __restrict__ t_out,
                    int* __restrict__ prim_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  __shared__ float s_tri[9 * kMaxTris];
  for (int k = threadIdx.x; k < 9 * f; k += blockDim.x) {
    int r = k / f;
    int c = k - r * f;
    s_tri[r * kMaxTris + c] = tri[k];
  }
  __syncthreads();

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
      float v0x = s_tri[0 * kMaxTris + s], v0y = s_tri[1 * kMaxTris + s];
      float v0z = s_tri[2 * kMaxTris + s];
      float e1x = s_tri[3 * kMaxTris + s], e1y = s_tri[4 * kMaxTris + s];
      float e1z = s_tri[5 * kMaxTris + s];
      float e2x = s_tri[6 * kMaxTris + s], e2y = s_tri[7 * kMaxTris + s];
      float e2z = s_tri[8 * kMaxTris + s];
      float px = dy * e2z - dz * e2y;
      float py = dz * e2x - dx * e2z;
      float pz = dx * e2y - dy * e2x;
      float det = e1x * px + e1y * py + e1z * pz;
      bool ok_det = fabsf(det) > 1e-12f;
      float inv_det = ok_det ? 1.0f / det : 0.0f;
      float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      float u = (tx * px + ty * py + tz * pz) * inv_det;
      float qx = ty * e1z - tz * e1y;
      float qy = tz * e1x - tx * e1z;
      float qz = tx * e1y - ty * e1x;
      float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      bool valid = ok_det && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 0.0f);
      // strict <: on equal t the lowest prim index wins
      if (valid && t < best_t) {
        best_t = t;
        best = s;
        bu = u;
        bv = v;
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
  if (f < 1 || f > kMaxTris || m < 1) return (int)cudaErrorInvalidValue;
  k_dense_closest<<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(rays, stride, m, tri, f, t, prim,
                                                                   u, v);
  return (int)cudaGetLastError();
}
