// Dense any-hit: does any triangle lie on each ray below its tmax?
//
// Replaces fredholm_tpu/accel/pallas_dense.py `_any_kernel` (via `_any_call`;
// entries `intersect_any_pallas` and `intersect_any_pallas_c`). Plain twin:
// fredholm_tpu_torch/accel/dense.py `intersect_any_twin`.
//
// occluded[i] = some triangle s has a valid Moller-Trumbore hit with
// 0 < t < tmax[i]; a dead lane (tmax <= 0) gives false. K1's design: one
// thread per ray, each 256-thread block stages the 9 x F triangle SoA in
// shared memory once (the staging and the test are K1's, common.cuh), and
// every thread reads each triangle as a broadcast. The reference sweeps all
// F triangles; a lane here stops at its first occluder, which gives the
// same answer.
//
// Bounds on the H100, at the shapes of the wavefront integrator's NEE trace
// (the sky and area blocks of a 512^2 bounce, 524,288 rays, 36 triangles):
// bytes. A dead ray reads 4 B, a live one 28 B, and each ray writes 1 B
// (about 7 MB, 0.002 ms at 3.35 TB/s), against ~40 flops a triangle test
// up to each lane's first occluder. chip_smoke.py computes both from the
// run's rays and reports the kernel's time beside them.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    k_dense_any(const float* __restrict__ rays, long long stride, int m,
                const float* __restrict__ tri, int f, unsigned char* __restrict__ occ_out) {
  __shared__ float s_tri[9 * kDenseMaxTris];
  stage_tri_soa(s_tri, tri, f);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float tmax = rays[6 * stride + i];
  bool occluded = false;
  if (tmax > 0.0f) {
    float ox = rays[i], oy = rays[stride + i], oz = rays[2 * stride + i];
    float dx = rays[3 * stride + i], dy = rays[4 * stride + i], dz = rays[5 * stride + i];
    for (int s = 0; s < f && !occluded; ++s) {
      MtHit h = mt_staged(s_tri, s, ox, oy, oz, dx, dy, dz);
      occluded = h.valid && h.t < tmax;
    }
  }
  occ_out[i] = occluded ? 1 : 0;
}

}  // namespace

extern "C" int fh_dense_any(const float* rays, long long stride, int m, const float* tri, int f,
                            unsigned char* occ, cudaStream_t stream) {
  if (f < 1 || f > kDenseMaxTris || m < 1) return (int)cudaErrorInvalidValue;
  k_dense_any<<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(rays, stride, m, tri, f, occ);
  return (int)cudaGetLastError();
}
