// Dense any-hit: does any triangle lie on each ray below its tmax?
//
// Replaces fredholm_tpu/accel/pallas_dense.py `_any_kernel` (via `_any_call`;
// entries `intersect_any_pallas` and `intersect_any_pallas_c`). Plain twin:
// fredholm_tpu_torch/accel/dense.py `intersect_any_twin`.
//
// occluded[i] = some triangle s has a valid Moller-Trumbore hit with
// 0 < t < tmax[i]; a dead lane (tmax <= 0) gives false. The reference sweeps
// all F triangles; a lane here stops at its first occluder, in triangle
// index order, which gives the same answer.
//
// Bound on the H100, the larger of two terms. Operations: ~40 float
// operations a ray-triangle test, counted in the kernel's order (index
// order) up to each live lane's first occluder, over 67 TFLOP/s; the build
// is -fmad=false, so every product and sum issues on its own, and the
// unfused term, at half that rate, is the one the kernel can reach. Bytes:
// a dead ray reads its tmax (4 B), a live one 28 B, and every ray writes
// 1 B. At the wavefront's NEE trace (the sky and area blocks of a 512^2
// bounce: 524,288 rays, 36 triangles, ~11.7 M tests at d = 0) operations
// lead: 0.0070 ms, 0.0140 unfused, against ~0.004 ms of bytes.
// chip_smoke.py [12] counts both from each bounce's rays.
//
// The design, for what held the first one (one thread a ray in launch
// order, a static 36 KB SoA table read with nine scalar loads a test; each
// step measured in turns against it, PERF.md):
// - Live rays are packed inside each block (a warp ballot, prefix counts
//   over the block's warps, a shared list of live lanes), as B1 does: dead
//   lanes write false at once and hold no thread of the sweep, and a block
//   with no live ray stages nothing. A live ray's origin, tmax and
//   direction go to shared memory as two 16-byte records.
// - Triangles are 16-byte records (v0, e1, e2, each padded to four floats)
//   in dynamic shared memory sized to F, read as three broadcast 16-byte
//   loads a test.
// - A warp runs as long as its slowest lane, and the lanes of a bounce
//   split: a sky ray mostly stops at a wall among the first triangles,
//   while one that leaves the scene, or an unoccluded light ray, tests all
//   F. So a block with more than kPackAbove live lanes packs those still
//   searching once more, after their first kFirst triangles. A lane's tests
//   and their order do not change. Packing after every chunk, or in blocks
//   with fewer live lanes, measured slower: the barriers cost more than the
//   idle lanes they save.
// - Each test is moller_trumbore's (common.cuh) operation for operation,
//   except that the divide is taken whatever det is (`occludes`): the
//   branch around it cost more than the divide. The masks are the twin's
//   bit for bit. With -fmad=false and the IEEE divide (a reciprocal, its
//   refinement and a range check), a test issues well over the 40 float
//   operations the bound counts, so the kernel stays above that bound.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// A block with more than kPackAbove live lanes packs those still searching
// once, after their first kFirst triangles
constexpr int kPackAbove = 128;
constexpr int kFirst = 8;

// the triangle records, the block's rays, its lane list and the warps' counts
__host__ __device__ constexpr int smem_bytes(int f) {
  return 48 * f + 32 * kBlock + 4 * (kBlock + kWarps);
}

// Packs the ids of the block's threads whose `keep` holds into s_list, in
// thread order, and returns how many there are. Every thread of the block
// calls it; it ends in a barrier.
__device__ __forceinline__ int pack(bool keep, int id, int* s_list, int* s_count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (keep) s_list[offset + __popc(ballot & ((1u << lane) - 1u))] = id;
  __syncthreads();
  return total;
}

// Whether triangle (v0, e1, e2) occludes the ray (o, d) below tmax: common.cuh
// moller_trumbore's operations, with the divide taken whatever det is. Where
// |det| <= 1e-12 the twin's hit is invalid whatever u, v and t are, and
// elsewhere both divide alike, so the answer is the twin's.
__device__ __forceinline__ bool occludes(float4 o, float4 d, float4 v0, float4 e1, float4 e2) {
  const float px = d.y * e2.z - d.z * e2.y;
  const float py = d.z * e2.x - d.x * e2.z;
  const float pz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float inv_det = 1.0f / det;
  const float tx = o.x - v0.x, ty = o.y - v0.y, tz = o.z - v0.z;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
         t < o.w;
}

__global__ void __launch_bounds__(kBlock)
    k_dense_any(const float* __restrict__ rays, long long stride, int m,
                const float* __restrict__ tri, int f, unsigned char* __restrict__ occ_out) {
  extern __shared__ float4 s_buf[];
  float4* s_tri = s_buf;          // 3 f records
  float4* s_ray = s_tri + 3 * f;  // 2 a lane: (o, tmax), (d, 0)
  int* s_list = reinterpret_cast<int*>(s_ray + 2 * kBlock);
  int* s_count = s_list + kBlock;
  const long long base = (long long)blockIdx.x * kBlock;

  // ---- pack the block's live lanes; their rays go to shared memory
  const long long i = base + threadIdx.x;
  const float tmax = i < m ? rays[6 * stride + i] : -1.0f;
  const bool live = tmax > 0.0f;
  if (i < m && !live) occ_out[i] = 0;
  if (live) {
    s_ray[2 * threadIdx.x] = make_float4(rays[i], rays[stride + i], rays[2 * stride + i], tmax);
    s_ray[2 * threadIdx.x + 1] =
        make_float4(rays[3 * stride + i], rays[4 * stride + i], rays[5 * stride + i], 0.0f);
  }
  int n = pack(live, threadIdx.x, s_list, s_count);
  if (n == 0) return;  // the whole block: no live ray, nothing to stage

  // ---- stage the triangle records
  for (int k = threadIdx.x; k < f; k += kBlock) {
    s_tri[3 * k] = make_float4(tri[k], tri[f + k], tri[2 * f + k], 0.0f);
    s_tri[3 * k + 1] = make_float4(tri[3 * f + k], tri[4 * f + k], tri[5 * f + k], 0.0f);
    s_tri[3 * k + 2] = make_float4(tri[6 * f + k], tri[7 * f + k], tri[8 * f + k], 0.0f);
  }
  __syncthreads();

  // ---- sweep; a full block packs its searching lanes after kFirst triangles
  for (int s = 0, end = n > kPackAbove ? min(kFirst, f) : f;; s = end, end = f) {
    const int id = (int)threadIdx.x < n ? s_list[threadIdx.x] : -1;
    bool searching = false;
    if (id >= 0) {
      const float4 o = s_ray[2 * id];
      const float4 d = s_ray[2 * id + 1];
      bool occluded = false;
      for (int k = s; k < end && !occluded; ++k)
        occluded = occludes(o, d, s_tri[3 * k], s_tri[3 * k + 1], s_tri[3 * k + 2]);
      if (occluded || end == f)
        occ_out[base + id] = occluded ? 1 : 0;
      else
        searching = true;
    }
    if (end == f) break;  // every lane has written its result
    n = pack(searching, id, s_list, s_count);
    if (n == 0) break;
  }
}

}  // namespace

extern "C" int fh_dense_any(const float* rays, long long stride, int m, const float* tri, int f,
                            unsigned char* occ, cudaStream_t stream) {
  if (f < 1 || f > kDenseMaxTris || m < 1) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(f);
  if (bytes > 48 * 1024) {  // past the default: opt in (F > 843)
    const cudaError_t e =
        cudaFuncSetAttribute(k_dense_any, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  k_dense_any<<<(m + kBlock - 1) / kBlock, kBlock, bytes, stream>>>(rays, stride, m, tri, f, occ);
  return (int)cudaGetLastError();
}
