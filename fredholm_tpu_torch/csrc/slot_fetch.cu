// Hit-attribute fetch keyed by traversal slot.
//
// Replaces fredholm_tpu/fused/slot_fetch.py `_make_kernel` (via `_call`,
// entry `fetch_geom_by_slot`). Plain twin:
// fredholm_tpu_torch/fused/slot_fetch.py `fetch_twin`.
//
//   out[a, i] = 0 <= slot[i] < n_slots ? rows[slot[i]][a] : 0,  a < 26
//
// The table is slot-major, rows [S, 32] float32 (scene/device.py uploads
// fused/slot_fetch.py `slot_rows`): a slot's 26 words and 6 pad words make
// one 128-byte row on a 128-byte boundary. The reference keeps the table
// plane-major, [32, S] (fredholm_tpu/fused/slot_fetch.py:9-12), because its
// kernel DMAs a cluster's whole 16 KB block into VMEM. Here each lane
// gathers its own slot, and in a plane-major table each of a hit's 26
// words lies in a 32-byte sector of its own: 26 sectors a hit, from device
// memory once the table outgrows the 50 MB L2 (a 10.4M-triangle instanced
// scene's holds 83 MB). A hit lane reads its row with six 16-byte loads
// and one 8-byte load, words 0-25: 104 B in 4 sectors. The planes out stay
// plane-major, [26, N]: lane i writes column i, so each store is coalesced
// across the warp.
// Bounds on the H100: bytes. Per lane it reads 4 B of slot and writes
// 104 B; each distinct hit slot's 104 B are read once.
//
// k_slot_fetch_inst (instanced scenes) is the same gather followed by the
// hit-attribute transform of fredholm_tpu/fused/pt_fused.py
// `_xform_attrs_cols` (called from `_gather_attrs`), which the reference
// runs as jnp after its fetch; plain twin: fused/slot_fetch.py
// `fetch_inst_twin`. The table holds object-space geometry; each lane
// reads its instance's row of inst_table [I, 24] (96 B, six 16-byte loads;
// cols 0-11 the object-to-world affine rows, 12-20 the normal matrix, the
// instance id clamped to [0, I)) and writes world-space planes: the three
// vertices by the affine rows, the three normals by the normal matrix then
// times 1 / sqrt(max(|n|^2, 1e-24)), the area from the moved vertices.
// Every lane, misses included (inst 0 and zero planes), as the reference
// does. The products and sums run in the twin's order, one rounding each
// (-fmad=false). The lane writes the planes the transform leaves alone
// (uv, mat_id) as soon as its row arrives, and each moved group as soon as
// it is done, so that fewer words stay live in registers. Bounds on the
// H100: bytes, as the plain fetch, plus 4 B of inst a lane (the rows of
// the instances stay in L1).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kAttrs = 26;
constexpr int kRowWords = 32;
constexpr int kInstCols = 24;

// words 0-25 of slot s's 128-byte row (4 sectors), or zeros for a miss
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int s, bool hit,
                                         float g[kAttrs]) {
  if (hit) {
    const float4* r = reinterpret_cast<const float4*>(rows + (long long)s * kRowWords);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = __ldg(r + q);
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
    const float2 t = __ldg(reinterpret_cast<const float2*>(r + 6));
    g[24] = t.x;
    g[25] = t.y;
  } else {
#pragma unroll
    for (int a = 0; a < kAttrs; ++a) g[a] = 0.0f;
  }
}

__global__ void __launch_bounds__(kBlock)
    k_slot_fetch(const int* __restrict__ slot, int n, const float* __restrict__ rows,
                 long long n_slots, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot[i];
  float g[kAttrs];
  load_row(rows, s, s >= 0 && s < n_slots, g);
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) out[(long long)a * n + i] = g[a];
}

__device__ __forceinline__ float affine(const float* r, float x, float y, float z) {
  return r[0] * x + r[1] * y + r[2] * z + r[3];
}

__device__ __forceinline__ float linear(const float* r, float x, float y, float z) {
  return r[0] * x + r[1] * y + r[2] * z;
}

__global__ void __launch_bounds__(kBlock)
    k_slot_fetch_inst(const int* __restrict__ slot, const int* __restrict__ inst, int n,
                      const float* __restrict__ rows, long long n_slots,
                      const float* __restrict__ inst_table, int n_inst,
                      float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot[i];
  float g[kAttrs];
  load_row(rows, s, s >= 0 && s < n_slots, g);
#pragma unroll
  for (int a = 18; a < 24; ++a) out[(long long)a * n + i] = g[a];
  out[25LL * n + i] = g[25];
  const int k = min(max(inst[i], 0), n_inst - 1);
  const float4* xf = reinterpret_cast<const float4*>(inst_table + (long long)k * kInstCols);
  float r[kInstCols];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 v = __ldg(xf + q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int b = 0; b < 9; b += 3) {
    const float x = g[b], y = g[b + 1], z = g[b + 2];
    g[b] = affine(r, x, y, z);
    g[b + 1] = affine(r + 4, x, y, z);
    g[b + 2] = affine(r + 8, x, y, z);
  }
  const float e1x = g[3] - g[0], e1y = g[4] - g[1], e1z = g[5] - g[2];
  const float e2x = g[6] - g[0], e2y = g[7] - g[1], e2z = g[8] - g[2];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  out[24LL * n + i] = 0.5f * sqrtf(cx * cx + cy * cy + cz * cz);
#pragma unroll
  for (int a = 0; a < 9; ++a) out[(long long)a * n + i] = g[a];
#pragma unroll
  for (int b = 9; b < 18; b += 3) {
    const float x = g[b], y = g[b + 1], z = g[b + 2];
    const float nx = linear(r + 12, x, y, z);
    const float ny = linear(r + 15, x, y, z);
    const float nz = linear(r + 18, x, y, z);
    const float q = nx * nx + ny * ny + nz * nz;
    // torch.clamp_min's NaN passes through
    const float sc = 1.0f / sqrtf(q < 1e-24f ? 1e-24f : q);
    out[(long long)b * n + i] = nx * sc;
    out[(long long)(b + 1) * n + i] = ny * sc;
    out[(long long)(b + 2) * n + i] = nz * sc;
  }
}

}  // namespace

extern "C" int fh_slot_fetch_inst(const int* slot, const int* inst, int n, const float* rows,
                                  long long n_slots, const float* inst_table, int n_inst,
                                  float* out, cudaStream_t stream) {
  if (n < 1 || n_slots < 1 || n_inst < 1) return (int)cudaErrorInvalidValue;
  k_slot_fetch_inst<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      slot, inst, n, rows, n_slots, inst_table, n_inst, out);
  return (int)cudaGetLastError();
}

extern "C" int fh_slot_fetch(const int* slot, int n, const float* rows, long long n_slots,
                             float* out, cudaStream_t stream) {
  if (n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  k_slot_fetch<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(slot, n, rows, n_slots, out);
  return (int)cudaGetLastError();
}
