// Hit-attribute fetch keyed by traversal slot.
//
// Replaces fredholm_tpu/fused/slot_fetch.py `_make_kernel` (via `_call`,
// entry `fetch_geom_by_slot`). Plain twin:
// fredholm_tpu_torch/fused/slot_fetch.py `fetch_twin`.
//
//   out[a, i] = 0 <= slot[i] < n_slots ? slot_attrs[a, slot[i]] : 0,  a < 26
//
// One thread per lane reads its slot and copies the 26 attribute rows of
// that slot into 26 planes. The TPU kernel walked each ray tile's
// distinct hit clusters and shuffled lanes, because a per-lane gather was
// its slowest primitive; here a per-lane gather through the L2 cache is
// cheap, so the kernel is a plain gather.
// Bounds on the H100: bytes. Per lane it reads 4 B of slot and writes
// 104 B; a hit lane also reads its slot's 104 B of attributes. Stores are
// coalesced, loads of lanes that hit one cluster fall in one 512 B row
// segment.
//
// k_slot_fetch_inst (instanced scenes) is the same gather followed by the
// hit-attribute transform of fredholm_tpu/fused/pt_fused.py
// `_xform_attrs_cols` (called from `_gather_attrs`), which the reference
// runs as jnp after its fetch; plain twin: fused/slot_fetch.py
// `fetch_inst_twin`. slot_attrs holds object-space geometry; each lane
// reads its instance's row of inst_table [I, 24] (cols 0-11 the
// object-to-world affine rows, 12-20 the normal matrix, the instance id
// clamped to [0, I)) and writes world-space planes: the three vertices by
// the affine rows, the three normals by the normal matrix then times
// 1 / sqrt(max(|n|^2, 1e-24)), the area from the moved vertices. Every
// lane, misses included (inst 0 and zero planes), as the reference does.
// The products and sums run in the twin's order, one rounding each
// (-fmad=false). Bounds on the H100: bytes, as the plain fetch, plus 4 B
// of inst a lane (the 96 B row of an instance stays in L1).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kAttrs = 26;

__global__ void __launch_bounds__(kBlock)
    k_slot_fetch(const int* __restrict__ slot, int n, const float* __restrict__ attrs,
                 long long n_slots, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot[i];
  const bool hit = s >= 0 && s < n_slots;
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) {
    out[(long long)a * n + i] = hit ? __ldg(attrs + a * n_slots + s) : 0.0f;
  }
}

constexpr int kInstCols = 24;

__device__ __forceinline__ float affine(const float* r, float x, float y, float z) {
  return r[0] * x + r[1] * y + r[2] * z + r[3];
}

__device__ __forceinline__ float linear(const float* r, float x, float y, float z) {
  return r[0] * x + r[1] * y + r[2] * z;
}

__global__ void __launch_bounds__(kBlock)
    k_slot_fetch_inst(const int* __restrict__ slot, const int* __restrict__ inst, int n,
                      const float* __restrict__ attrs, long long n_slots,
                      const float* __restrict__ inst_table, int n_inst,
                      float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot[i];
  const bool hit = s >= 0 && s < n_slots;
  float g[kAttrs];
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) g[a] = hit ? __ldg(attrs + a * n_slots + s) : 0.0f;
  const int k = min(max(inst[i], 0), n_inst - 1);
  float r[21];
#pragma unroll
  for (int c = 0; c < 21; ++c) r[c] = __ldg(inst_table + (long long)k * kInstCols + c);
#pragma unroll
  for (int b = 0; b < 9; b += 3) {
    const float x = g[b], y = g[b + 1], z = g[b + 2];
    g[b] = affine(r, x, y, z);
    g[b + 1] = affine(r + 4, x, y, z);
    g[b + 2] = affine(r + 8, x, y, z);
  }
#pragma unroll
  for (int b = 9; b < 18; b += 3) {
    const float x = g[b], y = g[b + 1], z = g[b + 2];
    const float nx = linear(r + 12, x, y, z);
    const float ny = linear(r + 15, x, y, z);
    const float nz = linear(r + 18, x, y, z);
    const float q = nx * nx + ny * ny + nz * nz;
    // torch.clamp_min's NaN passes through
    const float sc = 1.0f / sqrtf(q < 1e-24f ? 1e-24f : q);
    g[b] = nx * sc;
    g[b + 1] = ny * sc;
    g[b + 2] = nz * sc;
  }
  const float e1x = g[3] - g[0], e1y = g[4] - g[1], e1z = g[5] - g[2];
  const float e2x = g[6] - g[0], e2y = g[7] - g[1], e2z = g[8] - g[2];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
  g[24] = 0.5f * sqrtf(cx * cx + cy * cy + cz * cz);
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) out[(long long)a * n + i] = g[a];
}

}  // namespace

extern "C" int fh_slot_fetch_inst(const int* slot, const int* inst, int n, const float* attrs,
                                  long long n_slots, const float* inst_table, int n_inst,
                                  float* out, cudaStream_t stream) {
  if (n < 1 || n_slots < 1 || n_inst < 1) return (int)cudaErrorInvalidValue;
  k_slot_fetch_inst<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      slot, inst, n, attrs, n_slots, inst_table, n_inst, out);
  return (int)cudaGetLastError();
}

extern "C" int fh_slot_fetch(const int* slot, int n, const float* attrs, long long n_slots,
                             float* out, cudaStream_t stream) {
  if (n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  k_slot_fetch<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(slot, n, attrs, n_slots, out);
  return (int)cudaGetLastError();
}
