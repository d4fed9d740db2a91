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

}  // namespace

extern "C" int fh_slot_fetch(const int* slot, int n, const float* attrs, long long n_slots,
                             float* out, cudaStream_t stream) {
  if (n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  k_slot_fetch<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(slot, n, attrs, n_slots, out);
  return (int)cudaGetLastError();
}
