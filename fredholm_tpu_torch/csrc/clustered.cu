// Clustered closest-hit and any-hit traversal (scenes above 1024 faces).
//
// Replaces fredholm_tpu/accel/pallas_clustered.py `_make_kernel`
// (any_hit=False via `intersect_closest_clustered`, any_hit=True via
// `intersect_any_clustered`). Plain twins:
// fredholm_tpu_torch/accel/clustered.py `intersect_closest_twin`,
// `intersect_any_twin`.
//
// One thread per ray walks the reference's tables (accel/cluster.py) in
// table order: instance AABB -> supercluster AABB -> member-cluster AABB
// (cl_meta) -> 16-triangle group AABB (blocks rows 10-15) -> triangles.
// Every level is gated by the reference's slab test against the lane's
// running best t, after the reference's root-box clamp of the initial
// best t; triangles use its Moller-Trumbore test and the strict
// `t < best` rule, so on exactly equal t the lowest slot wins. Any-hit
// stops at the first hit below the clamped tmax. The loops are fixed and
// need no stack: front-to-back ordering, shared-memory staging and
// warp-coherent traversal are later work.
//
// Bounds on the H100, at the bounce shapes of the hosek sweep that
// chip_smoke.py times (PERF.md has the numbers): the closest hit by bytes,
// the any-hit by operations. A live ray reads 28 B and a dead one 4 B, a
// ray writes 24 B (closest) or 1 B (any), and the tables are read once per
// entry the rays reach; a slab test takes ~21 flops and a triangle test
// ~40. The any-hit traces three blocks of rays, each walking boxes until
// its first hit, so its tests outweigh its bytes. Both run 70x (any) to
// 180x (closest) above their bound: each thread waits on a chain of
// dependent loads (supercluster, cluster and group boxes, then triangles),
// and divergent lanes of a warp serialise the loops, which warp-coherent
// traversal would fix.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kCluster = 128;
constexpr int kScGroup = 128;
constexpr int kTriGroup = 16;
constexpr int kGroups = kCluster / kTriGroup;

struct Tables {
  const float* root;       // [6, 8] (column 0 used)
  const float* inst_aabb;  // [6, I]
  const float* inst_minv;  // [12, I] world -> object affine rows
  const int* inst_sc;      // [3, I] supercluster base, count, region base
  const float* sc_aabb;    // [6, S]
  const int* sc_mcount;    // [S]
  const float* cl_meta;    // [8, S * 128] lo.xyz, hi.xyz, count, cluster id
  const float* blocks;     // [16, K * 128] v0, e1, e2, prim id, group AABBs
  long long n_slots;       // K * 128
  int n_inst;
  int n_sc;
  int identity;
};

// pallas_clustered `_slab`: box as lo.xyz at p[0..2 * s], hi.xyz at
// p[3..5 * s] (s = row stride of the table)
__device__ __forceinline__ bool slab(const float* __restrict__ p, long long s, const Ray& r,
                                     float t_best) {
  return slab_box(__ldg(p), __ldg(p + s), __ldg(p + 2 * s), __ldg(p + 3 * s), __ldg(p + 4 * s),
                  __ldg(p + 5 * s), r, t_best);
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
    k_clustered(const float* __restrict__ rays, long long stride, int m, const Tables tb,
                float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ inst_out, int* __restrict__ slot_out,
                unsigned char* __restrict__ occ_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float tmax = rays[6 * stride + i];
  float best_t = tmax;
  int best_slot = -1, best_inst = 0;
  float bu = 0.0f, bv = 0.0f;
  bool occluded = false;
  const long long ns = tb.n_slots;
  const long long nc = (long long)tb.n_sc * kScGroup;
  if (tmax > 0.0f) {
    const Ray w = make_ray(rays[i], rays[stride + i], rays[2 * stride + i], rays[3 * stride + i],
                           rays[4 * stride + i], rays[5 * stride + i]);
    best_t = fminf(best_t, root_exit_clamp(tb.root, w));
    for (int in = 0; in < tb.n_inst; ++in) {
      if (!slab(tb.inst_aabb + in, tb.n_inst, w, best_t)) continue;
      Ray r = w;
      if (!tb.identity) {
        const float* mi = tb.inst_minv + in;
        const long long s = tb.n_inst;
        float mm[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) mm[k] = mi[k * s];
        r.ox = mm[0] * w.ox + mm[1] * w.oy + mm[2] * w.oz + mm[3];
        r.oy = mm[4] * w.ox + mm[5] * w.oy + mm[6] * w.oz + mm[7];
        r.oz = mm[8] * w.ox + mm[9] * w.oy + mm[10] * w.oz + mm[11];
        r.dx = mm[0] * w.dx + mm[1] * w.dy + mm[2] * w.dz;
        r.dy = mm[4] * w.dx + mm[5] * w.dy + mm[6] * w.dz;
        r.dz = mm[8] * w.dx + mm[9] * w.dy + mm[10] * w.dz;
        r.ix = inv_dir(r.dx);
        r.iy = inv_dir(r.dy);
        r.iz = inv_dir(r.dz);
      }
      const int sc_lo = tb.inst_sc[in], sc_n = tb.inst_sc[tb.n_inst + in];
      for (int s = sc_lo; s < sc_lo + sc_n; ++s) {
        if (!slab(tb.sc_aabb + s, tb.n_sc, r, best_t)) continue;
        const int mcount = __ldg(tb.sc_mcount + s);
        for (int j = 0; j < mcount; ++j) {
          const long long col = (long long)s * kScGroup + j;
          if (!slab(tb.cl_meta + col, nc, r, best_t)) continue;
          const int cnt = (int)__ldg(tb.cl_meta + 6 * nc + col);
          const long long base = (long long)__ldg(tb.cl_meta + 7 * nc + col) * kCluster;
          for (int g = 0; g < kGroups && g * kTriGroup < cnt; ++g) {
            if (!slab(tb.blocks + 10 * ns + base + g, ns, r, best_t)) continue;
            const int k_end = min(cnt, (g + 1) * kTriGroup);
            for (int k = g * kTriGroup; k < k_end; ++k) {
              const float* q = tb.blocks + base + k;
              float v0x = __ldg(q), v0y = __ldg(q + ns), v0z = __ldg(q + 2 * ns);
              float e1x = __ldg(q + 3 * ns), e1y = __ldg(q + 4 * ns), e1z = __ldg(q + 5 * ns);
              float e2x = __ldg(q + 6 * ns), e2y = __ldg(q + 7 * ns), e2z = __ldg(q + 8 * ns);
              MtHit h = moller_trumbore(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, v0x, v0y, v0z,
                                        e1x, e1y, e1z, e2x, e2y, e2z);
              if (h.valid && h.t < best_t) {
                if (kAny) {
                  occluded = true;
                  goto done;
                }
                best_t = h.t;
                best_slot = (int)(base + k);
                bu = h.u;
                bv = h.v;
                best_inst = in;
              }
            }
          }
        }
      }
    }
  }
done:
  if (kAny) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    const bool hit = best_slot >= 0;
    t_out[i] = hit ? best_t : tmax;
    prim_out[i] = hit ? (int)__ldg(tb.blocks + 9 * ns + best_slot) : -1;
    u_out[i] = bu;
    v_out[i] = bv;
    inst_out[i] = best_inst;
    slot_out[i] = best_slot;
  }
}

template <bool kAny>
int launch(const float* rays, long long stride, int m, const float* root, const float* inst_aabb,
           const float* inst_minv, const int* inst_sc, int n_inst, int identity,
           const float* sc_aabb, const int* sc_mcount, int n_sc, const float* cl_meta,
           const float* blocks, long long n_slots, float* t, int* prim, float* u, float* v,
           int* inst, int* slot, unsigned char* occ, cudaStream_t stream) {
  if (m < 1 || n_inst < 1 || n_sc < 1 || n_slots < kCluster) return (int)cudaErrorInvalidValue;
  if (kAny ? occ == nullptr : (t == nullptr || prim == nullptr || u == nullptr || v == nullptr ||
                                inst == nullptr || slot == nullptr))
    return (int)cudaErrorInvalidValue;
  Tables tb;
  tb.root = root;
  tb.inst_aabb = inst_aabb;
  tb.inst_minv = inst_minv;
  tb.inst_sc = inst_sc;
  tb.sc_aabb = sc_aabb;
  tb.sc_mcount = sc_mcount;
  tb.cl_meta = cl_meta;
  tb.blocks = blocks;
  tb.n_slots = n_slots;
  tb.n_inst = n_inst;
  tb.n_sc = n_sc;
  tb.identity = identity;
  k_clustered<kAny><<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(rays, stride, m, tb, t, prim,
                                                                       u, v, inst, slot, occ);
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_CLUSTERED_ARGS                                                                         \
  const float *rays, long long stride, int m, const float *root, const float *inst_aabb,          \
      const float *inst_minv, const int *inst_sc, int n_inst, int identity, const float *sc_aabb, \
      const int *sc_mcount, int n_sc, const float *cl_meta, const float *blocks,                  \
      long long n_slots, float *t, int *prim, float *u, float *v, int *inst, int *slot,           \
      unsigned char *occ, cudaStream_t stream
#define FH_CLUSTERED_PASS                                                                        \
  rays, stride, m, root, inst_aabb, inst_minv, inst_sc, n_inst, identity, sc_aabb, sc_mcount, \
      n_sc, cl_meta, blocks, n_slots, t, prim, u, v, inst, slot, occ, stream

extern "C" int fh_clustered_closest(FH_CLUSTERED_ARGS) { return launch<false>(FH_CLUSTERED_PASS); }

extern "C" int fh_clustered_any(FH_CLUSTERED_ARGS) { return launch<true>(FH_CLUSTERED_PASS); }
