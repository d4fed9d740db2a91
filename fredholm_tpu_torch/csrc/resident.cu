// Ray-resident closest-hit and any-hit traversal in cid order (B7).
//
// Replaces fredholm_tpu/experimental/pallas_resident.py `_make_kernel`
// (via `_call`; entries `intersect_closest_resident`,
// `intersect_any_resident`). Plain twins:
// fredholm_tpu_torch/experimental/resident.py `intersect_closest_twin`,
// `intersect_any_twin`.
//
// Contract: each ray walks the clusters in cid order, page by page (P_CL
// clusters a page), every gate against its own running best t: the page
// box, the cluster box (clusters with a triangle count > 0), each
// 16-triangle group box, then the triangles (Moller-Trumbore) under the
// strict `t < best` rule, so on exactly equal t the first triangle in cid
// order wins. The initial best t is the root-box exit clamp. Any-hit stops
// a ray at its first occluder. The slab and Moller-Trumbore helpers are
// common.cuh's, built -fmad=false as the rest: the results are the twin's
// bit for bit. A ray's result never depends on the other rays.
//
// Bound on the H100 at the hosek sweep's bounce shapes (chip_smoke.py
// [13]; PERF.md has the numbers): operations. Every live ray tests every
// page box (the twin's count), then the clusters, groups and triangles
// behind the pages it wants; the bytes (rays, outputs, each table entry
// once) are a few MB. [13] also counts the walk with this kernel's span
// gate (each span box, then only the page boxes of the spans a ray
// passes): 1.7x less for closest (bytes), 5.6x for any-hit (operations).
// Neither is what sets the time: that is the longest chain of dependent
// steps a warp walks, and at any-hit's 188,028 live rays, the warp
// instructions a ray costs.
//
// The design, lever by lever against what held the first port, the
// page-streaming design (the reference's loops: a block of 256 rays
// streaming every page through shared memory;
// PERF.md section 6 has both designs' times and each measurement):
// - The page loop's fixed cost (two block barriers a page, wanted or not;
//   every block walked all ~270 pages): nothing in the walk waits on
//   another warp. A span record (the union of kSpan page boxes; res_span)
//   gates its pages: its slab test fails wherever each page's would, at
//   the same or a smaller best t (the test is monotone in the box under
//   round-to-nearest), so the gate changes no result. A warp tests 64
//   spans at once (the first 64 records in shared memory, copied once a
//   block), then a passing span's 32 (page, cluster) slots, one a lane.
// - Synchronous, coarse staging (a wanted page copied whole, 32 KB, by
//   256 threads, then a barrier; 7.9 us a page): nothing is staged. The
//   records are 16-byte loads (res_page: a page box and its clusters'
//   boxes and counts; B4/B5's group and triangle records) from the
//   L2-resident tables through the read-only cache, and the 32 lanes of a
//   warp load one ray's records of a level at once: a span's slots in one
//   round trip, a cluster's group boxes in one, the triangles of its
//   passing groups (up to 128, four a lane) in one. Staging the page
//   records in shared memory as well measured no gain (L1 holds them).
// - The slowest block (a block's time was the union of its 256 rays'
//   pages; block 337's 105 were the launch's time): one warp walks one
//   ray, a block's warps take its live rays from a shared counter, and a
//   block holds 8 tiles of 32 rays, every gridDim.x-th tile, so the
//   grazing rays of one region of the image (up to 36 pages a ray) spread
//   over many blocks. One thread a ray instead (each warp walking the
//   union of its lanes' pages, one load after another) measured 0.74 ms.
// - Scattered live lanes (21% and 42% live, in every warp): each block
//   packs its live rays, with their inverse directions and clamped best t
//   computed once, into shared memory; dead rays write their miss, and a
//   block with no live ray leaves after one barrier.
// Exactness: the tests of a level at once use the best t of the moment
// they are made, and every candidate is tested again, in cid order, at
// the best t of its turn (a page at its first candidate cluster, each
// cluster and group at its own), before it can change the result; the
// triangles of a group reduce to their first (t, index) minimum, which is
// what testing them in turn under the strict rule gives. A candidate
// taken at a larger best t is a superset of the clusters and groups the
// walk in turn would test. Any-hit keeps its best t fixed, so its tests
// at once are exact and it leaves at the first occluder.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;                 // rays a block (resident.py RES_BLOCK)
constexpr int kWarps = kBlock / 32;
constexpr int kCluster = 128;               // triangle slots a cluster
constexpr int kTriGroup = 16;
constexpr int kGroups = kCluster / kTriGroup;
constexpr int kPcl = 4;                     // clusters a page (resident.py P_CL)
constexpr int kSpan = 8;                    // pages a span record (resident.py SPAN)
constexpr int kSlots = kSpan * kPcl;        // (page, cluster) slots a span: one a lane
constexpr int kPageRecs = 2 * (1 + kPcl);   // float4s a page record: its box, its clusters'
constexpr int kTriLane = kCluster / 32;     // a cluster's triangles a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpanShared = 64;             // span records a block keeps in shared memory
constexpr int kRayWords = 11;               // a packed ray: o, d, 1/d, best t, tmax
// resident blocks an SM the registers allow
constexpr int kMinBlocks = 2;
static_assert(kSlots == 32, "a span's slots are a warp's lanes");

struct Out {
  float* t;
  int* prim;
  float* u;
  float* v;
  unsigned char* occ;
};

__device__ __forceinline__ bool slab4(const float4& a, const float4& b, const Ray& r, float t) {
  return slab_box(a.x, a.y, a.z, b.x, b.y, b.z, r, t);
}

// one ray, walked by a whole warp (every lane holds the same ray and the
// same running best hit)
// span record half h (0: lo, 1: hi) of span s: the block's shared copy of
// the first kSpanShared, else global memory
__device__ __forceinline__ float4 span_rec(const float4* s_span, const float4* __restrict__ span,
                                           int s, int h) {
  return s < kSpanShared ? s_span[2 * s + h] : __ldg(span + 2 * s + h);
}

template <bool kAny>
__device__ __forceinline__ void walk(const Ray& r, float& best_t, int& best_prim, float& bu,
                                     float& bv, bool& occluded, const float4* s_span,
                                     const float4* __restrict__ span,
                                     const float4* __restrict__ page, int n_pages,
                                     const float4* __restrict__ grp,
                                     const float4* __restrict__ tri, int lane) {
  const int n_spans = (n_pages + kSpan - 1) / kSpan;
  for (int s0 = 0; s0 < n_spans; s0 += 64) {
    // 64 spans at once, two a lane
    unsigned long long smask = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + 32 * h + lane;
      const bool pass =
          s < n_spans && slab4(span_rec(s_span, span, s, 0), span_rec(s_span, span, s, 1), r,
                               best_t);
      smask |= (unsigned long long)__ballot_sync(kFull, pass) << (32 * h);
    }
    while (smask) {
      const int s = s0 + __ffsll((long long)smask) - 1;
      smask &= smask - 1;
      // again at the best t of now (the gate is conservative either way)
      if (!slab4(span_rec(s_span, span, s, 0), span_rec(s_span, span, s, 1), r, best_t)) continue;
      // the span's (page, cluster) slots at once: lane = 4 * page + cluster
      const int p = s * kSpan + (lane >> 2);
      float4 pa = make_float4(0.f, 0.f, 0.f, 0.f), pb = pa, ca = pa, cb = pa;
      int cnt = 0;
      if (p < n_pages) {
        const float4* rec = page + (long long)p * kPageRecs;
        pa = __ldg(rec);
        pb = __ldg(rec + 1);
        ca = __ldg(rec + 2 + 2 * (lane & 3));
        cb = __ldg(rec + 3 + 2 * (lane & 3));
        cnt = (int)ca.w;
      }
      unsigned cmask = __ballot_sync(
          kFull, p < n_pages && cnt > 0 && slab4(pa, pb, r, best_t) && slab4(ca, cb, r, best_t));
      int page_in = -1;  // the page whose gate was last taken (in the span)
      while (cmask) {
        const int cs = __ffs(cmask) - 1;
        cmask &= cmask - 1;
        // the walk in turn: the page's gate at its first candidate
        // cluster, the cluster's at its own, both at the best t of now
        if ((cs >> 2) != page_in) {
          page_in = cs >> 2;
          if (!__shfl_sync(kFull, slab4(pa, pb, r, best_t), cs)) {
            cmask &= ~(0xfu << (4 * page_in));
            continue;
          }
        }
        if (!__shfl_sync(kFull, slab4(ca, cb, r, best_t), cs)) continue;
        const int ccnt = __shfl_sync(kFull, cnt, cs);
        const long long cid = (long long)s * kSlots + cs;
        // the cluster's group boxes at once, lane g group g
        const int n_g = (ccnt + kTriGroup - 1) / kTriGroup;
        float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), gb = ga;
        if (lane < n_g) {
          ga = __ldg(grp + 2 * (cid * kGroups + lane));
          gb = __ldg(grp + 2 * (cid * kGroups + lane) + 1);
        }
        unsigned gmask = __ballot_sync(kFull, lane < n_g && slab4(ga, gb, r, best_t));
        if (!gmask) continue;
        // the passing groups' triangles at once: triangle k at lane k % 32,
        // slot k / 32
        // (every load issued before the first test)
        float4 v0[kTriLane], e1[kTriLane], e2[kTriLane];
        bool ld[kTriLane];
#pragma unroll
        for (int q = 0; q < kTriLane; ++q) {
          const int k = lane + 32 * q;
          ld[q] = k < ccnt && ((gmask >> (k / kTriGroup)) & 1u);
          if (ld[q]) {
            const float4* tr = tri + 3 * (cid * kCluster + k);
            v0[q] = __ldg(tr);
            e1[q] = __ldg(tr + 1);
            e2[q] = __ldg(tr + 2);
          }
        }
        float tt[kTriLane], tu[kTriLane], tv[kTriLane], tp[kTriLane];
        bool ok[kTriLane];
#pragma unroll
        for (int q = 0; q < kTriLane; ++q) {
          ok[q] = false;
          tt[q] = 0.0f;
          tu[q] = 0.0f;
          tv[q] = 0.0f;
          tp[q] = 0.0f;
          if (ld[q]) {
            const MtHit h = moller_trumbore(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, v0[q].x, v0[q].y,
                                            v0[q].z, e1[q].x, e1[q].y, e1[q].z, e2[q].x,
                                            e2[q].y, e2[q].z);
            ok[q] = h.valid;
            tt[q] = h.t;
            tu[q] = h.u;
            tv[q] = h.v;
            tp[q] = v0[q].w;
          }
        }
        if (kAny) {
          bool hit = false;
#pragma unroll
          for (int q = 0; q < kTriLane; ++q) hit |= ok[q] && tt[q] < best_t;
          if (__any_sync(kFull, hit)) {
            occluded = true;
            return;
          }
          continue;
        }
        // the group walk in turn: each passing group's gate at the best t
        // of now, then its triangles' first (t, index) minimum below it
        while (gmask) {
          const int g = __ffs(gmask) - 1;
          gmask &= gmask - 1;
          if (!__shfl_sync(kFull, lane < n_g && slab4(ga, gb, r, best_t), g)) continue;
          const int q = g >> 1;  // the slot of group g's triangles, in half-warp g & 1
          float t_q = tt[0], u_q = tu[0], v_q = tv[0], p_q = tp[0];
          bool ok_q = ok[0];
#pragma unroll
          for (int w = 1; w < kTriLane; ++w) {
            if (q == w) {
              t_q = tt[w];
              u_q = tu[w];
              v_q = tv[w];
              p_q = tp[w];
              ok_q = ok[w];
            }
          }
          const bool mine = (lane >> 4) == (g & 1) && ok_q && t_q < best_t;
          float bt = mine ? t_q : best_t;
          int bk = mine ? lane : 32;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kFull, bt, off);
            const int ok2 = __shfl_xor_sync(kFull, bk, off);
            if (ok2 < 32 && (bk == 32 || ot < bt || (ot == bt && ok2 < bk))) {
              bt = ot;
              bk = ok2;
            }
          }
          // the half-warp of group g holds the winner (lane bk, or none)
          const int win = __shfl_sync(kFull, bk, (g & 1) * 16);
          if (win < 32) {
            best_t = __shfl_sync(kFull, t_q, win);
            bu = __shfl_sync(kFull, u_q, win);
            bv = __shfl_sync(kFull, v_q, win);
            best_prim = (int)__shfl_sync(kFull, p_q, win);
          }
        }
      }
    }
  }
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    k_resident(const float* __restrict__ rays, long long stride, int m,
               const float* __restrict__ root, const float4* __restrict__ span,
               const float4* __restrict__ page, int n_pages, const float4* __restrict__ grp,
               const float4* __restrict__ tri, Out out) {
  __shared__ int s_list[kBlock];
  __shared__ float s_ray[kRayWords][kBlock];
  __shared__ float4 s_span[2 * kSpanShared];
  __shared__ int s_count[kWarps];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // ---- this block's rays, a 32-ray tile a warp, every gridDim.x-th tile:
  // pack the live ones with their inverse directions and clamped best t;
  // dead rays write their miss
  const long long i = ((long long)warp * gridDim.x + blockIdx.x) * 32 + lane;
  const float tmax_i = i < m ? rays[6 * stride + i] : 0.0f;
  const bool live = tmax_i > 0.0f;
  if (i < m && !live) {
    if (kAny) {
      out.occ[i] = 0;
    } else {
      out.t[i] = tmax_i;
      out.prim[i] = -1;
      out.u[i] = 0.0f;
      out.v[i] = 0.0f;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) s_count[warp] = __popc(ballot);
  if (threadIdx.x == 0) s_next = 0;
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (live) {
    const int at = offset + __popc(ballot & ((1u << lane) - 1u));
    const Ray r = make_ray(rays[i], rays[stride + i], rays[2 * stride + i], rays[3 * stride + i],
                           rays[4 * stride + i], rays[5 * stride + i]);
    const float w[kRayWords] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.ix, r.iy, r.iz,
                                fminf(tmax_i, root_exit_clamp(root, r)), tmax_i};
#pragma unroll
    for (int k = 0; k < kRayWords; ++k) s_ray[k][at] = w[k];
    s_list[at] = (int)i;
  }
  if (total == 0) return;  // the whole block: nothing to walk, nothing to stage
  // ---- the first span records, once a block
  const int n_spans = (n_pages + kSpan - 1) / kSpan;
  for (int e = threadIdx.x; e < 2 * min(n_spans, kSpanShared); e += kBlock)
    s_span[e] = __ldg(span + e);
  __syncthreads();

  // ---- the warps take the live rays in turn, one ray a warp
  for (;;) {
    int idx = 0;
    if (lane == 0) idx = atomicAdd(&s_next, 1);
    idx = __shfl_sync(kFull, idx, 0);
    if (idx >= total) return;
    const long long j = s_list[idx];
    Ray r;
    r.ox = s_ray[0][idx];
    r.oy = s_ray[1][idx];
    r.oz = s_ray[2][idx];
    r.dx = s_ray[3][idx];
    r.dy = s_ray[4][idx];
    r.dz = s_ray[5][idx];
    r.ix = s_ray[6][idx];
    r.iy = s_ray[7][idx];
    r.iz = s_ray[8][idx];
    float best_t = s_ray[9][idx];
    const float tmax = s_ray[10][idx];
    int best_prim = -1;
    float bu = 0.0f, bv = 0.0f;
    bool occluded = false;
    walk<kAny>(r, best_t, best_prim, bu, bv, occluded, s_span, span, page, n_pages, grp, tri,
               lane);
    if (lane == 0) {
      if (kAny) {
        out.occ[j] = occluded ? 1 : 0;
      } else {
        const bool hit = best_prim >= 0;
        out.t[j] = hit ? best_t : tmax;
        out.prim[j] = best_prim;
        out.u[j] = bu;
        out.v[j] = bv;
      }
    }
  }
}

template <bool kAny>
int launch(const float* rays, long long stride, int m, const float* root, const float* span,
           const float* page, int n_pages, const float* grp, const float* tri, Out out,
           cudaStream_t stream) {
  if (m < 1 || n_pages < 1 || !rays || !root || !span || !page || !grp || !tri)
    return (int)cudaErrorInvalidValue;
  if (kAny ? out.occ == nullptr
           : (out.t == nullptr || out.prim == nullptr || out.u == nullptr || out.v == nullptr))
    return (int)cudaErrorInvalidValue;
  k_resident<kAny><<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      rays, stride, m, root, reinterpret_cast<const float4*>(span),
      reinterpret_cast<const float4*>(page), n_pages, reinterpret_cast<const float4*>(grp),
      reinterpret_cast<const float4*>(tri), out);
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_RESIDENT_ARGS                                                                    \
  const float *rays, long long stride, int m, const float *root, const float *span,         \
      const float *page, int n_pages, const float *grp, const float *tri, float *t, int *prim, \
      float *u, float *v, unsigned char *occ, cudaStream_t stream
#define FH_RESIDENT_PASS \
  rays, stride, m, root, span, page, n_pages, grp, tri, Out{t, prim, u, v, occ}, stream

extern "C" int fh_resident_closest(FH_RESIDENT_ARGS) { return launch<false>(FH_RESIDENT_PASS); }

extern "C" int fh_resident_any(FH_RESIDENT_ARGS) { return launch<true>(FH_RESIDENT_PASS); }
