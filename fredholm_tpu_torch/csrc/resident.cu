// Ray-resident, geometry-streamed closest-hit and any-hit traversal (B7).
//
// Replaces fredholm_tpu/experimental/pallas_resident.py `_make_kernel`
// (via `_call`; entries `intersect_closest_resident`,
// `intersect_any_resident`). Plain twins:
// fredholm_tpu_torch/experimental/resident.py `intersect_closest_twin`,
// `intersect_any_twin`.
//
// One thread per ray; a block of kBlock rays is the resident tile. The
// block streams the dense-by-cid meta table (res_meta) chunk by chunk
// into shared memory, in cid order. For each page of kPcl clusters every
// lane tests the page box against its running best t; a page that no
// lane of the block wants is skipped (__syncthreads_or), else the block
// stages the page's kPcl x 128 triangle columns (16 rows, 32 KB) in
// shared memory and each lane that wants the page walks it: cluster box,
// 16-triangle group boxes, then the triangles, each gate against the
// lane's own running best t, with the slab and Moller-Trumbore helpers of
// common.cuh (built -fmad=false as the rest). Each lane applies its own
// gates, so its result does not depend on the other lanes of its block:
// the strictly closest triangle, the first in cid order on exact ties,
// which is what the twin computes bit for bit. The initial best t is the
// root-box exit clamp. Any-hit stops a lane at its first occluder, and the
// block leaves the stream once every lane is dead or occluded
// (__syncthreads_and). prim is int32, from blocks row 9.
//
// Bounds on the H100, at the hosek sweep's bounce shapes that
// chip_smoke.py times (PERF.md has the numbers): operations. Every live
// lane tests every page box (one slab test per 4 clusters, ~290 at the
// sweep), then the clusters, groups and triangles behind the pages it
// wants; the bytes (rays, outputs and each table entry once) are a few MB.
// The design's cost beyond the bound: each block re-stages every page any
// of its lanes wants from L2 (incoherent rays want most pages), and a
// warp's lanes walk different clusters in turn. Larger ray tiles, or
// staging only the clusters some lane wants, would cut the first.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;                  // rays a block (resident.py RES_BLOCK)
constexpr int kCluster = 128;                // triangle columns a cluster
constexpr int kTriGroup = 16;
constexpr int kGroups = kCluster / kTriGroup;
constexpr int kPcl = 4;                      // clusters a page (resident.py P_CL)
constexpr int kChunk = 128;                  // meta columns a chunk (resident.py CHUNK)
constexpr int kMetaRows = 14;                // res_meta rows read: cluster box, count, page box
constexpr int kPageCols = kPcl * kCluster;   // triangle columns a page
constexpr int kTriRows = 16;                 // v0, e1, e2, prim id, group boxes

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
    k_resident(const float* __restrict__ rays, long long stride, int m,
               const float* __restrict__ root, const float* __restrict__ meta, int k_pad,
               int n_pages, const float* __restrict__ blocks, long long n_cols,
               float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ u_out,
               float* __restrict__ v_out, unsigned char* __restrict__ occ_out) {
  __shared__ float s_meta[kMetaRows][kChunk];
  __shared__ float s_tri[kTriRows][kPageCols];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // lanes past m take part in the block's barriers as dead lanes
  const float tmax = i < m ? rays[6 * stride + i] : 0.0f;
  const bool alive = tmax > 0.0f;
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float best_t = tmax;
  if (alive) {
    r = make_ray(rays[i], rays[stride + i], rays[2 * stride + i], rays[3 * stride + i],
                 rays[4 * stride + i], rays[5 * stride + i]);
    best_t = fminf(best_t, root_exit_clamp(root, r));
  }
  int best_prim = -1;
  float bu = 0.0f, bv = 0.0f;
  bool occluded = false;
  const int pages_per_chunk = kChunk / kPcl;
  for (int j = 0; j * pages_per_chunk < n_pages; ++j) {
    // also the barrier before the chunk's meta overwrites the last one's
    if (__syncthreads_and(!alive || occluded)) break;
    for (int e = threadIdx.x; e < kMetaRows * kChunk; e += kBlock) {
      const int row = e / kChunk, col = e - row * kChunk;
      s_meta[row][col] = meta[(long long)row * k_pad + (long long)j * kChunk + col];
    }
    __syncthreads();
    for (int p = 0; p < pages_per_chunk && j * pages_per_chunk + p < n_pages; ++p) {
      const int c0 = p * kPcl;
      const bool want = alive && !occluded &&
                        slab_box(s_meta[8][c0], s_meta[9][c0], s_meta[10][c0], s_meta[11][c0],
                                 s_meta[12][c0], s_meta[13][c0], r, best_t);
      // also the barrier before the page's triangles overwrite the last one's
      if (!__syncthreads_or(want)) continue;
      // in bounds: the blocks cover whole pages (launch checks n_cols)
      const long long col0 = ((long long)j * kChunk + c0) * kCluster;
      for (int e = threadIdx.x; e < kTriRows * kPageCols; e += kBlock) {
        const int row = e / kPageCols, col = e - row * kPageCols;
        s_tri[row][col] = blocks[row * n_cols + col0 + col];
      }
      __syncthreads();
      if (!want) continue;
      for (int cl = 0; cl < kPcl; ++cl) {
        const int cnt = (int)s_meta[6][c0 + cl];
        if (cnt <= 0) continue;
        if (!slab_box(s_meta[0][c0 + cl], s_meta[1][c0 + cl], s_meta[2][c0 + cl],
                      s_meta[3][c0 + cl], s_meta[4][c0 + cl], s_meta[5][c0 + cl], r, best_t))
          continue;
        const int cb = cl * kCluster;
        for (int g = 0; g < kGroups && g * kTriGroup < cnt; ++g) {
          if (!slab_box(s_tri[10][cb + g], s_tri[11][cb + g], s_tri[12][cb + g],
                        s_tri[13][cb + g], s_tri[14][cb + g], s_tri[15][cb + g], r, best_t))
            continue;
          const int k_end = min(cnt, (g + 1) * kTriGroup);
          for (int k = g * kTriGroup; k < k_end; ++k) {
            const int q = cb + k;
            MtHit h = moller_trumbore(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, s_tri[0][q],
                                      s_tri[1][q], s_tri[2][q], s_tri[3][q], s_tri[4][q],
                                      s_tri[5][q], s_tri[6][q], s_tri[7][q], s_tri[8][q]);
            if (h.valid && h.t < best_t) {
              if (kAny) {
                occluded = true;
                goto page_done;
              }
              best_t = h.t;
              best_prim = (int)s_tri[9][q];
              bu = h.u;
              bv = h.v;
            }
          }
        }
      }
    page_done:;
    }
  }
  if (i >= m) return;
  if (kAny) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    const bool hit = best_prim >= 0;
    t_out[i] = hit ? best_t : tmax;
    prim_out[i] = best_prim;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

template <bool kAny>
int launch(const float* rays, long long stride, int m, const float* root, const float* meta,
           int k_pad, int n_pages, const float* blocks, long long n_cols, float* t, int* prim,
           float* u, float* v, unsigned char* occ, cudaStream_t stream) {
  if (m < 1 || k_pad < kChunk || k_pad % kChunk || n_pages < 1 || n_pages * kPcl > k_pad ||
      n_cols < (long long)n_pages * kPageCols)
    return (int)cudaErrorInvalidValue;
  if (kAny ? occ == nullptr : (t == nullptr || prim == nullptr || u == nullptr || v == nullptr))
    return (int)cudaErrorInvalidValue;
  k_resident<kAny><<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      rays, stride, m, root, meta, k_pad, n_pages, blocks, n_cols, t, prim, u, v, occ);
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_RESIDENT_ARGS                                                                      \
  const float *rays, long long stride, int m, const float *root, const float *meta, int k_pad, \
      int n_pages, const float *blocks, long long n_cols, float *t, int *prim, float *u,      \
      float *v, unsigned char *occ, cudaStream_t stream
#define FH_RESIDENT_PASS \
  rays, stride, m, root, meta, k_pad, n_pages, blocks, n_cols, t, prim, u, v, occ, stream

extern "C" int fh_resident_closest(FH_RESIDENT_ARGS) { return launch<false>(FH_RESIDENT_PASS); }

extern "C" int fh_resident_any(FH_RESIDENT_ARGS) { return launch<true>(FH_RESIDENT_PASS); }
