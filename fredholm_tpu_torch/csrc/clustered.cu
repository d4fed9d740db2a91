// Clustered closest-hit and any-hit traversal (scenes above 1024 faces).
//
// Replaces fredholm_tpu/accel/pallas_clustered.py `_make_kernel`
// (any_hit=False via `intersect_closest_clustered`, any_hit=True via
// `intersect_any_clustered`). Plain twins:
// fredholm_tpu_torch/accel/clustered.py `intersect_closest_twin`,
// `intersect_any_twin`.
//
// Contract, independent of the visit order: the closest hit is the valid
// hit below the lane's root-clamped tmax with the smallest (t, inst,
// slot), compared in that order; any-hit is whether such a hit exists.
// Every level (instance, supercluster, member cluster, 16-triangle group)
// is gated by the reference's slab test against the running best t, and
// the gate is inclusive (tn <= best t), so a box holding a tied lower
// (inst, slot) is never pruned; triangles use the reference's
// Moller-Trumbore test. The kernels and the twin give the same bits.
//
// The walk: each ray visits an instance's superclusters front to back in
// one of the six visit orders (sc_order, sc_key: accel/cluster.py), the
// one of its own object-space direction (dominant axis and sign; the
// reference picks one per 2048-ray tile, pallas_clustered.py:568-586).
// Before each position it leaves the instance if (key - o') * inv' > best
// t, o' and inv' its origin and inverse direction along the order's axis,
// sign-flipped (taken only where d' > 1e-7, as `exit_ok` at :602). That
// product is the slab test's own entry distance along the axis of the box
// the key comes from, and keys ascend along the order, so every later box
// would fail its gate: the exit is exact and changes no result.
//
// Records (accel/clustered.py `card_records`): a box is two float4s
// (lo.xyz + a count or child index, hi.xyz + an id), a triangle three
// (v0 + prim, e1, e2), so every fetch is one or two 16-byte loads where
// the reference layout's lane-major columns took six to nine scalar loads
// a table row apart.
//
// One warp a ray: a warp takes its live rays one at a time and tests 32
// of that ray's order positions (key bound and supercluster box) or
// member-cluster boxes at once, ballots the ones that pass and visits
// them in order, each re-gated against the best t of the moment. In a
// cluster, lanes 0-7 test the group boxes; the groups that pass are tested
// two a round, a half-warp each (16 triangles a lane), reduced to each
// group's first (t, slot) minimum (__shfl_xor_sync), and the group walk is
// then replayed in order: the result of one lane walking the ray alone
// (the twin's walk), bit for bit. Any-hit leaves at the first hit
// (__any_sync). With kStaged each block first copies the supercluster
// records, the visit orders and keys and the member-cluster records into
// shared memory (cp.async) when they fit in a block's default 48 KB
// (stage_bytes); above that the same records are read from global memory.
// Staging measured 1.7% (closest) and 3.8% (any-hit) off the device time
// at the hosek sweep's bounce, every one of 20 pairs (PERF.md).
//
// Bounds on the H100 at the hosek sweep's shapes that chip_smoke.py times
// (PERF.md has the numbers): the closest hit by bytes, the any-hit by
// operations, both far below what a chain of dependent loads allows: each
// level's loads wait on the previous level's test, and a warp walks its
// live rays in turn. The front-to-back exit shortens the chain, the
// records cut each link to one or two loads, and the warp issues a ray's
// 32 tests of a level at once where one lane a ray (the PR-4 design, and
// the first steps of this one: PERF.md section 7) walked them in turn,
// its warp stalled on the slowest lane. The launch bounds ask for one
// resident block an SM (closest hit) and three (any-hit): the register
// counts that measured fastest without spills (PERF.md).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kCluster = 128;
constexpr int kTriGroup = 16;
constexpr int kGroups = kCluster / kTriGroup;
constexpr int kOrders = 6;
// a block's shared memory without the opt-in attribute
constexpr size_t kStageBytesMax = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  const float* root;       // [6, 8] (column 0 used)
  const float4* inst_rec;  // [I, 2] lo.xyz | sc base, hi.xyz | sc count (int bits)
  const float4* inst_xf;   // [I, 3] world -> object affine rows
  const float4* sc_rec;    // [S, 2] lo.xyz | member count, hi.xyz | first member (int bits)
  const int* sc_order;     // [6, S] visit orders (global supercluster ids)
  const float* sc_key;     // [6, S] their ascending keys
  const float4* cl_rec;    // [C, 2] lo.xyz | tri count, hi.xyz | cluster id (floats)
  const float4* grp_rec;   // [C * 8, 2] group boxes
  const float4* tri_rec;   // [C * 128, 3] v0 | prim (float), e1 | 0, e2 | 0
  int n_inst, n_sc, n_cl, identity;
};

struct Out {
  float* t;
  int* prim;
  float* u;
  float* v;
  int* inst;
  int* slot;
  unsigned char* occ;
};

// the records of the top levels a block walks, in shared or global memory
struct Top {
  const float4* sc;
  const float4* cl;
  const float* key;
  const int* order;
};

// a ray's running best hit
struct Hit {
  float t;
  int slot, inst;
  float u, v;
};

template <bool kShared>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ T ld1(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Stage the top levels into the block's shared memory: supercluster and
// member-cluster records, then the visit orders' keys and ids. Every
// thread of the block calls it (it ends in a barrier).
__device__ __forceinline__ Top stage_top(float4* smem, const Tables& tb) {
  float4* s_sc = smem;
  float4* s_cl = s_sc + 2 * tb.n_sc;
  float* s_key = reinterpret_cast<float*>(s_cl + 2 * tb.n_cl);
  int* s_ord = reinterpret_cast<int*>(s_key + kOrders * tb.n_sc);
  for (int e = threadIdx.x; e < 2 * tb.n_sc; e += blockDim.x) cp_async16(s_sc + e, tb.sc_rec + e);
  for (int e = threadIdx.x; e < 2 * tb.n_cl; e += blockDim.x) cp_async16(s_cl + e, tb.cl_rec + e);
  for (int e = threadIdx.x; e < kOrders * tb.n_sc; e += blockDim.x) {
    cp_async4(s_key + e, tb.sc_key + e);
    cp_async4(s_ord + e, tb.sc_order + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return Top{s_sc, s_cl, s_key, s_ord};
}

__device__ __forceinline__ bool gate(float tn, float tf, float t_best) {
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_best);
}

__device__ __forceinline__ void slab_rec(const float4& lo, const float4& hi, const Ray& r,
                                         float& tn, float& tf) {
  slab_t(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, tn, tf);
}

// the ray in instance space (rows of the world -> object affine)
__device__ __forceinline__ Ray to_object(const float4* xf, const Ray& w) {
  const float4 a = __ldg(xf), b = __ldg(xf + 1), c = __ldg(xf + 2);
  Ray r;
  r.ox = a.x * w.ox + a.y * w.oy + a.z * w.oz + a.w;
  r.oy = b.x * w.ox + b.y * w.oy + b.z * w.oz + b.w;
  r.oz = c.x * w.ox + c.y * w.oy + c.z * w.oz + c.w;
  r.dx = a.x * w.dx + a.y * w.dy + a.z * w.dz;
  r.dy = b.x * w.dx + b.y * w.dy + b.z * w.dz;
  r.dz = c.x * w.dx + c.y * w.dy + c.z * w.dz;
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// A ray's visit order and its sign-flipped coordinates along the order's
// axis (twin: clustered.py `order_class`)
struct Order {
  int o;
  float op, ip;
  bool exit_ok;
};

__device__ __forceinline__ Order order_of(const Ray& r) {
  const float ax_ = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
  const int ax = (ax_ >= ay && ax_ >= az) ? 0 : (ay >= az ? 1 : 2);
  const float d = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
  const float o = ax == 0 ? r.ox : (ax == 1 ? r.oy : r.oz);
  const float iv = ax == 0 ? r.ix : (ax == 1 ? r.iy : r.iz);
  const bool neg = d < 0.0f;
  Order c;
  c.o = 2 * ax + (neg ? 1 : 0);
  c.op = neg ? -o : o;
  c.ip = neg ? -iv : iv;
  c.exit_ok = (neg ? -d : d) > 1e-7f;
  return c;
}

__device__ __forceinline__ MtHit mt_rec(const float4* q, const Ray& r) {
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  return moller_trumbore(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a.x, a.y, a.z, b.x, b.y, b.z, c.x,
                         c.y, c.z);
}

// ---------------------------------------------------------------------------
// the warp's walk of one ray: every value below is the same in all lanes
// but the per-lane temporaries of the 32-wide tests

// cluster cid (cnt triangles) of instance in. Returns true at any-hit's
// first hit.
template <bool kAny>
__device__ __forceinline__ bool warp_cluster(const Tables& tb, const Ray& r, int in, int cid,
                                             int cnt, int lane, Hit& h) {
  float gtn = 0.0f, gtf = -1.0f;
  if (lane < kGroups && lane * kTriGroup < cnt) {
    const float4* g = tb.grp_rec + (long long)cid * (2 * kGroups) + 2 * lane;
    slab_rec(__ldg(g), __ldg(g + 1), r, gtn, gtf);
  }
  // the groups that pass at the best t on entry hold every candidate
  const float entry = h.t;
  unsigned rem = __ballot_sync(kFull, gate(gtn, gtf, entry)) & ((1u << kGroups) - 1);
  if (!rem) return false;
  const unsigned gbits = rem;
  // a hit at exactly the entry best t wins when this cluster's slots come
  // before the best hit's in (inst, slot)
  const bool tie_ok = !kAny && h.slot >= 0 &&
                      (in < h.inst || (in == h.inst && cid * kCluster < h.slot));
  const float4* q = tb.tri_rec + (long long)cid * (3 * kCluster);
  const float inf = __int_as_float(0x7f800000);
  // lane g < 8 ends up holding group g's first (t, slot) minimum
  float my_gt = inf;
  int my_gk = kCluster;
  while (rem) {
    const int g0 = __ffs(rem) - 1;
    rem &= rem - 1;
    const int g1 = rem ? __ffs(rem) - 1 : -1;
    if (rem) rem &= rem - 1;
    const int g = lane < kTriGroup ? g0 : g1;
    const int k = g * kTriGroup + (lane & (kTriGroup - 1));
    float t = inf;
    int kk = kCluster;
    if (g >= 0 && k < cnt) {
      const MtHit m = mt_rec(q + 3 * k, r);
      if (m.valid && (m.t < entry || (tie_ok && m.t == entry))) {
        t = m.t;
        kk = k;
      }
    }
    if (kAny) {
      if (__any_sync(kFull, t < inf)) return true;
      continue;
    }
#pragma unroll
    for (int off = kTriGroup / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, t, off);
      const int ok = __shfl_xor_sync(kFull, kk, off);
      if (ot < t || (ot == t && ok < kk)) {
        t = ot;
        kk = ok;
      }
    }
    const float t0 = __shfl_sync(kFull, t, 0), t1 = __shfl_sync(kFull, t, kTriGroup);
    const int k0 = __shfl_sync(kFull, kk, 0), k1 = __shfl_sync(kFull, kk, kTriGroup);
    if (lane == g0) {
      my_gt = t0;
      my_gk = k0;
    }
    if (lane == g1) {
      my_gt = t1;
      my_gk = k1;
    }
  }
  if (kAny) return false;
  // the one-lane walk: each group gated against the best t the earlier
  // groups left, then its minimum by the (t, slot) rule
  float cur = entry;
  bool cur_tie = tie_ok;
  int win = -1;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float tn_g = __shfl_sync(kFull, gtn, g), tf_g = __shfl_sync(kFull, gtf, g);
    const float gt = __shfl_sync(kFull, my_gt, g);
    const int gk = __shfl_sync(kFull, my_gk, g);
    if (((gbits >> g) & 1u) && gate(tn_g, tf_g, cur) && (gt < cur || (cur_tie && gt == cur))) {
      cur = gt;
      win = gk;
      cur_tie = false;
    }
  }
  if (win < 0) return false;
  // the winner's barycentrics, computed as the one-lane walk computes them
  const MtHit m = mt_rec(q + 3 * win, r);
  h.t = cur;
  h.slot = cid * kCluster + win;
  h.inst = in;
  h.u = m.u;
  h.v = m.v;
  return false;
}

// supercluster s: its member clusters in table order
template <bool kAny, bool kShared>
__device__ __forceinline__ bool warp_sc(const Tables& tb, const Top& top, const Ray& r, int in,
                                        int s, int lane, Hit& h) {
  const float4 lo = ld4<kShared>(top.sc + 2 * s), hi = ld4<kShared>(top.sc + 2 * s + 1);
  const int mcount = __float_as_int(lo.w);
  const float4* cl = top.cl + 2 * __float_as_int(hi.w);
  for (int j0 = 0; j0 < mcount; j0 += 32) {
    const int j = j0 + lane;
    float tn = 0.0f, tf = -1.0f;
    int cnt = 0, cid = 0;
    if (j < mcount) {
      const float4 clo = ld4<kShared>(cl + 2 * j), chi = ld4<kShared>(cl + 2 * j + 1);
      slab_rec(clo, chi, r, tn, tf);
      cnt = (int)clo.w;
      cid = (int)chi.w;
    }
    unsigned bits = __ballot_sync(kFull, gate(tn, tf, h.t));
    while (bits) {
      const int p = __ffs(bits) - 1;
      bits &= bits - 1;
      const float tn_p = __shfl_sync(kFull, tn, p), tf_p = __shfl_sync(kFull, tf, p);
      const int cid_p = __shfl_sync(kFull, cid, p), cnt_p = __shfl_sync(kFull, cnt, p);
      if (!gate(tn_p, tf_p, h.t)) continue;
      if (warp_cluster<kAny>(tb, r, in, cid_p, cnt_p, lane, h)) return true;
    }
  }
  return false;
}

// The ray w (alive; h.t its tmax) through every instance, front to back.
// Positions are tested 32 at a time (key bound, supercluster box) and the
// ones that pass or exit visited in order: a skipped position fails its
// gate at the best t of the ballot and so later, and keys ascend, so the
// first exit the one-lane walk takes is taken at the next visited
// position at the latest. Returns true at any-hit's first hit.
template <bool kAny, bool kShared>
__device__ __forceinline__ bool warp_walk(const Tables& tb, const Top& top, const Ray& w, int lane,
                                          Hit& h) {
  h.t = fminf(h.t, root_exit_clamp(tb.root, w));
  for (int in = 0; in < tb.n_inst; ++in) {
    const float4 ilo = __ldg(tb.inst_rec + 2 * in), ihi = __ldg(tb.inst_rec + 2 * in + 1);
    if (!slab_box(ilo.x, ilo.y, ilo.z, ihi.x, ihi.y, ihi.z, w, h.t)) continue;
    const Ray r = tb.identity ? w : to_object(tb.inst_xf + 3 * in, w);
    const int sc_lo = __float_as_int(ilo.w), sc_n = __float_as_int(ihi.w);
    const Order oc = order_of(r);
    const int base = oc.o * tb.n_sc + sc_lo;
    bool stop = false;
    for (int k0 = 0; k0 < sc_n && !stop; k0 += 32) {
      const int k = k0 + lane;
      float lb = 0.0f, tn = 0.0f, tf = -1.0f;
      int s = 0;
      if (k < sc_n) {
        lb = (ld1<kShared>(top.key + base + k) - oc.op) * oc.ip;
        s = ld1<kShared>(top.order + base + k);
        slab_rec(ld4<kShared>(top.sc + 2 * s), ld4<kShared>(top.sc + 2 * s + 1), r, tn, tf);
      }
      const bool out = k < sc_n && oc.exit_ok && lb > h.t;
      unsigned bits = __ballot_sync(kFull, out || gate(tn, tf, h.t));
      while (bits) {
        const int p = __ffs(bits) - 1;
        bits &= bits - 1;
        const float lb_p = __shfl_sync(kFull, lb, p);
        const float tn_p = __shfl_sync(kFull, tn, p), tf_p = __shfl_sync(kFull, tf, p);
        const int s_p = __shfl_sync(kFull, s, p);
        if (oc.exit_ok && lb_p > h.t) {
          stop = true;
          break;
        }
        if (!gate(tn_p, tf_p, h.t)) continue;
        if (warp_sc<kAny, kShared>(tb, top, r, in, s_p, lane, h)) return true;
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// kernel

__device__ __forceinline__ void store(const Tables& tb, const Out& out, int i, float tmax,
                                      const Hit& h, bool occ, bool any) {
  if (any) {
    out.occ[i] = occ ? 1 : 0;
    return;
  }
  const bool hit = h.slot >= 0;
  out.t[i] = hit ? h.t : tmax;
  out.prim[i] = hit ? (int)__ldg(reinterpret_cast<const float*>(tb.tri_rec) + 12LL * h.slot + 3)
                    : -1;
  out.u[i] = h.u;
  out.v[i] = h.v;
  out.inst[i] = h.inst;
  out.slot[i] = h.slot;
}

template <bool kAny, bool kStaged>
__global__ void __launch_bounds__(kBlock, kAny ? 3 : 1)
    k_clustered(const float* __restrict__ rays, long long stride, int m, const Tables tb,
                const Out out) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const float tmax = i < m ? rays[6 * stride + i] : 0.0f;
  const bool alive = tmax > 0.0f;
  Top top{tb.sc_rec, tb.cl_rec, tb.sc_key, tb.sc_order};
  if (kStaged) {
    // a block without a live lane stages nothing
    if (!__syncthreads_or(alive)) {
      if (i < m) store(tb, out, i, tmax, Hit{tmax, -1, 0, 0.0f, 0.0f}, false, kAny);
      return;
    }
    top = stage_top(smem, tb);
  }
  Hit mine{tmax, -1, 0, 0.0f, 0.0f};
  bool my_occ = false;
  unsigned live = __ballot_sync(kFull, alive);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    const int j = i - lane + src;
    Hit h{rays[6 * stride + j], -1, 0, 0.0f, 0.0f};
    const Ray w = make_ray(rays[j], rays[stride + j], rays[2 * stride + j],
                           rays[3 * stride + j], rays[4 * stride + j], rays[5 * stride + j]);
    const bool occ = warp_walk<kAny, kStaged>(tb, top, w, lane, h);
    if (lane == src) {
      mine = h;
      my_occ = occ;
    }
  }
  if (i < m) store(tb, out, i, tmax, mine, my_occ, kAny);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// the staged kernels' shared memory (stage_top's layout), 0 where it
// exceeds kStageBytesMax and the kernels read the tables from global memory
size_t stage_bytes(int n_sc, int n_cl) {
  const size_t b = (size_t)32 * n_sc + (size_t)32 * n_cl + (size_t)8 * kOrders * n_sc;
  return b <= kStageBytesMax ? b : 0;
}

template <bool kAny>
int launch(const float* rays, long long stride, int m, const float* root, const float* inst_rec,
           const float* inst_xf, int n_inst, int identity, const float* sc_rec,
           const int* sc_order, const float* sc_key, int n_sc, const float* cl_rec,
           const float* grp_rec, const float* tri_rec, int n_cl, int staged, float* t, int* prim,
           float* u, float* v, int* inst, int* slot, unsigned char* occ, cudaStream_t stream) {
  if (m < 1 || n_inst < 1 || n_sc < 1 || n_cl < 1) return (int)cudaErrorInvalidValue;
  if (kAny ? occ == nullptr : (t == nullptr || prim == nullptr || u == nullptr || v == nullptr ||
                                inst == nullptr || slot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(inst_rec) || !aligned16(inst_xf) || !aligned16(sc_rec) || !aligned16(cl_rec) ||
      !aligned16(grp_rec) || !aligned16(tri_rec))
    return (int)cudaErrorMisalignedAddress;
  Tables tb;
  tb.root = root;
  tb.inst_rec = reinterpret_cast<const float4*>(inst_rec);
  tb.inst_xf = reinterpret_cast<const float4*>(inst_xf);
  tb.sc_rec = reinterpret_cast<const float4*>(sc_rec);
  tb.sc_order = sc_order;
  tb.sc_key = sc_key;
  tb.cl_rec = reinterpret_cast<const float4*>(cl_rec);
  tb.grp_rec = reinterpret_cast<const float4*>(grp_rec);
  tb.tri_rec = reinterpret_cast<const float4*>(tri_rec);
  tb.n_inst = n_inst;
  tb.n_sc = n_sc;
  tb.n_cl = n_cl;
  tb.identity = identity;
  const Out out{t, prim, u, v, inst, slot, occ};
  const int grid = (m + kBlock - 1) / kBlock;
  const size_t smem = staged ? stage_bytes(n_sc, n_cl) : 0;
  if (smem) {
    k_clustered<kAny, true><<<grid, kBlock, smem, stream>>>(rays, stride, m, tb, out);
  } else {
    k_clustered<kAny, false><<<grid, kBlock, 0, stream>>>(rays, stride, m, tb, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_CLUSTERED_ARGS                                                                        \
  const float *rays, long long stride, int m, const float *root, const float *inst_rec,          \
      const float *inst_xf, int n_inst, int identity, const float *sc_rec, const int *sc_order,  \
      const float *sc_key, int n_sc, const float *cl_rec, const float *grp_rec,                  \
      const float *tri_rec, int n_cl, int staged, float *t, int *prim, float *u, float *v,       \
      int *inst, int *slot, unsigned char *occ, cudaStream_t stream
#define FH_CLUSTERED_PASS                                                                        \
  rays, stride, m, root, inst_rec, inst_xf, n_inst, identity, sc_rec, sc_order, sc_key, n_sc, \
      cl_rec, grp_rec, tri_rec, n_cl, staged, t, prim, u, v, inst, slot, occ, stream

extern "C" int fh_clustered_closest(FH_CLUSTERED_ARGS) { return launch<false>(FH_CLUSTERED_PASS); }

extern "C" int fh_clustered_any(FH_CLUSTERED_ARGS) { return launch<true>(FH_CLUSTERED_PASS); }

extern "C" long long fh_clustered_stage_bytes(int n_sc, int n_cl) {
  return (long long)stage_bytes(n_sc, n_cl);
}
