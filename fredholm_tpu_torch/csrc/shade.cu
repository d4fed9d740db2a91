// The shading stages of the fused path tracer: raygen, mega, final.
//
// Replace fredholm_tpu/fused/kernels.py `tiled_map` as the reference runs
// it from `_raygen_tiled`, `_mega_tiled` and `_final_tiled`
// (fused/pt_fused.py:1331-1384) over `raygen_body`, `mega_body` and
// `final_resolve_body`. Plain twins: fredholm_tpu_torch/fused/pt_fused.py
// `raygen_twin`, `mega_twin`, `final_twin`.
//
// One thread per lane over the packed SoA planes of pt_fused.py. `mega`
// and `final` take a hit's geometry from the slot-fetch planes (clustered
// scenes, csrc/slot_fetch.cu) or fetch the fused_table row of the clamped
// prim themselves (dense scenes), then the material row by the rounded,
// clamped mat_id (`_attrs`). Each NEE block's occlusion comes from the
// trace that carried it: the any-hit booleans (`occ`, clustered scenes)
// or the closest hit's prim. `mega` writes each emitted ray block into its
// slice of one [7, B*N] buffer, so the next trace reads it in place.
// Envelope: constant or Hosek sky, optional sun (directional light), the
// ten texture kinds of pt_fused.TEX_KINDS, all seven BSDF lobes of
// cbsdf.ALL_LOBES (common.cuh); the wrapper raises on anything else.
//
// `mega` comes in four variants, one body compiled four ways, each with
// its own register budget. The plain one (constant sky, no sun, diffuse_r
// only) and the rich one (Hosek sky, sun, metal and specular) shade with
// `Bsdf`; the full one, which `fh_mega` launches whenever the scene has a
// coat, transmission, sheen or diffuse transmission, with `BsdfFull`, so
// the lobes it adds cost the other two nothing. The textured one
// (`k_mega_tex`, every feature of the full one) takes every scene whose
// materials use a texture (`tex_mask`), and `k_final`'s textured instance
// the same scenes.
//
// Textures. The reference fetches texels in its jnp gather stage, outside
// the Pallas kernel, into planes the kernel reads (pt_fused.py:534
// `fetch_texture_planes`; Mosaic has no gather). Here the kernel fetches
// them itself, from the run atlas (common.cuh `tex_fetch`) with the header
// the material row carries in its tx_<kind> columns: for each kind of
// `tex_mask` a material has (texture id >= 0), one run row a tap (three
// for the heightmap). It overrides the shading columns in a copy of the
// row (`_apply_tex_overrides`), bumps then normal-maps the shading frame
// (pt_fused.py:837-872), and replaces the emission at the first hit and at
// the light ray's hit (`emission_from_attrs`); NEE toward an area light
// keeps the light table's untextured emission, as the reference does.
//
// Bound of `mega` on the H100: bytes. At metric 1's d >= 1 a lane reads
// 172 B (its state, sample index and n_spp, the pending rows of its
// variant, the light ray's origin and direction, prim, u and v of the light
// and radiance blocks, the NEE blocks' prims) and writes 224 B (state,
// pending rows, four ray blocks): 0.031 ms at 3.35 TB/s for 262,144 lanes
// (d = 0: 360 B a lane, 0.028 ms), against ~1500 operations a lane,
// hashing included (0.006 ms at 67 TFLOP/s, 0.012 unfused). The full
// variant reads the sheen table too and does ~3300 operations a lane:
// at transmission_rough's d = 1 (262,144 lanes) still bytes, 0.0315 ms
// against 0.013 (0.026 unfused).
//
// The design of `mega`, for what held the first one (every lane through
// the whole select-style body at 119 and 148 registers: 4 and 3 blocks an
// SM), ~2.6x above its bound (each step measured in turns, PERF.md):
// - Registers fitted to the resident blocks an SM that time best: the body
//   waits on its ~60 loads and gathers, and more warps hide more of that.
//   Spills are kept where they win: the plain variant at 6 blocks (80
//   registers, 72 B of spill stores) against 5 (96, spilling too) and 4
//   or 3 (128, no spills), which take 1.03-1.08x its time on metric 1's
//   bounces; the rich one at 5 (96 registers, 104 B) against 6 (80, 220
//   B) and 3 (152, none), which take 1.15x its time on metric 2's d = 1;
//   the full one's whole body at 4 (128 registers) against 5 (96) and 3
//   (164), which took 1.06x and 1.16x its time at transmission_rough's
//   d = 1.
// - A short path through the same body for lanes that shade nothing (not
//   alive, or their ray missed): the work whose results the body masks away
//   for them (the NEE BSDF evaluations and skies, the next bounce's sample
//   and its draws, the RR draw) sits behind `alive` and is skipped. What
//   they write is what the full body writes for them, bit for bit: zero
//   contributions, tmax -1 rays (their origins and directions as the body
//   computes them), the light ray's pdf, the stale state. It gains where
//   whole warps are dead and the skipped work is dear (metric 2: Hosek
//   skies, the metal and specular lobes) and costs ~1% where not.
// Measured and dropped: compacting each block's shading lanes to the front
// (homogeneous warps, but every plane read and written out of order: 0.8x
// on metric 1's bounces, 1.03x on metric 2's), and staging the fused_table
// and material rows in shared memory as 16-byte records (no gain beyond
// the noise, and more registers).
//
// The full variant past d = 0, for what held it in one pass (PERF.md, at
// transmission_rough's d = 1): under 5% of the lanes shade (alive, and
// their ray hit), bunched in image space (1,598 of 8,192 warps, ~7.7
// each), while every lane runs the BSDF setup and the light ray's sample,
// whose direction and pdf it writes. One body at 128 registers ran the
// floor of the other 95% at the shading lanes' 4 blocks an SM, and each
// warp holding a few shading lanes ran their long chain for them. The
// lobes vary little inside a warp (at most 3 sets, 1.15 on average):
// divergence across lobes is not the cost.
// - The floor pass (`k_mega_full_floor`): a lane that shades nothing runs
//   the body with `alive` false at compile time, so the evaluations, the
//   next bounce's sample and all that only feeds a contribution (the light
//   sample's value, the layer multipliers, the metal Fresnel) fold away:
//   80 registers, 6 blocks an SM.
// - The shading pass (`k_mega_full`, the whole body): the shading lanes,
//   queued in lane order one atomic a warp (`k_mega_full_queue`), run the
//   whole body 32 to a warp. They are too few warps to hide one body's
//   chain, so the pass does not follow the floor pass: it starts first and
//   lets the floor pass launch beside it (programmatic dependent launch),
//   and the floor pass's last block waits for it. Where an eighth of the
//   lanes or more shade, it runs the whole body on every lane, and the
//   floor pass none; at d = 0, where many do (38% at transmission_rough's),
//   it runs alone on every lane, without the queue.
// - Two choices of the whole body on every lane, each measured against
//   the other (PERF.md): the host takes it at d = 0, without the queue
//   (the count's choice there costs the queue kernel and an empty floor
//   pass, 1.09-1.10x); past it the count takes it where an eighth of the
//   lanes or more shade (the queue there costs 1.16x at 38% shading).
// - The queue's buffer is zeroed once and kept by the wrapper; the floor
//   pass's last block zeroes its counters for the next launch, so a launch
//   costs the host its three kernel launches and nothing more.
// Measured and dropped for it (PERF.md): the two passes in turn (the
// shading pass's chain after the floor), in one kernel taking the queue
// first (the floor at the shading pass's registers), on two streams (no
// order between the two grids), a lane's three sections (NEE, light ray,
// next bounce) on three warps (three times the loads), and each block
// packing its own run of lanes (the bunched runs' chains in turn).
//
// The textured variant past d = 0 takes the same shape (PERF.md, at
// texture's d = 1): about 1% of the lanes shade, in an eighth of the
// warps (~2.6 each), and one body at 128 registers ran every lane. It
// splits as the full variant does, into the queue, the whole textured
// body as the shading pass (`k_mega_tex`) and a floor pass
// (`k_mega_tex_floor`) launched beside it; the host and the count keep
// their choices. A lane that shades nothing still writes what its texels
// decide: the bump and normal maps turn the frame its NEE and light rays
// leave from, and the overrides feed the setup whose `bsdf_sample` writes
// the light ray's direction and pdf. So the floor pass keeps those taps,
// and the light hit's emission tap in `resolve_pending`; the rest of the
// body folds away with `alive`, as in the full variant's floor pass. The
// body carries the ten columns the textures may override beside the row
// pointer (`TexRow`), not a copy of the row's first 34 columns, so the
// setup reads the others from the row where it uses them: the floor pass
// fits 6 blocks an SM (80 registers) without spills, the whole body 4.
// Measured against each other in turns (PERF.md): the copy (2.4-6.6%
// slower at every d), the floor pass at 4, 5, 7 or 8 blocks an SM and the
// whole body at 3 (within the build's noise past d = 0, or slower on some
// setups; the whole body at 3 costs 20% at d = 0), the queue at d = 0 (the
// count's choice 1.21x, the queue whatever the count 1.28x), and the Sobol
// draws' direction numbers read as 16-byte loads (no gain: they sit in
// L1). Past d = 0 the floor pass is the kernel's time.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;
// the resident blocks an SM that ptxas fits each mega variant's registers to
constexpr int kMegaBlocksPlain = 6;
constexpr int kMegaBlocksRich = 5;
constexpr int kMegaBlocksFull = 4;   // the full variant's whole body
constexpr int kMegaBlocksFloor = 6;  // and its floor pass
constexpr int kMegaBlocksTex = 4;       // the textured variant's whole body
constexpr int kMegaBlocksTexFloor = 6;  // and its floor pass

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, int row, long long stride, long long i) {
  return v3(p[row * stride + i], p[(row + 1) * stride + i], p[(row + 2) * stride + i]);
}
__device__ __forceinline__ void st3(float* __restrict__ p, int row, long long stride, long long i, V3 v) {
  p[row * stride + i] = v.x;
  p[(row + 1) * stride + i] = v.y;
  p[(row + 2) * stride + i] = v.z;
}
__device__ __forceinline__ V3 row3(const float* __restrict__ a, int c) { return v3(a[c], a[c + 1], a[c + 2]); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// A hit's geometry columns (scene/device.py COL): a fused_table row
// (stride 1) or one lane of the slot-fetch planes (stride hits_m)
struct Geom {
  const float* p;
  long long s;
  __device__ __forceinline__ float operator[](int c) const { return p[c * s]; }
};
__device__ __forceinline__ V3 g3(const Geom& g, int c) { return v3(g[c], g[c + 1], g[c + 2]); }
__device__ __forceinline__ V3 interp3(const Geom& g, int base, float w0, float w1, float w2) {
  return v3(w0 * g[base + 0] + w1 * g[base + 3] + w2 * g[base + 6],
            w0 * g[base + 1] + w1 * g[base + 4] + w2 * g[base + 7],
            w0 * g[base + 2] + w1 * g[base + 5] + w2 * g[base + 8]);
}

// `_attrs`: the geometry of closest-hit lane j (slot-fetch planes, or the
// fused_table row of the clamped prim), then the material row by the
// rounded, clamped mat_id
__device__ __forceinline__ void attrs(const ShadeArgs& a, long long j, Geom& g, const float*& m) {
  if (a.geom != nullptr) {
    g.p = a.geom + j;
    g.s = a.hits_m;
  } else {
    g.p = a.fused_table + (long long)clampi(a.hit_prim[j], 0, a.n_faces - 1) * GEOM_COLS;
    g.s = 1;
  }
  int mid = clampi((int)rintf(g[C_MAT_ID]), 0, a.n_mats - 1);
  m = a.mat_table + (long long)mid * MAT_COLS;
}

// occlusion of input ray block b, from whichever trace carried it
__device__ __forceinline__ bool occluded(const ShadeArgs& a, int b, int i) {
  const long long n = a.n;
  if (b < a.hit_block0) return a.occ[b * n + i] != 0;
  return a.hit_prim[(b - a.hit_block0) * n + i] >= 0;
}

struct Blocks {  // ray block indices of FusedConfig.blocks
  int dl, area, light, rad, count;
};
__device__ __forceinline__ Blocks blocks_of(const ShadeArgs& a) {
  Blocks k;
  k.dl = a.has_dl ? 1 : -1;
  k.area = a.n_lights > 0 ? 1 + (a.has_dl ? 1 : 0) : -1;
  k.light = 1 + (a.has_dl ? 1 : 0) + (a.n_lights > 0 ? 1 : 0);
  k.rad = k.light + 1;
  k.count = k.rad + 1;
  return k;
}

__device__ __forceinline__ void store_ray(const ShadeArgs& a, int nb, int blk, int i, V3 o, V3 d,
                                          float tmax) {
  long long s = (long long)a.n * nb;
  long long j = (long long)blk * a.n + i;
  st3(a.rays_out, 0, s, j, o);
  st3(a.rays_out, 3, s, j, d);
  a.rays_out[6 * s + j] = tmax;
}

__device__ __forceinline__ float nee_tmax(V3 c, float tmax) {
  return (c.x > 0.0f || c.y > 0.0f || c.z > 0.0f) ? tmax : -1.0f;
}

// A kernel variant: kRich takes the Hosek sky, the sun block and every
// CUDA lobe from the launch arguments; !kRich is the constant-sky,
// no-sun, diffuse_r-only configuration with those features compiled out,
// which keeps its register count (and occupancy) at slice 1's
struct Features {
  int sky_mode, has_dl, lobe_mask;
};
template <bool kRich>
__device__ __forceinline__ Features features(const ShadeArgs& a) {
  Features f;
  f.sky_mode = kRich ? a.sky_mode : SKY_CONSTANT;
  f.has_dl = kRich ? a.has_dl : 0;
  f.lobe_mask = kRich ? a.lobe_mask : (a.lobe_mask & LOBE_DIFFUSE_R);
  return f;
}
inline bool needs_rich(const ShadeArgs* a) {
  return (a->lobe_mask & ~LOBE_DIFFUSE_R) != 0 || a->sky_mode != SKY_CONSTANT || a->has_dl != 0;
}
inline bool needs_full(const ShadeArgs* a) { return (a->lobe_mask & LOBES_FULL_ONLY) != 0; }

// The shading columns of a textured hit: its material row, with the ten
// columns `_apply_tex_overrides` may override held beside it (base colour;
// specular colour, specular roughness, metalness, coat, coat roughness)
struct TexRow {
  const float* __restrict__ m;
  float base[3];  // columns M_BASE_COLOR .. + 2
  float spec[7];  // columns M_SPECULAR_COLOR .. M_COAT_ROUGHNESS
  __device__ __forceinline__ float& at(int k) {
    return k < M_SPECULAR_COLOR ? base[k - M_BASE_COLOR] : spec[k - M_SPECULAR_COLOR];
  }
  __device__ __forceinline__ float operator[](int k) const {
    if (k >= M_BASE_COLOR && k < M_BASE_COLOR + 3) return base[k - M_BASE_COLOR];
    if (k >= M_SPECULAR_COLOR && k <= M_COAT_ROUGHNESS) return spec[k - M_SPECULAR_COLOR];
    return m[k];
  }
};
__device__ __forceinline__ V3 row3(const TexRow& r, int c) { return v3(r[c], r[c + 1], r[c + 2]); }

// the shading BSDF of a mega variant: BsdfFull for the full one, else Bsdf
template <bool kFull>
__device__ __forceinline__ auto shading_bsdf(const ShadeArgs& a, const float* __restrict__ m, V3 wo,
                                             bool entering, int lobe_mask) {
  if constexpr (kFull)
    return bsdf_setup_full(m, wo, entering, lobe_mask, a.lut, a.sheen_lut);
  else
    return bsdf_setup(m, wo, entering, lobe_mask, a.lut);
}
// and the textured one's, on the row with its overrides
template <bool kFull>
__device__ __forceinline__ BsdfFull shading_bsdf(const ShadeArgs& a, const TexRow& m, V3 wo, bool entering,
                                                 int lobe_mask) {
  return bsdf_setup_full<TexRow>(m, wo, entering, lobe_mask, a.lut, a.sheen_lut);
}

// texture kind k's tx columns of material row m: the texture id, then the
// header tex_fetch takes
__device__ __forceinline__ const float* tx(const float* __restrict__ m, int k) {
  return m + M_TX0 + TX_COLS * k;
}
// whether a material row uses texture kind k (its bit, TEX_KINDS[k], is in
// the launch's tex_mask and its texture id is >= 0)
__device__ __forceinline__ bool tex_has(const ShadeArgs& a, const float* __restrict__ m, int k) {
  return (a.tex_mask & (1 << k)) != 0 && tx(m, k)[0] >= 0.0f;
}
__device__ __forceinline__ Texel4 tex_at(const ShadeArgs& a, const float* __restrict__ m, int k, float u,
                                         float v) {
  return tex_fetch(a.tex_runs, a.n_tex_runs, tx(m, k) + 1, u, v);
}
constexpr int kTexEmission = 7, kTexNormalmap = 8, kTexHeightmap = 9;  // TEX_KINDS indices

// `emission_from_attrs`: the emission of material row m at uv (u, v)
__device__ __forceinline__ V3 emission_at(const ShadeArgs& a, const float* __restrict__ m, float u, float v) {
  if (!tex_has(a, m, kTexEmission)) return row3(m, M_EMISSION_COLOR);
  const Texel4 c = tex_at(a, m, kTexEmission, u, v);
  return v3(c.r, c.g, c.b);
}

// The textured shading of a hit at uv (u, v): its shading columns, with
// `_apply_tex_overrides` applied in its order; the frame (n_s, t, b) is
// bumped, then normal-mapped on the unperturbed frame (pt_fused.py:837-872)
__device__ __forceinline__ TexRow tex_shading(const ShadeArgs& a, const float* __restrict__ m, float u, float v,
                                              V3& n_s, V3& t, V3& b) {
  TexRow r;
  r.m = m;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.base[c] = m[M_BASE_COLOR + c];
#pragma unroll
  for (int c = 0; c < 7; ++c) r.spec[c] = m[M_SPECULAR_COLOR + c];
  if (tex_has(a, m, 0)) {  // base_color
    const Texel4 c = tex_at(a, m, 0, u, v);
    r.at(M_BASE_COLOR) = c.r;
    r.at(M_BASE_COLOR + 1) = c.g;
    r.at(M_BASE_COLOR + 2) = c.b;
  }
  if (tex_has(a, m, 1)) {  // specular_color
    const Texel4 c = tex_at(a, m, 1, u, v);
    r.at(M_SPECULAR_COLOR) = c.r;
    r.at(M_SPECULAR_COLOR + 1) = c.g;
    r.at(M_SPECULAR_COLOR + 2) = c.b;
  }
  if (tex_has(a, m, 2)) r.at(M_SPECULAR_ROUGHNESS) = jclip(tex_at(a, m, 2, u, v).r, 0.01f, 1.0f);
  if (tex_has(a, m, 3)) r.at(M_METALNESS) = tex_at(a, m, 3, u, v).r;
  if (tex_has(a, m, 4)) {  // metallic_roughness, glTF packing: g roughness, b metalness
    const Texel4 c = tex_at(a, m, 4, u, v);
    r.at(M_SPECULAR_ROUGHNESS) = jclip(c.g, 0.01f, 1.0f);
    r.at(M_METALNESS) = jclip(c.b, 0.0f, 1.0f);
  }
  if (tex_has(a, m, 5)) r.at(M_COAT) = jclip(tex_at(a, m, 5, u, v).r, 0.0f, 1.0f);
  // reference quirk, mirrored: coat roughness reads channel .g (pt_fused.py:644)
  if (tex_has(a, m, 6)) r.at(M_COAT_ROUGHNESS) = jclip(tex_at(a, m, 6, u, v).g, 0.0f, 1.0f);

  V3 pt = t, pb = b, pn = n_s;
  if (tex_has(a, m, kTexHeightmap)) {
    // forward differences one texel away; the step is 0 for a header of
    // width 0, where the reference divides by it (ROADMAP Queue C item 4)
    const float* hh = tx(m, kTexHeightmap) + 1;
    const float du = hh[1] > 0.0f ? 1.0f / hh[1] : 0.0f;
    const float dv = hh[2] > 0.0f ? 1.0f / hh[2] : 0.0f;
    const float h0 = tex_at(a, m, kTexHeightmap, u, v).r;
    const float dfdu = tex_at(a, m, kTexHeightmap, u + du, v).r - h0;
    const float dfdv = tex_at(a, m, kTexHeightmap, u, v + dv).r - h0;
    pt = normalize(t + n_s * dfdu, 0.0f);
    pb = normalize(b + n_s * dfdv, 0.0f);
    pn = normalize(cross(pt, pb), 0.0f);
  }
  if (tex_has(a, m, kTexNormalmap)) {
    // a tangent-space map with +Z normal in a +Y local frame: (x, z, y)
    const Texel4 c = tex_at(a, m, kTexNormalmap, u, v);
    pn = normalize(local_to_world(v3(c.r * 2.0f - 1.0f, c.b * 2.0f - 1.0f, c.g * 2.0f - 1.0f), t, n_s, b),
                   0.0f);
    onb(pn, pt, pb);
  }
  t = pt;
  b = pb;
  n_s = pn;
  return r;
}

// the shading columns of a mega variant's hit: the material row, or (kTex)
// the textured row, whose taps also bump and normal-map the frame
template <bool kTex>
__device__ __forceinline__ auto shading_row(const ShadeArgs& a, const float* __restrict__ m, float u, float v,
                                            V3& n_s, V3& t, V3& b) {
  if constexpr (kTex)
    return tex_shading(a, m, u, v, n_s, t, b);
  else
    return m;
}

// `_resolve_pending`: bounce d-1's NEE visibility + BSDF-light-ray MIS;
// kTex: the light ray's hit shows the emission texture
template <bool kRich, bool kTex>
__device__ __forceinline__ V3 resolve_pending(const ShadeArgs& a, int i, V3 rad) {
  const long long n = a.n;
  const Features ft = features<kRich>(a);
  const Blocks k = blocks_of(a);
  const float* pd = a.pending_in;
  rad = rad + (occluded(a, 0, i) ? zero3() : ld3(pd, PD_SKY, n, i));
  if (ft.has_dl) rad = rad + (occluded(a, k.dl, i) ? zero3() : ld3(pd, PD_DL, n, i));
  if (a.n_lights > 0) rad = rad + (occluded(a, k.area, i) ? zero3() : ld3(pd, PD_AREA, n, i));
  const long long li = k.light * n + i;
  const V3 ldir = ld3(a.rays_in, 3, a.rays_in_stride, li);
  const bool l_hit = occluded(a, k.light, i);
  const V3 le_miss = eval_sky(a.sv, ft.sky_mode, ldir);
  float pdf_light_miss = fabsf(pd[PD_WI_L_Y * n + i]) / F_PI;
  V3 le;
  float pdf_light;
  if (a.n_lights == 0) {
    le = l_hit ? zero3() : le_miss;
    pdf_light = pdf_light_miss;
  } else {
    const long long j = (k.light - a.hit_block0) * n + i;
    Geom g;
    const float* m;
    attrs(a, j, g, m);
    float lw1 = a.hit_u[j], lw2 = a.hit_v[j];
    float lw0 = 1.0f - lw1 - lw2;
    V3 l_p = interp3(g, C_V0, lw0, lw1, lw2);
    V3 l_n = interp3(g, C_N0, lw0, lw1, lw2);
    bool l_emissive = (m[M_HAS_EMISSION] > 0.0f) && (dot(-ldir, l_n) > 0.0f);
    bool hit_light = l_hit && l_emissive;
    V3 le_hit = row3(m, M_EMISSION_COLOR);
    if constexpr (kTex) {
      if (hit_light) {
        const float lu = lw0 * g[C_UV0] + lw1 * g[C_UV0 + 2] + lw2 * g[C_UV0 + 4];
        const float lv = lw0 * g[C_UV0 + 1] + lw1 * g[C_UV0 + 3] + lw2 * g[C_UV0 + 5];
        le_hit = emission_at(a, m, lu, lv);
      }
    }
    le = l_hit ? (hit_light ? le_hit : zero3()) : le_miss;
    V3 to_p = l_p - ld3(a.rays_in, 0, a.rays_in_stride, li);
    float r2 = dot(to_p, to_p);
    float n_l = (float)(a.n_lights > 1 ? a.n_lights : 1);
    float pdf_area_hit = 1.0f / (n_l * jmax(g[C_AREA], 1e-12f));
    float pdf_light_hit = r2 / jmax(fabsf(dot(-ldir, l_n)), 1e-12f) * pdf_area_hit;
    pdf_light = hit_light ? pdf_light_hit : pdf_light_miss;
  }
  float pdf_l = pd[PD_PDF_L * n + i];
  float mis_w = pdf_l > 0.0f ? pdf_l / jmax(pdf_l + pdf_light, 1e-20f) : 0.0f;
  V3 w = clip3(ld3(pd, PD_TPF, n, i) * mis_w, 0.0f, 1.0f);
  return rad + w * le;
}

__global__ void __launch_bounds__(kBlock) k_raygen(const ShadeArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  const float* sv = a.sv;
  uint32_t seed = (uint32_t)a.usv[0];
  uint32_t n_pixels = (uint32_t)a.usv[1];
  uint32_t n_spp = (uint32_t)a.n_spp[i];
  uint32_t image_idx = (uint32_t)i;
  uint32_t sample_idx = image_idx + n_spp * n_pixels;
  float px = (float)(i % a.width);
  float py = (float)(i / a.width);

  float jx, jy, lx, ly;
  draw_cmj_2d(n_spp, image_idx, 0u, seed, jx, jy);
  draw_cmj_2d(n_spp, image_idx, 1u, seed, lx, ly);
  float u = (2.0f * (px + jx) - (float)a.width) / (float)a.height;
  float v = (2.0f * (py + jy) - (float)a.height) / (float)a.height;
  float uvx = -u, uvy = v;

  float f = 1.0f / tanf(0.5f * sv[12]);
  float b = sv[14];
  float aa = 1.0f / (1.0f + f - 1.0f / b);
  float lens_radius = 2.0f * f / sv[13];
  float dx, dy;
  concentric_disk(lx, ly, dx, dy);
  V3 p_lens = v3(0.0f + lens_radius * dx, 0.0f + lens_radius * dy, f);
  V3 stl = normalize(v3(0.0f - uvx, 0.0f - uvy, f - 0.0f), 0.0f);
  float t_obj = (aa + b) / stl.z;
  V3 p_object = v3(uvx + t_obj * stl.x, uvy + t_obj * stl.y, 0.0f + t_obj * stl.z);
  const float* m = sv;
  V3 origin = v3(m[0] * p_lens.x + m[1] * p_lens.y + m[2] * p_lens.z + m[3],
                 m[4] * p_lens.x + m[5] * p_lens.y + m[6] * p_lens.z + m[7],
                 m[8] * p_lens.x + m[9] * p_lens.y + m[10] * p_lens.z + m[11]);
  V3 dl = normalize(p_object - p_lens, 0.0f);
  dl.z = -dl.z;  // z-flip (camera.cu:19)
  V3 dir = v3(m[0] * dl.x + m[1] * dl.y + m[2] * dl.z, m[4] * dl.x + m[5] * dl.y + m[6] * dl.z,
              m[8] * dl.x + m[9] * dl.y + m[10] * dl.z);

  // depth-0 RR draw (prob 1; the draw is still consumed, pt.cu:455-462)
  float u_rr = sobol_owen(sample_idx, 1, seed, a.sobol);
  bool alive = u_rr < 1.0f;
  float tmax = alive ? RAY_TMAX : -1.0f;

  float* st = a.state_out;
  st3(st, ST_O, n, i, origin);
  st3(st, ST_D, n, i, dir);
  st3(st, ST_THR, n, i, v3(1.0f, 1.0f, 1.0f));
  st3(st, ST_RAD, n, i, zero3());
  st[ST_NV * n + i] = 0.0f;
  st[ST_ALIVE * n + i] = alive ? 1.0f : 0.0f;
  a.sample_idx[i] = (long long)sample_idx;
  st3(a.rays_out, 0, n, i, origin);
  st3(a.rays_out, 3, n, i, dir);
  a.rays_out[6 * n + i] = tmax;
}

// How a launch runs the body: as it stands (kPassAll), or, in the floor
// pass of the full or textured variant, on lanes that shade nothing
// (kPassFloor)
constexpr int kPassAll = 0, kPassFloor = 1;

// the body of every mega variant on lane i; kFull (which implies kRich)
// shades with the full BSDF, kTex (which implies kFull) applies the
// textures
template <bool kRich, bool kFull, bool kTex, int kPass = kPassAll>
__device__ __forceinline__ void mega_body(const ShadeArgs& a, int i) {
  if (i >= a.n) return;
  const long long n = a.n;
  const int d = a.d;
  const Features ft = features<kRich>(a);
  const bool has_area = a.n_lights > 0;
  const Blocks k = blocks_of(a);
  const int n1 = 3 + (has_area ? 1 : 0);                    // Sobol draws a bounce
  const int n2 = 3 + (ft.has_dl ? 1 : 0) + (has_area ? 1 : 0);  // CMJ draws a bounce
  const float* sv = a.sv;
  const uint32_t seed = (uint32_t)a.usv[0];
  const uint32_t n_spp = (uint32_t)a.n_spp[i];
  const uint32_t image_idx = (uint32_t)i;
  const uint32_t sidx = (uint32_t)a.sample_idx[i];

  const float* st = a.state_in;
  const V3 o_in = ld3(st, ST_O, n, i);
  const V3 dir = ld3(st, ST_D, n, i);
  const V3 thr = ld3(st, ST_THR, n, i);
  V3 rad = ld3(st, ST_RAD, n, i);
  float nv = st[ST_NV * n + i];
  bool alive = st[ST_ALIVE * n + i] != 0.0f;

  if (d > 0) rad = resolve_pending<kRich, kTex>(a, i, rad);

  // ---- shade bounce d
  const long long ri = (d == 0 ? 0 : k.rad - a.hit_block0) * n + i;
  const bool hit = a.hit_prim[ri] >= 0;
  if (d == 0) {  // sky on first-hit miss (pt.cu:504-523)
    V3 sky = zero3();
    if (alive && !hit) sky = thr * eval_sky(sv, ft.sky_mode, dir);
    rad = rad + sky;
  }
  alive = alive && hit;
  // the floor pass runs only lanes that shade nothing: every branch on
  // `alive` below folds away, and with it all that only they use
  if constexpr (kPass == kPassFloor) alive = false;
  nv = nv + (alive ? 1.0f : 0.0f);

  Geom g;
  const float* m;
  attrs(a, ri, g, m);
  const float w1 = a.hit_u[ri], w2 = a.hit_v[ri];
  const float w0 = 1.0f - w1 - w2;
  const V3 x = interp3(g, C_V0, w0, w1, w2);
  const V3 fv0 = g3(g, C_V0), fv1 = g3(g, C_V0 + 3), fv2 = g3(g, C_V0 + 6);
  V3 n_g = normalize(cross(fv1 - fv0, fv2 - fv0), 1e-20f);
  V3 n_s = normalize(interp3(g, C_N0, w0, w1, w2), 1e-20f);
  const bool entering = dot(-dir, n_g) > 0.0f;
  const float flip = entering ? 1.0f : -1.0f;
  n_s = n_s * flip;
  n_g = n_g * flip;
  V3 tangent, bitangent;
  onb(n_s, tangent, bitangent);

  float tex_u = 0.0f, tex_v = 0.0f;
  if constexpr (kTex) {
    tex_u = w0 * g[C_UV0] + w1 * g[C_UV0 + 2] + w2 * g[C_UV0 + 4];
    tex_v = w0 * g[C_UV0 + 1] + w1 * g[C_UV0 + 3] + w2 * g[C_UV0 + 5];
  }
  const auto ms = shading_row<kTex>(a, m, tex_u, tex_v, n_s, tangent, bitangent);

  if (d == 0) {  // first-hit AOVs + emissive-hit termination (pt.cu:745-760)
    const bool cap = alive;
    float tu = w0 * g[C_UV0] + w1 * g[C_UV0 + 2] + w2 * g[C_UV0 + 4];
    float tv = w0 * g[C_UV0 + 1] + w1 * g[C_UV0 + 3] + w2 * g[C_UV0 + 5];
    st3(a.aov_out, AOV_POS, n, i, cap ? x : zero3());
    st3(a.aov_out, AOV_NRM, n, i, cap ? n_s : zero3());
    a.aov_out[AOV_DEPTH * n + i] = cap ? a.hit_t[ri] : 0.0f;
    a.aov_out[AOV_TU * n + i] = cap ? tu : 0.0f;
    a.aov_out[AOV_TV * n + i] = cap ? tv : 0.0f;
    st3(a.aov_out, AOV_ALB, n, i, cap ? row3(ms, M_BASE_COLOR) : zero3());
    const bool emit_now = cap && (m[M_HAS_EMISSION] > 0.0f);
    V3 le0 = row3(m, M_EMISSION_COLOR);
    if constexpr (kTex) {
      if (emit_now) le0 = emission_at(a, m, tex_u, tex_v);
    }
    rad = rad + (emit_now ? thr * le0 : zero3());
    alive = alive && !emit_now;
  }

  // What follows for a lane that is not alive writes what the body writes
  // for it: every contribution zero, every ray's tmax -1 (origins and
  // directions as computed), the light ray's pdf, the stale state. Work
  // whose results the body masks away for it sits behind `alive`.
  const V3 wo = world_to_local(-dir, tangent, n_s, bitangent);
  const auto bsdf = shading_bsdf<kFull>(a, ms, wo, entering, ft.lobe_mask);
  const V3 shadow_origin = ray_origin_offset(x, n_g);
  const float shadow_tmax = alive ? RAY_TMAX : -1.0f;
  float* pd = a.pending_out;

  // ---- NEE (pt.cu:767-890): [dl], sky, [area]
  int cmj_slot = 0;
  if (ft.has_dl) {  // a sun disk 1e9 away (pt_fused.py:902-931)
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    cmj_slot += 1;
    const float dist = 1e9f;
    float dxx, dyy;
    concentric_disk(ux, uy, dxx, dyy);
    const V3 ddir = v3(sv[SV_DL_DIR], sv[SV_DL_DIR + 1], sv[SV_DL_DIR + 2]);
    const float disk_r = dist * tanf(0.5f * sv[SV_DL_ANGLE] * 0.017453292519943295f);
    V3 t_dl, b_dl;
    onb(ddir, t_dl, b_dl);
    const V3 p_sun = v3(dist * ddir.x + disk_r * (t_dl.x * dxx + b_dl.x * dyy),
                        dist * ddir.y + disk_r * (t_dl.y * dxx + b_dl.y * dyy),
                        dist * ddir.z + disk_r * (t_dl.z * dxx + b_dl.z * dyy));
    const V3 sdir = normalize(p_sun - shadow_origin, 0.0f);
    V3 c_dl = zero3();
    if (alive) {
      const V3 wi = world_to_local(sdir, tangent, n_s, bitangent);
      V3 f;
      float pdf_bsdf;
      bsdf_eval(bsdf, wo, wi, f, pdf_bsdf);
      float mis_w = 1.0f / (1.0f + pdf_bsdf);
      V3 wgt = clip3(thr * (mis_w * fabsf(wi.y)) * f, 0.0f, 1.0f);
      c_dl = wgt * v3(sv[SV_DL_LE], sv[SV_DL_LE + 1], sv[SV_DL_LE + 2]);
    }
    st3(pd, PD_DL, n, i, c_dl);
    store_ray(a, k.count, k.dl, i, shadow_origin, sdir, nee_tmax(c_dl, shadow_tmax));
  } else {
    st3(pd, PD_DL, n, i, zero3());
  }
  {
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    V3 wi_sky = cosine_hemisphere(ux, uy);
    V3 sdir = local_to_world(wi_sky, tangent, n_s, bitangent);
    V3 c_sky = zero3();
    if (alive) {
      float cos_sky = fabsf(wi_sky.y);
      float pdf_sky = cos_sky / F_PI;
      V3 f;
      float pdf_bsdf;
      bsdf_eval(bsdf, wo, wi_sky, f, pdf_bsdf);
      float mis_w = pdf_sky / (pdf_sky + pdf_bsdf);
      float scale = pdf_sky > 0.0f ? mis_w * cos_sky / jmax(pdf_sky, 1e-12f) : 0.0f;
      V3 wgt = clip3(thr * scale * f, 0.0f, 1.0f);
      c_sky = wgt * eval_sky(sv, ft.sky_mode, sdir);
    }
    st3(pd, PD_SKY, n, i, c_sky);
    store_ray(a, k.count, 0, i, shadow_origin, sdir, nee_tmax(c_sky, shadow_tmax));
  }
  cmj_slot += 1;

  int sobol_slot = 1;
  if (has_area) {
    float u1 = sobol_owen(sidx, 1 + d * n1 + sobol_slot, seed, a.sobol);
    sobol_slot += 1;
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    cmj_slot += 1;
    int li = clampi((int)(u1 * (float)a.n_lights), 0, a.n_lights - 1);
    const float* L = a.light_table + (long long)li * 24;
    float su0 = sqrtf(ux);
    float b0 = 1.0f - su0, b1 = uy * su0;
    float lb0 = 1.0f - b0 - b1;
    V3 p_l = v3(lb0 * L[0] + b0 * L[3] + b1 * L[6], lb0 * L[1] + b0 * L[4] + b1 * L[7],
                lb0 * L[2] + b0 * L[5] + b1 * L[8]);
    V3 n_lv = v3(lb0 * L[9] + b0 * L[12] + b1 * L[15], lb0 * L[10] + b0 * L[13] + b1 * L[16],
                 lb0 * L[11] + b0 * L[14] + b1 * L[17]);
    V3 to_l = p_l - shadow_origin;
    float r = length(to_l);
    float inv_r = 1.0f / jmax(r, 1e-12f);
    V3 sdir = to_l * inv_r;
    bool front = dot(-sdir, n_lv) > 0.0f;
    V3 c_area = zero3();
    if (alive && front) {
      float pdf_area = 1.0f / ((float)a.n_lights * jmax(L[21], 1e-12f));
      V3 wi = world_to_local(sdir, tangent, n_s, bitangent);
      V3 f;
      float pdf_bsdf;
      bsdf_eval(bsdf, wo, wi, f, pdf_bsdf);
      float pdf = r * r / jmax(fabsf(dot(-sdir, n_lv)), 1e-12f) * pdf_area;
      float mis_w = pdf / (pdf + pdf_bsdf);
      V3 wgt = clip3(thr * (mis_w * fabsf(wi.y) / jmax(pdf, 1e-12f)) * f, 0.0f, 1.0f);
      c_area = wgt * row3(L, 18);
    }
    st3(pd, PD_AREA, n, i, c_area);
    store_ray(a, k.count, k.area, i, shadow_origin, sdir,
              nee_tmax(c_area, alive ? r - SHADOW_RAY_EPS : -1.0f));
  } else {
    st3(pd, PD_AREA, n, i, zero3());
  }

  // ---- BSDF-sampled light ray (pt.cu:892-925 head)
  {
    float u1 = sobol_owen(sidx, 1 + d * n1 + sobol_slot, seed, a.sobol);
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    V3 wi_l, f_l;
    float pdf_l;
    bsdf_sample(bsdf, wo, u1, ux, uy, wi_l, f_l, pdf_l);
    V3 ldir = local_to_world(wi_l, tangent, n_s, bitangent);
    bool transmitted = dot(ldir, n_g) < 0.0f;
    V3 lorigin = ray_origin_offset(x, transmitted ? -n_g : n_g);
    float tpf_scale = pdf_l > 0.0f ? fabsf(wi_l.y) / jmax(pdf_l, 1e-12f) : 0.0f;
    V3 tpf = alive ? thr * tpf_scale * f_l : zero3();
    st3(pd, PD_TPF, n, i, tpf);
    pd[PD_PDF_L * n + i] = pdf_l;
    pd[PD_WI_L_Y * n + i] = wi_l.y;
    store_ray(a, k.count, k.light, i, lorigin, ldir, nee_tmax(tpf, alive ? RAY_TMAX : -1.0f));
  }
  sobol_slot += 1;
  cmj_slot += 1;

  // ---- next bounce (pt.cu:927-943); dead lanes keep stale ray state
  // (pt.py `keep` masking)
  V3 new_o = o_in, new_d = dir, new_thr = thr;
  bool alive_next = false;
  if (alive) {
    float u1 = sobol_owen(sidx, 1 + d * n1 + sobol_slot, seed, a.sobol);
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    V3 wi_n, f_n;
    float pdf_n;
    bsdf_sample(bsdf, wo, u1, ux, uy, wi_n, f_n, pdf_n);
    V3 wi_world = local_to_world(wi_n, tangent, n_s, bitangent);
    float bounce_w = pdf_n > 0.0f ? fabsf(wi_n.y) / jmax(pdf_n, 1e-12f) : 0.0f;
    V3 thr_n = thr * f_n * bounce_w;
    bool transmitted = dot(wi_world, n_g) < 0.0f;
    if (finite3(thr_n) && (pdf_n > 0.0f)) {
      alive_next = true;
      new_o = ray_origin_offset(x, transmitted ? -n_g : n_g);
      new_d = wi_world;
      new_thr = thr_n;
    }
  }

  // ---- RR for bounce d+1 (drawn here == start of pt.cu body d+1)
  if (d + 1 < a.max_depth) {
    float rr_prob = jclip(luminance(new_thr), 0.0f, 1.0f);
    if (alive_next) alive_next = sobol_owen(sidx, 1 + (d + 1) * n1, seed, a.sobol) < rr_prob;
    float inv_rr = 1.0f / jmax(rr_prob, 1e-12f);
    new_thr = new_thr * inv_rr;
  }
  store_ray(a, k.count, k.rad, i, new_o, new_d, alive_next ? RAY_TMAX : -1.0f);

  float* so = a.state_out;
  st3(so, ST_O, n, i, new_o);
  st3(so, ST_D, n, i, new_d);
  st3(so, ST_THR, n, i, new_thr);
  st3(so, ST_RAD, n, i, rad);
  so[ST_NV * n + i] = nv;
  so[ST_ALIVE * n + i] = alive_next ? 1.0f : 0.0f;
}

template <bool kRich>
__global__ void __launch_bounds__(kBlock, kRich ? kMegaBlocksRich : kMegaBlocksPlain)
    k_mega(const ShadeArgs a) {
  mega_body<kRich, false, false>(a, blockIdx.x * blockDim.x + threadIdx.x);
}

// whether lane i shades bounce d: alive, and its ray hit (at d = 0 an
// emissive first hit then ends it, which the whole body decides)
__device__ __forceinline__ bool shades(const ShadeArgs& a, int i) {
  const long long ri = (a.d == 0 ? 0 : blocks_of(a).rad - a.hit_block0) * (long long)a.n + i;
  return a.state_in[ST_ALIVE * (long long)a.n + i] != 0.0f && a.hit_prim[ri] >= 0;
}

// whether so many of the lanes shade (count of them) that the shading
// pass runs the whole body on every lane in order, and the floor pass
// none
__device__ __forceinline__ bool many_shade(const ShadeArgs& a, int count) { return 8 * count > a.n; }

// The queue of the full and textured variants: the lanes that shade
// (lane_queue[0] counts them, their indices go to lane_queue[2 + slot]),
// one atomic a warp; lane_queue[1] counts the floor pass's finished blocks.
// Both counters are 0 when it starts: the wrapper's buffer is zeroed once,
// and the floor pass's last block sets them back to 0.
__global__ void __launch_bounds__(kBlock) k_mega_full_queue(const ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const bool s = shades(a, i);
  const unsigned q = __ballot_sync(__activemask(), s);
  if (!s) return;
  const int lane = threadIdx.x & 31, leader = __ffs(q) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(a.lane_queue, __popc(q));
  base = __shfl_sync(q, base, leader);
  a.lane_queue[2 + base + __popc(q & ((1u << lane) - 1u))] = i;
}

// The lane a shading pass's thread runs. At d = 0 the pass runs alone on
// every lane. Past it, the queued lanes, 32 to a warp, from the first block
// on (the threads past the queue get lane n and end at once), or every
// lane where many shade. Its blocks start first, and each lets the floor
// pass launch beside it at once (griddepcontrol.launch_dependents), so its
// long chains run beside the floor pass, not after it.
__device__ __forceinline__ int shading_lane(const ShadeArgs& a) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (a.d > 0) {
    const int count = a.lane_queue[0];
    if (!many_shade(a, count)) return k < count ? a.lane_queue[2 + k] : a.n;
  }
  return k;
}

// A floor pass, past d = 0: a lane that shades nothing runs the body with
// `alive` false at compile time. The last of its blocks to finish waits
// for the shading pass (griddepcontrol.wait), so the launch ends after
// both, and then zeroes the queue's counters for the next launch.
template <bool kTex>
__device__ __forceinline__ void floor_lanes(const ShadeArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n && !many_shade(a, a.lane_queue[0]) && !shades(a, i))
    mega_body<true, true, kTex, kPassFloor>(a, i);
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(a.lane_queue + 1, 1) == (int)gridDim.x - 1) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    a.lane_queue[0] = 0;
    a.lane_queue[1] = 0;
  }
}

// The full variant's whole body: alone at d = 0, the shading pass past it
__global__ void __launch_bounds__(kBlock, kMegaBlocksFull) k_mega_full(const ShadeArgs a) {
  mega_body<true, true, false>(a, shading_lane(a));
}

// the full variant's floor pass
__global__ void __launch_bounds__(kBlock, kMegaBlocksFloor) k_mega_full_floor(const ShadeArgs a) {
  floor_lanes<false>(a);
}

// The textured variant's whole body: alone at d = 0, the shading pass past
// it
__global__ void __launch_bounds__(kBlock, kMegaBlocksTex) k_mega_tex(const ShadeArgs a) {
  mega_body<true, true, true>(a, shading_lane(a));
}

// the textured variant's floor pass: the taps whose texels reach what a
// lane that shades nothing writes stay (the frame's, and the overrides
// that feed the light ray's sample), the rest fold away with `alive`
__global__ void __launch_bounds__(kBlock, kMegaBlocksTexFloor) k_mega_tex_floor(const ShadeArgs a) {
  floor_lanes<true>(a);
}

// kTex implies kRich
template <bool kRich, bool kTex>
__global__ void __launch_bounds__(kBlock) k_final(const ShadeArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  V3 rad = resolve_pending<kRich, kTex>(a, i, ld3(a.state_in, ST_RAD, n, i));
  st3(a.rad_out, 0, n, i, finite3(rad) ? rad : zero3());  // NaN scrub (pt.cu:474-478)
}

inline int grid(int n) { return (n + kBlock - 1) / kBlock; }

// Past d = 0, the full and textured variants: the queue, the shading pass,
// then the floor pass launched beside it (programmatic stream
// serialization)
int mega_split(const ShadeArgs* a, cudaStream_t stream, void (*shading_pass)(ShadeArgs),
               void (*floor_pass)(ShadeArgs)) {
  if (a->lane_queue == nullptr) return (int)cudaErrorInvalidValue;
  k_mega_full_queue<<<grid(a->n), kBlock, 0, stream>>>(*a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  shading_pass<<<grid(a->n), kBlock, 0, stream>>>(*a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cudaLaunchAttribute beside[1];
  beside[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  beside[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid(a->n));
  cfg.blockDim = dim3(kBlock);
  cfg.stream = stream;
  cfg.attrs = beside;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, floor_pass, *a);
}

}  // namespace

extern "C" int fh_raygen(const ShadeArgs* a, cudaStream_t stream) {
  k_raygen<<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_mega(const ShadeArgs* a, cudaStream_t stream) {
  if (a->tex_mask != 0 && a->d > 0) return mega_split(a, stream, k_mega_tex, k_mega_tex_floor);
  if (needs_full(a) && a->d > 0) return mega_split(a, stream, k_mega_full, k_mega_full_floor);
  if (a->tex_mask != 0)
    k_mega_tex<<<grid(a->n), kBlock, 0, stream>>>(*a);
  else if (needs_full(a))
    k_mega_full<<<grid(a->n), kBlock, 0, stream>>>(*a);
  else if (needs_rich(a))
    k_mega<true><<<grid(a->n), kBlock, 0, stream>>>(*a);
  else
    k_mega<false><<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_final(const ShadeArgs* a, cudaStream_t stream) {
  if (a->tex_mask != 0)
    k_final<true, true><<<grid(a->n), kBlock, 0, stream>>>(*a);
  else if (needs_rich(a))
    k_final<true, false><<<grid(a->n), kBlock, 0, stream>>>(*a);
  else
    k_final<false, false><<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
