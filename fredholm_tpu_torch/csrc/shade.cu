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
// Envelope: constant or Hosek sky, optional sun (directional light),
// no textures, all seven BSDF lobes of cbsdf.ALL_LOBES (common.cuh); the
// wrapper raises on anything else.
//
// `mega` comes in three variants, one body compiled three ways, each with
// its own register budget. The plain one (constant sky, no sun, diffuse_r
// only) and the rich one (Hosek sky, sun, metal and specular) shade with
// `Bsdf`; the full one, which `fh_mega` launches whenever the scene has a
// coat, transmission, sheen or diffuse transmission, with `BsdfFull`, so
// the lobes it adds cost the other two nothing.
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
//   the full one at 4 (128 registers, 88 B) against 5 (96, 264 B) and 3
//   (164, none), which take 1.06x and 1.16x its time at
//   transmission_rough's d = 1.
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
#include "common.cuh"

namespace {

constexpr int kBlock = 128;
// the resident blocks an SM that ptxas fits each mega variant's registers to
constexpr int kMegaBlocksPlain = 6;
constexpr int kMegaBlocksRich = 5;
constexpr int kMegaBlocksFull = 4;

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

// the shading BSDF of a mega variant: BsdfFull for the full one, else Bsdf
template <bool kFull>
__device__ __forceinline__ auto shading_bsdf(const ShadeArgs& a, const float* __restrict__ m, V3 wo,
                                             bool entering, int lobe_mask) {
  if constexpr (kFull)
    return bsdf_setup_full(m, wo, entering, lobe_mask, a.lut, a.sheen_lut);
  else
    return bsdf_setup(m, wo, entering, lobe_mask, a.lut);
}

// `_resolve_pending`: bounce d-1's NEE visibility + BSDF-light-ray MIS
template <bool kRich>
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
    le = l_hit ? (hit_light ? row3(m, M_EMISSION_COLOR) : zero3()) : le_miss;
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

// the body of every mega variant; kFull (which implies kRich) shades with
// the full BSDF
template <bool kRich, bool kFull>
__device__ __forceinline__ void mega_body(const ShadeArgs& a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
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

  if (d > 0) rad = resolve_pending<kRich>(a, i, rad);

  // ---- shade bounce d
  const long long ri = (d == 0 ? 0 : k.rad - a.hit_block0) * n + i;
  const bool hit = a.hit_prim[ri] >= 0;
  if (d == 0) {  // sky on first-hit miss (pt.cu:504-523)
    V3 sky = zero3();
    if (alive && !hit) sky = thr * eval_sky(sv, ft.sky_mode, dir);
    rad = rad + sky;
  }
  alive = alive && hit;
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

  if (d == 0) {  // first-hit AOVs + emissive-hit termination (pt.cu:745-760)
    const bool cap = alive;
    float tu = w0 * g[C_UV0] + w1 * g[C_UV0 + 2] + w2 * g[C_UV0 + 4];
    float tv = w0 * g[C_UV0 + 1] + w1 * g[C_UV0 + 3] + w2 * g[C_UV0 + 5];
    st3(a.aov_out, AOV_POS, n, i, cap ? x : zero3());
    st3(a.aov_out, AOV_NRM, n, i, cap ? n_s : zero3());
    a.aov_out[AOV_DEPTH * n + i] = cap ? a.hit_t[ri] : 0.0f;
    a.aov_out[AOV_TU * n + i] = cap ? tu : 0.0f;
    a.aov_out[AOV_TV * n + i] = cap ? tv : 0.0f;
    st3(a.aov_out, AOV_ALB, n, i, cap ? row3(m, M_BASE_COLOR) : zero3());
    const bool emit_now = cap && (m[M_HAS_EMISSION] > 0.0f);
    rad = rad + (emit_now ? thr * row3(m, M_EMISSION_COLOR) : zero3());
    alive = alive && !emit_now;
  }

  // What follows for a lane that is not alive writes what the body writes
  // for it: every contribution zero, every ray's tmax -1 (origins and
  // directions as computed), the light ray's pdf, the stale state. Work
  // whose results the body masks away for it sits behind `alive`.
  const V3 wo = world_to_local(-dir, tangent, n_s, bitangent);
  const auto bsdf = shading_bsdf<kFull>(a, m, wo, entering, ft.lobe_mask);
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
  mega_body<kRich, false>(a);
}

__global__ void __launch_bounds__(kBlock, kMegaBlocksFull) k_mega_full(const ShadeArgs a) {
  mega_body<true, true>(a);
}

template <bool kRich>
__global__ void __launch_bounds__(kBlock) k_final(const ShadeArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  V3 rad = resolve_pending<kRich>(a, i, ld3(a.state_in, ST_RAD, n, i));
  st3(a.rad_out, 0, n, i, finite3(rad) ? rad : zero3());  // NaN scrub (pt.cu:474-478)
}

inline int grid(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int fh_raygen(const ShadeArgs* a, cudaStream_t stream) {
  k_raygen<<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_mega(const ShadeArgs* a, cudaStream_t stream) {
  if (needs_full(a))
    k_mega_full<<<grid(a->n), kBlock, 0, stream>>>(*a);
  else if (needs_rich(a))
    k_mega<true><<<grid(a->n), kBlock, 0, stream>>>(*a);
  else
    k_mega<false><<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_final(const ShadeArgs* a, cudaStream_t stream) {
  if (needs_rich(a))
    k_final<true><<<grid(a->n), kBlock, 0, stream>>>(*a);
  else
    k_final<false><<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
