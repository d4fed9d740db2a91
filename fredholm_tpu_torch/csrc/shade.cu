// The shading stages of the fused path tracer: raygen, mega, final.
//
// Replace fredholm_tpu/fused/kernels.py `tiled_map` as the reference runs
// it from `_raygen_tiled`, `_mega_tiled` and `_final_tiled`
// (fused/pt_fused.py:1331-1384) over `raygen_body`, `mega_body` and
// `final_resolve_body`. Plain twins: fredholm_tpu_torch/fused/pt_fused.py
// `raygen_twin`, `mega_twin`, `final_twin`.
//
// One thread per lane over the packed SoA planes of pt_fused.py. `mega`
// also does the reference's attribute gather (`_gather_attrs`: clamped
// prim, rounded and clamped mat_id) from fused_table / fused_mat_table,
// and writes each emitted ray block into its slice of one [7, B*N]
// buffer, so the next trace reads it without a concatenation.
// Slice-1 envelope: constant sky, no directional light, no textures,
// BSDF lobe diffuse_r (common.cuh); the wrapper raises on anything else.
//
// Bounds on the H100: mega is a ~600-operation body per lane with uint32
// hashing (5 Sobol + 4 CMJ draws a bounce) and data-dependent branches;
// it reads ~60 floats and writes ~60 floats a lane (state, pending, four
// ray blocks), so at N = 262144 it moves ~30 MB a launch. Registers, not
// bandwidth, limit occupancy; __launch_bounds__(128) lets ptxas keep the
// whole body in registers (the build prints the spill counts).
#include "common.cuh"

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, int row, long long stride, long long i) {
  return v3(p[row * stride + i], p[(row + 1) * stride + i], p[(row + 2) * stride + i]);
}
__device__ __forceinline__ void st3(float* __restrict__ p, int row, long long stride, long long i, V3 v) {
  p[row * stride + i] = v.x;
  p[(row + 1) * stride + i] = v.y;
  p[(row + 2) * stride + i] = v.z;
}
__device__ __forceinline__ V3 interp3(const float* __restrict__ a, int base, float w0, float w1, float w2) {
  return v3(w0 * a[base + 0] + w1 * a[base + 3] + w2 * a[base + 6],
            w0 * a[base + 1] + w1 * a[base + 4] + w2 * a[base + 7],
            w0 * a[base + 2] + w1 * a[base + 5] + w2 * a[base + 8]);
}
__device__ __forceinline__ V3 row3(const float* __restrict__ a, int c) { return v3(a[c], a[c + 1], a[c + 2]); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// `_gather_attrs`: geometry row by clamped prim, material row by mat_id
__device__ __forceinline__ void gather(const ShadeArgs& a, int prim, const float*& g, const float*& m) {
  g = a.fused_table + (long long)clampi(prim, 0, a.n_faces - 1) * GEOM_COLS;
  int mid = clampi((int)rintf(g[C_MAT_ID]), 0, a.n_mats - 1);
  m = a.mat_table + (long long)mid * MAT_COLS;
}

__device__ __forceinline__ void store_ray(const ShadeArgs& a, int blk, int i, V3 o, V3 d, float tmax) {
  long long s = (long long)a.n * (a.n_lights > 0 ? 4 : 3);
  long long j = (long long)blk * a.n + i;
  st3(a.rays_out, 0, s, j, o);
  st3(a.rays_out, 3, s, j, d);
  a.rays_out[6 * s + j] = tmax;
}

__device__ __forceinline__ float nee_tmax(V3 c, float tmax) {
  return (c.x > 0.0f || c.y > 0.0f || c.z > 0.0f) ? tmax : -1.0f;
}

// `_resolve_pending`: bounce d-1's NEE visibility + BSDF-light-ray MIS
__device__ V3 resolve_pending(const ShadeArgs& a, int i, V3 rad, V3 bg) {
  const long long n = a.n;
  const bool has_area = a.n_lights > 0;
  const int b_light = has_area ? 2 : 1;
  const float* pd = a.pending_in;
  bool occ_sky = a.hit_prim[i] >= 0;
  rad = rad + (occ_sky ? zero3() : ld3(pd, PD_SKY, n, i));
  if (has_area) {
    bool occ_area = a.hit_prim[n + i] >= 0;
    rad = rad + (occ_area ? zero3() : ld3(pd, PD_AREA, n, i));
  }
  long long li = b_light * n + i;
  V3 ldir = ld3(a.rays_in, 3, a.rays_in_stride, li);
  bool l_hit = a.hit_prim[li] >= 0;
  float pdf_light_miss = fabsf(pd[PD_WI_L_Y * n + i]) / F_PI;
  V3 le;
  float pdf_light;
  if (!has_area) {
    le = l_hit ? zero3() : bg;
    pdf_light = pdf_light_miss;
  } else {
    const float *g, *m;
    gather(a, a.hit_prim[li], g, m);
    float lw1 = a.hit_u[li], lw2 = a.hit_v[li];
    float lw0 = 1.0f - lw1 - lw2;
    V3 l_p = interp3(g, C_V0, lw0, lw1, lw2);
    V3 l_n = interp3(g, C_N0, lw0, lw1, lw2);
    bool l_emissive = (m[M_HAS_EMISSION] > 0.0f) && (dot(-ldir, l_n) > 0.0f);
    bool hit_light = l_hit && l_emissive;
    le = l_hit ? (hit_light ? row3(m, M_EMISSION_COLOR) : zero3()) : bg;
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

__global__ void __launch_bounds__(kBlock) k_mega(const ShadeArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  const int d = a.d;
  const bool has_area = a.n_lights > 0;
  const int n1 = 3 + (has_area ? 1 : 0);  // Sobol draws a bounce
  const int n2 = 3 + (has_area ? 1 : 0);  // CMJ draws a bounce (no sun)
  const int b_area = 1, b_light = has_area ? 2 : 1, b_rad = has_area ? 3 : 2;
  const float* sv = a.sv;
  const uint32_t seed = (uint32_t)a.usv[0];
  const uint32_t n_spp = (uint32_t)a.n_spp[i];
  const uint32_t image_idx = (uint32_t)i;
  const uint32_t sidx = (uint32_t)a.sample_idx[i];
  const V3 bg = v3(sv[16], sv[17], sv[18]);

  const float* st = a.state_in;
  const V3 o_in = ld3(st, ST_O, n, i);
  const V3 dir = ld3(st, ST_D, n, i);
  const V3 thr = ld3(st, ST_THR, n, i);
  V3 rad = ld3(st, ST_RAD, n, i);
  float nv = st[ST_NV * n + i];
  bool alive = st[ST_ALIVE * n + i] != 0.0f;

  if (d > 0) rad = resolve_pending(a, i, rad, bg);

  // ---- shade bounce d
  const long long ri = (d == 0 ? 0 : b_rad) * n + i;
  const int prim = a.hit_prim[ri];
  const bool hit = prim >= 0;
  if (d == 0) {  // sky on first-hit miss (pt.cu:504-523)
    bool miss_first = alive && !hit;
    rad = rad + (miss_first ? thr * bg : zero3());
  }
  alive = alive && hit;
  nv = nv + (alive ? 1.0f : 0.0f);

  const float *g, *m;
  gather(a, prim, g, m);
  const float w1 = a.hit_u[ri], w2 = a.hit_v[ri];
  const float w0 = 1.0f - w1 - w2;
  const V3 x = interp3(g, C_V0, w0, w1, w2);
  const V3 fv0 = row3(g, C_V0), fv1 = row3(g, C_V0 + 3), fv2 = row3(g, C_V0 + 6);
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

  const V3 wo = world_to_local(-dir, tangent, n_s, bitangent);
  const Bsdf bsdf = bsdf_setup(m, entering, a.lobe_mask);
  const V3 shadow_origin = ray_origin_offset(x, n_g);
  const float shadow_tmax = alive ? RAY_TMAX : -1.0f;
  float* pd = a.pending_out;

  // ---- NEE (pt.cu:767-890): sky, then [area]
  int cmj_slot = 0;
  {
    float ux, uy;
    draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
    V3 wi_sky = cosine_hemisphere(ux, uy);
    V3 sdir = local_to_world(wi_sky, tangent, n_s, bitangent);
    float cos_sky = fabsf(wi_sky.y);
    float pdf_sky = cos_sky / F_PI;
    V3 f = bsdf_eval(bsdf, wo, wi_sky);
    float pdf_bsdf = bsdf_pdf(bsdf, wo, wi_sky);
    float mis_w = pdf_sky / (pdf_sky + pdf_bsdf);
    float scale = pdf_sky > 0.0f ? mis_w * cos_sky / jmax(pdf_sky, 1e-12f) : 0.0f;
    V3 wgt = clip3(thr * scale * f, 0.0f, 1.0f);
    V3 c_sky = alive ? wgt * bg : zero3();
    st3(pd, PD_SKY, n, i, c_sky);
    store_ray(a, 0, i, shadow_origin, sdir, nee_tmax(c_sky, shadow_tmax));
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
    float pdf_area = 1.0f / ((float)a.n_lights * jmax(L[21], 1e-12f));
    V3 to_l = p_l - shadow_origin;
    float r = length(to_l);
    float inv_r = 1.0f / jmax(r, 1e-12f);
    V3 sdir = to_l * inv_r;
    bool front = dot(-sdir, n_lv) > 0.0f;
    V3 wi = world_to_local(sdir, tangent, n_s, bitangent);
    V3 f = bsdf_eval(bsdf, wo, wi);
    float pdf = r * r / jmax(fabsf(dot(-sdir, n_lv)), 1e-12f) * pdf_area;
    float pdf_bsdf = bsdf_pdf(bsdf, wo, wi);
    float mis_w = pdf / (pdf + pdf_bsdf);
    V3 wgt = clip3(thr * (mis_w * fabsf(wi.y) / jmax(pdf, 1e-12f)) * f, 0.0f, 1.0f);
    V3 c_area = (alive && front) ? wgt * row3(L, 18) : zero3();
    st3(pd, PD_AREA, n, i, c_area);
    store_ray(a, b_area, i, shadow_origin, sdir,
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
    store_ray(a, b_light, i, lorigin, ldir, nee_tmax(tpf, alive ? RAY_TMAX : -1.0f));
  }
  sobol_slot += 1;
  cmj_slot += 1;

  // ---- next bounce (pt.cu:927-943)
  float u1 = sobol_owen(sidx, 1 + d * n1 + sobol_slot, seed, a.sobol);
  float ux, uy;
  draw_cmj_2d(n_spp, image_idx, (uint32_t)(2 + d * n2 + cmj_slot), seed, ux, uy);
  V3 wi_n, f_n;
  float pdf_n;
  bsdf_sample(bsdf, wo, u1, ux, uy, wi_n, f_n, pdf_n);
  V3 wi_world = local_to_world(wi_n, tangent, n_s, bitangent);
  float bounce_w = pdf_n > 0.0f ? fabsf(wi_n.y) / jmax(pdf_n, 1e-12f) : 0.0f;
  V3 new_thr = thr * f_n * bounce_w;
  bool transmitted = dot(wi_world, n_g) < 0.0f;
  V3 new_o = ray_origin_offset(x, transmitted ? -n_g : n_g);
  bool alive_next = alive && finite3(new_thr) && (pdf_n > 0.0f);
  // dead lanes keep stale ray state (pt.py `keep` masking)
  new_o = alive_next ? new_o : o_in;
  V3 new_d = alive_next ? wi_world : dir;
  new_thr = alive_next ? new_thr : thr;

  // ---- RR for bounce d+1 (drawn here == start of pt.cu body d+1)
  if (d + 1 < a.max_depth) {
    float u_rr = sobol_owen(sidx, 1 + (d + 1) * n1, seed, a.sobol);
    float rr_prob = jclip(luminance(new_thr), 0.0f, 1.0f);
    alive_next = alive_next && (u_rr < rr_prob);
    float inv_rr = 1.0f / jmax(rr_prob, 1e-12f);
    new_thr = new_thr * inv_rr;
  }
  store_ray(a, b_rad, i, new_o, new_d, alive_next ? RAY_TMAX : -1.0f);

  float* so = a.state_out;
  st3(so, ST_O, n, i, new_o);
  st3(so, ST_D, n, i, new_d);
  st3(so, ST_THR, n, i, new_thr);
  st3(so, ST_RAD, n, i, rad);
  so[ST_NV * n + i] = nv;
  so[ST_ALIVE * n + i] = alive_next ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kBlock) k_final(const ShadeArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long n = a.n;
  V3 bg = v3(a.sv[16], a.sv[17], a.sv[18]);
  V3 rad = resolve_pending(a, i, ld3(a.state_in, ST_RAD, n, i), bg);
  st3(a.rad_out, 0, n, i, finite3(rad) ? rad : zero3());  // NaN scrub (pt.cu:474-478)
}

inline int grid(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int fh_raygen(const ShadeArgs* a, cudaStream_t stream) {
  k_raygen<<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_mega(const ShadeArgs* a, cudaStream_t stream) {
  k_mega<<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int fh_final(const ShadeArgs* a, cudaStream_t stream) {
  k_final<<<grid(a->n), kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
