// Device helpers shared by the port's CUDA kernels.
//
// Every function mirrors its plain PyTorch twin in fredholm_tpu_torch
// (core/rng.py, sampling/, fused/cvec.py, fused/cmappings.py,
// fused/cbsdf.py) in evaluation order. The kernels are built with
// -fmad=false and without --use_fast_math, so float results track the
// twins to a few ulp (transcendentals differ by a few ulp); the integer
// hashing is bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// launch arguments (mirrored field for field by _build.ShadeArgs)

struct ShadeArgs {
  const float* sv;            // [64] scalar vector (pt_fused.pack_scalars)
  const long long* usv;       // [8] uint32 values: seed hash, n_pixels
  const float* fused_table;   // [n_faces, 32]
  const float* mat_table;     // [n_mats, 94]
  const float* light_table;   // [max(n_lights,1), 24]
  const unsigned* sobol;      // [128, 32] direction numbers
  const float* lut;           // [16, 16, 2] GGX reflection albedo table
  const float* sheen_lut;     // [16, 16] sheen albedo table
  const long long* n_spp;     // [N] per-pixel sample count (uint32 values)
  long long* sample_idx;      // [N] raygen writes, mega reads
  const float* state_in;      // [14, N]
  float* state_out;           // [14, N]
  const float* rays_in;       // [7, rays_in_stride]
  const float* hit_t;         // closest hits over rays_in blocks
  const int* hit_prim;        //   [hit_block0, ...), hits_m lanes
  const float* hit_u;
  const float* hit_v;
  const float* geom;          // [26, hits_m] slot-fetch planes, or null:
                              //   fused_table row of the hit prim
  const unsigned char* occ;   // occlusion of rays_in blocks [0, hit_block0)
  const float* pending_in;    // [14, N]
  float* pending_out;         // [14, N]
  float* rays_out;            // [7, B*N]
  float* aov_out;             // [12, N] (bounce 0 only)
  float* rad_out;             // [3, N] (final resolve)
  long long rays_in_stride;
  long long hits_m;
  int n;
  int width;
  int height;
  int d;
  int max_depth;
  int n_faces;
  int n_mats;
  int n_lights;
  int lobe_mask;              // bit k: cbsdf.ALL_LOBES[k]
  int sky_mode;               // SKY_CONSTANT or SKY_HOSEK
  int has_dl;                 // directional light (sun) NEE block
  int hit_block0;             // first ray block the closest hits cover
  int tex_mask;               // bit k: pt_fused.TEX_KINDS[k] a material uses
  int n_tex_runs;             // rows of tex_runs
  const unsigned* tex_runs;   // [n_tex_runs, 16] texel runs (scene/texture.py)
  int* lane_queue;            // [2 + N] scratch of mega's full variant: its
                              //   shading lanes' count, the count taken,
                              //   then their indices
};

// packed plane rows (fused/pt_fused.py)
#define ST_O 0
#define ST_D 3
#define ST_THR 6
#define ST_RAD 9
#define ST_NV 12
#define ST_ALIVE 13
#define PD_SKY 0
#define PD_AREA 3
#define PD_TPF 6
#define PD_PDF_L 9
#define PD_WI_L_Y 10
#define PD_DL 11
#define AOV_POS 0
#define AOV_NRM 3
#define AOV_DEPTH 6
#define AOV_TU 7
#define AOV_TV 8
#define AOV_ALB 9

// fused table columns (scene/device.py COL); material columns are
// relative to the material row (COL - GEOM_COLS)
#define GEOM_COLS 32
#define MAT_COLS 94
#define C_V0 0
#define C_N0 9
#define C_UV0 18
#define C_AREA 24
#define C_MAT_ID 25
#define M_EMISSION_COLOR 0
#define M_HAS_EMISSION 3
#define M_BASE_COLOR 4
#define M_DIFFUSE 7
#define M_DIFFUSE_ROUGHNESS 8
#define M_SPECULAR 9
#define M_SPECULAR_COLOR 10
#define M_SPECULAR_ROUGHNESS 13
#define M_METALNESS 14
#define M_COAT 15
#define M_COAT_ROUGHNESS 16
#define M_COAT_COLOR 17
#define M_TRANSMISSION 20
#define M_TRANSMISSION_COLOR 21
#define M_SHEEN 24
#define M_SHEEN_COLOR 25
#define M_SHEEN_ROUGHNESS 28
#define M_SUBSURFACE 29
#define M_SUBSURFACE_COLOR 30
#define M_THIN_WALLED 33
// the tx_<kind> columns (texture id, run offset, width, height, runs per
// row, srgb) of TEX_KINDS[k] start at M_TX0 + TX_COLS * k
#define M_TX0 34
#define TX_COLS 6

// bit k: pt_fused.TEX_KINDS[k]
#define TEX_BASE_COLOR 1
#define TEX_SPECULAR_COLOR 2
#define TEX_SPECULAR_ROUGHNESS 4
#define TEX_METALNESS 8
#define TEX_METALLIC_ROUGHNESS 16
#define TEX_COAT 32
#define TEX_COAT_ROUGHNESS 64
#define TEX_EMISSION 128
#define TEX_NORMALMAP 256
#define TEX_HEIGHTMAP 512

// bit k: cbsdf.ALL_LOBES[k]
#define LOBE_COAT 1
#define LOBE_METAL 2
#define LOBE_SPECULAR 4
#define LOBE_TRANSMISSION 8
#define LOBE_SHEEN 16
#define LOBE_DIFFUSE_T 32
#define LOBE_DIFFUSE_R 64
// the lobes only the full BSDF (BsdfFull) has
#define LOBES_FULL_ONLY (LOBE_COAT | LOBE_TRANSMISSION | LOBE_SHEEN | LOBE_DIFFUSE_T)

#define SKY_CONSTANT 0
#define SKY_HOSEK 2
// scalar-vector slots (pt_fused._SV)
#define SV_SKY_INTENSITY 15
#define SV_BG 16
#define SV_SUN_DIR 19
#define SV_DL_LE 22
#define SV_DL_DIR 25
#define SV_DL_ANGLE 28
#define SV_HOSEK_CFG 29
#define SV_HOSEK_RAD 56

#define RAY_TMAX 1e9f
#define SHADOW_RAY_EPS 1e-3f
#define F_PI 3.14159265358979f
#define F_INV_PI 0.3183098861837907f

// ---------------------------------------------------------------------------
// float helpers with jnp / torch semantics

__device__ __forceinline__ float jmax(float x, float c) {  // NaN-propagating
  return x != x ? x : fmaxf(x, c);
}
__device__ __forceinline__ float jmin(float x, float c) {
  return x != x ? x : fminf(x, c);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float san(float v) { return isfinite(v) ? v : 0.0f; }

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 zero3() { return v3(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 san3(V3 v) { return v3(san(v.x), san(v.y), san(v.z)); }
__device__ __forceinline__ V3 clip3(V3 v, float lo, float hi) {
  return v3(jclip(v.x, lo, hi), jclip(v.y, lo, hi), jclip(v.z, lo, hi));
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(jmax(dot(a, a), 0.0f)); }
__device__ __forceinline__ V3 normalize(V3 a, float eps) {
  float inv = 1.0f / sqrtf(jmax(dot(a, a), eps));
  return v3(a.x * inv, a.y * inv, a.z * inv);
}
__device__ __forceinline__ bool finite3(V3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}
__device__ __forceinline__ float luminance(V3 c) {
  return 0.2126729f * c.x + 0.7151522f * c.y + 0.0721750f * c.z;
}
// Duff et al. 2017 branchless ONB (math.cu:7-17)
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float bb = n.x * n.y * a;
  t = v3(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
  b = v3(bb, sign + n.y * n.y * a, -n.y);
}
__device__ __forceinline__ V3 world_to_local(V3 v, V3 t, V3 n, V3 b) {
  return v3(dot(v, t), dot(v, n), dot(v, b));
}
__device__ __forceinline__ V3 local_to_world(V3 v, V3 t, V3 n, V3 b) {
  return v3(v.x * t.x + v.y * n.x + v.z * b.x, v.x * t.y + v.y * n.y + v.z * b.y,
            v.x * t.z + v.y * n.z + v.z * b.z);
}
// robust ray-origin offset (Ray Tracing Gems ch.6; pt.cu:401-416)
__device__ __forceinline__ float offset_comp(float p, float n) {
  int of_i = (int)(256.0f * n);
  int p_i = __float_as_int(p);
  float p_shift = __int_as_float(p < 0.0f ? p_i - of_i : p_i + of_i);
  return fabsf(p) < (1.0f / 32.0f) ? p + (1.0f / 65536.0f) * n : p_shift;
}
__device__ __forceinline__ V3 ray_origin_offset(V3 p, V3 n) {
  return v3(offset_comp(p.x, n.x), offset_comp(p.y, n.y), offset_comp(p.z, n.z));
}

// ---------------------------------------------------------------------------
// Moller-Trumbore of one ray against one triangle (v0, edges e1, e2) in the
// reference's evaluation order (pallas_dense.py `_mt_one`, pallas_clustered.py
// `_mt_scalar`; twin: accel/dense.py `moller_trumbore`). A hit is valid for
// |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and t > 0.
struct MtHit {
  float t, u, v;
  bool valid;
};
__device__ __forceinline__ MtHit moller_trumbore(float ox, float oy, float oz, float dx, float dy,
                                                 float dz, float v0x, float v0y, float v0z,
                                                 float e1x, float e1y, float e1z, float e2x,
                                                 float e2y, float e2z) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok_det = fabsf(det) > 1e-12f;
  float inv_det = ok_det ? 1.0f / det : 0.0f;
  float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  MtHit h;
  h.u = (tx * px + ty * py + tz * pz) * inv_det;
  h.v = (dx * qx + dy * qy + dz * qz) * inv_det;
  h.t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  h.valid = ok_det && (h.u >= 0.0f) && (h.v >= 0.0f) && (h.u + h.v <= 1.0f) && (h.t > 0.0f);
  return h;
}

// A ray with its inverse direction: the operands of the slab tests of the
// clustered (clustered.cu) and ray-resident (resident.cu) traversals.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// pallas_clustered `_inv_dir`
__device__ __forceinline__ float inv_dir(float d) {
  const float eps = 1e-12f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = inv_dir(dx);
  r.iy = inv_dir(dy);
  r.iz = inv_dir(dz);
  return r;
}

// Slab entry and exit distances of ray r against box (lo.xyz, hi.xyz), in
// the evaluation order of pallas_clustered `_slab` (twin: clustered.py
// `_slab_t`).
__device__ __forceinline__ void slab_t(float lox, float loy, float loz, float hix, float hiy,
                                       float hiz, const Ray& r, float& tn, float& tf) {
  float t1x = (lox - r.ox) * r.ix, t2x = (hix - r.ox) * r.ix;
  float t1y = (loy - r.oy) * r.iy, t2y = (hiy - r.oy) * r.iy;
  float t1z = (loz - r.oz) * r.iz, t2z = (hiz - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// pallas_clustered `_slab`: the box gate of a ray with running best t
__device__ __forceinline__ bool slab_box(float lox, float loy, float loz, float hix, float hiy,
                                         float hiz, const Ray& r, float t_best) {
  float tn, tf;
  slab_t(lox, loy, loz, hix, hiy, hiz, r, tn, tf);
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_best);
}

// The root-box exit clamp of a ray's initial best t (pallas_clustered.py
// :303-321): just past its exit from the root box rb ([6, 8], column 0),
// or 0 when it misses the box.
__device__ __forceinline__ float root_exit_clamp(const float* __restrict__ rb, const Ray& r) {
  float rtn, rtf;
  slab_t(rb[0], rb[8], rb[2 * 8], rb[3 * 8], rb[4 * 8], rb[5 * 8], r, rtn, rtf);
  return (rtn <= rtf) && (rtf >= 0.0f) ? rtf * 1.0001f + 1e-4f : 0.0f;
}

// The dense kernels (dense_closest.cu, dense_any.cu) stage F <= kDenseMaxTris
// triangles in shared memory; larger scenes trace clustered.
constexpr int kDenseMaxTris = 1024;

// ---------------------------------------------------------------------------
// integer hashing (core/rng.py, shared.h:282-319, sobol.cu, cmj.cu)

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ uint32_t xxh_avalanche(uint32_t h) {
  h = 2246822519u * (h ^ (h >> 15));
  h = 3266489917u * (h ^ (h >> 13));
  return h ^ (h >> 16);
}
__device__ __forceinline__ uint32_t xxhash32_4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  uint32_t h = w + 374761393u + x * 3266489917u;
  h = 668265263u * rotl(h, 17);
  h = h + y * 3266489917u;
  h = 668265263u * rotl(h, 17);
  h = h + z * 3266489917u;
  h = 668265263u * rotl(h, 17);
  return xxh_avalanche(h);
}
__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  x = __brev(x);
  x = x + seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return __brev(x);
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t seed, uint32_t v) {
  return seed ^ (v + (seed << 6) + (seed >> 2));
}
__device__ __forceinline__ float u32_to_unit(uint32_t u) {  // top 24 bits
  return (float)(int)(u >> 8) * (1.0f / 16777216.0f);
}
// Owen-scrambled Sobol (sobol.cu:10733-10742)
__device__ __forceinline__ float sobol_owen(uint32_t index, int dim, uint32_t seed,
                                            const unsigned* __restrict__ mats) {
  uint32_t sh = nested_uniform_scramble(index, seed);
  const unsigned* row = mats + (dim % 128) * 32;
  uint32_t r = 0u;
  for (int k = 0; k < 32; ++k) {
    if ((sh >> k) & 1u) r ^= row[k];
  }
  return u32_to_unit(nested_uniform_scramble(r, hash_combine(seed, (uint32_t)dim)));
}
// Kensler permute for power-of-two l (cmj.cu:12-43)
__device__ __forceinline__ uint32_t cmj_permute(uint32_t i, uint32_t l, uint32_t p) {
  uint32_t w = l - 1u;
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCB303u;
  i ^= (i & w) >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return (i + p) % l;
}
__device__ __forceinline__ float cmj_randfloat(uint32_t i, uint32_t p) {
  i ^= p;
  i ^= i >> 17;
  i ^= i >> 10;
  i *= 0xB36534E5u;
  i ^= i >> 12;
  i ^= i >> 21;
  i *= 0x93FC4795u;
  i ^= 0xDF6E307Fu;
  i ^= i >> 17;
  i *= 1u | (p >> 18);
  return u32_to_unit(i);
}
// CMJ 2D draw at dimension slot `depth` (cmj.cu:60-82)
__device__ __forceinline__ void draw_cmj_2d(uint32_t n_spp, uint32_t image_idx, uint32_t depth,
                                            uint32_t scramble, float& fx, float& fy) {
  uint32_t index = n_spp % 16u;
  uint32_t key = xxhash32_4(n_spp / 16u, image_idx, depth, scramble);
  uint32_t ip = cmj_permute(index, 16u, key * 0x51633E2Du);
  uint32_t sx = cmj_permute(ip % 4u, 4u, key * 0xA511E9B3u);
  uint32_t sy = cmj_permute(ip / 4u, 4u, key * 0x63D83595u);
  float jx = cmj_randfloat(ip, key * 0xA399D265u);
  float jy = cmj_randfloat(ip, key * 0x711AD6A5u);
  fx = ((float)(int)(ip % 4u) + ((float)(int)sy + jx) / 4.0f) / 4.0f;
  fy = ((float)(int)(ip / 4u) + ((float)(int)sx + jy) / 4.0f) / 4.0f;
}

// ---------------------------------------------------------------------------
// sample mappings (sampling.cu:54-84)

__device__ __forceinline__ void concentric_disk(float u0, float u1, float& px, float& py) {
  float x = 2.0f * u0 - 1.0f;
  float y = 2.0f * u1 - 1.0f;
  bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  float safe_x = x == 0.0f ? 1.0f : x;
  float safe_y = y == 0.0f ? 1.0f : y;
  float theta = use_x ? 0.785398163397448f * (y / safe_x)
                      : 1.5707963267949f - 0.785398163397448f * (x / safe_y);
  bool degenerate = (x == 0.0f) && (y == 0.0f);
  px = degenerate ? 0.0f : r * cosf(theta);
  py = degenerate ? 0.0f : r * sinf(theta);
}
__device__ __forceinline__ V3 cosine_hemisphere(float u0, float u1) {
  float x, z;
  concentric_disk(u0, u1, x, z);
  return v3(x, sqrtf(jmax(1.0f - x * x - z * z, 0.0f)), z);
}


// ---------------------------------------------------------------------------
// skies (pt_fused.eval_sky_c): constant, or the Hosek-Wilkie dome

// cos(pi/2 - 1e-3) in float32: the Hosek model's horizon clamp of theta
#define HOSEK_COS_T_MIN 0x1.0624dap-10f

// acos by the Abramowitz-Stegun 4.4.45 polynomial (pt_fused._acos_poly)
__device__ __forceinline__ float acos_poly(float x) {
  float ax = fabsf(x);
  float p = -0.0012624911f;
  p = p * ax + 0.0066700901f;
  p = p * ax + -0.0170881256f;
  p = p * ax + 0.0308918810f;
  p = p * ax + -0.0501743046f;
  p = p * ax + 0.0889789874f;
  p = p * ax + -0.2145988016f;
  p = p * ax + 1.5707963050f;
  float r = p * sqrtf(jmax(1.0f - ax, 0.0f));
  return x < 0.0f ? 3.14159265358979f - r : r;
}

__device__ __forceinline__ V3 eval_sky(const float* __restrict__ sv, int mode, V3 v) {
  if (mode != SKY_HOSEK) return v3(sv[SV_BG], sv[SV_BG + 1], sv[SV_BG + 2]);
  const float intensity = sv[SV_SKY_INTENSITY];
  const float cos_g = jclip(sv[SV_SUN_DIR] * v.x + sv[SV_SUN_DIR + 1] * v.y + sv[SV_SUN_DIR + 2] * v.z,
                            -1.0f, 1.0f);
  const float gamma = acos_poly(cos_g);
  const float cos_t = jmax(jclip(v.y, -1.0f, 1.0f), HOSEK_COS_T_MIN);
  const float zenith = sqrtf(jmax(cos_t, 0.0f));
  const float ray_m = cos_g * cos_g;
  float out[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* c = sv + SV_HOSEK_CFG + 9 * ch;
    float exp_m = expf(c[4] * gamma);
    // the reference's floor keeps mie_b > 0 at the forward/backward peak
    float mie_b = jmax(1.0f + c[8] * c[8] - 2.0f * c[8] * cos_g, 1e-8f);
    float mie_m = (1.0f + cos_g * cos_g) / (mie_b * sqrtf(mie_b));
    float r = (1.0f + c[0] * expf(c[1] / (cos_t + 0.01f))) *
              (c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith);
    out[ch] = jmax(r * sv[SV_HOSEK_RAD + ch], 0.0f);
  }
  return v3(out[0] * intensity, out[1] * intensity, out[2] * intensity);
}

// ---------------------------------------------------------------------------
// BSDF, in two forms. `Bsdf`: the weight/pmf scaffold of cbsdf.setup with
// the lobes metal (conductor GGX), specular (dielectric GGX) and diffuse_r
// (Oren-Nayar), bxdf.cu:119-207 and :428-560; coat, sheen, transmission and
// diffuse_t have albedo / value 0 in it. `BsdfFull` (further down): all
// seven lobes of cbsdf.ALL_LOBES. In both, lobes outside `lobe_mask`
// evaluate to 0, exactly as cbsdf does for lobes missing from `lobes_on`.

__device__ __forceinline__ V3 normalize0(V3 a) { return normalize(a, 0.0f); }

__device__ __forceinline__ V3 reflect(V3 w, V3 n) {
  float d = dot(w, n);
  return normalize0(v3(-w.x + 2.0f * d * n.x, -w.y + 2.0f * d * n.y, -w.z + 2.0f * d * n.z));
}

__device__ __forceinline__ float fresnel_dielectric(float cos, float ior) {
  float temp = ior * ior + cos * cos - 1.0f;
  float g = sqrtf(jmax(temp, 0.0f));
  float t0 = (g - cos) / (g + cos);
  float t1 = ((g + cos) * cos - 1.0f) / ((g - cos) * cos + 1.0f);
  float fr = 0.5f * t0 * t0 * (1.0f + t1 * t1);
  return temp < 0.0f ? 1.0f : fr;
}

__device__ __forceinline__ float fresnel_conductor1(float cos, float ior, float k) {
  float c2 = cos * cos;
  float two_eta_cos = 2.0f * ior * cos;
  float t0 = ior * ior + k * k;
  float t1 = t0 * c2;
  float rs = (t0 - two_eta_cos + c2) / (t0 + two_eta_cos + c2);
  float rp = (t1 - two_eta_cos + 1.0f) / (t1 + two_eta_cos + 1.0f);
  return 0.5f * (rp + rs);
}

// Gulbrandsen 2014 (bxdf.cu:107-116), one channel
__device__ __forceinline__ void artist_fresnel1(float r, float g, float& n, float& k) {
  r = jclip(r, 0.0f, 0.99f);
  float r_sqrt = sqrtf(r);
  n = g * (1.0f - r) / (1.0f + r) + (1.0f - g) * (1.0f + r_sqrt) / (1.0f - r_sqrt);
  float t1 = n + 1.0f;
  float t2 = n - 1.0f;
  k = sqrtf(jmax((r * (t1 * t1) - t2 * t2) / (1.0f - r), 0.0f));
}

// GGX (bxdf.cu:484-512), isotropic alpha a
__device__ __forceinline__ float ggx_d(V3 wh, float a) {
  float t = wh.x * wh.x / jmax(a * a, 1e-12f) + wh.z * wh.z / jmax(a * a, 1e-12f) + wh.y * wh.y;
  return 1.0f / (F_PI * a * a * t * t);
}
__device__ __forceinline__ float ggx_lambda(V3 w, float a) {
  float t = (a * a * w.x * w.x + a * a * w.z * w.z) / jmax(w.y * w.y, 1e-12f);
  return 0.5f * (-1.0f + sqrtf(1.0f + t));
}
__device__ __forceinline__ float ggx_g2(V3 wo, V3 wi, float a) {
  return 1.0f / (1.0f + ggx_lambda(wo, a) + ggx_lambda(wi, a));
}
__device__ __forceinline__ float ggx_d_visible(V3 w, V3 wh, float a) {
  float g1 = 1.0f / (1.0f + ggx_lambda(w, a));
  return g1 * fabsf(dot(w, wh)) * ggx_d(wh, a) / jmax(fabsf(w.y), 1e-8f);
}

// microfacet reflection pdf (shared by the metal and specular lobes)
__device__ __forceinline__ float mf_reflection_pdf(float a, V3 wo, V3 wi) {
  V3 wh = normalize(wo + wi, 1e-20f);
  return 0.25f * ggx_d_visible(wo, wh, a) / jmax(fabsf(dot(wo, wh)), 1e-8f);
}
__device__ __forceinline__ float mf_dielectric_eval(float ior, float a, V3 wo, V3 wi) {
  V3 wh = normalize(wo + wi, 1e-20f);
  float f = fresnel_dielectric(fabsf(dot(wo, wh)), ior);
  float d = ggx_d(wh, a);
  float g = ggx_g2(wo, wi, a);
  float denom = jmax(fabsf(wo.y) * fabsf(wi.y), 1e-8f);
  return 0.25f * f * d * g / denom;
}
__device__ __forceinline__ V3 mf_conductor_eval(V3 n, V3 k, float a, V3 wo, V3 wi) {
  V3 wh = normalize(wo + wi, 1e-20f);
  float c = fabsf(dot(wo, wh));
  V3 f = v3(fresnel_conductor1(c, n.x, k.x), fresnel_conductor1(c, n.y, k.y),
            fresnel_conductor1(c, n.z, k.z));
  float d = ggx_d(wh, a);
  float g = ggx_g2(wo, wi, a);
  float s = d * g / jmax(fabsf(wo.y) * fabsf(wi.y), 1e-8f);
  return v3(0.25f * f.x * s, 0.25f * f.y * s, 0.25f * f.z * s);
}

// Heitz 2018 visible-normal sampling (sampling.cu:87-110)
__device__ __forceinline__ V3 sample_vndf(V3 wo, float a, float u0, float u1) {
  V3 vh = normalize0(v3(a * wo.x, wo.y, a * wo.z));
  float lensq = vh.x * vh.x + vh.z * vh.z;
  bool has_len = lensq > 0.0f;
  float inv_len = has_len ? 1.0f / sqrtf(jmax(lensq, 1e-30f)) : 0.0f;
  V3 t1 = v3(has_len ? vh.z * inv_len : 0.0f, 0.0f, has_len ? -vh.x * inv_len : 1.0f);
  V3 t2 = v3(vh.y * t1.z - vh.z * t1.y, vh.z * t1.x - vh.x * t1.z, vh.x * t1.y - vh.y * t1.x);
  float r = sqrtf(u0);
  float phi = 6.28318530717958647f * u1;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + vh.y);
  p2 = (1.0f - s) * sqrtf(jmax(1.0f - p1 * p1, 0.0f)) + s * p2;
  float p3 = sqrtf(jmax(1.0f - p1 * p1 - p2 * p2, 0.0f));
  V3 nh = v3(p1 * t1.x + p2 * t2.x + p3 * vh.x, p1 * t1.y + p2 * t2.y + p3 * vh.y,
             p1 * t1.z + p2 * t2.z + p3 * vh.z);
  return normalize0(v3(a * nh.x, jmax(nh.y, 0.0f), a * nh.z));
}

// bilinear hat weights over 16 bins (cbsdf._bilinear_weights_16)
__device__ __forceinline__ void hat16(float u, int& i0, int& i1, float& w0, float& w1) {
  float xi = u * 16.0f;
  float i = jclip(floorf(xi), 0.0f, 15.0f);
  float ip = jmin(i + 1.0f, 15.0f);
  float hx = xi - i;
  i0 = (int)i;
  i1 = (int)ip;
  w0 = 1.0f - hx;
  w1 = hx;
}
// bilinear fetch of channel ch of a [16, 16, nch] table; the terms are
// summed in the order of cbsdf._lut_fetch_16x16 (zero terms are exact)
__device__ __forceinline__ float lut_fetch_n(const float* __restrict__ lut, int nch, int ch, float u,
                                             float v) {
  int i0, i1, j0, j1;
  float a0, a1, b0, b1;
  hat16(u, i0, i1, a0, a1);
  hat16(v, j0, j1, b0, b1);
  float r0, r1;
  if (i0 == i1) {
    r0 = (a0 + a1) * lut[(i0 * 16 + j0) * nch + ch];
    r1 = (a0 + a1) * lut[(i0 * 16 + j1) * nch + ch];
  } else {
    r0 = a0 * lut[(i0 * 16 + j0) * nch + ch] + a1 * lut[(i1 * 16 + j0) * nch + ch];
    r1 = a0 * lut[(i0 * 16 + j1) * nch + ch] + a1 * lut[(i1 * 16 + j1) * nch + ch];
  }
  return j0 == j1 ? (b0 + b1) * r0 : b0 * r0 + b1 * r1;
}
// channel ch of the [16, 16, 2] reflection table
__device__ __forceinline__ float lut_fetch(const float* __restrict__ lut, int ch, float u, float v) {
  return lut_fetch_n(lut, 2, ch, u, v);
}
// cbsdf.compute_directional_albedo_reflection: F0 R + (1 - F0) G
__device__ __forceinline__ float albedo_reflection(const float* __restrict__ lut, float u, float rough,
                                                   float f0) {
  const float v = jclip(rough, 0.0f, 1.0f);
  return f0 * lut_fetch(lut, 0, u, v) + (1.0f - f0) * lut_fetch(lut, 1, u, v);
}

struct Bsdf {
  V3 base_color;
  float rough;       // diffuse roughness
  float eta;
  float alpha;       // specular GGX alpha (isotropic)
  float metal_g, spec_g, diffuse_g;  // weights after the entering gate
  float spec_lum;
  V3 metal_n, metal_k;
  V3 mult_metal, mult_spec, mult_d;  // layer multipliers of the three lobes
  float pmf[7];
  int lobes;
};

__device__ __forceinline__ Bsdf bsdf_setup(const float* __restrict__ m, V3 wo, bool entering, int lobe_mask,
                                           const float* __restrict__ lut) {
  Bsdf b;
  b.lobes = lobe_mask;
  b.base_color = v3(m[M_BASE_COLOR], m[M_BASE_COLOR + 1], m[M_BASE_COLOR + 2]);
  const V3 sc = v3(m[M_SPECULAR_COLOR], m[M_SPECULAR_COLOR + 1], m[M_SPECULAR_COLOR + 2]);
  b.rough = m[M_DIFFUSE_ROUGHNESS];
  const float ni = entering ? 1.0f : 1.5f;
  const float nt = entering ? 1.5f : 1.0f;
  b.eta = nt / ni;
  const float spec_rough = jclip(m[M_SPECULAR_ROUGHNESS], 0.01f, 1.0f);
  float coat = jclip(m[M_COAT], 0.0f, 1.0f);
  V3 cc = v3(m[M_COAT_COLOR], m[M_COAT_COLOR + 1], m[M_COAT_COLOR + 2]);
  float trans = m[M_TRANSMISSION];
  float ss = m[M_SUBSURFACE];
  float thin = m[M_THIN_WALLED];
  b.spec_lum = luminance(sc);
  const float f0r = (nt - ni) / (nt + ni);
  const float f0 = f0r * f0r;
  // the specular albedo gate reads the ungated weight (cbsdf.setup)
  float spec_albedo = 0.0f;
  if ((lobe_mask & LOBE_SPECULAR) && (m[M_SPECULAR] * b.spec_lum > 0.0f) && (b.eta >= 1.0f)) {
    float u = fabsf(wo.y), v = jclip(spec_rough, 0.0f, 1.0f);
    spec_albedo = f0 * lut_fetch(lut, 0, u, v) + (1.0f - f0) * lut_fetch(lut, 1, u, v);
  }
  // reflective lobes are off when shading from inside (bsdf.cu:56-62)
  float coat_g = entering ? coat : 0.0f;
  b.metal_g = entering ? m[M_METALNESS] : 0.0f;
  b.spec_g = entering ? m[M_SPECULAR] : 0.0f;
  float sheen_g = entering ? m[M_SHEEN] : 0.0f;
  b.diffuse_g = entering ? m[M_DIFFUSE] : 0.0f;
  // coat absorption uses the ungated coat weight (bsdf.cu:27-30 quirk)
  V3 ca = v3(1.0f + (cc.x - 1.0f) * coat, 1.0f + (cc.y - 1.0f) * coat, 1.0f + (cc.z - 1.0f) * coat);
  // coat and sheen albedos are 0: those lobes are BsdfFull's
  float c = coat_g * 0.0f;
  float s = b.spec_g * spec_albedo;
  float sh = sheen_g * 0.0f;
  float w[7];
  w[0] = c;
  w[1] = (1.0f - c) * b.metal_g;
  w[2] = (1.0f - c) * (1.0f - b.metal_g) * s;
  w[3] = (1.0f - c) * (1.0f - b.metal_g) * (1.0f - s) * trans;
  w[4] = (1.0f - c) * (1.0f - b.metal_g) * (1.0f - s) * sh;
  w[5] = (1.0f - c) * (1.0f - b.metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * ss * thin;
  w[6] = (1.0f - c) * (1.0f - b.metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * (1.0f - ss) *
         b.diffuse_g;
  float total = w[0] + w[1] + w[2] + w[3] + w[4] + w[5] + w[6];
  float inv_total = 1.0f / (total > 0.0f ? total : 1.0f);
  for (int k = 0; k < 7; ++k) b.pmf[k] = w[k] * inv_total;

  if (lobe_mask & LOBE_METAL) {
    artist_fresnel1(jclip(b.base_color.x, 0.0f, 0.99f), jclip(sc.x, 0.0f, 0.99f), b.metal_n.x, b.metal_k.x);
    artist_fresnel1(jclip(b.base_color.y, 0.0f, 0.99f), jclip(sc.y, 0.0f, 0.99f), b.metal_n.y, b.metal_k.y);
    artist_fresnel1(jclip(b.base_color.z, 0.0f, 0.99f), jclip(sc.z, 0.0f, 0.99f), b.metal_n.z, b.metal_k.z);
  } else {
    b.metal_n = b.metal_k = v3(1.0f, 1.0f, 1.0f);
  }
  b.alpha = spec_rough * spec_rough;  // roughness_to_alpha, no anisotropy

  // layer chain of eval/sample (cbsdf._layer_multipliers); the sheen
  // attenuation is 1 - sheen * 0 == 1 exactly
  b.mult_metal = ca * b.metal_g;
  V3 base2 = ca * (1.0f - b.metal_g);
  b.mult_spec = base2 * b.spec_g * sc;
  V3 spec_att = v3(1.0f - b.spec_g * sc.x * spec_albedo, 1.0f - b.spec_g * sc.y * spec_albedo,
                   1.0f - b.spec_g * sc.z * spec_albedo);
  V3 base = base2 * spec_att;
  base = base * (1.0f - trans);
  b.mult_d = base * (1.0f - ss) * b.diffuse_g;
  return b;
}

__device__ __forceinline__ float oren_nayar_scalar(float rough, V3 wo, V3 wi) {
  float sigma2 = rough * rough;
  float a = 1.0f - sigma2 / (2.0f * (sigma2 + 0.33f));
  float b = 0.45f * sigma2 / (sigma2 + 0.09f);
  float s2o = jmax(1.0f - wo.y * wo.y, 0.0f);
  float s2i = jmax(1.0f - wi.y * wi.y, 0.0f);
  float s_o = sqrtf(s2o);
  float s_i = sqrtf(s2i);
  bool both = (s_i > 1e-4f) && (s_o > 1e-4f);
  float ro = sqrtf(jmax(s2o, 1e-20f));
  float ri = sqrtf(jmax(s2i, 1e-20f));
  float c = (wi.x / ri) * (wo.x / ro) + (wi.z / ri) * (wo.z / ro);
  float c_max = both ? jmax(c, 0.0f) : 0.0f;
  bool use_i = fabsf(wi.y) > fabsf(wo.y);
  float s_alpha = use_i ? s_o : s_i;
  float t_beta = use_i ? s_i / jmax(fabsf(wi.y), 1e-8f) : s_o / jmax(fabsf(wo.y), 1e-8f);
  return (a + b * c_max * s_alpha * t_beta) * F_INV_PI;
}

// cbsdf.eval and cbsdf.eval_pdf in one pass
__device__ __forceinline__ void bsdf_eval(const Bsdf& b, V3 wo, V3 wi, V3& f, float& pdf) {
  V3 fm = zero3(), fs = zero3(), fd = zero3();
  float pm = 0.0f, ps = 0.0f, pd = 0.0f;
  const bool metal_on = (b.lobes & LOBE_METAL) && b.metal_g > 0.0f;
  const bool spec_on = (b.lobes & LOBE_SPECULAR) && b.spec_g * b.spec_lum > 0.0f;
  if (metal_on || spec_on) {
    float p = san(mf_reflection_pdf(b.alpha, wo, wi));
    if (metal_on) {
      fm = san3(mf_conductor_eval(b.metal_n, b.metal_k, b.alpha, wo, wi));
      pm = p;
    }
    if (spec_on) {
      float x = san(mf_dielectric_eval(b.eta, b.alpha, wo, wi));
      fs = v3(x, x, x);
      ps = p;
    }
  }
  if ((b.lobes & LOBE_DIFFUSE_R) && b.diffuse_g > 0.0f) {
    fd = san3(b.base_color * oren_nayar_scalar(b.rough, wo, wi));
    pd = san(fabsf(wi.y) * F_INV_PI);
  }
  f = b.mult_metal * fm + b.mult_spec * fs + b.mult_d * fd;
  pdf = b.pmf[1] * pm + b.pmf[2] * ps + b.pmf[6] * pd;
}

// cbsdf.sample: lobe by the unrolled CDF, then its direction
__device__ __forceinline__ void bsdf_sample(const Bsdf& b, V3 wo, float u, float v0, float v1, V3& wi,
                                            V3& f, float& pdf) {
  float acc = 0.0f;
  int idx = 0;
  for (int k = 0; k < 7; ++k) {
    acc = acc + b.pmf[k];
    idx += (u >= acc) ? 1 : 0;
  }
  idx = idx < 6 ? idx : 6;
  float pmf_sel = b.pmf[6];  // select chain keeps pmf in registers
#pragma unroll
  for (int k = 0; k < 6; ++k) pmf_sel = idx == k ? b.pmf[k] : pmf_sel;
  wi = zero3();
  f = zero3();
  float p = 0.0f;
  if ((idx == 1 && (b.lobes & LOBE_METAL)) || (idx == 2 && (b.lobes & LOBE_SPECULAR))) {
    V3 wh = sample_vndf(wo, b.alpha, v0, v1);
    wi = reflect(wo, wh);
    if (idx == 1) {
      f = mf_conductor_eval(b.metal_n, b.metal_k, b.alpha, wo, wi) * b.mult_metal;
    } else {
      float x = mf_dielectric_eval(b.eta, b.alpha, wo, wi);
      f = v3(x, x, x) * b.mult_spec;
    }
    p = mf_reflection_pdf(b.alpha, wo, wi);
  } else if (idx == 6 && (b.lobes & LOBE_DIFFUSE_R)) {
    wi = cosine_hemisphere(v0, v1);
    f = (b.base_color * oren_nayar_scalar(b.rough, wo, wi)) * b.mult_d;
    p = fabsf(wi.y) * F_INV_PI;
  }
  f = san3(f);
  pdf = san(p * pmf_sel);
}

// ---------------------------------------------------------------------------
// The full BSDF: all seven lobes of cbsdf.ALL_LOBES (bsdf.cu, bxdf.cu), for
// the kernel variant that shades scenes with a coat, transmission, sheen
// or diffuse transmission. The weights, guard masks, layer chain and CDF
// select follow cbsdf.setup, _lobe_evals, eval, eval_pdf,
// _layer_multipliers and sample term for term; the lobes below follow
// their cbsdf namesakes.

// dielectric microfacet transmission (bxdf.cu:562-740): the half vector of
// wo and wi refracted from ior ni into nt, turned to the +Y side
__device__ __forceinline__ V3 transmission_half(float ni, float nt, V3 wo, V3 wi) {
  V3 wh = normalize(v3(-(ni * wo.x + nt * wi.x), -(ni * wo.y + nt * wi.y), -(ni * wo.z + nt * wi.z)),
                    1e-20f);
  return wh.y < 0.0f ? -wh : wh;
}
__device__ __forceinline__ float mf_transmission_eval(float ni, float nt, float a, V3 wo, V3 wi) {
  V3 wh = transmission_half(ni, nt, wo, wi);
  float f = fresnel_dielectric(fabsf(dot(wo, wh)), nt / ni);
  float d = ggx_d(wh, a);
  float g = ggx_g2(wo, wi, a);
  float wo_wh = dot(wo, wh);
  float wi_wh = dot(wi, wh);
  float t = ni * wo_wh + nt * wi_wh;
  float denom = jmax(fabsf(wo.y) * fabsf(wi.y) * t * t, 1e-10f);
  return fabsf(wo_wh) * fabsf(wi_wh) * nt * nt * jmax(1.0f - f, 0.0f) * g * d / denom;
}
__device__ __forceinline__ float mf_transmission_pdf(float ni, float nt, float a, V3 wo, V3 wi) {
  V3 wh = transmission_half(ni, nt, wo, wi);
  float wi_wh = dot(wi, wh);
  float t = ni * dot(wo, wh) + nt * wi_wh;
  return ggx_d_visible(wo, wh, a) * nt * nt * fabsf(wi_wh) / jmax(t * t, 1e-10f);
}
// Snell refraction of w about n (cvec.refract); ok is false under total
// internal reflection
__device__ __forceinline__ V3 refract(V3 w, V3 n, float ni, float nt, bool& ok) {
  float eta = ni / nt;
  float wn = dot(w, n);
  V3 th = v3(-eta * (w.x - wn * n.x), -eta * (w.y - wn * n.y), -eta * (w.z - wn * n.z));
  float th2 = dot(th, th);
  ok = th2 <= 1.0f;
  float tp = -sqrtf(jmax(1.0f - th2, 0.0f));
  return v3(th.x + tp * n.x, th.y + tp * n.y, th.z + tp * n.z);
}
// cbsdf.microfacet_transmission_sample: a visible normal, then the
// refracted direction, or under total internal reflection the mirrored
// one with the reflection's value and pdf at that normal
__device__ __forceinline__ void mf_transmission_sample(float ni, float nt, float a, V3 wo, float u0,
                                                       float u1, V3& wi, float& f, float& pdf) {
  V3 wh = sample_vndf(wo, a, u0, u1);
  bool ok;
  V3 wt = refract(wo, wh, ni, nt, ok);
  if (ok) {
    wi = wt;
    f = mf_transmission_eval(ni, nt, a, wo, wt);
    pdf = mf_transmission_pdf(ni, nt, a, wo, wt);
  } else {
    V3 wr = reflect(wo, wh);
    float fr = fresnel_dielectric(fabsf(dot(wo, wh)), nt / ni);
    float d = ggx_d(wh, a);
    float g = ggx_g2(wo, wr, a);
    float denom = jmax(fabsf(wo.y) * fabsf(wr.y), 1e-8f);
    wi = wr;
    f = 0.25f * fr * d * g / denom;
    pdf = 0.25f * ggx_d_visible(wo, wh, a) / jmax(fabsf(dot(wr, wh)), 1e-8f);
  }
}

// production sheen (Estevez & Kulla 2017; bxdf.cu:743-822)
__device__ __forceinline__ float sheen_l(float x, float rough) {
  float t = 1.0f - rough;
  float t2 = t * t;
  float a = t2 * 25.3245f + (1.0f - t2) * 21.5473f;
  float b = t2 * 3.32435f + (1.0f - t2) * 3.82987f;
  float c = t2 * 0.16801f + (1.0f - t2) * 0.19823f;
  float d = t2 * -1.27393f + (1.0f - t2) * -1.97760f;
  float e = t2 * -4.85967f + (1.0f - t2) * -4.32054f;
  return a / (1.0f + b * expf(c * logf(jmax(x, 1e-8f)))) + d * x + e;
}
__device__ __forceinline__ float sheen_lambda(float cos, float rough) {  // cos = |w.y|
  return cos < 0.5f ? expf(sheen_l(cos, rough))
                    : expf(2.0f * sheen_l(0.5f, rough) - sheen_l(1.0f - cos, rough));
}
__device__ __forceinline__ float sheen_d(V3 wh, float rough) {
  float s = sqrtf(jmax(1.0f - wh.y * wh.y, 0.0f));
  float inv_r = 1.0f / jmax(rough, 1e-4f);
  return (2.0f + inv_r) * expf(inv_r * logf(jmax(s, 1e-8f))) / 6.28318530717958647f;
}
__device__ __forceinline__ float sheen_eval(float rough, V3 wo, V3 wi) {
  V3 wh = normalize(wo + wi, 1e-20f);
  float d = sheen_d(wh, rough);
  float g = 1.0f / (1.0f + sheen_lambda(fabsf(wo.y), rough) + sheen_lambda(fabsf(wi.y), rough));
  float denom = jmax(fabsf(wo.y) * fabsf(wi.y), 1e-8f);
  return 0.25f * d * g / denom;
}

struct BsdfFull {
  V3 base_color;
  float rough;        // diffuse roughness
  float ni, nt, eta;  // ior on wo's side, across the surface, and nt / ni
  float alpha;        // GGX alpha of metal, specular and transmission
  float coat_alpha;
  float sheen_rough;
  float coat_g;       // the coat weight after the entering gate
  V3 metal_n, metal_k;
  V3 mult[7];         // layer multipliers (cbsdf._layer_multipliers)
  float pmf[7];
  int lobes;          // lobe_mask
  int eval_lobes;     // lobe_mask and each lobe's guard (cbsdf._lobe_evals)
};

// How bsdf_setup_full takes the material row: a pointer to it, kept
// __restrict__ so that the variants passing one compile to the same
// machine code, or a view of it (shade.cu `TexRow`) read by operator[]
template <class M>
struct MatRow {
  using type = const M&;
};
template <>
struct MatRow<const float*> {
  using type = const float* __restrict__;
};

template <class M = const float*>
__device__ __forceinline__ BsdfFull bsdf_setup_full(typename MatRow<M>::type m, V3 wo, bool entering,
                                                    int lobe_mask, const float* __restrict__ lut,
                                                    const float* __restrict__ sheen_lut) {
  BsdfFull b;
  b.lobes = lobe_mask;
  b.base_color = v3(m[M_BASE_COLOR], m[M_BASE_COLOR + 1], m[M_BASE_COLOR + 2]);
  const V3 sc = v3(m[M_SPECULAR_COLOR], m[M_SPECULAR_COLOR + 1], m[M_SPECULAR_COLOR + 2]);
  const V3 cc = v3(m[M_COAT_COLOR], m[M_COAT_COLOR + 1], m[M_COAT_COLOR + 2]);
  const V3 tc = v3(m[M_TRANSMISSION_COLOR], m[M_TRANSMISSION_COLOR + 1], m[M_TRANSMISSION_COLOR + 2]);
  const V3 shc = v3(m[M_SHEEN_COLOR], m[M_SHEEN_COLOR + 1], m[M_SHEEN_COLOR + 2]);
  const V3 ssc = v3(m[M_SUBSURFACE_COLOR], m[M_SUBSURFACE_COLOR + 1], m[M_SUBSURFACE_COLOR + 2]);
  b.rough = m[M_DIFFUSE_ROUGHNESS];
  b.ni = entering ? 1.0f : 1.5f;
  b.nt = entering ? 1.5f : 1.0f;
  b.eta = b.nt / b.ni;
  const float spec_rough = jclip(m[M_SPECULAR_ROUGHNESS], 0.01f, 1.0f);
  const float coat = jclip(m[M_COAT], 0.0f, 1.0f);
  const float coat_rough = jclip(m[M_COAT_ROUGHNESS], 0.0f, 1.0f);
  const float trans = m[M_TRANSMISSION];
  const float sheen = m[M_SHEEN];
  b.sheen_rough = m[M_SHEEN_ROUGHNESS];
  const float ss = m[M_SUBSURFACE];
  const float thin = m[M_THIN_WALLED];
  const float coat_lum = luminance(cc);
  const float spec_lum = luminance(sc);
  const float sheen_lum = luminance(shc);
  const float f0r = (b.nt - b.ni) / (b.nt + b.ni);
  const float f0 = f0r * f0r;
  const float u = fabsf(wo.y);
  // the albedo gates read the ungated weights (cbsdf.setup)
  float coat_albedo = 0.0f, spec_albedo = 0.0f, sheen_albedo = 0.0f;
  if ((lobe_mask & LOBE_COAT) && (coat * coat_lum > 0.0f) && entering)
    coat_albedo = albedo_reflection(lut, u, coat_rough, f0);
  if ((lobe_mask & LOBE_SPECULAR) && (m[M_SPECULAR] * spec_lum > 0.0f) && (b.eta >= 1.0f))
    spec_albedo = albedo_reflection(lut, u, spec_rough, f0);
  if ((lobe_mask & LOBE_SHEEN) && (sheen * sheen_lum > 0.0f) && entering)
    sheen_albedo = lut_fetch_n(sheen_lut, 1, 0, u, jclip(b.sheen_rough, 0.0f, 1.0f));
  // reflective lobes are off when shading from inside (bsdf.cu:56-62)
  b.coat_g = entering ? coat : 0.0f;
  const float metal_g = entering ? m[M_METALNESS] : 0.0f;
  const float spec_g = entering ? m[M_SPECULAR] : 0.0f;
  const float sheen_g = entering ? sheen : 0.0f;
  const float diffuse_g = entering ? m[M_DIFFUSE] : 0.0f;
  // coat absorption uses the ungated coat weight (bsdf.cu:27-30 quirk)
  const V3 ca = v3(1.0f + (cc.x - 1.0f) * coat, 1.0f + (cc.y - 1.0f) * coat, 1.0f + (cc.z - 1.0f) * coat);
  const float c = b.coat_g * coat_albedo;
  const float s = spec_g * spec_albedo;
  const float sh = sheen_g * sheen_albedo;
  float w[7];
  w[0] = c;
  w[1] = (1.0f - c) * metal_g;
  w[2] = (1.0f - c) * (1.0f - metal_g) * s;
  w[3] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * trans;
  w[4] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * sh;
  w[5] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * ss * thin;
  w[6] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * (1.0f - ss) *
         diffuse_g;
  float total = w[0] + w[1] + w[2] + w[3] + w[4] + w[5] + w[6];
  float inv_total = 1.0f / (total > 0.0f ? total : 1.0f);
#pragma unroll
  for (int k = 0; k < 7; ++k) b.pmf[k] = w[k] * inv_total;

  if (lobe_mask & LOBE_METAL) {
    artist_fresnel1(jclip(b.base_color.x, 0.0f, 0.99f), jclip(sc.x, 0.0f, 0.99f), b.metal_n.x, b.metal_k.x);
    artist_fresnel1(jclip(b.base_color.y, 0.0f, 0.99f), jclip(sc.y, 0.0f, 0.99f), b.metal_n.y, b.metal_k.y);
    artist_fresnel1(jclip(b.base_color.z, 0.0f, 0.99f), jclip(sc.z, 0.0f, 0.99f), b.metal_n.z, b.metal_k.z);
  } else {
    b.metal_n = b.metal_k = v3(1.0f, 1.0f, 1.0f);
  }
  b.alpha = spec_rough * spec_rough;  // roughness_to_alpha, no anisotropy
  b.coat_alpha = coat_rough * coat_rough;

  int guard = 0;
  guard |= b.coat_g * coat_lum > 0.0f ? LOBE_COAT : 0;
  guard |= metal_g > 0.0f ? LOBE_METAL : 0;
  guard |= spec_g * spec_lum > 0.0f ? LOBE_SPECULAR : 0;
  guard |= trans > 0.0f ? LOBE_TRANSMISSION : 0;
  guard |= sheen_g * sheen_lum > 0.0f ? LOBE_SHEEN : 0;
  guard |= ss * thin > 0.0f ? LOBE_DIFFUSE_T : 0;
  guard |= diffuse_g > 0.0f ? LOBE_DIFFUSE_R : 0;
  b.eval_lobes = lobe_mask & guard;

  // layer chain of eval/sample (cbsdf._layer_multipliers)
  const V3 spec_att = v3(1.0f - spec_g * sc.x * spec_albedo, 1.0f - spec_g * sc.y * spec_albedo,
                         1.0f - spec_g * sc.z * spec_albedo);
  const float sheen_att = 1.0f - sheen_g * sheen_albedo;
  b.mult[0] = v3(b.coat_g, b.coat_g, b.coat_g);
  b.mult[1] = ca * metal_g;
  const V3 base2 = ca * (1.0f - metal_g);
  b.mult[2] = base2 * spec_g * sc;
  const V3 base3 = base2 * spec_att;
  b.mult[3] = base3 * trans * tc;
  const V3 base4 = base3 * (1.0f - trans);
  b.mult[4] = base4 * sheen_g * shc;
  const V3 base5 = base4 * sheen_att;
  b.mult[5] = base5 * ss * ssc * thin;
  b.mult[6] = base5 * (1.0f - ss) * diffuse_g;
  return b;
}

// cbsdf.eval and cbsdf.eval_pdf in one pass: each lobe's value and pdf
// where its guard holds (non-finite ones zeroed), summed in lobe order
__device__ __forceinline__ void bsdf_eval(const BsdfFull& b, V3 wo, V3 wi, V3& f, float& pdf) {
  const int on = b.eval_lobes;
  V3 fk[7];
  float pk[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    fk[k] = zero3();
    pk[k] = 0.0f;
  }
  if (on & LOBE_COAT) {
    float x = san(mf_dielectric_eval(b.eta, b.coat_alpha, wo, wi));
    fk[0] = v3(x, x, x);
    pk[0] = san(mf_reflection_pdf(b.coat_alpha, wo, wi));
  }
  if (on & (LOBE_METAL | LOBE_SPECULAR)) {
    float p = san(mf_reflection_pdf(b.alpha, wo, wi));
    if (on & LOBE_METAL) {
      fk[1] = san3(mf_conductor_eval(b.metal_n, b.metal_k, b.alpha, wo, wi));
      pk[1] = p;
    }
    if (on & LOBE_SPECULAR) {
      float x = san(mf_dielectric_eval(b.eta, b.alpha, wo, wi));
      fk[2] = v3(x, x, x);
      pk[2] = p;
    }
  }
  if (on & LOBE_TRANSMISSION) {
    float x = san(mf_transmission_eval(b.ni, b.nt, b.alpha, wo, wi));
    fk[3] = v3(x, x, x);
    pk[3] = san(mf_transmission_pdf(b.ni, b.nt, b.alpha, wo, wi));
  }
  if (on & LOBE_SHEEN) {
    float x = san(sheen_eval(b.sheen_rough, wo, wi));
    fk[4] = v3(x, x, x);
    pk[4] = san(fabsf(wi.y) * F_INV_PI);
  }
  if (on & (LOBE_DIFFUSE_T | LOBE_DIFFUSE_R)) {
    V3 x = san3(b.base_color * oren_nayar_scalar(b.rough, wo, wi));
    float p = san(fabsf(wi.y) * F_INV_PI);
    if (on & LOBE_DIFFUSE_T) {
      fk[5] = x;
      pk[5] = p;
    }
    if (on & LOBE_DIFFUSE_R) {
      fk[6] = x;
      pk[6] = p;
    }
  }
  f = fk[0] * b.coat_g;
  pdf = 0.0f;
#pragma unroll
  for (int k = 1; k < 7; ++k) f = f + b.mult[k] * fk[k];
#pragma unroll
  for (int k = 0; k < 7; ++k) pdf = pdf + b.pmf[k] * pk[k];
}

// cbsdf.sample: lobe by the unrolled CDF, then its direction
__device__ __forceinline__ void bsdf_sample(const BsdfFull& b, V3 wo, float u, float v0, float v1, V3& wi,
                                            V3& f, float& pdf) {
  float acc = 0.0f;
  int idx = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    acc = acc + b.pmf[k];
    idx += (u >= acc) ? 1 : 0;
  }
  idx = idx < 6 ? idx : 6;
  float pmf_sel = b.pmf[6];  // select chains keep pmf and mult in registers
  V3 mult = b.mult[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    pmf_sel = idx == k ? b.pmf[k] : pmf_sel;
    mult = idx == k ? b.mult[k] : mult;
  }
  wi = zero3();
  f = zero3();
  float p = 0.0f;
  if (b.lobes & (1 << idx)) {
    if (idx == 0 || idx == 1 || idx == 2) {  // GGX reflection: coat, metal, specular
      const float a = idx == 0 ? b.coat_alpha : b.alpha;
      V3 wh = sample_vndf(wo, a, v0, v1);
      wi = reflect(wo, wh);
      if (idx == 1) {
        f = mf_conductor_eval(b.metal_n, b.metal_k, a, wo, wi);
      } else {
        float x = mf_dielectric_eval(b.eta, a, wo, wi);
        f = v3(x, x, x);
      }
      p = mf_reflection_pdf(a, wo, wi);
    } else if (idx == 3) {
      float x;
      mf_transmission_sample(b.ni, b.nt, b.alpha, wo, v0, v1, wi, x, p);
      f = v3(x, x, x);
    } else if (idx == 4) {
      wi = reflect(wo, cosine_hemisphere(v0, v1));
      float x = sheen_eval(b.sheen_rough, wo, wi);
      f = v3(x, x, x);
      p = fabsf(wi.y) * F_INV_PI;
    } else {  // diffuse_t (the flipped hemisphere) or diffuse_r
      wi = cosine_hemisphere(v0, v1);
      if (idx == 5) wi = -wi;
      f = b.base_color * oren_nayar_scalar(b.rough, wo, wi);
      p = fabsf(wi.y) * F_INV_PI;
    }
    f = f * mult;
  }
  f = san3(f);
  pdf = san(p * pmf_sel);
}

// ---------------------------------------------------------------------------
// textures (scene/texture.py): 8x2 texel runs at x-stride 4, wrap baked in,
// so a bilinear footprint lies in one run row

struct Texel4 {
  float r, g, b, a;
};

__device__ __forceinline__ float srgb_to_linear(float c) {
  return c <= 0.04045f ? c / 12.92f : powf((c + 0.055f) / 1.055f, 2.4f);
}

__device__ __forceinline__ Texel4 unpack_texel(uint32_t t, bool srgb) {
  Texel4 o;
  o.r = (float)(t & 0xFFu) / 255.0f;
  o.g = (float)((t >> 8) & 0xFFu) / 255.0f;
  o.b = (float)((t >> 16) & 0xFFu) / 255.0f;
  o.a = (float)(t >> 24) / 255.0f;
  if (srgb) {
    o.r = srgb_to_linear(o.r);
    o.g = srgb_to_linear(o.g);
    o.b = srgb_to_linear(o.b);
  }
  return o;
}

// `sample_texture_hdr`: the bilinear fetch at (u, v) of the texture whose
// header (run offset, width, height, runs per row, srgb) is hdr[0..4].
// jnp.mod is a floor-mod: a floor of -1 wraps to w - 1 (C's % truncates).
// The footprint's run row is off + yw * rw + xw / 4, its texels columns
// lx, lx + 1, lx + 8 and lx + 9 of it (lx = xw % 4). The weights multiply
// and sum in the twin's order.
__device__ __forceinline__ Texel4 tex_fetch(const unsigned* __restrict__ runs, int n_runs,
                                            const float* __restrict__ hdr, float u, float v) {
  const float uu = u * hdr[1] - 0.5f;
  const float vv = v * hdr[2] - 0.5f;
  const float x0 = floorf(uu), y0 = floorf(vv);
  const float fx = uu - x0, fy = vv - y0;
  const int wi = max((int)hdr[1], 1), hi = max((int)hdr[2], 1);
  int xw = (int)x0 % wi;
  int yw = (int)y0 % hi;
  xw += xw < 0 ? wi : 0;
  yw += yw < 0 ? hi : 0;
  int ri = (int)hdr[0] + yw * (int)hdr[3] + xw / 4;
  ri = ri < 0 ? 0 : (ri > n_runs - 1 ? n_runs - 1 : ri);
  const unsigned* row = runs + (long long)ri * 16 + (xw & 3);
  const bool srgb = hdr[4] > 0.0f;
  const Texel4 t00 = unpack_texel(row[0], srgb), t10 = unpack_texel(row[1], srgb);
  const Texel4 t01 = unpack_texel(row[8], srgb), t11 = unpack_texel(row[9], srgb);
  const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
  Texel4 o;
  o.r = w00 * t00.r + w10 * t10.r + w01 * t01.r + w11 * t11.r;
  o.g = w00 * t00.g + w10 * t10.g + w01 * t01.g + w11 * t11.g;
  o.b = w00 * t00.b + w10 * t10.b + w01 * t01.b + w11 * t11.b;
  o.a = w00 * t00.a + w10 * t10.a + w01 * t01.a + w11 * t11.a;
  return o;
}
