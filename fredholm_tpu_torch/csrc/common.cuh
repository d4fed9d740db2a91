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
  const long long* n_spp;     // [N] per-pixel sample count (uint32 values)
  long long* sample_idx;      // [N] raygen writes, mega reads
  const float* state_in;      // [14, N]
  float* state_out;           // [14, N]
  const float* rays_in;       // [7, rays_in_stride]
  const float* hit_t;         // closest hits over the rays_in blocks
  const int* hit_prim;
  const float* hit_u;
  const float* hit_v;
  const float* pending_in;    // [11, N]
  float* pending_out;         // [11, N]
  float* rays_out;            // [7, B*N]
  float* aov_out;             // [12, N] (bounce 0 only)
  float* rad_out;             // [3, N] (final resolve)
  long long rays_in_stride;
  int n;
  int width;
  int height;
  int d;
  int max_depth;
  int n_faces;
  int n_mats;
  int n_lights;
  int lobe_mask;              // bit 6: diffuse_r
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
#define M_METALNESS 14
#define M_COAT 15
#define M_COAT_COLOR 17
#define M_TRANSMISSION 20
#define M_SHEEN 24
#define M_SUBSURFACE 29
#define M_THIN_WALLED 33

#define LOBE_DIFFUSE_R 64

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
// BSDF: the weight/pmf scaffold of cbsdf.setup with the diffuse_r lobe
// (Oren-Nayar, bxdf.cu:119-207). Lobes outside `lobe_mask` evaluate to 0,
// exactly as cbsdf does for lobes missing from `lobes_on`.

struct Bsdf {
  V3 base_color;
  float rough;
  float diffuse_g;  // diffuse weight after the entering gate
  V3 fmul_d;        // layer multiplier of the diffuse_r lobe (incl. diffuse_g)
  float pmf[7];
  bool diffuse_on;
};

__device__ __forceinline__ Bsdf bsdf_setup(const float* __restrict__ m, bool entering, int lobe_mask) {
  Bsdf b;
  b.base_color = v3(m[M_BASE_COLOR], m[M_BASE_COLOR + 1], m[M_BASE_COLOR + 2]);
  b.rough = m[M_DIFFUSE_ROUGHNESS];
  float coat = jclip(m[M_COAT], 0.0f, 1.0f);
  V3 cc = v3(m[M_COAT_COLOR], m[M_COAT_COLOR + 1], m[M_COAT_COLOR + 2]);
  float trans = m[M_TRANSMISSION];
  float ss = m[M_SUBSURFACE];
  float thin = m[M_THIN_WALLED];
  // reflective lobes are off when shading from inside (bsdf.cu:56-62)
  float coat_g = entering ? coat : 0.0f;
  float metal_g = entering ? m[M_METALNESS] : 0.0f;
  float spec_g = entering ? m[M_SPECULAR] : 0.0f;
  float sheen_g = entering ? m[M_SHEEN] : 0.0f;
  b.diffuse_g = entering ? m[M_DIFFUSE] : 0.0f;
  // coat absorption uses the ungated coat weight (bsdf.cu:27-30 quirk)
  V3 ca = v3(1.0f + (cc.x - 1.0f) * coat, 1.0f + (cc.y - 1.0f) * coat, 1.0f + (cc.z - 1.0f) * coat);
  // coat / specular / sheen albedos are 0: those lobes are not in this kernel
  float c = coat_g * 0.0f;
  float s = spec_g * 0.0f;
  float sh = sheen_g * 0.0f;
  float w[7];
  w[0] = c;
  w[1] = (1.0f - c) * metal_g;
  w[2] = (1.0f - c) * (1.0f - metal_g) * s;
  w[3] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * trans;
  w[4] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * sh;
  w[5] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * ss * thin;
  w[6] = (1.0f - c) * (1.0f - metal_g) * (1.0f - s) * (1.0f - trans) * (1.0f - sh) * (1.0f - ss) *
         b.diffuse_g;
  float total = w[0] + w[1] + w[2] + w[3] + w[4] + w[5] + w[6];
  float inv_total = 1.0f / (total > 0.0f ? total : 1.0f);
  for (int k = 0; k < 7; ++k) b.pmf[k] = w[k] * inv_total;
  // layer chain of eval/sample down to the diffuse_r lobe; the specular
  // and sheen attenuations are 1 - x * 0 == 1 exactly
  V3 f = ca * (1.0f - metal_g);
  f = f * (1.0f - trans);
  f = f * (1.0f - ss);
  b.fmul_d = f * b.diffuse_g;
  b.diffuse_on = (lobe_mask & LOBE_DIFFUSE_R) != 0;
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

// cbsdf.eval
__device__ __forceinline__ V3 bsdf_eval(const Bsdf& b, V3 wo, V3 wi) {
  if (!b.diffuse_on) return zero3();
  V3 dr = zero3();
  if (b.diffuse_g > 0.0f) dr = san3(b.base_color * oren_nayar_scalar(b.rough, wo, wi));
  return b.fmul_d * dr;
}
// cbsdf.eval_pdf
__device__ __forceinline__ float bsdf_pdf(const Bsdf& b, V3 wo, V3 wi) {
  if (!b.diffuse_on) return 0.0f;
  float p = b.diffuse_g > 0.0f ? san(fabsf(wi.y) * F_INV_PI) : 0.0f;
  return b.pmf[6] * p;
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
  if (idx == 6 && b.diffuse_on) {
    wi = cosine_hemisphere(v0, v1);
    f = (b.base_color * oren_nayar_scalar(b.rough, wo, wi)) * b.fmul_d;
    p = fabsf(wi.y) * F_INV_PI;
  }
  f = san3(f);
  pdf = san(p * pmf_sel);
}
