// K3, shade-advance (replaces the Pallas kernel _shade_advance_kernel with
// _inclusive_rank, _sun_sky and _raygen, raytracer_project_tpu/ops/
// fused_step.py:669, :571, :591, :633; as K3 fused also K2's
// _decode_kernel, :326, and the step's scatter into the accumulator,
// :1398-1420).
//
// Per lane: background (sun-sky, solid or HDR texel), bump-mapped normal,
// the branchless Lambertian / metal / dielectric / isotropic / emissive
// scatter, the radiance and throughput update, the weak-ray cutoff and
// Russian roulette, the finished-path target, and respawn of free lanes
// from the global work counter with the camera ray regenerated in the
// kernel. The texel, bump-delta and HDR rows are direct loads here (the
// reference gathers them between its kernels).
//
// Three features are compile-time variants, shade_kernel<SPEC, AOVS, FOG,
// FUSED>, so that the beauty variant <false, false, false, *> carries none
// of them:
//   FOG   solid-albedo fog: per volume row of vparams (f32[V, 16], read by
//         every lane through the read-only cache) the boundary span clamped
//         by the surface hit and an exponential free flight; a scatter
//         overrides the hit with the volume's isotropic phase material
//         (reference :772-845). logf is the card's, within an ulp of the
//         plain version's log: a lane whose flight sits on its span's end
//         may flip, which the tests budget.
//   AOVS  albedo / normal / z-depth of bounce-0 beauty lanes whose absolute
//         sample id is below aux (:965-996); aov_mask picks the buffers.
//   SPEC  the reflection/refraction split passes as spec lanes: state rows
//         is_spec, to_refl, to_refr and attn0; no first-hit emission or
//         attenuation on a spec lane, the routing at its first hit, the
//         firefly-clamped contributions (:921-963, :1003-1016), and work
//         ids from n_beauty on respawning as spec lanes (:1031-1078).
// Pixel windows: lane pixel ids stay global (RNG streams and the camera
// decode do not change), n_pixels is the window's size, a respawned slot s
// becomes pixel s + pixel_offset, and targets are li - pixel_offset
// (reference :564-567, :971, :1001-1012, :1041). Full frames pass 0.
// FUSED picks what the kernel reads and what it hands on:
//   false  the unfused K3, kept as the yardstick of K3 fused and for the
//          plain step's parity tests: it reads K2's [24, P] record rows and
//          writes [k, P] rows that a caller adds with one index_add_:
//          contrib (beauty 3, the enabled AOV values, reflection 3,
//          refraction 3) and tgt (beauty, AOV, reflection, refraction
//          targets, n_pixels for a lane that finished nothing);
//          fused_step.acc_channels names them.
//   true   K3 fused, the main path's step: it reads K1's closest hit (t,
//          idx, type) and decodes it in registers (decode_lane,
//          csrc/decode.cuh), so no record rows exist, and adds what a
//          lane finishes straight into the flat accumulator acc
//          (f32[channels * (n_pixels + 1)], channel c at c * stride, in
//          acc_channels' order) with one atomicAdd per channel. A lane that
//          finishes nothing adds nothing: the reference ran one wide
//          scatter outside its kernel because XLA's scatter staging cost
//          ~2 ms per scatter on the TPU, and on an H100 that scatter
//          (index_add_ with every idle lane on one dummy address per
//          channel) took more device time than K2 and K3 together.
//          The sums within a step land in no fixed order, so a pixel that
//          two lanes finish in one step is summed in either order.
//
// The respawn needs, for each free lane, the number of free lanes before
// it in lane order. The reference carries that count across a grid that
// runs in order on the TPU; CUDA blocks run in no order, so the step is two
// launches with a deterministic scan and no atomics:
//   shade_kernel    shades every lane, writes the advanced state, and each
//                   block's counts of free, live and still-active lanes;
//   respawn_kernel  each block sums the free counts of the blocks before
//                   it, ranks its free lanes with warp ballots, and gives
//                   the lane of rank r the work id next_work + r - 1 while
//                   that is below total_work; block 0 writes next_work,
//                   the segment count (int64) and the live count, and
//                   for K3 fused adds 1 to the step count (int64, in
//                   place) when the step began with live lanes.
//
// Bound on the H100: bytes. The unfused beauty variant reads 24 record
// rows, 16 state rows and up to 6 texel words and writes 16 state rows, 3
// contributions and a target: about 272 B/lane at 3.35 TB/s, and K2 moved
// another 132 B/lane to make its records (404 B/lane in all). The variant
// with every feature moves 22 state rows each way and writes 16
// contributions and 4 targets: about 376 B/lane. K3 fused, each input byte
// counted once: 16 state rows in and out (128 B), t, idx and type (12 B),
// the scene tables once per launch, and 4 B per atomicAdd issued, 12 B per
// finished beauty lane: about 140-152 B/lane in beauty; with every feature
// 22 state rows each way (176 B), 12 B of hits and 4 B for each of up to
// 18 channels a lane adds to.

#include <stdint.h>

#include "decode.cuh"

#define BLOCK 256
#define NWARP (BLOCK / 32)
enum {
  BP_CENTER = 0, BP_P00 = 3, BP_DU = 6, BP_DV = 9, BP_DDU = 12, BP_DDV = 15,
  BP_SUN_DIR = 18, BP_SUN_COL = 21, BP_SUN_INT = 24, BP_SUN_SIZE = 25,
  BP_INTENSITY = 26, BP_BG = 27,
};
enum { PHYSICAL_SUN = 0, HDR_MAP = 1, SOLID_COLOR = 2 };
enum { STREAM_CAMERA = 0, STREAM_SCATTER = 1, STREAM_RR = 2, STREAM_VOLUME = 3 };
enum { VP_KIND = 0, VP_CENTER = 1, VP_RADIUS = 4, VP_BMIN = 5, VP_BMAX = 8,
       VP_NID = 11, VP_ALBEDO = 12, VP_COLS = 16 };
enum { BP_CAM_U = 30 };  // camera right, up, backward at 30, 33, 36
enum { AOV_ALBEDO = 1, AOV_NORMAL = 2, AOV_Z = 4 };

#define RAY_EPSILON 1e-4f
#define WEAK_RAY_EPS 1e-4f
#define RR_START_BOUNCE 10
#define RR_P_MIN 0.05f
#define RR_P_MAX 0.95f
#define T_MIN_F 1e-3f
#define SALT_MUL 0x85EBCA6Bu

// --- counter-hash lane RNG (core/rng.py) ------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

struct Bits4 {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ Bits4 bits4(uint32_t seed, uint32_t pix,
                                       uint32_t samp, uint32_t ctx,
                                       int stream) {
  uint32_t a = pix ^ 0x9E3779B9u;
  uint32_t b = samp + 0x85EBCA6Bu;
  uint32_t c = (ctx * 16u + (uint32_t)stream) ^ 0xC2B2AE35u;
  uint32_t d = seed + 0x27D4EB2Fu;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a += b; d = rotl(d ^ a, 16);
    c += d; b = rotl(b ^ c, 12);
    a += b; d = rotl(d ^ a, 8);
    c += d; b = rotl(b ^ c, 7);
  }
  return Bits4{a, b, c, d};
}

__device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// v - 2 (v.n) n (core/soa.reflect)
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  float dd2 = 2.0f * dot(v, n);
  return v3(v.x - dd2 * n.x, v.y - dd2 * n.y, v.z - dd2 * n.z);
}

// --- sky and camera ---------------------------------------------------------

__device__ V3 sun_sky(const float* bp, V3 ud) {
  float sdx = bp[BP_SUN_DIR], sdy = bp[BP_SUN_DIR + 1], sdz = bp[BP_SUN_DIR + 2];
  float sun_height = sdy;
  float adjusted = sun_height - 0.05f;
  float sky_exposure = clampf(adjusted * 8.0f + 1.4f, 0.0f, 1.0f);
  float day_factor = clampf(adjusted * 10.0f + 1.1f, 0.0f, 1.0f);
  float sunset_i = clampf(1.0f - fabsf(adjusted + 0.05f) * 30.0f, 0.0f, 1.0f);
  float sunset = adjusted > -0.1f ? sunset_i : 0.0f;
  sunset = sun_height < 0.0f ? sunset * (sun_height * 10.0f + 1.0f) : sunset;
  sunset = clampf(sunset, 0.0f, 1.0f);
  const float zen[3] = {0.01f, 0.03f, 0.1f};
  const float zday[3] = {0.2f, 0.5f, 1.0f};
  const float hor[3] = {0.05f, 0.02f, 0.01f};
  const float hday[3] = {0.6f, 0.8f, 1.0f};
  const float hsun[3] = {1.0f, 0.35f, 0.1f};
  const float scol_sunset[3] = {1.0f, 0.3f, 0.1f};
  float visibility = clampf(sun_height * 5.0f + 1.0f, 0.0f, 1.0f);
  float threshold = 1.0f - bp[BP_SUN_SIZE] * 0.001f;
  float sun_focus = ud.x * sdx + ud.y * sdy + ud.z * sdz;
  float e1 = threshold + 0.0002f;
  float st = clampf((sun_focus - threshold) / (e1 - threshold), 0.0f, 1.0f);
  float alpha = st * st * (3.0f - 2.0f * st);
  bool disc_on = sun_focus > threshold && adjusted > -0.1f;
  bool up = ud.y > 0.0f;
  float gain = bp[BP_INTENSITY] * 1.5f * sky_exposure;
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float zenith = zen[k] * (1.0f - day_factor) + zday[k] * day_factor;
    float horizon = hor[k] * (1.0f - day_factor) + hday[k] * day_factor;
    horizon = horizon * (1.0f - sunset) + hsun[k] * sunset;
    float sky = up ? (1.0f - ud.y) * horizon + ud.y * zenith : horizon * 0.1f;
    float s_col = bp[BP_SUN_COL + k] * (1.0f - sunset) + scol_sunset[k] * sunset;
    float disc = disc_on ? s_col * bp[BP_SUN_INT] * visibility * alpha : 0.0f;
    out[k] = sky * gain + disc;
  }
  return v3(out[0], out[1], out[2]);
}

// Camera ray of (pixel, sample), context 0 (camera.hpp:784-794).
__device__ void raygen(const float* bp, uint32_t seed, int pix, int samp,
                       int width, float inv_w, V3& o, V3& d) {
  Bits4 h = bits4(seed, (uint32_t)pix, (uint32_t)samp, 0u, STREAM_CAMERA);
  float off_x = u01(h.a) - 0.5f;
  float off_y = u01(h.b) - 0.5f;
  float disk_r = sqrtf(u01(h.c));
  float disk_t = TWO_PI_F * u01(h.d);
  float r0 = disk_r * cosf(disk_t);
  float r1 = disk_r * sinf(disk_t);
  float w = (float)width;
  float pf = (float)pix;
  float jj = floorf((pf + 0.5f) * inv_w);
  float ii = pf - jj * w;
  jj = ii < 0.0f ? jj - 1.0f : (ii >= w ? jj + 1.0f : jj);
  ii = pf - jj * w;
  float px = ii + off_x;
  float py = jj + off_y;
  float oc[3], dc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    oc[k] = bp[BP_CENTER + k] + r0 * bp[BP_DDU + k] + r1 * bp[BP_DDV + k];
    dc[k] = bp[BP_P00 + k] + px * bp[BP_DU + k] + py * bp[BP_DV + k] - oc[k];
  }
  o = v3(oc[0], oc[1], oc[2]);
  d = v3(dc[0], dc[1], dc[2]);
}

// --- launch 1: shade and advance ---------------------------------------------

// What K3 fused reads besides K3's inputs, and the accumulator it adds to.
struct FusedArgs {
  DecodeTables tb;
  const float* t;    // K1's closest hits
  const int* idx;
  const int* typ;
  float* acc;        // f32[channels * stride]: channel c at c * stride
  int stride;        // n_pixels + 1
};

// The record of lane i from K2's [24, P] rows (the unfused K3).
__device__ __forceinline__ Hit load_record(const float* __restrict__ rec,
                                           int p, int i) {
  const float* R = rec + i;
  Hit h;
  h.hit = R[RO_HIT * p] > 0.5f;
  h.t = R[RO_T * p];
  h.normal = v3(R[RO_N * p], R[(RO_N + 1) * p], R[(RO_N + 2) * p]);
  h.tangent = v3(R[RO_TAN * p], R[(RO_TAN + 1) * p], R[(RO_TAN + 2) * p]);
  h.bitangent = v3(R[RO_BIT * p], R[(RO_BIT + 1) * p], R[(RO_BIT + 2) * p]);
  h.front = R[RO_FRONT * p] > 0.5f;
  h.mtype = R[RO_MTYPE * p];
  h.param = R[RO_PARAM * p];
  h.bstr = R[RO_BSTR * p];
#pragma unroll
  for (int c = 0; c < 3; ++c) h.base[c] = R[(RO_BASE + c) * p];
  h.gate_u = R[RO_GU * p];
  h.gate_v = R[RO_GV * p];
  h.has_bump = R[RO_HASB * p] > 0.5f;
  h.texrow = R[RO_TEXROW * p];
  h.bumprow = R[RO_BUMPROW * p];
  h.envrow = 0.0f;  // read where the HDR background needs it
  return h;
}

template <bool SPEC, bool AOVS, bool FOG, bool FUSED>
__global__ void shade_kernel(
    const float* __restrict__ rec, const float* __restrict__ sf,
    const int* __restrict__ si, int p, const float* __restrict__ bp,
    const float* __restrict__ atlas_rows, const float* __restrict__ grad_rows,
    const float* __restrict__ env_rows, const float* __restrict__ vparams,
    uint32_t seed, int pixel_offset, int n_pixels, int max_depth,
    int env_mode, int aux, float z_max, int aov_mask, int use_reflection,
    int use_refraction, int n_volumes, float* __restrict__ out_f,
    int* __restrict__ out_i,
    float* __restrict__ contrib, int* __restrict__ tgt,
    int* __restrict__ counts, FusedArgs fa) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool in = i < p;
  bool live = false, free_lane = false, still = false;
  if (in) {
    V3 o = v3(sf[i], sf[p + i], sf[2 * p + i]);
    V3 d = v3(sf[3 * p + i], sf[4 * p + i], sf[5 * p + i]);
    Hit h;
    if constexpr (FUSED) {
      h = decode_lane(o, d, fa.t[i], fa.idx[i], fa.typ[i], fa.tb);
    } else {
      h = load_record(rec, p, i);
    }
    bool hit = h.hit;
    float t_hit = h.t;
    V3 normal = h.normal, tangent = h.tangent, bitangent = h.bitangent;
    bool front = h.front;
    float mtype = h.mtype, param = h.param, bstr = h.bstr;
    V3 base_col = v3(h.base[0], h.base[1], h.base[2]);
    float gate_u = h.gate_u, gate_v = h.gate_v;
    float texrow = h.texrow;

    int trow = (int)fmaxf(texrow, 0.0f);
    int brow = (int)fmaxf(h.bumprow, 0.0f);
    float4 tex4 = __ldg(reinterpret_cast<const float4*>(atlas_rows) + trow);
    float2 gb2 = __ldg(reinterpret_cast<const float2*>(grad_rows) + brow);
    bool is_image_lane = texrow >= -0.5f;
    V3 tex3 = is_image_lane ? v3(tex4.x, tex4.y, tex4.z) : base_col;

    V3 thr = v3(sf[6 * p + i], sf[7 * p + i], sf[8 * p + i]);
    V3 rad = v3(sf[9 * p + i], sf[10 * p + i], sf[11 * p + i]);
    live = si[i] > 0;
    int bounce = si[p + i], samp = si[2 * p + i], li = si[3 * p + i];
    bool is_spec = false, to_refl = false, to_refr = false;
    V3 attn0 = v3(1.0f, 1.0f, 1.0f);
    uint32_t spec_bit = 0u;
    if (SPEC) {
      spec_bit = (uint32_t)si[4 * p + i];
      is_spec = si[4 * p + i] > 0;
      to_refl = si[5 * p + i] > 0;
      to_refr = si[6 * p + i] > 0;
      attn0 = v3(sf[12 * p + i], sf[13 * p + i], sf[14 * p + i]);
    }
    uint32_t ctx = (((uint32_t)bounce) << 1) | spec_bit;

    if (FOG) {
      float best_vt = hit ? t_hit : T_MAX_F;
      bool vol_take = false;
      V3 valb = v3(0.0f, 0.0f, 0.0f);
      float dd_v = d.x * d.x + d.y * d.y + d.z * d.z;
      float ray_len = sqrtf(dd_v);
      for (int v = 0; v < n_volumes; ++v) {
        const float* vp = vparams + v * VP_COLS;
        float entry, exit_;
        bool bhit;
        if (__ldg(vp + VP_KIND) < 0.5f) {
          float radius = __ldg(vp + VP_RADIUS);
          V3 oc = v3(__ldg(vp + VP_CENTER) - o.x, __ldg(vp + VP_CENTER + 1) - o.y,
                     __ldg(vp + VP_CENTER + 2) - o.z);
          float h_v = d.x * oc.x + d.y * oc.y + d.z * oc.z;
          float c_v = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z - radius * radius;
          float disc = h_v * h_v - dd_v * c_v;
          float sq = sqrtf(fmaxf(disc, 0.0f));
          entry = (h_v - sq) / dd_v;
          exit_ = (h_v + sq) / dd_v;
          bhit = disc > 0.0f && radius > 0.0f;
        } else {
          const float dv[3] = {d.x, d.y, d.z};
          const float ov[3] = {o.x, o.y, o.z};
          float tn[3], tf[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float dk = fabsf(dv[k]) < 1e-20f ? (dv[k] < 0.0f ? -1e-20f : 1e-20f)
                                             : dv[k];
            float inv = 1.0f / dk;
            float t0 = (__ldg(vp + VP_BMIN + k) - ov[k]) * inv;
            float t1 = (__ldg(vp + VP_BMAX + k) - ov[k]) * inv;
            tn[k] = fminf(t0, t1);
            tf[k] = fmaxf(t0, t1);
          }
          entry = fmaxf(fmaxf(tn[0], tn[1]), tn[2]);
          exit_ = fminf(fminf(tf[0], tf[1]), tf[2]);
          bhit = entry < exit_;
        }
        float e_v = fmaxf(entry, T_MIN_F);
        float x_v = fminf(exit_, best_vt);
        bool valid = bhit && e_v < x_v;
        uint32_t vseed = seed + (uint32_t)(v + 1) * SALT_MUL;
        float u_v = u01(bits4(vseed, (uint32_t)li, (uint32_t)samp, ctx,
                              STREAM_VOLUME).a);
        float flight = __ldg(vp + VP_NID) * logf(fmaxf(u_v, 1e-38f));
        bool scatters = valid && flight <= (x_v - e_v) * ray_len;
        float t_v = e_v + flight / fmaxf(ray_len, 1e-20f);
        if (scatters && t_v < best_vt) {
          best_vt = t_v;
          valb = v3(__ldg(vp + VP_ALBEDO), __ldg(vp + VP_ALBEDO + 1),
                    __ldg(vp + VP_ALBEDO + 2));
          vol_take = true;
        }
      }
      if (vol_take) {
        hit = true;
        t_hit = best_vt;
        mtype = 4.0f;  // ISOTROPIC
        tex3 = valb;
        normal = v3(1.0f, 0.0f, 0.0f);
        front = true;
      }
    }

    float t_safe = hit ? t_hit : 1.0f;
    V3 hp = v3(t_safe * d.x + o.x, t_safe * d.y + o.y, t_safe * d.z + o.z);

    V3 ud = normalize(d);
    V3 bg;
    if (env_mode == PHYSICAL_SUN) {
      bg = sun_sky(bp, ud);
    } else if (env_mode == SOLID_COLOR) {
      float s = bp[BP_INTENSITY];
      bg = v3(bp[BP_BG] * s * 1.0f, bp[BP_BG + 1] * s * 1.0f, bp[BP_BG + 2] * s * 1.0f);
    } else {
      float envrow = FUSED ? h.envrow : rec[RO_ENVROW * p + i];
      float4 e4 = __ldg(reinterpret_cast<const float4*>(env_rows) +
                        (int)envrow);
      float s = bp[BP_INTENSITY];
      bg = v3(e4.x * s, e4.y * s, e4.z * s);
    }

    Bits4 hs = bits4(seed, (uint32_t)li, (uint32_t)samp, ctx, STREAM_SCATTER);
    float z = 1.0f - 2.0f * u01(hs.a);
    float phi = TWO_PI_F * u01(hs.b);
    float rr = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    V3 sphere_draw = v3(rr * cosf(phi), rr * sinf(phi), z);
    float choice_u = u01(hs.c);

    float f_u = gb2.x * gate_u * bstr;
    float f_v = gb2.y * gate_v * bstr;
    V3 n_b = v3(normal.x - f_u * tangent.x - f_v * bitangent.x,
                normal.y - f_u * tangent.y - f_v * bitangent.y,
                normal.z - f_u * tangent.z - f_v * bitangent.z);
    bool has_bump = h.has_bump;
    V3 working_n = has_bump ? normalize(n_b) : normal;
    V3 unit_in = normalize(d);

    V3 lam_dir = add(working_n, sphere_draw);
    bool nz = fabsf(lam_dir.x) < 1e-8f && fabsf(lam_dir.y) < 1e-8f &&
              fabsf(lam_dir.z) < 1e-8f;
    lam_dir = nz ? working_n : lam_dir;
    V3 eps_origin = axpy(RAY_EPSILON, normal, hp);

    V3 reflected = reflect(unit_in, working_n);
    V3 metal_dir = normalize(axpy(param, sphere_draw, reflected));
    bool metal_ok = dot(metal_dir, normal) > 0.0f;

    float ri = front ? 1.0f / fmaxf(param, 1e-6f) : param;
    float cos_theta = fminf(dot(neg(unit_in), working_n), 1.0f);
    float sin_theta = safe_sqrt(1.0f - cos_theta * cos_theta);
    bool cannot_refract = ri * sin_theta > 1.0f;
    float r0 = (1.0f - ri) / (1.0f + ri);
    float r0s = r0 * r0;
    float c1 = 1.0f - cos_theta;
    float c2 = c1 * c1;
    float reflect_prob = r0s + (1.0f - r0s) * (c1 * (c2 * c2));
    bool do_reflect = cannot_refract || reflect_prob > choice_u;
    // refract(unit_in, working_n, ri) (vec3.hpp:209-213)
    float cos_r = fminf(dot(neg(unit_in), working_n), 1.0f);
    V3 perp = scale(add(unit_in, scale(working_n, cos_r)), ri);
    float par_len = -sqrtf(fabsf(1.0f - dot(perp, perp)));
    V3 refracted = add(perp, scale(working_n, par_len));
    V3 diel_dir = do_reflect ? reflected : refracted;
    bool offset_out = dot(diel_dir, normal) > 0.0f;
    V3 diel_origin = axpy(offset_out ? RAY_EPSILON : -RAY_EPSILON, normal, hp);

    bool is_lam = mtype == 0.0f, is_metal = mtype == 1.0f;
    bool is_diel = mtype == 2.0f, is_emit = mtype == 3.0f;
    bool is_iso = mtype == 4.0f;
    V3 sc_dir = is_lam ? lam_dir : (is_metal ? metal_dir : (is_diel ? diel_dir : sphere_draw));
    V3 sc_origin = (is_lam || is_metal) ? eps_origin : (is_diel ? diel_origin : hp);
    V3 attenuation = tex3;
    bool scattered = is_lam || (is_metal && metal_ok) || is_diel || is_iso;
    V3 emitted = is_emit ? tex3 : v3(0.0f, 0.0f, 0.0f);

    // A spec lane skips its first hit's emission and attenuation.
    bool at0 = bounce == 0;
    bool emit_ok = !(at0 && is_spec);
    bool miss = live && !hit;
    rad = v3(rad.x + (miss ? thr.x * bg.x : 0.0f), rad.y + (miss ? thr.y * bg.y : 0.0f),
             rad.z + (miss ? thr.z * bg.z : 0.0f));
    bool active = live && hit;
    bool emit_lane = active && emit_ok;
    rad = v3(rad.x + (emit_lane ? thr.x * emitted.x : 0.0f),
             rad.y + (emit_lane ? thr.y * emitted.y : 0.0f),
             rad.z + (emit_lane ? thr.z * emitted.z : 0.0f));
    thr = (active && scattered && emit_ok) ? mul(thr, attenuation) : thr;
    active = active && scattered;

    bool late = (bounce - 1) > RR_START_BOUNCE;
    bool weak = late && sqrtf(dot(thr, thr)) < WEAK_RAY_EPS;
    active = active && !weak;
    float p_rr = clampf(fmaxf(thr.x, fmaxf(thr.y, thr.z)), RR_P_MIN, RR_P_MAX);
    float u_rr = u01(bits4(seed, (uint32_t)li, (uint32_t)samp, ctx, STREAM_RR).a);
    active = active && !(late && u_rr > p_rr);
    thr = (late && active) ? scale(thr, 1.0f / p_rr) : thr;
    active = active && (bounce + 1 < max_depth);

    // Spec-pass routing at the first hit (camera.hpp:492-517).
    if (SPEC) {
      bool spec0 = at0 && is_spec && live;
      V3 refl_dir = reflect(normalize(d), normalize(normal));
      bool is_specular = dot(normalize(sc_dir), refl_dir) > 0.9f;
      bool entering = dot(sc_dir, normal) < 0.0f;
      bool spec_live = hit && scattered;
      if (spec0) {
        to_refl = use_reflection && spec_live && is_specular;
        to_refr = use_refraction && spec_live && !is_specular && entering;
        attn0 = attenuation;
      }
      active = active && !(spec0 && !(to_refl || to_refr));
    }

    bool done = live && !active;
    bool done_beauty = done && !is_spec;
    // li is the global pixel id; the accumulator holds the window.
    int slot = li - pixel_offset;
    // K3 fused adds a finished lane's values to channel ch + k of its
    // pixel; the unfused K3 writes contribution row crow + k and target
    // row trow_out (the dummy slot n_pixels for a lane that finished
    // nothing).
    int ch = 3, crow = 3, trow_out = 1;
    if constexpr (FUSED) {
      if (done_beauty) {
        atomicAdd(fa.acc + slot, rad.x);
        atomicAdd(fa.acc + fa.stride + slot, rad.y);
        atomicAdd(fa.acc + 2 * fa.stride + slot, rad.z);
      }
    } else {
      tgt[i] = done_beauty ? slot : n_pixels;
      contrib[i] = done_beauty ? rad.x : 0.0f;
      contrib[p + i] = done_beauty ? rad.y : 0.0f;
      contrib[2 * p + i] = done_beauty ? rad.z : 0.0f;
    }

    // AOVs of bounce-0 beauty lanes within the aux budget.
    if (AOVS) {
      bool is_aux = live && at0 && samp < aux && !is_spec;
      if constexpr (!FUSED) tgt[p + i] = is_aux ? slot : n_pixels;
      trow_out = 2;
      // One AOV value: added to `reps` channels (z-depth fills three with
      // its one value), or written as one contribution row.
      auto emit = [&](float v, int reps) {
        if constexpr (FUSED) {
          for (int r = 0; r < reps; ++r, ++ch)
            if (is_aux) atomicAdd(fa.acc + ch * fa.stride + slot, v);
        } else {
          contrib[(crow++) * p + i] = v;
        }
      };
      if (aov_mask & AOV_ALBEDO) {
        const float tc[3] = {tex3.x, tex3.y, tex3.z};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float alb = is_diel ? 1.0f : tc[k];
          alb = is_emit ? fminf(tc[k], 1.0f) : alb;
          alb = is_iso ? 0.0f : alb;
          emit((is_aux && hit) ? alb : 0.0f, 1);
        }
      }
      if (aov_mask & AOV_NORMAL) {
        V3 nn = normalize(normal);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* axis = bp + BP_CAM_U + 3 * k;
          float c = nn.x * axis[0] + nn.y * axis[1] + nn.z * axis[2];
          c = (c + 1.0f) * 0.5f;
          float miss_c = k < 2 ? 0.5f : 1.0f;
          emit(is_aux ? (hit ? c : miss_c) : 0.0f, 1);
        }
      }
      if (aov_mask & AOV_Z) {
        float zval = 1.0f - clampf(t_hit / z_max, 0.0f, 1.0f);
        emit((is_aux && hit) ? zval : 0.0f, 3);
      }
    }

    // Finished spec paths: firefly clamp on |radiance|, then the first-hit
    // attenuation (camera.hpp:499-509).
    if (SPEC) {
      float luma = 0.2126f * sqrtf(dot(rad, rad));
      float fscale = luma > 2.0f ? 2.0f / fmaxf(luma, 1e-12f) : 1.0f;
      const float sc[3] = {attn0.x * rad.x * fscale, attn0.y * rad.y * fscale,
                           attn0.z * rad.z * fscale};
      bool d_refl = done && to_refl, d_refr = done && to_refr;
      if constexpr (FUSED) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (d_refl) atomicAdd(fa.acc + (ch + k) * fa.stride + slot, sc[k]);
          if (d_refr) atomicAdd(fa.acc + (ch + 3 + k) * fa.stride + slot, sc[k]);
        }
      } else {
        tgt[trow_out * p + i] = d_refl ? slot : n_pixels;
        tgt[(trow_out + 1) * p + i] = d_refr ? slot : n_pixels;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          contrib[(crow + k) * p + i] = d_refl ? sc[k] : 0.0f;
          contrib[(crow + 3 + k) * p + i] = d_refr ? sc[k] : 0.0f;
        }
      }
    }

    V3 no = active ? sc_origin : o;
    V3 nd = active ? sc_dir : d;
    const float vals[12] = {no.x, no.y, no.z, nd.x, nd.y, nd.z,
                            thr.x, thr.y, thr.z, rad.x, rad.y, rad.z};
#pragma unroll
    for (int k = 0; k < 12; ++k) out_f[k * p + i] = vals[k];
    still = live && active;
    out_i[i] = still ? 1 : 0;
    out_i[p + i] = bounce + 1;
    out_i[2 * p + i] = samp;
    out_i[3 * p + i] = li;
    if (SPEC) {
      out_f[12 * p + i] = attn0.x;
      out_f[13 * p + i] = attn0.y;
      out_f[14 * p + i] = attn0.z;
      out_i[4 * p + i] = is_spec ? 1 : 0;
      out_i[5 * p + i] = to_refl ? 1 : 0;
      out_i[6 * p + i] = to_refr ? 1 : 0;
    }
    free_lane = !still;
  }
  int n_free = __syncthreads_count(free_lane);
  int n_live = __syncthreads_count(live);
  int n_still = __syncthreads_count(still);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = n_free;
    counts[gridDim.x + blockIdx.x] = n_live;
    counts[2 * gridDim.x + blockIdx.x] = n_still;
  }
}

// --- launch 2: respawn --------------------------------------------------------

__device__ long long block_sum(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < NWARP; ++w) s += red[w];
  return s;
}

template <bool SPEC>
__global__ void respawn_kernel(
    int p, const float* __restrict__ bp, uint32_t seed, int sample_offset,
    int pixel_offset, int n_pixels, float inv_n, int width, float inv_w,
    int total_work,
    int n_beauty, const int* __restrict__ next_work_in,
    const long long* __restrict__ seg_in, const int* __restrict__ counts,
    float* __restrict__ out_f, int* __restrict__ out_i,
    int* __restrict__ next_out, long long* __restrict__ seg_out,
    int* __restrict__ live_count, long long* __restrict__ steps) {
  __shared__ long long red[NWARP];
  __shared__ int warp_free[NWARP];
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const long long next_work = next_work_in[0];

  // Free lanes in the blocks before this one.
  long long before = 0;
  for (int j = threadIdx.x; j < b; j += BLOCK) before += counts[j];
  before = block_sum(before, red);

  if (b == 0) {
    long long tf = 0, tl = 0, ts = 0;
    for (int j = threadIdx.x; j < nb; j += BLOCK) {
      tf += counts[j];
      tl += counts[nb + j];
      ts += counts[2 * nb + j];
    }
    tf = block_sum(tf, red);
    tl = block_sum(tl, red);
    ts = block_sum(ts, red);
    if (threadIdx.x == 0) {
      long long room = (long long)total_work - next_work;
      long long spawned = room < 0 ? 0 : (room < tf ? room : tf);
      long long nw = next_work + tf;
      next_out[0] = (int)(nw < total_work ? nw : total_work);
      seg_out[0] = seg_in[0] + tl;
      live_count[0] = (int)(ts + spawned);
      // K3 fused counts the steps that began with live lanes in place.
      if (steps != nullptr && tl > 0) steps[0] += 1;
    }
  }

  int i = b * BLOCK + threadIdx.x;
  bool free_lane = i < p && out_i[i] == 0;
  // Inclusive rank of this lane among the block's free lanes.
  unsigned ballot = __ballot_sync(0xffffffffu, free_lane);
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_free[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & (0xffffffffu >> (31 - lane)));
  for (int w = 0; w < warp; ++w) rank += warp_free[w];
  if (!free_lane) return;
  long long new_w = next_work + before + rank - 1;
  if (new_w >= total_work) return;
  // Work ids from n_beauty on are the spec lanes of the same samples.
  bool new_spec = SPEC && new_w >= n_beauty;
  if (new_spec) new_w -= n_beauty;

  // Work id -> (pixel, sample), in f32 as the reference decodes it (exact
  // below 2^24).
  float wf = (float)new_w;
  float n = (float)n_pixels;
  float sr = floorf((wf + 0.5f) * inv_n);
  float sli = wf - sr * n;
  sr = sli < 0.0f ? sr - 1.0f : (sli >= n ? sr + 1.0f : sr);
  sli = wf - sr * n;
  // The window's slot -> the global pixel id (RNG streams and raygen).
  int new_li = (int)sli + pixel_offset;
  int new_samp = sample_offset + (int)sr;
  V3 o, d;
  raygen(bp, seed, new_li, new_samp, width, inv_w, o, d);
  const float vals[12] = {o.x, o.y, o.z, d.x, d.y, d.z,
                          1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 12; ++k) out_f[k * p + i] = vals[k];
  out_i[i] = 1;
  out_i[p + i] = 0;
  out_i[2 * p + i] = new_samp;
  out_i[3 * p + i] = new_li;
  if (SPEC) {
    out_f[12 * p + i] = 1.0f;
    out_f[13 * p + i] = 1.0f;
    out_f[14 * p + i] = 1.0f;
    out_i[4 * p + i] = new_spec ? 1 : 0;
    out_i[5 * p + i] = 0;
    out_i[6 * p + i] = 0;
  }
}

#define SHADE_ARGS                                                             \
  (const float*)rec, (const float*)state_f, (const int*)state_i, p,          \
      (const float*)bparams, (const float*)atlas_rows,                       \
      (const float*)grad_rows, (const float*)env_rows, (const float*)vparams, \
      seed, pixel_offset, n_pixels, max_depth, env_mode, aux, z_max,         \
      aov_mask, use_reflection, use_refraction, n_volumes, (float*)out_f,    \
      (int*)out_i, (float*)contrib, (int*)tgt, (int*)counts, fa

// Both launches of one step: shade_kernel in the variant the features
// select (FUSED: K3 fused, else the unfused K3 writing contrib and tgt),
// then respawn_kernel. steps may be null.
template <bool FUSED>
static int launch_step(
    const void* rec, const void* state_f, const void* state_i, int p,
    const void* bparams, const void* atlas_rows, const void* grad_rows,
    const void* env_rows, const void* vparams, unsigned int seed,
    int sample_offset, int pixel_offset, int n_pixels, float inv_n, int width,
    float inv_w, int total_work, int max_depth, int env_mode, int aux,
    float z_max, int aov_mask, int use_reflection, int use_refraction,
    int n_beauty, int n_volumes, const void* next_work, const void* segments,
    void* out_f, void* out_i, void* contrib, void* tgt, void* counts,
    void* next_out, void* seg_out, void* live_count, void* steps,
    FusedArgs fa, cudaStream_t s) {
  int grid = (p + BLOCK - 1) / BLOCK;
  if (grid == 0) return (int)cudaErrorInvalidValue;
  bool want_spec = use_reflection || use_refraction;
  switch ((want_spec ? 4 : 0) | (aov_mask ? 2 : 0) | (n_volumes > 0 ? 1 : 0)) {
    case 0: shade_kernel<false, false, false, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 1: shade_kernel<false, false, true, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 2: shade_kernel<false, true, false, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 3: shade_kernel<false, true, true, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 4: shade_kernel<true, false, false, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 5: shade_kernel<true, false, true, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    case 6: shade_kernel<true, true, false, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
    default: shade_kernel<true, true, true, FUSED><<<grid, BLOCK, 0, s>>>(SHADE_ARGS); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (want_spec) {
    respawn_kernel<true><<<grid, BLOCK, 0, s>>>(
        p, (const float*)bparams, seed, sample_offset, pixel_offset, n_pixels,
        inv_n, width,
        inv_w, total_work, n_beauty, (const int*)next_work,
        (const long long*)segments, (const int*)counts, (float*)out_f,
        (int*)out_i, (int*)next_out, (long long*)seg_out, (int*)live_count,
        (long long*)steps);
  } else {
    respawn_kernel<false><<<grid, BLOCK, 0, s>>>(
        p, (const float*)bparams, seed, sample_offset, pixel_offset, n_pixels,
        inv_n, width,
        inv_w, total_work, n_beauty, (const int*)next_work,
        (const long long*)segments, (const int*)counts, (float*)out_f,
        (int*)out_i, (int*)next_out, (long long*)seg_out, (int*)live_count,
        (long long*)steps);
  }
  return (int)cudaGetLastError();
}

// The unfused K3: reads K2's rows, writes contrib and tgt.
extern "C" int shade_advance_launch(
    const void* rec, const void* state_f, const void* state_i, int p,
    const void* bparams, const void* atlas_rows, const void* grad_rows,
    const void* env_rows, const void* vparams, unsigned int seed,
    int sample_offset, int pixel_offset, int n_pixels, float inv_n, int width,
    float inv_w, int total_work, int max_depth, int env_mode, int aux,
    float z_max, int aov_mask, int use_reflection, int use_refraction,
    int n_beauty, int n_volumes, const void* next_work, const void* segments,
    void* out_f, void* out_i, void* contrib, void* tgt, void* counts,
    void* next_out, void* seg_out, void* live_count, void* stream) {
  return launch_step<false>(
      rec, state_f, state_i, p, bparams, atlas_rows, grad_rows, env_rows,
      vparams, seed, sample_offset, pixel_offset, n_pixels, inv_n, width,
      inv_w, total_work, max_depth, env_mode, aux, z_max, aov_mask,
      use_reflection, use_refraction, n_beauty, n_volumes, next_work,
      segments, out_f, out_i, contrib, tgt, counts, next_out, seg_out,
      live_count, nullptr, FusedArgs{}, (cudaStream_t)stream);
}

// K3 fused: decodes K1's hits in registers, adds finished paths into acc
// in place, and adds the step to steps when it began with live lanes.
extern "C" int shade_accumulate_launch(
    const void* t, const void* idx, const void* typ, const void* state_f,
    const void* state_i, int p, const void* bparams, const void* atlas_rows,
    const void* grad_rows, const void* env_rows, const void* vparams,
    unsigned int seed, int sample_offset, int pixel_offset, int n_pixels,
    float inv_n, int width, float inv_w, int total_work, int max_depth,
    int env_mode, int aux, float z_max, int aov_mask, int use_reflection,
    int use_refraction, int n_beauty, int n_volumes, const void* aparams,
    const void* rectab, int n_rec, const void* mattab, int n_mat,
    const void* texmeta, int n_tex, int n_spheres, int n_tris, int has_boxes,
    float ah, float aw, int has_env, float eh, float ew, int stride,
    const void* next_work, const void* segments, void* out_f, void* out_i,
    void* acc, void* counts, void* next_out, void* seg_out, void* live_count,
    void* steps, void* stream) {
  FusedArgs fa{DecodeTables{(const float*)aparams, (const float*)rectab,
                            (const float*)mattab, (const float*)texmeta, n_rec,
                            n_mat, n_tex, n_spheres, n_tris, has_boxes,
                            has_env, ah, aw, eh, ew},
               (const float*)t, (const int*)idx, (const int*)typ,
               (float*)acc, stride};
  return launch_step<true>(
      nullptr, state_f, state_i, p, bparams, atlas_rows, grad_rows, env_rows,
      vparams, seed, sample_offset, pixel_offset, n_pixels, inv_n, width,
      inv_w, total_work, max_depth, env_mode, aux, z_max, aov_mask,
      use_reflection, use_refraction, n_beauty, n_volumes, next_work,
      segments, out_f, out_i, nullptr, nullptr, counts, next_out, seg_out,
      live_count, steps, fa, (cudaStream_t)stream);
}
