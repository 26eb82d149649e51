// One bounce's hair BSDF work on NVIDIA Hopper (sm_90a), in one launch.
//
// hair_kernel gives each lane one thread. The thread builds the lane's
// context in registers (bsdf/hair.py: hair_ctx), evaluates f and the pdf
// towards each of the bounce's K next-event directions (hair_f_ctx,
// hair_f_pdf_ctx), then draws the BSDF sample from the lane's first four
// uniforms (hair_sample_wi) and evaluates f and the pdf there
// (hair_f_pdf_ctx). integrator/path._shade launches it once a bounce on
// gradient-free passes on the card.
//
// No TPU kernel is replaced: the JAX package's yhair_tpu/bsdf/hair.py is
// jnp that XLA fuses into a few loops. In torch every element-wise op is
// one launch and the host issues them one by one: about 210 for the
// context, 545 for f at one direction, 550 for f and the pdf, 95 for the
// sample, so a bounce of the hairball (two point lights) or of the bunny
// (a point light and the env map) made some 1,950 launches, and the
// device idled under them about ten times as long as it worked (PERF.md).
//
// What bounds it on an H100: a lane reads h, wo, its material row, K
// directions and 4 uniforms and writes 4 floats a direction and 7 for the
// sample, about 64 + 28 K bytes; it computes about 760 + 475 K FP32
// element operations as the torch code counts them (200 the context, 85
// the sample, 475 each evaluation). A 65,536-lane strip is then 2-3
// microseconds of either: the launch, the latency of the library
// functions and the IEEE divisions set the time. One thread a lane keeps
// every intermediate in registers, and the K + 1 evaluations, one inlined
// copy in a loop, read the context from there.
//
// Exactness: every operation is the torch op's, in the torch code's order
// (hair_ctx, _shared_terms, fr_dielectric, roughness_to_v, roughness_to_s,
// alpha_terms, _tilted, _ap_pdf, _angles, _lobe_mn, _mp, _log_i0, _i0,
// _np_term, _trimmed_logistic, _f_from_mn, _pdf_from_mn, hair_sample_wi).
// The library's flags (-fmad=false, IEEE division and square root) make
// each product and sum round on its own, as a separate torch launch does.
// Where ATen's CUDA kernels differ from the Python spelling, the code
// follows ATen:
//   x / c (c a Python float) is x * (1.0f / (float)c), the reciprocal
//     rounded once (BinaryDivTrueKernel's CPU-scalar case);
//   c / x is reciprocal(x) * c (Tensor.__rtruediv__), so 1.0 / x is 1 / x;
//   x ** 2 is x * x, x ** 20 and x ** 22 are powf (pow_tensor_scalar);
//   torch.remainder is fmod and a sign fix; torch.sigmoid is
//     1 / (1 + exp(-x));
//   clamp returns a NaN as it is, then max / min;
//   mean over the 3 channels sums (c0 + c2) + c1, the order of ATen's
//     reduction (two lanes a row), and scales by 1.0f / 3;
//   torch.where computes both sides and selects: here only the selected
//     side is computed, which gives the same bits.
// exp, log, sqrt, asin, atan2, sin, cos and pow are the CUDA library's
// accurate functions, as ATen's kernels call them.

#include <cuda_runtime.h>

namespace {

constexpr int HAIR_THREADS = 128;
// a material row: sigma_a (3), beta_m, beta_n, alpha, eta
constexpr int MAT_COLS = 7;

// a Python float as ATen casts it to float32: rounded from the double
__host__ __device__ constexpr float F(double x) {
  return static_cast<float>(x);
}
constexpr double PI = 3.14159265358979323846;  // math.pi
constexpr float PI_F = F(PI);
constexpr float TWO_PI_F = F(6.283185307179586);
constexpr float NEG_LOG_TWO_PI = F(-1.8378770664093453);  // -log(TWO_PI)
constexpr float THIRD = 1.0f / 3.0f;  // ATen's mean factor, 3 per output

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// x / c for a Python float c
__device__ __forceinline__ float div_c(float x, float c) {
  return x * (1.0f / c);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// _safe_sqrt's value
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > F(1e-12) ? sqrtf(clamp_min(x, F(1e-12)))
                      : sqrtf(clamp_min(x, 0.0f));
}

// _safe_asin's value
__device__ __forceinline__ float safe_asin(float x) {
  constexpr float lim = F(1.0 - 1e-6);
  return (x > -lim && x < lim) ? asinf(clamp2(x, -lim, lim))
                               : asinf(clamp2(x, -1.0f, 1.0f));
}

// _i0: pbrt's 10-term series
__device__ __forceinline__ float bessel_i0(float x) {
  const float x2 = x * x;
  float val = 1.0f, term = 1.0f;
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    term = div_c(term * x2, 4.0f * i * i);
    val = val + term;
  }
  return val;
}

__device__ __forceinline__ float log_i0(float x) {
  if (x > 12.0f) {
    const float xs = clamp_min(x, F(1e-30));
    const float inner =
        (logf(1.0f / xs) + NEG_LOG_TWO_PI) + 1.0f / (xs * 8.0f);
    return x + inner * 0.5f;
  }
  return logf(bessel_i0(clamp_max(x, 12.0f)));
}

// _mp: the longitudinal term
__device__ __forceinline__ float mp(float cos_i, float cos_o, float sin_i,
                                    float sin_o, float v) {
  v = clamp_min(v, F(1e-7));
  const float a = (cos_i * cos_o) / v;
  const float b = (sin_i * sin_o) / v;
  if (v <= F(0.1)) {
    float e = log_i0(a) - b;
    e = e - 1.0f / v;
    e = e + F(0.6931);
    e = e + logf(1.0f / (v * 2.0f));
    return expf(clamp2(e, -80.0f, 80.0f));
  }
  const float a_big = clamp2(a, 0.0f, 12.0f);
  const float b_big = clamp2(b, -60.0f, 60.0f);
  const float inv_v = clamp_max(1.0f / v, 20.0f);
  const float sinh_term = (expf(inv_v) - expf(-inv_v)) * 0.5f;
  return (expf(-b_big) * bessel_i0(a_big)) / ((sinh_term * 2.0f) * v);
}

// _logistic_cdf(a, s) at a = -pi and b = pi
struct Cdf {
  float a, b;
};

__device__ __forceinline__ Cdf logistic_cdf(float s) {
  const float r = 1.0f / s;
  return {sigmoid(r * -PI_F), sigmoid(r * PI_F)};
}

// _np_term for lobe p (0, 1, 2)
__device__ __forceinline__ float np_term(float phi, int p, float s,
                                         float gamma_o, float gamma_t) {
  const float fn = (gamma_t * F(2.0 * p) - gamma_o * 2.0f) + F(p * PI);
  float dphi = phi - fn;
  float m = fmodf(dphi + PI_F, TWO_PI_F);
  if (m != 0.0f && ((TWO_PI_F < 0.0f) != (m < 0.0f))) m += TWO_PI_F;
  dphi = m - PI_F;
  // _trimmed_logistic(dphi, s, -pi, pi)
  const float x = fabsf(dphi);
  const float e = expf(-x / s);
  const float sq = (e + 1.0f) * (e + 1.0f);
  const float logistic = e / (s * sq);
  const Cdf c = logistic_cdf(s);
  return logistic / (c.b - c.a);
}

// fr_dielectric's value (external eta_i = 1)
__device__ __forceinline__ float fr_dielectric(float cos_theta_i, float eta) {
  const float cti = clamp2(cos_theta_i, -1.0f, 1.0f);
  const bool entering = cti > 0.0f;
  const float eta1 = eta * 1.0f;
  const float eta_i = entering ? 1.0f : eta1;
  const float eta_t = entering ? eta1 : 1.0f;
  const float ci = fabsf(cti);
  const float sin_t = (eta_i / eta_t) * safe_sqrt(1.0f - ci * ci);
  const float ct = safe_sqrt(1.0f - sin_t * sin_t);
  const float r_parl = (eta_t * ci - eta_i * ct) /
                       clamp_min(eta_t * ci + eta_i * ct, F(1e-30));
  const float r_perp = (eta_i * ci - eta_t * ct) /
                       clamp_min(eta_i * ci + eta_t * ct, F(1e-30));
  const float fr = (r_parl * r_parl + r_perp * r_perp) * 0.5f;
  return sin_t >= 1.0f ? 1.0f : fr;
}

// HairCtx of one lane
struct Ctx {
  float gamma_o, sin_o, cos_o, phi_o, gamma_t, s;
  float v[4];               // roughness_to_v
  float tsin[4], tcos[4];   // _tilted (sin, |cos|) of each lobe
  float ap0;                // the Fresnel term, ap0 in every channel
  float ap[3][3];           // ap1..ap3, RGB
  float ap_pdf[4];
};

// hair_ctx(material row m, h, wo)
__device__ __forceinline__ Ctx make_ctx(const float m[MAT_COLS], float h_in,
                                        float wx, float wy, float wz) {
  Ctx c;
  // _grad_interior(h)'s value
  constexpr float lim = F(1.0 - 1e-3);
  const float xc = clamp2(h_in, -lim, lim);
  const float h = xc + (h_in - xc);
  c.gamma_o = safe_asin(h);
  // _angles(wo)
  c.sin_o = wx;
  c.cos_o = safe_sqrt(1.0f - wx * wx);
  const bool safe = (wy * wy + wz * wz) > F(1e-18);
  c.phi_o = atan2f(safe ? wz : 0.0f, safe ? wy : 1.0f);
  // _shared_terms
  const float eta = m[6];
  const float sin_t = c.sin_o / eta;
  const float cos_t = safe_sqrt(1.0f - sin_t * sin_t);
  const float etap = safe_sqrt(eta * eta - c.sin_o * c.sin_o) /
                     clamp_min(c.cos_o, F(1e-7));
  const float sin_gt = h / clamp_min(etap, F(1e-7));
  const float cos_gt = safe_sqrt(1.0f - sin_gt * sin_gt);
  c.gamma_t = safe_asin(sin_gt);
  const float path = (cos_gt * 2.0f) / clamp_min(cos_t, F(1e-7));
  const float cos_go = safe_sqrt(1.0f - h * h);
  const float fr = fr_dielectric(c.cos_o * cos_go, eta);
  c.ap0 = fr;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float t = expf(-m[ch] * path);
    const float a1 = ((1.0f - fr) * (1.0f - fr)) * t;
    const float a2 = (a1 * t) * fr;
    c.ap[0][ch] = a1;
    c.ap[1][ch] = a2;
    c.ap[2][ch] = ((a2 * fr) * t) / clamp_min(1.0f - t * fr, F(1e-5));
  }
  // roughness_to_s, roughness_to_v
  const float bm = m[3], bn = m[4];
  c.s = (((bn * F(0.265)) + (bn * bn) * F(1.194)) +
         powf(bn, 22.0f) * F(5.372)) * F(0.626657069);
  float v0 = ((bm * F(0.726)) + (bm * bm) * F(0.812)) +
             powf(bm, 20.0f) * F(3.7);
  v0 = v0 * v0;
  c.v[0] = v0;
  c.v[1] = v0 * 0.25f;
  c.v[2] = v0 * 4.0f;
  c.v[3] = v0 * 4.0f;
  // alpha_terms, then _tilted (lobe 0 takes 2 alpha, lobe 1 alpha,
  // lobe 2 4 alpha, with pbrt's signs)
  const float s0 = sinf(m[5]), c0 = cosf(m[5]);
  const float s1 = (c0 * 2.0f) * s0, c1 = c0 * c0 - s0 * s0;
  const float s2 = (c1 * 2.0f) * s1, c2 = c1 * c1 - s1 * s1;
  const float so = c.sin_o, co = c.cos_o;
  c.tsin[0] = so * c1 - co * s1;
  c.tcos[0] = fabsf(co * c1 + so * s1);
  c.tsin[1] = so * c0 + co * s0;
  c.tcos[1] = fabsf(co * c0 - so * s0);
  c.tsin[2] = so * c2 + co * s2;
  c.tcos[2] = fabsf(co * c2 - so * s2);
  c.tsin[3] = so;
  c.tcos[3] = fabsf(co);
  // _ap_pdf
  float ys[4];
  ys[0] = clamp_min(((fr + fr) + fr) * THIRD, 0.0f);
#pragma unroll
  for (int p = 1; p < 4; ++p) {
    const float* a = c.ap[p - 1];
    ys[p] = clamp_min(((a[0] + a[2]) + a[1]) * THIRD, 0.0f);
  }
  const float total = clamp_min(((ys[0] + ys[1]) + ys[2]) + ys[3], F(1e-30));
#pragma unroll
  for (int p = 0; p < 4; ++p) c.ap_pdf[p] = ys[p] / total;
  return c;
}

// _lobe_mn + _f_from_mn + _pdf_from_mn towards local wi
__device__ __forceinline__ void evaluate(const Ctx& c, float wx, float wy,
                                         float wz, float f[3], float& pdf) {
  // _angles(wi)
  const float sin_i = wx;
  const float cos_i = safe_sqrt(1.0f - sin_i * sin_i);
  const bool safe = (wy * wy + wz * wz) > F(1e-18);
  const float phi_i = atan2f(safe ? wz : 0.0f, safe ? wy : 1.0f);
  const float phi = phi_i - c.phi_o;
  float mn[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float m = mp(cos_i, c.tcos[p], sin_i, c.tsin[p], c.v[p]);
    mn[p] = m * np_term(phi, p, c.s, c.gamma_o, c.gamma_t);
  }
  const float m_last = mp(cos_i, c.cos_o, sin_i, c.sin_o, c.v[3]);
  const float m_last_2pi = div_c(m_last, TWO_PI_F);
  const float abs_cos = clamp_min(fabsf(wz), F(1e-7));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float fs = m_last_2pi * c.ap[2][ch];
    fs = fs + mn[0] * c.ap0;
    fs = fs + mn[1] * c.ap[0][ch];
    fs = fs + mn[2] * c.ap[1][ch];
    f[ch] = fs / abs_cos;
  }
  pdf = div_c(m_last * c.ap_pdf[3], TWO_PI_F);
#pragma unroll
  for (int p = 0; p < 3; ++p) pdf = pdf + mn[p] * c.ap_pdf[p];
}

// hair_sample_wi: a local direction drawn from u0..u3
__device__ __forceinline__ void sample(const Ctx& c, float u0, float u1_in,
                                       float u2, float u3, float w[3]) {
  const float cdf0 = c.ap_pdf[0];
  const float cdf1 = cdf0 + c.ap_pdf[1];
  const float cdf2 = cdf1 + c.ap_pdf[2];
  const int p = (u0 >= cdf0) + (u0 >= cdf1) + (u0 >= cdf2);
  // selects, not an index: the context stays in registers
  const float sin_op = p == 0 ? c.tsin[0] : p == 1 ? c.tsin[1]
                     : p == 2 ? c.tsin[2] : c.tsin[3];
  const float cos_op = p == 0 ? c.tcos[0] : p == 1 ? c.tcos[1]
                     : p == 2 ? c.tcos[2] : c.tcos[3];
  const float v_p = p == 0 ? c.v[0] : p == 1 ? c.v[1] : p == 2 ? c.v[2]
                                                            : c.v[3];
  // longitudinal sample
  const float u1 = clamp_min(u1_in, F(1e-5));
  const float cos_theta =
      1.0f + v_p * logf(u1 + (1.0f - u1) * expf((1.0f / v_p) * -2.0f));
  const float sin_theta = safe_sqrt(1.0f - cos_theta * cos_theta);
  const float cos_phi = cosf(u2 * TWO_PI_F);
  const float sin_i = -cos_theta * sin_op + (sin_theta * cos_phi) * cos_op;
  const float cos_i = safe_sqrt(1.0f - sin_i * sin_i);
  // azimuthal sample
  float dphi;
  if (p < 3) {
    const float pf = static_cast<float>(p);
    const float fn = ((pf * 2.0f) * c.gamma_t - c.gamma_o * 2.0f) + pf * PI_F;
    // _sample_trimmed_logistic(u3, s, -pi, pi)
    const Cdf cdf = logistic_cdf(c.s);
    const float k = cdf.b - cdf.a;
    const float denom = clamp_min(u3 * k + cdf.a, F(1e-30));
    const float x = -c.s * logf(1.0f / denom - 1.0f);
    dphi = fn + clamp2(x, -PI_F, PI_F);
  } else {
    dphi = u3 * TWO_PI_F;
  }
  const float phi_i = c.phi_o + dphi;
  w[0] = sin_i;
  w[1] = cos_i * cosf(phi_i);
  w[2] = cos_i * sinf(phi_i);
}

__global__ void __launch_bounds__(HAIR_THREADS)
hair_kernel(const float* __restrict__ h, const float* __restrict__ wo,
            const float* __restrict__ mat, const int* __restrict__ mat_id,
            const float* __restrict__ wi, int k, const float* __restrict__ u,
            int u_ld, int n, float* __restrict__ f_out,
            float* __restrict__ pdf_out, float* __restrict__ wi_h_out,
            float* __restrict__ f_h_out, float* __restrict__ pdf_h_out) {
  const int i = blockIdx.x * HAIR_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t r3 = 3 * static_cast<size_t>(i);
  const size_t row_id = mat_id == nullptr ? 0 : mat_id[i];
  const float* row = mat + MAT_COLS * row_id;
  float m[MAT_COLS];
#pragma unroll
  for (int j = 0; j < MAT_COLS; ++j) m[j] = row[j];
  const Ctx c = make_ctx(m, h[i], wo[r3], wo[r3 + 1], wo[r3 + 2]);
  // the K next-event directions, then (j == k) the BSDF sample: one
  // inlined copy of the evaluation serves both
#pragma unroll 1
  for (int j = 0; j <= k; ++j) {
    const size_t r = static_cast<size_t>(i) * k + j;
    float w[3], f[3], pdf;
    if (j < k) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch] = wi[3 * r + ch];
    } else {
      const float* ui = u + static_cast<size_t>(i) * u_ld;
      sample(c, ui[0], ui[1], ui[2], ui[3], w);
    }
    evaluate(c, w[0], w[1], w[2], f, pdf);
    if (j < k) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f_out[3 * r + ch] = f[ch];
      pdf_out[r] = pdf;
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        wi_h_out[r3 + ch] = w[ch];
        f_h_out[r3 + ch] = f[ch];
      }
      pdf_h_out[i] = pdf;
    }
  }
}

}  // namespace

// One bounce's hair BSDF terms of n lanes: the context of (material row,
// h (n,), wo (n, 3)); f_out (n, k, 3) and pdf_out (n, k) towards the local
// directions wi (n, k, 3); a direction drawn from u (rows of u_ld floats,
// the first 4 read) into wi_h_out (n, 3), with f_h_out (n, 3) and pdf_h_out
// (n,) there. mat (M, 7) rows of sigma_a, beta_m, beta_n, alpha, eta; lane
// i reads row mat_id[i], or row 0 where mat_id is null.
extern "C" int yhair_hair_shade(const float* h, const float* wo,
                                const float* mat, const int* mat_id,
                                const float* wi, int k, const float* u,
                                int u_ld, int n, float* f_out, float* pdf_out,
                                float* wi_h_out, float* f_h_out,
                                float* pdf_h_out, void* stream) {
  if (n == 0) return 0;
  hair_kernel<<<(n + HAIR_THREADS - 1) / HAIR_THREADS, HAIR_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      h, wo, mat, mat_id, wi, k, u, u_ld, n, f_out, pdf_out, wi_h_out,
      f_h_out, pdf_h_out);
  return static_cast<int>(cudaGetLastError());
}
