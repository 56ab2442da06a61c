// Fused evaluate + assemble for the banded Schur solver, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rsba_tpu/kernels/fused.py::fused_evaluate_assemble
// (its pl.pallas_call over _kernel).  For every slot of the (NR, G, L)
// window grid it computes the rolling-shutter reprojection residual
// (SLERP / NLERP / lerp_aa pose at row time t, Brown-Conrady distortion),
// the 15 tangent Jacobians over pose_a (6), pose_b (6) and the point (3)
// by forward-mode dual numbers, the Triggs robust correction, and the
// constant-block masks.  It then reduces on chip to the normal-equation
// blocks; the Jacobians never reach device memory:
//
//   cost (NR)           per-row 0.5 * sum(rho)
//   gw   (NR, W, 6)     g_cam window sums (folded into poses outside)
//   b0   (NR, W, 36)    B band d=0 window sums
//   b1   (NR, W, 36)    B band d=1 window sums
//   g_pt (NR, 3, G)     point gradients
//   c6   (NR, 6, G)     per-point 3x3 J^T J, packed [00 01 02 11 12 22]
//   F    (NR, W, 18, G) camera-point blocks, comp = 3a + p
//
// Inputs: win (NR, W, 8) per-row pose windows [q(4), c(3), pose_free],
// pts (NR, 3, G), ptf (NR, G), uv (NR, 2, L, G), tt/mask/rsf (NR, L, G),
// offs (NR, L, G) int32 (pose_a - row_base), intr (9).  Each slot picks its
// pose_a / pose_b from the window itself (offs_b = offs + rsf).
//
// Design: one block per window row, one thread per point column g.  A
// thread walks its L slots, skips padded ones (they can project 0/0), and
// owns F[r, :, :, g], g_pt[r, :, g] and c6[r, :, g] outright, so those need
// no atomics.  The row's gw/b0/b1 window sums (<= 24 * 78 values) and its
// cost accumulate in shared memory with atomics, then are written once.
// Branches (Taylor guards, to_axis_angle at sin_half = 0, loss branches)
// select whole duals, never multiply an unselected NaN by zero.
//
// Bound: registers and FMA throughput.  Each 15-tangent dual is 16 values
// in registers and the projection chain keeps dozens of them live, so
// occupancy is register-limited.  wgmma, TMA and tuning (hand-derived
// sparse tangents, warp-level window reductions in place of shared atomics)
// are left for later work.
//
// Built with nvcc into a shared library with a plain C interface
// (rsba_tpu_torch/kernels/build.py) and called through ctypes.

#ifdef __CUDACC__
#define RSBA_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <stddef.h>
#define RSBA_HD inline
#endif

namespace rsba {

constexpr int NT = 15;  // tangents: rot a (3), trans a (3), rot b, trans b, point

RSBA_HD float m_sqrt(float x) { return sqrtf(x); }
RSBA_HD double m_sqrt(double x) { return sqrt(x); }
RSBA_HD float m_sin(float x) { return sinf(x); }
RSBA_HD double m_sin(double x) { return sin(x); }
RSBA_HD float m_cos(float x) { return cosf(x); }
RSBA_HD double m_cos(double x) { return cos(x); }
RSBA_HD float m_atan2(float y, float x) { return atan2f(y, x); }
RSBA_HD double m_atan2(double y, double x) { return atan2(y, x); }
RSBA_HD float m_log(float x) { return logf(x); }
RSBA_HD double m_log(double x) { return log(x); }
template <typename T> RSBA_HD T m_max(T a, T b) { return a > b ? a : b; }

// Forward-mode dual number with NT tangents.  Operators are friends so a
// double literal converts to float for D<float>.
template <typename T>
struct D {
  T v;
  T d[NT];

  static RSBA_HD D c(T x) {
    D r;
    r.v = x;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = T(0);
    return r;
  }
  static RSBA_HD D seed(T x, int j) {
    D r = c(x);
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = (k == j) ? T(1) : T(0);
    return r;
  }

  friend RSBA_HD D operator+(const D& a, const D& b) {
    D r;
    r.v = a.v + b.v;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = a.d[k] + b.d[k];
    return r;
  }
  friend RSBA_HD D operator-(const D& a, const D& b) {
    D r;
    r.v = a.v - b.v;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = a.d[k] - b.d[k];
    return r;
  }
  friend RSBA_HD D operator-(const D& a) {
    D r;
    r.v = -a.v;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = -a.d[k];
    return r;
  }
  friend RSBA_HD D operator*(const D& a, const D& b) {
    D r;
    r.v = a.v * b.v;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
    return r;
  }
  friend RSBA_HD D operator/(const D& a, const D& b) {
    D r;
    const T inv = T(1) / b.v;
    r.v = a.v * inv;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
    return r;
  }
  friend RSBA_HD D operator+(const D& a, T s) {
    D r = a;
    r.v = a.v + s;
    return r;
  }
  friend RSBA_HD D operator+(T s, const D& a) { return a + s; }
  friend RSBA_HD D operator-(const D& a, T s) {
    D r = a;
    r.v = a.v - s;
    return r;
  }
  friend RSBA_HD D operator-(T s, const D& a) {
    D r = -a;
    r.v = s - a.v;
    return r;
  }
  friend RSBA_HD D operator*(const D& a, T s) {
    D r;
    r.v = a.v * s;
#pragma unroll
    for (int k = 0; k < NT; ++k) r.d[k] = a.d[k] * s;
    return r;
  }
  friend RSBA_HD D operator*(T s, const D& a) { return a * s; }
  friend RSBA_HD D operator/(const D& a, T s) { return a * (T(1) / s); }
  friend RSBA_HD D operator/(T s, const D& b) { return c(s) / b; }
};

template <typename T>
RSBA_HD D<T> d_unary(const D<T>& a, T value, T deriv) {
  D<T> r;
  r.v = value;
#pragma unroll
  for (int k = 0; k < NT; ++k) r.d[k] = deriv * a.d[k];
  return r;
}
template <typename T>
RSBA_HD D<T> d_sqrt(const D<T>& a) {
  const T s = m_sqrt(a.v);
  return d_unary(a, s, T(0.5) / s);
}
template <typename T>
RSBA_HD D<T> d_sin(const D<T>& a) { return d_unary(a, m_sin(a.v), m_cos(a.v)); }
template <typename T>
RSBA_HD D<T> d_cos(const D<T>& a) { return d_unary(a, m_cos(a.v), -m_sin(a.v)); }
template <typename T>
RSBA_HD D<T> d_atan2(const D<T>& y, const D<T>& x) {
  D<T> r;
  r.v = m_atan2(y.v, x.v);
  const T inv = T(1) / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int k = 0; k < NT; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) * inv;
  return r;
}

template <typename T> struct Q { D<T> w, x, y, z; };
template <typename T> struct V { D<T> x, y, z; };

template <typename T>
RSBA_HD Q<T> q_mul(const Q<T>& a, const Q<T>& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
template <typename T>
RSBA_HD Q<T> q_conj(const Q<T>& q) { return {q.w, -q.x, -q.y, -q.z}; }
template <typename T>
RSBA_HD Q<T> q_normalize(const Q<T>& q) {
  const D<T> inv = T(1) / d_sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}
template <typename T>
RSBA_HD V<T> v_cross(const V<T>& a, const V<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// R(q) v = v + 2 (w (u x v) + u x (u x v)), u = q.xyz
template <typename T>
RSBA_HD V<T> q_rotate(const Q<T>& q, const V<T>& v) {
  const V<T> u = {q.x, q.y, q.z};
  const V<T> uv = v_cross(u, v);
  const V<T> uuv = v_cross(u, uv);
  return {v.x + T(2) * (q.w * uv.x + uuv.x), v.y + T(2) * (q.w * uv.y + uuv.y),
          v.z + T(2) * (q.w * uv.z + uuv.z)};
}

// Angle-axis -> quaternion; Taylor branch below theta^2 < 1e-8
// (geometry.quaternion.from_axis_angle).
template <typename T>
RSBA_HD Q<T> from_aa(const V<T>& aa) {
  const D<T> theta_sq = aa.x * aa.x + aa.y * aa.y + aa.z * aa.z;
  D<T> k, w;
  if (theta_sq.v < T(1e-8)) {
    k = T(0.5) - theta_sq / T(48);
    w = T(1) - theta_sq / T(8);
  } else {
    const D<T> theta = d_sqrt(theta_sq + T(1e-16));
    const D<T> half = T(0.5) * theta;
    k = d_sin(half) / theta;
    w = d_cos(half);
  }
  return {w, k * aa.x, k * aa.y, k * aa.z};
}

// Quaternion -> angle-axis on the w >= 0 hemisphere
// (geometry.quaternion.to_axis_angle); sin_half = 0 takes the constant 2.
template <typename T>
RSBA_HD V<T> to_aa(const Q<T>& q) {
  const D<T> sin_half = d_sqrt(q.x * q.x + q.y * q.y + q.z * q.z);
  const T sign = q.w.v < T(0) ? T(-1) : T(1);
  const D<T> w = sign * q.w;
  const V<T> u = {sign * q.x, sign * q.y, sign * q.z};
  D<T> k;
  if (sin_half.v < T(1e-8)) {
    k = D<T>::c(T(2));
  } else {
    k = T(2) * d_atan2(sin_half, w) / sin_half;
  }
  return {k * u.x, k * u.y, k * u.z};
}

template <typename T>
RSBA_HD V<T> v_scale(const V<T>& a, T s) { return {a.x * s, a.y * s, a.z * s}; }
template <typename T>
RSBA_HD V<T> v_lerp(const V<T>& a, const V<T>& b, T t) {
  return {(T(1) - t) * a.x + t * b.x, (T(1) - t) * a.y + t * b.y,
          (T(1) - t) * a.z + t * b.z};
}

enum Interp { SLERP = 0, NLERP = 1, LERP_AA = 2 };
enum LossKind { TRIVIAL = 0, HUBER = 1, SOFT_L1 = 2, CAUCHY = 3 };

template <typename T>
RSBA_HD Q<T> interp_rotation(const Q<T>& qa, const Q<T>& qb, T t, int mode) {
  if (mode == SLERP) {
    return q_mul(qa, from_aa(v_scale(to_aa(q_mul(q_conj(qa), qb)), t)));
  }
  if (mode == NLERP) {
    const T dot = qa.w.v * qb.w.v + qa.x.v * qb.x.v + qa.y.v * qb.y.v + qa.z.v * qb.z.v;
    const T s = dot < T(0) ? T(-1) : T(1);
    const T a = T(1) - t;
    return q_normalize(Q<T>{a * qa.w + t * (s * qb.w), a * qa.x + t * (s * qb.x),
                            a * qa.y + t * (s * qb.y), a * qa.z + t * (s * qb.z)});
  }
  return from_aa(v_lerp(to_aa(qa), to_aa(qb), t));
}

template <typename T>
struct Args {
  const T* win;
  const T* pts;
  const T* ptf;
  const T* uv;
  const T* tt;
  const T* mask;
  const int* offs;
  const T* rsf;
  const T* intr;
  int NR, W, L, G;
  int rolling_shutter, interp, use_distortion, loss_kind;
  T projection_sign, loss_scale;
  T* cost;
  T* gw;
  T* b0;
  T* b1;
  T* gpt;
  T* c6;
  T* F;
};

// rho, rho', rho'' of the robust loss (geometry.losses.Loss.evaluate).
template <typename T>
RSBA_HD void loss_eval(int kind, T a, T s, T& rho, T& rho1, T& rho2) {
  const T a2 = a * a;
  if (kind == HUBER) {
    if (s > a2) {
      const T r = m_sqrt(m_max(s, a2));
      rho = T(2) * a * r - a2;
      rho1 = a / r;
      rho2 = T(-0.5) * a / (r * s + T(1e-30));
    } else {
      rho = s;
      rho1 = T(1);
      rho2 = T(0);
    }
  } else if (kind == SOFT_L1) {
    const T t = T(1) + s / a2;
    const T sq = m_sqrt(t);
    rho = T(2) * a2 * (sq - T(1));
    rho1 = T(1) / sq;
    rho2 = T(-0.5) / (a2 * t * sq);
  } else if (kind == CAUCHY) {
    const T t = T(1) + s / a2;
    rho = a2 * m_log(t);
    rho1 = T(1) / t;
    rho2 = T(-1) / (a2 * t * t);
  } else {
    rho = s;
    rho1 = T(1);
    rho2 = T(0);
  }
}

template <typename T>
RSBA_HD void acc_add(T* p, T v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// One point column g of window row r: all L slots.  acc is the row's
// shared accumulator: gw at 0, b0 at 6W, b1 at 42W, cost at 78W.
template <typename T>
RSBA_HD void thread_row(const Args<T>& a, int r, int g, T* acc) {
  const int W = a.W, L = a.L, G = a.G;
  T* F = a.F + (size_t)r * W * 18 * G + g;
  for (int i = 0; i < W * 18; ++i) F[(size_t)i * G] = T(0);
  T gpt[3] = {T(0), T(0), T(0)};
  T c6[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T cost = T(0);
  const T X0[3] = {a.pts[((size_t)r * 3 + 0) * G + g], a.pts[((size_t)r * 3 + 1) * G + g],
                   a.pts[((size_t)r * 3 + 2) * G + g]};
  const bool pt_free = a.ptf[(size_t)r * G + g] > T(0);
  const T* in = a.intr;
  T* gw = acc;
  T* b0 = acc + 6 * W;
  T* b1 = acc + 42 * W;

  for (int l = 0; l < L; ++l) {
    const size_t idx = ((size_t)r * L + l) * G + g;
    if (!(a.mask[idx] > T(0))) continue;
    const int oa = a.offs[idx];
    const T rs = a.rsf[idx];
    const int ob = oa + (int)rs;
    const T* wa = a.win + ((size_t)r * W + oa) * 8;
    const T* wb = a.win + ((size_t)r * W + ob) * 8;
    const T t = a.tt[idx];
    const T u0 = a.uv[(((size_t)r * 2 + 0) * L + l) * G + g];
    const T u1 = a.uv[(((size_t)r * 2 + 1) * L + l) * G + g];

    // Residual as a function of the 15 tangents at 0.
    const Q<T> qa = {D<T>::c(wa[0]), D<T>::c(wa[1]), D<T>::c(wa[2]), D<T>::c(wa[3])};
    const Q<T> qa2 = q_normalize(q_mul(
        qa, from_aa(V<T>{D<T>::seed(T(0), 0), D<T>::seed(T(0), 1), D<T>::seed(T(0), 2)})));
    const V<T> ca2 = {D<T>::seed(wa[4], 3), D<T>::seed(wa[5], 4), D<T>::seed(wa[6], 5)};
    Q<T> q_t;
    V<T> c_t;
    if (a.rolling_shutter) {
      const Q<T> qb = {D<T>::c(wb[0]), D<T>::c(wb[1]), D<T>::c(wb[2]), D<T>::c(wb[3])};
      const Q<T> qb2 = q_normalize(q_mul(
          qb, from_aa(V<T>{D<T>::seed(T(0), 6), D<T>::seed(T(0), 7), D<T>::seed(T(0), 8)})));
      const V<T> cb2 = {D<T>::seed(wb[4], 9), D<T>::seed(wb[5], 10), D<T>::seed(wb[6], 11)};
      q_t = interp_rotation(qa2, qb2, t, a.interp);
      c_t = v_lerp(ca2, cb2, t);
    } else {
      q_t = qa2;
      c_t = ca2;
    }
    const V<T> Xr = {D<T>::seed(X0[0], 12) - c_t.x, D<T>::seed(X0[1], 13) - c_t.y,
                     D<T>::seed(X0[2], 14) - c_t.z};
    const V<T> Xc = q_rotate(q_t, Xr);
    const D<T> inv_z = T(1) / Xc.z;
    D<T> x = a.projection_sign * Xc.x * inv_z;
    D<T> y = a.projection_sign * Xc.y * inv_z;
    if (a.use_distortion) {
      const T k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7], k3 = in[8];
      const D<T> r2 = x * x + y * y;
      const D<T> radial = T(1) + r2 * (k1 + r2 * (k2 + r2 * k3));
      const D<T> xd = x * radial + T(2) * p1 * x * y + p2 * (r2 + T(2) * x * x);
      const D<T> yd = y * radial + p1 * (r2 + T(2) * y * y) + T(2) * p2 * x * y;
      x = xd;
      y = yd;
    }
    const D<T> res0 = in[0] * x + in[2] - u0;
    const D<T> res1 = in[1] * y + in[3] - u1;

    // Triggs correction (geometry.losses.Loss.correct).
    const T r0 = res0.v, r1 = res1.v;
    const T s = r0 * r0 + r1 * r1;
    T rho, rho1, rho2;
    loss_eval(a.loss_kind, a.loss_scale, s, rho, rho1, rho2);
    T J[NT][2];
    T rt0 = r0, rt1 = r1;
    if (a.loss_kind == TRIVIAL) {
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        J[k][0] = res0.d[k];
        J[k][1] = res1.d[k];
      }
    } else {
      const T sqrt_rho1 = m_sqrt(m_max(rho1, T(1e-30)));
      const T dd = m_max(T(1) + T(2) * s * rho2 / rho1, T(0));
      const T alpha = rho2 > T(0) ? T(1) - m_sqrt(dd) : T(0);
      const T res_scale = sqrt_rho1 / (T(1) - alpha);
      rt0 = res_scale * r0;
      rt1 = res_scale * r1;
      const T aos = s > T(0) ? alpha / m_max(s, T(1e-30)) : T(0);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const T rTJ = r0 * res0.d[k] + r1 * res1.d[k];
        J[k][0] = sqrt_rho1 * (res0.d[k] - aos * r0 * rTJ);
        J[k][1] = sqrt_rho1 * (res1.d[k] - aos * r1 * rTJ);
      }
    }
    // Constant-block masks (selection).
    const bool pf_a = wa[7] > T(0), pf_b = wb[7] > T(0);
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const bool keep = k < 6 ? pf_a : (k < 12 ? pf_b : pt_free);
      if (!keep) {
        J[k][0] = T(0);
        J[k][1] = T(0);
      }
    }
    cost += rho;

#define DOT(i, j) (J[i][0] * J[j][0] + J[i][1] * J[j][1])
    // Point side: g_pt, C.
#pragma unroll
    for (int p = 0; p < 3; ++p) gpt[p] += J[12 + p][0] * rt0 + J[12 + p][1] * rt1;
    c6[0] += DOT(12, 12);
    c6[1] += DOT(12, 13);
    c6[2] += DOT(12, 14);
    c6[3] += DOT(13, 13);
    c6[4] += DOT(13, 14);
    c6[5] += DOT(14, 14);

    // F blocks (thread-owned) and g_cam windows.
    for (int q = 0; q < 6; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        F[(size_t)(oa * 18 + 3 * q + p) * G] += DOT(q, 12 + p);
      }
      acc_add(&gw[oa * 6 + q], J[q][0] * rt0 + J[q][1] * rt1);
    }
    if (a.rolling_shutter) {
      for (int q = 0; q < 6; ++q) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          F[(size_t)(ob * 18 + 3 * q + p) * G] += DOT(6 + q, 12 + p);
        }
        acc_add(&gw[ob * 6 + q], J[6 + q][0] * rt0 + J[6 + q][1] * rt1);
      }
    }

    // B band windows: d=0 at offs_a gets aa (+ ab + ba when pose_b ==
    // pose_a), d=0 at offs_b gets bb, d=1 at offs_a gets ab when pose_b ==
    // pose_a + 1.
    const T same = T(1) - rs;
    for (int q = 0; q < 6; ++q) {
      for (int b = 0; b < 6; ++b) {
        T v = DOT(q, b);
        if (a.rolling_shutter) {
          const T ab = DOT(q, 6 + b);
          const T ba = DOT(b, 6 + q);
          v += same * (ab + ba);
          acc_add(&b0[ob * 36 + q * 6 + b], DOT(6 + q, 6 + b));
          if (rs != T(0)) acc_add(&b1[oa * 36 + q * 6 + b], rs * ab);
        }
        acc_add(&b0[oa * 36 + q * 6 + b], v);
      }
    }
#undef DOT
  }

  acc_add(&acc[78 * W], T(0.5) * cost);
#pragma unroll
  for (int p = 0; p < 3; ++p) a.gpt[((size_t)r * 3 + p) * G + g] = gpt[p];
#pragma unroll
  for (int i = 0; i < 6; ++i) a.c6[((size_t)r * 6 + i) * G + g] = c6[i];
}

// Copies the row's shared accumulator out (thread i of n).
template <typename T>
RSBA_HD void write_row(const Args<T>& a, int r, const T* acc, int i, int n) {
  const int W = a.W;
  for (int j = i; j < 6 * W; j += n) a.gw[(size_t)r * 6 * W + j] = acc[j];
  for (int j = i; j < 36 * W; j += n) {
    a.b0[(size_t)r * 36 * W + j] = acc[6 * W + j];
    a.b1[(size_t)r * 36 * W + j] = acc[42 * W + j];
  }
  if (i == 0) a.cost[r] = acc[78 * W];
}

#ifdef __CUDACC__
template <typename T>
__global__ void fused_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int r = blockIdx.x;
  const int n_acc = 78 * a.W + 1;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = T(0);
  __syncthreads();
  if ((int)threadIdx.x < a.G) thread_row(a, r, (int)threadIdx.x, acc);
  __syncthreads();
  write_row(a, r, acc, (int)threadIdx.x, (int)blockDim.x);
}

template <typename T>
int launch(const Args<T>& a, void* stream) {
  const int threads = ((a.G + 31) / 32) * 32;
  const size_t smem = sizeof(T) * (78 * a.W + 1);
  fused_kernel<T><<<a.NR, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // namespace rsba

#ifdef __CUDACC__
#define RSBA_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const T* win, const T* pts, const T* ptf, const T* uv,      \
                      const T* tt, const T* mask, const int* offs, const T* rsf,  \
                      const T* intr, int NR, int W, int L, int G,                 \
                      int rolling_shutter, int interp, int use_distortion,        \
                      int loss_kind, double projection_sign, double loss_scale,   \
                      T* cost, T* gw, T* b0, T* b1, T* gpt, T* c6, T* F,          \
                      void* stream) {                                              \
    rsba::Args<T> a{win, pts, ptf, uv, tt, mask, offs, rsf, intr, NR, W, L, G,    \
                    rolling_shutter, interp, use_distortion, loss_kind,           \
                    (T)projection_sign, (T)loss_scale,                            \
                    cost, gw, b0, b1, gpt, c6, F};                                \
    return rsba::launch<T>(a, stream);                                             \
  }
RSBA_ENTRY(rsba_fused_evaluate_assemble_f32, float)
RSBA_ENTRY(rsba_fused_evaluate_assemble_f64, double)
#endif
