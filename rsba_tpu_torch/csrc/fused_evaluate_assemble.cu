// Fused evaluate + assemble for the banded Schur solver, and the residual
// pass of its LM loop, CUDA C++ for sm_90a.
//
// The fused kernel (fused_kernel) replaces the TPU kernel
// rsba_tpu/kernels/fused.py::fused_evaluate_assemble (its pl.pallas_call
// over _kernel).  For every slot of the (NR, G, L)
// window grid it computes the rolling-shutter reprojection residual
// (SLERP / NLERP / lerp_aa pose at row time t, Brown-Conrady distortion),
// the 15 tangent Jacobians over pose_a (6), pose_b (6) and the point (3),
// the Triggs robust correction, and the constant-block masks.  It then
// reduces on chip to the normal-equation blocks; the Jacobians never reach
// device memory:
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
// Bound: bytes.  At the banded solver's largest preset (NR = 1096, W = 11,
// L = 10, G = 112, float32) the inputs and outputs are 137 MB, 0.041 ms at
// an H100's 3.35 TB/s, of which F alone is 97 MB; the arithmetic that the
// valid slots need is well under 2 GFLOP, 0.02 ms at the float32 peak.  The
// kernel is several times above that bound: the F tile in shared memory
// leaves room for 8 warps on an SM, too few to hide the latency of each
// slot's serial chain (see "Launch shape").
//
// Design, one block per window row, one thread per point column:
//
// * Per-row prologue in shared memory.  The first 3W threads compute, once
//   per row, what does not depend on a slot's row time t: each pose's
//   boxplus-and-normalise with its 3 rotation tangents (and, for lerp_aa,
//   its angle-axis vector), and for SLERP each pose pair's relative rotation
//   to_aa(conj(qa) qb) with its 6 tangents, atan2 included.  A slot is then
//   one from_aa(t w), one quaternion product, one rotation, the projection
//   and the distortion, all on plain values.
// * Sparse tangents, derived by hand.  The dual number takes its width as a
//   template parameter and is used in the prologue only (3 tangents a pose,
//   6 a pair).  In a slot, with M the 2x3 Jacobian of intrinsics o
//   distortion o perspective at X_cam, nine columns are one product:
//   J_X = M R(q_t), J_ca = -(1-t) J_X, J_cb = -t J_X.  The six rotation
//   columns pull the two rows of M d(R(q) Xr)/dq back through the
//   interpolation onto the prologue's tangents (2 rows backward in place
//   of 6 tangents forward).  Every branch keeps its meaning: Taylor
//   guards, to_aa at sin_half = 0, the nlerp sign and the loss branches
//   select on the primal and compute only the taken side; padded slots are
//   skipped before any arithmetic.
// * Window sums without atomics, in a fixed order.  A slot whose pose_b is
//   its pose_a first folds J_b into J_a, so that every slot adds aa, J_a^T r
//   and ab at its offset and bb, J_b^T r one offset later.  Per slot the
//   warp reduces the 21 + 21 distinct entries of the symmetric blocks, the
//   36 of ab, the 12 of J^T r and rho, 91 values in all, by a butterfly
//   that halves the values with each exchange (3 x 31 shuffles in float),
//   lanes grouped by offset.  Each lane adds its share into its warp's own
//   accumulator in shared memory, an address that no other lane touches.
//   The warps' accumulators are summed in warp order and the symmetric
//   blocks mirrored when the row is written.  Two launches on the same
//   inputs give the same bits.
// * F leaves the block once.  A thread accumulates its column of the row's
//   (W, 18, G) tile in shared memory and the block writes the tile out in
//   whole 16-byte coalesced stores; F is never read back.  Where the tile of
//   a whole row does not fit, the same kernel walks the row in column
//   chunks, each chunk's tile in turn, with the window sums carried in
//   shared memory across chunks (the wrapper chooses threads and tile width
//   from the shape).
// * Launch shape.  One block per row, left to the hardware's block
//   scheduler, which hands a row to whichever SM has room: at the largest
//   preset two blocks of four warps fit on an SM beside their tiles
//   (2 x 109 KB), so one row's F store overlaps the other's arithmetic, and
//   1096 rows over 264 places leave a last wave that is partly full.
//   Shared memory, not registers, sets the residency.
// * No tensor cores, on purpose.  The products are normal-equation sums
//   that need full float32; Hopper's tensor cores take float32 only as
//   TF32, which costs the solver accuracy and LM iterations.  The inputs
//   are read once with plain coalesced loads; TMA tensor maps are not
//   needed.
//
// The residual pass, the second kernel here (residual_kernel, entry points
// rsba_residual_pass_f32 / _f64), replaces no TPU kernel: the reference's
// residual pass is XLA ops (rsba_tpu/solver/banded.py::residuals_raw).  On
// a candidate's parameters it writes every slot's robust cost rho
// (NR, L, G), 0 on padded slots, and per row 0.5 sum(rho_ref - rho) over
// the valid slots, from the fused kernel's inputs less ptf.  The LM loop
// seeds rho_ref with it and differences every attempt through it, so both
// sides of a decrease come from one evaluator, and it shares this file's
// prologue (values only), geometry, projection and loss with the fused
// kernel, so the residual the LM differences and the one the prepare
// assembles cannot drift apart.
//
// Bound: bytes.  A slot reads uv, t, mask, offset, rsf and rho_ref and
// writes rho, 32 B in float32; at config 5 (NR = 10,920, L = 8, G = 112,
// 9.78M slots) that and the point planes and pose windows are 0.33 GB,
// 0.10 ms at 3.35 TB/s; config 4's 1.23M slots 0.012 ms.  A valid slot's
// arithmetic is a few hundred FLOP, far under it.  Design:
//
// * Nothing of F's tile: the block's shared memory is its rows' prologues
//   and one partial a thread (6-8 KB in float32), so registers, not shared
//   memory, set the residency.
// * A thread takes one column of one row and walks its L slots, each
//   slot's inputs loaded one slot ahead; consecutive threads take
//   consecutive columns, so every load and the rho store are coalesced
//   along G.  A block takes R consecutive rows (R G columns rounded up to
//   whole warps, at most 256 threads: two rows of 112 make 224 threads, no
//   idle lane), chosen by the wrapper to leave at least four blocks an SM
//   on all 132 SMs where the grid has them (5,460 blocks at config 5).
// * The prologue is per row, by the block's threads together: the
//   normalised poses and SLERP's pair rotations, as the fused kernel's
//   prologue computes them but without tangents.
// * Row sums without atomics: a thread sums its slots in order, a warp
//   sums a row's partials with lanes striding in a fixed order and a
//   butterfly; the wrapper sums the NR rows.  Two launches on the same
//   inputs give the same bits.
//
// The per-slot arithmetic, the prologue and the row write-out are
// __host__ __device__, so the same source builds as plain C++ (g++ -x c++)
// with a sequential loop that fills the same outputs; warp shuffles,
// shared memory and the tile stores sit under #ifdef __CUDACC__.
//
// Built with nvcc into a shared library with a plain C interface
// (rsba_tpu_torch/kernels/build.py) and called through ctypes.

#ifdef __CUDACC__
#include <stdint.h>
#define RSBA_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <stddef.h>
#include <vector>
#define RSBA_HD inline
#endif

namespace rsba {

RSBA_HD float m_sqrt(float x) { return sqrtf(x); }
RSBA_HD double m_sqrt(double x) { return sqrt(x); }
RSBA_HD float m_sin(float x) { return sinf(x); }
RSBA_HD double m_sin(double x) { return sin(x); }
RSBA_HD float m_cos(float x) { return cosf(x); }
RSBA_HD double m_cos(double x) { return cos(x); }
RSBA_HD void m_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
RSBA_HD void m_sincos(double x, double* s, double* c) { sincos(x, s, c); }
RSBA_HD float m_atan2(float y, float x) { return atan2f(y, x); }
RSBA_HD double m_atan2(double y, double x) { return atan2(y, x); }
RSBA_HD float m_log(float x) { return logf(x); }
RSBA_HD double m_log(double x) { return log(x); }
template <typename T> RSBA_HD T m_max(T a, T b) { return a > b ? a : b; }

// Forward-mode dual number with N tangents.  Operators are friends so a
// double literal converts to float for D<float, N>.
template <typename T, int N>
struct D {
  T v;
  T d[N];

  static RSBA_HD D c(T x) {
    D r;
    r.v = x;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = T(0);
    return r;
  }

  friend RSBA_HD D operator+(const D& a, const D& b) {
    D r;
    r.v = a.v + b.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
    return r;
  }
  friend RSBA_HD D operator-(const D& a, const D& b) {
    D r;
    r.v = a.v - b.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
    return r;
  }
  friend RSBA_HD D operator-(const D& a) {
    D r;
    r.v = -a.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
    return r;
  }
  friend RSBA_HD D operator*(const D& a, const D& b) {
    D r;
    r.v = a.v * b.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
    return r;
  }
  friend RSBA_HD D operator/(const D& a, const D& b) {
    D r;
    const T inv = T(1) / b.v;
    r.v = a.v * inv;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
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
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
    return r;
  }
  friend RSBA_HD D operator*(T s, const D& a) { return a * s; }
  friend RSBA_HD D operator/(const D& a, T s) { return a * (T(1) / s); }
  friend RSBA_HD D operator/(T s, const D& b) { return c(s) / b; }
};

template <typename T, int N>
RSBA_HD D<T, N> d_unary(const D<T, N>& a, T value, T deriv) {
  D<T, N> r;
  r.v = value;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = deriv * a.d[k];
  return r;
}
template <typename T, int N>
RSBA_HD D<T, N> d_sqrt(const D<T, N>& a) {
  const T s = m_sqrt(a.v);
  return d_unary(a, s, T(0.5) / s);
}
template <typename T, int N>
RSBA_HD D<T, N> d_sin(const D<T, N>& a) {
  return d_unary(a, m_sin(a.v), m_cos(a.v));
}
template <typename T, int N>
RSBA_HD D<T, N> d_cos(const D<T, N>& a) {
  return d_unary(a, m_cos(a.v), -m_sin(a.v));
}
template <typename T, int N>
RSBA_HD D<T, N> d_atan2(const D<T, N>& y, const D<T, N>& x) {
  D<T, N> r;
  r.v = m_atan2(y.v, x.v);
  const T inv = T(1) / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) * inv;
  return r;
}

template <typename T, int N> struct Q { D<T, N> w, x, y, z; };
template <typename T, int N> struct V { D<T, N> x, y, z; };

template <typename T, int N>
RSBA_HD Q<T, N> q_mul(const Q<T, N>& a, const Q<T, N>& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
template <typename T, int N>
RSBA_HD Q<T, N> q_conj(const Q<T, N>& q) { return {q.w, -q.x, -q.y, -q.z}; }
template <typename T, int N>
RSBA_HD Q<T, N> q_normalize(const Q<T, N>& q) {
  const D<T, N> inv =
      T(1) / d_sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}
// Angle-axis -> quaternion; Taylor branch below theta^2 < 1e-8
// (geometry.quaternion.from_axis_angle).
template <typename T, int N>
RSBA_HD Q<T, N> from_aa(const V<T, N>& aa) {
  const D<T, N> theta_sq = aa.x * aa.x + aa.y * aa.y + aa.z * aa.z;
  D<T, N> k, w;
  if (theta_sq.v < T(1e-8)) {
    k = T(0.5) - theta_sq / T(48);
    w = T(1) - theta_sq / T(8);
  } else {
    const D<T, N> theta = d_sqrt(theta_sq + T(1e-16));
    const D<T, N> half = T(0.5) * theta;
    k = d_sin(half) / theta;
    w = d_cos(half);
  }
  return {w, k * aa.x, k * aa.y, k * aa.z};
}

// Quaternion -> angle-axis on the w >= 0 hemisphere
// (geometry.quaternion.to_axis_angle); sin_half = 0 takes the constant 2.
template <typename T, int N>
RSBA_HD V<T, N> to_aa(const Q<T, N>& q) {
  const D<T, N> sin_half = d_sqrt(q.x * q.x + q.y * q.y + q.z * q.z);
  const T sign = q.w.v < T(0) ? T(-1) : T(1);
  const D<T, N> w = sign * q.w;
  const V<T, N> u = {sign * q.x, sign * q.y, sign * q.z};
  D<T, N> k;
  if (sin_half.v < T(1e-8)) {
    k = D<T, N>::c(T(2));
  } else {
    k = T(2) * d_atan2(sin_half, w) / sin_half;
  }
  return {k * u.x, k * u.y, k * u.z};
}

enum Mode { GS = 0, SLERP = 1, NLERP = 2, LERP_AA = 3 };  // 1 + interp if RS
enum LossKind { TRIVIAL = 0, HUBER = 1, SOFT_L1 = 2, CAUCHY = 3 };

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
  int use_distortion, loss_kind;
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

// --- the row's prologue -----------------------------------------------------
//
// pro holds W pose records, then (SLERP) 2W pair records, pair (oa, rs) at
// 2 oa + rs.  Tangent j of component c sits at c * (number of tangents) + j.
constexpr int PRO_POSE = 32;   // q 4, dq 4x3, aa 3, daa 3x3, c 3, pose_free 1
constexpr int PRO_PAIR = 21;   // omega 3, domega 3x6
constexpr int PRO_VALUES = PRO_POSE + 2 * PRO_PAIR;   // per window pose
constexpr int P_AA = 16, P_C = 28, P_FREE = 31;

// normalize(q * exp(delta)) at delta = 0, delta seeded on tangents AT..AT+2
// (AT < 0: no tangent seeded, the values alone).
template <typename T, int N, int AT>
RSBA_HD Q<T, N> boxplus_seeded(const T* w) {
  V<T, N> delta = {D<T, N>::c(T(0)), D<T, N>::c(T(0)), D<T, N>::c(T(0))};
  if constexpr (AT >= 0) {
    delta.x.d[AT] = T(1);
    delta.y.d[AT + 1] = T(1);
    delta.z.d[AT + 2] = T(1);
  }
  const Q<T, N> q = {D<T, N>::c(w[0]), D<T, N>::c(w[1]), D<T, N>::c(w[2]),
                     D<T, N>::c(w[3])};
  return q_normalize(q_mul(q, from_aa(delta)));
}

// A dual's value, and with TANGENTS its tangents.
template <bool TANGENTS, typename T, int N>
RSBA_HD void store_dual(const D<T, N>& x, T* value, T* tangents) {
  *value = x.v;
  if constexpr (TANGENTS) {
#pragma unroll
    for (int j = 0; j < N; ++j) tangents[j] = x.d[j];
  }
}

// Item i of a row's prologue (win: the row's W pose windows): pose i for
// i < W, else pair i - W.  Without TANGENTS only the values are stored,
// from the same arithmetic on one-tangent duals that nothing seeds.
template <typename T, int MODE, bool TANGENTS = true>
RSBA_HD void prologue_item(const T* win, int W, int i, T* pro) {
  constexpr int NP = TANGENTS ? 3 : 1, NQ = TANGENTS ? 6 : 1;
  if (i < W) {
    const T* w = win + i * 8;
    T* p = pro + i * PRO_POSE;
    const Q<T, NP> q = boxplus_seeded<T, NP, TANGENTS ? 0 : -1>(w);
    store_dual<TANGENTS>(q.w, p + 0, p + 4);
    store_dual<TANGENTS>(q.x, p + 1, p + 7);
    store_dual<TANGENTS>(q.y, p + 2, p + 10);
    store_dual<TANGENTS>(q.z, p + 3, p + 13);
    if (MODE == LERP_AA) {
      const V<T, NP> aa = to_aa(q);
      store_dual<TANGENTS>(aa.x, p + P_AA + 0, p + P_AA + 3);
      store_dual<TANGENTS>(aa.y, p + P_AA + 1, p + P_AA + 6);
      store_dual<TANGENTS>(aa.z, p + P_AA + 2, p + P_AA + 9);
    }
    p[P_C + 0] = w[4];
    p[P_C + 1] = w[5];
    p[P_C + 2] = w[6];
    p[P_FREE] = w[7];
  } else if (MODE == SLERP) {
    const int k = i - W, oa = k >> 1, ob = oa + (k & 1);
    if (ob >= W) return;
    const Q<T, NQ> qa = boxplus_seeded<T, NQ, TANGENTS ? 0 : -1>(win + oa * 8);
    const Q<T, NQ> qb = boxplus_seeded<T, NQ, TANGENTS ? 3 : -1>(win + ob * 8);
    const V<T, NQ> om = to_aa(q_mul(q_conj(qa), qb));
    T* p = pro + W * PRO_POSE + k * PRO_PAIR;
    store_dual<TANGENTS>(om.x, p + 0, p + 3);
    store_dual<TANGENTS>(om.y, p + 1, p + 9);
    store_dual<TANGENTS>(om.z, p + 2, p + 15);
  }
}

// --- one slot -----------------------------------------------------------------

// Corrected residual, corrected and masked 2x15 Jacobian (column k at J[k]:
// rot a 0-2, trans a 3-5, rot b 6-8, trans b 9-11, point 12-14) and rho.
template <typename T>
struct Slot {
  T rt[2];
  T J[15][2];
  T rho;
};

// from_aa(v) = (w, k v) as values, with the coefficients of its
// derivative: d w / d v_j = cw v_j and d k / d v_j = ck v_j (the same
// branches as from_aa above).
template <typename T>
RSBA_HD void from_aa_values(const T* v, T& w, T& k, T& cw, T& ck) {
  const T theta_sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  if (theta_sq < T(1e-8)) {
    k = T(0.5) - theta_sq / T(48);
    w = T(1) - theta_sq / T(8);
    cw = T(-0.25);
    ck = T(-1) / T(24);
  } else {
    const T th2 = theta_sq + T(1e-16);
    const T theta = m_sqrt(th2);
    T sin_half;
    m_sincos(T(0.5) * theta, &sin_half, &w);
    k = sin_half / theta;
    cw = T(-0.5) * k;
    ck = (T(0.5) * w - k) / th2;
  }
}

// m (a row over a quaternion's 4 components) pulled back through
// from_aa at v: out_j = sum_c m_c d from_aa(v)_c / d v_j.
template <typename T>
RSBA_HD void pull_from_aa(const T* m, const T* v, T k, T cw, T ck, T* out) {
  const T mv = m[1] * v[0] + m[2] * v[1] + m[3] * v[2];
  const T c = cw * m[0] + ck * mv;
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = k * m[1 + j] + c * v[j];
}

// sum_c m_c x[c * n + j]: a row against a stored tangent block.
template <typename T>
RSBA_HD T row_dot(const T* m, int rows, const T* x, int n, int j) {
  T s = m[0] * x[j];
#pragma unroll
  for (int c = 1; c < rows; ++c) s += m[c] * x[c * n + j];
  return s;
}

// The slot's pose at row time t, as values, with what the Jacobian needs
// of the interpolation, and its camera-frame point.
template <typename T>
struct SlotGeom {
  T q[4];              // q_t = [w, x, y, z]
  T ta, tb;            // d c_t / d c_a, d c_t / d c_b
  T v[3];              // angle-axis argument of from_aa
  T e[4];              // SLERP: from_aa(t w)
  T fk, fcw, fck;      // from_aa_values coefficients
  T inv_n, sb;         // NLERP: 1 / |blend|, signed t
  T Xr[3], uxv[3], Xc[3];   // X - c_t, u x Xr, X_cam
};

// pa, pb: the prologue records of pose_a and pose_b; pw: SLERP's pair
// record (read for SLERP only).
template <typename T, int MODE>
RSBA_HD void slot_geometry(const T* pa, const T* pb, const T* pw, T t,
                           const T* X0, SlotGeom<T>& g) {
  T* q = g.q;
  g.ta = T(1);
  g.tb = T(0);
  g.fk = g.fcw = g.fck = T(0);
  g.inv_n = T(1);
  g.sb = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) g.v[j] = T(0);
  g.e[0] = T(1);
  g.e[1] = g.e[2] = g.e[3] = T(0);
  if constexpr (MODE == GS) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = pa[c];
  } else {
    g.ta = T(1) - t;
    g.tb = t;
    if constexpr (MODE == SLERP) {
#pragma unroll
      for (int j = 0; j < 3; ++j) g.v[j] = t * pw[j];
      from_aa_values(g.v, g.e[0], g.fk, g.fcw, g.fck);
#pragma unroll
      for (int j = 0; j < 3; ++j) g.e[1 + j] = g.fk * g.v[j];
      const T* e = g.e;
      q[0] = pa[0] * e[0] - pa[1] * e[1] - pa[2] * e[2] - pa[3] * e[3];
      q[1] = pa[0] * e[1] + pa[1] * e[0] + pa[2] * e[3] - pa[3] * e[2];
      q[2] = pa[0] * e[2] - pa[1] * e[3] + pa[2] * e[0] + pa[3] * e[1];
      q[3] = pa[0] * e[3] + pa[1] * e[2] - pa[2] * e[1] + pa[3] * e[0];
    } else if constexpr (MODE == NLERP) {
      const T dot = pa[0] * pb[0] + pa[1] * pb[1] + pa[2] * pb[2] + pa[3] * pb[3];
      g.sb = dot < T(0) ? -t : t;
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = g.ta * pa[c] + g.sb * pb[c];
      g.inv_n = T(1) / m_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] *= g.inv_n;
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g.v[j] = g.ta * pa[P_AA + j] + g.tb * pb[P_AA + j];
      }
      from_aa_values(g.v, q[0], g.fk, g.fcw, g.fck);
#pragma unroll
      for (int j = 0; j < 3; ++j) q[1 + j] = g.fk * g.v[j];
    }
  }

  // X_cam = R(q_t) (X - c_t) = Xr + 2 (w (u x Xr) + u x (u x Xr)).
  T* Xr = g.Xr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Xr[i] = X0[i] - (g.ta * pa[P_C + i] + g.tb * pb[P_C + i]);
  }
  const T w = q[0], u[3] = {q[1], q[2], q[3]};
  T* uxv = g.uxv;
  uxv[0] = u[1] * Xr[2] - u[2] * Xr[1];
  uxv[1] = u[2] * Xr[0] - u[0] * Xr[2];
  uxv[2] = u[0] * Xr[1] - u[1] * Xr[0];
  g.Xc[0] = Xr[0] + T(2) * (w * uxv[0] + (u[1] * uxv[2] - u[2] * uxv[1]));
  g.Xc[1] = Xr[1] + T(2) * (w * uxv[1] + (u[2] * uxv[0] - u[0] * uxv[2]));
  g.Xc[2] = Xr[2] + T(2) * (w * uxv[2] + (u[0] * uxv[1] - u[1] * uxv[0]));
}

// Perspective, distortion and intrinsics at X_cam: the residual against
// (u0, u1) and the 2x3 Jacobian M of the pixel in X_cam.
template <typename T>
struct Proj {
  T r0, r1;
  T M[2][3];
};

template <typename T>
RSBA_HD void project_slot(const T* in, T sg, int use_distortion, const T* Xc,
                          T u0, T u1, Proj<T>& pj) {
  const T iz = T(1) / Xc[2];
  const T x = sg * Xc[0] * iz, y = sg * Xc[1] * iz;
  T xd = x, yd = y, d00 = T(1), d01 = T(0), d10 = T(0), d11 = T(1);
  if (use_distortion) {
    const T k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7], k3 = in[8];
    const T r2 = x * x + y * y;
    const T radial = T(1) + r2 * (k1 + r2 * (k2 + r2 * k3));
    const T rp = k1 + r2 * (T(2) * k2 + T(3) * k3 * r2);   // d radial / d r2
    xd = x * radial + T(2) * p1 * x * y + p2 * (r2 + T(2) * x * x);
    yd = y * radial + p1 * (r2 + T(2) * y * y) + T(2) * p2 * x * y;
    d00 = radial + T(2) * x * x * rp + T(2) * p1 * y + T(6) * p2 * x;
    d01 = T(2) * x * y * rp + T(2) * p1 * x + T(2) * p2 * y;
    d10 = d01;
    d11 = radial + T(2) * y * y * rp + T(6) * p1 * y + T(2) * p2 * x;
  }
  pj.r0 = in[0] * xd + in[2] - u0;
  pj.r1 = in[1] * yd + in[3] - u1;
  pj.M[0][0] = in[0] * d00 * sg * iz;
  pj.M[0][1] = in[0] * d01 * sg * iz;
  pj.M[0][2] = -in[0] * (d00 * x + d01 * y) * iz;
  pj.M[1][0] = in[1] * d10 * sg * iz;
  pj.M[1][1] = in[1] * d11 * sg * iz;
  pj.M[1][2] = -in[1] * (d10 * x + d11 * y) * iz;
}

// The slot's pose at row time t is a value q_t (no duals here: the
// prologue holds every tangent that does not depend on t).  The 6 rotation
// columns come from the two rows of M d(R(q) Xr)/dq pulled back through
// the interpolation to the stored tangents, which costs a third of pushing
// 6 tangents forward; the other 9 columns are M R(q_t) scaled.
template <typename T, int MODE>
RSBA_HD void slot_eval(const Args<T>& a, const T* pro, int oa, int rsi, T t,
                       T u0, T u1, const T* X0, bool pt_free, Slot<T>& s) {
  const T* pa = pro + oa * PRO_POSE;
  const T* pb = pro + (oa + rsi) * PRO_POSE;
  const T* pw = pro + a.W * PRO_POSE + (2 * oa + rsi) * PRO_PAIR;  // SLERP

  SlotGeom<T> g;
  slot_geometry<T, MODE>(pa, pb, pw, t, X0, g);
  Proj<T> pj;
  project_slot(a.intr, a.projection_sign, a.use_distortion, g.Xc, u0, u1, pj);
  const T* q = g.q;
  const T ta = g.ta, tb = g.tb, fk = g.fk, fcw = g.fcw, fck = g.fck;
  const T inv_n = g.inv_n, sb = g.sb;
  const T* v = g.v;
  const T* e = g.e;
  const T* Xr = g.Xr;
  const T* uxv = g.uxv;
  const T w = q[0], u[3] = {q[1], q[2], q[3]};
  const T r0 = pj.r0, r1 = pj.r1;
  const T(&M)[2][3] = pj.M;

  // Uncorrected Jacobian.
#pragma unroll
  for (int k = 0; k < 15; ++k) s.J[k][0] = s.J[k][1] = T(0);
  const T udv = u[0] * Xr[0] + u[1] * Xr[1] + u[2] * Xr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // mg = M[r] d(R(q) Xr)/dq, with d/dw = 2 (u x Xr) and
    // d/du = 2 (-w [Xr]x + (u.Xr) I + u Xr^T - 2 Xr u^T).
    const T* m = M[r];
    const T mu = m[0] * u[0] + m[1] * u[1] + m[2] * u[2];
    const T mv = m[0] * Xr[0] + m[1] * Xr[1] + m[2] * Xr[2];
    const T mxv[3] = {m[1] * Xr[2] - m[2] * Xr[1], m[2] * Xr[0] - m[0] * Xr[2],
                      m[0] * Xr[1] - m[1] * Xr[0]};
    T mg[4];
    mg[0] = T(2) * (m[0] * uxv[0] + m[1] * uxv[1] + m[2] * uxv[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mg[1 + j] = T(2) * (udv * m[j] - w * mxv[j] + mu * Xr[j] - T(2) * mv * u[j]);
    }
    if constexpr (MODE == GS) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s.J[k][r] = row_dot(mg, 4, pa + 4, 3, k);
    } else if constexpr (MODE == NLERP) {
      // q_t = n / |n|: d q_t = (I - q_t q_t^T) d n / |n|.
      const T mq = mg[0] * q[0] + mg[1] * q[1] + mg[2] * q[2] + mg[3] * q[3];
      T mn[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) mn[c] = (mg[c] - mq * q[c]) * inv_n;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.J[k][r] = ta * row_dot(mn, 4, pa + 4, 3, k);
        s.J[6 + k][r] = sb * row_dot(mn, 4, pb + 4, 3, k);
      }
    } else if constexpr (MODE == LERP_AA) {
      T mE[3];
      pull_from_aa(mg, v, fk, fcw, fck, mE);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.J[k][r] = ta * row_dot(mE, 3, pa + P_AA + 3, 3, k);
        s.J[6 + k][r] = tb * row_dot(mE, 3, pb + P_AA + 3, 3, k);
      }
    } else {
      // q_t = qa e: d q_t = d qa e + qa d e, d e = d from_aa(t w).
      const T ma[4] = {
          mg[0] * e[0] + mg[1] * e[1] + mg[2] * e[2] + mg[3] * e[3],
          -mg[0] * e[1] + mg[1] * e[0] - mg[2] * e[3] + mg[3] * e[2],
          -mg[0] * e[2] + mg[1] * e[3] + mg[2] * e[0] - mg[3] * e[1],
          -mg[0] * e[3] - mg[1] * e[2] + mg[2] * e[1] + mg[3] * e[0]};
      const T mb[4] = {
          mg[0] * pa[0] + mg[1] * pa[1] + mg[2] * pa[2] + mg[3] * pa[3],
          -mg[0] * pa[1] + mg[1] * pa[0] + mg[2] * pa[3] - mg[3] * pa[2],
          -mg[0] * pa[2] - mg[1] * pa[3] + mg[2] * pa[0] + mg[3] * pa[1],
          -mg[0] * pa[3] + mg[1] * pa[2] - mg[2] * pa[1] + mg[3] * pa[0]};
      T mE[3];
      pull_from_aa(mb, v, fk, fcw, fck, mE);
#pragma unroll
      for (int j = 0; j < 3; ++j) mE[j] *= t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.J[k][r] = row_dot(ma, 4, pa + 4, 3, k) + row_dot(mE, 3, pw + 3, 6, k);
        s.J[6 + k][r] = row_dot(mE, 3, pw + 3, 6, 3 + k);
      }
    }
  }
  {
    // The other columns: J_X = M R(q_t), scaled by -d c_t / d c.
    const T qx = u[0], qy = u[1], qz = u[2];
    const T R[3][3] = {
        {T(1) - T(2) * (qy * qy + qz * qz), T(2) * (qx * qy - w * qz),
         T(2) * (qx * qz + w * qy)},
        {T(2) * (qx * qy + w * qz), T(1) - T(2) * (qx * qx + qz * qz),
         T(2) * (qy * qz - w * qx)},
        {T(2) * (qx * qz - w * qy), T(2) * (qy * qz + w * qx),
         T(1) - T(2) * (qx * qx + qy * qy)}};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const T jx = M[r][0] * R[0][p] + M[r][1] * R[1][p] + M[r][2] * R[2][p];
        s.J[12 + p][r] = jx;
        s.J[3 + p][r] = -ta * jx;
        if (MODE != GS) s.J[9 + p][r] = -tb * jx;
      }
    }
  }

  // Triggs correction (geometry.losses.Loss.correct).
  const T sq = r0 * r0 + r1 * r1;
  T rho1, rho2;
  loss_eval(a.loss_kind, a.loss_scale, sq, s.rho, rho1, rho2);
  s.rt[0] = r0;
  s.rt[1] = r1;
  if (a.loss_kind != TRIVIAL) {
    const T sqrt_rho1 = m_sqrt(m_max(rho1, T(1e-30)));
    const T dd = m_max(T(1) + T(2) * sq * rho2 / rho1, T(0));
    const T alpha = rho2 > T(0) ? T(1) - m_sqrt(dd) : T(0);
    const T res_scale = sqrt_rho1 / (T(1) - alpha);
    s.rt[0] = res_scale * r0;
    s.rt[1] = res_scale * r1;
    const T aos = sq > T(0) ? alpha / m_max(sq, T(1e-30)) : T(0);
#pragma unroll
    for (int k = 0; k < 15; ++k) {
      const T rTJ = r0 * s.J[k][0] + r1 * s.J[k][1];
      s.J[k][0] = sqrt_rho1 * (s.J[k][0] - aos * r0 * rTJ);
      s.J[k][1] = sqrt_rho1 * (s.J[k][1] - aos * r1 * rTJ);
    }
  }
  // Constant-block masks (selection).
  const bool pf_a = pa[P_FREE] > T(0), pf_b = pb[P_FREE] > T(0);
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    const bool keep = k < 6 ? pf_a : (k < 12 ? pf_b : pt_free);
    if (!keep) s.J[k][0] = s.J[k][1] = T(0);
  }
  // pose_b == pose_a: both sides move the same pose, so J_b joins J_a and
  // every later sum treats the slot as one with an empty b side.
  if (MODE != GS && rsi == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s.J[k][e] += s.J[6 + k][e];
        s.J[6 + k][e] = T(0);
      }
    }
  }
}

// --- what a slot adds --------------------------------------------------------

template <typename T>
RSBA_HD T dot2(const T* x, const T* y) { return x[0] * y[0] + x[1] * y[1]; }

// Row and column of entry k of a symmetric 6x6 block packed by rows of its
// upper triangle, and the inverse.
RSBA_HD constexpr int sym_row(int k) {
  return k < 6 ? 0 : k < 11 ? 1 : k < 15 ? 2 : k < 18 ? 3 : k < 20 ? 4 : 5;
}
RSBA_HD constexpr int sym_start(int i) { return 6 * i - i * (i - 1) / 2; }
RSBA_HD constexpr int sym_col(int k) {
  return k - sym_start(sym_row(k)) + sym_row(k);
}
RSBA_HD constexpr int sym_index(int i, int j) {
  return i <= j ? sym_start(i) + j - i : sym_start(j) + i - j;
}

// The window sums a slot adds at its offset oa, as one vector: aa (21
// packed), J_a^T r (6), 0.5 rho, then with rolling shutter bb (21 packed)
// and J_b^T r (6), which belong one offset later, and ab (36).
constexpr int K_AA = 0, K_GA = 21, K_COST = 27, K_BB = 28, K_GB = 49,
              K_AB = 55, K_END = 91;
constexpr int K_GS = 32, K_RS = 96;       // padded to whole 32-value passes

template <typename T>
RSBA_HD T kval(int idx, const Slot<T>& s) {
  if (idx < K_GA) return dot2(s.J[sym_row(idx)], s.J[sym_col(idx)]);
  if (idx < K_COST) return dot2(s.J[idx - K_GA], s.rt);
  if (idx == K_COST) return T(0.5) * s.rho;
  if (idx < K_GB) {
    return dot2(s.J[6 + sym_row(idx - K_BB)], s.J[6 + sym_col(idx - K_BB)]);
  }
  if (idx < K_AB) return dot2(s.J[6 + idx - K_GB], s.rt);
  if (idx < K_END) return dot2(s.J[(idx - K_AB) / 6], s.J[6 + (idx - K_AB) % 6]);
  return T(0);
}

// Point side of a slot: its column of the F tile (tile points at the
// column, rows `stride` apart), g_pt and the packed C.
template <typename T, bool RS>
RSBA_HD void add_point_side(const Slot<T>& s, int oa, int rsi, T* tile,
                            size_t stride, T* gpt, T* c6) {
#pragma unroll
  for (int p = 0; p < 3; ++p) gpt[p] += dot2(s.J[12 + p], s.rt);
  c6[0] += dot2(s.J[12], s.J[12]);
  c6[1] += dot2(s.J[12], s.J[13]);
  c6[2] += dot2(s.J[12], s.J[14]);
  c6[3] += dot2(s.J[13], s.J[13]);
  c6[4] += dot2(s.J[13], s.J[14]);
  c6[5] += dot2(s.J[14], s.J[14]);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      tile[(size_t)(oa * 18 + 3 * q + p) * stride] += dot2(s.J[q], s.J[12 + p]);
    }
  }
  if (RS && rsi != 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        tile[(size_t)((oa + 1) * 18 + 3 * q + p) * stride] +=
            dot2(s.J[6 + q], s.J[12 + p]);
      }
    }
  }
}

// Sum over the nw per-warp accumulators, in warp order.
template <typename T>
RSBA_HD T acc_sum(const T* acc, int nw, int W, int KS, int w, int idx) {
  T s = T(0);
  for (int p = 0; p < nw; ++p) s += acc[((size_t)p * W + w) * KS + idx];
  return s;
}

// Writes the row's window sums from the accumulators (thread i of n): bb
// and J_b^T r move one offset up, symmetric blocks are mirrored.
template <typename T, bool RS>
RSBA_HD void write_sums(const Args<T>& a, int r, const T* acc, int nw, int i,
                        int n) {
  constexpr int KS = RS ? K_RS : K_GS;
  const int W = a.W;
  for (int j = i; j < 6 * W; j += n) {
    const int w = j / 6, q = j % 6;
    T s = acc_sum(acc, nw, W, KS, w, K_GA + q);
    if (RS && w > 0) s += acc_sum(acc, nw, W, KS, w - 1, K_GB + q);
    a.gw[(size_t)r * 6 * W + j] = s;
  }
  for (int j = i; j < 36 * W; j += n) {
    const int w = j / 36, q = (j % 36) / 6, b = j % 6;
    const int k = sym_index(q, b);
    T s = acc_sum(acc, nw, W, KS, w, K_AA + k);
    if (RS && w > 0) s += acc_sum(acc, nw, W, KS, w - 1, K_BB + k);
    a.b0[(size_t)r * 36 * W + j] = s;
    a.b1[(size_t)r * 36 * W + j] =
        RS ? acc_sum(acc, nw, W, KS, w, K_AB + q * 6 + b) : T(0);
  }
  if (i == 0) {
    T c = T(0);
    for (int w = 0; w < W; ++w) c += acc_sum(acc, nw, W, KS, w, K_COST);
    a.cost[r] = c;
  }
}

// Shared memory of one block, in values: prologue, one accumulator per
// warp, then the F tile, each part padded to 16 bytes.
RSBA_HD constexpr size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }
RSBA_HD constexpr size_t smem_head(int W, int warps, int KS) {
  return round4((size_t)W * (PRO_VALUES + warps * KS));
}
RSBA_HD constexpr size_t smem_values(int W, int warps, int KS, int tile_cols) {
  return smem_head(W, warps, KS) + round4((size_t)W * 18 * tile_cols);
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

// One exchange of the butterfly: 2 HALF values a lane become HALF.
template <typename T, int HALF>
__device__ __forceinline__ void fold_step(T* v, bool upper, int lane_mask) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, lane_mask);
  }
}

// A pass reduces PW of the slot's values at a time: 32 for float, 16 for
// double, whose values take two registers each.
template <typename T> struct PassWidth { static constexpr int value = 32; };
template <> struct PassWidth<double> { static constexpr int value = 16; };

template <typename T, int PW, int HALF>
__device__ __forceinline__ void fold_all(T* v, int lane) {
  if constexpr (HALF >= 1) {
    fold_step<T, HALF>(v, lane & (PW / (2 * HALF)), PW / (2 * HALF));
    fold_all<T, PW, HALF / 2>(v, lane);
  }
}

// Adds the warp's sum of kval(PW PASS + i) over its lanes, for i < PW, to
// dst[PW PASS + i].  After the exchanges lane l (l < PW) holds entry
// bit_reverse(l), an address of dst that only this lane ever touches; with
// PW = 16 the two half-warps are summed by one more exchange.
template <typename T, int PASS>
__device__ __forceinline__ void warp_pass(const Slot<T>& s, int lane, T* dst) {
  constexpr int PW = PassWidth<T>::value;
  T v[PW];
#pragma unroll
  for (int i = 0; i < PW; ++i) v[i] = kval(PW * PASS + i, s);
  fold_all<T, PW, PW / 2>(v, lane);
  if (PW == 16) v[0] += __shfl_xor_sync(FULL, v[0], 16);
  if (lane < PW) {
    dst[PW * PASS + (__brev((unsigned)lane) >> (PW == 32 ? 27 : 28))] += v[0];
  }
}

// Every pass of the slot's K values.
template <typename T, int K, int PASS = 0>
__device__ __forceinline__ void warp_passes(const Slot<T>& s, int lane, T* dst) {
  if constexpr (PASS * PassWidth<T>::value < K) {
    warp_pass<T, PASS>(s, lane, dst);
    warp_passes<T, K, PASS + 1>(s, lane, dst);
  }
}

// One slot's inputs; every field is read whether or not the slot is valid
// (the addresses are), so that the loads need not wait for the mask.
template <typename T>
struct SlotIn {
  bool valid;
  int oa, rsi;
  T t, u0, u1;
};

template <typename T, bool RS>
__device__ __forceinline__ SlotIn<T> load_slot(const Args<T>& a, int r, int l,
                                               int g, bool column) {
  SlotIn<T> in = {false, 0, 0, T(0), T(0), T(0)};
  if (column) {
    const size_t idx = ((size_t)r * a.L + l) * a.G + g;
    in.valid = a.mask[idx] > T(0);
    in.oa = a.offs[idx];
    in.rsi = RS ? (int)a.rsf[idx] : 0;
    in.t = a.tt[idx];
    in.u0 = a.uv[(((size_t)r * 2 + 0) * a.L + l) * a.G + g];
    in.u1 = a.uv[(((size_t)r * 2 + 1) * a.L + l) * a.G + g];
  }
  return in;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(128)
fused_kernel(Args<T> a, int tile_cols, int vec_store) {
  constexpr bool RS = MODE != GS;
  constexpr int KS = RS ? K_RS : K_GS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, L = a.L, G = a.G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int r = blockIdx.x;
  T* pro = reinterpret_cast<T*>(smem_raw);
  T* acc = pro + (size_t)W * PRO_VALUES;
  T* tile = pro + smem_head(W, nw, KS);
  const int n_tile16 =
      (int)(round4((size_t)W * 18 * tile_cols) * sizeof(T) / 16);

  for (int i = tid; i < nw * W * KS; i += nt) acc[i] = T(0);
  for (int i = tid; i < 3 * W; i += nt) {
    prologue_item<T, MODE>(a.win + (size_t)r * W * 8, W, i, pro);
  }
  T* my_acc = acc + (size_t)warp * W * KS;

  for (int g0 = 0; g0 < G; g0 += nt) {
    for (int i = tid; i < n_tile16; i += nt) {
      reinterpret_cast<int4*>(tile)[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();   // prologue (first chunk), tile zeroed

    const int g = g0 + tid;
    const bool column = g < G;
    T X0[3] = {T(0), T(0), T(0)};
    bool pt_free = false;
    if (column) {
#pragma unroll
      for (int i = 0; i < 3; ++i) X0[i] = a.pts[((size_t)r * 3 + i) * G + g];
      pt_free = a.ptf[(size_t)r * G + g] > T(0);
    }
    T gpt[3] = {T(0), T(0), T(0)};
    T c6[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};

    // A slot's inputs are loaded one slot ahead of their use.
    SlotIn<T> next = load_slot<T, RS>(a, r, 0, g, column);
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const SlotIn<T> in = next;
      if (l + 1 < L) next = load_slot<T, RS>(a, r, l + 1, g, column);
      const bool valid = in.valid;
      unsigned todo = __ballot_sync(FULL, valid);
      if (todo == 0) continue;
      Slot<T> s;
      const int oa = valid ? in.oa : -1;
      if (valid) {
        slot_eval<T, MODE>(a, pro, oa, in.rsi, in.t, in.u0, in.u1, X0,
                           pt_free, s);
        add_point_side<T, RS>(s, oa, in.rsi, tile + tid, (size_t)tile_cols,
                              gpt, c6);
      }
      // Window sums: one butterfly per offset present in the warp, lanes
      // outside the group adding zeros.
      while (todo) {
        const int k = __shfl_sync(FULL, oa, __ffs(todo) - 1);
        const bool member = valid && oa == k;
        todo &= ~__ballot_sync(FULL, member);
        Slot<T> m;
#pragma unroll
        for (int c = 0; c < 15; ++c) {
          m.J[c][0] = member ? s.J[c][0] : T(0);
          m.J[c][1] = member ? s.J[c][1] : T(0);
        }
        m.rt[0] = member ? s.rt[0] : T(0);
        m.rt[1] = member ? s.rt[1] : T(0);
        m.rho = member ? s.rho : T(0);
        T* dst = my_acc + (size_t)k * KS;
        warp_passes<T, RS ? K_END : K_BB>(m, lane, dst);
      }
    }

    if (column) {
#pragma unroll
      for (int p = 0; p < 3; ++p) a.gpt[((size_t)r * 3 + p) * G + g] = gpt[p];
#pragma unroll
      for (int i = 0; i < 6; ++i) a.c6[((size_t)r * 6 + i) * G + g] = c6[i];
    }
    __syncthreads();   // tile complete

    // The chunk's tile leaves the block once.
    T* Frow = a.F + (size_t)r * W * 18 * G;
    if (vec_store) {   // one chunk spans the row: tile and F[r] coincide
      const int n16 = (int)((size_t)W * 18 * G * sizeof(T) / 16);
      for (int i = tid; i < n16; i += nt) {
        reinterpret_cast<int4*>(Frow)[i] = reinterpret_cast<const int4*>(tile)[i];
      }
    } else {
      const int tw = min(tile_cols, G - g0);
      for (int row = warp; row < W * 18; row += nw) {
        for (int c = lane; c < tw; c += 32) {
          Frow[(size_t)row * G + g0 + c] = tile[(size_t)row * tile_cols + c];
        }
      }
    }
    __syncthreads();   // tile free for the next chunk
  }
  write_sums<T, RS>(a, r, acc, nw, tid, nt);
}

template <typename T, int MODE>
int run(const Args<T>& a, int threads, int tile_cols, int smem_bytes,
        void* stream) {
  constexpr int KS = MODE != GS ? K_RS : K_GS;
  if (threads < 32 || threads > 128 || threads % 32 != 0 ||
      tile_cols != (threads < a.G ? threads : a.G)) {
    return -1;
  }
  if ((size_t)smem_bytes != smem_values(a.W, threads / 32, KS, tile_cols) * sizeof(T)) {
    return -2;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec_store = tile_cols == a.G &&
                        ((size_t)a.W * 18 * a.G * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.F) % 16 == 0;
  fused_kernel<T, MODE><<<a.NR, threads, smem_bytes, (cudaStream_t)stream>>>(
      a, tile_cols, vec_store);
  return (int)cudaGetLastError();
}

#else  // plain C++: the same arithmetic in a sequential loop

template <typename T, int MODE>
int run(const Args<T>& a, int, int, int, void*) {
  constexpr bool RS = MODE != GS;
  constexpr int KS = RS ? K_RS : K_GS;
  const int W = a.W, L = a.L, G = a.G;
  std::vector<T> pro((size_t)W * PRO_VALUES), acc((size_t)W * KS);
  for (int r = 0; r < a.NR; ++r) {
    for (size_t i = 0; i < acc.size(); ++i) acc[i] = T(0);
    for (int i = 0; i < 3 * W; ++i) {
      prologue_item<T, MODE>(a.win + (size_t)r * W * 8, W, i, pro.data());
    }
    T* Frow = a.F + (size_t)r * W * 18 * G;
    for (size_t i = 0; i < (size_t)W * 18 * G; ++i) Frow[i] = T(0);
    for (int g = 0; g < G; ++g) {
      const T X0[3] = {a.pts[((size_t)r * 3 + 0) * G + g],
                       a.pts[((size_t)r * 3 + 1) * G + g],
                       a.pts[((size_t)r * 3 + 2) * G + g]};
      const bool pt_free = a.ptf[(size_t)r * G + g] > T(0);
      T gpt[3] = {T(0), T(0), T(0)};
      T c6[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int l = 0; l < L; ++l) {
        const size_t idx = ((size_t)r * L + l) * G + g;
        if (!(a.mask[idx] > T(0))) continue;
        const int oa = a.offs[idx];
        const int rsi = RS ? (int)a.rsf[idx] : 0;
        Slot<T> s;
        slot_eval<T, MODE>(a, pro.data(), oa, rsi, a.tt[idx],
                           a.uv[(((size_t)r * 2 + 0) * L + l) * G + g],
                           a.uv[(((size_t)r * 2 + 1) * L + l) * G + g], X0,
                           pt_free, s);
        add_point_side<T, RS>(s, oa, rsi, Frow + g, (size_t)G, gpt, c6);
        for (int k = 0; k < (RS ? K_END : K_BB); ++k) {
          acc[(size_t)oa * KS + k] += kval(k, s);
        }
      }
      for (int p = 0; p < 3; ++p) a.gpt[((size_t)r * 3 + p) * G + g] = gpt[p];
      for (int i = 0; i < 6; ++i) a.c6[((size_t)r * 6 + i) * G + g] = c6[i];
    }
    write_sums<T, RS>(a, r, acc.data(), 1, 0, 1);
  }
  return 0;
}

#endif

template <typename T>
int dispatch(const Args<T>& a, int rolling_shutter, int interp, int threads,
             int tile_cols, int smem_bytes, void* stream) {
  switch (rolling_shutter ? 1 + interp : (int)GS) {
    case GS: return run<T, GS>(a, threads, tile_cols, smem_bytes, stream);
    case SLERP: return run<T, SLERP>(a, threads, tile_cols, smem_bytes, stream);
    case NLERP: return run<T, NLERP>(a, threads, tile_cols, smem_bytes, stream);
    case LERP_AA:
      return run<T, LERP_AA>(a, threads, tile_cols, smem_bytes, stream);
  }
  return -3;
}

// --- the residual pass ------------------------------------------------------
//
// rho of every slot of the grid and the row sums of the pairwise decrease
// 0.5 (rho_ref - rho) over the valid slots, from the same prologue,
// geometry, projection and loss as the fused kernel's slots (values only).

template <typename T>
struct RArgs {
  const T* win;
  const T* pts;
  const T* uv;
  const T* tt;
  const T* mask;
  const int* offs;
  const T* rsf;
  const T* intr;
  const T* rho_ref;   // may be null: rho_ref = 0
  int NR, W, L, G;
  int use_distortion, loss_kind;
  T projection_sign, loss_scale;
  T* rho;             // (NR, L, G), 0 on padded slots
  T* dec;             // (NR) 0.5 sum over valid slots of (rho_ref - rho)
};

// One slot's inputs; every field is read whether or not the slot is valid
// (the addresses are), so that the loads need not wait for the mask.
template <typename T>
struct RSlotIn {
  bool valid;
  int oa, rsi;
  T t, u0, u1, ref;
};

template <typename T, bool RS>
RSBA_HD RSlotIn<T> load_rslot(const RArgs<T>& a, int r, int l, int g) {
  const size_t idx = ((size_t)r * a.L + l) * a.G + g;
  RSlotIn<T> in;
  in.valid = a.mask[idx] > T(0);
  in.oa = a.offs[idx];
  in.rsi = RS ? (int)a.rsf[idx] : 0;
  in.t = a.tt[idx];
  in.u0 = a.uv[(((size_t)r * 2 + 0) * a.L + l) * a.G + g];
  in.u1 = a.uv[(((size_t)r * 2 + 1) * a.L + l) * a.G + g];
  in.ref = a.rho_ref != nullptr ? a.rho_ref[idx] : T(0);
  return in;
}

// rho of a valid slot, from the row's prologue (values only).
template <typename T, int MODE>
RSBA_HD T slot_rho(const RArgs<T>& a, const T* pro, const RSlotIn<T>& in,
                   const T* X0) {
  const T* pa = pro + in.oa * PRO_POSE;
  const T* pb = pro + (in.oa + in.rsi) * PRO_POSE;
  const T* pw = pro + a.W * PRO_POSE + (2 * in.oa + in.rsi) * PRO_PAIR;
  SlotGeom<T> g;
  slot_geometry<T, MODE>(pa, pb, pw, in.t, X0, g);
  Proj<T> pj;
  project_slot(a.intr, a.projection_sign, a.use_distortion, g.Xc, in.u0,
               in.u1, pj);
  const T sq = pj.r0 * pj.r0 + pj.r1 * pj.r1;
  T rho, rho1, rho2;
  loss_eval(a.loss_kind, a.loss_scale, sq, rho, rho1, rho2);
  return rho;
}

// Column g of row r: writes rho over its L slots (a slot's inputs loaded
// one slot ahead of their use) and returns its sum of rho_ref - rho over
// the valid ones, in slot order.  A padded slot is skipped before any
// arithmetic (its sentinel point can project to 0/0).
template <typename T, int MODE>
RSBA_HD T residual_column(const RArgs<T>& a, const T* pro, int r, int g) {
  constexpr bool RS = MODE != GS;
  const int L = a.L, G = a.G;
  const T X0[3] = {a.pts[((size_t)r * 3 + 0) * G + g],
                   a.pts[((size_t)r * 3 + 1) * G + g],
                   a.pts[((size_t)r * 3 + 2) * G + g]};
  T dec = T(0);
  RSlotIn<T> next = load_rslot<T, RS>(a, r, 0, g);
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    const RSlotIn<T> in = next;
    if (l + 1 < L) next = load_rslot<T, RS>(a, r, l + 1, g);
    T rho = T(0);
    if (in.valid) {
      rho = slot_rho<T, MODE>(a, pro, in, X0);
      dec += in.ref - rho;
    }
    a.rho[((size_t)r * L + l) * G + g] = rho;
  }
  return dec;
}

// Shared memory of one residual block, in values: the prologues of its
// rows, then one partial sum per thread.
RSBA_HD constexpr size_t residual_smem_values(int W, int rows, int threads) {
  return round4((size_t)rows * W * PRO_VALUES) + (size_t)threads;
}

#ifdef __CUDACC__

// A block takes R = rows_per_block consecutive rows, thread j the column
// j % E of row j / E with E = min(G, threads) (with R = 1 and G wider than
// the block, a thread walks the columns j, j + E, ...).  The block's
// threads first fill its rows' prologues, then run their columns; each
// row's partials are summed by one warp, lanes striding in a fixed order
// and then a butterfly, so two launches on the same inputs give the same
// bits.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
residual_kernel(RArgs<T> a, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, G = a.G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, a.NR - r0);
  T* pro = reinterpret_cast<T*>(smem_raw);
  T* part = pro + round4((size_t)rows_per_block * W * PRO_VALUES);

  for (int i = tid; i < rows * 3 * W; i += nt) {
    const int k = i / (3 * W), j = i - k * 3 * W;
    prologue_item<T, MODE, false>(a.win + (size_t)(r0 + k) * W * 8, W, j,
                                  pro + (size_t)k * W * PRO_VALUES);
  }
  __syncthreads();

  const int E = min(G, nt);
  const int k = tid / E, gc = tid - k * E;
  T dec = T(0);
  if (k < rows) {
    const T* rpro = pro + (size_t)k * W * PRO_VALUES;
    for (int g = gc; g < G; g += E) {
      dec += residual_column<T, MODE>(a, rpro, r0 + k, g);
    }
  }
  part[tid] = dec;
  __syncthreads();

  for (int kk = warp; kk < rows; kk += nw) {
    T s = T(0);
    for (int i = lane; i < E; i += 32) s += part[(size_t)kk * E + i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL, s, m);
    if (lane == 0) a.dec[r0 + kk] = T(0.5) * s;
  }
}

template <typename T, int MODE>
int run_residual(const RArgs<T>& a, int threads, int rows_per_block,
                 int smem_bytes, void* stream) {
  if (threads < 32 || threads > 256 || threads % 32 != 0 ||
      rows_per_block < 1 ||
      (rows_per_block > 1 && rows_per_block * a.G > threads)) {
    return -1;
  }
  if ((size_t)smem_bytes !=
      residual_smem_values(a.W, rows_per_block, threads) * sizeof(T)) {
    return -2;
  }
  if (a.NR == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      residual_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.NR + rows_per_block - 1) / rows_per_block;
  residual_kernel<T, MODE><<<blocks, threads, smem_bytes,
                             (cudaStream_t)stream>>>(a, rows_per_block);
  return (int)cudaGetLastError();
}

#else  // plain C++: the same arithmetic in a sequential loop

template <typename T, int MODE>
int run_residual(const RArgs<T>& a, int, int, int, void*) {
  std::vector<T> pro((size_t)a.W * PRO_VALUES);
  for (int r = 0; r < a.NR; ++r) {
    for (int i = 0; i < 3 * a.W; ++i) {
      prologue_item<T, MODE, false>(a.win + (size_t)r * a.W * 8, a.W, i,
                                    pro.data());
    }
    T dec = T(0);
    for (int g = 0; g < a.G; ++g) {
      dec += residual_column<T, MODE>(a, pro.data(), r, g);
    }
    a.dec[r] = T(0.5) * dec;
  }
  return 0;
}

#endif

template <typename T>
int dispatch_residual(const RArgs<T>& a, int rolling_shutter, int interp,
                      int threads, int rows_per_block, int smem_bytes,
                      void* stream) {
  switch (rolling_shutter ? 1 + interp : (int)GS) {
    case GS:
      return run_residual<T, GS>(a, threads, rows_per_block, smem_bytes,
                                 stream);
    case SLERP:
      return run_residual<T, SLERP>(a, threads, rows_per_block, smem_bytes,
                                    stream);
    case NLERP:
      return run_residual<T, NLERP>(a, threads, rows_per_block, smem_bytes,
                                    stream);
    case LERP_AA:
      return run_residual<T, LERP_AA>(a, threads, rows_per_block, smem_bytes,
                                      stream);
  }
  return -3;
}

}  // namespace rsba

// threads, tile_cols and smem_bytes are the launch plan of
// rsba_tpu_torch/kernels/fused.py::launch_plan (ignored by the C++ build).
// Returns 0, a cudaError, or a negative code for a plan that does not match
// the shape.
#define RSBA_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* win, const T* pts, const T* ptf, const T* uv,  \
                      const T* tt, const T* mask, const int* offs,            \
                      const T* rsf, const T* intr, int NR, int W, int L,      \
                      int G, int rolling_shutter, int interp,                 \
                      int use_distortion, int loss_kind,                      \
                      double projection_sign, double loss_scale, T* cost,     \
                      T* gw, T* b0, T* b1, T* gpt, T* c6, T* F, int threads,  \
                      int tile_cols, int smem_bytes, void* stream) {          \
    rsba::Args<T> a{win, pts, ptf, uv, tt, mask, offs, rsf, intr, NR, W, L,   \
                    G, use_distortion, loss_kind, (T)projection_sign,         \
                    (T)loss_scale, cost, gw, b0, b1, gpt, c6, F};             \
    return rsba::dispatch<T>(a, rolling_shutter, interp, threads, tile_cols,  \
                             smem_bytes, stream);                             \
  }
RSBA_ENTRY(rsba_fused_evaluate_assemble_f32, float)
RSBA_ENTRY(rsba_fused_evaluate_assemble_f64, double)

// The residual pass: rho (NR, L, G) and dec (NR) from the fused kernel's
// inputs less ptf, and rho_ref (NR, L, G) or null.  threads,
// rows_per_block and smem_bytes are the launch plan of
// rsba_tpu_torch/kernels/fused.py::residual_plan (ignored by the C++
// build).  Returns as the entry points above.
#define RSBA_RESIDUAL_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* win, const T* pts, const T* uv, const T* tt,   \
                      const T* mask, const int* offs, const T* rsf,           \
                      const T* intr, const T* rho_ref, int NR, int W, int L,  \
                      int G, int rolling_shutter, int interp,                 \
                      int use_distortion, int loss_kind,                      \
                      double projection_sign, double loss_scale, T* rho,      \
                      T* dec, int threads, int rows_per_block,                \
                      int smem_bytes, void* stream) {                         \
    rsba::RArgs<T> a{win, pts, uv, tt, mask, offs, rsf, intr, rho_ref, NR, W, \
                     L, G, use_distortion, loss_kind, (T)projection_sign,     \
                     (T)loss_scale, rho, dec};                                \
    return rsba::dispatch_residual<T>(a, rolling_shutter, interp, threads,    \
                                      rows_per_block, smem_bytes, stream);    \
  }
RSBA_RESIDUAL_ENTRY(rsba_residual_pass_f32, float)
RSBA_RESIDUAL_ENTRY(rsba_residual_pass_f64, double)
