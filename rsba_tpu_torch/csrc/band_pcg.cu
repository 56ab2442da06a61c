// Preconditioned conjugate gradients on the banded reduced camera system,
// CUDA C++ for sm_90a: the whole solve in one launch.
//
// Replaces no TPU kernel.  The reference runs PCG as XLA ops
// (rsba_tpu/solver/pcg.py::pcg over the band product of
// rsba_tpu/solver/banded.py).  The port ran the same loop as PyTorch ops
// (rsba_tpu_torch/solver/pcg.py::pcg): 100 masked passes of about 26 small
// kernels each, about 2,600 nodes of the step attempt's CUDA graph.  At
// config 4 they took 5.4 of an attempt's 10.5 ms, about 2 us a node with
// almost no arithmetic, and most of the graph that each solve captures.
//
// What it computes: S x = b for the symmetric block band S with the
// block-Jacobi preconditioner (the 6x6 inverses of S's diagonal blocks),
// with the meaning of rsba_tpu_torch/solver/pcg.py::pcg: stop when
// ||r|| <= eta ||b|| or after max_iterations passes; alpha and beta freeze
// at 0 when p^T q <= 0 or r^T z <= 0, and ||r|| then reads -1, which ends
// the loop; iters counts the live passes.  The loop ends on the device as
// soon as the test fails, which leaves the state that the masked passes
// would have frozen.
//
// Inputs: rows (P, 6, C), C = 6 (2W - 1), pose p's block row of S over the
// 2W - 1 poses nbr (P, 2W - 1) int64, as solver/banded.py::band_rows lays
// them out (every neighbour within W - 1 poses of its row); minv (P, 6, 6);
// b (6P).  Outputs: x, r (6P) and iters (one int).
//
// Bound: a live pass reads the rows once (3.03 MB at config 4 in float32:
// P = 1001, W = 11), the inverses (0.14 MB) and a few 24 KB vectors, about
// 1 us at 3.35 TB/s.  What holds it back is the chain from pass to pass:
// a pass needs two sums over the whole vector (p^T q, then r^T z with
// ||r||) before the next pass can start.
//
// Design: one thread block cluster (16 CTAs where the card can run them,
// else 8; one SM each) runs every pass, and nothing returns to the host in
// between.
// * Each CTA owns a contiguous range of poses and keeps its share of x, r
//   and q in shared memory, and p and z over its poses and the W - 1 poses
//   either side, which the band product reads.  The owner of a pose stores
//   each new z into the halo of the CTAs that hold it, through distributed
//   shared memory, before the barrier that ends the pass; every CTA then
//   forms p = z + beta p over its poses and halo itself, the same bits as
//   the owner.  Nothing is read from another CTA but the partial sums.
// * The band product gives a warp a pose: the lanes walk the row's columns
//   (coalesced) with six row sums each, and fold them by a butterfly that
//   halves the values with each exchange (9 shuffles).  The rows stay in
//   shared memory for the whole solve where the CTA's share fits (config 4
//   in float32: 63 poses, 190 KB); otherwise they stream from L2, which
//   holds them, on every pass.  Each block column's offset into p is
//   worked out once, at the start.
// * Sums in a fixed order, no atomics: a warp's shuffle tree, the warps in
//   order by warp 0, the CTA's partial in its shared memory; after the
//   cluster barrier warp 0 of every CTA reads the partials in rank order
//   and folds them by the same tree.  Every thread holds the same bits and
//   takes the same branch at the loop's end, and two launches on the same
//   inputs give the same bits.
// * Two cluster barriers a pass: after p^T q, and after r^T z and ||r||,
//   which also publishes the halo's z for the next pass.
//
// Built with nvcc into a shared library with a plain C interface
// (rsba_tpu_torch/kernels/build.py) and called through ctypes from
// rsba_tpu_torch/kernels/band_pcg.py, which holds the plain version.

#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace rsba_band {

constexpr int NT = 1024;        // threads of a CTA
constexpr int NW = NT / 32;     // its warps, whose partial sums warp 0 folds
static_assert(NW <= 32, "one warp folds the warps' partial sums");
constexpr int DOF = 6;          // values a pose
constexpr int GROUP = 5;        // poses a warp updates at once, six lanes each
constexpr int MAX_CLUSTER = 16;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Args {
  const T* rows;
  const long long* nbr;
  const T* minv;
  const T* b;
  int P, W, max_iterations;
  int ppc;                      // poses a CTA owns (the last CTA fewer)
  T eta;
  T* x;
  T* r;
  int* iters;
};

// Shared memory: in values of T, p and z over the poses and their halo,
// then q, r and x over the poses, the warps' partial sums (3 NW), the
// CTA's (3, padded to 4) and the cluster's (4); then the column offsets of
// the CTA's band rows (ints); then, 16-byte aligned, the CTA's rows where
// they are kept.  rsba_tpu_torch/kernels/band_pcg.py::smem_bytes mirrors
// this.
__host__ __device__ constexpr size_t state_values(int ppc, int W) {
  return (size_t)2 * (ppc + 2 * (W - 1)) * DOF + (size_t)3 * ppc * DOF +
         3 * NW + 8;
}

__host__ __device__ constexpr size_t head_bytes(int ppc, int W, size_t item) {
  return state_values(ppc, W) * item + (size_t)ppc * (2 * W - 1) * sizeof(int);
}

__host__ __device__ constexpr size_t rows_offset(int ppc, int W, size_t item) {
  return (head_bytes(ppc, W, item) + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t smem_bytes(int ppc, int W, size_t item,
                                                bool rows_in_smem) {
  return rows_in_smem ? rows_offset(ppc, W, item) +
                            (size_t)ppc * DOF * DOF * (2 * W - 1) * item
                      : head_bytes(ppc, W, item);
}

__device__ __forceinline__ float m_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double m_fma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// One exchange of the butterfly: 2 HALF values a lane become HALF.
template <typename T, int HALF>
__device__ __forceinline__ void fold_step(T (&v)[8], bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// Sums v[e] (e < 8) over the warp; lanes 4e..4e+3 then hold entry e in v[0].
template <typename T>
__device__ __forceinline__ void fold8(T (&v)[8], int lane) {
  fold_step<T, 4>(v, lane & 16, 16);
  fold_step<T, 2>(v, lane & 8, 8);
  fold_step<T, 1>(v, lane & 4, 4);
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
}

// Sums every thread's v[n] over the cluster: a warp's tree, the warps in
// order (warp 0, into this CTA's cpart[n]), then after the cluster barrier
// the CTAs in rank order (warp 0, into total[n]), which every thread
// reads.  Every thread of every CTA gets the same bits.  wpart, cpart and
// total are this sum's own slots: a neighbour's warp 0 may read cpart
// until it reaches the next cluster barrier.
template <typename T, int N>
__device__ __forceinline__ void cluster_sum(T (&v)[N], T* wpart, T* cpart,
                                            T* total,
                                            cg::cluster_group& cluster,
                                            int lane, int warp, int ncta) {
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) wpart[n * NW + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T s = warp_sum(lane < NW ? wpart[n * NW + lane] : T(0));
      if (lane == 0) cpart[n] = s;
    }
  }
  cluster.sync();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T s = warp_sum(
          lane < ncta ? *cluster.map_shared_rank(cpart + n, lane) : T(0));
      if (lane == 0) total[n] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = total[n];
}

// q = S p on the CTA's poses, a warp a pose; pe is p over the poses and
// their halo, nb each block column's offset into pe.  Returns the lane's
// share of p^T q.
template <typename T, bool ROWS_SM>
__device__ __forceinline__ T band_product(int K, const T* rows, const int* nb,
                                          const T* pe, int n_own, int own_off,
                                          T* q, int lane, int warp) {
  const int C = K * DOF;
  T pq = T(0);
  for (int pl = warp; pl < n_own; pl += NW) {
    const T* row = rows + (size_t)pl * DOF * C;
    const int* nbo = nb + pl * K;
    T v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = T(0);
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const int kb = c / DOF;
      const T pv = pe[nbo[kb] + c - kb * DOF];
#pragma unroll
      for (int i = 0; i < DOF; ++i) {
        T s;
        if constexpr (ROWS_SM) {
          s = row[i * C + c];
        } else {
          s = __ldg(row + i * C + c);
        }
        v[i] = m_fma(s, pv, v[i]);
      }
    }
    fold8(v, lane);
    if (lane < 4 * DOF && (lane & 3) == 0) {
      const int o = pl * DOF + (lane >> 2);
      q[o] = v[0];
      pq = m_fma(pe[own_off * DOF + o], v[0], pq);
    }
  }
  return pq;
}

// Where the poses of a CTA and their halo lie.
struct Range {
  int lo, n_own, ext_lo, n_ext;
  __device__ Range(int rank, int ppc, int H, int P) {
    lo = rank * ppc;
    n_own = max(0, min(ppc, P - lo));
    ext_lo = max(lo - H, 0);
    n_ext = n_own > 0 ? min(lo + n_own + H, P) - ext_lo : 0;
  }
};

// x += alpha p, r -= alpha q and z = M^-1 r on the CTA's poses (at the
// start x = 0, r = b, z = M^-1 b), five poses a warp at once, six lanes a
// pose.  pe and ze are p and z over the poses and their halo; each new z
// is also stored into the halo of every CTA whose halo holds its pose.
// Adds the lane's shares of r^T z and r^T r to rz and rr.
template <typename T>
__device__ __forceinline__ void update_own(const Args<T>& a, bool start,
                                           T alpha, const Range& own,
                                           int rank, int ncta,
                                           cg::cluster_group& cluster,
                                           const T* pe, T* ze, const T* q,
                                           T* x, T* r, int lane, int warp,
                                           T& rz, T& rr) {
  const int H = a.W - 1, ppc = a.ppc, reach = (H + ppc - 1) / ppc;
  const int own_off = own.lo - own.ext_lo;
  const int s = lane / DOF, i = lane - s * DOF;
  for (int g = warp * GROUP; g < own.n_own; g += NW * GROUP) {
    const int pl = g + s;
    const bool on = s < GROUP && pl < own.n_own;
    const int o = pl * DOF + i;
    T ri = T(0);
    if (on) {
      if (start) {
        ri = a.b[(size_t)own.lo * DOF + o];
        x[o] = T(0);
      } else {
        x[o] = m_fma(alpha, pe[own_off * DOF + o], x[o]);
        ri = m_fma(-alpha, q[o], r[o]);
      }
      r[o] = ri;
    }
    T zi = T(0);
    const T* m = a.minv + ((size_t)(own.lo + pl) * DOF + i) * DOF;
#pragma unroll
    for (int j = 0; j < DOF; ++j) {
      const T rj = __shfl_sync(FULL, ri, (s * DOF + j) & 31);
      if (on) zi = m_fma(__ldg(m + j), rj, zi);
    }
    if (on) {
      ze[own_off * DOF + o] = zi;
      rz = m_fma(ri, zi, rz);
      rr = m_fma(ri, ri, rr);
      const int j = own.lo + pl;
      for (int c = max(0, rank - reach); c <= min(ncta - 1, rank + reach);
           ++c) {
        const Range other(c, ppc, H, a.P);
        if (c != rank && j >= other.ext_lo &&
            j < other.ext_lo + other.n_ext) {
          *cluster.map_shared_rank(ze + (j - other.ext_lo) * DOF + i, c) = zi;
        }
      }
    }
  }
}

template <typename T, bool ROWS_SM>
__global__ void __launch_bounds__(NT, 1) band_pcg_kernel(Args<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int W = a.W, H = W - 1, K = 2 * W - 1, C = K * DOF, ppc = a.ppc;
  const int E = ppc + 2 * H;
  T* const pe = sm;                   // p over the poses and the halo
  T* const ze = pe + E * DOF;         // z over the poses and the halo
  T* const q = ze + E * DOF;
  T* const r = q + ppc * DOF;
  T* const x = r + ppc * DOF;
  T* const wpart = x + ppc * DOF;     // NW for p^T q, 2 NW for r^T z, r^T r
  T* const cpart = wpart + 3 * NW;    // the CTA's: p^T q, r^T z, r^T r
  T* const total = cpart + 4;         // the cluster's
  int* const nb = reinterpret_cast<int*>(sm + state_values(ppc, W));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  const Range own(rank, ppc, H, a.P);
  const int own_off = own.lo - own.ext_lo;

  // Each block column's offset into pe; nbr lies in the halo for
  // band_rows' layout, and the clamp only keeps other input inside.
  for (int i = tid; i < own.n_own * K; i += NT) {
    const int e = (int)a.nbr[(size_t)own.lo * K + i] - own.ext_lo;
    nb[i] = min(max(e, 0), own.n_ext - 1) * DOF;
  }
  const T* rows = a.rows + (size_t)own.lo * DOF * C;
  if constexpr (ROWS_SM) {
    T* const rs = reinterpret_cast<T*>(smem_raw + rows_offset(ppc, W, sizeof(T)));
    const int n = own.n_own * DOF * C;
#pragma unroll 8
    for (int i = tid; i < n; i += NT) rs[i] = __ldg(rows + i);
    rows = rs;
  }
  // Completes nb and the rows, and every CTA has started before any CTA
  // stores into another's shared memory.
  cluster.sync();

  T s2[2] = {T(0), T(0)};
  update_own<T>(a, true, T(0), own, rank, ncta, cluster, pe, ze, q, x, r,
                lane, warp, s2[0], s2[1]);
  cluster_sum<T, 2>(s2, wpart + NW, cpart + 1, total + 1, cluster, lane,
                    warp, ncta);
  T rz = s2[0];
  const T bnorm = m_sqrt(s2[1]);
  const T tol = a.eta * bnorm;
  T rnorm = bnorm, beta = T(0);
  int k = 0;
  while (k < a.max_iterations && rnorm > tol) {
    // p = z + beta p on the poses and the halo (p = z on the first pass):
    // every CTA holding a pose computes the same bits for it.
    for (int e = tid; e < own.n_ext * DOF; e += NT) {
      pe[e] = k == 0 ? ze[e] : m_fma(beta, pe[e], ze[e]);
    }
    __syncthreads();

    T s1[1] = {band_product<T, ROWS_SM>(K, rows, nb, pe, own.n_own, own_off,
                                        q, lane, warp)};
    cluster_sum<T, 1>(s1, wpart, cpart, total, cluster, lane, warp, ncta);
    const T pq = s1[0];
    const T alpha = pq > T(0) ? rz / pq : T(0);

    s2[0] = s2[1] = T(0);
    update_own<T>(a, false, alpha, own, rank, ncta, cluster, pe, ze, q, x,
                  r, lane, warp, s2[0], s2[1]);
    cluster_sum<T, 2>(s2, wpart + NW, cpart + 1, total + 1, cluster, lane,
                      warp, ncta);
    const bool stalled = pq <= T(0) || rz <= T(0);
    beta = rz > T(0) ? s2[0] / rz : T(0);
    rnorm = stalled ? T(-1) : m_sqrt(s2[1]);
    rz = s2[0];
    ++k;
  }
  // No CTA leaves while a neighbour's warp 0 may still read its partial
  // sums; the barrier also completes x and r, which other threads wrote.
  cluster.sync();
  for (int e = tid; e < own.n_own * DOF; e += NT) {
    a.x[(size_t)own.lo * DOF + e] = x[e];
    a.r[(size_t)own.lo * DOF + e] = r[e];
  }
  if (rank == 0 && tid == 0) *a.iters = k;
}

// One launch, or with max_clusters set, no launch: how many such clusters
// the card can run at once.  Returns 0, a cudaError, or a negative code for
// a plan that does not match the shape.
template <typename T, bool ROWS_SM>
int run(const Args<T>& a, int ctas, int smem, void* stream,
        int* max_clusters) {
  if (a.P < 1 || a.W < 1 || a.ppc < 1 || ctas < 1 || ctas > MAX_CLUSTER ||
      (long long)ctas * a.ppc < a.P || (long long)(ctas - 1) * a.ppc >= a.P) {
    return -1;
  }
  if ((size_t)smem != smem_bytes(a.ppc, a.W, sizeof(T), ROWS_SM)) return -2;
  void (*kernel)(Args<T>) = band_pcg_kernel<T, ROWS_SM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  } else {
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace rsba_band

// ctas, ppc, rows_in_smem and smem_bytes are a plan of
// rsba_tpu_torch/kernels/band_pcg.py::launch_plans.
#define RSBA_BAND_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* rows, const long long* nbr, const T* minv,    \
                      const T* b, int P, int W, int max_iterations,           \
                      double eta, T* x, T* r, int* iters, int ctas, int ppc,  \
                      int rows_in_smem, int smem_bytes, void* stream,         \
                      int* max_clusters) {                                    \
    rsba_band::Args<T> a{rows, nbr, minv, b, P, W, max_iterations, ppc,      \
                         (T)eta, x, r, iters};                                \
    return rows_in_smem                                                       \
               ? rsba_band::run<T, true>(a, ctas, smem_bytes, stream,         \
                                         max_clusters)                        \
               : rsba_band::run<T, false>(a, ctas, smem_bytes, stream,        \
                                          max_clusters);                      \
  }
RSBA_BAND_ENTRY(rsba_band_pcg_f32, float)
RSBA_BAND_ENTRY(rsba_band_pcg_f64, double)
