// Fused element apply for NVIDIA Hopper (sm_90a), generic in the pointwise
// physics.
//
// Replaces ceedpetscsolid_tpu/ops/pallas_apply.py::_apply_kernel (built by
// make_fused_apply for every model's residual_planes / jacobian_planes) in
// both of its modes on the solver's path:
//   residual  (K1, jacobian=False, stash_out=True): ve = B^T D(B G u), writes
//             the stash gradu (a physics with a stash);
//   Jacobian  (K2, jacobian=True, stash_in=True):  ve = B^T dD(B G v; gradu).
// The pointwise physics D is a template parameter, one functor per physics
// (ids shared with ops/fused_apply.py PHYSICS, Pointwise.kernel_id):
//   0 hyperFS, 1 linElas (no stash: its residual writes none and its
//   Jacobian reads none), 2 hyperSS, 3 hyperFSIncomp's deviatoric mu part,
//   4 hyperFSIncomp's pressure part (reduced integration, Q = 1 + qextra).
// Template instances: physics 0-3 at every 2 <= P <= Q <= 6, physics 4 at
// (P, 1) for 2 <= P <= 6, f32 and f64. P = Q is a level at its own Gauss
// rule (the fine residual and J.v, native p-multigrid levels); P < Q is a
// coarse level at the fine level's rule or a -qextra run; P > Q = 1 is the
// pressure term at one point per element on every level. Every other
// (physics, P, Q) runs on the generic tile, whose P and Q are run-time
// arguments (generic_reg_kernel up to P, Q = 8, generic_cluster_kernel
// above, an element a thread-block cluster, and generic_gmem_kernel where
// no cluster of 8 CTAs holds an element): the pressure term at
// Q = 1 + qextra > 1 and everything above Q = 6, up to P, Q = 64.
// Per element: gather the 3 x P^3 nodal values through `conn` (orientation is
// already resolved by the FE-space numbering, so the TPU kernel's class rows,
// orientation masks and selection GEMMs have no counterpart), contract to the
// Q^3 reference gradients by sum factorization, run the pointwise physics,
// contract back by sum factorization, write the element vector
// ve (3, nelem, P^3). The owner-sum over elements stays a deterministic
// plain-torch gather-sum (ops/restriction.py), as in the JAX package.
//
// What bounds it on the card: memory, on paper. Each input byte read once
// and each output byte written once (ops/fused_apply.min_bytes), hyperFS at
// 24^3, P = Q = 5, f32 moves 176.8 MB an apply (qdata 10 and stash 9 words
// a point: 74% of it) against ~1.1k flops a point (ops/fused_apply.
// min_flops: the sum-factorized contractions ~480, the hyperFS 3x3 algebra
// ~620): 52.8 us at 3.35 TB/s against 28 us at 67 TFLOP/s. In practice
// the warps an SM are: every contraction goes through shared memory and
// the gather is two dependent global loads, so a warp's tile is a chain of
// latencies that only other warps hide, and shared memory (the staged
// streams) and registers (the physics) cap those at 11-14 an SM. Its (5,5)
// f32 instances run at 43-63% of the bound at 24^3 (PERF.md §6).
//
// Design, full quadrature (Q >= 2, warp_tile_kernel): warp tiles. A block
// is one warp; it owns a tile of G = max(1, 32 / Q^2) elements at a time
// (one element at (5,5), so that a contraction phase is about one line a
// lane) and walks the tiles blockIdx.x, + gridDim.x, ... with as many
// blocks as the card holds at once. Only __syncwarp separates its phases,
// so the warps of an SM are independent pipelines: one gathers while
// another contracts or runs the physics. The tile's per-point streams,
// qdata's 10 planes and in J.v the stash's 9 (warp_planes), are issued
// right after the previous tile's physics: one lane issues TMA bulk copies
// of each plane's slice, rounded out to 16 bytes, that complete on the
// warp's mbarrier (or, where a plane is no multiple of 16 bytes or a base
// is misaligned, every lane copies words with cp.async:
// ops/fused_apply.copy_path states the same rule and counts the path);
// they land while the previous tile's adjoint and this tile's gather and
// forward contractions run. The gather is prefetched too (f32): the next
// tile's node ids are loaded after the physics, u at them after adjoint y.
// Thread layout: a lane takes one line position and all three components
// in each contraction (so a B/D row serves three lines), one quadrature
// point in the physics; f32 keeps B and D in registers (no shared copy),
// f64 reads padded shared copies. ve goes out from the adjoint x
// registers. Shared memory a warp: the slab of streams, buffer A (ue -> t2
// -> adjoint t2) and buffer B (t1 -> du -> dv -> adjoint t1).
// Occupancy: __launch_bounds__(32, the warps an SM's shared memory holds).
// At (5,5) f32 a warp takes 20.0 KB in J.v (15.2 KB for linElas and
// hyperSS, which stage no stash) and 15.2 KB in the residual: 11 and 14
// warps an SM, beside 155-159 and 126 registers a thread (ptxas; 13 and 16
// warps by registers): 11-14 elements in flight an SM, against 4 (of 4
// warps each) in the earlier one-block-per-element body. f64 (5,5): 31.0 KB
// and 186-188 registers a thread, 7 warps an SM.
// Which instances take the block tile instead: block_tile() below.
// Design, the block tile (block_tile_kernel: Q = 1, and f64 where the warp
// tile spills or loses): a block takes E elements (a few hundred nodal
// lines), one thread per element (Q = 1) or per point in the physics, the
// contractions spread over the block between block barriers; its streams
// come in by TMA bulk copies (thread 0 issues them) or cp.async at tile
// start, in flight through the gather and the forward contractions. No
// wgmma (2-6-wide contractions, f32 with TF32 off) and no atomics.
//
// Layouts (all row-major, x fastest inside a P^3 or Q^3 lattice):
//   u      (3, N)            L-vector, component-major
//   conn   (nelem, P^3)      int64 node ids
//   qdata  (10, nelem, Q^3)  [wdetJ, dXdx row-major]
//   stash  (9, nelem, Q^3)   gradu row-major: plane 3c+k = gradu[c][k]
//   B, D   (Q, P)            1D interp / derivative matrices
//   ve     (3, nelem, P^3)   element output
//
// The physics is transcribed from ceedpetscsolid_tpu_torch/models/*.py and
// base.py (which mirror the reference's qfunctions/*.h): the
// cancellation-free det(C) - 1 and the log1p series are kept as written,
// not replaced by log1p/log.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cps {

namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ T log1p_series(T x) {
  T y = x / (T(2) + x);
  T y2 = y * y;
  T s = y;
  y = y * y2;
  s = s + y / T(3);
  y = y * y2;
  s = s + y / T(5);
  y = y * y2;
  s = s + y / T(7);
  return T(2) * s;
}

// Range-extended series (hyperFS.h:45-67): valid 0.35 < 1+x < 2.83.
template <typename T>
__device__ __forceinline__ T log1p_series_shifted(T x) {
  const T sqrt2 = T(1.41421356237309504880);
  const T ln2 = T(0.69314718055994530942);
  const T left = sqrt2 / T(2) - T(1);
  const T right = sqrt2 - T(1);
  T xa = x;
  T base = T(0);
  if (x < left) {
    xa = T(1) + T(2) * x;
    base = -ln2 / T(2);
  } else if (x > right) {
    xa = (x - T(1)) / T(2);
    base = ln2 / T(2);
  }
  return T(2) * base + log1p_series(xa);
}

// c = a b (3x3 row-major)
template <typename T>
__device__ __forceinline__ void mat_mul(const T* a, const T* b, T* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[3 * j + k] = a[3 * j + 0] * b[0 + k] + a[3 * j + 1] * b[3 + k] +
                     a[3 * j + 2] * b[6 + k];
}

// c = a b^T
template <typename T>
__device__ __forceinline__ void mat_mul_T2(const T* a, const T* b, T* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[3 * j + k] = a[3 * j + 0] * b[3 * k + 0] + a[3 * j + 1] * b[3 * k + 1] +
                     a[3 * j + 2] * b[3 * k + 2];
}

// c = a^T b
template <typename T>
__device__ __forceinline__ void mat_T1_mul(const T* a, const T* b, T* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[3 * j + k] = a[0 + j] * b[0 + k] + a[3 + j] * b[3 + k] +
                     a[6 + j] * b[6 + k];
}

// F = I + g
template <typename T>
__device__ __forceinline__ void eye_plus(const T* g, T* F) {
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = g[k];
  F[0] = F[0] + T(1);
  F[4] = F[4] + T(1);
  F[8] = F[8] + T(1);
}

// e = 1/2 (g + g^T)
template <typename T>
__device__ __forceinline__ void sym(const T* g, T* e) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      e[3 * i + j] = T(0.5) * (g[3 * i + j] + g[3 * j + i]);
}

// E2 = 2E, det(C) - 1 and C^{-1} from gradu (hyperFS.h:85-124, the
// commonFS_incomp of hyperFSIncomp.h:69-137).
template <typename T>
__device__ __forceinline__ void finite_strain(const T* g, T* E2, T* Cinv,
                                              T& detC_m1) {
  T gtg[9];
  mat_T1_mul(g, g, gtg);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      E2[3 * i + j] = (g[3 * i + j] + g[3 * j + i]) + gtg[3 * i + j];
  const T e00 = E2[0], e11 = E2[4], e22 = E2[8];
  const T e12 = E2[5], e02 = E2[2], e01 = E2[1];
  // det(I + E2) - 1, expanded cancellation-free (hyperFS.h:72-80)
  detC_m1 = e00 * (e11 * e22 - e12 * e12) + e01 * (e02 * e12 - e01 * e22) +
            e02 * (e01 * e12 - e02 * e11) + e00 + e11 + e22 + e00 * e11 +
            e00 * e22 + e11 * e22 - e01 * e01 - e02 * e02 - e12 * e12;
  T C[9];
  eye_plus(E2, C);
  // symmetric inverse via adjugate / det (hyperFS.h:115-124)
  const T a00 = C[4] * C[8] - C[5] * C[7];
  const T a11 = C[0] * C[8] - C[2] * C[6];
  const T a22 = C[0] * C[4] - C[1] * C[3];
  const T a12 = C[2] * C[3] - C[0] * C[5];
  const T a02 = C[1] * C[5] - C[2] * C[4];
  const T a01 = C[2] * C[7] - C[1] * C[8];
  const T inv = T(1) / (detC_m1 + T(1));
  Cinv[0] = a00 * inv; Cinv[1] = a01 * inv; Cinv[2] = a02 * inv;
  Cinv[3] = a01 * inv; Cinv[4] = a11 * inv; Cinv[5] = a12 * inv;
  Cinv[6] = a02 * inv; Cinv[7] = a12 * inv; Cinv[8] = a22 * inv;
}

// dE = 1/2 (graddu^T F + F^T graddu)  (hyperFS.h:382-389)
template <typename T>
__device__ __forceinline__ void delta_E(const T* gd, const T* F, T* dE) {
  T gTF[9];
  mat_T1_mul(gd, F, gTF);
  sym(gTF, dE);
}

// C^{-1} dE C^{-1}
template <typename T>
__device__ __forceinline__ void cinv_dE_cinv(const T* Cinv, const T* dE,
                                             T* out) {
  T dECi[9];
  mat_mul(dE, Cinv, dECi);
  mat_mul(Cinv, dECi, out);
}

// dP = graddu S + F dS
template <typename T>
__device__ __forceinline__ void dpiola(const T* gd, const T* S, const T* F,
                                       const T* dS, T* dP) {
  T t1[9], t2[9];
  mat_mul(gd, S, t1);
  mat_mul(F, dS, t2);
#pragma unroll
  for (int k = 0; k < 9; ++k) dP[k] = t1[k] + t2[k];
}

// ---------------------------------------------------------------------------
// Pointwise physics. stress(g, a, b, P): the stress tensor that the test
// gradients are weighted with, from the physical gradient g = gradu;
// dstress(gd, g, a, b, dP): its linearization in the direction gd = graddu
// at the stashed state g. (a, b) are the physics' two parameters
// (ops/fused_apply.py Pointwise.params).
// ---------------------------------------------------------------------------
enum PhysicsId {
  kHyperFS = 0,
  kLinElas = 1,
  kHyperSS = 2,
  kIncompMu = 3,
  kIncompPressure = 4,
  kNumPhysics = 5
};

template <int PH>
struct Pointwise;

// hyperFS (models/hyper_fs.py), (a, b) = (lambda, mu):
// S = lambda log J C^{-1} + mu C^{-1} 2E, P = F S.
template <>
struct Pointwise<kHyperFS> {
  static constexpr bool kStash = true;
  template <typename T>
  __device__ static void stress(const T* g, T lam, T mu, T* P) {
    T E2[9], Cinv[9], detC_m1, CiE2[9], S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    const T llnj = lam * log1p_series_shifted(detC_m1) / T(2);
    mat_mul(Cinv, E2, CiE2);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = llnj * Cinv[k] + mu * CiE2[k];
    eye_plus(g, F);
    mat_mul(F, S, P);
  }
  template <typename T>
  __device__ static void dstress(const T* gd, const T* g, T lam, T mu, T* dP) {
    T E2[9], Cinv[9], detC_m1, CiE2[9], S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    const T llnj = lam * log1p_series_shifted(detC_m1) / T(2);
    mat_mul(Cinv, E2, CiE2);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = llnj * Cinv[k] + mu * CiE2[k];
    eye_plus(g, F);
    T dE[9], CidECi[9], dS[9];
    delta_E(gd, F, dE);
    T cinv_dE = Cinv[0] * dE[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) cinv_dE = cinv_dE + Cinv[k] * dE[k];
    cinv_dE_cinv(Cinv, dE, CidECi);
    const T s1 = lam * cinv_dE;
    const T s2 = T(2) * (llnj - mu);
#pragma unroll
    for (int k = 0; k < 9; ++k) dS[k] = Cinv[k] * s1 - s2 * CidECi[k];
    dpiola(gd, S, F, dS, dP);
  }
};

// linElas (models/lin_elas.py), (a, b) = (ss nu, ss (1 - 2 nu) / 2), the
// reference's Voigt form: sigma = a tr(e) I + b (e + diag(e)). Linear: the
// Jacobian is the same map of gd, and there is no stash.
template <>
struct Pointwise<kLinElas> {
  static constexpr bool kStash = false;
  template <typename T>
  __device__ static void stress(const T* g, T lam_v, T mu_v, T* s) {
    T e[9];
    sym(g, e);
    const T tr = e[0] + e[4] + e[8];
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = mu_v * e[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s[4 * d] = s[4 * d] + mu_v * e[4 * d];
      s[4 * d] = s[4 * d] + lam_v * tr;
    }
  }
  template <typename T>
  __device__ static void dstress(const T* gd, const T*, T lam_v, T mu_v,
                                 T* ds) {
    stress(gd, lam_v, mu_v, ds);
  }
};

// hyperSS (models/hyper_ss.py), (a, b) = (lambda, 2 mu):
// sigma = lambda log1p_series(tr e) I + 2 mu e; the Jacobian takes
// lambda_bar = lambda / (1 + tr gradu) from the stashed gradu.
template <>
struct Pointwise<kHyperSS> {
  static constexpr bool kStash = true;
  template <typename T>
  __device__ static void stress(const T* g, T lam, T two_mu, T* s) {
    T e[9];
    sym(g, e);
    const T llv = log1p_series(e[0] + e[4] + e[8]);
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = two_mu * e[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) s[4 * d] = s[4 * d] + lam * llv;
  }
  template <typename T>
  __device__ static void dstress(const T* gd, const T* g, T lam, T two_mu,
                                 T* ds) {
    T de[9];
    sym(gd, de);
    const T lam_bar = lam / (T(1) + (g[0] + g[4] + g[8]));
    const T dtr = de[0] + de[4] + de[8];
#pragma unroll
    for (int k = 0; k < 9; ++k) ds[k] = two_mu * de[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) ds[4 * d] = ds[4 * d] + lam_bar * dtr;
  }
};

// hyperFSIncomp deviatoric part (models/hyper_fs_incomp.py), (a, b) =
// (lambda, mu), lambda unused: S = mu C^{-1} 2E, dS = 2 mu C^{-1} dE C^{-1}.
template <>
struct Pointwise<kIncompMu> {
  static constexpr bool kStash = true;
  template <typename T>
  __device__ static void stress(const T* g, T, T mu, T* P) {
    T E2[9], Cinv[9], detC_m1, S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    mat_mul(Cinv, E2, S);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = mu * S[k];
    eye_plus(g, F);
    mat_mul(F, S, P);
  }
  template <typename T>
  __device__ static void dstress(const T* gd, const T* g, T, T mu, T* dP) {
    T E2[9], Cinv[9], detC_m1, S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    mat_mul(Cinv, E2, S);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = mu * S[k];
    eye_plus(g, F);
    T dE[9], CidECi[9], dS[9];
    delta_E(gd, F, dE);
    cinv_dE_cinv(Cinv, dE, CidECi);
#pragma unroll
    for (int k = 0; k < 9; ++k) dS[k] = T(2) * mu * CidECi[k];
    dpiola(gd, S, F, dS, dP);
  }
};

// hyperFSIncomp pressure part, one quadrature point per element, (a, b) =
// (lambda, mu), mu unused: S = lambda log J C^{-1},
// dS = lambda (C^{-1}:dE) C^{-1} - 2 lambda log J C^{-1} dE C^{-1}.
template <>
struct Pointwise<kIncompPressure> {
  static constexpr bool kStash = true;
  template <typename T>
  __device__ static void stress(const T* g, T lam, T, T* P) {
    T E2[9], Cinv[9], detC_m1, S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    const T llnj = lam * log1p_series_shifted(detC_m1) / T(2);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = llnj * Cinv[k];
    eye_plus(g, F);
    mat_mul(F, S, P);
  }
  template <typename T>
  __device__ static void dstress(const T* gd, const T* g, T lam, T, T* dP) {
    T E2[9], Cinv[9], detC_m1, S[9], F[9];
    finite_strain(g, E2, Cinv, detC_m1);
    const T llnj = lam * log1p_series_shifted(detC_m1) / T(2);
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = llnj * Cinv[k];
    eye_plus(g, F);
    T dE[9], CidECi[9], dS[9];
    delta_E(gd, F, dE);
    T cinv_dE = Cinv[0] * dE[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) cinv_dE = cinv_dE + Cinv[k] * dE[k];
    cinv_dE_cinv(Cinv, dE, CidECi);
    const T s1 = lam * cinv_dE;
    const T s2 = T(2) * llnj;
#pragma unroll
    for (int k = 0; k < 9; ++k) dS[k] = s1 * Cinv[k] - s2 * CidECi[k];
    dpiola(gd, S, F, dS, dP);
  }
};

// residual_planes at one point: du_ref -> (dv_ref, gradu)
template <int PH, typename T>
__device__ __forceinline__ void residual_point(const T* du, const T* X,
                                               T wdetJ, T a, T b, T* dv,
                                               T* g) {
  mat_mul(du, X, g);
  T P[9];
  Pointwise<PH>::stress(g, a, b, P);
  mat_mul_T2(P, X, dv);
#pragma unroll
  for (int k = 0; k < 9; ++k) dv[k] = dv[k] * wdetJ;
}

// jacobian_planes at one point: (ddu_ref, stashed gradu) -> dv_ref
template <int PH, typename T>
__device__ __forceinline__ void jacobian_point(const T* ddu, const T* X,
                                               T wdetJ, const T* g, T a, T b,
                                               T* dv) {
  T gd[9], dP[9];
  mat_mul(ddu, X, gd);
  Pointwise<PH>::dstress(gd, g, a, b, dP);
  mat_mul_T2(dP, X, dv);
#pragma unroll
  for (int k = 0; k < 9; ++k) dv[k] = dv[k] * wdetJ;
}

// ---------------------------------------------------------------------------
// Tile geometry (ops/fused_apply.py reads it through cps_fused_plan)
// ---------------------------------------------------------------------------
constexpr int kMaxThreads = 384;
constexpr size_t kSmemBudget = 75 * 1024;  // bytes a block: 3 blocks an SM
constexpr int kMaxPoints = 512;            // quadrature points a tile
constexpr int kMaxElems = 64;
constexpr size_t kBarBytes = 16;           // the mbarrier, padded to 16 bytes

__host__ __device__ constexpr bool has_stash(int PH) { return PH != kLinElas; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cgcd(int a, int b) {
  return b == 0 ? a : cgcd(b, a % b);
}
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct TilePlan {
  int elems;         // E, elements a tile
  int threads;       // threads a block
  int min_blocks;    // resident blocks an SM asked of __launch_bounds__
  int planes;        // per-point streams staged: 10 qdata, + 9 stash in J.v
  int plane_stride;  // words between staged planes: E Q^3 up to 16 bytes
  int bd_words;      // B, D (Q rows of P) and B^T, D^T (P rows of Q)
  int a_words;       // per element: ue -> t2 -> adjoint t2 -> staged ve
  int b_words;       // per element: t1 -> adjoint t1
  size_t smem;       // dynamic shared memory, bytes
};

// The largest tile within kSmemBudget, kMaxPoints and kMaxElems whose
// element count keeps every tile's slice of a plane 16-byte aligned (at
// least one such step, whatever the budget). Threads: one a contraction
// line of the tile (at most kMaxThreads). Registers: at least 64 a thread
// in f32 (72 for the pressure term), 128 in f64 (136), as few resident
// blocks (at most 3) as that leaves room for.
__host__ __device__ constexpr TilePlan tile_plan(int P, int Q, int tsize,
                                                 int planes, bool pressure) {
  const int Q3 = Q * Q * Q;
  const int step = 16 / cgcd(Q3 * tsize, 16);
  const int V = 16 / tsize;  // words a 16-byte load of a B/D row
  const int P2 = round_up(P, 2), Q2 = round_up(Q, 2);
  const int bd = 2 * Q * round_up(P, V) + 2 * P * round_up(Q, V);
  const int a = round_up(cmax(cmax(3 * P * P * P2, 9 * Q * Q * P2),
                              cmax(9 * P * Q * Q2, 3 * P * P * P)), 2);
  const int b = round_up(cmax(6 * P * Q * P2, 6 * P * P * Q2), 2);
  const int lines = cmax(3 * P * P, cmax(3 * P * Q, 3 * Q * Q));
  const int regs = tsize == 4 ? (pressure ? 72 : 64) : (pressure ? 136 : 128);
  TilePlan t{};
  for (int E = step;; E += step) {
    const int stride = round_up(E * Q3, V);
    const size_t smem =
        kBarBytes + (size_t)tsize * (bd + planes * stride + E * (a + b));
    if (E > step &&
        (smem > kSmemBudget || E > kMaxElems || E * Q3 > kMaxPoints))
      break;
    const int threads = cmin(kMaxThreads, round_up(E * lines, 32));
    const int blocks = cmax(1, cmin(3, 65536 / (threads * regs)));
    t = TilePlan{E, threads, blocks, planes, stride, bd, a, b, smem};
  }
  return t;
}

template <int PH, bool JAC, int P, int Q, typename T>
struct Tile {
  static_assert(Pointwise<PH>::kStash == has_stash(PH), "stash flag");
  static constexpr bool kStashIn = JAC && Pointwise<PH>::kStash;
  static constexpr TilePlan plan = tile_plan(
      P, Q, sizeof(T), kStashIn ? 19 : 10, PH == kIncompPressure);
  static_assert(plan.smem <= 227 * 1024, "a tile above 227 KB");
};

// Warp tiles (Q >= 2; see warp_tile_kernel): a block is one warp that owns
// a tile of G elements at a time, G = 32 / Q^2 or 1, so that a contraction
// phase has about one line a lane.
constexpr size_t kSmSmem = 233472;      // shared memory of an SM (228 KB)
constexpr size_t kBlockReserve = 1024;  // the runtime's share of it a block

struct WarpPlan {
  int elems;         // G, elements a warp tile
  int planes;        // per-point streams staged: 10 qdata, + 9 stash in J.v
  int plane_stride;  // words between staged planes
  int bd_words;      // B, D (Q rows of P) and B^T, D^T (P rows of Q): f64
  int a_words;       // buffer A: ue -> t2 -> adjoint t2
  int b_words;       // buffer B: t1 -> du -> dv -> adjoint t1
  size_t smem;       // dynamic shared memory, bytes
  int min_blocks;    // one-warp blocks an SM asked of __launch_bounds__
};

__host__ __device__ constexpr WarpPlan warp_plan(int P, int Q, int tsize,
                                                 int planes) {
  const int V = 16 / tsize;
  const int P2 = round_up(P, 2), Q2 = round_up(Q, 2);
  const int Q3 = Q * Q * Q;
  const int G = cmax(1, 32 / (Q * Q));
  const int a = G * cmax(cmax(3 * P * P * P2, 9 * Q * Q * P2),
                         9 * P * Q * Q2);
  const int b = G * cmax(cmax(6 * P * Q * P2, 9 * Q3), 6 * P * P * Q2);
  // a plane's slice of the tile, rounded out to 16 bytes at both ends
  const int stride = round_up(G * Q3, V) + V;
  // f32 keeps B and D in registers (bd_in_registers)
  const int bd = tsize == 4 ? 0
                            : 2 * Q * round_up(P, V) + 2 * P * round_up(Q, V);
  const int A = round_up(a, V), B = round_up(b, V);
  const size_t smem =
      kBarBytes + (size_t)tsize * (bd + planes * stride + A + B);
  const int blocks = (int)(kSmSmem / (smem + kBlockReserve));
  return WarpPlan{G, planes, stride, bd, A, B, smem,
                  cmin(32, cmax(1, blocks))};
}

// The per-point streams a warp tile stages: qdata's 10 planes and, in J.v,
// the stash's 9, but for hyperSS, whose light physics reads its stash
// straight from global memory: its tile is then as small as the residual's,
// and the more warps an SM hide those loads (PERF.md §6, run X2).
__host__ __device__ constexpr int warp_planes(int PH, bool jacobian) {
  return jacobian && has_stash(PH) && PH != kHyperSS ? 19 : 10;
}

template <int PH, bool JAC, int P, int Q, typename T>
struct WarpTile {
  static constexpr bool kStashIn = JAC && Pointwise<PH>::kStash;
  static constexpr bool kStage = warp_planes(PH, JAC) == 19;  // the stash
  static constexpr WarpPlan plan =
      warp_plan(P, Q, sizeof(T), warp_planes(PH, JAC));
  static_assert(plan.smem <= 227 * 1024, "a warp tile above 227 KB");
};

// Which body an instance runs: the block tile for the pressure term (Q = 1),
// for the f64 J.v of the finite-strain physics (hyperFS, hyperFSIncomp's mu
// part), whose ~215 registers a thread and 40 KB a warp tile leave 5 warps
// an SM (slower than the block tile there; PERF.md §6), and for f64 at
// P = Q = 6, where a warp tile's lines (9 rows of 6 doubles a lane) spill
// at 255 registers; the warp tile for everything else.
__host__ __device__ constexpr bool block_tile(int PH, bool jacobian, int P,
                                              int Q, int tsize) {
  return Q == 1 || (tsize == 8 && P == 6) ||
         (jacobian && tsize == 8 && (PH == kHyperFS || PH == kIncompMu));
}

// Copy path of one launch: TMA bulk copies when every staged stream (qdata;
// in J.v the stash) starts 16-byte aligned and its planes are multiples of
// 16 bytes long, so that every tile's slice is too; else cp.async.
// ops/fused_apply.copy_path is the same rule.
inline bool bulk_path(size_t tsize, int nelem, int Q, const void* qdata,
                      const void* stash, bool stash_in) {
  const size_t plane = tsize * (size_t)nelem * Q * Q * Q;
  return plane % 16 == 0 && reinterpret_cast<uintptr_t>(qdata) % 16 == 0 &&
         (!stash_in || reinterpret_cast<uintptr_t>(stash) % 16 == 0);
}

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase `parity` of `bar` to complete. A copy that never
// completes traps (a launch error the wrapper raises) instead of hanging
// the card: 2^28 polls are seconds, against microseconds of a tile's copies.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into this block's shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// cp.async of one word (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_async_word(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte words");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Row of N words of shared memory into registers, W words a load: the
// source is aligned to W words and padded to a multiple of W.
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <int W, int N, typename T>
__device__ __forceinline__ void ld_row(const T* src, T (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += W) {
    const Pack<T, W> p = *reinterpret_cast<const Pack<T, W>*>(src + i);
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (i + k < N) dst[i + k] = p.v[k];
  }
}

// ---------------------------------------------------------------------------
// The kernel: one tile of E elements a block (see the header). Every
// contraction phase gives a thread one line of the tile: the P or Q values
// it contracts, read as one padded row (the layouts below keep the
// contracted direction contiguous), and the B/D rows it needs, read as
// 16-byte loads from padded copies of B, D, B^T and D^T.
// Per element, rows padded to P2 = P or Q2 = Q rounded up to even:
//   ue           [c][pz][py] rows of px        (gather -> forward x)
//   t1[2]        [c][pz][qx] rows of py        (forward x -> forward y)
//   t2[3]        [c][qy][qx] rows of pz        (forward y -> forward z)
//   adj t2[3]    [c][pz][qx] rows of qy        (adjoint z -> adjoint y)
//   adj t1[2]    [c][pz][py] rows of qx        (adjoint y -> adjoint x)
// ---------------------------------------------------------------------------
template <int PH, bool JAC, int P, int Q, typename T>
__global__ void __launch_bounds__(Tile<PH, JAC, P, Q, T>::plan.threads,
                                  Tile<PH, JAC, P, Q, T>::plan.min_blocks)
block_tile_kernel(const T* __restrict__ u, long long N,
                  const long long* __restrict__ conn, int nelem,
                  const T* __restrict__ qdata, const T* __restrict__ Bg,
                  const T* __restrict__ Dg, T* __restrict__ stash,
                  T* __restrict__ ve, T a, T b, int bulk) {
  using TL = Tile<PH, JAC, P, Q, T>;
  constexpr int P3 = P * P * P;
  constexpr int Q3 = Q * Q * Q;
  constexpr int E = TL::plan.elems;
  constexpr int NT = TL::plan.threads;
  constexpr int PS = TL::plan.plane_stride;
  constexpr int A = TL::plan.a_words;
  constexpr int B1 = TL::plan.b_words;
  constexpr int V = 16 / sizeof(T);
  constexpr int PV = round_up(P, V), QV = round_up(Q, V);
  constexpr int P2 = round_up(P, 2), Q2 = round_up(Q, 2);
  constexpr int T1 = 3 * P * Q * P2;   // one t1 array
  constexpr int T2 = 3 * Q * Q * P2;   // one t2 array
  constexpr int T2A = 3 * P * Q * Q2;  // one adjoint t2 array
  constexpr int T1A = 3 * P * P * Q2;  // one adjoint t1 array

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* sB = reinterpret_cast<T*>(smem + kBarBytes);  // Q rows of PV
  T* sD = sB + Q * PV;
  T* sBT = sD + Q * PV;  // P rows of QV
  T* sDT = sBT + P * QV;
  // slab: plane k at k * PS; qdata planes 0-9, stash planes 10-18 (J.v);
  // the physics overwrites a point's qdata planes 0-8 with its dv
  T* slab = sB + TL::plan.bd_words;
  T* bufA = slab + TL::plan.planes * PS;  // element e at e * A
  T* bufB = bufA + E * A;                 // element e at e * B1

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, nelem - e0);
  const int npts = ne * Q3;
  const size_t plane = (size_t)nelem * Q3;
  const size_t off0 = (size_t)e0 * Q3;  // the tile's first point in a plane

  // ---- the tile's per-point streams, in flight through the gather and the
  // forward contractions ----
  if (bulk) {
    if (tid == 0) {
      const uint32_t bytes = sizeof(T) * npts;
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, bytes * TL::plan.planes);
      for (int k = 0; k < TL::plan.planes; ++k) {
        const T* src = k < 10 ? qdata + k * plane + off0
                              : stash + (k - 10) * plane + off0;
        bulk_load(slab + k * PS, src, bytes, bar);
      }
    }
  } else {
    for (int k = 0; k < 10; ++k)
      for (int w = tid; w < npts; w += NT)
        cp_async_word(slab + k * PS + w, qdata + k * plane + off0 + w);
    if constexpr (TL::kStashIn) {
      for (int k = 0; k < 9; ++k)
        for (int w = tid; w < npts; w += NT)
          cp_async_word(slab + (10 + k) * PS + w, stash + k * plane + off0 + w);
    }
  }

  // ---- B, D (rows by quadrature point) and B^T, D^T (rows by node), the
  // padding zero; the nodal gather into ue ----
  for (int i = tid; i < Q * PV; i += NT) {
    const int q = i / PV, p = i - q * PV;
    sB[i] = p < P ? Bg[q * P + p] : T(0);
    sD[i] = p < P ? Dg[q * P + p] : T(0);
  }
  for (int i = tid; i < P * QV; i += NT) {
    const int p = i / QV, q = i - p * QV;
    sBT[i] = q < Q ? Bg[q * P + p] : T(0);
    sDT[i] = q < Q ? Dg[q * P + p] : T(0);
  }
  const long long* ce = conn + (size_t)e0 * P3;
  for (int i = tid; i < ne * P3; i += NT) {
    const long long node = ce[i];
    const int e = i / P3;
    const int p = i - e * P3;
    const int row = p / P;  // pz * P + py
    T* ue = bufA + e * A + row * P2 + (p - row * P);
#pragma unroll
    for (int c = 0; c < 3; ++c) ue[c * P * P * P2] = u[c * N + node];
  }
  __syncthreads();

  // ---- forward x: a row (c, pz, py) -> t1[0] = B_x u, t1[1] = D_x u at
  // every qx ----
  for (int i = tid; i < ne * 3 * P * P; i += NT) {
    const int e = i / (3 * P * P);
    const int r = i - e * (3 * P * P);  // (c * P + pz) * P + py
    T x[P];
    ld_row<2>(bufA + e * A + r * P2, x);
    const int rp = r / P;               // c * P + pz
    T* o = bufB + e * B1 + rp * Q * P2 + (r - rp * P);
#pragma unroll
    for (int qx = 0; qx < Q; ++qx) {
      T bq[P], dq[P];
      ld_row<V>(sB + qx * PV, bq);
      ld_row<V>(sD + qx * PV, dq);
      T bs = T(0), ds = T(0);
#pragma unroll
      for (int px = 0; px < P; ++px) {
        bs += bq[px] * x[px];
        ds += dq[px] * x[px];
      }
      o[qx * P2] = bs;
      o[T1 + qx * P2] = ds;
    }
  }
  __syncthreads();

  // ---- forward y: a line (c, pz, qx) over py -> t2[0] = B_y D_x u,
  // t2[1] = D_y B_x u, t2[2] = B_y B_x u at every qy ----
  for (int i = tid; i < ne * 3 * P * Q; i += NT) {
    const int e = i / (3 * P * Q);
    const int j = i - e * (3 * P * Q);  // (c * P + pz) * Q + qx
    T x0[P], x1[P];
    ld_row<2>(bufB + e * B1 + j * P2, x0);
    ld_row<2>(bufB + e * B1 + T1 + j * P2, x1);
    const int c = j / (P * Q);
    const int rq = j / Q;               // c * P + pz
    const int qx = j - rq * Q;
    T* o = bufA + e * A + (c * Q * Q + qx) * P2 + (rq - c * P);
#pragma unroll
    for (int qy = 0; qy < Q; ++qy) {
      T bq[P], dq[P];
      ld_row<V>(sB + qy * PV, bq);
      ld_row<V>(sD + qy * PV, dq);
      T bd = T(0), db = T(0), bb = T(0);
#pragma unroll
      for (int py = 0; py < P; ++py) {
        bd += bq[py] * x1[py];
        db += dq[py] * x0[py];
        bb += bq[py] * x0[py];
      }
      o[qy * Q * P2] = bd;
      o[T2 + qy * Q * P2] = db;
      o[2 * T2 + qy * Q * P2] = bb;
    }
  }
  if (!bulk) cp_async_wait_all();
  __syncthreads();
  if (bulk) mbar_wait(bar, 0);

  // ---- forward z + pointwise physics, one quadrature point of the tile a
  // thread (pt = e * Q^3 + q, also its offset in a staged plane) ----
  for (int pt = tid; pt < npts; pt += NT) {
    const int e = pt / Q3;
    const int q = pt - e * Q3;
    const int qz = q / (Q * Q);
    const int qxy = q - qz * (Q * Q);  // qy * Q + qx
    T bz[P], dz[P];
    ld_row<V>(sB + qz * PV, bz);
    ld_row<V>(sD + qz * PV, dz);
    const T* t2 = bufA + e * A + qxy * P2;
    T du[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T r0[P], r1[P], r2[P];
      ld_row<2>(t2 + c * Q * Q * P2, r0);
      ld_row<2>(t2 + T2 + c * Q * Q * P2, r1);
      ld_row<2>(t2 + 2 * T2 + c * Q * Q * P2, r2);
      T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
      for (int pz = 0; pz < P; ++pz) {
        a0 += bz[pz] * r0[pz];
        a1 += bz[pz] * r1[pz];
        a2 += dz[pz] * r2[pz];
      }
      du[3 * c + 0] = a0;
      du[3 * c + 1] = a1;
      du[3 * c + 2] = a2;
    }
    const T wdetJ = slab[pt];
    T X[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = slab[(1 + k) * PS + pt];
    T dv[9], g[9];
    if constexpr (JAC) {
      if constexpr (TL::kStashIn) {
#pragma unroll
        for (int k = 0; k < 9; ++k) g[k] = slab[(10 + k) * PS + pt];
      }
      jacobian_point<PH>(du, X, wdetJ, g, a, b, dv);
    } else {
      residual_point<PH>(du, X, wdetJ, a, b, dv, g);
      if constexpr (Pointwise<PH>::kStash) {
#pragma unroll
        for (int k = 0; k < 9; ++k) stash[k * plane + off0 + pt] = g[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) slab[k * PS + pt] = dv[k];
  }
  __syncthreads();

  // ---- adjoint z: a line (c, qy, qx) of dv over qz -> adjoint t2[0] =
  // B_z^T dv0, t2[1] = B_z^T dv1, t2[2] = D_z^T dv2 at every pz ----
  for (int i = tid; i < ne * 3 * Q * Q; i += NT) {
    const int e = i / (3 * Q * Q);
    const int j = i - e * (3 * Q * Q);
    const int c = j / (Q * Q);
    const int qxy = j - c * (Q * Q);
    const int qy = qxy / Q;
    const T* d = slab + e * Q3 + qxy;
    T y0[Q], y1[Q], y2[Q];
#pragma unroll
    for (int qz = 0; qz < Q; ++qz) {
      y0[qz] = d[(3 * c + 0) * PS + qz * Q * Q];
      y1[qz] = d[(3 * c + 1) * PS + qz * Q * Q];
      y2[qz] = d[(3 * c + 2) * PS + qz * Q * Q];
    }
    T* o = bufA + e * A + (c * P * Q + (qxy - qy * Q)) * Q2 + qy;
#pragma unroll
    for (int pz = 0; pz < P; ++pz) {
      T bt[Q], dt[Q];
      ld_row<V>(sBT + pz * QV, bt);
      ld_row<V>(sDT + pz * QV, dt);
      T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
      for (int qz = 0; qz < Q; ++qz) {
        a0 += bt[qz] * y0[qz];
        a1 += bt[qz] * y1[qz];
        a2 += dt[qz] * y2[qz];
      }
      o[pz * Q * Q2] = a0;
      o[T2A + pz * Q * Q2] = a1;
      o[2 * T2A + pz * Q * Q2] = a2;
    }
  }
  __syncthreads();

  // ---- adjoint y: a line (c, pz, qx) over qy -> adjoint t1[0] =
  // B_y^T t2[0], t1[1] = D_y^T t2[1] + B_y^T t2[2] at every py ----
  for (int i = tid; i < ne * 3 * P * Q; i += NT) {
    const int e = i / (3 * P * Q);
    const int j = i - e * (3 * P * Q);  // (c * P + pz) * Q + qx
    T y0[Q], y1[Q], y2[Q];
    ld_row<2>(bufA + e * A + j * Q2, y0);
    ld_row<2>(bufA + e * A + T2A + j * Q2, y1);
    ld_row<2>(bufA + e * A + 2 * T2A + j * Q2, y2);
    const int rp = j / Q;  // c * P + pz
    T* o = bufB + e * B1 + rp * P * Q2 + (j - rp * Q);
#pragma unroll
    for (int py = 0; py < P; ++py) {
      T bt[Q], dt[Q];
      ld_row<V>(sBT + py * QV, bt);
      ld_row<V>(sDT + py * QV, dt);
      T bx = T(0), bb = T(0);
#pragma unroll
      for (int qy = 0; qy < Q; ++qy) {
        bx += bt[qy] * y0[qy];
        bb += dt[qy] * y1[qy] + bt[qy] * y2[qy];
      }
      o[py * Q2] = bx;
      o[T1A + py * Q2] = bb;
    }
  }
  __syncthreads();

  // ---- adjoint x: a row (c, pz, py) over qx -> ve = D_x^T t1[0] +
  // B_x^T t1[1] at every px, staged per component over the tile ----
  for (int i = tid; i < ne * 3 * P * P; i += NT) {
    const int e = i / (3 * P * P);
    const int r = i - e * (3 * P * P);  // (c * P + pz) * P + py
    T x0[Q], x1[Q];
    ld_row<2>(bufB + e * B1 + r * Q2, x0);
    ld_row<2>(bufB + e * B1 + T1A + r * Q2, x1);
    const int c = r / (P * P);
    T* o = bufA + c * (E * P3) + e * P3 + (r - c * P * P) * P;
#pragma unroll
    for (int px = 0; px < P; ++px) {
      T bt[Q], dt[Q];
      ld_row<V>(sBT + px * QV, bt);
      ld_row<V>(sDT + px * QV, dt);
      T acc = T(0);
#pragma unroll
      for (int qx = 0; qx < Q; ++qx)
        acc += dt[qx] * x0[qx] + bt[qx] * x1[qx];
      o[px] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T* dst = ve + ((size_t)c * nelem + e0) * P3;
    for (int w = tid; w < ne * P3; w += NT) dst[w] = bufA[c * (E * P3) + w];
  }
}

// The node ids of tile t's gather for this lane, lane + 32 it of the tile's
// G P^3 (node 0 past the tile's last element), and u's three components at
// them: issued together, so that their latencies overlap.
template <int G, int P3, int IT>
__device__ __forceinline__ void gather_nodes(long long (&node)[IT],
                                             const long long* __restrict__ conn,
                                             int t, int nelem, int lane) {
  const int n = min(G, nelem - t * G) * P3;
  const long long* ce = conn + (size_t)t * G * P3;
#pragma unroll
  for (int it = 0; it < IT; ++it)
    node[it] = lane + 32 * it < n ? ce[lane + 32 * it] : 0;
}

template <int IT, typename T>
__device__ __forceinline__ void gather_values(T (&val)[IT][3],
                                              const long long (&node)[IT],
                                              const T* __restrict__ u,
                                              long long N) {
#pragma unroll
  for (int it = 0; it < IT; ++it)
#pragma unroll
    for (int c = 0; c < 3; ++c) val[it][c] = u[c * N + node[it]];
}

// Row q of B and of D (P values each), and row p of B^T and of D^T (Q
// values each): from the registers rB, rD in f32, else from the padded
// shared copies (16-byte loads, the same row for every lane). f64 keeps
// them in shared memory: 2 P Q doubles of registers would crowd out the
// physics.
template <typename T>
__host__ __device__ constexpr bool bd_in_registers() {
  return sizeof(T) == 4;
}

template <int V, int PV, int Q, int P, typename T>
__device__ __forceinline__ void bd_row(int q, const T (&rB)[Q][P],
                                       const T (&rD)[Q][P], const T* sB,
                                       const T* sD, T (&b)[P], T (&d)[P]) {
  if constexpr (bd_in_registers<T>()) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      b[p] = rB[q][p];
      d[p] = rD[q][p];
    }
  } else {
    ld_row<V>(sB + q * PV, b);
    ld_row<V>(sD + q * PV, d);
  }
}

template <int V, int QV, int Q, int P, typename T>
__device__ __forceinline__ void bdt_row(int p, const T (&rB)[Q][P],
                                        const T (&rD)[Q][P], const T* sBT,
                                        const T* sDT, T (&b)[Q], T (&d)[Q]) {
  if constexpr (bd_in_registers<T>()) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      b[q] = rB[q][p];
      d[q] = rD[q][p];
    }
  } else {
    ld_row<V>(sBT + p * QV, b);
    ld_row<V>(sDT + p * QV, d);
  }
}

// ---------------------------------------------------------------------------
// The full-quadrature kernel (Q >= 2): warp tiles (see the header). Per
// element, rows padded to P2 or Q2 (buffer A or B):
//   ue     A  [c][pz][py] rows of px
//   t1     B  [b|d][c][pz][qx] rows of py
//   t2     A  [bd|db|bb][c][qy][qx] rows of pz
//   du/dv  B  [3c+k][e][q] (a plane of the tile's points)
//   a2     A  [0|1|2][c][pz][qx] rows of qy
//   a1     B  [0|1][c][pz][py] rows of qx
// ---------------------------------------------------------------------------
template <int PH, bool JAC, int P, int Q, typename T>
__global__ void __launch_bounds__(32,
                                  WarpTile<PH, JAC, P, Q, T>::plan.min_blocks)
warp_tile_kernel(const T* __restrict__ u, long long N,
                 const long long* __restrict__ conn, int nelem,
                 const T* __restrict__ qdata, const T* __restrict__ Bg,
                 const T* __restrict__ Dg, T* __restrict__ stash,
                 T* __restrict__ ve, T a, T b, int bulk) {
  using WT = WarpTile<PH, JAC, P, Q, T>;
  constexpr int P3 = P * P * P, Q3 = Q * Q * Q;
  constexpr int G = WT::plan.elems;
  constexpr int NPL = WT::plan.planes;
  constexpr int PS = WT::plan.plane_stride;
  constexpr int V = 16 / sizeof(T);
  constexpr int PV = round_up(P, V), QV = round_up(Q, V);
  constexpr int P2 = round_up(P, 2), Q2 = round_up(Q, 2);
  constexpr int UE = 3 * P * P * P2;   // per element: ue
  constexpr int T1 = 6 * P * Q * P2;   // t1
  constexpr int T2 = 9 * Q * Q * P2;   // t2
  constexpr int A2 = 9 * P * Q * Q2;   // adjoint t2
  constexpr int A1 = 6 * P * P * Q2;   // adjoint t1
  constexpr int GQ3 = G * Q3, GP3 = G * P3;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* sB = reinterpret_cast<T*>(smem + kBarBytes);  // Q rows of PV
  T* sD = sB + Q * PV;
  T* sBT = sD + Q * PV;  // P rows of QV
  T* sDT = sBT + P * QV;
  T* slab = sB + WT::plan.bd_words;  // plane k at k * PS
  T* bufA = slab + NPL * PS;
  T* bufB = bufA + WT::plan.a_words;

  const int lane = threadIdx.x;
  const int ntiles = (nelem + G - 1) / G;
  const size_t plane = (size_t)nelem * Q3;
  const size_t plane_ve = (size_t)nelem * P3;

  T rB[Q][P], rD[Q][P];  // used in f32 only (bd_in_registers)
  if constexpr (!bd_in_registers<T>()) {
    for (int i = lane; i < Q * PV; i += 32) {
      const int q = i / PV, p = i - q * PV;
      sB[i] = p < P ? Bg[q * P + p] : T(0);
      sD[i] = p < P ? Dg[q * P + p] : T(0);
    }
    for (int i = lane; i < P * QV; i += 32) {
      const int p = i / QV, q = i - p * QV;
      sBT[i] = q < Q ? Bg[q * P + p] : T(0);
      sDT[i] = q < Q ? Dg[q * P + p] : T(0);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        rB[q][p] = Bg[q * P + p];
        rD[q][p] = Dg[q * P + p];
      }
  }
  if (bulk && lane == 0) mbar_init(bar, 1);
  __syncwarp();

  // the per-point streams of tile t into the slab: TMA copies of each
  // plane's slice rounded out to 16 bytes (bulk_path keeps that inside the
  // plane), or cp.async word by word from the slice's first point
  auto issue = [&](int t) {
    const int e0 = t * G;
    const int n = min(G, nelem - e0) * Q3;
    const size_t s = (size_t)e0 * Q3;
    if (bulk) {
      if (lane == 0) {
        const size_t s0 = s & ~(size_t)(V - 1);
        const uint32_t bytes =
            sizeof(T) * round_up(static_cast<int>(s - s0) + n, V);
        mbar_arrive_expect_tx(bar, bytes * NPL);
        for (int k = 0; k < NPL; ++k) {
          const T* src = k < 10 ? qdata + k * plane + s0
                                : stash + (k - 10) * plane + s0;
          bulk_load(slab + k * PS, src, bytes, bar);
        }
      }
    } else {
      for (int k = 0; k < 10; ++k)
        for (int w = lane; w < n; w += 32)
          cp_async_word(slab + k * PS + w, qdata + k * plane + s + w);
      if constexpr (WT::kStage) {
        for (int k = 0; k < 9; ++k)
          for (int w = lane; w < n; w += 32)
            cp_async_word(slab + (10 + k) * PS + w, stash + k * plane + s + w);
      }
    }
  };

  // f32 prefetches the gather a tile ahead; f64 gathers in place (its
  // prefetched values would crowd the registers at P = Q = 6)
  constexpr bool kPrefetch = sizeof(T) == 4;
  constexpr int IT = (GP3 + 31) / 32;
  long long node[IT];
  T val[IT][3];
  int t = blockIdx.x;
  if (t < ntiles) {
    issue(t);
    if constexpr (kPrefetch) {
      gather_nodes<G, P3>(node, conn, t, nelem, lane);
      gather_values(val, node, u, N);
    }
  }
  uint32_t parity = 0;
  for (; t < ntiles; t += gridDim.x) {
    const int e0 = t * G;
    const int ne = min(G, nelem - e0);
    // the tile's first point in a staged plane
    const int off = bulk ? static_cast<int>(((size_t)e0 * Q3) & (V - 1)) : 0;

    // ---- gather: u at the tile's nodes (in f32 loaded during the previous
    // tile, or above for the first) ----
    {
      if constexpr (!kPrefetch) {
        gather_nodes<G, P3>(node, conn, t, nelem, lane);
        gather_values(val, node, u, N);
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int i = lane + 32 * it;
        if (i < ne * P3) {
          const int e = i / P3;
          const int p = i - e * P3;
          const int row = p / P;  // pz * P + py
          T* o = bufA + e * UE + row * P2 + (p - row * P);
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c * P * P * P2] = val[it][c];
        }
      }
    }
    __syncwarp();

    // ---- forward x: position (pz, py) -> t1 b = B_x u, d = D_x u ----
    for (int i = lane; i < ne * P * P; i += 32) {
      const int e = i / (P * P);
      const int r = i - e * (P * P);  // pz * P + py
      T x[3][P];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ld_row<2>(bufA + e * UE + c * P * P * P2 + r * P2, x[c]);
      const int pz = r / P;
      T* o = bufB + e * T1 + pz * Q * P2 + (r - pz * P);
#pragma unroll
      for (int qx = 0; qx < Q; ++qx) {
        T bq[P], dq[P];
        bd_row<V, PV>(qx, rB, rD, sB, sD, bq, dq);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T bs = T(0), ds = T(0);
#pragma unroll
          for (int px = 0; px < P; ++px) {
            bs += bq[px] * x[c][px];
            ds += dq[px] * x[c][px];
          }
          o[c * P * Q * P2 + qx * P2] = bs;
          o[(3 + c) * P * Q * P2 + qx * P2] = ds;
        }
      }
    }
    __syncwarp();

    // ---- forward y: position (pz, qx) -> t2 bd = B_y D_x u,
    // db = D_y B_x u, bb = B_y B_x u ----
    for (int i = lane; i < ne * P * Q; i += 32) {
      const int e = i / (P * Q);
      const int j = i - e * (P * Q);  // pz * Q + qx
      T x0[3][P], x1[3][P];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ld_row<2>(bufB + e * T1 + c * P * Q * P2 + j * P2, x0[c]);
        ld_row<2>(bufB + e * T1 + (3 + c) * P * Q * P2 + j * P2, x1[c]);
      }
      const int pz = j / Q;
      T* o = bufA + e * T2 + (j - pz * Q) * P2 + pz;
#pragma unroll
      for (int qy = 0; qy < Q; ++qy) {
        T bq[P], dq[P];
        bd_row<V, PV>(qy, rB, rD, sB, sD, bq, dq);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T bd = T(0), db = T(0), bb = T(0);
#pragma unroll
          for (int py = 0; py < P; ++py) {
            bd += bq[py] * x1[c][py];
            db += dq[py] * x0[c][py];
            bb += bq[py] * x0[c][py];
          }
          o[c * Q * Q * P2 + qy * Q * P2] = bd;
          o[(3 + c) * Q * Q * P2 + qy * Q * P2] = db;
          o[(6 + c) * Q * Q * P2 + qy * Q * P2] = bb;
        }
      }
    }
    __syncwarp();

    // ---- forward z: position (qy, qx) -> du[3c + k] at every qz ----
    for (int i = lane; i < ne * Q * Q; i += 32) {
      const int e = i / (Q * Q);
      const int qxy = i - e * (Q * Q);  // qy * Q + qx
      T r[9][P];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        ld_row<2>(bufA + e * T2 + k * Q * Q * P2 + qxy * P2, r[k]);
      T* o = bufB + e * Q3 + qxy;
#pragma unroll
      for (int qz = 0; qz < Q; ++qz) {
        T bz[P], dz[P];
        bd_row<V, PV>(qz, rB, rD, sB, sD, bz, dz);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
          for (int pz = 0; pz < P; ++pz) {
            a0 += bz[pz] * r[c][pz];
            a1 += bz[pz] * r[3 + c][pz];
            a2 += dz[pz] * r[6 + c][pz];
          }
          o[(3 * c + 0) * GQ3 + qz * Q * Q] = a0;
          o[(3 * c + 1) * GQ3 + qz * Q * Q] = a1;
          o[(3 * c + 2) * GQ3 + qz * Q * Q] = a2;
        }
      }
    }
    if (bulk) {
      mbar_wait(bar, parity);
      parity ^= 1u;
    } else {
      cp_async_wait_all();
    }
    __syncwarp();

    // ---- pointwise physics, one point of the tile a lane; dv overwrites
    // du in place ----
#pragma unroll 1
    for (int pt = lane; pt < ne * Q3; pt += 32) {
      T du[9], X[9], dv[9], g[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) du[k] = bufB[k * GQ3 + pt];
      const T* sl = slab + off + pt;
      const T wdetJ = sl[0];
#pragma unroll
      for (int k = 0; k < 9; ++k) X[k] = sl[(1 + k) * PS];
      if constexpr (JAC) {
        if constexpr (WT::kStage) {
#pragma unroll
          for (int k = 0; k < 9; ++k) g[k] = sl[(10 + k) * PS];
        } else if constexpr (WT::kStashIn) {
#pragma unroll
          for (int k = 0; k < 9; ++k)
            g[k] = stash[k * plane + (size_t)e0 * Q3 + pt];
        }
        jacobian_point<PH>(du, X, wdetJ, g, a, b, dv);
      } else {
        residual_point<PH>(du, X, wdetJ, a, b, dv, g);
        if constexpr (Pointwise<PH>::kStash) {
#pragma unroll
          for (int k = 0; k < 9; ++k)
            stash[k * plane + (size_t)e0 * Q3 + pt] = g[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) bufB[k * GQ3 + pt] = dv[k];
    }
    __syncwarp();
    // the slab is free: the next tile's streams land during this adjoint
    const int next = t + static_cast<int>(gridDim.x);
    if (next < ntiles) {
      issue(next);
      if constexpr (kPrefetch)
        gather_nodes<G, P3>(node, conn, next, nelem, lane);
    }

    // ---- adjoint z: position (qy, qx) -> a2 0 = B_z^T dv0,
    // 1 = B_z^T dv1, 2 = D_z^T dv2 at every pz ----
    for (int i = lane; i < ne * Q * Q; i += 32) {
      const int e = i / (Q * Q);
      const int qxy = i - e * (Q * Q);
      const int qy = qxy / Q;
      T y[9][Q];
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int qz = 0; qz < Q; ++qz)
          y[k][qz] = bufB[k * GQ3 + e * Q3 + qz * Q * Q + qxy];
      T* o = bufA + e * A2 + (qxy - qy * Q) * Q2 + qy;
#pragma unroll
      for (int pz = 0; pz < P; ++pz) {
        T bt[Q], dt[Q];
        bdt_row<V, QV>(pz, rB, rD, sBT, sDT, bt, dt);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
          for (int qz = 0; qz < Q; ++qz) {
            a0 += bt[qz] * y[3 * c + 0][qz];
            a1 += bt[qz] * y[3 * c + 1][qz];
            a2 += dt[qz] * y[3 * c + 2][qz];
          }
          o[(c * P + pz) * Q * Q2] = a0;
          o[((3 + c) * P + pz) * Q * Q2] = a1;
          o[((6 + c) * P + pz) * Q * Q2] = a2;
        }
      }
    }
    __syncwarp();

    // ---- adjoint y: position (pz, qx) -> a1 0 = B_y^T a2 0,
    // 1 = D_y^T a2 1 + B_y^T a2 2 at every py ----
    for (int i = lane; i < ne * P * Q; i += 32) {
      const int e = i / (P * Q);
      const int j = i - e * (P * Q);  // pz * Q + qx
      T y[9][Q];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        ld_row<2>(bufA + e * A2 + k * P * Q * Q2 + j * Q2, y[k]);
      const int pz = j / Q;
      T* o = bufB + e * A1 + pz * P * Q2 + (j - pz * Q);
#pragma unroll
      for (int py = 0; py < P; ++py) {
        T bt[Q], dt[Q];
        bdt_row<V, QV>(py, rB, rD, sBT, sDT, bt, dt);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T s0 = T(0), s1 = T(0);
#pragma unroll
          for (int qy = 0; qy < Q; ++qy) {
            s0 += bt[qy] * y[c][qy];
            s1 += dt[qy] * y[3 + c][qy] + bt[qy] * y[6 + c][qy];
          }
          o[c * P * P * Q2 + py * Q2] = s0;
          o[(3 + c) * P * P * Q2 + py * Q2] = s1;
        }
      }
    }
    // the ids have landed: the next tile's values land during adjoint x
    if (kPrefetch && next < ntiles) gather_values(val, node, u, N);
    __syncwarp();

    // ---- adjoint x: position (pz, py) -> ve = D_x^T a1 0 + B_x^T a1 1 at
    // every px, staged per component ----
    for (int i = lane; i < ne * P * P; i += 32) {
      const int e = i / (P * P);
      const int r = i - e * (P * P);  // pz * P + py
      T x0[3][Q], x1[3][Q];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ld_row<2>(bufB + e * A1 + c * P * P * Q2 + r * Q2, x0[c]);
        ld_row<2>(bufB + e * A1 + (3 + c) * P * P * Q2 + r * Q2, x1[c]);
      }
      T* o = ve + ((size_t)e0 + e) * P3 + r * P;
#pragma unroll
      for (int px = 0; px < P; ++px) {
        T bt[Q], dt[Q];
        bdt_row<V, QV>(px, rB, rD, sBT, sDT, bt, dt);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T acc = T(0);
#pragma unroll
          for (int qx = 0; qx < Q; ++qx)
            acc += dt[qx] * x0[c][qx] + bt[qx] * x1[c][qx];
          o[c * plane_ve + px] = acc;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The generic tile: P and Q are run-time arguments. It runs every
// (physics, P, Q) that the template instances above lack: the pressure term
// at Q = 1 + qextra > 1 (P > Q on every p-multigrid level, which all share
// that rule) and every instance above Q = 6 (degree >= 6, or degree 5 with
// -qextra), in both modes and both types. Up to P, Q = kGenericRegCap the
// register bodies below run it (generic_reg_kernel); above, the cluster
// body (generic_cluster_kernel, "cluster": an element in the shared memory
// of a thread-block cluster of up to kClusterMax CTAs) and, where no such
// cluster holds an element, the global-memory body (generic_gmem_kernel,
// "gmem"): one instance a (physics, mode, type) each, 20 kernels a body.
// The gmem body runs generic_tile: a block of kGenericThreads threads takes
// one element, every phase gives a thread one output value at a time,
// looping over the contracted direction, with a block barrier between
// phases; qdata and the stash are read (and the stash written) per point
// straight from global memory, consecutive threads on consecutive points.
// Its buffers, an element, in words (x fastest):
//   buffer A: ue [c][pz][py][px] -> t2[3] [c][qy][qx][pz]
//             -> adjoint t2[3] [c][pz][qx][qy]
//   buffer B: t1[2] [c][pz][qx][py] -> dv[9] [qz][qy][qx]
//             -> adjoint t1[2] [c][pz][py][qx]
// max(3 P^3, 9 P Q^2) + max(6 P^2 Q, 9 Q^3) words (gmem_words).
// ---------------------------------------------------------------------------
constexpr int kGenericThreads = 256;
constexpr size_t kGenericBudget = 64 * 1024;  // bytes a block when E > 1
constexpr int kGenericMaxPQ = 64;             // a bound on P, Q for the plan

// Buffer A, and A and B, of one element of the gmem body, in words.
__host__ __device__ constexpr int gmem_a_words(int P, int Q) {
  return cmax(3 * P * P * P, 9 * P * Q * Q);
}
__host__ __device__ constexpr int gmem_words(int P, int Q) {
  return gmem_a_words(P, Q) + cmax(6 * P * P * Q, 9 * Q * Q * Q);
}

// The phases of the gmem body on element e0, its buffers A and B at bufA
// and bufB (a block's slice of the global workspace). sB, sD: B and D in
// shared memory, whose loads the caller issues first; the barrier after
// the gather completes them. No barrier at the end: a next element's
// gather writes only buffer A, which the adjoint x phase no longer reads.
template <int PH, bool JAC, typename T>
__device__ __forceinline__ void generic_tile(
    int P, int Q, int e0, const T* sB, const T* sD, T* bufA, T* bufB,
    const T* __restrict__ u, long long N,
    const long long* __restrict__ conn, int nelem,
    const T* __restrict__ qdata, T* __restrict__ stash, T* __restrict__ ve,
    T a, T b) {
  constexpr bool kStashIn = JAC && Pointwise<PH>::kStash;
  const int P2 = P * P, P3 = P2 * P, Q2 = Q * Q, Q3 = Q2 * Q;
  const int T1 = 3 * P2 * Q;   // one t1 (and adjoint t1) array
  const int T2 = 3 * Q2 * P;   // one t2 (and adjoint t2) array
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const size_t plane = (size_t)nelem * Q3;
  const size_t off0 = (size_t)e0 * Q3;  // the element's first point

  // ---- the nodal gather into ue ----
  const long long* ce = conn + (size_t)e0 * P3;
  for (int i = tid; i < P3; i += NT) {
    const long long node = ce[i];
    T* ue = bufA + i;
    for (int c = 0; c < 3; ++c) ue[c * P3] = u[c * N + node];
  }
  __syncthreads();

  // ---- forward x: t1[0] = B_x u, t1[1] = D_x u at (c, pz, qx, py) ----
  for (int j = tid; j < T1; j += NT) {  // ((c * P + pz) * Q + qx) * P + py
    const int py = j % P;
    const int qx = (j / P) % Q;
    const int rp = j / (P * Q);  // c * P + pz
    const T* x = bufA + (rp * P + py) * P;
    const T* bq = sB + qx * P;
    const T* dq = sD + qx * P;
    T bs = T(0), ds = T(0);
    for (int px = 0; px < P; ++px) {
      bs += bq[px] * x[px];
      ds += dq[px] * x[px];
    }
    T* o = bufB + j;
    o[0] = bs;
    o[T1] = ds;
  }
  __syncthreads();

  // ---- forward y: t2[0] = B_y D_x u, t2[1] = D_y B_x u, t2[2] = B_y B_x u
  // at (c, qy, qx, pz) ----
  for (int j = tid; j < T2; j += NT) {  // ((c * Q + qy) * Q + qx) * P + pz
    const int pz = j % P;
    const int qx = (j / P) % Q;
    const int qy = (j / (P * Q)) % Q;
    const int c = j / (P * Q2);
    const T* x0 = bufB + (((c * P + pz) * Q + qx) * P);
    const T* x1 = x0 + T1;
    const T* bq = sB + qy * P;
    const T* dq = sD + qy * P;
    T bd = T(0), db = T(0), bb = T(0);
    for (int py = 0; py < P; ++py) {
      bd += bq[py] * x1[py];
      db += dq[py] * x0[py];
      bb += bq[py] * x0[py];
    }
    T* o = bufA + j;
    o[0] = bd;
    o[T2] = db;
    o[2 * T2] = bb;
  }
  __syncthreads();

  // ---- forward z + pointwise physics, one quadrature point a thread at a
  // time (q = (qz * Q + qy) * Q + qx) ----
  for (int q = tid; q < Q3; q += NT) {
    const int qz = q / Q2;
    const int qxy = q - qz * Q2;  // qy * Q + qx
    const T* bz = sB + qz * P;
    const T* dz = sD + qz * P;
    T du[9];
    for (int c = 0; c < 3; ++c) {
      const T* r0 = bufA + (c * Q2 + qxy) * P;
      const T* r1 = r0 + T2;
      const T* r2 = r0 + 2 * T2;
      T a0 = T(0), a1 = T(0), a2 = T(0);
      for (int pz = 0; pz < P; ++pz) {
        a0 += bz[pz] * r0[pz];
        a1 += bz[pz] * r1[pz];
        a2 += dz[pz] * r2[pz];
      }
      du[3 * c + 0] = a0;
      du[3 * c + 1] = a1;
      du[3 * c + 2] = a2;
    }
    const size_t off = off0 + q;
    const T wdetJ = qdata[off];
    T X[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = qdata[(1 + k) * plane + off];
    T dv[9], g[9];
    if constexpr (JAC) {
      if constexpr (kStashIn) {
#pragma unroll
        for (int k = 0; k < 9; ++k) g[k] = stash[k * plane + off];
      }
      jacobian_point<PH>(du, X, wdetJ, g, a, b, dv);
    } else {
      residual_point<PH>(du, X, wdetJ, a, b, dv, g);
      if constexpr (Pointwise<PH>::kStash) {
#pragma unroll
        for (int k = 0; k < 9; ++k) stash[k * plane + off] = g[k];
      }
    }
    T* o = bufB + q;
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k * Q3] = dv[k];
  }
  __syncthreads();

  // ---- adjoint z: adjoint t2[0] = B_z^T dv[3c], t2[1] = B_z^T dv[3c+1],
  // t2[2] = D_z^T dv[3c+2] at (c, pz, qx, qy) ----
  for (int j = tid; j < T2; j += NT) {  // ((c * P + pz) * Q + qx) * Q + qy
    const int qy = j % Q;
    const int qx = (j / Q) % Q;
    const int pz = (j / Q2) % P;
    const int c = j / (Q2 * P);
    const T* d = bufB + 3 * c * Q3 + qy * Q + qx;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int qz = 0; qz < Q; ++qz) {
      const T bt = sB[qz * P + pz], dt = sD[qz * P + pz];
      a0 += bt * d[qz * Q2];
      a1 += bt * d[Q3 + qz * Q2];
      a2 += dt * d[2 * Q3 + qz * Q2];
    }
    T* o = bufA + j;
    o[0] = a0;
    o[T2] = a1;
    o[2 * T2] = a2;
  }
  __syncthreads();

  // ---- adjoint y: adjoint t1[0] = B_y^T t2[0], t1[1] = D_y^T t2[1] +
  // B_y^T t2[2] at (c, pz, py, qx) ----
  for (int j = tid; j < T1; j += NT) {  // ((c * P + pz) * P + py) * Q + qx
    const int qx = j % Q;
    const int py = (j / Q) % P;
    const int rp = j / (Q * P);  // c * P + pz
    const T* y0 = bufA + (rp * Q + qx) * Q;
    const T* y1 = y0 + T2;
    const T* y2 = y0 + 2 * T2;
    T bx = T(0), bb = T(0);
    for (int qy = 0; qy < Q; ++qy) {
      const T bt = sB[qy * P + py], dt = sD[qy * P + py];
      bx += bt * y0[qy];
      bb += dt * y1[qy] + bt * y2[qy];
    }
    T* o = bufB + j;
    o[0] = bx;
    o[T1] = bb;
  }
  __syncthreads();

  // ---- adjoint x: ve = D_x^T t1[0] + B_x^T t1[1] at (c, e, pz, py, px),
  // written straight to global memory ----
  for (int i = tid; i < 3 * P3; i += NT) {
    const int c = i / P3;
    const int p = i - c * P3;  // (pz * P + py) * P + px
    const int px = p % P;
    const T* x0 = bufB + (c * P2 + p / P) * Q;
    const T* x1 = x0 + T1;
    T acc = T(0);
    for (int qx = 0; qx < Q; ++qx)
      acc += sD[qx * P + px] * x0[qx] + sB[qx * P + px] * x1[qx];
    ve[((size_t)c * nelem + e0) * P3 + p] = acc;
  }
}

// B and D (Q x P each) into shared memory at sB and sB + Q P.
template <typename T>
__device__ __forceinline__ void load_bd(int P, int Q, const T* __restrict__ Bg,
                                        const T* __restrict__ Dg, T* sB) {
  for (int i = threadIdx.x; i < Q * P; i += blockDim.x) {
    sB[i] = Bg[i];
    sB[Q * P + i] = Dg[i];
  }
}

// ---------------------------------------------------------------------------
// The global-memory body (generic_gmem_kernel, "gmem"): every generic
// (physics, P, Q) above kGenericRegCap whose element no cluster of
// kClusterMax CTAs holds in shared memory. It runs generic_tile, one
// element at a time, with buffers A and B in the block's slice
// of a global-memory workspace (A + B words a block; the wrapper allocates
// the workspace through torch's caching allocator); B and D stay in shared
// memory (2 Q P words). The grid is persistent: min(nelem,
// kGmemBlocksPerSm x SMs) blocks of kGenericThreads threads, block k taking
// elements k, k + gridDim.x, ...
// What bounds it on the card: the buffers' traffic. Every contraction
// operand is a load from the workspace (an element's buffers are 243 KB at
// (15, 15) f32 and 249 KB at (12, 12) f64, more than an SM's L1, so most
// come from L2), and at the solves' 125-216 elements about one block of
// 256 threads runs an SM. It runs only where no cluster of kClusterMax
// CTAs holds an element (the cluster body below): P = Q >= 23 in f64,
// >= 29 in f32.
// ---------------------------------------------------------------------------
constexpr int kGmemBlocksPerSm = 2;

template <int PH, bool JAC, typename T>
__global__ void __launch_bounds__(kGenericThreads)
generic_gmem_kernel(int P, int Q, int A, int B1, T* work,
                    const T* __restrict__ u, long long N,
                    const long long* __restrict__ conn, int nelem,
                    const T* __restrict__ qdata, const T* __restrict__ Bg,
                    const T* __restrict__ Dg, T* __restrict__ stash,
                    T* __restrict__ ve, T a, T b) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sB = reinterpret_cast<T*>(smem);
  load_bd(P, Q, Bg, Dg, sB);
  T* bufA = work + (size_t)blockIdx.x * (A + B1);
  for (int e = blockIdx.x; e < nelem; e += gridDim.x)
    generic_tile<PH, JAC, T>(P, Q, e, sB, sB + Q * P, bufA, bufA + A, u, N,
                             conn, nelem, qdata, stash, ve, a, b);
}

// ---------------------------------------------------------------------------
// The cluster body (generic_cluster_kernel, "cluster"): every generic
// (physics, P, Q) above kGenericRegCap whose element a thread-block cluster
// of at most kClusterMax CTAs holds in shared memory. It replaces, as every
// generic body does, ceedpetscsolid_tpu/ops/pallas_apply.py::_apply_kernel
// (residual with the stash out, J.v with it in; all five physics, f32 and
// f64, P and Q at run time).
// What bounds it on the card: memory, on paper (ops/fused_apply.bound_ms:
// qdata, the stash, u, conn and ve once each; 0.0134 ms for hyperFS J.v at
// (15, 15) f32 on 5^3, 0.0227 ms at (12, 12) f64 on 6^3). What held the
// bodies it replaces far below that: the gmem body kept an element's
// buffers (243-249 KB) in a global workspace, so every contraction operand
// was an L2 load, with one 256-thread block an element on 125-216 of 132
// SMs; the shared-memory body (one element a 256-thread block, since
// removed) fit an element into one block only up to (11, 11) f64 and
// (14, 14) f32, at one or two blocks an SM, every operand a shared load.
// Design: one cluster of k CTAs (kGenericThreads threads each) an element,
// its buffers split between the CTAs' shared memory, so no operand leaves
// the chip. k comes from the plan (cluster_size): at least the fewest CTAs
// whose share fits a block's opt-in shared memory, more while the element
// count leaves the SMs short of CTAs, or a CTA too big to share its SM.
// CTA r owns
//   the pz-slabs [r nzc, r nzc + nzc) (nzc = ceil(P / k)): the gather,
//       forward x and y, adjoint y and x, which read and write one slab;
//   the (qy, qx) columns [r ncc, r ncc + ncc) (ncc = ceil(Q^2 / k)):
//       forward z, the physics and adjoint z, which need a whole column
//       and all three components at a point. The column owner's points of
//       one qz are consecutive in qdata and the stash, so their per-point
//       streams are read coalesced, straight from global memory.
// Two exchanges move the data between the two owners, through
// distributed shared memory (map_shared_rank): forward y stores its t2
// values into the column owners' region A, adjoint z its adjoint t2 into
// the slab owners' region A; each moves 9 Q^2 P words an element, (k-1)/k
// of them remote. Per CTA, region A: t2 of its columns [3][c][pz][col]
// (9 P ncc), then adjoint t2 of its slabs [3][c][zl][qy qx] (9 nzc Q^2);
// region B: ue [c][zl][py][px] and t1 [2][c][zl][py][qx] (3 nzc P^2 +
// 6 nzc P Q), then dv [9][qz][col] (9 Q ncc), then adjoint t1
// [2][c][zl][py][qx]. A and B alias phase to phase as the gmem body's two
// buffers do, so a cluster holds 18 P^3 words at P = Q, as one block would;
// the price is a third cluster barrier: peers store into region A
// at any time between two barriers, so it may hold only the data of one
// exchange: the barriers fall after forward y, after the physics (the t2
// in region A is read) and after adjoint z. Every CTA signals its start
// before its gather and waits for its peers' before its first remote
// store. Inside a CTA a contraction phase gives a thread the three
// components of a line position and two positions half the free direction
// apart (a row of B or D loaded once serves three lines, a line loaded
// once serves two rows), with a block barrier between local phases;
// forward z writes du into region B and the physics, one point a thread,
// reads it back there, so that the physics alone holds the registers it
// needs. The layouts put consecutive threads on consecutive words of a row
// and broadcast B or D (B^T and D^T held transposed for forward x), so a
// warp's shared loads meet no bank conflict. Registers: __launch_bounds__
// asks for 3 CTAs an SM in f32 (80 registers a thread) and 2 in f64 (128);
// at the first design's 151 (hyperFS J.v f64) one CTA ran an SM. One
// element a cluster, nelem clusters: no CTA touches a peer after the last
// barrier, so each may exit at its end.
// ---------------------------------------------------------------------------
constexpr int kClusterMax = 8;  // CTAs a cluster: the portable limit
// CTAs an SM that __launch_bounds__ asks registers for: in f32 3 x 256
// threads, at most 85 registers a thread; in f64 2, at most 128
__host__ __device__ constexpr int cluster_min_ctas(int tsize) {
  return tsize == 4 ? 3 : 2;
}
// the most shared memory a CTA may take for two to share an SM
constexpr size_t kClusterPairSmem = (kSmSmem - 2 * kBlockReserve) / 2;

struct ClusterPlan {
  int nzc;      // pz-slabs a CTA
  int ncc;      // (qy, qx) columns a CTA
  int a_words;  // region A a CTA
  int b_words;  // region B a CTA
  size_t smem;  // dynamic shared memory a CTA, bytes: B, D, B^T, D^T, A, B
};

__host__ __device__ constexpr ClusterPlan cluster_plan(int P, int Q,
                                                       int tsize, int k) {
  const int nzc = (P + k - 1) / k, ncc = (Q * Q + k - 1) / k;
  const int a = cmax(9 * P * ncc, 9 * nzc * Q * Q);
  const int b = cmax(3 * nzc * P * P + 6 * nzc * P * Q, 9 * Q * ncc);
  return ClusterPlan{nzc, ncc, a, b, (size_t)tsize * (4 * Q * P + a + b)};
}

// The fewest CTAs, at most kClusterMax, whose share fits `optin` bytes; 0
// when none does.
__host__ __device__ constexpr int cluster_fewest(int P, int Q, int tsize,
                                                 int optin) {
  for (int k = 1; k <= kClusterMax; ++k)
    if (cluster_plan(P, Q, tsize, k).smem <= (size_t)optin) return k;
  return 0;
}

// The plan's cluster size for `nelem` elements on `sms` SMs: the fewest
// CTAs that fit, doubled (within kClusterMax) while a CTA's share leaves
// no room for a second CTA on its SM, which the registers would allow, or
// the grid has fewer CTAs than the card has SMs. Measured on the H100
// (PERF.md §6, in turns): at phase 19's four shapes it picks the fastest
// of the fewest, twice and four times as many CTAs.
__host__ __device__ constexpr int cluster_size(int P, int Q, int tsize,
                                               int nelem, int sms,
                                               int optin) {
  int k = cluster_fewest(P, Q, tsize, optin);
  while (k > 0 && 2 * k <= kClusterMax &&
         (cluster_plan(P, Q, tsize, k).smem > kClusterPairSmem ||
          (long long)nelem * k < sms))
    k *= 2;
  return k;
}

// The cluster barrier in its two halves (barrier.cluster: every thread of
// every CTA arrives; arrive releases, wait acquires).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int PH, bool JAC, typename T>
__global__ void __launch_bounds__(kGenericThreads,
                                  cluster_min_ctas(sizeof(T)))
generic_cluster_kernel(int P, int Q, int A, const T* __restrict__ u,
                       long long N, const long long* __restrict__ conn,
                       int nelem, const T* __restrict__ qdata,
                       const T* __restrict__ Bg, const T* __restrict__ Dg,
                       T* __restrict__ stash, T* __restrict__ ve, T a, T b) {
  constexpr bool kStashIn = JAC && Pointwise<PH>::kStash;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / k;
  const int P2 = P * P, P3 = P2 * P, Q2 = Q * Q, Q3 = Q2 * Q;
  const int nzc = (P + k - 1) / k, ncc = (Q2 + k - 1) / k;
  const int z0 = r * nzc, nz = max(0, min(nzc, P - z0));
  const int c0 = r * ncc, nc = max(0, min(ncc, Q2 - c0));
  const int tid = threadIdx.x, NT = blockDim.x;
  T* sB = reinterpret_cast<T*>(smem);  // B[q][p]
  T* sD = sB + Q * P;                  // D[q][p]
  T* sBT = sD + Q * P;                 // B^T[p][q]
  T* sDT = sBT + Q * P;                // D^T[p][q]
  T* RA = sDT + Q * P;                 // region A
  T* RB = RA + A;                      // region B
  T* t1 = RB + 3 * nzc * P2;           // t1 [2][c][zl][py][qx]
  const int T1S = 3 * nzc * P * Q;     // one t1 (and adjoint t1) array
  const int T2S = 3 * P * ncc;         // one t2 array of the columns
  const int A2S = 3 * nzc * Q2;        // one adjoint t2 array of the slabs
  const int DVS = Q * ncc;             // one du / dv plane of the columns
  const size_t plane = (size_t)nelem * Q3;

  for (int i = tid; i < Q * P; i += NT) {
    const int q = i / P, p = i - q * P;
    const T bv = Bg[i], dv = Dg[i];
    sB[i] = bv;
    sD[i] = dv;
    sBT[p * Q + q] = bv;
    sDT[p * Q + q] = dv;
  }
  cluster_arrive();  // started: peers may store into this CTA

  // ---- the gather of the CTA's slabs into ue ----
  {
    const long long* ce = conn + (size_t)e * P3 + (size_t)z0 * P2;
    for (int i = tid; i < nz * P2; i += NT) {
      const long long node = ce[i];
      T* ue = RB + i;  // (zl * P + py) * P + px = i
      for (int c = 0; c < 3; ++c) ue[c * nzc * P2] = u[c * N + node];
    }
  }
  __syncthreads();

  // Every phase below gives a thread the three components of a line
  // position (one row of B or D serves three lines) and two positions of
  // the free direction h apart (h = ceil(n / 2)), so one load of a line's
  // values serves two rows of B or D, or one row of B or D two lines.
  const int hp = (P + 1) / 2, hq = (Q + 1) / 2;
  const int US = nzc * P2;      // one component of ue
  const int TS = nzc * P * Q;   // one component of a t1 (or adjoint t1)
  const int CS = P * ncc;       // one component of a column t2
  const int AS = nzc * Q2;      // one component of a slab adjoint t2

  // ---- forward x: t1[0] = B_x u, t1[1] = D_x u at (c, zl, py, qx), rows
  // py and py + hp ----
  for (int i = tid; i < nz * hp * Q; i += NT) {
    const int qx = i % Q, rr = i / Q;
    const int py = rr % hp, zl = rr / hp;
    const bool two = py + hp < P;
    const T* x = RB + (zl * P + py) * P;
    T bs[2][3] = {}, ds[2][3] = {};
#pragma unroll 2
    for (int px = 0; px < P; ++px) {
      const T bt = sBT[px * Q + qx], dt = sDT[px * Q + qx];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T x0 = x[c * US + px];
        const T x1 = two ? x[c * US + hp * P + px] : T(0);
        bs[0][c] += bt * x0;
        ds[0][c] += dt * x0;
        bs[1][c] += bt * x1;
        ds[1][c] += dt * x1;
      }
    }
    T* o = t1 + (zl * P + py) * Q + qx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c * TS] = bs[0][c];
      o[T1S + c * TS] = ds[0][c];
      if (two) {
        o[c * TS + hp * Q] = bs[1][c];
        o[T1S + c * TS + hp * Q] = ds[1][c];
      }
    }
  }
  __syncthreads();
  cluster_wait();  // every peer has started

  // ---- forward y: t2[0] = B_y D_x u, t2[1] = D_y B_x u, t2[2] = B_y B_x u
  // at (c, pz, col), rows qy and qy + hq, stored into the column owner's
  // region A ----
  for (int i = tid; i < nz * hq * Q; i += NT) {
    const int qx = i % Q, rr = i / Q;
    const int qy = rr % hq, zl = rr / hq;
    const bool two = qy + hq < Q;
    const T* x0 = t1 + zl * P * Q + qx;  // t1[0], then t1[1] at + T1S
    const T* b0 = sB + qy * P;
    const T* d0 = sD + qy * P;
    const T* b1 = two ? b0 + hq * P : b0;
    const T* d1 = two ? d0 + hq * P : d0;
    T acc[2][3][3] = {};  // [row][c][bd, db, bb]
#pragma unroll 2
    for (int py = 0; py < P; ++py) {
      const T bv0 = b0[py], dv0 = d0[py], bv1 = b1[py], dv1 = d1[py];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T xb = x0[c * TS + py * Q], xd = x0[T1S + c * TS + py * Q];
        acc[0][c][0] += bv0 * xd;
        acc[0][c][1] += dv0 * xb;
        acc[0][c][2] += bv0 * xb;
        acc[1][c][0] += bv1 * xd;
        acc[1][c][1] += dv1 * xb;
        acc[1][c][2] += bv1 * xb;
      }
    }
    const int pz = z0 + zl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
      const int col = (qy + h * hq) * Q + qx;
      const int o = col / ncc, lc = col - o * ncc;
      T* dst = cluster.map_shared_rank(RA, o) + pz * ncc + lc;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dst[c * CS] = acc[h][c][0];
        dst[T2S + c * CS] = acc[h][c][1];
        dst[2 * T2S + c * CS] = acc[h][c][2];
      }
    }
  }
  cluster.sync();  // every column's t2 is in

  // ---- forward z: du[3c + k] at (qz, col), rows qz and qz + hq, into
  // the du planes of region B ----
  for (int i = tid; i < hq * nc; i += NT) {
    const int qz = i / nc, lc = i - qz * nc;
    const bool two = qz + hq < Q;
    const T* b0 = sB + qz * P;
    const T* d0 = sD + qz * P;
    const T* b1 = two ? b0 + hq * P : b0;
    const T* d1 = two ? d0 + hq * P : d0;
    const T* t2 = RA + lc;  // t2[k][c][pz][col] at k T2S + c CS + pz ncc
    T du[2][9] = {};
#pragma unroll 2
    for (int pz = 0; pz < P; ++pz) {
      const T bv0 = b0[pz], dv0 = d0[pz], bv1 = b1[pz], dv1 = d1[pz];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* r0 = t2 + c * CS + pz * ncc;
        const T y0 = r0[0], y1 = r0[T2S], y2 = r0[2 * T2S];
        du[0][3 * c + 0] += bv0 * y0;
        du[0][3 * c + 1] += bv0 * y1;
        du[0][3 * c + 2] += dv0 * y2;
        du[1][3 * c + 0] += bv1 * y0;
        du[1][3 * c + 1] += bv1 * y1;
        du[1][3 * c + 2] += dv1 * y2;
      }
    }
    T* o = RB + qz * ncc + lc;
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      o[m * DVS] = du[0][m];
      if (two) o[m * DVS + hq * ncc] = du[1][m];
    }
  }
  __syncthreads();

  // ---- pointwise physics, one point (qz, col) of the CTA's columns a
  // thread at a time; dv overwrites du in place ----
  for (int i = tid; i < Q * nc; i += NT) {
    const int qz = i / nc, lc = i - qz * nc;
    const size_t off = (size_t)e * Q3 + (size_t)qz * Q2 + c0 + lc;
    T* o = RB + qz * ncc + lc;
    T du[9], X[9], dv[9], g[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) du[m] = o[m * DVS];
    const T wdetJ = qdata[off];
#pragma unroll
    for (int m = 0; m < 9; ++m) X[m] = qdata[(1 + m) * plane + off];
    if constexpr (JAC) {
      if constexpr (kStashIn) {
#pragma unroll
        for (int m = 0; m < 9; ++m) g[m] = stash[m * plane + off];
      }
      jacobian_point<PH>(du, X, wdetJ, g, a, b, dv);
    } else {
      residual_point<PH>(du, X, wdetJ, a, b, dv, g);
      if constexpr (Pointwise<PH>::kStash) {
#pragma unroll
        for (int m = 0; m < 9; ++m) stash[m * plane + off] = g[m];
      }
    }
#pragma unroll
    for (int m = 0; m < 9; ++m) o[m * DVS] = dv[m];
  }
  cluster.sync();  // no CTA reads its t2 any more

  // ---- adjoint z: adjoint t2[0] = B_z^T dv[3c], [1] = B_z^T dv[3c+1],
  // [2] = D_z^T dv[3c+2] at (c, pz, col), rows pz and pz + hp, stored
  // into the slab owner's region A ----
  for (int i = tid; i < hp * nc; i += NT) {
    const int pz = i / nc, lc = i - pz * nc;
    const bool two = pz + hp < P;
    const int pz1 = two ? pz + hp : pz;
    const T* d = RB + lc;  // dv[m][qz][col] at m DVS + qz ncc
    T acc[2][9] = {};
#pragma unroll 2
    for (int qz = 0; qz < Q; ++qz) {
      const T bt0 = sB[qz * P + pz], dt0 = sD[qz * P + pz];
      const T bt1 = sB[qz * P + pz1], dt1 = sD[qz * P + pz1];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* r0 = d + 3 * c * DVS + qz * ncc;
        const T v0 = r0[0], v1 = r0[DVS], v2 = r0[2 * DVS];
        acc[0][3 * c + 0] += bt0 * v0;
        acc[0][3 * c + 1] += bt0 * v1;
        acc[0][3 * c + 2] += dt0 * v2;
        acc[1][3 * c + 0] += bt1 * v0;
        acc[1][3 * c + 1] += bt1 * v1;
        acc[1][3 * c + 2] += dt1 * v2;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
      const int p = pz + h * hp;
      const int s = p / nzc, zl = p - s * nzc;
      T* dst = cluster.map_shared_rank(RA, s) + zl * Q2 + c0 + lc;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dst[c * AS] = acc[h][3 * c + 0];
        dst[A2S + c * AS] = acc[h][3 * c + 1];
        dst[2 * A2S + c * AS] = acc[h][3 * c + 2];
      }
    }
  }
  cluster.sync();  // every slab's adjoint t2 is in; no peer touches this
                   // CTA any more

  // ---- adjoint y: adjoint t1[0] = B_y^T a2[0], [1] = D_y^T a2[1] +
  // B_y^T a2[2] at (c, zl, py, qx), rows py and py + hp ----
  for (int i = tid; i < nz * hp * Q; i += NT) {
    const int qx = i % Q, rr = i / Q;
    const int py = rr % hp, zl = rr / hp;
    const bool two = py + hp < P;
    const int py1 = two ? py + hp : py;
    const T* y = RA + zl * Q2 + qx;  // a2[k][c][zl][qy qx] at k A2S + c AS
    T bx[2][3] = {}, bb[2][3] = {};
#pragma unroll 2
    for (int qy = 0; qy < Q; ++qy) {
      const T bt0 = sB[qy * P + py], dt0 = sD[qy * P + py];
      const T bt1 = sB[qy * P + py1], dt1 = sD[qy * P + py1];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* r0 = y + c * AS + qy * Q;
        const T y0 = r0[0], y1 = r0[A2S], y2 = r0[2 * A2S];
        bx[0][c] += bt0 * y0;
        bb[0][c] += dt0 * y1 + bt0 * y2;
        bx[1][c] += bt1 * y0;
        bb[1][c] += dt1 * y1 + bt1 * y2;
      }
    }
    T* o = RB + (zl * P + py) * Q + qx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c * TS] = bx[0][c];
      o[T1S + c * TS] = bb[0][c];
      if (two) {
        o[c * TS + hp * Q] = bx[1][c];
        o[T1S + c * TS + hp * Q] = bb[1][c];
      }
    }
  }
  __syncthreads();

  // ---- adjoint x: ve = D_x^T a1[0] + B_x^T a1[1] at (c, e, pz, py, px),
  // columns px and px + hp, written straight to global memory ----
  for (int i = tid; i < nz * P * hp; i += NT) {
    const int px = i % hp, rr = i / hp;
    const int py = rr % P, zl = rr / P;
    const bool two = px + hp < P;
    const int px1 = two ? px + hp : px;
    const T* x = RB + (zl * P + py) * Q;  // a1[k][c][zl][py][qx]
    T acc[2][3] = {};
#pragma unroll 2
    for (int qx = 0; qx < Q; ++qx) {
      const T d0 = sD[qx * P + px], b0 = sB[qx * P + px];
      const T d1 = sD[qx * P + px1], b1 = sB[qx * P + px1];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T x0 = x[c * TS + qx], x1 = x[T1S + c * TS + qx];
        acc[0][c] += d0 * x0 + b0 * x1;
        acc[1][c] += d1 * x0 + b1 * x1;
      }
    }
    T* o = ve + (size_t)e * P3 + (size_t)(z0 + zl) * P2 + py * P + px;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[(size_t)c * nelem * P3] = acc[0][c];
      if (two) o[(size_t)c * nelem * P3 + hp] = acc[1][c];
    }
  }
}

// ---------------------------------------------------------------------------
// The generic tile's register bodies (generic_reg_kernel): every generic
// (physics, P, Q) with P, Q <= kGenericRegCap, which holds every pair the
// solves launch (the pressure term at (P, 2..3) on each p-multigrid level,
// hyperFS (7, 7) at degree 6). P and Q stay run-time arguments; the rows a
// thread holds are register arrays of a compile-time cap (PC >= P,
// QC >= Q), their loops unrolled to the cap and cut at P or Q, so a cap
// near the shape wastes few issue slots. Bodies (generic_body, chosen by
// shape; generic_launch sizes the tile):
//   warp3x2 (PC 3, QC 2), warp6x2 (6, 2), warp8x3 (8, 3): Q <= 3, a tile's
//       points fit a warp: a block is one warp that owns a tile of E <= 32
//       / Q^3 elements; phases meet at __syncwarp.
//   block8x8 (8, 8): 4 <= Q <= 8: a block owns a tile of E <= 256 / Q^3
//       elements, its points (or lines) spread evenly over the fewest
//       passes of at most kGenericThreads threads (343 points: 2 x 172, 192
//       threads); one __syncthreads a phase.
// The grid: one block a tile, and as many tiles as it takes to give the
// card's SMs about kGenericWarpsPerSm warp tiles (block tiles: one) each
// before a tile takes more elements: at phase 14's 512 elements (5, 2)
// runs E = 1, 512 one-warp blocks (the shared-memory body: 22 blocks of
// 24); at 24^3 E = 4, 3,456 blocks.
// A phase gives a thread whole lines: the P (or Q) inputs of a line read
// once from shared memory into registers, every output of the line, for B
// and for D, made from them. In a warp tile forward x, forward y and
// adjoint x take all three components of a line position (NC = 3: one
// B/D row and one index computation serve three lines); a block tile
// takes one component a line (NC = 1: with one element a tile, three
// positions' worth of threads). Line positions advance by a stride
// decomposed once (LineWalk), so no phase divides by P or Q. B and D: in
// f32, at PC QC <= 32 (the warp bodies), loaded into registers at each
// phase's start; else read as 16-byte rows of padded shared copies (the
// same row for every thread: a broadcast). qdata's 10 planes, and in J.v
// the stash's 9, are issued at the tile's start by TMA bulk copies
// (bulk_path) or cp.async, and land during the gather and the forward
// contractions; the gather issues a batch of kGatherBatch node ids, then
// their values. Rows are padded to an odd length (PP = P | 1, QQ = Q | 1),
// so that the lines of a warp, which read rows one row apart, fall in
// distinct banks. ve is staged in shared memory and written out coalesced.
// What holds it (PERF.md §6): at the solves' small meshes the chain
// of one tile (two dependent global loads, seven phases, the physics) and
// the launch; at 24^3 the instructions a tile issues and the warps an SM's
// shared memory holds (13 tiles of 16 KB at (5, 2)).
// Per element (words), buffer A and buffer B:
//   A: ue [c][pz][py] rows of PP -> t2 [bd|db|bb][c][qy][qx] rows of PP
//      -> adjoint t2 [0|1|2][c][pz][qx] rows of QQ -> ve (staged)
//   B: t1 [b|d][c][pz][qx] rows of PP -> du/dv planes [3c+k] of the tile's
//      points -> adjoint t1 [0|1][c][pz][py] rows of QQ
// ---------------------------------------------------------------------------
constexpr int kGenericRegCap = 8;      // P, Q above it: the smem or gmem body
constexpr int kGenericWarpQ = 3;       // Q <= 3: a warp a tile
constexpr int kGenericWarpsPerSm = 4;  // tiles an SM before E grows
constexpr int kGatherBatch = 4;        // node ids in flight a thread

enum GenericBody {   // 0: retired (a shared-memory body, one CTA a tile)
  kBodyWarp3x2 = 1,  // warp team, PC = 3, QC = 2
  kBodyWarp6x2 = 2,  // warp team, PC = 6, QC = 2
  kBodyWarp8x3 = 3,  // warp team, PC = 8, QC = 3
  kBodyBlock8 = 4,   // block team, PC = 8, QC = 8
  kBodyGmem = 5,     // generic_gmem_kernel, where no cluster of
                     // kClusterMax CTAs holds an element
  kBodyCluster = 6,  // generic_cluster_kernel, above the register cap
  kNumBodies = 7
};

// The body at (P, Q) in words of `tsize` bytes, on a device whose blocks
// may opt in to `optin` bytes of dynamic shared memory.
__host__ __device__ constexpr int generic_body(int P, int Q, int tsize,
                                               int optin) {
  return P > kGenericRegCap || Q > kGenericRegCap
             ? (cluster_fewest(P, Q, tsize, optin) > 0 ? kBodyCluster
                                                       : kBodyGmem)
         : Q > kGenericWarpQ ? kBodyBlock8
         : Q > 2 || P > 6    ? kBodyWarp8x3
         : P > 3             ? kBodyWarp6x2
                             : kBodyWarp3x2;
}
// Whether a body is one of the register bodies (which stage the streams).
__host__ __device__ constexpr bool reg_body(int body) {
  return body != kBodyGmem && body != kBodyCluster;
}
__host__ __device__ constexpr int body_pc(int body) {
  return body == kBodyWarp3x2 ? 3 : body == kBodyWarp6x2 ? 6 : 8;
}
__host__ __device__ constexpr int body_qc(int body) {
  return body == kBodyBlock8 ? 8 : body == kBodyWarp8x3 ? 3 : 2;
}

struct GenericLaunch {
  int body;          // GenericBody
  int elems;         // E, elements a tile (one tile a block)
  int threads;       // threads a block
  int planes;        // per-point streams staged (register bodies)
  int plane_stride;  // words between staged planes
  int a_words;       // buffer A an element
  int b_words;       // buffer B an element
  int bd_words;      // B, D (Q rows of PCV), B^T, D^T (P rows of QCV)
  size_t smem;       // dynamic shared memory, bytes
  int tiles;         // blocks (the gmem body: its persistent grid)
  size_t work;       // the gmem body's global workspace, bytes (else 0)
  int cluster;       // the cluster body: CTAs a cluster (an element)
  int clusters;      // the cluster body: clusters (else 0)
};

// The launch of the generic tile at (P, Q) for `nelem` elements on a card
// of `sms` SMs whose blocks may opt in to `optin` bytes of shared memory
// (ops/fused_apply.py generic_plan mirrors it); `cluster` > 0 sets the
// cluster body's size instead of cluster_size.
__host__ __device__ constexpr GenericLaunch generic_launch(int P, int Q,
                                                           int tsize,
                                                           int nelem, int sms,
                                                           int planes,
                                                           int optin,
                                                           int cluster = 0) {
  GenericLaunch g{};
  g.body = generic_body(P, Q, tsize, optin);
  if (g.body == kBodyCluster) {
    const int k = cluster > 0 ? cluster
                              : cluster_size(P, Q, tsize, nelem, sms, optin);
    const ClusterPlan c = cluster_plan(P, Q, tsize, k);
    g.elems = 1;
    g.threads = kGenericThreads;
    g.a_words = c.a_words;
    g.b_words = c.b_words;
    g.smem = c.smem;
    g.cluster = k;
    g.clusters = nelem;
    g.tiles = nelem * k;
    return g;
  }
  if (g.body == kBodyGmem) {
    // one element a block at a time, B and D alone in shared memory
    g.threads = kGenericThreads;
    g.a_words = gmem_a_words(P, Q);
    g.b_words = gmem_words(P, Q) - g.a_words;
    g.elems = 1;
    g.smem = (size_t)tsize * 2 * Q * P;
    g.tiles = cmin(nelem, kGmemBlocksPerSm * sms);
    g.work = (size_t)tsize * g.tiles * gmem_words(P, Q);
    return g;
  } else {
    const int PC = body_pc(g.body), QC = body_qc(g.body);
    const int V = 16 / tsize, Q3 = Q * Q * Q, PP = P | 1, QQ = Q | 1;
    const bool warp = g.body != kBodyBlock8;
    g.planes = planes;
    g.a_words = cmax(cmax(3 * P * P * PP, 9 * Q * Q * PP), 9 * P * Q * QQ);
    g.b_words = cmax(cmax(6 * P * Q * PP, 9 * Q3), 6 * P * P * QQ);
    g.bd_words = 2 * Q * round_up(PC, V) + 2 * P * round_up(QC, V);
    const int most = warp ? cmax(1, 32 / Q3) : cmax(1, kGenericThreads / Q3);
    int E = cmin(most,
                 cmax(1, nelem / ((warp ? kGenericWarpsPerSm : 1) * sms)));
    for (;; --E) {
      g.plane_stride = round_up(E * Q3, V) + V;
      g.smem = kBarBytes + (size_t)tsize * (g.bd_words +
                                            (size_t)planes * g.plane_stride +
                                            (size_t)E * (g.a_words + g.b_words));
      if (E == 1 || g.smem <= kGenericBudget) break;
    }
    g.elems = E;
    const int m = cmax(P, Q);
    // a block tile: its points (or lines) in as few passes of at most
    // kGenericThreads threads as may be, spread evenly over the passes
    const int n = cmax(E * Q3, 3 * E * m * m);
    const int passes = (n + kGenericThreads - 1) / kGenericThreads;
    g.threads = warp ? 32 : round_up((n + passes - 1) / passes, 32);
  }
  g.tiles = nelem > 0 ? (nelem + g.elems - 1) / g.elems : 0;
  return g;
}

template <bool WARP>
__device__ __forceinline__ void team_sync() {
  if constexpr (WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The lines start, start + stride, ... of a phase, line l = (row Ra + a)
// Rb + b: decomposed once, then advanced by adding the stride's own
// decomposition with carries.
struct LineWalk {
  int row, a, b;
  int Ra, Rb, drow, da, db;
  __device__ __forceinline__ LineWalk(int start, int stride, int Ra_, int Rb_)
      : Ra(Ra_), Rb(Rb_) {
    const int R = Ra * Rb;
    row = start / R;
    int r = start - row * R;
    a = r / Rb;
    b = r - a * Rb;
    drow = stride / R;
    r = stride - drow * R;
    da = r / Rb;
    db = r - da * Rb;
  }
  __device__ __forceinline__ void next() {
    b += db;
    int carry = 0;
    if (b >= Rb) {
      b -= Rb;
      carry = 1;
    }
    a += da + carry;
    carry = 0;
    if (a >= Ra) {
      a -= Ra;
      carry = 1;
    }
    row += drow + carry;
  }
};

// n <= N words of a shared-memory row into registers
template <int N, typename T>
__device__ __forceinline__ void ld_line(const T* src, int n, T (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = i < n ? src[i] : T(0);
}

// Rows of B, D (Q rows of PCV words, zero past P) and B^T, D^T (P rows of
// QCV, zero past Q) for one phase: held in registers (REG: f32 at PC QC <=
// 32, loaded once a phase) or read from the padded shared copies a row at a
// time, 16 bytes a load.
template <bool REG, int PC, int QC, typename T>
struct BDRows {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PCV = round_up(PC, V), QCV = round_up(QC, V);
  static constexpr int RQ = REG ? QC : 1, RP = REG ? PC : 1;
  T rB[RQ][RP], rD[RQ][RP];
  const T *sB, *sD, *sBT, *sDT;
  __device__ __forceinline__ BDRows(const T* sB_, const T* sD_,
                                    const T* sBT_, const T* sDT_)
      : sB(sB_), sD(sD_), sBT(sBT_), sDT(sDT_) {
    if constexpr (REG) {
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        ld_row<V>(sB + q * PCV, rB[q]);
        ld_row<V>(sD + q * PCV, rD[q]);
      }
    }
  }
  // row q of B and of D
  __device__ __forceinline__ void row(int q, T (&b)[PC], T (&d)[PC]) const {
    if constexpr (REG) {
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        b[p] = rB[q][p];
        d[p] = rD[q][p];
      }
    } else {
      ld_row<V>(sB + q * PCV, b);
      ld_row<V>(sD + q * PCV, d);
    }
  }
  // row p of B^T and of D^T
  __device__ __forceinline__ void col(int p, T (&b)[QC], T (&d)[QC]) const {
    if constexpr (REG) {
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        b[q] = rB[q][p];
        d[q] = rD[q][p];
      }
    } else {
      ld_row<V>(sBT + p * QCV, b);
      ld_row<V>(sDT + p * QCV, d);
    }
  }
};

template <int PH, bool JAC, typename T, int BODY>
__global__ void __launch_bounds__(BODY == kBodyBlock8 ? kGenericThreads : 32)
generic_reg_kernel(int P, int Q, int E, int PS, int A, int B1, int bd_words,
                   const T* __restrict__ u, long long N,
                   const long long* __restrict__ conn, int nelem,
                   const T* __restrict__ qdata, const T* __restrict__ Bg,
                   const T* __restrict__ Dg, T* __restrict__ stash,
                   T* __restrict__ ve, T a, T b, int bulk) {
  constexpr bool WARP = BODY != kBodyBlock8;
  constexpr int PC = body_pc(BODY), QC = body_qc(BODY);
  constexpr int V = 16 / sizeof(T);
  constexpr int PCV = round_up(PC, V), QCV = round_up(QC, V);
  constexpr bool kStashIn = JAC && Pointwise<PH>::kStash;
  constexpr int NPL = kStashIn ? 19 : 10;
  constexpr bool REG = sizeof(T) == 4 && PC * QC <= 32;
  // components a line of forward x, forward y and adjoint x: all three in a
  // warp tile (a line's B/D rows and index work serve three), one in a
  // block tile (three times the lines to spread over its threads)
  constexpr int NC = WARP ? 3 : 1, CR = 3 / NC;
  using Rows = BDRows<REG, PC, QC, T>;
  const int P2 = P * P, P3 = P2 * P, Q2 = Q * Q, Q3 = Q2 * Q;
  const int PP = P | 1, QQ = Q | 1;
  const int T1 = 3 * P * Q * PP;   // one t1 array (b or d)
  const int T2 = 3 * Q2 * PP;      // one t2 array (bd, db or bb)
  const int T2A = 3 * P * Q * QQ;  // one adjoint t2 array
  const int T1A = 3 * P2 * QQ;     // one adjoint t1 array
  const int EQ3 = E * Q3;          // a du/dv plane of the tile

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* sB = reinterpret_cast<T*>(smem + kBarBytes);  // Q rows of PCV
  T* sD = sB + Q * PCV;
  T* sBT = sD + Q * PCV;  // P rows of QCV
  T* sDT = sBT + P * QCV;
  T* slab = sB + bd_words;  // staged plane k at k * PS
  T* bufA = slab + NPL * PS;  // element e at e * A
  T* bufB = bufA + E * A;     // element e at e * B1; du/dv planes at k * EQ3

  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, nelem - e0);
  const int npts = ne * Q3;
  const size_t plane = (size_t)nelem * Q3;
  const size_t s = (size_t)e0 * Q3;  // the tile's first point in a plane
  // ...and in a staged plane (a bulk copy starts at a 16-byte boundary)
  const int off = bulk ? static_cast<int>(s & (V - 1)) : 0;

  // ---- the tile's per-point streams, in flight through the gather and the
  // forward contractions ----
  if (bulk) {
    if (tid == 0) {
      const uint32_t bytes = sizeof(T) * round_up(off + npts, V);
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, bytes * NPL);
      for (int k = 0; k < NPL; ++k) {
        const T* src = k < 10 ? qdata + k * plane : stash + (k - 10) * plane;
        bulk_load(slab + k * PS, src + (s - off), bytes, bar);
      }
    }
  } else {
    for (int k = 0; k < 10; ++k)
      for (int w = tid; w < npts; w += NT)
        cp_async_word(slab + k * PS + w, qdata + k * plane + s + w);
    if constexpr (kStashIn) {
      for (int k = 0; k < 9; ++k)
        for (int w = tid; w < npts; w += NT)
          cp_async_word(slab + (10 + k) * PS + w, stash + k * plane + s + w);
    }
  }

  // ---- B, D and B^T, D^T, zero-padded; the gather: a batch of node ids,
  // then u's three components at them ----
  for (int i = tid; i < Q * PCV; i += NT) {
    const int q = i / PCV, p = i - q * PCV;
    sB[i] = p < P ? Bg[q * P + p] : T(0);
    sD[i] = p < P ? Dg[q * P + p] : T(0);
  }
  for (int i = tid; i < P * QCV; i += NT) {
    const int p = i / QCV, q = i - p * QCV;
    sBT[i] = q < Q ? Bg[q * P + p] : T(0);
    sDT[i] = q < Q ? Dg[q * P + p] : T(0);
  }
  {
    const long long* ce = conn + (size_t)e0 * P3;
    const int n = ne * P3;
    LineWalk w(tid, NT, P2, P);  // node i = (e P^2 + pz P + py) P + px
    for (int i0 = tid; i0 < n; i0 += kGatherBatch * NT) {
      long long node[kGatherBatch];
#pragma unroll
      for (int k = 0; k < kGatherBatch; ++k) {
        const int i = i0 + k * NT;
        node[k] = i < n ? ce[i] : 0;
      }
      T val[kGatherBatch][3];
#pragma unroll
      for (int k = 0; k < kGatherBatch; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          val[k][c] = i0 + k * NT < n ? u[c * N + node[k]] : T(0);
#pragma unroll
      for (int k = 0; k < kGatherBatch; ++k) {
        if (i0 + k * NT < n) {
          T* o = bufA + w.row * A + w.a * PP + w.b;
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c * P2 * PP] = val[k][c];
        }
        w.next();
      }
    }
  }
  team_sync<WARP>();

  // ---- forward x: line (pz, py) over px, NC components -> t1 b = B_x u,
  // d = D_x u at every qx ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    for (LineWalk w(tid, NT, P, P); w.row < CR * ne; w.next()) {
      const int e = w.row / CR, c0 = (w.row - CR * e) * NC;
      T x[NC][PC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        ld_line(bufA + e * A + (((c0 + c) * P + w.a) * P + w.b) * PP, P,
                x[c]);
      T* o = bufB + e * B1 + (c0 * P + w.a) * Q * PP + w.b;
#pragma unroll
      for (int qx = 0; qx < QC; ++qx) {
        if (qx < Q) {
          T bq[PC], dq[PC];
          bd.row(qx, bq, dq);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            T bs = T(0), ds = T(0);
#pragma unroll
            for (int px = 0; px < PC; ++px) {
              if (px < P) {
                bs += bq[px] * x[c][px];
                ds += dq[px] * x[c][px];
              }
            }
            o[c * P * Q * PP + qx * PP] = bs;
            o[T1 + c * P * Q * PP + qx * PP] = ds;
          }
        }
      }
    }
  }
  team_sync<WARP>();

  // ---- forward y: line (pz, qx) over py, NC components -> t2 bd =
  // B_y D_x u, db = D_y B_x u, bb = B_y B_x u at every qy ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    for (LineWalk w(tid, NT, P, Q); w.row < CR * ne; w.next()) {
      const int e = w.row / CR, c0 = (w.row - CR * e) * NC;
      T x0[NC][PC], x1[NC][PC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = ((c0 + c) * P + w.a) * Q + w.b;
        ld_line(bufB + e * B1 + j * PP, P, x0[c]);
        ld_line(bufB + e * B1 + T1 + j * PP, P, x1[c]);
      }
      T* o = bufA + e * A + (c0 * Q2 + w.b) * PP + w.a;
#pragma unroll
      for (int qy = 0; qy < QC; ++qy) {
        if (qy < Q) {
          T bq[PC], dq[PC];
          bd.row(qy, bq, dq);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            T sbd = T(0), sdb = T(0), sbb = T(0);
#pragma unroll
            for (int py = 0; py < PC; ++py) {
              if (py < P) {
                sbd += bq[py] * x1[c][py];
                sdb += dq[py] * x0[c][py];
                sbb += bq[py] * x0[c][py];
              }
            }
            T* oc = o + c * Q2 * PP + qy * Q * PP;
            oc[0] = sbd;
            oc[T2] = sdb;
            oc[2 * T2] = sbb;
          }
        }
      }
    }
  }
  team_sync<WARP>();

  // ---- forward z: line (c, qy, qx) over pz -> du[3c + k] at every qz ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    for (LineWalk w(tid, NT, Q, Q); w.row < 3 * ne; w.next()) {
      const int e = w.row / 3, c = w.row - 3 * e;
      const int qxy = w.a * Q + w.b;
      const T* t2 = bufA + e * A + (c * Q2 + qxy) * PP;
      T r0[PC], r1[PC], r2[PC];
      ld_line(t2, P, r0);
      ld_line(t2 + T2, P, r1);
      ld_line(t2 + 2 * T2, P, r2);
      T* o = bufB + 3 * c * EQ3 + e * Q3 + qxy;
#pragma unroll
      for (int qz = 0; qz < QC; ++qz) {
        if (qz < Q) {
          T bz[PC], dz[PC];
          bd.row(qz, bz, dz);
          T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
          for (int pz = 0; pz < PC; ++pz) {
            if (pz < P) {
              a0 += bz[pz] * r0[pz];
              a1 += bz[pz] * r1[pz];
              a2 += dz[pz] * r2[pz];
            }
          }
          o[qz * Q2] = a0;
          o[EQ3 + qz * Q2] = a1;
          o[2 * EQ3 + qz * Q2] = a2;
        }
      }
    }
  }
  if (!bulk) cp_async_wait_all();
  team_sync<WARP>();
  if (bulk) mbar_wait(bar, 0);

  // ---- pointwise physics, one point of the tile a thread at a time; dv
  // overwrites du in place ----
#pragma unroll 1
  for (int pt = tid; pt < npts; pt += NT) {
    T du[9], X[9], dv[9], g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) du[k] = bufB[k * EQ3 + pt];
    const T* sl = slab + off + pt;
    const T wdetJ = sl[0];
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = sl[(1 + k) * PS];
    if constexpr (JAC) {
      if constexpr (kStashIn) {
#pragma unroll
        for (int k = 0; k < 9; ++k) g[k] = sl[(10 + k) * PS];
      }
      jacobian_point<PH>(du, X, wdetJ, g, a, b, dv);
    } else {
      residual_point<PH>(du, X, wdetJ, a, b, dv, g);
      if constexpr (Pointwise<PH>::kStash) {
#pragma unroll
        for (int k = 0; k < 9; ++k) stash[k * plane + s + pt] = g[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) bufB[k * EQ3 + pt] = dv[k];
  }
  team_sync<WARP>();

  // ---- adjoint z: line (c, qy, qx) over qz -> adjoint t2 0 = B_z^T dv0,
  // 1 = B_z^T dv1, 2 = D_z^T dv2 at every pz ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    for (LineWalk w(tid, NT, Q, Q); w.row < 3 * ne; w.next()) {
      const int e = w.row / 3, c = w.row - 3 * e;
      const T* d = bufB + 3 * c * EQ3 + e * Q3 + w.a * Q + w.b;
      T y0[QC], y1[QC], y2[QC];
#pragma unroll
      for (int qz = 0; qz < QC; ++qz) {
        y0[qz] = qz < Q ? d[qz * Q2] : T(0);
        y1[qz] = qz < Q ? d[EQ3 + qz * Q2] : T(0);
        y2[qz] = qz < Q ? d[2 * EQ3 + qz * Q2] : T(0);
      }
      T* o = bufA + e * A + (c * P * Q + w.b) * QQ + w.a;
#pragma unroll
      for (int pz = 0; pz < PC; ++pz) {
        if (pz < P) {
          T bt[QC], dt[QC];
          bd.col(pz, bt, dt);
          T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
          for (int qz = 0; qz < QC; ++qz) {
            if (qz < Q) {
              a0 += bt[qz] * y0[qz];
              a1 += bt[qz] * y1[qz];
              a2 += dt[qz] * y2[qz];
            }
          }
          o[pz * Q * QQ] = a0;
          o[T2A + pz * Q * QQ] = a1;
          o[2 * T2A + pz * Q * QQ] = a2;
        }
      }
    }
  }
  team_sync<WARP>();

  // ---- adjoint y: line (c, pz, qx) over qy -> adjoint t1 0 = B_y^T a2 0,
  // 1 = D_y^T a2 1 + B_y^T a2 2 at every py ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    for (LineWalk w(tid, NT, P, Q); w.row < 3 * ne; w.next()) {
      const int e = w.row / 3, c = w.row - 3 * e;
      const int j = (c * P + w.a) * Q + w.b;
      T y0[QC], y1[QC], y2[QC];
      ld_line(bufA + e * A + j * QQ, Q, y0);
      ld_line(bufA + e * A + T2A + j * QQ, Q, y1);
      ld_line(bufA + e * A + 2 * T2A + j * QQ, Q, y2);
      T* o = bufB + e * B1 + (c * P + w.a) * P * QQ + w.b;
#pragma unroll
      for (int py = 0; py < PC; ++py) {
        if (py < P) {
          T bt[QC], dt[QC];
          bd.col(py, bt, dt);
          T s0 = T(0), s1 = T(0);
#pragma unroll
          for (int qy = 0; qy < QC; ++qy) {
            if (qy < Q) {
              s0 += bt[qy] * y0[qy];
              s1 += dt[qy] * y1[qy] + bt[qy] * y2[qy];
            }
          }
          o[py * QQ] = s0;
          o[T1A + py * QQ] = s1;
        }
      }
    }
  }
  team_sync<WARP>();

  // ---- adjoint x: line (pz, py) over qx, NC components -> ve =
  // D_x^T a1 0 + B_x^T a1 1 at every px, staged by component over the
  // tile ----
  {
    const Rows bd(sB, sD, sBT, sDT);
    const int NP3 = ne * P3;
    for (LineWalk w(tid, NT, P, P); w.row < CR * ne; w.next()) {
      const int e = w.row / CR, c0 = (w.row - CR * e) * NC;
      T x0[NC][QC], x1[NC][QC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int r = ((c0 + c) * P + w.a) * P + w.b;
        ld_line(bufB + e * B1 + r * QQ, Q, x0[c]);
        ld_line(bufB + e * B1 + T1A + r * QQ, Q, x1[c]);
      }
      T* o = bufA + c0 * NP3 + e * P3 + (w.a * P + w.b) * P;
#pragma unroll
      for (int px = 0; px < PC; ++px) {
        if (px < P) {
          T bt[QC], dt[QC];
          bd.col(px, bt, dt);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            T acc = T(0);
#pragma unroll
            for (int qx = 0; qx < QC; ++qx)
              if (qx < Q) acc += dt[qx] * x0[c][qx] + bt[qx] * x1[c][qx];
            o[c * NP3 + px] = acc;
          }
        }
      }
    }
    team_sync<WARP>();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T* dst = ve + ((size_t)c * nelem + e0) * P3;
      for (int w = tid; w < NP3; w += NT) dst[w] = bufA[c * NP3 + w];
    }
  }
}

// Raises a kernel's dynamic shared memory limit (above 48 KB it must be) and
// asks for the largest shared-memory carveout.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Launches one instance; returns the CUDA error of its set-up (the launch's
// own is read by cps_fused_apply).
template <int PH, bool JAC, int P, int Q, typename T>
cudaError_t launch(const void* u, long long N, const void* conn, int nelem,
                   const void* qdata, const void* B, const void* D,
                   void* stash, void* ve, double a, double b,
                   cudaStream_t stream) {
  // set-up once for each device
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  const bool stash_in = JAC && Pointwise<PH>::kStash;
  const int bulk = bulk_path(sizeof(T), nelem, Q, qdata, stash, stash_in);
  if constexpr (block_tile(PH, JAC, P, Q, sizeof(T))) {
    using TL = Tile<PH, JAC, P, Q, T>;
    auto kernel = block_tile_kernel<PH, JAC, P, Q, T>;
    if (!(ready.load() >> dev & 1u)) {
      err = prepare(kernel, TL::plan.smem);
      if (err != cudaSuccess) return err;
      ready.fetch_or(1u << dev);
    }
    const int tiles = (nelem + TL::plan.elems - 1) / TL::plan.elems;
    if (tiles == 0) return cudaSuccess;
    kernel<<<tiles, TL::plan.threads, TL::plan.smem, stream>>>(
        static_cast<const T*>(u), N, static_cast<const long long*>(conn),
        nelem, static_cast<const T*>(qdata), static_cast<const T*>(B),
        static_cast<const T*>(D), static_cast<T*>(stash),
        static_cast<T*>(ve), T(a), T(b), bulk);
  } else {
    using WT = WarpTile<PH, JAC, P, Q, T>;
    auto kernel = warp_tile_kernel<PH, JAC, P, Q, T>;
    // the grid: as many one-warp blocks as the card holds at once
    static int resident[32];
    if (!(ready.load() >> dev & 1u)) {
      int per_sm = 0, sms = 0;
      err = prepare(kernel, WT::plan.smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, 32, WT::plan.smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      resident[dev] = per_sm * sms;
      ready.fetch_or(1u << dev);
    }
    const int tiles = (nelem + WT::plan.elems - 1) / WT::plan.elems;
    if (tiles == 0) return cudaSuccess;
    const int grid = tiles < resident[dev] ? tiles : resident[dev];
    kernel<<<grid, 32, WT::plan.smem, stream>>>(
        static_cast<const T*>(u), N, static_cast<const long long*>(conn),
        nelem, static_cast<const T*>(qdata), static_cast<const T*>(B),
        static_cast<const T*>(D), static_cast<T*>(stash),
        static_cast<T*>(ve), T(a), T(b), bulk);
  }
  return cudaSuccess;
}

template <int PH, int P, int Q>
cudaError_t launch_pq(int jacobian, int is_double, const void* u, long long N,
                      const void* conn, int nelem, const void* qdata,
                      const void* B, const void* D, void* stash, void* ve,
                      double a, double b, cudaStream_t s) {
  if (is_double) {
    if (jacobian) return launch<PH, true, P, Q, double>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
    return launch<PH, false, P, Q, double>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
  }
  if (jacobian) return launch<PH, true, P, Q, float>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
  return launch<PH, false, P, Q, float>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
}

// Launches the generic tile of one (physics, mode, type) in body BODY as
// `g` plans it; returns the CUDA error of its set-up. `optin`: the most
// dynamic shared memory a block may opt in to on this device, which the
// kernel is allowed once a device; `work`: the gmem body's workspace
// (g.work bytes).
constexpr int kSmemRefused = -2;
constexpr int kWorkShort = -3;  // the gmem body's workspace is missing or short
constexpr int kClusterRefused = -4;  // no cluster of the launch fits the card,
                                     // or a cluster size asked for is refused

// Before a cluster launch's first run on a device (one query a kernel,
// cluster size and shared memory): the CUDA error of
// cudaOccupancyMaxActiveClusters, kClusterRefused when the card holds no
// cluster of it, else 0.
inline int cluster_check(const void* kernel, const cudaLaunchConfig_t& cfg,
                         int dev, int k) {
  struct Seen {
    const void* kernel;
    int dev, k;
    size_t smem;
  };
  static std::mutex mu;
  static Seen seen[256];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev && seen[i].k == k &&
        seen[i].smem == cfg.dynamicSmemBytes)
      return 0;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel,
                                                         &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kClusterRefused;
  if (n < 256) seen[n++] = Seen{kernel, dev, k, cfg.dynamicSmemBytes};
  return 0;
}

template <int PH, bool JAC, typename T, int BODY>
int launch_generic_body(const GenericLaunch& g, int optin, int P, int Q,
                        const void* u, long long N, const void* conn,
                        int nelem, const void* qdata, const void* B,
                        const void* D, void* stash, void* ve, double a,
                        double b, int bulk, void* work, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if constexpr (BODY == kBodyCluster) {
    auto kernel = generic_cluster_kernel<PH, JAC, T>;
    if (!(ready.load() >> dev & 1u)) {
      err = prepare(kernel, static_cast<size_t>(optin));
      if (err != cudaSuccess) return static_cast<int>(err);
      ready.fetch_or(1u << dev);
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g.tiles);
    cfg.blockDim = dim3(g.threads);
    cfg.dynamicSmemBytes = g.smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int r = cluster_check(reinterpret_cast<const void*>(kernel), cfg,
                                dev, g.cluster);
    if (r != 0) return r;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, kernel, P, Q, g.a_words, static_cast<const T*>(u), N,
        static_cast<const long long*>(conn), nelem,
        static_cast<const T*>(qdata), static_cast<const T*>(B),
        static_cast<const T*>(D), static_cast<T*>(stash),
        static_cast<T*>(ve), T(a), T(b)));
  } else if constexpr (BODY == kBodyGmem) {
    auto kernel = generic_gmem_kernel<PH, JAC, T>;
    if (!(ready.load() >> dev & 1u)) {
      err = prepare(kernel, static_cast<size_t>(optin));
      if (err != cudaSuccess) return static_cast<int>(err);
      ready.fetch_or(1u << dev);
    }
    kernel<<<g.tiles, g.threads, g.smem, stream>>>(
        P, Q, g.a_words, g.b_words, static_cast<T*>(work),
        static_cast<const T*>(u), N, static_cast<const long long*>(conn),
        nelem, static_cast<const T*>(qdata), static_cast<const T*>(B),
        static_cast<const T*>(D), static_cast<T*>(stash),
        static_cast<T*>(ve), T(a), T(b));
  } else {
    auto kernel = generic_reg_kernel<PH, JAC, T, BODY>;
    if (!(ready.load() >> dev & 1u)) {
      err = prepare(kernel, static_cast<size_t>(optin));
      if (err != cudaSuccess) return static_cast<int>(err);
      ready.fetch_or(1u << dev);
    }
    kernel<<<g.tiles, g.threads, g.smem, stream>>>(
        P, Q, g.elems, g.plane_stride, g.a_words, g.b_words, g.bd_words,
        static_cast<const T*>(u), N, static_cast<const long long*>(conn),
        nelem, static_cast<const T*>(qdata), static_cast<const T*>(B),
        static_cast<const T*>(D), static_cast<T*>(stash),
        static_cast<T*>(ve), T(a), T(b), bulk);
  }
  return 0;
}

// The limit is ops/fused_apply.py's MAX_Q, passed by csrc/build.py as
// -DCPS_FUSED_MAX_Q.
#ifndef CPS_FUSED_MAX_Q
#error "compile with -DCPS_FUSED_MAX_Q=<max Q> (csrc/build.py passes it)"
#endif
constexpr int FUSED_MAX_Q = CPS_FUSED_MAX_Q;

// The Q instances of a physics at a given P (ops/fused_apply.py
// Pointwise.instances): Q = P..FUSED_MAX_Q, and Q = 1 alone for the
// reduced-integration pressure term.
constexpr int q_first(int PH, int P) { return PH == kIncompPressure ? 1 : P; }
constexpr int q_last(int PH) {
  return PH == kIncompPressure ? 1 : FUSED_MAX_Q;
}

// Whether (physics, P, Q) has an instance.
constexpr bool has_instance(int PH, int P, int Q) {
  return PH >= 0 && PH < kNumPhysics && P >= 2 && P <= FUSED_MAX_Q &&
         Q >= q_first(PH, P) && Q <= q_last(PH);
}

// Q = Qc..q_last(PH) for a fixed physics and P: the set-up's CUDA error, or
// -1 when Q has no instance.
template <int PH, int P, int Qc = q_first(PH, P)>
int dispatch_q(int Q, int jacobian, int is_double, const void* u,
               long long N, const void* conn, int nelem, const void* qdata,
               const void* B, const void* D, void* stash, void* ve,
               double a, double b, cudaStream_t s) {
  if constexpr (Qc > q_last(PH)) {
    return -1;
  } else {
    if (Q == Qc)
      return static_cast<int>(launch_pq<PH, P, Qc>(
          jacobian, is_double, u, N, conn, nelem, qdata, B, D, stash, ve, a,
          b, s));
    return dispatch_q<PH, P, Qc + 1>(Q, jacobian, is_double, u, N, conn,
                                     nelem, qdata, B, D, stash, ve, a, b, s);
  }
}

// Whether (physics, P, Q) runs on the generic tile: every pair without a
// template instance (ops/fused_apply.py is_generic).
constexpr bool generic_pq(int PH, int P, int Q) {
  return PH >= 0 && PH < kNumPhysics && !has_instance(PH, P, Q) && P >= 2 &&
         P <= kGenericMaxPQ && Q >= 1 && Q <= kGenericMaxPQ;
}

// The instances are split into one translation unit per (physics, P)
// (compiled with -DCPS_FUSED_PHYS=ph -DCPS_FUSED_P=p by csrc/build.py, in
// parallel nvcc processes): unit (ph, p) defines dispatch_p<ph, p>; and one
// per (physics, body) for the generic tile (-DCPS_FUSED_GENERIC=ph
// -DCPS_GENERIC_BODY=body): unit (ph, body) defines generic_run<ph, body>.
// The unit with neither sees only the declarations and holds the C entry
// points below.
#define CPS_DISPATCH_PARAMS                                                 \
  int Q, int jacobian, int is_double, const void *u, long long N,          \
      const void *conn, int nelem, const void *qdata, const void *B,       \
      const void *D, void *stash, void *ve, double a, double b,            \
      cudaStream_t s
#define CPS_DISPATCH_ARGS \
  Q, jacobian, is_double, u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s

template <int PH, int P>
int dispatch_p(CPS_DISPATCH_PARAMS);
template <int PH, int BODY>
int generic_run(const GenericLaunch& g, int optin, int P, int bulk,
                void* work, CPS_DISPATCH_PARAMS);

#if defined(CPS_FUSED_P)
template <int PH, int P>
int dispatch_p(CPS_DISPATCH_PARAMS) {
  return dispatch_q<PH, P>(CPS_DISPATCH_ARGS);
}
template int dispatch_p<CPS_FUSED_PHYS, CPS_FUSED_P>(CPS_DISPATCH_PARAMS);
#elif defined(CPS_FUSED_GENERIC)
#ifndef CPS_GENERIC_BODY
#error "a generic unit needs -DCPS_GENERIC_BODY=<body> (csrc/build.py)"
#endif
template <int PH, int BODY>
int generic_run(const GenericLaunch& g, int optin, int P, int bulk,
                void* work, CPS_DISPATCH_PARAMS) {
  if (is_double) {
    if (jacobian)
      return launch_generic_body<PH, true, double, BODY>(
          g, optin, P, Q, u, N, conn, nelem, qdata, B, D, stash, ve, a, b,
          bulk, work, s);
    return launch_generic_body<PH, false, double, BODY>(
        g, optin, P, Q, u, N, conn, nelem, qdata, B, D, stash, ve, a, b,
        bulk, work, s);
  }
  if (jacobian)
    return launch_generic_body<PH, true, float, BODY>(
        g, optin, P, Q, u, N, conn, nelem, qdata, B, D, stash, ve, a, b,
        bulk, work, s);
  return launch_generic_body<PH, false, float, BODY>(
      g, optin, P, Q, u, N, conn, nelem, qdata, B, D, stash, ve, a, b, bulk,
      work, s);
}
template int generic_run<CPS_FUSED_GENERIC, CPS_GENERIC_BODY>(
    const GenericLaunch& g, int optin, int P, int bulk, void* work,
    CPS_DISPATCH_PARAMS);
#else
// P = Pc..FUSED_MAX_Q for one physics; -1 when P has no instance.
template <int PH, int Pc = 2>
int dispatch_any_p(int P, CPS_DISPATCH_PARAMS) {
  if constexpr (Pc > FUSED_MAX_Q) {
    return -1;
  } else {
    if (P == Pc) return dispatch_p<PH, Pc>(CPS_DISPATCH_ARGS);
    return dispatch_any_p<PH, Pc + 1>(P, CPS_DISPATCH_ARGS);
  }
}

// physics = PHc..kNumPhysics-1; -1 when the physics id is unknown.
template <int PHc = 0>
int dispatch_any(int physics, int P, CPS_DISPATCH_PARAMS) {
  if constexpr (PHc >= kNumPhysics) {
    return -1;
  } else {
    if (physics == PHc) return dispatch_any_p<PHc>(P, CPS_DISPATCH_ARGS);
    return dispatch_any<PHc + 1>(physics, P, CPS_DISPATCH_ARGS);
  }
}

// The generic tile of physics = PHc..kNumPhysics-1, body = BODYc..
// kNumBodies-1.
template <int PH, int BODYc = kBodyWarp3x2>
int dispatch_generic_body(int body, const GenericLaunch& g, int optin, int P,
                          int bulk, void* work, CPS_DISPATCH_PARAMS) {
  if constexpr (BODYc >= kNumBodies) {
    return -1;
  } else {
    if (body == BODYc)
      return generic_run<PH, BODYc>(g, optin, P, bulk, work,
                                    CPS_DISPATCH_ARGS);
    return dispatch_generic_body<PH, BODYc + 1>(body, g, optin, P, bulk, work,
                                                CPS_DISPATCH_ARGS);
  }
}

template <int PHc = 0>
int dispatch_generic(int physics, const GenericLaunch& g, int optin, int P,
                     int bulk, void* work, CPS_DISPATCH_PARAMS) {
  if constexpr (PHc >= kNumPhysics) {
    return -1;
  } else {
    if (physics == PHc)
      return dispatch_generic_body<PHc>(g.body, g, optin, P, bulk, work,
                                        CPS_DISPATCH_ARGS);
    return dispatch_generic<PHc + 1>(physics, g, optin, P, bulk, work,
                                     CPS_DISPATCH_ARGS);
  }
}

// The card's SM count and the most dynamic shared memory a block may opt
// in to, read once a device.
struct DeviceLimits {
  int sms;
  int optin;
};

inline int device_limits(DeviceLimits* out) {
  static std::atomic<unsigned> ready{0};
  static DeviceLimits limits[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(ready.load() >> dev & 1u)) {
    DeviceLimits l{};
    err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &l.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    limits[dev] = l;
    ready.fetch_or(1u << dev);
  }
  *out = limits[dev];
  return 0;
}

// The generic tile's launch for these arguments on the current device
// (`cluster` as generic_launch takes it).
inline int generic_for(int physics, int P, int Q, int jacobian, int is_double,
                       int nelem, int cluster, GenericLaunch* g,
                       DeviceLimits* lim) {
  const int r = device_limits(lim);
  if (r != 0) return r;
  const bool stash_in = jacobian && has_stash(physics);
  *g = generic_launch(P, Q, is_double ? 8 : 4, nelem, lim->sms,
                      stash_in ? 19 : 10, lim->optin, cluster);
  return 0;
}

// Launches the generic tile; the CUDA error of its set-up, kSmemRefused
// when its tile needs more shared memory than a block may opt in to on
// this device, kWorkShort when the gmem body's workspace `work` holds
// fewer than the plan's bytes (`work_bytes`: its size), kClusterRefused
// when `cluster` (> 0: the cluster body's size instead of the plan's) is
// not a size of 1..kClusterMax of a shape that runs the cluster body, or
// the card holds no cluster of the launch.
inline int launch_generic(int physics, int P, void* work,
                          long long work_bytes, int cluster,
                          CPS_DISPATCH_PARAMS) {
  GenericLaunch g;
  DeviceLimits lim;
  const int r = generic_for(physics, P, Q, jacobian, is_double, nelem,
                            cluster, &g, &lim);
  if (r != 0) return r;
  if (cluster != 0 && (g.body != kBodyCluster || cluster < 1 ||
                       cluster > kClusterMax))
    return kClusterRefused;
  if (g.smem > static_cast<size_t>(lim.optin)) return kSmemRefused;
  if (g.tiles == 0) return 0;
  if (g.work > 0 &&
      (work == nullptr || work_bytes < static_cast<long long>(g.work)))
    return kWorkShort;
  const bool stash_in = jacobian && has_stash(physics);
  const int bulk = reg_body(g.body) &&
                   bulk_path(is_double ? 8 : 4, nelem, Q, qdata, stash,
                             stash_in);
  return dispatch_generic(physics, g, lim.optin, P, bulk, work,
                          CPS_DISPATCH_ARGS);
}
#endif

}  // namespace cps

#if !defined(CPS_FUSED_P) && !defined(CPS_FUSED_GENERIC)
extern "C" {

// Launches one fused apply of pointwise physics `physics` on `stream`: the
// template instance of (physics, P, Q) where there is one, else the generic
// tile; `work` (`work_bytes` bytes on the device): the workspace of the
// generic tile's gmem body (cps_fused_plan's out[8] bytes), else unused;
// `cluster`: 0 for the plan's cluster size, else the cluster body's size
// (1..8; a measurement's override, refused for any other body).
// Returns the CUDA error of the set-up or, after the launch,
// cudaGetLastError() (0 on success); -1 when neither runs (physics, P, Q),
// -2 when the generic tile needs more shared memory than a block may have,
// -3 when the gmem body's workspace is missing or short, -4 when a cluster
// size is refused or the card holds no cluster of the launch.
int cps_fused_apply(int physics, int jacobian, int P, int Q, int is_double,
                    const void* u, long long N, const void* conn, int nelem,
                    const void* qdata, const void* B, const void* D,
                    void* stash, void* ve, double a, double b, void* stream,
                    void* work, long long work_bytes, int cluster) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r;
  if (cps::generic_pq(physics, P, Q))
    r = cps::launch_generic(physics, P, work, work_bytes, cluster,
                            CPS_DISPATCH_ARGS);
  else
    r = cluster != 0 ? cps::kClusterRefused
                     : cps::dispatch_any(physics, P, CPS_DISPATCH_ARGS);
  if (r != 0) return r;
  return static_cast<int>(cudaGetLastError());
}

// The launch cps_fused_apply makes for the same arguments (cluster = 0),
// without making it: out = {elements a tile, threads a block, dynamic
// shared memory bytes (the cluster body: a CTA's), tiles (blocks), path (1
// TMA bulk, 0 cp.async; the generic tile: 3 a register body, 4 the
// global-memory body, 5 the cluster body; 2, a retired shared-memory body,
// no longer occurs),
// minimum blocks an SM of __launch_bounds__, the generic register body's
// copy path (1 TMA bulk, 0 cp.async; else -1), the generic tile's body
// (GenericBody; else -1), the gmem body's workspace bytes (else 0), the
// cluster body's CTAs a cluster and clusters (else 0, 0)}.
// Returns 0, -1 when (physics, P, Q) runs on neither, or the CUDA error of
// reading the device's limits.
int cps_fused_plan(int physics, int jacobian, int P, int Q, int is_double,
                   int nelem, const void* qdata, const void* stash,
                   long long* out) {
  const int tsize = is_double ? 8 : 4;
  const bool stash_in = jacobian && cps::has_stash(physics);
  out[6] = -1;
  out[7] = -1;
  out[8] = 0;
  out[9] = 0;
  out[10] = 0;
  if (cps::generic_pq(physics, P, Q)) {
    cps::GenericLaunch g;
    cps::DeviceLimits lim;
    const int r = cps::generic_for(physics, P, Q, jacobian, is_double, nelem,
                                   0, &g, &lim);
    if (r != 0) return r;
    const bool reg = cps::reg_body(g.body);
    out[0] = g.elems;
    out[1] = g.threads;
    out[2] = static_cast<long long>(g.smem);
    out[3] = g.tiles;
    out[4] = reg ? 3 : g.body == cps::kBodyCluster ? 5 : 4;
    out[5] = 1;
    if (reg)
      out[6] = cps::bulk_path(tsize, nelem, Q, qdata, stash, stash_in) ? 1 : 0;
    out[7] = g.body;
    out[8] = static_cast<long long>(g.work);
    out[9] = g.cluster;
    out[10] = g.clusters;
    return 0;
  }
  if (!cps::has_instance(physics, P, Q)) return -1;
  if (cps::block_tile(physics, jacobian, P, Q, tsize)) {
    const cps::TilePlan t = cps::tile_plan(P, Q, tsize, stash_in ? 19 : 10,
                                           physics == cps::kIncompPressure);
    out[0] = t.elems;
    out[1] = t.threads;
    out[2] = static_cast<long long>(t.smem);
    out[5] = t.min_blocks;
  } else {
    const cps::WarpPlan w =
        cps::warp_plan(P, Q, tsize, cps::warp_planes(physics, jacobian));
    out[0] = w.elems;
    out[1] = 32;
    out[2] = static_cast<long long>(w.smem);
    out[5] = w.min_blocks;
  }
  out[3] = (nelem + out[0] - 1) / out[0];
  out[4] = cps::bulk_path(tsize, nelem, Q, qdata, stash, stash_in) ? 1 : 0;
  return 0;
}

}  // extern "C"
#endif
