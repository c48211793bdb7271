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
//   4 hyperFSIncomp's pressure part (reduced integration, Q = 1).
// Instances: physics 0-3 at every 2 <= P <= Q <= 6, physics 4 at (P, 1) for
// 2 <= P <= 6, f32 and f64. P = Q is a level at its own Gauss rule (the
// fine residual and J.v, native p-multigrid levels); P < Q is a coarse level
// at the fine level's rule or a -qextra run; P > Q = 1 is the pressure term
// at one point per element on every level.
// Per element: gather the 3 x P^3 nodal values through `conn` (orientation is
// already resolved by the FE-space numbering, so the TPU kernel's class rows,
// orientation masks and selection GEMMs have no counterpart), contract to the
// Q^3 reference gradients by sum factorization, run the pointwise physics,
// contract back by sum factorization, write the element vector
// ve (3, nelem, P^3). The owner-sum over elements stays a deterministic
// plain-torch gather-sum (ops/restriction.py), as in the JAX package.
//
// What bounds it on the card: the per-quadrature-point streams. Residual
// mode reads qdata (10 words) and writes the stash (9 words), Jacobian mode
// reads both: 19 * Q^3 * nelem words per apply, against 6 * P^3 * nelem
// words of nodal gather and E-vector traffic. In f32 that is ~100 bytes per
// point against ~1k flops (both sum-factorized contractions ~500, the
// hyperFS 3x3 algebra ~500; linElas and hyperSS need a fifth of that and
// read no stash in J.v): ~10 flops/byte, under the H100's f32 balance point
// of ~20, so the kernel is memory-bound. Design response: one thread per
// quadrature point, so those streams are read/written with consecutive
// threads on consecutive addresses (coalesced along q in the (k, e, q)
// layout); all intermediates of the contractions live in shared memory and
// never touch device memory; the 1D B/D matrices (Q x P) are the only
// basis data read. One block per element keeps the kernel simple; at Q = 1
// a block is one warp of which one thread runs the physics, the nodal
// contractions spreading over the warp. Multi-element blocks, wgmma and TMA
// are later work.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace cps {

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

template <int Q>
constexpr int threads_for() {
  return ((Q * Q * Q + 31) / 32) * 32;
}

// One block per element, one thread per quadrature point.
template <int PH, bool JAC, int P, int Q, typename T>
__global__ void __launch_bounds__(threads_for<Q>())
fused_apply_kernel(const T* __restrict__ u, long long N,
                   const long long* __restrict__ conn, int nelem,
                   const T* __restrict__ qdata, const T* __restrict__ Bg,
                   const T* __restrict__ Dg, T* __restrict__ stash,
                   T* __restrict__ ve, T a, T b) {
  constexpr int P3 = P * P * P;
  constexpr int Q3 = Q * Q * Q;
  constexpr int N1 = 3 * P * P * Q;  // (c, pz, py, qx)
  constexpr int N2 = 3 * P * Q * Q;  // (c, pz, qy, qx)
  __shared__ T sB[Q * P], sD[Q * P];
  __shared__ T ue[3 * P3];
  __shared__ T t1[2][N1];
  __shared__ T t2[3][N2];
  __shared__ T dvs[9 * Q3];

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t plane = (size_t)nelem * Q3;

  for (int i = tid; i < Q * P; i += nt) {
    sB[i] = Bg[i];
    sD[i] = Dg[i];
  }
  for (int i = tid; i < P3; i += nt) {
    const long long node = conn[(size_t)e * P3 + i];
#pragma unroll
    for (int c = 0; c < 3; ++c) ue[c * P3 + i] = u[c * N + node];
  }
  __syncthreads();

  // ---- forward: u (c,pz,py,px) -> reference gradients at (qz,qy,qx) ----
  // x: t1[0] = sum_px B[qx,px] u, t1[1] = sum_px D[qx,px] u
  for (int i = tid; i < N1; i += nt) {
    const int qx = i % Q;
    const T* row = ue + (i / Q) * P;
    T bsum = T(0), dsum = T(0);
#pragma unroll
    for (int px = 0; px < P; ++px) {
      bsum += sB[qx * P + px] * row[px];
      dsum += sD[qx * P + px] * row[px];
    }
    t1[0][i] = bsum;
    t1[1][i] = dsum;
  }
  __syncthreads();
  // y: t2[0] = B_y D_x u, t2[1] = D_y B_x u, t2[2] = B_y B_x u
  for (int i = tid; i < N2; i += nt) {
    const int qx = i % Q;
    const int qy = (i / Q) % Q;
    const int r = i / (Q * Q);  // c*P + pz
    T bd = T(0), db = T(0), bb = T(0);
#pragma unroll
    for (int py = 0; py < P; ++py) {
      const int j = (r * P + py) * Q + qx;
      bd += sB[qy * P + py] * t1[1][j];
      db += sD[qy * P + py] * t1[0][j];
      bb += sB[qy * P + py] * t1[0][j];
    }
    t2[0][i] = bd;
    t2[1][i] = db;
    t2[2][i] = bb;
  }
  __syncthreads();
  // z + pointwise physics, one thread per quadrature point
  for (int q = tid; q < Q3; q += nt) {
    const int qx = q % Q;
    const int qy = (q / Q) % Q;
    const int qz = q / (Q * Q);
    T du[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
      for (int pz = 0; pz < P; ++pz) {
        const int j = ((c * P + pz) * Q + qy) * Q + qx;
        a0 += sB[qz * P + pz] * t2[0][j];
        a1 += sB[qz * P + pz] * t2[1][j];
        a2 += sD[qz * P + pz] * t2[2][j];
      }
      du[3 * c + 0] = a0;
      du[3 * c + 1] = a1;
      du[3 * c + 2] = a2;
    }
    const size_t off = (size_t)e * Q3 + q;
    const T wdetJ = qdata[off];
    T X[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = qdata[(1 + k) * plane + off];
    T dv[9], g[9];
    if constexpr (JAC) {
      if constexpr (Pointwise<PH>::kStash) {
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
#pragma unroll
    for (int k = 0; k < 9; ++k) dvs[k * Q3 + q] = dv[k];
  }
  __syncthreads();

  // ---- adjoint: ve[c,p] = sum_q sum_d G_d[q,p] dv[c,d,q] ----
  // z: t2[0] = B_z dv0, t2[1] = B_z dv1, t2[2] = D_z dv2 over (c,pz,qy,qx)
  for (int i = tid; i < N2; i += nt) {
    const int qxy = i % (Q * Q);
    const int r = i / (Q * Q);
    const int c = r / P;
    const int pz = r % P;
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
    for (int qz = 0; qz < Q; ++qz) {
      const int qi = qz * Q * Q + qxy;
      a0 += sB[qz * P + pz] * dvs[(3 * c + 0) * Q3 + qi];
      a1 += sB[qz * P + pz] * dvs[(3 * c + 1) * Q3 + qi];
      a2 += sD[qz * P + pz] * dvs[(3 * c + 2) * Q3 + qi];
    }
    t2[0][i] = a0;
    t2[1][i] = a1;
    t2[2][i] = a2;
  }
  __syncthreads();
  // y: t1[0] = B_y t2[0] (needs D_x), t1[1] = D_y t2[1] + B_y t2[2] (B_x)
  for (int i = tid; i < N1; i += nt) {
    const int qx = i % Q;
    const int py = (i / Q) % P;
    const int r = i / (Q * P);  // c*P + pz
    T bx = T(0), bb = T(0);
#pragma unroll
    for (int qy = 0; qy < Q; ++qy) {
      const int j = (r * Q + qy) * Q + qx;
      bx += sB[qy * P + py] * t2[0][j];
      bb += sD[qy * P + py] * t2[1][j] + sB[qy * P + py] * t2[2][j];
    }
    t1[0][i] = bx;
    t1[1][i] = bb;
  }
  __syncthreads();
  // x: ve = D_x t1[0] + B_x t1[1]
  for (int i = tid; i < 3 * P3; i += nt) {
    const int px = i % P;
    const int r = i / P;  // (c*P + pz)*P + py
    const int c = i / P3;
    const int p = i % P3;
    T s = T(0);
#pragma unroll
    for (int qx = 0; qx < Q; ++qx) {
      const int j = r * Q + qx;
      s += sD[qx * P + px] * t1[0][j] + sB[qx * P + px] * t1[1][j];
    }
    ve[((size_t)c * nelem + e) * P3 + p] = s;
  }
}

template <int PH, bool JAC, int P, int Q, typename T>
void launch(const void* u, long long N, const void* conn, int nelem,
            const void* qdata, const void* B, const void* D, void* stash,
            void* ve, double a, double b, cudaStream_t stream) {
  fused_apply_kernel<PH, JAC, P, Q, T>
      <<<nelem, threads_for<Q>(), 0, stream>>>(
          static_cast<const T*>(u), N, static_cast<const long long*>(conn),
          nelem, static_cast<const T*>(qdata), static_cast<const T*>(B),
          static_cast<const T*>(D), static_cast<T*>(stash),
          static_cast<T*>(ve), T(a), T(b));
}

// Static shared memory of one block (sB, sD, ue, t1, t2, dvs above).
template <int P, int Q, typename T>
constexpr size_t shared_bytes() {
  return sizeof(T) * (2 * Q * P + 3 * P * P * P + 2 * 3 * P * P * Q +
                      3 * 3 * P * Q * Q + 9 * Q * Q * Q);
}

template <int PH, int P, int Q>
void launch_pq(int jacobian, int is_double, const void* u, long long N,
               const void* conn, int nelem, const void* qdata, const void* B,
               const void* D, void* stash, void* ve, double a, double b,
               cudaStream_t s) {
  static_assert(shared_bytes<P, Q, double>() <= 48 * 1024,
                "static shared memory above 48 KB per block");
  if (is_double) {
    if (jacobian) launch<PH, true, P, Q, double>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
    else launch<PH, false, P, Q, double>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
  } else {
    if (jacobian) launch<PH, true, P, Q, float>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
    else launch<PH, false, P, Q, float>(u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s);
  }
}

// The limit is ops/fused_apply.py's MAX_Q, passed by csrc/build.py as
// -DCPS_FUSED_MAX_Q; at 6 the f64 blocks use 47.2 KB of static shared
// memory.
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

// Q = Qc..q_last(PH) for a fixed physics and P; false when Q has no
// instance.
template <int PH, int P, int Qc = q_first(PH, P)>
bool dispatch_q(int Q, int jacobian, int is_double, const void* u,
                long long N, const void* conn, int nelem, const void* qdata,
                const void* B, const void* D, void* stash, void* ve,
                double a, double b, cudaStream_t s) {
  if constexpr (Qc > q_last(PH)) {
    return false;
  } else {
    if (Q == Qc) {
      launch_pq<PH, P, Qc>(jacobian, is_double, u, N, conn, nelem, qdata, B,
                           D, stash, ve, a, b, s);
      return true;
    }
    return dispatch_q<PH, P, Qc + 1>(Q, jacobian, is_double, u, N, conn,
                                     nelem, qdata, B, D, stash, ve, a, b, s);
  }
}

// The instances are split into one translation unit per (physics, P)
// (compiled with -DCPS_FUSED_PHYS=ph -DCPS_FUSED_P=p by csrc/build.py, in
// parallel nvcc processes): unit (ph, p) defines dispatch_p<ph, p>. The
// unit without CPS_FUSED_P sees only the declaration and holds the C entry
// point below.
#define CPS_DISPATCH_PARAMS                                                 \
  int Q, int jacobian, int is_double, const void *u, long long N,          \
      const void *conn, int nelem, const void *qdata, const void *B,       \
      const void *D, void *stash, void *ve, double a, double b,            \
      cudaStream_t s
#define CPS_DISPATCH_ARGS \
  Q, jacobian, is_double, u, N, conn, nelem, qdata, B, D, stash, ve, a, b, s

template <int PH, int P>
bool dispatch_p(CPS_DISPATCH_PARAMS);

#ifdef CPS_FUSED_P
template <int PH, int P>
bool dispatch_p(CPS_DISPATCH_PARAMS) {
  return dispatch_q<PH, P>(CPS_DISPATCH_ARGS);
}
template bool dispatch_p<CPS_FUSED_PHYS, CPS_FUSED_P>(CPS_DISPATCH_PARAMS);
#else
// P = Pc..FUSED_MAX_Q for one physics; false when P has no instance.
template <int PH, int Pc = 2>
bool dispatch_any_p(int P, CPS_DISPATCH_PARAMS) {
  if constexpr (Pc > FUSED_MAX_Q) {
    return false;
  } else {
    if (P == Pc) return dispatch_p<PH, Pc>(CPS_DISPATCH_ARGS);
    return dispatch_any_p<PH, Pc + 1>(P, CPS_DISPATCH_ARGS);
  }
}

// physics = PHc..kNumPhysics-1; false when the physics id is unknown.
template <int PHc = 0>
bool dispatch_any(int physics, int P, CPS_DISPATCH_PARAMS) {
  if constexpr (PHc >= kNumPhysics) {
    return false;
  } else {
    if (physics == PHc) return dispatch_any_p<PHc>(P, CPS_DISPATCH_ARGS);
    return dispatch_any<PHc + 1>(physics, P, CPS_DISPATCH_ARGS);
  }
}
#endif

}  // namespace cps

#ifndef CPS_FUSED_P
extern "C" {

// Launches one fused apply of pointwise physics `physics` on `stream`.
// Returns cudaGetLastError() after the launch (0 on success), or -1 when
// (physics, P, Q) has no instance.
int cps_fused_apply(int physics, int jacobian, int P, int Q, int is_double,
                    const void* u, long long N, const void* conn, int nelem,
                    const void* qdata, const void* B, const void* D,
                    void* stash, void* ve, double a, double b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cps::dispatch_any(physics, P, CPS_DISPATCH_ARGS)) return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
#endif
