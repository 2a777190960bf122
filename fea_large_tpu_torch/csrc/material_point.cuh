// Constitutive law at one quadrature point, shared by the structured
// (struct_kernels.cu) and the element-block (elem_kernels.cu) kernels.
// Templated on the scalar type: float for the f32 tangent passes, double
// for the f64 residuals. material_point gives the stress and the tangent
// factors; material_stress the stress alone, on symmetric storage.
#pragma once

#include <cuda_runtime.h>

namespace fea {

__device__ __forceinline__ float fea_log(float x) { return logf(x); }
__device__ __forceinline__ double fea_log(double x) { return log(x); }
__device__ __forceinline__ float fea_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double fea_sqrt(double x) { return sqrt(x); }

// Constitutive state of material `kind` at the right Cauchy-Green tensor Cm:
// S, the tangent factors (alpha, A, beta) of CC:X = alpha (A:X) A + beta A X A.
// kind 0: St. Venant-Kirchhoff; 1: neo-Hookean (Ciarlet); 2: neo-Hookean
// with the volumetric split. Same closed forms as the plain versions
// (fea_large_tpu_torch/materials).
template <typename scalar_t>
__device__ __forceinline__ void material_point(int kind, scalar_t lam, scalar_t mu,
                                               const scalar_t Cm[3][3], scalar_t S[3][3],
                                               scalar_t A[3][3], scalar_t& alpha,
                                               scalar_t& beta) {
  if (kind == 0) {
    const scalar_t trE = scalar_t(0.5) * (Cm[0][0] + Cm[1][1] + Cm[2][2] - scalar_t(3));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const scalar_t d = (i == j) ? scalar_t(1) : scalar_t(0);
        S[i][j] = lam * trE * d + mu * (Cm[i][j] - d);
        A[i][j] = d;
      }
    alpha = lam;
    beta = scalar_t(2) * mu;
    return;
  }
  // C^-1 by the adjugate (explicit cofactors, det along row 0)
  scalar_t c[3][3];
  c[0][0] = Cm[1][1] * Cm[2][2] - Cm[1][2] * Cm[2][1];
  c[0][1] = Cm[0][2] * Cm[2][1] - Cm[0][1] * Cm[2][2];
  c[0][2] = Cm[0][1] * Cm[1][2] - Cm[0][2] * Cm[1][1];
  c[1][0] = Cm[1][2] * Cm[2][0] - Cm[1][0] * Cm[2][2];
  c[1][1] = Cm[0][0] * Cm[2][2] - Cm[0][2] * Cm[2][0];
  c[1][2] = Cm[0][2] * Cm[1][0] - Cm[0][0] * Cm[1][2];
  c[2][0] = Cm[1][0] * Cm[2][1] - Cm[1][1] * Cm[2][0];
  c[2][1] = Cm[0][1] * Cm[2][0] - Cm[0][0] * Cm[2][1];
  c[2][2] = Cm[0][0] * Cm[1][1] - Cm[0][1] * Cm[1][0];
  const scalar_t detC = Cm[0][0] * c[0][0] + Cm[0][1] * c[1][0] + Cm[0][2] * c[2][0];
  const scalar_t inv_det = scalar_t(1) / detC;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = c[i][j] * inv_det;
  scalar_t vol;
  if (kind == 1) {  // S = mu (I - C^-1) + lam lnJ C^-1
    const scalar_t lnJ = scalar_t(0.5) * fea_log(detC);
    vol = lam * lnJ;
    alpha = lam;
  } else {  // S = mu (I - C^-1) + lam J (J - 1) C^-1
    const scalar_t J = fea_sqrt(detC);
    vol = lam * J * (J - scalar_t(1));
    alpha = lam * J * (scalar_t(2) * J - scalar_t(1));
  }
  beta = scalar_t(2) * (mu - vol);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const scalar_t d = (i == j) ? scalar_t(1) : scalar_t(0);
      S[i][j] = mu * (d - A[i][j]) + vol * A[i][j];
    }
}

// C = F^T F
template <typename scalar_t>
__device__ __forceinline__ void right_cauchy_green(const scalar_t F[3][3], scalar_t Cm[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Cm[i][j] = F[0][i] * F[0][j] + F[1][i] * F[1][j] + F[2][i] * F[2][j];
}

// The symmetric C = F^T F as its six entries (00, 01, 02, 11, 12, 22).
template <typename scalar_t>
__device__ __forceinline__ void right_cauchy_green_sym(const scalar_t F[3][3], scalar_t Cs[6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      Cs[3 * i - i * (i - 1) / 2 + j - i] = F[0][i] * F[0][j] + F[1][i] * F[1][j] + F[2][i] * F[2][j];
}

// The stress S of material `kind` alone, for the residual kernel, which
// needs no tangent factors and no operation spent on them: C and S as the
// six entries (00, 01, 02, 11, 12, 22) of a symmetric matrix. Same closed
// forms as material_point.
template <typename scalar_t>
__device__ __forceinline__ void material_stress(int kind, scalar_t lam, scalar_t mu,
                                                const scalar_t Cs[6], scalar_t S[6]) {
  const scalar_t C00 = Cs[0], C01 = Cs[1], C02 = Cs[2], C11 = Cs[3], C12 = Cs[4], C22 = Cs[5];
  if (kind == 0) {
    const scalar_t ltr = lam * (scalar_t(0.5) * (C00 + C11 + C22 - scalar_t(3)));
    S[0] = ltr + mu * (C00 - scalar_t(1));
    S[1] = mu * C01;
    S[2] = mu * C02;
    S[3] = ltr + mu * (C11 - scalar_t(1));
    S[4] = mu * C12;
    S[5] = ltr + mu * (C22 - scalar_t(1));
    return;
  }
  // C^-1 by the adjugate of a symmetric matrix
  scalar_t c[6];
  c[0] = C11 * C22 - C12 * C12;
  c[1] = C02 * C12 - C01 * C22;
  c[2] = C01 * C12 - C02 * C11;
  c[3] = C00 * C22 - C02 * C02;
  c[4] = C02 * C01 - C00 * C12;
  c[5] = C00 * C11 - C01 * C01;
  const scalar_t detC = C00 * c[0] + C01 * c[1] + C02 * c[2];
  const scalar_t inv_det = scalar_t(1) / detC;
  scalar_t vol;
  if (kind == 1) {  // S = mu (I - C^-1) + lam lnJ C^-1
    vol = lam * (scalar_t(0.5) * fea_log(detC));
  } else {  // S = mu (I - C^-1) + lam J (J - 1) C^-1
    const scalar_t J = fea_sqrt(detC);
    vol = lam * J * (J - scalar_t(1));
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const scalar_t d = (e == 0 || e == 3 || e == 5) ? scalar_t(1) : scalar_t(0);
    const scalar_t Ainv = c[e] * inv_det;
    S[e] = mu * (d - Ainv) + vol * Ainv;
  }
}

}  // namespace fea
