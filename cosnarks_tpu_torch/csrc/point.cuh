// Curve formulas (short Weierstrass, a = 0) over field.cuh, one thread per
// point, shared by the point kernels. They follow cosnarks_tpu/ec/curve.py
// step for step: Jacobian dbl-2009-l, complete add-2007-bl and mixed add
// madd-2007-bl with their selects, and the Renes-Costello-Batina complete
// projective add / double (K6; rcb_group.cuh runs RCB on groups of threads).
#pragma once

#include "field.cuh"

namespace cosnarks {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  return c ? a : b;
}

// x * 3b by the left-to-right double/add chain on the bits of b3 below its
// top bit (curve._mul_b3 for small-integer b).
__device__ __forceinline__ Fe mul_b3(const Fe& x, int b3,
                                     const FieldParams& F) {
  Fe acc = x;
  int top = 31 - __clz(b3);
  for (int bit = top - 1; bit >= 0; --bit) {
    acc = fe_dbl(acc, F);
    if ((b3 >> bit) & 1) acc = fe_add(acc, x, F);
  }
  return acc;
}

// dbl-2009-l (curve.double); infinity (Z = 0) maps to infinity.
__device__ __noinline__ Pt jac_double(const Pt& P, const FieldParams& F) {
  Fe A = fe_mul(P.x, P.x, F);
  Fe B = fe_mul(P.y, P.y, F);
  Fe YZ = fe_mul(P.y, P.z, F);
  Fe XB = fe_add(P.x, B, F);
  Fe C = fe_mul(B, B, F);
  Fe T = fe_mul(XB, XB, F);
  Fe D = fe_dbl(fe_sub(T, fe_add(A, C, F), F), F);
  Fe E = fe_add(fe_dbl(A, F), A, F);
  Fe Fv = fe_mul(E, E, F);
  Pt R;
  R.x = fe_sub(Fv, fe_dbl(D, F), F);
  Fe C8 = fe_dbl(fe_dbl(fe_dbl(C, F), F), F);
  R.y = fe_sub(fe_mul(E, fe_sub(D, R.x, F), F), C8, F);
  R.z = fe_dbl(YZ, F);
  return R;
}

// Complete Jacobian add (curve.add): add-2007-bl, then P=Q -> double,
// P=-Q -> Z = 0, P=inf -> Q, Q=inf -> P (the last select wins).
__device__ __noinline__ Pt jac_add(const Pt& P, const Pt& Q,
                                   const FieldParams& F) {
  bool p_inf = fe_is_zero(P.z);
  bool q_inf = fe_is_zero(Q.z);
  if (q_inf) return P;
  if (p_inf) return Q;
  Fe Z1Z1 = fe_mul(P.z, P.z, F);
  Fe Z2Z2 = fe_mul(Q.z, Q.z, F);
  Fe t1 = fe_mul(P.y, Q.z, F);
  Fe t2 = fe_mul(Q.y, P.z, F);
  Fe Z12 = fe_add(P.z, Q.z, F);
  Fe U1 = fe_mul(P.x, Z2Z2, F);
  Fe U2 = fe_mul(Q.x, Z1Z1, F);
  Fe S1 = fe_mul(t1, Z2Z2, F);
  Fe S2 = fe_mul(t2, Z1Z1, F);
  Fe W = fe_mul(Z12, Z12, F);
  Fe H = fe_sub(U2, U1, F);
  Fe rhalf = fe_sub(S2, S1, F);
  bool h_zero = fe_is_zero(H);
  bool r_zero = fe_is_zero(rhalf);
  if (h_zero && r_zero) return jac_double(P, F);
  Fe H2 = fe_dbl(H, F);
  Fe r = fe_dbl(rhalf, F);
  Fe I = fe_mul(H2, H2, F);
  Fe r2 = fe_mul(r, r, F);
  Fe J = fe_mul(H, I, F);
  Fe V = fe_mul(U1, I, F);
  Fe Z3 = fe_mul(fe_sub(W, fe_add(Z1Z1, Z2Z2, F), F), H, F);
  Pt R;
  R.x = fe_sub(r2, fe_add(J, fe_dbl(V, F), F), F);
  Fe rVX = fe_mul(r, fe_sub(V, R.x, F), F);
  Fe S1J = fe_mul(S1, J, F);
  R.y = fe_sub(rVX, fe_dbl(S1J, F), F);
  R.z = h_zero ? fe_zero() : Z3;  // h_zero here means P = -Q
  return R;
}

// Complete Jacobian + affine mixed add (curve.madd): madd-2007-bl, then
// P=Q -> double, P=-Q -> Z = 0, P=inf -> (x2, y2, 1) (the last select wins).
__device__ __noinline__ Pt jac_madd(const Pt& P, const Fe& x2, const Fe& y2,
                                    const FieldParams& F) {
  if (fe_is_zero(P.z)) {
    Pt R;
    R.x = x2;
    R.y = y2;
    R.z = fe_one(F);
    return R;
  }
  Fe Z1Z1 = fe_mul(P.z, P.z, F);
  Fe U2 = fe_mul(x2, Z1Z1, F);
  Fe Z1c = fe_mul(P.z, Z1Z1, F);
  Fe S2 = fe_mul(y2, Z1c, F);
  Fe H = fe_sub(U2, P.x, F);
  Fe rhalf = fe_sub(S2, P.y, F);
  bool h_zero = fe_is_zero(H);
  if (h_zero && fe_is_zero(rhalf)) return jac_double(P, F);
  Fe HH = fe_mul(H, H, F);
  Fe I = fe_dbl(fe_dbl(HH, F), F);
  Fe r = fe_dbl(rhalf, F);
  Fe J = fe_mul(H, I, F);
  Fe V = fe_mul(P.x, I, F);
  Pt R;
  R.x = fe_sub(fe_mul(r, r, F), fe_add(J, fe_dbl(V, F), F), F);
  Fe rVX = fe_mul(r, fe_sub(V, R.x, F), F);
  Fe Y1J = fe_mul(P.y, J, F);
  R.y = fe_sub(rVX, fe_dbl(Y1J, F), F);
  Fe ZH1 = fe_add(P.z, H, F);
  Fe Z3 = fe_sub(fe_mul(ZH1, ZH1, F), fe_add(Z1Z1, HH, F), F);
  R.z = h_zero ? fe_zero() : Z3;  // h_zero here means P = -Q
  return R;
}

// RCB complete projective add (curve.proj_add, alg 7).
__device__ __noinline__ Pt proj_add(const Pt& P, const Pt& Q, int b3,
                                    const FieldParams& F) {
  Fe t0 = fe_mul(P.x, Q.x, F);
  Fe t1 = fe_mul(P.y, Q.y, F);
  Fe t2 = fe_mul(P.z, Q.z, F);
  Fe s3 = fe_mul(fe_add(P.x, P.y, F), fe_add(Q.x, Q.y, F), F);
  Fe s4 = fe_mul(fe_add(P.y, P.z, F), fe_add(Q.y, Q.z, F), F);
  Fe s5 = fe_mul(fe_add(P.x, P.z, F), fe_add(Q.x, Q.z, F), F);
  Fe t3 = fe_sub(s3, fe_add(t0, t1, F), F);
  Fe t4 = fe_sub(s4, fe_add(t1, t2, F), F);
  Fe t5 = fe_sub(s5, fe_add(t0, t2, F), F);
  t0 = fe_add(fe_dbl(t0, F), t0, F);
  t2 = mul_b3(t2, b3, F);
  Fe z = fe_add(t1, t2, F);
  t1 = fe_sub(t1, t2, F);
  Fe y = mul_b3(t5, b3, F);
  Pt R;
  R.x = fe_sub(fe_mul(t3, t1, F), fe_mul(t4, y, F), F);
  R.y = fe_add(fe_mul(t1, z, F), fe_mul(y, t0, F), F);
  R.z = fe_add(fe_mul(z, t4, F), fe_mul(t0, t3, F), F);
  return R;
}

// RCB projective double (curve.proj_double, alg 9).
__device__ __noinline__ Pt proj_double(const Pt& P, int b3,
                                       const FieldParams& F) {
  Fe t0 = fe_mul(P.y, P.y, F);
  Fe t1 = fe_mul(P.y, P.z, F);
  Fe t2 = fe_mul(P.z, P.z, F);
  Fe xy = fe_mul(P.x, P.y, F);
  Fe z3 = fe_dbl(fe_dbl(fe_dbl(t0, F), F), F);
  t2 = mul_b3(t2, b3, F);
  Fe y3 = fe_add(t0, t2, F);
  Fe x3 = fe_mul(t2, z3, F);
  z3 = fe_mul(t1, z3, F);
  t2 = fe_add(fe_dbl(t2, F), t2, F);
  t0 = fe_sub(t0, t2, F);
  Fe Y3 = fe_mul(t0, y3, F);
  Fe X3 = fe_mul(t0, xy, F);
  Pt R;
  R.x = fe_dbl(X3, F);
  R.y = fe_add(x3, Y3, F);
  R.z = z3;
  return R;
}

__device__ __forceinline__ Pt pt_load(const int64_t* x, const int64_t* y,
                                      const int64_t* z, int64_t off,
                                      int64_t stride) {
  Pt P;
  P.x = fe_load(x + off, stride);
  P.y = fe_load(y + off, stride);
  P.z = fe_load(z + off, stride);
  return P;
}

__device__ __forceinline__ void pt_store(int64_t* x, int64_t* y, int64_t* z,
                                         int64_t off, int64_t stride,
                                         const Pt& P) {
  fe_store(x + off, stride, P.x);
  fe_store(y + off, stride, P.y);
  fe_store(z + off, stride, P.z);
}

}  // namespace cosnarks
