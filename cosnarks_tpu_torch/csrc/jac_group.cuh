// The Jacobian double on a group of G threads per point, shared by K2's add
// and double (jacobian.cu) and by K5's P = Q points (jacobian_madd.cu).
//
// dbl-2009-l (curve.double) in three layers of products (group.cuh's
// group_layer): {A = X^2, B = Y^2, YZ}, {C = B^2, T = (X + B)^2, E^2},
// {E (D - X3)}, with E = 3A, D = 2 (T - A - C), X3 = E^2 - 2D. Infinity
// (Z = 0) maps to infinity. Every value is canonical, so the limbs equal
// curve._double_formula's over the plain ops.
#pragma once

#include "group.cuh"
#include "point.cuh"

namespace cosnarks {

// Slots the double writes, from its first product slot d on.
constexpr int kDoubleProducts = 7;

// 2P for the point in slots (x, y, z); its products go to slots d..d+6.
// Every lane of the group returns the whole result.
template <int G>
__device__ Pt group_double(uint32_t* S, int l, int x, int y, int z, int d,
                           unsigned mask, const FieldParams& F) {
  // {A = X^2, B = Y^2, YZ}
  group_layer<G, 3>(S, l, d, mask, F, [&](int k, Fe& a, Fe& b) {
    a = get(S, by_lane(k, x, y, y));
    b = get(S, by_lane(k, x, y, z));
  });
  const Fe A = get(S, d), B = get(S, d + 1);
  const Fe E = fe_add(fe_dbl(A, F), A, F);
  // {C = B^2, T = (X + B)^2, E^2}
  group_layer<G, 3>(S, l, d + 3, mask, F, [&](int k, Fe& a, Fe& b) {
    a = b = pick(k, B, fe_add(get(S, x), B, F), E);
  });
  const Fe C = get(S, d + 3);
  const Fe D = fe_dbl(fe_sub(get(S, d + 4), fe_add(A, C, F), F), F);
  const Fe X3 = fe_sub(get(S, d + 5), fe_dbl(D, F), F);
  // {E (D - X3)}
  group_layer<G, 1>(S, l, d + 6, mask, F, [&](int, Fe& a, Fe& b) {
    a = E;
    b = fe_sub(D, X3, F);
  });
  const Fe C8 = fe_dbl(fe_dbl(fe_dbl(C, F), F), F);
  return Pt{X3, fe_sub(get(S, d + 6), C8, F), fe_dbl(get(S, d + 2), F)};
}

}  // namespace cosnarks
