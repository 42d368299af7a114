// RCB complete projective add, mixed add and double (Renes-Costello-Batina
// 2015/1060 algs 7-9, a = 0) on a group of G threads per point (K3, K4).
//
// A formula's field products run in layers of independent products:
// product k of a layer is computed by lane k mod G (one round when the layer
// fits the group, more when it does not), its operands picked by k from the
// group's slots (group.cuh) or from registers, and the group meets at
// __syncwarp after each layer. Lane c mod G then hands output coordinate c
// to the caller's emit(c, value). Between layers every lane of
// the group computes the same few additions in registers, mul_b3's
// double/add chain included. The layers are those of RCB_SCHEDULE in
// cosnarks_tpu_torch/ec/ec_kernels.py, product for product and in the same
// order (tests/test_torch_rcb_groups.py holds that table to the JAX
// package's formulas limb for limb):
//   add     {t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, s3 = (X1+Y1)(X2+Y2),
//            s4 = (Y1+Z1)(Y2+Z2), s5 = (X1+Z1)(X2+Z2)}
//           {A = t4 y, B = t3 t1', C = y t0', D = t1' z, E = t0' t3, F = z t4}
//   madd    {t0 = X1 x2, t1 = Y1 y2, s3 = (X1+Y1)(x2+y2), u = Z1 x2,
//            v = Z1 y2}
//           {A = t5 y, B = t3 t1', C = y t0', D = t1' z, E = t0' t3, F = z t5}
//   double  {t0 = Y Y, t1 = Y Z, t2 = Z Z, xy = X Y}, {x3 = t2' z3,
//            Z3 = t1 z3}, {Y3 = t0' y3, X3 = t0' xy}
// So a chain of 2, 2 and 3 layers instead of one thread's 12, 11 and 8
// products.
// Every value is canonical, so the limbs equal the plain versions'
// (curve._proj_*_formula) whatever the order of the additions.
#pragma once

#include "group.cuh"
#include "point.cuh"

namespace cosnarks {

// Product slots a formula writes: the add's and the madd's second layer
// reuses the first layer's slots, the double's three layers take eight.
constexpr int kRcbProducts = 8;

// Output coordinates of the add and the madd from their second layer
// {A, ..., F} at slots pr..pr+5: (B - A, D + C, F + E).
template <int G, class Emit>
__device__ __forceinline__ void rcb_add_out(const uint32_t* S, int l, int pr,
                                            const FieldParams& F, Emit emit) {
#pragma unroll
  for (int c = l; c < 3; c += G) {
    const Fe u = get(S, pr + by_lane(c, 1, 3, 5));
    const Fe v = get(S, pr + by_lane(c, 0, 2, 4));
    emit(c, pick(c, fe_sub(u, v, F), fe_add(u, v, F)));
  }
}

// P + Q (alg 7, RCB_SCHEDULE["add"]): P at slots p..p+2, Q at q..q+2, the
// products at pr..pr+5.
template <int G, class Emit>
__device__ __forceinline__ void rcb_add(uint32_t* S, int l, int p, int q,
                                        int pr, int b3, unsigned mask,
                                        const FieldParams& F, Emit emit) {
  // X1, Y1, Z1, X1+Y1, Y1+Z1, X1+Z1 times the same sums of Q
  group_layer<G, 6>(S, l, pr, mask, F, [&](int k, Fe& a, Fe& b) {
    const int i = by_lane(k, 0, 1, 2, 0, 1, 0);
    const int j = by_lane(k, 0, 0, 0, 1, 2, 2);
    a = fe_add(get(S, p + i), keep_if(k >= 3, get(S, p + j)), F);
    b = fe_add(get(S, q + i), keep_if(k >= 3, get(S, q + j)), F);
  });
  const Fe t0 = get(S, pr), t1 = get(S, pr + 1), t2 = get(S, pr + 2);
  const Fe t3 = fe_sub(get(S, pr + 3), fe_add(t0, t1, F), F);
  const Fe t4 = fe_sub(get(S, pr + 4), fe_add(t1, t2, F), F);
  const Fe y = mul_b3(fe_sub(get(S, pr + 5), fe_add(t0, t2, F), F), b3, F);
  const Fe t0x3 = fe_add(fe_dbl(t0, F), t0, F);
  const Fe t2b = mul_b3(t2, b3, F);
  const Fe z = fe_add(t1, t2b, F);
  const Fe t1m = fe_sub(t1, t2b, F);
  __syncwarp(mask);  // every lane has read the first layer's products
  group_layer<G, 6>(S, l, pr, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, t4, t3, y, t1m, t0x3, z);
    b = pick(k, y, t1m, t0x3, z, t3, t4);
  });
  rcb_add_out<G>(S, l, pr, F, emit);
}

// P + (x2, y2, 1) (alg 8, RCB_SCHEDULE["madd"]): P at slots p..p+2, the
// affine Q at q, q+1, the products at pr..pr+5.
template <int G, class Emit>
__device__ __forceinline__ void rcb_madd(uint32_t* S, int l, int p, int q,
                                         int pr, int b3, unsigned mask,
                                         const FieldParams& F, Emit emit) {
  // X1, Y1, X1+Y1, Z1, Z1 times x2, y2, x2+y2, x2, y2
  group_layer<G, 5>(S, l, pr, mask, F, [&](int k, Fe& a, Fe& b) {
    a = fe_add(get(S, p + by_lane(k, 0, 1, 0, 2, 2)),
               keep_if(k == 2, get(S, p + 1)), F);
    b = fe_add(get(S, q + by_lane(k, 0, 1, 0, 0, 1)),
               keep_if(k == 2, get(S, q + 1)), F);
  });
  const Fe t0 = get(S, pr), t1 = get(S, pr + 1);
  const Fe t3 = fe_sub(get(S, pr + 2), fe_add(t0, t1, F), F);
  const Fe t5 = fe_add(get(S, pr + 4), get(S, p + 1), F);
  const Fe y = mul_b3(fe_add(get(S, pr + 3), get(S, p), F), b3, F);
  const Fe t0x3 = fe_add(fe_dbl(t0, F), t0, F);
  const Fe t2 = mul_b3(get(S, p + 2), b3, F);
  const Fe z = fe_add(t1, t2, F);
  const Fe t1m = fe_sub(t1, t2, F);
  __syncwarp(mask);  // every lane has read the first layer's products
  group_layer<G, 6>(S, l, pr, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, t5, t3, y, t1m, t0x3, z);
    b = pick(k, y, t1m, t0x3, z, t3, t5);
  });
  rcb_add_out<G>(S, l, pr, F, emit);
}

// 2P (alg 9, RCB_SCHEDULE["double"]): P at slots p..p+2, the products at
// pr..pr+7.
template <int G, class Emit>
__device__ __forceinline__ void rcb_double(uint32_t* S, int l, int p, int pr,
                                           int b3, unsigned mask,
                                           const FieldParams& F, Emit emit) {
  // Y Y, Y Z, Z Z, X Y
  group_layer<G, 4>(S, l, pr, mask, F, [&](int k, Fe& a, Fe& b) {
    a = get(S, p + by_lane(k, 1, 1, 2, 0));
    b = get(S, p + by_lane(k, 1, 2, 2, 1));
  });
  const Fe t0 = get(S, pr);
  const Fe z3 = fe_dbl(fe_dbl(fe_dbl(t0, F), F), F);
  const Fe t2b = mul_b3(get(S, pr + 2), b3, F);
  group_layer<G, 2>(S, l, pr + 4, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, t2b, get(S, pr + 1));
    b = z3;
  });
  const Fe t0m = fe_sub(t0, fe_add(fe_dbl(t2b, F), t2b, F), F);
  const Fe y3 = fe_add(t0, t2b, F);
  group_layer<G, 2>(S, l, pr + 6, mask, F, [&](int k, Fe& a, Fe& b) {
    a = t0m;
    b = pick(k, y3, get(S, pr + 3));
  });
  // (2 X3, x3 + Y3, Z3)
#pragma unroll
  for (int c = l; c < 3; c += G) {
    const Fe u = get(S, pr + by_lane(c, 7, 4, 5));
    emit(c, fe_add(u, keep_if(c < 2, get(S, pr + by_lane(c, 7, 6))), F));
  }
}

}  // namespace cosnarks
