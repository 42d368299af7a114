// Curve helpers (short Weierstrass, a = 0) over field.cuh, shared by the
// point kernels: a point's three coordinates, and x * 3b for the RCB
// formulas (rcb_group.cuh). The formulas themselves run on groups of
// threads: Jacobian in jac_group.cuh and the kernels that include it, RCB in
// rcb_group.cuh.
#pragma once

#include "field.cuh"

namespace cosnarks {

struct Pt {
  Fe x, y, z;
};

// x * 3b for the RCB formulas, as curve._mul_b3 computes it for an integer
// b: with 0 < b3 <= 64 the left-to-right double/add chain on the bits of b3
// below its top bit (BN254, BLS12-381: 9, 12); with -64 <= b3 < 0, when 3b
// = -m mod p for a small m = -b3 (Grumpkin, b = -17: -51), the chain of m
// and then one negation, 0 - acc. b3 is the same for the whole launch.
__device__ __forceinline__ Fe mul_b3(const Fe& x, int b3,
                                     const FieldParams& F) {
  const int m = b3 < 0 ? -b3 : b3;
  Fe acc = x;
  int top = 31 - __clz(m);
  for (int bit = top - 1; bit >= 0; --bit) {
    acc = fe_dbl(acc, F);
    if ((m >> bit) & 1) acc = fe_add(acc, x, F);
  }
  return b3 < 0 ? fe_neg(acc, F) : acc;
}

// The 3b values mul_b3 takes: nonzero, |b3| <= 64 (ec_kernels._b3). The
// entry points refuse any other.
inline bool b3_ok(int b3) { return b3 != 0 && b3 >= -64 && b3 <= 64; }

}  // namespace cosnarks
