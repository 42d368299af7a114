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

}  // namespace cosnarks
