// K5: complete Jacobian + affine mixed add over a flat batch, unmasked
// (mode 0) or with an int64 validity mask (mode 1: invalid lanes return P).
//
// Replaces _madd_call of cosnarks_tpu/ec/pallas_ec.py. One thread per
// point; the formula and its edge-case selects are curve.madd's
// (point.cuh jac_madd), taken as early returns in the order that makes the
// reference's last select win. Bytes-bound by the roofline: 11 field
// products per point on 640-648 bytes of int64 limbs; in practice latency-
// bound like K2 (one thread holds a whole point).
#include "point.cuh"

using namespace cosnarks;

__global__ void jacobian_madd_kernel(const int64_t* __restrict__ x1,
                                     const int64_t* __restrict__ y1,
                                     const int64_t* __restrict__ z1,
                                     const int64_t* __restrict__ x2,
                                     const int64_t* __restrict__ y2,
                                     const int64_t* __restrict__ valid,
                                     int64_t* __restrict__ ox,
                                     int64_t* __restrict__ oy,
                                     int64_t* __restrict__ oz, int64_t total,
                                     FieldParams F) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t off = i * NL;
  Pt P = pt_load(x1, y1, z1, off, 1);
  Pt R;
  if (valid != nullptr && valid[i] == 0) {
    R = P;
  } else {
    R = jac_madd(P, fe_load(x2 + off, 1), fe_load(y2 + off, 1), F);
  }
  pt_store(ox, oy, oz, off, 1, R);
}

extern "C" int cosnarks_jacobian_madd(int masked, const int64_t* x1,
                                      const int64_t* y1, const int64_t* z1,
                                      const int64_t* x2, const int64_t* y2,
                                      const int64_t* valid, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t total,
                                      const uint32_t* params, void* stream) {
  if ((masked != 0) != (valid != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jacobian_madd_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, valid, ox, oy, oz, total, params_from(params));
  return static_cast<int>(cudaGetLastError());
}
