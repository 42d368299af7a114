// K2: complete Jacobian add (op 0) and double (op 1) over a flat batch.
//
// Replaces _add_call and _double_call of cosnarks_tpu/ec/pallas_ec.py with
// the formulas and selects of curve.add / curve.double: add-2007-bl, then
// P = Q -> double, P = -Q -> Z3 = 0, P = inf -> Q, Q = inf -> P (the last
// select wins); dbl-2009-l (jac_group.cuh, shared with K5).
//
// What bounds it on the card: latency. By the roofline it is bytes-bound
// (9 or 6 coordinates of 16 NW bytes against 16 or 7 field products), but the
// main path launches it on single points (curve.scalar_mul), where the
// whole launch is the formula's chain of products. One thread per point
// runs that chain serially, 16 products for an add and 7 for a double, and
// holds ~30 field elements (130 registers), so at 2^14 points only 4 warps
// share an SM, too few to hide the chains.
//
// Design: a group of four threads per point, eight points to a warp. The
// block stages its points' coordinates through shared memory (field.cuh
// tile_stage: coalesced 16-byte cp.async copies into padded rows), and
// each group converts its point's coordinates to 32-bit words in its slots.
// The group then runs the formula layer by layer: in a layer each lane
// computes one of the layer's independent products with fe_mul, its
// operands picked by lane from the group's slots or from registers, and
// writes it to a slot of its own; the group meets at __syncwarp before the
// next layer reads the slots. The additions between layers are cheap and
// every lane of the group computes them. add-2007-bl takes five layers:
//   {Z1Z1, Z2Z2, t1 = Y1*Z2, t2 = Y2*Z1}, {U1, U2, S1, S2},
//   {W = (Z1+Z2)^2, I = (2H)^2, r^2}, {J = H*I, V = U1*I, Z3 = (W-Z1Z1-Z2Z2)*H},
//   {r*(V - X3), S1*J};
// dbl-2009-l three: {A, B, Y*Z}, {C = B^2, T = (X+B)^2, E^2}, {E*(D - X3)}.
// So the serial chain is 5 products for an add and 3 for a double. A group
// takes its point's selects together (every lane reads the same slots, so
// its branch is uniform) and computes curve.py's values, so the limbs are
// the same. Lane l < 3 writes output coordinate l over the point's P rows,
// and the block stores the rows with coalesced 16-byte stores.
#include "jac_group.cuh"

using namespace cosnarks;

namespace {

constexpr int kGroup = 4;                   // threads per point
constexpr int kBlock = 128;                 // threads per block
constexpr int kPoints = kBlock / kGroup;    // points per block
constexpr int kSlots = 22;                  // field elements per point
constexpr int kPointWords = kSlots * NW + 4;  // padded: 720, 1072 bytes
constexpr int kRowsBytes = 6 * kPoints * kRowBytes;
constexpr int kSmem = kRowsBytes + kPoints * kPointWords * 4;

// Slots: the six input coordinates, then one per product of the add.
enum : int {
  IX1, IY1, IZ1, IX2, IY2, IZ2,
  Z1Z1, Z2Z2, T1, T2, U1, U2, S1, S2, WW, II, R2, JJ, VV, Z3S, RVX, S1J
};
// The double's products reuse the add's last slots from WW on (a P = Q add
// branches to the double before it writes them).
static_assert(S1J + 1 - WW >= kDoubleProducts, "the double's slots fit");

// dbl-2009-l (jac_group.cuh) on the point in slots (x, y, z); returns output
// coordinate l for lanes 0-2.
__device__ Fe double_coord(uint32_t* S, int l, int x, int y, int z,
                           unsigned mask, const FieldParams& F) {
  const Pt R = group_double<kGroup>(S, l, x, y, z, WW, mask, F);
  return pick(l, R.x, R.y, R.z);
}

// add-2007-bl with curve.add's selects; returns output coordinate l for
// lanes 0-2.
__device__ Fe group_add(uint32_t* S, int l, unsigned mask,
                        const FieldParams& F) {
  const int c = l < 3 ? l : 2;
  if (fe_is_zero(get(S, IZ2))) return get(S, IX1 + c);  // Q = inf -> P
  if (fe_is_zero(get(S, IZ1))) return get(S, IX2 + c);  // P = inf -> Q
  // {Z1Z1, Z2Z2, t1 = Y1*Z2, t2 = Y2*Z1}
  put(S, Z1Z1 + l, fe_mul(get(S, by_lane(l, IZ1, IZ2, IY1, IY2)),
                          get(S, by_lane(l, IZ1, IZ2, IZ2, IZ1)), F));
  __syncwarp(mask);
  // {U1 = X1*Z2Z2, U2 = X2*Z1Z1, S1 = t1*Z2Z2, S2 = t2*Z1Z1}
  put(S, U1 + l, fe_mul(get(S, by_lane(l, IX1, IX2, T1, T2)),
                        get(S, by_lane(l, Z2Z2, Z1Z1, Z2Z2, Z1Z1)), F));
  __syncwarp(mask);
  const Fe H = fe_sub(get(S, U2), get(S, U1), F);
  const Fe rhalf = fe_sub(get(S, S2), get(S, S1), F);
  const bool h_zero = fe_is_zero(H);
  if (h_zero && fe_is_zero(rhalf))  // P = Q
    return double_coord(S, l, IX1, IY1, IZ1, mask, F);
  const Fe r = fe_dbl(rhalf, F);
  if (l < 3) {  // {W = (Z1 + Z2)^2, I = (2H)^2, r^2}
    const Fe v = pick(l, fe_add(get(S, IZ1), get(S, IZ2), F), fe_dbl(H, F),
                      r);
    put(S, WW + l, fe_mul(v, v, F));
  }
  __syncwarp(mask);
  if (l < 3) {  // {J = H*I, V = U1*I, Z3 = (W - Z1Z1 - Z2Z2)*H}
    const Fe I = get(S, II);
    const Fe x = pick(
        l, H, get(S, U1),
        fe_sub(get(S, WW), fe_add(get(S, Z1Z1), get(S, Z2Z2), F), F));
    put(S, JJ + l, fe_mul(x, pick(l, I, I, H), F));
  }
  __syncwarp(mask);
  const Fe J = get(S, JJ), V = get(S, VV);
  const Fe X3 = fe_sub(get(S, R2), fe_add(J, fe_dbl(V, F), F), F);
  if (l < 2)  // {r*(V - X3), S1*J}
    put(S, RVX + l, fe_mul(pick(l, r, get(S, S1), r),
                           pick(l, fe_sub(V, X3, F), J, J), F));
  __syncwarp(mask);
  const Fe Y3 = fe_sub(get(S, RVX), fe_dbl(get(S, S1J), F), F);
  // h_zero here means P = -Q
  return pick(l, X3, Y3, h_zero ? fe_zero() : get(S, Z3S));
}

}  // namespace

// At most 128 registers a thread, so that four blocks (16 warps) fit an SM.
__global__ void __launch_bounds__(kBlock, 4)
    jacobian_kernel(int op, const int64_t* __restrict__ x1,
                    const int64_t* __restrict__ y1,
                    const int64_t* __restrict__ z1,
                    const int64_t* __restrict__ x2,
                    const int64_t* __restrict__ y2,
                    const int64_t* __restrict__ z2, int64_t* __restrict__ ox,
                    int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                    int64_t total, FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPoints;
  const int n = static_cast<int>(
      total - first < kPoints ? total - first : kPoints);
  const int ncoords = op == 0 ? 6 : 3;
  auto rows = [&](int c) { return smem + c * kPoints * kRowBytes; };
  const int64_t* in[6] = {x1, y1, z1, x2, y2, z2};
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (c < ncoords) tile_stage(rows(c), in[c] + first * NL, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = threadIdx.x / kGroup, l = threadIdx.x % kGroup;
  const unsigned mask = group_mask<kGroup>(threadIdx.x);
  Fe R;
  if (p < n) {
    uint32_t* S = reinterpret_cast<uint32_t*>(smem + kRowsBytes) +
                  p * kPointWords;
    for (int c = l; c < ncoords; c += kGroup)
      put(S, c, fe_from_row(rows(c) + p * kRowBytes));
    __syncwarp(mask);
    R = op == 0 ? group_add(S, l, mask, F)
                : double_coord(S, l, IX1, IY1, IZ1, mask, F);
    // the point's P rows were read by this group alone, into its slots
    if (l < 3) fe_to_row(rows(l) + p * kRowBytes, R);
  }
  __syncthreads();
  tile_store(ox + first * NL, rows(0), n);
  tile_store(oy + first * NL, rows(1), n);
  tile_store(oz + first * NL, rows(2), n);
}

extern "C" int cosnarks_jacobian(int op, const int64_t* x1, const int64_t* y1,
                                 const int64_t* z1, const int64_t* x2,
                                 const int64_t* y2, const int64_t* z2,
                                 int64_t* ox, int64_t* oy, int64_t* oz,
                                 int64_t total, const uint32_t* params,
                                 void* stream) {
  if (op != 0 && op != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_dynamic_smem<jacobian_kernel>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>((total + kPoints - 1) / kPoints);
  jacobian_kernel<<<blocks, kBlock, kSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      op, x1, y1, z1, x2, y2, z2, ox, oy, oz, total, params_from(params));
  return static_cast<int>(cudaGetLastError());
}
