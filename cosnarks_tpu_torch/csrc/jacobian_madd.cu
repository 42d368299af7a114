// K5: complete Jacobian + affine mixed add over a flat batch, unmasked
// (mode 0) or with an int64 validity mask (mode 1: invalid lanes return P).
//
// Replaces _madd_call of cosnarks_tpu/ec/pallas_ec.py with the formula and
// selects of curve.madd: madd-2007-bl, then P = -Q -> Z3 = 0, P = Q -> the
// double, P = inf -> (x2, y2, 1), and the mask last (the last select wins).
//
// What bounds it on the card: by the roofline, bytes (5 coordinates in and 3
// out, 16 NW bytes each, against 11 field products). In practice latency:
// at 1-32 points the formula's chain of products, and at 2^14 points and
// more the products' carry chains, which need many warps in flight. One
// thread a point (the first port) ran the 11 products as one serial chain
// and held 132 / 172 registers (8 / 12 words), too few warps to hide them.
//
// Design: K2's groups of threads, with Z2 = 1. A group of G threads per
// point (ec_kernels.madd_geometry, from scripts/torch_k5_sweep.py: 4 up to
// 4096 points; above, 2 at 8 words and 4 at 12). The block stages its
// points' five coordinates through shared memory (field.cuh tile_stage:
// coalesced 16-byte cp.async copies into padded rows) and the mask with
// 8-byte copies. The rows lie point-major, a point's five rows together:
// once its group has read them into registers, the point's slots
// (group.cuh) take their place, and its three output rows take the slots'
// place at the end, so a point holds 720 / 1040 bytes of shared memory at
// 8 / 12 words, not rows and slots side by side. The group runs
// curve.madd's 11 products in the five layers of
// ec_kernels.MADD_LAYERS["madd"], product for product:
//   {Z1Z1 = Z1^2}, {U2 = x2 Z1Z1, Z1c = Z1 Z1Z1},
//   {S2 = y2 Z1c, HH = H^2, ZH = (Z1 + H)^2}, {J = H I, V = X1 I, r^2},
//   {r (V - X3), Y1 J}
// with H = U2 - X1, I = 4 HH, r = 2 (S2 - Y1), X3 = r^2 - J - 2V: a chain of
// 5 products instead of 11 (7 rounds for a group of 2, whose layers of 3
// take two). Every lane reads the same slots, so each select is uniform
// across the group: P = inf returns before the first layer, P = Q branches
// after the third to K2's double (jac_group.cuh, MADD_LAYERS["double"]),
// whose products take the slots from J on, and P = -Q zeroes Z3. Every value
// is canonical, so the limbs equal curve._madd_formula's. Lane c mod G
// writes output coordinate c, and the block stores the rows with coalesced
// 16-byte stores.
#include "jac_group.cuh"

using namespace cosnarks;

namespace {

constexpr int kMaxThreads = 256;
// Slots of one point: the five input coordinates, then one per product of
// the madd. A P = Q point's double writes its seven from J on (it branches
// before the fourth layer writes them).
enum : int {
  IX1, IY1, IZ1, IX2, IY2,
  Z1Z1, U2, Z1C, S2, HH, ZH, JJ, VV, R2, RVX, Y1J,
  kSlots = JJ + kDoubleProducts
};
constexpr int kCoords = 5;  // input coordinates
// A point's shared memory: its padded input rows, which its slots and then
// its three output rows overwrite; then 8 bytes of mask.
constexpr int kPointBytes = kCoords * kRowBytes;  // 720, 1040
static_assert(kSlots * NW * 4 <= kPointBytes, "a point's slots fit its rows");

constexpr int smem_bytes(int points) { return points * (kPointBytes + 8); }

// curve.madd on the point in slots IX1..IY2; every lane of the group returns
// the whole result.
template <int G>
__device__ __forceinline__ Pt group_madd(uint32_t* S, int l, unsigned mask,
                                         const FieldParams& F) {
  if (fe_is_zero(get(S, IZ1)))  // P = inf
    return Pt{get(S, IX2), get(S, IY2), fe_one(F)};
  // {Z1Z1 = Z1^2}
  group_layer<G, 1>(S, l, Z1Z1, mask, F, [&](int, Fe& a, Fe& b) {
    a = b = get(S, IZ1);
  });
  // {U2 = x2 Z1Z1, Z1c = Z1 Z1Z1}
  group_layer<G, 2>(S, l, U2, mask, F, [&](int k, Fe& a, Fe& b) {
    a = get(S, by_lane(k, IX2, IZ1));
    b = get(S, Z1Z1);
  });
  const Fe H = fe_sub(get(S, U2), get(S, IX1), F);
  const Fe ZH1 = fe_add(get(S, IZ1), H, F);
  // {S2 = y2 Z1c, HH = H^2, ZH = (Z1 + H)^2}
  group_layer<G, 3>(S, l, S2, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, get(S, IY2), H, ZH1);
    b = pick(k, get(S, Z1C), H, ZH1);
  });
  const Fe rhalf = fe_sub(get(S, S2), get(S, IY1), F);
  const bool h_zero = fe_is_zero(H);
  if (h_zero && fe_is_zero(rhalf))  // P = Q
    return group_double<G>(S, l, IX1, IY1, IZ1, JJ, mask, F);
  const Fe r = fe_dbl(rhalf, F);
  const Fe I = fe_dbl(fe_dbl(get(S, HH), F), F);
  // {J = H I, V = X1 I, r^2}
  group_layer<G, 3>(S, l, JJ, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, H, get(S, IX1), r);
    b = pick(k, I, I, r);
  });
  const Fe J = get(S, JJ), V = get(S, VV);
  const Fe X3 = fe_sub(get(S, R2), fe_add(J, fe_dbl(V, F), F), F);
  // {r (V - X3), Y1 J}
  group_layer<G, 2>(S, l, RVX, mask, F, [&](int k, Fe& a, Fe& b) {
    a = pick(k, r, get(S, IY1));
    b = pick(k, fe_sub(V, X3, F), J);
  });
  const Fe Y3 = fe_sub(get(S, RVX), fe_dbl(get(S, Y1J), F), F);
  const Fe Z3 = fe_sub(get(S, ZH), fe_add(get(S, Z1Z1), get(S, HH), F), F);
  return Pt{X3, Y3, h_zero ? fe_zero() : Z3};  // h_zero here means P = -Q
}

}  // namespace

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
    jacobian_madd_kernel(const int64_t* __restrict__ x1,
                         const int64_t* __restrict__ y1,
                         const int64_t* __restrict__ z1,
                         const int64_t* __restrict__ x2,
                         const int64_t* __restrict__ y2,
                         const int64_t* __restrict__ valid,
                         int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, int64_t total,
                         FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int points = blockDim.x / G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * points;
  const int n = static_cast<int>(
      total - first < points ? total - first : points);
  int64_t* keep = reinterpret_cast<int64_t*>(smem + points * kPointBytes);
  const int64_t* in[kCoords] = {x1, y1, z1, x2, y2};
#pragma unroll
  for (int c = 0; c < kCoords; ++c)
    tile_stage(smem + c * kRowBytes, in[c] + first * NL, n, kPointBytes);
  if (valid != nullptr)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async8(keep + i, valid + first + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = threadIdx.x / G, l = threadIdx.x % G;
  const unsigned mask = group_mask<G>(threadIdx.x);
  unsigned char* rows = smem + p * kPointBytes;
  if (p < n) {
    uint32_t* S = reinterpret_cast<uint32_t*>(rows);
    constexpr int kMine = (kCoords + G - 1) / G;  // coordinates a lane reads
    Fe v[kMine];
#pragma unroll
    for (int i = 0; i < kMine; ++i)
      if (l + i * G < kCoords)
        v[i] = fe_from_row(rows + (l + i * G) * kRowBytes);
    __syncwarp(mask);  // the group has read its rows; its slots replace them
#pragma unroll
    for (int i = 0; i < kMine; ++i)
      if (l + i * G < kCoords) put(S, l + i * G, v[i]);
    __syncwarp(mask);
    const Pt R = valid != nullptr && keep[p] == 0
                     ? Pt{get(S, IX1), get(S, IY1), get(S, IZ1)}
                     : group_madd<G>(S, l, mask, F);
    __syncwarp(mask);  // the group has read its slots; output rows replace them
    for (int c = l; c < 3; c += G)
      fe_to_row(rows + c * kRowBytes, pick(c, R.x, R.y, R.z));
  }
  __syncthreads();
  int64_t* out[3] = {ox, oy, oz};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    tile_store(out[c] + first * NL, smem + c * kRowBytes, n, kPointBytes);
}

template <int G>
static cudaError_t launch(int threads, int blocks, cudaStream_t stream,
                          const int64_t* x1, const int64_t* y1,
                          const int64_t* z1, const int64_t* x2,
                          const int64_t* y2, const int64_t* valid,
                          int64_t* ox, int64_t* oy, int64_t* oz,
                          int64_t total, const FieldParams& F) {
  const cudaError_t err = allow_dynamic_smem<jacobian_madd_kernel<G>>(
      smem_bytes(kMaxThreads / G));
  if (err != cudaSuccess) return err;
  jacobian_madd_kernel<G><<<blocks, threads, smem_bytes(threads / G),
                            stream>>>(x1, y1, z1, x2, y2, valid, ox, oy, oz,
                                      total, F);
  return cudaGetLastError();
}

// group: threads per point (2 or 4); threads a block (a multiple of 32, at
// most 256); blocks: enough for total points (ec_kernels.madd_geometry).
extern "C" int cosnarks_jacobian_madd(int masked, const int64_t* x1,
                                      const int64_t* y1, const int64_t* z1,
                                      const int64_t* x2, const int64_t* y2,
                                      const int64_t* valid, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t total,
                                      int group, int threads, int blocks,
                                      const uint32_t* params, void* stream) {
  if ((masked != 0) != (valid != nullptr) || (group != 2 && group != 4) ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks <= 0 ||
      static_cast<int64_t>(blocks) * (threads / group) < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const FieldParams F = params_from(params);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(threads, blocks, s, x1, y1, z1, x2,
                                          y2, valid, ox, oy, oz, total, F));
  };
  return group == 2 ? run(launch<2>) : run(launch<4>);
}
