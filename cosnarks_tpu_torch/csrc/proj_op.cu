// K3: RCB complete projective point op over a flat batch.
//
// Replaces _proj_op_call of cosnarks_tpu/ec/pallas_ec.py. op 0: add
// (12 products), 1: mixed add (11), 2: mixed add with a validity mask
// (invalid points return P), 3: double (8); 3b comes in as a small signed
// integer and runs curve._mul_b3's double/add chain (point.cuh mul_b3;
// negative for Grumpkin).
//
// What bounds it on the card: by the roofline, bytes (6-9 coordinates of
// 16 NW bytes against 8-12 field products). In practice latency: the main
// path launches it mostly on 1-32 points (the Horner combine's doubles and
// adds, the last fold levels), where the launch is the formula's chain of
// products, 12, 11 or 8 long for one thread per point; and at its large
// launches (the suffix sums over every bucket) the chains must be hidden
// by enough points in flight.
//
// Design: a group of G threads per point (ec_kernels.proj_geometry: 8 up to
// 4096 points, 2 or 4 above, from scripts/torch_rcb_group_sweep.py). The
// block stages its points' coordinates through shared memory (field.cuh
// tile_stage: coalesced 16-byte cp.async copies into padded rows), each
// group converts its point's coordinates into 32-bit words in its slots,
// and runs the formula in layers of independent products (rcb_group.cuh: 2,
// 2 and 3 layers for the add, the madd and the double). RCB is complete, so
// identity, P = Q and P = -Q points take the same layers with no branch on
// their values; the masked madd's select is the group's, uniform across its
// lanes. Lane c mod G writes output coordinate c over the point's P rows,
// and the block stores the rows with coalesced 16-byte stores. What is left
// (PERF.md): at 1-32 points the launch floor and about 1-1.5 us a layer,
// most of it fe_mul's serial carry chain; at 2^14 points and more,
// instruction throughput, since every lane of a group repeats the
// additions between layers (hence smaller groups there).
#include "rcb_group.cuh"

using namespace cosnarks;

namespace {

constexpr int kMaxThreads = 256;
// Slots of one point: P, Q (3 coordinates, or x2, y2), the products.
enum : int { SP = 0, SQ = 3, SPR = 6, kSlots = SPR + kRcbProducts };
constexpr int kPointWords = kSlots * NW + 4;  // padded: 464, 688 bytes

constexpr int smem_bytes(int points) {
  return points * (6 * kRowBytes + kPointWords * 4);
}

}  // namespace

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
    proj_op_kernel(int op, const int64_t* __restrict__ x1,
                   const int64_t* __restrict__ y1,
                   const int64_t* __restrict__ z1,
                   const int64_t* __restrict__ x2,
                   const int64_t* __restrict__ y2,
                   const int64_t* __restrict__ z2,
                   const int64_t* __restrict__ valid,
                   int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                   int64_t* __restrict__ oz, int64_t total, int b3,
                   FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int points = blockDim.x / G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * points;
  const int n = static_cast<int>(
      total - first < points ? total - first : points);
  const int ncoords = op == 0 ? 6 : (op == 3 ? 3 : 5);
  auto rows = [&](int c) { return smem + c * points * kRowBytes; };
  const int64_t* in[6] = {x1, y1, z1, x2, y2, z2};
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (c < ncoords) tile_stage(rows(c), in[c] + first * NL, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = threadIdx.x / G, l = threadIdx.x % G;
  const unsigned mask = group_mask<G>(threadIdx.x);
  if (p < n) {
    uint32_t* S = reinterpret_cast<uint32_t*>(smem + 6 * points * kRowBytes) +
                  p * kPointWords;
    for (int c = l; c < ncoords; c += G)
      put(S, SP + c, fe_from_row(rows(c) + p * kRowBytes));
    __syncwarp(mask);
    // output coordinate c over the point's P row c, which this group alone
    // read, into its slots
    auto emit = [&](int c, const Fe& v) {
      fe_to_row(rows(c) + p * kRowBytes, v);
    };
    if (op == 0) {
      rcb_add<G>(S, l, SP, SQ, SPR, b3, mask, F, emit);
    } else if (op == 3) {
      rcb_double<G>(S, l, SP, SPR, b3, mask, F, emit);
    } else if (op == 2 && valid[first + p] == 0) {
      for (int c = l; c < 3; c += G) emit(c, get(S, SP + c));
    } else {
      rcb_madd<G>(S, l, SP, SQ, SPR, b3, mask, F, emit);
    }
  }
  __syncthreads();
  tile_store(ox + first * NL, rows(0), n);
  tile_store(oy + first * NL, rows(1), n);
  tile_store(oz + first * NL, rows(2), n);
}

template <int G>
static cudaError_t launch(int threads, int blocks, cudaStream_t stream,
                          int op, const int64_t* x1, const int64_t* y1,
                          const int64_t* z1, const int64_t* x2,
                          const int64_t* y2, const int64_t* z2,
                          const int64_t* valid, int64_t* ox, int64_t* oy,
                          int64_t* oz, int64_t total, int b3,
                          const FieldParams& F) {
  const cudaError_t err =
      allow_dynamic_smem<proj_op_kernel<G>>(smem_bytes(kMaxThreads / G));
  if (err != cudaSuccess) return err;
  proj_op_kernel<G><<<blocks, threads, smem_bytes(threads / G), stream>>>(
      op, x1, y1, z1, x2, y2, z2, valid, ox, oy, oz, total, b3, F);
  return cudaGetLastError();
}

// group: threads per point (2, 4 or 8); threads a block (a multiple of 32, at
// most 256, and at twelve words at most 128 in groups of 2, for shared
// memory); blocks: enough for total points (ec_kernels.proj_geometry).
extern "C" int cosnarks_proj_op(int op, const int64_t* x1, const int64_t* y1,
                                const int64_t* z1, const int64_t* x2,
                                const int64_t* y2, const int64_t* z2,
                                const int64_t* valid, int64_t* ox,
                                int64_t* oy, int64_t* oz, int64_t total,
                                int b3, int group, int threads, int blocks,
                                const uint32_t* params, void* stream) {
  if (op < 0 || op > 3 || !b3_ok(b3) ||
      (group != 2 && group != 4 && group != 8) ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes(threads / group) > kMaxDynamicSmem ||
      static_cast<int64_t>(blocks) * (threads / group) < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const FieldParams F = params_from(params);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(threads, blocks, s, op, x1, y1, z1,
                                          x2, y2, z2, valid, ox, oy, oz,
                                          total, b3, F));
  };
  if (group == 2) return run(launch<2>);
  if (group == 4) return run(launch<4>);
  return run(launch<8>);
}
