// K6: weighted bucket reduction, out_w = sum_j (j+1) S_j per window over W
// projective buckets (buckets[:, j] holds bucket j+1), as segmented running
// sums across the card.
//
// Replaces _wreduce_call of cosnarks_tpu/ec/pallas_ec.py (reached through
// weighted_bucket_sum): the same function in another order of additions.
// The TPU kernel held a window's W points in VMEM and read both weighted
// sums off double suffix ladders, rolls of a VMEM tile; here a window is
// split into P segments of m = W / P consecutive buckets
// (ec_kernels.wreduce_geometry), and ec_kernels.wreduce_plain runs the same
// additions in the same order, so the output limbs are equal:
//   segments  a group of G threads owns segment p (buckets p m .. p m + m-1)
//             and walks it from the top bucket down with two running sums
//             in its slots, run += S_j, then acc += run, both starting at
//             the top bucket: T_p = run = sum S_j and A_p = acc =
//             sum (j - p m + 1) S_j, 2 (m - 1) adds in series;
//   scale     D_p = (p m) T_p + A_p, by double-and-add over the bits of p
//             below its top bit (public), then log2 m doublings, then + A_p;
//             D_0 = A_0;
//   tree      out_w = sum_p D_p pairwise in a fixed order (level 1 adds
//             D_2i + D_2i+1, ...), a second kernel with one block a window.
// Every add and double is RCB's complete formula in rcb_group.cuh's layers
// (the code K3 and K4 run), so the identity, P = Q and P = -Q take the same
// path.
//
// What bounds it on the card: operations. The sum needs 2 (W - 1) adds a
// window by running sums (what chip_smoke.py's bound counts); this design
// does 2 (W - P) + P (log2 W + popcount) + P (segments, scale, tree), 1.2-
// 1.27x that at the table's splits (ec_kernels.wreduce_work). The grid
// covers nwin x P groups (8704 at 17 x 16384 with P = 512), a segment's
// step is 2 RCB adds deep, and each lane copies the next bucket's
// coordinate into its stage with 16-byte cp.async while the current step
// computes. The scratch is the nwin x P sums D_p. What is left (PERF.md):
// 12-19x the multiply bound, with 4-8 warps an SM (segments of 32
// buckets) and every lane of a group repeating the additions between
// layers.
#include "rcb_group.cuh"

using namespace cosnarks;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSegments = 1024;
// Slots of one segment's group: the running sum, the weighted sum, the
// step's bucket, the scaled sum, the products.
enum : int {
  RUN = 0, ACC = 3, OPQ = 6, SC = 9, PROD = 12,
  kSlots = PROD + kRcbProducts
};
constexpr int kGroupWords = kSlots * NW + 4;  // padded: 656, 976 bytes
constexpr int kStageBytes = 3 * NL * 8;       // one bucket's int64 limbs

constexpr int segment_smem_bytes(int groups) {
  return groups * (kGroupWords * 4 + kStageBytes);
}

// The tree: one block a window, groups of kTreeGroup threads a pair.
constexpr int kTreeThreads = 256;
constexpr int kTreeGroup = 4;

constexpr int tree_smem_bytes(int P) {
  return (3 * P + kTreeThreads / kTreeGroup * kRcbProducts) * NW * 4;
}

// P + Q into P's slots, then the group meets.
template <int G>
__device__ __forceinline__ void add_into(uint32_t* S, int l, int p, int q,
                                         int pr, int b3, unsigned mask,
                                         const FieldParams& F) {
  rcb_add<G>(S, l, p, q, pr, b3, mask, F,
             [&](int c, const Fe& v) { put(S, p + c, v); });
  __syncwarp(mask);
}

template <int G>
__device__ __forceinline__ void double_into(uint32_t* S, int l, int p,
                                            int pr, int b3, unsigned mask,
                                            const FieldParams& F) {
  rcb_double<G>(S, l, p, pr, b3, mask, F,
                [&](int c, const Fe& v) { put(S, p + c, v); });
  __syncwarp(mask);
}

}  // namespace

// Segment s = blockIdx.x * groups + (group in the block) of nwin x P:
// window s / P, segment p = s % P; writes D_p's words to
// dsum[(s * 3 + c) * NW].
template <int G>
__global__ void __launch_bounds__(kMaxThreads)
    wreduce_segments(const int64_t* __restrict__ bx,
                     const int64_t* __restrict__ by,
                     const int64_t* __restrict__ bz,
                     uint32_t* __restrict__ dsum, int64_t segs, int64_t W,
                     int P, int log_m, int b3, FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / G;
  const int j = threadIdx.x / G, l = threadIdx.x % G;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * groups + j;
  if (s >= segs) return;  // whole groups; no block-wide barrier follows
  const unsigned mask = group_mask<G>(threadIdx.x);
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) + j * kGroupWords;
  unsigned char* st = smem + groups * kGroupWords * 4 + j * kStageBytes;
  const int p = static_cast<int>(s % P);
  const int64_t lo = (s / P) * W + (static_cast<int64_t>(p) << log_m);
  const int64_t top = lo + (int64_t(1) << log_m) - 1;
  const int64_t* src[3] = {bx, by, bz};

  // Lane c mod G copies coordinate c of bucket b into its stage, and later
  // converts it into slot `to` + c: the lane reads only what it copied.
  auto stage = [&](int64_t b) {
    for (int c = l; c < 3; c += G) {
      const char* g = reinterpret_cast<const char*>(src[c] + b * NL);
#pragma unroll
      for (int i = 0; i < NW; ++i)
        cp_async16(st + c * NL * 8 + i * 16, g + i * 16);
    }
    cp_async_commit();
  };
  auto take = [&](int to) {
    cp_async_wait<0>();
    for (int c = l; c < 3; c += G)
      put(S, to + c, fe_from_row(st + c * NL * 8));
    __syncwarp(mask);
  };

  stage(top);
  take(RUN);
  for (int c = l; c < 3; c += G) put(S, ACC + c, get(S, RUN + c));
  __syncwarp(mask);
  if (top > lo) stage(top - 1);
  for (int64_t b = top - 1; b >= lo; --b) {
    take(OPQ);
    if (b > lo) stage(b - 1);  // in flight while the two adds compute
    add_into<G>(S, l, RUN, OPQ, PROD, b3, mask, F);
    add_into<G>(S, l, ACC, RUN, PROD, b3, mask, F);
  }

  int d = ACC;
  if (p > 0) {  // D_p = (p m) T_p + A_p
    for (int c = l; c < 3; c += G) put(S, SC + c, get(S, RUN + c));
    __syncwarp(mask);
    for (int bit = 30 - __clz(p); bit >= 0; --bit) {
      double_into<G>(S, l, SC, PROD, b3, mask, F);
      if ((p >> bit) & 1) add_into<G>(S, l, SC, RUN, PROD, b3, mask, F);
    }
    for (int i = 0; i < log_m; ++i)
      double_into<G>(S, l, SC, PROD, b3, mask, F);
    add_into<G>(S, l, SC, ACC, PROD, b3, mask, F);
    d = SC;
  }
  for (int c = l; c < 3; c += G)
    put(dsum + (s * 3 + c) * NW, 0, get(S, d + c));
}

// One block a window: its P sums D_p into slots 3p..3p+2, then log2 P
// levels of pairwise adds in place (level t adds D at 2^t apart), each
// pair on a group of kTreeGroup threads; slot 0 is out_w.
template <int G>
__global__ void __launch_bounds__(kTreeThreads)
    wreduce_tree(const uint32_t* __restrict__ dsum, int64_t* __restrict__ ox,
                 int64_t* __restrict__ oy, int64_t* __restrict__ oz, int P,
                 int b3, FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* S = reinterpret_cast<uint32_t*>(smem);
  const int64_t win = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(dsum + win * P * 3 * NW);
  for (int i = threadIdx.x; i < P * 3 * NW / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(S)[i] = src[i];
  __syncthreads();
  const int groups = blockDim.x / G;
  const int g = threadIdx.x / G, l = threadIdx.x % G;
  const unsigned mask = group_mask<G>(threadIdx.x);
  const int pr = 3 * P + g * kRcbProducts;
  for (int half = 1; half < P; half *= 2) {
    for (int i = g; i < P / (2 * half); i += groups)
      add_into<G>(S, l, 3 * (2 * half * i), 3 * (2 * half * i + half), pr,
                  b3, mask, F);
    __syncthreads();
  }
  if (g == 0) {
    int64_t* out[3] = {ox, oy, oz};
    for (int c = l; c < 3; c += G) fe_store(out[c] + win * NL, 1, get(S, c));
  }
}

template <int G>
static cudaError_t launch_segments(int threads, cudaStream_t stream,
                                   const int64_t* bx, const int64_t* by,
                                   const int64_t* bz, uint32_t* dsum,
                                   int64_t segs, int64_t W, int P, int log_m,
                                   int b3, const FieldParams& F) {
  const cudaError_t err = allow_dynamic_smem<wreduce_segments<G>>(
      segment_smem_bytes(kMaxThreads / G));
  if (err != cudaSuccess) return err;
  const int groups = threads / G;
  const auto blocks = static_cast<unsigned int>((segs + groups - 1) / groups);
  wreduce_segments<G><<<blocks, threads, segment_smem_bytes(groups),
                        stream>>>(bx, by, bz, dsum, segs, W, P, log_m, b3, F);
  return cudaGetLastError();
}

// P: segments a window (a power of two, at most W and kMaxSegments);
// group: threads a segment (2, 4 or 8); threads a block for the segments
// (a multiple of 32, at most 256); scratch: nwin x P x 3 NW words
// (ec_kernels.wreduce_geometry, wreduce_launch).
extern "C" int cosnarks_wreduce(const int64_t* bx, const int64_t* by,
                                const int64_t* bz, int64_t* ox, int64_t* oy,
                                int64_t* oz, uint32_t* scratch, int64_t nwin,
                                int64_t W, int64_t P, int b3, int group,
                                int threads, const uint32_t* params,
                                void* stream) {
  if (!b3_ok(b3) || nwin <= 0 || W < 64 || (W & (W - 1)) != 0 || P < 1 ||
      P > W || P > kMaxSegments || (P & (P - 1)) != 0 ||
      (group != 2 && group != 4 && group != 8) || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      segment_smem_bytes(threads / group) > kMaxDynamicSmem ||
      tree_smem_bytes(static_cast<int>(P)) > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int log_m = 0;
  while ((P << log_m) < W) ++log_m;
  const auto s = static_cast<cudaStream_t>(stream);
  const FieldParams F = params_from(params);
  const int p = static_cast<int>(P);
  cudaError_t err;
  if (group == 2) {
    err = launch_segments<2>(threads, s, bx, by, bz, scratch, nwin * P, W, p,
                             log_m, b3, F);
  } else if (group == 4) {
    err = launch_segments<4>(threads, s, bx, by, bz, scratch, nwin * P, W, p,
                             log_m, b3, F);
  } else {
    err = launch_segments<8>(threads, s, bx, by, bz, scratch, nwin * P, W, p,
                             log_m, b3, F);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_dynamic_smem<wreduce_tree<kTreeGroup>>(
      tree_smem_bytes(kMaxSegments));
  if (err != cudaSuccess) return static_cast<int>(err);
  wreduce_tree<kTreeGroup>
      <<<static_cast<unsigned int>(nwin), kTreeThreads, tree_smem_bytes(p),
         s>>>(scratch, ox, oy, oz, p, b3, F);
  return static_cast<int>(cudaGetLastError());
}
