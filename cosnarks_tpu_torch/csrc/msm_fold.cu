// K4: the MSM bucket fold, both modes.
//
// Replaces _level0_call of cosnarks_tpu/ec/pallas_ec.py (level0_fold with
// proj_q = 0, proj_fold with proj_q = 1). Each fold lane runs K sequential
// steps; every step it writes the pre-update running sum to buf[:, t, lane],
// then folds the step's operand:
//   level 0  — affine (x, y), packed two 16-bit limbs per word, RCB mixed
//              add masked by `valid`;
//   proj_q   — projective (x, y, z) stream values, RCB add of the operand
//              or of the identity (invalid entries still pass through the
//              complete formula, as on the TPU).
// Flags per (t, lane): bit0 changed (a new segment starts: run := operand,
// or at level 0 the identity when invalid), bit1 valid, bit2 save-prefix
// (prefix := run before this step). Layouts, limb-major with lanes
// contiguous: operands (limbs, K, L), flags (K, L), buf (NL, K, L), run /
// prefix (NL, L). The limbs equal ec_kernels.fold_plain's.
//
// What bounds it on the card: by the roofline, bytes (a step reads 2-3
// operand coordinates and writes one dumped point per lane, against 11-12
// field products). In practice the chain of K steps, each an RCB add or
// madd: the TPU kernel carried `run` and `prefix` across a sequential grid
// axis, and one thread per lane makes a lane's chain 352-384 products long,
// with a 2560-lane level only 80 warps on 132 SMs.
//
// Design: a group of G threads per lane (ec_kernels.fold_geometry: 8 up to
// 4096 lanes, 2 above, from scripts/torch_rcb_group_sweep.py). The group
// keeps `run` (two banks: step t reads bank t & 1 and writes the other),
// `prefix` and the step's operand in its slots and runs each step's RCB add
// or madd in layers (rcb_group.cuh), so a step is 2 products deep. A step's
// operands and flags do not depend on `run`: the block copies step t + 1's
// into shared memory with 8-byte cp.async copies (neighbouring threads on
// neighbouring lanes) while step t computes, double-buffered, one
// __syncthreads() a step. The dump reads the bank that no group writes in
// that step and stores with neighbouring threads on neighbouring words of
// buf. The selects on `changed` and `valid` are the group's, uniform across
// its lanes. What is left (PERF.md): at 160-3328 lanes, about 4-5 us a step
// (two layers of fe_mul latency, the sync, the dump); at 40960 lanes and
// more, instruction throughput (every lane of a group repeats the
// additions between layers, hence groups of 2 there) and shared memory
// per lane.
#include "rcb_group.cuh"

using namespace cosnarks;

namespace {

constexpr int kMaxThreads = 256;
// Slots of one fold lane: two banks of the running sum, the prefix, the
// step's operand, the products.
enum : int {
  RUN0 = 0, RUN1 = 3, PRE = 6, OPQ = 9, PROD = 12,
  kSlots = PROD + kRcbProducts
};
constexpr int kLaneWords = kSlots * NW + 4;  // padded: 656, 976 bytes

// int64 words staged per lane and step: the operand (three coordinates of
// NL limbs, or two of NW packed words), then the flags.
template <bool kProjQ>
constexpr int kStageRows = kProjQ ? 3 * NL + 1 : 2 * NW + 1;

template <bool kProjQ>
constexpr int smem_bytes(int lanes) {
  return lanes * (2 * kStageRows<kProjQ> * 8 + kLaneWords * 4);
}

// Store the point at slot s of each of the block's n lanes to
// x/y/z[limb * stride + off + j]: a thread takes four words of a
// coordinate of one lane (a half at NW = 8, a third at 12), so
// neighbouring threads store neighbouring words.
__device__ __forceinline__ void store_lanes(const uint32_t* slots, int s,
                                            int n, int64_t* x, int64_t* y,
                                            int64_t* z, int64_t off,
                                            int64_t stride) {
  constexpr int kParts = NW / 4;  // 4-word parts of a coordinate
  for (int c = threadIdx.x; c < 3 * kParts * n; c += blockDim.x) {
    const int j = c % n, coord = c / n / kParts, part = c / n % kParts;
    const uint4 v = reinterpret_cast<const uint4*>(
        slots + j * kLaneWords + (s + coord) * NW)[part];
    int64_t* dst = (coord == 0 ? x : (coord == 1 ? y : z)) + off + j;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[(8 * part + 2 * i) * stride] = w[i] & 0xFFFFu;
      dst[(8 * part + 2 * i + 1) * stride] = w[i] >> 16;
    }
  }
}

// One step of the group's lane: st points at the lane's staged words (row r
// at st[r * lanes]); the running sum is read from slot `in` and written to
// slot `out` (lane c mod G writes coordinate c).
template <bool kProjQ, int G>
__device__ __forceinline__ void fold_step(uint32_t* S, int l,
                                          const int64_t* st, int lanes,
                                          int in, int out, int b3,
                                          unsigned mask,
                                          const FieldParams& F) {
  constexpr int kRows = kStageRows<kProjQ>;
  const int64_t fl = st[(kRows - 1) * lanes];
  const bool changed = (fl & 1) != 0, valid = (fl & 2) != 0;
  if ((fl & 4) != 0)
    for (int c = l; c < 3; c += G) put(S, PRE + c, get(S, in + c));
  // the operand into its slots, lane c converting coordinate c; a
  // projective addend that is not valid is the identity (0 : 1 : 0)
  const bool ident = kProjQ && !changed && !valid;
  for (int c = l; c < (kProjQ ? 3 : 2); c += G) {
    Fe v;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      v.w[i] = kProjQ
                   ? static_cast<uint32_t>(st[(c * NL + 2 * i) * lanes]) |
                         static_cast<uint32_t>(
                             st[(c * NL + 2 * i + 1) * lanes]) << 16
                   : static_cast<uint32_t>(st[(c * NW + i) * lanes]);
    }
    put(S, OPQ + c, ident ? (c == 1 ? fe_one(F) : fe_zero()) : v);
  }
  __syncwarp(mask);
  auto emit = [&](int c, const Fe& v) { put(S, out + c, v); };
  if (!changed && (kProjQ || valid)) {
    if constexpr (kProjQ) {
      rcb_add<G>(S, l, in, OPQ, PROD, b3, mask, F, emit);
    } else {
      rcb_madd<G>(S, l, in, OPQ, PROD, b3, mask, F, emit);
    }
    return;
  }
  for (int c = l; c < 3; c += G) {
    if (!changed) {  // level 0, not valid: run stays
      emit(c, get(S, in + c));
    } else if (kProjQ || (valid && c < 2)) {  // the operand
      emit(c, get(S, OPQ + c));
    } else {  // level 0: Z = 1, or (0 : 1 : 0) when not valid
      emit(c, (valid ? c == 2 : c == 1) ? fe_one(F) : fe_zero());
    }
  }
}

}  // namespace

template <bool kProjQ, int G>
__global__ void __launch_bounds__(kMaxThreads)
    msm_fold_kernel(const int64_t* __restrict__ q0,
                    const int64_t* __restrict__ q1,
                    const int64_t* __restrict__ q2,
                    const int64_t* __restrict__ flags,
                    int64_t* __restrict__ bx, int64_t* __restrict__ by,
                    int64_t* __restrict__ bz, int64_t* __restrict__ rx,
                    int64_t* __restrict__ ry, int64_t* __restrict__ rz,
                    int64_t* __restrict__ px, int64_t* __restrict__ py,
                    int64_t* __restrict__ pz, int64_t K, int64_t L, int b3,
                    FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kStageRows<kProjQ>;
  constexpr int kWordsPerCoord = kProjQ ? NL : NW;
  const int lanes = blockDim.x / G;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * lanes;
  const int n = static_cast<int>(L - lane0 < lanes ? L - lane0 : lanes);
  const int64_t kl = K * L;
  int64_t* stage = reinterpret_cast<int64_t*>(smem);  // [2][kRows][lanes]
  uint32_t* slots =
      reinterpret_cast<uint32_t*>(smem + 2 * kRows * lanes * 8);
  // start copying step t's operands and flags into stage buffer t & 1
  auto stage_step = [&](int64_t t) {
    int64_t* dst = stage + (t & 1) * kRows * lanes;
    for (int c = threadIdx.x; c < kRows * n; c += blockDim.x) {
      const int r = c / n, j = c % n, coord = r / kWordsPerCoord;
      const int64_t* src =
          r == kRows - 1
              ? flags + t * L
              : (coord == 0 ? q0 : (coord == 1 ? q1 : q2)) +
                    (r % kWordsPerCoord) * kl + t * L;
      cp_async8(dst + r * lanes + j, src + lane0 + j);
    }
    cp_async_commit();
  };

  const int j = threadIdx.x / G, l = threadIdx.x % G;
  const unsigned mask = group_mask<G>(threadIdx.x);
  uint32_t* S = slots + j * kLaneWords;
  if (j < n) {  // run and prefix start as the identity (0 : 1 : 0)
    for (int c = l; c < 3; c += G) {
      const Fe v = c == 1 ? fe_one(F) : fe_zero();
      put(S, RUN0 + c, v);
      put(S, PRE + c, v);
    }
  }
  stage_step(0);
  for (int64_t t = 0; t < K; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // step t staged, bank t & 1 written, step t - 1 done
    if (t + 1 < K) stage_step(t + 1);
    const int in = t & 1 ? RUN1 : RUN0, out = t & 1 ? RUN0 : RUN1;
    store_lanes(slots, in, n, bx, by, bz, t * L + lane0, kl);
    if (j < n)
      fold_step<kProjQ, G>(S, l, stage + (t & 1) * kRows * lanes + j, lanes,
                           in, out, b3, mask, F);
  }
  __syncthreads();
  store_lanes(slots, K & 1 ? RUN1 : RUN0, n, rx, ry, rz, lane0, L);
  store_lanes(slots, PRE, n, px, py, pz, lane0, L);
}

template <bool kProjQ, int G>
static cudaError_t launch(int threads, int blocks, cudaStream_t stream,
                          const int64_t* qx, const int64_t* qy,
                          const int64_t* qz, const int64_t* flags,
                          int64_t* bx, int64_t* by, int64_t* bz, int64_t* rx,
                          int64_t* ry, int64_t* rz, int64_t* px, int64_t* py,
                          int64_t* pz, int64_t K, int64_t L, int b3,
                          const FieldParams& F) {
  const cudaError_t err = allow_dynamic_smem<msm_fold_kernel<kProjQ, G>>(
      smem_bytes<kProjQ>(kMaxThreads / G));
  if (err != cudaSuccess) return err;
  msm_fold_kernel<kProjQ, G>
      <<<blocks, threads, smem_bytes<kProjQ>(threads / G), stream>>>(
          qx, qy, qz, flags, bx, by, bz, rx, ry, rz, px, py, pz, K, L, b3,
          F);
  return cudaGetLastError();
}

// group: threads per fold lane (2 or 8, the two ec_kernels.FOLD_GEOMETRY
// picks); threads a block (a multiple of 32, at most 256, and at twelve
// words at most 128 in groups of 2, for shared memory); blocks: enough for
// L lanes (ec_kernels.fold_geometry).
extern "C" int cosnarks_msm_fold(int proj_q, const int64_t* qx,
                                 const int64_t* qy, const int64_t* qz,
                                 const int64_t* flags, int64_t* bx,
                                 int64_t* by, int64_t* bz, int64_t* rx,
                                 int64_t* ry, int64_t* rz, int64_t* px,
                                 int64_t* py, int64_t* pz, int64_t K,
                                 int64_t L, int b3, int group, int threads,
                                 int blocks, const uint32_t* params,
                                 void* stream) {
  if (!b3_ok(b3) || K <= 0 || (group != 2 && group != 8) || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (proj_q ? smem_bytes<true>(threads / group)
              : smem_bytes<false>(threads / group)) > kMaxDynamicSmem ||
      static_cast<int64_t>(blocks) * (threads / group) < L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const FieldParams F = params_from(params);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(threads, blocks, s, qx, qy, qz,
                                          flags, bx, by, bz, rx, ry, rz, px,
                                          py, pz, K, L, b3, F));
  };
  if (proj_q) {
    if (group == 2) return run(launch<true, 2>);
    return run(launch<true, 8>);
  }
  if (group == 2) return run(launch<false, 2>);
  return run(launch<false, 8>);
}
