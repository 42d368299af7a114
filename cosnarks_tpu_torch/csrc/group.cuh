// Slots of a group of threads that shares one point (K2-K6).
//
// A group keeps its point's field elements as NW 32-bit words in shared
// memory, one slot each. In a layer of independent products every lane
// picks its operands by its index, computes one product with fe_mul and
// writes it to a slot of its own; the group then meets at __syncwarp on its
// own mask before the next layer reads the slots. Operands are picked by
// index, never by branching on the lane, so the lanes of a group (and the
// groups of a warp) share one instruction stream.
#pragma once

#include "field.cuh"

namespace cosnarks {

__device__ __forceinline__ Fe get(const uint32_t* S, int i) {
  const uint4* p = reinterpret_cast<const uint4*>(S + i * NW);
  Fe r;
#pragma unroll
  for (int q = 0; q < NW / 4; ++q) {
    const uint4 v = p[q];
    r.w[4 * q] = v.x; r.w[4 * q + 1] = v.y;
    r.w[4 * q + 2] = v.z; r.w[4 * q + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ void put(uint32_t* S, int i, const Fe& a) {
  uint4* p = reinterpret_cast<uint4*>(S + i * NW);
#pragma unroll
  for (int q = 0; q < NW / 4; ++q)
    p[q] = make_uint4(a.w[4 * q], a.w[4 * q + 1], a.w[4 * q + 2],
                      a.w[4 * q + 3]);
}

// Entry k (0 <= k < 8) of up to eight slot indices below 256, packed in one
// 64-bit constant when the indices are constants.
template <typename... I>
__device__ __forceinline__ int by_lane(int k, I... s) {
  static_assert(sizeof...(s) <= 8, "at most eight entries");
  uint64_t table = 0;
  int shift = 0;
  ((table |= static_cast<uint64_t>(s) << shift, shift += 8), ...);
  return static_cast<int>((table >> (8 * k)) & 0xFF);
}

__device__ __forceinline__ Fe pick_from(int, int, const Fe& r) { return r; }

template <typename... V>
__device__ __forceinline__ Fe pick_from(int k, int i, const Fe& r,
                                        const Fe& v, const V&... vs) {
  Fe s;
#pragma unroll
  for (int j = 0; j < NW; ++j) s.w[j] = k >= i ? v.w[j] : r.w[j];
  return pick_from(k, i + 1, s, vs...);
}

// v_k for k below the number of values, the last value past it, word by
// word.
template <typename... V>
__device__ __forceinline__ Fe pick(int k, const Fe& v0, const V&... vs) {
  return pick_from(k, 1, v0, vs...);
}

// a where c holds, else zero, word by word.
__device__ __forceinline__ Fe keep_if(bool c, const Fe& a) {
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = c ? a.w[j] : 0u;
  return r;
}

// One layer of N independent products: product k goes to slot out + k and
// is computed by lane k mod G; operands(k, a, b) sets its two factors.
template <int G, int N, class Operands>
__device__ __forceinline__ void group_layer(uint32_t* S, int l, int out,
                                            unsigned mask,
                                            const FieldParams& F,
                                            Operands operands) {
#pragma unroll
  for (int r = 0; r < (N + G - 1) / G; ++r) {
    const int k = r * G + l;
    if (k < N) {
      Fe a, b;
      operands(k, a, b);
      put(S, out + k, fe_mul(a, b, F));
    }
  }
  __syncwarp(mask);
}

// The __syncwarp mask of the group of G lanes (G divides 32) that holds
// thread t.
template <int G>
__device__ __forceinline__ unsigned group_mask(int t) {
  static_assert(G < 32 && 32 % G == 0, "a group lies within one warp");
  return ((1u << G) - 1u) << (t & 31 & ~(G - 1));
}

}  // namespace cosnarks
