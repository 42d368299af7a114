// Prime-field arithmetic shared by the port's CUDA kernels, for fields of
// NW 32-bit words: COSNARKS_NW = 8 (the default; BN254 Fq and Fr,
// BLS12-381 Fr) or 12 (BLS12-381 Fq), fixed when a source is compiled.
//
// At the kernel boundary an element is 2 NW little-endian 16-bit limbs held
// in int64 (the port's tensor layout). Inside, it is NW 32-bit words;
// R = 2^(32 NW) either way, so Montgomery values are unchanged. Every
// function returns the canonical representative (< p), so kernel outputs
// equal the plain PyTorch versions limb for limb.
//
// Two ways across the boundary. fe_store writes an element's limbs from the
// thread that owns it (K6's one output point a window): neighbouring threads
// are 16 NW bytes apart, so a warp's 8-byte access touches 32 lines for 256
// useful bytes. The tile helpers at the end (K1-K5) move a block's
// consecutive elements through shared memory instead: 16-byte cp.async
// copies and 16-byte stores with neighbouring threads on neighbouring
// addresses, each element in a row padded by 16 bytes (144 bytes at eight
// words, 208 at twelve: NW + 1 pieces of 16 bytes, an odd number) so that
// eight threads reading 16 bytes of eight rows hit 32 distinct banks. Rows
// lie kRowBytes apart, or (K5) a stride of an odd number of pieces.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef COSNARKS_NW
#define COSNARKS_NW 8
#endif

namespace cosnarks {

constexpr int NW = COSNARKS_NW;  // 32-bit words per element
constexpr int NL = 2 * NW;       // 16-bit limbs per element at the boundary
static_assert(NW == 8 || NW == 12, "the kernels are built for 8 or 12 words");

// Field constants, passed by value to every kernel (8 NW + 4 bytes).
struct FieldParams {
  uint32_t p[NW];
  uint32_t one[NW];  // R mod p: Montgomery one
  uint32_t n0inv;    // -p^-1 mod 2^32
};

struct Fe {
  uint32_t w[NW];
};

__device__ __forceinline__ void fe_store(int64_t* __restrict__ dst,
                                         int64_t stride, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    dst[(2 * i) * stride] = a.w[i] & 0xFFFFu;
    dst[(2 * i + 1) * stride] = a.w[i] >> 16;
  }
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldParams& F) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = F.one[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  return c ? a : b;
}

// t + top * 2^(32 NW) (< 2p) -> canonical, subtracting p once when needed.
__device__ __forceinline__ Fe fe_reduce_once(const uint32_t* t, uint32_t top,
                                             const FieldParams& F) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(t[i]) - F.p[i] - borrow;
    d.w[i] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  if (top == 0 && borrow != 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) d.w[i] = t[i];
  }
  return d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const FieldParams& F) {
  uint32_t t[NW];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(a.w[i]) + b.w[i] + c;
    t[i] = static_cast<uint32_t>(s);
    c = static_cast<uint32_t>(s >> 32);
  }
  return fe_reduce_once(t, c, F);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const FieldParams& F) {
  return fe_add(a, a, F);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const FieldParams& F) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d.w[i] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  if (borrow) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t s = static_cast<uint64_t>(d.w[i]) + F.p[i] + c;
      d.w[i] = static_cast<uint32_t>(s);
      c = static_cast<uint32_t>(s >> 32);
    }
  }
  return d;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a, const FieldParams& F) {
  return fe_sub(fe_zero(), a, F);
}

// Montgomery product a*b*2^-(32 NW) mod p: CIOS over 32-bit words with
// 32x32->64-bit multiplies, then one conditional subtraction (the running
// value stays below 2p, its top word in t[NW]).
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const FieldParams& F) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + c;
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);
    uint32_t m = t[0] * F.n0inv;
    s = static_cast<uint64_t>(m) * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = static_cast<uint64_t>(m) * F.p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NW]) + c;
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
  return fe_reduce_once(t, t[NW], F);
}

// ---- tiles staged through shared memory (K1-K5) --------------------------

constexpr int kPieces = NL * 8 / 16;    // 16-byte pieces per element: NW
constexpr int kRowBytes = NL * 8 + 16;  // padded shared-memory row: 144, 208

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// An 8-byte copy (through L1; cp.async.cg takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying n consecutive elements from src (16-byte aligned) into
// padded rows `stride` bytes apart at dst; every thread of the block takes
// part. Commit, wait and __syncthreads() before reading the rows.
__device__ __forceinline__ void tile_stage(unsigned char* dst,
                                           const int64_t* src, int n,
                                           int stride = kRowBytes) {
  const char* g = reinterpret_cast<const char*>(src);
  for (int c = threadIdx.x; c < n * kPieces; c += blockDim.x)
    cp_async16(dst + (c / kPieces) * stride + (c % kPieces) * 16,
               g + c * 16);
}

// Store n padded rows `stride` bytes apart at src to n consecutive elements
// at dst (16-byte aligned); every thread of the block takes part.
__device__ __forceinline__ void tile_store(int64_t* dst,
                                           const unsigned char* src, int n,
                                           int stride = kRowBytes) {
  char* g = reinterpret_cast<char*>(dst);
  for (int c = threadIdx.x; c < n * kPieces; c += blockDim.x)
    *reinterpret_cast<uint4*>(g + c * 16) = *reinterpret_cast<const uint4*>(
        src + (c / kPieces) * stride + (c % kPieces) * 16);
}

// Element from a padded row: piece i holds limbs 2i and 2i+1 as int64, so
// their low words are the piece's .x and .z.
__device__ __forceinline__ Fe fe_from_row(const unsigned char* row) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(row)[i];
    r.w[i] = v.x | (v.z << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_to_row(unsigned char* row, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
    reinterpret_cast<uint4*>(row)[i] =
        make_uint4(a.w[i] & 0xFFFFu, 0u, a.w[i] >> 16, 0u);
}

// The most dynamic shared memory a block may opt in to on Hopper.
constexpr int kMaxDynamicSmem = 227 * 1024;

// Let Kernel take up to `bytes` (at most kMaxDynamicSmem) of dynamic shared
// memory on the current device, once per device (the launching wrapper runs
// on the host's hot path). The width is a template argument so that the
// instance's name differs between the 8- and 12-word libraries: a static
// local of an inline function is one object per process (a GNU unique
// symbol), and the kernels have the same names at both widths, so without
// it the library loaded second would find its flags set and skip the
// opt-in.
template <auto Kernel, int kWords = NW>
inline cudaError_t allow_dynamic_smem(int bytes) {
  if (bytes > kMaxDynamicSmem) bytes = kMaxDynamicSmem;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

inline FieldParams params_from(const uint32_t* words) {
  FieldParams F;
  for (int i = 0; i < NW; ++i) F.p[i] = words[i];
  for (int i = 0; i < NW; ++i) F.one[i] = words[NW + i];
  F.n0inv = words[2 * NW];
  return F;
}

}  // namespace cosnarks
