// K1: batched Montgomery multiplication, out = a*b*2^-(32 NW) mod p, built
// at NW = 8 and 12 words (field.cuh).
//
// Replaces _mul_call / _mul_call_lm of cosnarks_tpu/ff/pallas_mont.py.
//
// What bounds it on the card: bytes. 48 NW bytes cross the int64 limb
// boundary per product (two 16 NW-byte operands in, one out: 384 at eight
// words, 576 at twelve) against 4 NW^2 + NW 32-bit multiplies (264, 588:
// a 32x32->64 product is a lo and a hi multiply), so an H100 is
// bytes-bound by about 7x and 5x, and the design is about moving those
// bytes at the card's rate. A thread that loads its own
// element as 2 NW 8-byte limbs puts neighbouring threads 16 NW bytes
// apart: every warp-wide access touches 32 lines for 256 useful bytes, and
// its stores reach L2 as partial sectors (30 % of the byte bound at 2^20).
//
// Design: a persistent grid. Block b walks over the tiles b, b + gridDim.x,
// ... of blockDim.x consecutive elements each (the wrapper,
// ff/mont_kernel.py, picks the tile and the number of blocks). Both operand
// tiles are contiguous; the block copies them into shared memory with
// 16-byte cp.async copies, neighbouring threads on neighbouring addresses,
// each element in a row padded by 16 bytes (field.cuh tile_stage), so
// each thread's 16-byte reads of its own rows are free of bank conflicts.
// Copies are double-buffered: the next tile's are in flight while this
// tile is multiplied. Each thread packs its element's limbs into NW words, runs
// fe_mul's CIOS in registers and writes its 2 NW output limbs over its
// operand-a row; the block then stores the tile with coalesced 16-byte
// stores. The ragged last tile is masked.
//
// cp.async and not a 1-D TMA bulk copy: one bulk copy of a tile leaves its
// rows unpadded (128 or 192 bytes), where eight threads reading 16 bytes of
// eight rows hit the same four or eight banks; padded rows would take one
// bulk copy per element.
#include "field.cuh"

using namespace cosnarks;

namespace {
constexpr int kMaxTile = 256;
}

__global__ void __launch_bounds__(kMaxTile)
    mont_mul_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ b, int64_t* __restrict__ out,
                    int64_t total, FieldParams F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockDim.x;
  const int64_t ntiles = (total + tile - 1) / tile;
  const int buf = tile * kRowBytes;  // one operand's tile; stage s holds a
                                     // at 2*s*buf and b right after it
  auto count = [&](int64_t first) {  // elements in the tile from `first`
    return static_cast<int>(total - first < tile ? total - first : tile);
  };
  auto stage = [&](int s, int64_t t) {
    const int64_t first = t * tile;
    const int n = count(first);
    tile_stage(smem + 2 * s * buf, a + first * NL, n);
    tile_stage(smem + (2 * s + 1) * buf, b + first * NL, n);
  };

  int64_t t = blockIdx.x;
  if (t < ntiles) stage(0, t);
  cp_async_commit();
  for (int s = 0; t < ntiles; t += gridDim.x, s ^= 1) {
    if (t + gridDim.x < ntiles) stage(s ^ 1, t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const int64_t first = t * tile;
    const int n = count(first);
    unsigned char* rows = smem + 2 * s * buf;
    if (static_cast<int>(threadIdx.x) < n) {
      unsigned char* row = rows + threadIdx.x * kRowBytes;
      fe_to_row(row, fe_mul(fe_from_row(row), fe_from_row(row + buf), F));
    }
    __syncthreads();
    tile_store(out + first * NL, rows, n);
    __syncthreads();  // the next pass copies the tile after next here
  }
  cp_async_wait<0>();
}

extern "C" int cosnarks_mont_mul(const int64_t* a, const int64_t* b,
                                 int64_t* out, int64_t total, int tile,
                                 int blocks, const uint32_t* params,
                                 void* stream) {
  if (tile <= 0 || tile > kMaxTile || tile % 32 != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * tile * kRowBytes;
  const cudaError_t err =
      allow_dynamic_smem<mont_mul_kernel>(4 * kMaxTile * kRowBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_mul_kernel<<<blocks, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, total, params_from(params));
  return static_cast<int>(cudaGetLastError());
}
