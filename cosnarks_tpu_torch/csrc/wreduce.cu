// K6: weighted bucket reduction, sum_j (j+1) * S_j per window over W
// projective buckets (W a power of two >= 64), one thread block per window.
//
// Replaces _wreduce_call of cosnarks_tpu/ec/pallas_ec.py and keeps its
// decomposition, so the output limbs equal ec_kernels.wreduce_plain's: with
// L = 8 rows, H = W/8 lanes and j = H*l + h,
//   sum_j (j+1) S_j = H * sum_l l*R_l + sum_h (h+1)*C_h,
// C_h = sum_l S[l, h] by three row-halving RCB adds, R_l = lane 0 of a
// suffix ladder along each row, and both weighted sums read off double
// suffix ladders (U = suffix(suffix(.)); sum_h (h+1) C_h = U[0],
// sum_l l R_l = U[1]). Ladder level s adds to each point the one s further
// along its row, or the identity (0 : 1 : 0) past the row's end.
//
// On the TPU one grid cell held the window's W points in VMEM. One window at
// c = 15 is 16384 points x 96 bytes = 1.5 MB, far beyond the 227 KB of
// shared memory, so here each ladder level is a pass of the block over
// double-buffered scratch in device memory (2W points per window, laid out
// as 24 word planes so neighbouring threads touch neighbouring words), with
// __syncthreads() between levels. Operations-bound by the roofline: the sum
// needs about 2W RCB adds per window (running sums), while the ladders do
// about 1.25 W log2(W/8) + 7 W/8, 6.1x and 7.3x that at c = 13 and 15, the
// identity adds past each row's end included. With one block per window
// (17-20 blocks on 132 SMs) it runs 167x and 228x above its bound. Filling
// the card (several blocks per window, or the ladders split across
// launches) is left to a later change.
#include "point.cuh"

using namespace cosnarks;

constexpr int kWThreads = 256;
constexpr int kWords = 3 * NW;  // 32-bit words per projective point

// Word k of scratch point j sits at base[k * cap + j].
__device__ __forceinline__ Pt sp_load(const uint32_t* base, int64_t cap,
                                      int64_t j) {
  Pt P;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    P.x.w[k] = base[k * cap + j];
    P.y.w[k] = base[(NW + k) * cap + j];
    P.z.w[k] = base[(2 * NW + k) * cap + j];
  }
  return P;
}

__device__ __forceinline__ void sp_store(uint32_t* base, int64_t cap,
                                         int64_t j, const Pt& P) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    base[k * cap + j] = P.x.w[k];
    base[(NW + k) * cap + j] = P.y.w[k];
    base[(2 * NW + k) * cap + j] = P.z.w[k];
  }
}

__device__ __forceinline__ Pt proj_identity(const FieldParams& F) {
  Pt I;
  I.x = fe_zero();
  I.y = fe_one(F);
  I.z = fe_zero();
  return I;
}

// Suffix ladder over `rows` rows of `width` points at scratch [src, src +
// rows * width), ping-ponging with [other, ...): max(1, ceil(log2 width))
// levels. Returns the offset that holds the result. All threads call it.
__device__ int64_t ladder(uint32_t* base, int64_t cap, int64_t src,
                          int64_t other, int64_t rows, int64_t width, int b3,
                          const FieldParams& F) {
  int nlev = 0;
  while ((int64_t(1) << nlev) < width) ++nlev;
  if (nlev == 0) nlev = 1;
  const int64_t n = rows * width;
  for (int t = 0; t < nlev; ++t) {
    const int64_t s = int64_t(1) << t;
    for (int64_t idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int64_t i = idx % width;
      Pt a = sp_load(base, cap, src + idx);
      Pt b = i < width - s ? sp_load(base, cap, src + idx + s)
                           : proj_identity(F);
      sp_store(base, cap, other + idx, proj_add(a, b, b3, F));
    }
    __syncthreads();
    const int64_t tmp = src;
    src = other;
    other = tmp;
  }
  return src;
}

__global__ void __launch_bounds__(kWThreads)
    wreduce_kernel(const int64_t* __restrict__ bx,
                   const int64_t* __restrict__ by,
                   const int64_t* __restrict__ bz, int64_t* __restrict__ ox,
                   int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                   uint32_t* __restrict__ scratch, int64_t W, int b3,
                   FieldParams F) {
  __shared__ uint32_t w2s[kWords];
  const int64_t win = blockIdx.x;
  const int64_t H = W / 8;
  const int64_t cap = 2 * W;
  uint32_t* base = scratch + win * kWords * cap;

  // the window's buckets S[l, h] = S_{H*l + h} into [0, W)
  for (int64_t j = threadIdx.x; j < W; j += blockDim.x) {
    sp_store(base, cap, j, pt_load(bx, by, bz, (win * W + j) * NL, 1));
  }
  __syncthreads();

  // C_h: rows l and l+4, then l and l+2, then 0 and 1; into [W, W + H)
  for (int64_t h = threadIdx.x; h < H; h += blockDim.x) {
    Pt b0 = proj_add(
        proj_add(sp_load(base, cap, h), sp_load(base, cap, 4 * H + h), b3, F),
        proj_add(sp_load(base, cap, 2 * H + h), sp_load(base, cap, 6 * H + h),
                 b3, F),
        b3, F);
    Pt b1 = proj_add(
        proj_add(sp_load(base, cap, H + h), sp_load(base, cap, 5 * H + h), b3,
                 F),
        proj_add(sp_load(base, cap, 3 * H + h), sp_load(base, cap, 7 * H + h),
                 b3, F),
        b3, F);
    sp_store(base, cap, W + h, proj_add(b0, b1, b3, F));
  }
  __syncthreads();

  // w2 = sum_h (h+1) C_h = U[0] of suffix(suffix(C))
  int64_t u = ladder(base, cap, W, W + H, 1, H, b3, F);
  u = ladder(base, cap, u, u == W ? W + H : W, 1, H, b3, F);
  if (threadIdx.x == 0) {
    Pt w2 = sp_load(base, cap, u);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w2s[k] = w2.x.w[k];
      w2s[NW + k] = w2.y.w[k];
      w2s[2 * NW + k] = w2.z.w[k];
    }
  }
  __syncthreads();

  // R_l: lane 0 of a suffix ladder along each row, copied to the other half
  const int64_t rows = ladder(base, cap, 0, W, 8, H, b3, F);
  const int64_t r0 = rows == 0 ? W : 0;
  if (threadIdx.x < 8) {
    sp_store(base, cap, r0 + threadIdx.x,
             sp_load(base, cap, rows + threadIdx.x * H));
  }
  __syncthreads();

  // w1 = sum_l l R_l = U[1] of suffix(suffix(R)), times H; out = w1 + w2
  u = ladder(base, cap, r0, r0 + 8, 1, 8, b3, F);
  u = ladder(base, cap, u, u == r0 ? r0 + 8 : r0, 1, 8, b3, F);
  if (threadIdx.x == 0) {
    Pt w1 = sp_load(base, cap, u + 1);
    for (int64_t m = H; m > 1; m >>= 1) w1 = proj_double(w1, b3, F);
    Pt w2;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w2.x.w[k] = w2s[k];
      w2.y.w[k] = w2s[NW + k];
      w2.z.w[k] = w2s[2 * NW + k];
    }
    pt_store(ox, oy, oz, win * NL, 1, proj_add(w1, w2, b3, F));
  }
}

extern "C" int cosnarks_wreduce(const int64_t* bx, const int64_t* by,
                                const int64_t* bz, int64_t* ox, int64_t* oy,
                                int64_t* oz, uint32_t* scratch, int64_t nwin,
                                int64_t W, int b3, const uint32_t* params,
                                void* stream) {
  if (b3 <= 0 || nwin <= 0 || W < 64 || (W & (W - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wreduce_kernel<<<static_cast<unsigned int>(nwin), kWThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      bx, by, bz, ox, oy, oz, scratch, W, b3, params_from(params));
  return static_cast<int>(cudaGetLastError());
}
