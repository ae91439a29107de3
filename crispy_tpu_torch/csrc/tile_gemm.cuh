// The f32 SIMT tile product of the inverse spectra kernel (K6).
//
// A block of 256 threads computes a 128 x 128 tile of A @ B in 16-deep steps
// through double-buffered shared memory: while the tile of step k is
// multiplied, the next step's operands are loaded into registers, then staged.
// Each thread keeps 8 x 8 f32 accumulators and multiplies with explicit
// __fmaf_rn, which the library-wide --fmad=false does not touch (a*b+c would
// compile to a separate multiply and add there, at half the rate).
//
// The caller supplies the operand loaders, here K6's (frame, previous frame)
// rows; the loaders mask the ragged edges themselves.

#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kBM = 128;  // rows of a block's tile
constexpr int kBN = 128;  // columns of a block's tile
constexpr int kBK = 16;   // depth of one shared-memory step
constexpr int kTHREADS = 256;
constexpr int kSMEM = 2 * kBK * (kBM + kBN);  // floats: two buffers of A and of B

// Thread t owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} and columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3} of the tile (ty = t / 16, tx = t % 16):
// its shared-memory reads are float4s that a warp takes without bank conflicts.
__device__ __forceinline__ int row_of(int i) {
  return (threadIdx.x >> 4) * 4 + (i & 3) + (i >> 2) * 64;
}
__device__ __forceinline__ int col_of(int j) {
  return (threadIdx.x & 15) * 4 + (j & 3) + (j >> 2) * 64;
}

// Staging: thread t loads row a_row() of A at depths a_k() + {0..7}, and rows
// b_k(0), b_k(1) of B at columns b_col() + {0..3}.
__device__ __forceinline__ int a_row() { return threadIdx.x & 127; }
__device__ __forceinline__ int a_k() { return (threadIdx.x >> 7) * 8; }
__device__ __forceinline__ int b_k(int p) { return (threadIdx.x >> 5) + 8 * p; }
__device__ __forceinline__ int b_col() { return (threadIdx.x & 31) * 4; }

// acc[i][j] = sum over k < K of A[row_of(i)][k] * B[k][col_of(j)], K a
// multiple of kBK, summed in increasing k.
//   load_a(k0, a): a[j] = A[a_row()][k0 + a_k() + j] for j < 8;
//   load_b(k0, b): b[4p + q] = B[k0 + b_k(p)][b_col() + q] for p < 2, q < 4.
// smem holds kSMEM floats, 16-byte aligned. Ends with __syncthreads(), so the
// caller may reuse smem at once.
template <class LoadA, class LoadB>
__device__ __forceinline__ void product(float (&acc)[8][8], int K, float* smem,
                                        LoadA load_a, LoadB load_b) {
  float* sa = smem;                  // [2][kBK][kBM]: A transposed
  float* sb = smem + 2 * kBK * kBM;  // [2][kBK][kBN]
  const int ty4 = (threadIdx.x >> 4) * 4;
  const int tx4 = (threadIdx.x & 15) * 4;
  float ra[8], rb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage = [&](int buf) {
    float* a = sa + buf * kBK * kBM;
    float* b = sb + buf * kBK * kBN;
#pragma unroll
    for (int j = 0; j < 8; ++j) a[(a_k() + j) * kBM + a_row()] = ra[j];
#pragma unroll
    for (int p = 0; p < 2; ++p)
      *reinterpret_cast<float4*>(b + b_k(p) * kBN + b_col()) =
          make_float4(rb[4 * p], rb[4 * p + 1], rb[4 * p + 2], rb[4 * p + 3]);
  };

  const int nk = K / kBK;
  load_a(0, ra);
  load_b(0, rb);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_a((kt + 1) * kBK, ra);
      load_b((kt + 1) * kBK, rb);
    }
    const float* a = sa + cur * kBK * kBM;
    const float* b = sb + cur * kBK * kBN;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kBM + ty4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * kBM + 64 + ty4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * kBN + tx4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * kBN + 64 + tx4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous step's barrier.
    if (kt + 1 < nk) stage(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace tile
