// K6: the inverse windowed DFT with the overlap-add and the carried
// synthesis tail folded in, one f32 tile product.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_frontend.py::inv_spectrum_ola (body
// `_inv_kernel`): for spectra Y [S, F, 1024] in the padded layout (re of
// frequency k at column k, im at 512 + k),
//   out[s, f]  = Y[s, f] @ invA + (Y[s, f - 1] @ invB, or syn_mem[s] at f = 0)
//   new_mem[s] = Y[s, F - 1] @ invB
// with invA, invB [1024, 480] the two halves of the windowed inverse table.
// Its plain PyTorch version is frontend_kernels.inv_spectrum_ola_reference.
//
// What bounds it on the H100: the function's floor is its bytes, ~0.39 GB at
// S=128, F=500, ~0.12 ms at 3.35 TB/s; an inverse FFT and the overlap-add
// need only ~25,000 FLOP per frame (~1.6 GFLOP in all, ~0.02 ms of f32). This
// kernel computes the inverse DFT as a dense product, 2 x 2048 x 512 FLOP per
// frame (~134 GFLOP executed, ~2.0 ms at 67 TFLOP/s of f32 FMA outside the
// tensor cores), so its own design bounds it by operations at ~17x the floor.
//
// Design: the plain SIMT tile product of tile_gemm.cuh over S x (F + 1)
// virtual rows (s, f) of depth 2048: row (s, f) is [Y[s, f] | Y[s, f - 1]]
// against [invA ; invB], with the missing half zero, so frame f's output
// comes out whole, overlap-add included; the block adds syn_mem on frame 0
// and writes the extra row f = F, which is Y[F - 1] @ invB alone, as the new
// carry, for any F. A block reads its own previous frame's row of Y from
// device memory: the TPU version's edge array was a workaround for Mosaic's
// blocking and is not needed. The 480 output columns take 4 column tiles, the
// last one three-quarters full, and the pad rows of the table are multiplied
// through: 2 x 2048 x 512 FLOP are executed per frame, 14% above the dense
// inverse DFT's 2 x 962 x 960. An FFT-structured kernel, or wgmma, TMA and
// 3xTF32 tensor-core products, are later work.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kFRAME = 480;
constexpr int kYPAD = 1024;

__global__ void __launch_bounds__(tile::kTHREADS, 2)
inv_ola_kernel(const float* __restrict__ Y, const float* __restrict__ inva,
               const float* __restrict__ invb, const float* __restrict__ mem,
               float* __restrict__ out, float* __restrict__ new_mem, int F, int M) {
  __shared__ __align__(16) float smem[tile::kSMEM];
  const int m0 = blockIdx.x * tile::kBM;
  const int n0 = blockIdx.y * tile::kBN;

  const float* head = nullptr;  // Y[s, f] (none on the carry row)
  const float* tail = nullptr;  // Y[s, f - 1] (none on frame 0)
  const int am = m0 + tile::a_row();
  if (am < M) {
    const int s = am / (F + 1), f = am % (F + 1);
    const size_t row = (size_t)s * F + f;
    if (f < F) head = Y + row * kYPAD;
    if (f > 0) tail = Y + (row - 1) * kYPAD;
  }
  auto load_a = [&](int k0, float(&a)[8]) {
    const float* src = k0 < kYPAD ? head : tail;
    const int k = (k0 < kYPAD ? k0 : k0 - kYPAD) + tile::a_k();
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = src ? __ldg(src + k + j) : 0.f;
  };
  const int bn = n0 + tile::b_col();
  const bool bcol_live = bn < kFRAME;  // 480 is a multiple of 4: a quad is all in or all out
  auto load_b = [&](int k0, float(&b)[8]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k = k0 + tile::b_k(p);
      const float* row =
          (k < kYPAD ? inva + (size_t)k * kFRAME : invb + (size_t)(k - kYPAD) * kFRAME) + bn;
#pragma unroll
      for (int q = 0; q < 4; ++q) b[4 * p + q] = bcol_live ? __ldg(row + q) : 0.f;
    }
  };
  float acc[8][8];
  tile::product(acc, 2 * kYPAD, smem, load_a, load_b);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile::row_of(i);
    if (m >= M) continue;
    const int s = m / (F + 1), f = m % (F + 1);
    float* dst = f < F ? out + ((size_t)s * F + f) * kFRAME : new_mem + (size_t)s * kFRAME;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + tile::col_of(4 * h);
      if (n >= kFRAME) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][4 * h + q];
        if (f == 0) v[q] += __ldg(mem + (size_t)s * kFRAME + n + q);
      }
      *reinterpret_cast<float4*>(dst + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// Y [S * F, 1024], inva and invb [1024, 480], mem [S, 480] contiguous; writes
// out [S * F, 480] and new_mem [S, 480].
extern "C" int crispy_inv_spectrum_ola(const float* Y, const float* inva, const float* invb,
                                       const float* mem, float* out, float* new_mem, int S,
                                       int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = S * (F + 1);
  const dim3 grid((M + tile::kBM - 1) / tile::kBM, (kFRAME + tile::kBN - 1) / tile::kBN);
  inv_ola_kernel<<<grid, tile::kTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Y, inva, invb, mem, out, new_mem, F, M);
  return static_cast<int>(cudaGetLastError());
}
