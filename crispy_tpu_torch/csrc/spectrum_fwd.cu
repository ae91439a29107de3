// K4 and K5: the windowed 960-point DFT of each frame's window and its 22
// band energies, one f32 tile product with the band sums fused after it.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_frontend.py::fwd_spectrum_bands (K4,
// body `_fwd_kernel`) and ::win_spectrum_bands (K5, body `_win_kernel`):
//   Y[m, :]  = window_m @ T    T = dft_fwd_pad [960, 1024]: the re part of
//                              frequency k at column k, the im part at 512 + k
//   Ex[m, b] = sum_k (Y[m, k]^2 + Y[m, 512 + k]^2) * band_e_pad[k, b]
// for every row m = s * F + f (stream s, frame f). K4's window f is
// ext_a[s, 480 f : 480 f + 960], read in place from the HP signal (frames f
// and f + 1 are adjacent); K5's windows are K3's gathered [S, F, 960]. Their
// plain PyTorch versions are frontend_kernels.fwd_spectrum_bands_reference and
// win_spectrum_bands_reference.
//
// What bounds it on the H100: the function's floor is its bytes, ~0.4 GB (K4)
// or ~0.5 GB (K5) at S=128, F=500, ~0.12-0.15 ms at 3.35 TB/s; an FFT needs
// only ~28,000 FLOP per window (~1.8 GFLOP in all, ~0.03 ms of f32). This
// kernel computes the DFT as a dense product, 2 x 960 x 1024 FLOP per window
// (~126 GFLOP executed, ~1.9 ms at 67 TFLOP/s of f32 FMA outside the tensor
// cores), so its own design bounds it by operations at ~15x the floor.
//
// Design: the plain SIMT tile product of tile_gemm.cuh. One block owns 128
// rows and walks the 8 column tiles of Y itself; column tile c holds the re
// columns 64c..64c+63 and the im columns 512+64c.. of the same frequencies, so
// each thread holds re and im of its frequencies, squares them in registers,
// and the block reduces e against the tile's 64 rows of the band table
// through shared memory. Each thread keeps the band sums of one row (11 of
// its 22 bands) in registers across the 8 tiles, always in the same order,
// so Ex needs no atomics and no second pass and is the same from run to run.
// The pad columns 481..511 and 993..1023 are written as zeros. K4 and K5
// both take the whole [960, 1024] table. K4's rows are read
// through a base pointer and a row stride with scalar loads: the ext slice the
// pipeline passes starts 769 floats into rows of odd length, so it is neither
// contiguous nor 16-byte aligned, and the copy that .contiguous() would make
// (~250 MB read and written per block step) is saved. The 1024 columns
// include 62 of padding, 6% above the dense DFT's 962. An FFT-structured
// kernel, or wgmma, TMA and 3xTF32 tensor-core products, are later work.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kWIN = 960;
constexpr int kNFREQ = 481;
constexpr int kYPAD = 1024;
constexpr int kIM0 = 512;
constexpr int kNB = 22;
constexpr int kCOL_TILES = kYPAD / tile::kBN;  // 8
constexpr int kFREQS = tile::kBN / 2;          // 64 frequencies per column tile
constexpr int kES = kFREQS + 1;                // padded e row: conflict-free reads
constexpr int kBANDS = kNB / 2;                // band sums a thread keeps
constexpr int kE_FLOATS = tile::kBM * kES;
constexpr int kSTAGE = tile::kSMEM > kE_FLOATS ? tile::kSMEM : kE_FLOATS;
constexpr int kSMEM = kSTAGE + kFREQS * kNB;  // + the tile's band rows

__global__ void __launch_bounds__(tile::kTHREADS, 2)
spectrum_bands_kernel(const float* __restrict__ x, int ld_s, int ld_f, int F, int M,
                      const float* __restrict__ tab, const float* __restrict__ band,
                      float* __restrict__ Y,
                      float* __restrict__ Ex) {
  __shared__ __align__(16) float smem[kSMEM];
  float* es = smem;                 // [kBM][kES]: e of the column tile
  float* band_s = smem + kSTAGE;    // [kFREQS][kNB]
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * tile::kBM;

  const int am = m0 + tile::a_row();
  const float* arow =
      am < M ? x + (size_t)(am / F) * ld_s + (size_t)(am % F) * ld_f : nullptr;
  auto load_a = [&](int k0, float(&a)[8]) {
    const int k = k0 + tile::a_k();
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = arow ? __ldg(arow + k + j) : 0.f;
  };

  const int bm = t >> 1;                 // the row whose band sums this thread keeps
  const int b0 = (t & 1) * kBANDS;
  float exb[kBANDS];
#pragma unroll
  for (int b = 0; b < kBANDS; ++b) exb[b] = 0.f;

  float acc[8][8];
  for (int c = 0; c < kCOL_TILES; ++c) {
    const int f0 = c * kFREQS;  // first frequency of the column tile
    const int bl = tile::b_col();
    const int bcol = bl < kFREQS ? f0 + bl : kIM0 + f0 + bl - kFREQS;
    auto load_b = [&](int k0, float(&b)[8]) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* row = tab + (size_t)(k0 + tile::b_k(p)) * kYPAD + bcol;
#pragma unroll
        for (int q = 0; q < 4; ++q) b[4 * p + q] = __ldg(row + q);
      }
    };
    tile::product(acc, kWIN, smem, load_a, load_b);

    // Y, and e = re^2 + im^2 of this thread's 4 frequencies into shared memory.
    const int fq = f0 + tile::col_of(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile::row_of(i);
      float re[4], im[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool live = fq + q < kNFREQ;
        re[q] = live ? acc[i][q] : 0.f;
        im[q] = live ? acc[i][4 + q] : 0.f;
        es[r * kES + tile::col_of(q)] = __fmaf_rn(im[q], im[q], re[q] * re[q]);
      }
      if (m0 + r < M) {
        float* yrow = Y + (size_t)(m0 + r) * kYPAD;
        *reinterpret_cast<float4*>(yrow + fq) = make_float4(re[0], re[1], re[2], re[3]);
        *reinterpret_cast<float4*>(yrow + kIM0 + fq) = make_float4(im[0], im[1], im[2], im[3]);
      }
    }
    for (int i = t; i < kFREQS * kNB; i += tile::kTHREADS)
      band_s[i] = __ldg(band + (size_t)f0 * kNB + i);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFREQS; ++j) {
      const float e = es[bm * kES + j];
#pragma unroll
      for (int b = 0; b < kBANDS; ++b) exb[b] = __fmaf_rn(e, band_s[j * kNB + b0 + b], exb[b]);
    }
    __syncthreads();  // es is the next tile's staging area
  }
  if (m0 + bm < M) {
    float* exrow = Ex + (size_t)(m0 + bm) * kNB + b0;
#pragma unroll
    for (int b = 0; b < kBANDS; ++b) exrow[b] = exb[b];
  }
}

}  // namespace

// Row m = s * F + f of the windows starts at x + s * ld_s + f * ld_f (floats);
// tab is the DFT table [960, 1024], band [512, 22]; Y [S * F, 1024] and
// Ex [S * F, 22] contiguous.
extern "C" int crispy_spectrum_bands(const float* x, int ld_s, int ld_f, int S, int F,
                                     const float* tab, const float* band, float* Y,
                                     float* Ex, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = S * F;
  const dim3 grid((M + tile::kBM - 1) / tile::kBM);
  spectrum_bands_kernel<<<grid, tile::kTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ld_s, ld_f, F, M, tab, band, Y, Ex);
  return static_cast<int>(cudaGetLastError());
}
