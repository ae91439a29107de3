// K4 and K5: the windowed 960-point DFT of each frame's window and its 22
// band energies, as a real FFT in registers and shared memory.
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
// win_spectrum_bands_reference (the dense products).
//
// The table is make_params' windowed DFT: T[n, k] = f32(w[n] cos(2 pi n k /
// 960) / 960) (re) and f32(-w[n] sin(..) / 960) (im). Its column 0 is
// exactly f32(w[n] / 960), so the kernel reads that column, multiplies the
// window and RNNoise's 1/960 into the samples on load, and takes the DFT
// itself. A table that is not of that form gives a wrong result: the wrapper's
// docstring says so, and a CPU test checks the column.
//
// What bounds it on the H100: bytes. At S=128, F=500 the function moves
// ~0.39 GB (K4) or ~0.52 GB (K5), ~0.12-0.15 ms at 3.35 TB/s, two thirds of it
// the padded Y; the FFT needs ~28,000 FLOP per window (~1.8 GFLOP, ~0.03 ms
// of f32). The tensor cores would not help an FFT of this size, which the
// bytes bound, so none are used. The measured share of the bound is in
// PERF.md's kernel table.
//
// Design:
// - Real transform: each window x[0..959] is packed as 480 complex samples
//   z[n] = x[2n] + i x[2n+1]; one 480-point complex FFT gives Z, and the 481
//   real-input bins are X[k] = (Z[k] + Z*[480-k]) / 2
//   - i W960^k (Z[k] - Z*[480-k]) / 2, with Z[480] = Z[0].
// - One warp per window, 480 = 15 x 32: lane l holds z[l + 32 j], j = 0..14,
//   in registers; a 15-point DFT over j in each lane (prime factor 3 x 5,
//   no inner twiddles), the twiddles W480^(l k1), then fifteen 32-point DFTs
//   across the lanes, five radix-2 decimation-in-frequency stages of
//   __shfl_xor_sync. Lane l ends with Z[k1 + 15 brev5(l)]. The transform
//   is fft480.cuh's, shared with K6.
// - The split needs Z[k] and Z[480-k] together: Z goes through the warp's
//   3.84 KB in shared memory, which also puts it in frequency order, so lane l
//   takes the bins l + 32 i and a warp's stores of Y are 128-byte rows,
//   the pad columns 481..511 and 993..1023 written as zeros.
// - Band energies: each lane sums its 16 bins into the 22 bands against the
//   whole band table (staged transposed in shared memory), then a
//   reduce-scatter of 5 xor-shuffle stages leaves band b in lane b. The order
//   is fixed, there are no atomics, and Ex is the same from run to run.
// - Twiddles are computed on the host in float64 and cast to f32
//   (frontend_kernels.fft_twiddles), as the table was built; the 3- and
//   5-point constants are f32 roundings of the same float64 values.
// - Memory: one persistent block of 16 warps per SM stages the twiddles, the
//   window column and the band table once (56 KB), then takes runs of 16
//   consecutive frames of one stream. It copies each run's span into shared
//   memory once with cp.async, the next run's span in flight while this
//   run is computed (two 60 KB buffers): for K4 (16 + 1) x 480 samples, each
//   read once and not twice, as coalesced 4-byte copies (the slice the
//   pipeline passes is strided and not 16-byte aligned); for K5 16
//   contiguous 3,840-byte rows as 16-byte copies. Once a run's windows are
//   in registers its buffer holds the warps' Z. No intermediate goes to
//   device memory.
// - What it waits on, by count: ~570 shared-memory wavefronts per window,
//   352 of them the band sums' table reads (22 per bin and lane), against
//   one wavefront per clock per SM; and ~2,500 warp instructions per window.
//   Reading the band table once for several windows (lanes over bands, bins
//   broadcast) is the next step if this kernel is to come nearer its bound.
// - The library is built with --fmad=false; every multiply-add meant to be
//   fused is written as __fmaf_rn.

#include <cuda_runtime.h>

#include "fft480.cuh"

namespace {

using fft480::cp_async;
using fft480::forward;
using fft480::lane_bin;
using fft480::lane_twiddles;

constexpr int kWIN = 960;
constexpr int kHALF = 480;  // points of the packed complex transform
constexpr int kNFREQ = 481;
constexpr int kYPAD = 1024;
constexpr int kIM0 = 512;
constexpr int kNB = 22;
constexpr int kWARPS = 16;  // one window per warp
constexpr int kTHREADS = 32 * kWARPS;
constexpr int kRUN = kWARPS;          // frames of one stream per work item
constexpr int kTW = fft480::kTW;      // W480^(l k1) at k1 * 32 + l, then W960^m, m = 0..480
constexpr int kBINS = kIM0 / 32;      // bins per lane: l + 32 i, i = 0..15

// Shared memory, in floats: two span buffers (each, once its windows are in
// registers, the warps' Z), the twiddles, the window column, the band table
// transposed [22][512].
constexpr int kBUF = kRUN * kWIN;  // K5's span; K4's is (kRUN + 1) * 480
constexpr int kOFF_TW = 2 * kBUF;
constexpr int kOFF_WIN = kOFF_TW + 2 * kTW;
constexpr int kOFF_BAND = kOFF_WIN + kWIN;
constexpr int kSMEM_FLOATS = kOFF_BAND + kNB * kIM0;
constexpr size_t kSMEM_BYTES = kSMEM_FLOATS * sizeof(float);
static_assert((kRUN + 1) * kHALF <= kBUF, "K4's span fits the buffer");
static_assert(kOFF_TW % 2 == 0 && kOFF_WIN % 2 == 0, "float2 alignment");

// One stage of the band sums' reduce-scatter across the lanes.
template <int kH>
__device__ __forceinline__ void reduce_stage(float (&acc)[32], int lane) {
  const bool up = lane & kH;
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const float send = up ? acc[j] : acc[j + kH];
    const float keep = up ? acc[j + kH] : acc[j];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, kH);
  }
}

// Start copying len floats of one stream's row into buf, as one cp.async
// group: 16-byte copies for K5's aligned contiguous windows, 4-byte ones
// for K4's unaligned strided slice (each warp's copies are coalesced).
template <int kHop>
__device__ __forceinline__ void prefetch_span(const float* src, int len, float* buf) {
  if constexpr (kHop == kWIN) {
    for (int i = 4 * threadIdx.x; i < len; i += 4 * kTHREADS) cp_async(buf + i, src + i, 16);
  } else {
    for (int i = threadIdx.x; i < len; i += kTHREADS) cp_async(buf + i, src + i, 4);
  }
}

template <int kHop>
__global__ void __launch_bounds__(kTHREADS, 1)
spectrum_bands_kernel(const float* __restrict__ x, int ld_s, int S, int F,
                      const float* __restrict__ tab, const float* __restrict__ band,
                      const float2* __restrict__ tw, float* __restrict__ Y,
                      float* __restrict__ Ex) {
  extern __shared__ __align__(16) float smem[];
  float2* tw_s = reinterpret_cast<float2*>(smem + kOFF_TW);
  float* win_s = smem + kOFF_WIN;
  float* band_s = smem + kOFF_BAND;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int runs = (F + kRUN - 1) / kRUN;
  const int items = S * runs;
  // Item i is frames [kRUN r, kRUN r + nf) of stream s, i = s * runs + r.
  auto span = [&](int item, float* buf) {
    const int s = item / runs, f0 = (item - s * runs) * kRUN;
    const int nf = min(kRUN, F - f0);
    prefetch_span<kHop>(x + (size_t)s * ld_s + (size_t)f0 * kHop, (nf - 1) * kHop + kWIN, buf);
  };
  if (blockIdx.x < items) span(blockIdx.x, smem);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = t; i < kTW; i += kTHREADS) tw_s[i] = __ldg(tw + i);
  for (int i = t; i < kWIN; i += kTHREADS) win_s[i] = __ldg(tab + (size_t)i * kYPAD);
  for (int i = t; i < kIM0 * kNB; i += kTHREADS) {
    const int k = i / kNB, b = i - k * kNB;
    band_s[b * kIM0 + k] = __ldg(band + i);
  }
  __syncthreads();

  float2 dw[4];
  lane_twiddles(tw_s, lane, dw);
  const int k2 = lane_bin(lane);

  int cur = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, cur ^= 1) {
    const int s = item / runs;
    const int f0 = (item - s * runs) * kRUN;
    const int nf = min(kRUN, F - f0);
    float* buf = smem + cur * kBUF;
    __syncthreads();  // the previous item's Z, in the other buffer, is consumed
    if (item + gridDim.x < items) span(item + gridDim.x, smem + (cur ^ 1) * kBUF);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this item's span has landed
    __syncthreads();

    const bool live = warp < nf;
    float ar[15], ai[15];
    if (live) {
      const float* wv = buf + warp * kHop;
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const int n = 2 * (lane + 32 * j);
        const float2 v = *reinterpret_cast<const float2*>(wv + n);
        const float2 w = *reinterpret_cast<const float2*>(win_s + n);
        ar[j] = v.x * w.x;
        ai[j] = v.y * w.y;
      }
    }
    __syncthreads();  // every window is in registers: buf becomes the warps' Z
    if (!live) continue;

    forward(ar, ai, tw_s, dw, lane);

    float* zr = buf + warp * kWIN;
    float* zi = zr + kHALF;
#pragma unroll
    for (int q = 0; q < 15; ++q) {
      zr[q + 15 * k2] = ar[q];
      zi[q + 15 * k2] = ai[q];
    }
    __syncwarp();

    // Split into the real-input bins, store Y, sum the bands.
    const size_t m = (size_t)s * F + f0 + warp;
    float* yrow = Y + m * kYPAD;
    float acc[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) acc[b] = 0.f;
#pragma unroll 2
    for (int i = 0; i < kBINS; ++i) {
      const int k = lane + 32 * i;
      float xr = 0.f, xi = 0.f;
      if (k < kNFREQ) {
        const int ka = k == kHALF ? 0 : k;
        const int kb = k == 0 ? 0 : kHALF - k;
        const float pr = zr[ka], pi = zi[ka], qr = zr[kb], qi = -zi[kb];
        const float sr = pr + qr, si = pi + qi, dr = pr - qr, di = pi - qi;
        const float2 w = tw_s[kHALF + k];
        xr = 0.5f * __fmaf_rn(w.y, dr, __fmaf_rn(w.x, di, sr));
        xi = 0.5f * __fmaf_rn(w.y, di, __fmaf_rn(-w.x, dr, si));
      }
      yrow[k] = xr;
      yrow[kIM0 + k] = xi;
      const float e = __fmaf_rn(xi, xi, xr * xr);
#pragma unroll
      for (int b = 0; b < kNB; ++b) acc[b] = __fmaf_rn(e, band_s[b * kIM0 + k], acc[b]);
    }
    // Reduce-scatter: after the stage of width h, acc[j] (j < h) holds band
    // j + (the lane's bits above h); at the end lane l holds band l.
    reduce_stage<16>(acc, lane);
    reduce_stage<8>(acc, lane);
    reduce_stage<4>(acc, lane);
    reduce_stage<2>(acc, lane);
    reduce_stage<1>(acc, lane);
    if (lane < kNB) Ex[m * kNB + lane] = acc[0];
  }
}

template <int kHop>
cudaError_t launch(const float* x, int ld_s, int S, int F, const float* tab, const float* band,
                   const float* tw, float* Y, float* Ex, int device, cudaStream_t stream) {
  auto kernel = spectrum_bands_kernel<kHop>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSMEM_BYTES));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = S * ((F + kRUN - 1) / kRUN);
  const int grid = items < sms ? items : sms;  // persistent: one block per SM
  kernel<<<grid, kTHREADS, kSMEM_BYTES, stream>>>(x, ld_s, S, F, tab, band,
                                                  reinterpret_cast<const float2*>(tw), Y, Ex);
  return cudaGetLastError();
}

}  // namespace

// Window f of stream s is x[s * ld_s + f * hop .. + 960] (floats): hop 480
// for K4's overlapped windows read in place, 960 for K5's contiguous windows
// (then x must be 16-byte aligned and ld_s = F * 960). tab is the DFT table
// [960, 1024] (only its column 0 is read), band [512, 22], tw the twiddles
// [961] of float2; Y [S * F, 1024] and Ex [S * F, 22] contiguous.
extern "C" int crispy_spectrum_bands(const float* x, int ld_s, int hop, int S, int F,
                                     const float* tab, const float* band, const float* tw,
                                     float* Y, float* Ex, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hop == kHALF) err = launch<kHALF>(x, ld_s, S, F, tab, band, tw, Y, Ex, device, st);
  else if (hop == kWIN) err = launch<kWIN>(x, ld_s, S, F, tab, band, tw, Y, Ex, device, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
