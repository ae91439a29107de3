// K6: the inverse windowed DFT of each frame's spectrum with the synthesis
// window, the overlap-add and the carried tail fused, as an inverse real FFT
// in registers and shared memory.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_frontend.py::inv_spectrum_ola (body
// `_inv_kernel`): for spectra Y [S, F, 1024] in the padded layout (re of
// frequency k at column k, im at 512 + k),
//   out[s, f]  = Y[s, f] @ invA + (Y[s, f - 1] @ invB, or syn_mem[s] at f = 0)
//   new_mem[s] = Y[s, F - 1] @ invB
// with invA, invB [1024, 480] the two halves of the windowed inverse table.
// Its plain PyTorch version is frontend_kernels.inv_spectrum_ola_reference
// (the dense product).
//
// The table is make_params' inverse: rows k and 512 + k hold
// f32(c_k cos(2 pi n k / 960) w[n]) and f32(-c_k sin(..) w[n]), c_0 = c_480
// = 1, else 2. Its row 0 is exactly the window w (cos 0 = 1), the rows of
// Im X_0 and the pad rows are zero and the row of Im X_480 is ~1e-13, so
// with X_f[k] = Y[s, f, k] + i Y[s, f, 512 + k] (Im X_0 and Im X_480 taken
// as 0) the frame is x_f = 960 irfft(X_f) w. The kernel reads the window
// from row 0 of invA and invB and takes the inverse DFT itself; it never
// reads Y's pad columns. A table that is not of that form gives a wrong
// result: the wrapper's docstring says so, and a CPU test checks the rows.
//
// What bounds it on the H100: bytes. At S=128, F=500 the function moves
// ~0.39 GB (Y read, out written), ~0.12 ms at 3.35 TB/s; the inverse FFT
// needs ~25,000 FLOP per frame (~1.6 GFLOP, ~0.02 ms of f32). No tensor
// cores: they would not help an FFT of this size, which the bytes bound.
//
// Design:
// - Real inverse as one complex 480-point FFT: the 481 bins merge into
//   Z'[k] = (X[k] + X*[480-k]) + i W960^-k (X[k] - X*[480-k]), k = 0..479,
//   whose unnormalised inverse DFT is z[m] = x[2m] + i x[2m+1] (the 1/2 of
//   the merge and the 960 of the table cancel). The inverse is taken as
//   conj(FFT(conj Z')) with fft480.cuh's forward transform, K4's: one warp
//   per frame, lane l builds Z'[l + 32 j] from Y[k] and Y[480 - k] and ends
//   with z[q + 15 brev5(l)].
// - Overlap-add without atomics: one persistent block of 16 warps per SM
//   takes runs of 15 consecutive output frames f0.. of one stream. Warp w
//   transforms frame f0 - 1 + w into its row of shared memory (in natural
//   order, through the row its spectrum came in); after __syncthreads,
//   output frame f is w[:480] x_f[:480] + w[480:] x_(f-1)[480:], or syn_mem
//   at f = 0, stored as coalesced float4 rows of the contiguous run. Frame
//   f0 - 1 is transformed once more by warp 0 (1/15 extra work and Y
//   reads) so that no block waits on another; every output has one writer,
//   and a repeat launch gives the same bits. The run holding frame F - 1
//   writes new_mem. Any F >= 1 works.
// - Memory: the block stages the twiddles and the window once (11.5 KB),
//   then copies each run's rows of Y (columns 0..480 and 512..991, never
//   the pads) into shared memory with cp.async, 16-byte copies, the next
//   run's rows in flight while this run is computed (two 64 KB buffers).
// - Shared-memory traffic per frame, by count: ~60 wavefronts to build Z',
//   ~60 for the transposing store (2-way bank conflicts), ~60 for the
//   output; far below K4's ~570 (it sums bands). No intermediate goes to
//   device memory.
// - The library is built with --fmad=false; every multiply-add meant to be
//   fused is written as __fmaf_rn.

#include <cuda_runtime.h>

#include "fft480.cuh"

namespace {

using fft480::cp_async;

constexpr int kWIN = 960;
constexpr int kFRAME = 480;  // also the points of the packed complex transform
constexpr int kYPAD = 1024;
constexpr int kIM0 = 512;
constexpr int kWARPS = 16;
constexpr int kTHREADS = 32 * kWARPS;
constexpr int kRUN = kWARPS - 1;  // output frames per work item; warp 0 takes the frame before
constexpr int kQUADS = kFRAME / 4;  // float4 per half frame
constexpr int kCOPIES = 2 * kQUADS + 1;  // per row: re 0..479 and im 512..991 by 16 bytes, re 480

// Shared memory, in floats: two buffers of 16 rows (each row a frame's
// spectrum, then its 960 samples), the twiddles, the window.
constexpr int kBUF = kWARPS * kYPAD;
constexpr int kOFF_TW = 2 * kBUF;
constexpr int kOFF_WIN = kOFF_TW + 2 * fft480::kTW + 2;  // 16-byte aligned
constexpr int kSMEM_FLOATS = kOFF_WIN + kWIN;
constexpr size_t kSMEM_BYTES = kSMEM_FLOATS * sizeof(float);
static_assert(kOFF_TW % 4 == 0 && kOFF_WIN % 4 == 0, "float4 alignment");

__global__ void __launch_bounds__(kTHREADS, 1)
inv_ola_kernel(const float* __restrict__ Y, const float* __restrict__ inva,
               const float* __restrict__ invb, const float2* __restrict__ tw,
               const float* __restrict__ mem, float* __restrict__ out,
               float* __restrict__ new_mem, int S, int F) {
  extern __shared__ __align__(16) float smem[];
  float2* tw_s = reinterpret_cast<float2*>(smem + kOFF_TW);
  float* win_s = smem + kOFF_WIN;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int runs = (F + kRUN - 1) / kRUN;
  const int items = S * runs;
  // Item i = s * runs + r is output frames [f0, f0 + nf) of stream s,
  // f0 = kRUN r; row w of its buffer holds frame f0 - 1 + w (none at f0 = 0).
  auto span = [&](int item, float* buf) {
    const int s = item / runs, f0 = (item - s * runs) * kRUN;
    const int w0 = f0 == 0 ? 1 : 0;
    const int rows = min(kRUN, F - f0) + 1 - w0;
    const float* src = Y + ((size_t)s * F + f0 - 1 + w0) * kYPAD;
    float* dst = buf + w0 * kYPAD;
    for (int i = t; i < rows * kCOPIES; i += kTHREADS) {
      const int r = i / kCOPIES, c = i - r * kCOPIES;
      const int col = c < kQUADS ? 4 * c : c < 2 * kQUADS ? kIM0 + 4 * (c - kQUADS) : kFRAME;
      cp_async(dst + r * kYPAD + col, src + (size_t)r * kYPAD + col, c < 2 * kQUADS ? 16 : 4);
    }
  };
  if (blockIdx.x < items) span(blockIdx.x, smem);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = t; i < fft480::kTW; i += kTHREADS) tw_s[i] = __ldg(tw + i);
  for (int i = t; i < kWIN; i += kTHREADS)
    win_s[i] = i < kFRAME ? __ldg(inva + i) : __ldg(invb + i - kFRAME);  // row 0 of each
  __syncthreads();

  float2 dw[4];
  fft480::lane_twiddles(tw_s, lane, dw);
  const int k2 = fft480::lane_bin(lane);

  int cur = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, cur ^= 1) {
    const int s = item / runs;
    const int f0 = (item - s * runs) * kRUN;
    const int nf = min(kRUN, F - f0);
    float* buf = smem + cur * kBUF;
    __syncthreads();  // the previous item's output, in the other buffer, is consumed
    if (item + gridDim.x < items) span(item + gridDim.x, smem + (cur ^ 1) * kBUF);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this item's rows have landed
    __syncthreads();

    if (warp <= nf && (warp > 0 || f0 > 0)) {
      float* row = buf + warp * kYPAD;
      float ar[15], ai[15];
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const int k = lane + 32 * j, kc = kFRAME - k;
        const float xr = row[k], xi = k ? row[kIM0 + k] : 0.f;     // X[k], Im X_0 = 0
        const float yr = row[kc], yi = k ? row[kIM0 + kc] : 0.f;   // X[480 - k], Im X_480 = 0
        const float sr = xr + yr, si = xi - yi;  // X[k] + X*[480 - k]
        const float dr = xr - yr, di = xi + yi;  // X[k] - X*[480 - k]
        const float2 w = tw_s[fft480::kTW_W960 + k];  // W960^k; i W960^-k d below
        ar[j] = __fmaf_rn(w.y, dr, __fmaf_rn(-w.x, di, sr));    // Re Z'
        ai[j] = -__fmaf_rn(w.y, di, __fmaf_rn(w.x, dr, si));    // -Im Z': conj on the way in
      }
      fft480::forward(ar, ai, tw_s, dw, lane);
      __syncwarp();  // every lane has read the row's spectrum
      // conj on the way out: x[2m] = Re, x[2m + 1] = -Im, m = q + 15 k2
#pragma unroll
      for (int q = 0; q < 15; ++q)
        *reinterpret_cast<float2*>(row + 2 * (q + 15 * k2)) = make_float2(ar[q], -ai[q]);
    }
    __syncthreads();

    // Output frames f0 .. f0 + nf - 1 are one contiguous stretch of out.
    float4* dst = reinterpret_cast<float4*>(out + ((size_t)s * F + f0) * kFRAME);
    const float4* wh = reinterpret_cast<const float4*>(win_s);
    const float4* wt = reinterpret_cast<const float4*>(win_s + kFRAME);
    for (int i = t; i < nf * kQUADS; i += kTHREADS) {
      const int w = 1 + i / kQUADS, n4 = i - (w - 1) * kQUADS;
      const float4 h = reinterpret_cast<const float4*>(buf + w * kYPAD)[n4];
      const float4 a = wh[n4];
      float4 tl;
      if (w == 1 && f0 == 0) {
        const float* m = mem + (size_t)s * kFRAME + 4 * n4;
        tl = make_float4(__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3));
      } else {
        const float4 p = reinterpret_cast<const float4*>(buf + (w - 1) * kYPAD + kFRAME)[n4];
        const float4 b = wt[n4];
        tl = make_float4(p.x * b.x, p.y * b.y, p.z * b.z, p.w * b.w);
      }
      dst[i] = make_float4(__fmaf_rn(h.x, a.x, tl.x), __fmaf_rn(h.y, a.y, tl.y),
                           __fmaf_rn(h.z, a.z, tl.z), __fmaf_rn(h.w, a.w, tl.w));
    }
    if (f0 + nf == F) {
      const float4* p = reinterpret_cast<const float4*>(buf + nf * kYPAD + kFRAME);
      float4* m = reinterpret_cast<float4*>(new_mem + (size_t)s * kFRAME);
      for (int i = t; i < kQUADS; i += kTHREADS) {
        const float4 v = p[i], b = wt[i];
        m[i] = make_float4(v.x * b.x, v.y * b.y, v.z * b.z, v.w * b.w);
      }
    }
  }
}

}  // namespace

// Y [S * F, 1024] (16-byte aligned), inva and invb [1024, 480] (only row 0
// of each is read), tw the twiddles [961] of float2, mem [S, 480], all
// contiguous; writes out [S * F, 480] and new_mem [S, 480] (16-byte aligned).
extern "C" int crispy_inv_spectrum_ola(const float* Y, const float* inva, const float* invb,
                                       const float* tw, const float* mem, float* out,
                                       float* new_mem, int S, int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(inv_ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = S * ((F + kRUN - 1) / kRUN);
  const int grid = items < sms ? items : sms;  // persistent: one block per SM
  inv_ola_kernel<<<grid, kTHREADS, kSMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      Y, inva, invb, reinterpret_cast<const float2*>(tw), mem, out, new_mem, S, F);
  return static_cast<int>(cudaGetLastError());
}
