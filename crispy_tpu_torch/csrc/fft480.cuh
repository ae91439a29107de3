// The 480-point complex FFT that the spectra kernels (K4 and K5 in
// spectrum_fwd.cu, K6 in spectrum_inv.cu) run on one warp, and the cp.async
// copy they (and K2 in rd_scan.cu) stage their inputs with.
//
// 480 = 15 x 32: lane l holds the inputs l + 32 j, j = 0..14, in registers;
// a 15-point DFT over j in each lane (prime factor 3 x 5, no inner
// twiddles), the twiddles W480^(l k1), then fifteen 32-point DFTs across
// the lanes, five radix-2 decimation-in-frequency stages of __shfl_xor_sync.
// Lane l ends with the bins k1 + 15 brev5(l), k1 = 0..14. The transform is
// forward (W_N = e^(-2 pi i / N)) and unnormalised; K6 takes its inverse as
// conj(FFT(conj z)).
//
// The twiddles are frontend_kernels.fft_twiddles(), staged in shared memory:
// W480^(l k1) at k1 * 32 + l, then W960^m at kTW_W960 + m, m = 0..480. The
// 3- and 5-point constants are f32 roundings of the same float64 values.
// The library is built with --fmad=false: every multiply-add meant to be
// fused is written as __fmaf_rn.

#pragma once

#include <cuda_runtime.h>

namespace fft480 {

constexpr int kTW_W960 = 480;          // row of W960^0 in the twiddle table
constexpr int kTW = kTW_W960 + 481;    // rows of the twiddle table

// cos and sin of 2 pi / 5, 4 pi / 5 and 2 pi / 3.
constexpr float kC51 = 0.30901699437494745f, kS51 = 0.9510565162951535f;
constexpr float kC52 = -0.8090169943749475f, kS52 = 0.5877852522924731f;
constexpr float kS3 = 0.8660254037844386f;

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = __fmaf_rn(re, w.x, -(im * w.y));
  im = __fmaf_rn(re, w.y, im * w.x);
  re = r;
}

// Forward 5-point DFT in place.
__device__ __forceinline__ void dft5(float (&r)[5], float (&i)[5]) {
  const float t1r = r[1] + r[4], t1i = i[1] + i[4];
  const float t2r = r[2] + r[3], t2i = i[2] + i[3];
  const float t3r = r[1] - r[4], t3i = i[1] - i[4];
  const float t4r = r[2] - r[3], t4i = i[2] - i[3];
  const float b1r = __fmaf_rn(kC52, t2r, __fmaf_rn(kC51, t1r, r[0]));
  const float b1i = __fmaf_rn(kC52, t2i, __fmaf_rn(kC51, t1i, i[0]));
  const float b2r = __fmaf_rn(kC51, t2r, __fmaf_rn(kC52, t1r, r[0]));
  const float b2i = __fmaf_rn(kC51, t2i, __fmaf_rn(kC52, t1i, i[0]));
  const float d1r = __fmaf_rn(kS52, t4r, kS51 * t3r), d1i = __fmaf_rn(kS52, t4i, kS51 * t3i);
  const float d2r = __fmaf_rn(-kS51, t4r, kS52 * t3r), d2i = __fmaf_rn(-kS51, t4i, kS52 * t3i);
  r[0] = r[0] + t1r + t2r;
  i[0] = i[0] + t1i + t2i;
  r[1] = b1r + d1i; i[1] = b1i - d1r;
  r[4] = b1r - d1i; i[4] = b1i + d1r;
  r[2] = b2r + d2i; i[2] = b2i - d2r;
  r[3] = b2r - d2i; i[3] = b2i + d2r;
}

// Forward 3-point DFT in place.
__device__ __forceinline__ void dft3(float (&r)[3], float (&i)[3]) {
  const float tr = r[1] + r[2], ti = i[1] + i[2];
  const float br = __fmaf_rn(-0.5f, tr, r[0]), bi = __fmaf_rn(-0.5f, ti, i[0]);
  const float dr = kS3 * (r[1] - r[2]), di = kS3 * (i[1] - i[2]);
  r[0] = r[0] + tr; i[0] = i[0] + ti;
  r[1] = br + di; i[1] = bi - dr;
  r[2] = br - di; i[2] = bi + dr;
}

// This lane's twiddles of the cross-lane stages h = 16, 8, 4, 2: the upper
// lane of a pair multiplies by W_(2h)^(l mod h) = W960^((l mod h) 480 / h).
__device__ __forceinline__ void lane_twiddles(const float2* tw_s, int lane, float2 (&dw)[4]) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const int h = 16 >> st;
    dw[st] = (lane & h) ? tw_s[kTW_W960 + (lane & (h - 1)) * (480 / h)] : make_float2(1.f, 0.f);
  }
}

// The 32-point bin this lane ends with: its outputs are bins q + 15 bin(l).
__device__ __forceinline__ int lane_bin(int lane) { return __brev(lane) >> 27; }

// Forward 480-point FFT of the warp's z[l + 32 j] = (ar[j], ai[j]) in place;
// afterwards (ar[q], ai[q]) is Z[q + 15 lane_bin(lane)].
__device__ __forceinline__ void forward(float (&ar)[15], float (&ai)[15], const float2* tw_s,
                                        const float2 (&dw)[4], int lane) {
  // 15-point DFT over j: n = (5 n1 + 3 n2) mod 15, k = (10 k1 + 6 k2) mod 15.
  {
    float br[3][5], bi[3][5];
#pragma unroll
    for (int n1 = 0; n1 < 3; ++n1) {
#pragma unroll
      for (int n2 = 0; n2 < 5; ++n2) {
        br[n1][n2] = ar[(5 * n1 + 3 * n2) % 15];
        bi[n1][n2] = ai[(5 * n1 + 3 * n2) % 15];
      }
      dft5(br[n1], bi[n1]);
    }
#pragma unroll
    for (int q2 = 0; q2 < 5; ++q2) {
      float cr[3] = {br[0][q2], br[1][q2], br[2][q2]};
      float ci[3] = {bi[0][q2], bi[1][q2], bi[2][q2]};
      dft3(cr, ci);
#pragma unroll
      for (int q1 = 0; q1 < 3; ++q1) {
        ar[(10 * q1 + 6 * q2) % 15] = cr[q1];
        ai[(10 * q1 + 6 * q2) % 15] = ci[q1];
      }
    }
  }
#pragma unroll
  for (int q = 1; q < 15; ++q) cmul(ar[q], ai[q], tw_s[q * 32 + lane]);

  // 32-point DFTs across the lanes, decimation in frequency.
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int h = 16 >> st;
    const float sg = (lane & h) ? -1.f : 1.f;
#pragma unroll
    for (int q = 0; q < 15; ++q) {
      const float pr = __shfl_xor_sync(0xffffffffu, ar[q], h);
      const float pi = __shfl_xor_sync(0xffffffffu, ai[q], h);
      ar[q] = __fmaf_rn(sg, ar[q], pr);
      ai[q] = __fmaf_rn(sg, ai[q], pi);
      if (st < 4) cmul(ar[q], ai[q], dw[st]);
    }
  }
}

// An asynchronous copy of 16 bytes (both addresses 16-byte aligned) or 4
// bytes from device memory into shared memory; wait with cp.async.wait_group.
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

}  // namespace fft480
