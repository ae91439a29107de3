// K2: the remove_doubling continuation scan, one thread per stream.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_rnn.py::rd_scan_pallas (body
// `_rd_kernel`). Per frame, the 14 subharmonic candidates are accepted against
// thresholds that depend on the previous frame's (period, gain); the last
// winner is picked and its output period and pitch gain carry to the next
// frame. Its plain PyTorch version is rnn_kernels.rd_scan_reference.
//
// What bounds it on the H100: bytes. The packed [S, F, 74] f32 rows are read
// once and one f32 pitch per frame is written (S=128, F=500: 18.9 MB in,
// 0.26 MB out, ~6 us at 3.35 TB/s). The arithmetic is a few hundred flops a
// frame. But each stream is a chain of F dependent frames, so in this first
// version the loop's latency is the real limit.
//
// Design: the TPU's sequential frame grid becomes a loop over frames in one
// thread per stream, with the (period, gain) carry in registers. The result
// decides pitch indices, so it must equal the plain version bit for bit: the
// library is built with --fmad=false, so `0.7f * g0 - cont` and
// `5 * k * k < T0` are not contracted into FMAs and round exactly as the
// separate PyTorch ops do. floor(prev_T * 0.5), the strict `g1 > thresh` and
// the last winner mirror the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kW = 74;  // packed row: T1[14] g1[14] valid[14] g0 T0 Tout[15] pg[15]
constexpr int kTHREADS = 32;

// max(c, x) that propagates a NaN x, as torch.maximum does.
__device__ __forceinline__ float max_nan(float c, float x) {
  return x != x ? x : fmaxf(c, x);
}

__global__ void __launch_bounds__(kTHREADS)
rd_scan_kernel(const float* __restrict__ packed, const float* __restrict__ lp_in,
               const float* __restrict__ lg_in, float* __restrict__ pitch,
               float* __restrict__ lp_out, float* __restrict__ lg_out, int S, int F) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float prev_T = lp_in[s];
  float prev_g = lg_in[s];
  const float* row = packed + (size_t)s * F * kW;
  for (int f = 0; f < F; ++f, row += kW) {
    const float pph = floorf(prev_T * 0.5f);
    const float g0 = row[42];
    const float T0 = row[43];
    int kidx = -1;
    for (int k = 0; k < 14; ++k) {
      const float T1 = row[k];
      const float dT = fabsf(T1 - pph);
      const float ksf = static_cast<float>(2 + k);
      float cont = 0.f;
      if (dT <= 1.f) {
        cont = prev_g;
      } else if (dT <= 2.f && 5.f * ksf * ksf < T0) {
        cont = 0.5f * prev_g;
      }
      float thresh;
      if (T1 < 90.f) {
        thresh = max_nan(0.4f, 0.85f * g0 - cont);
      } else if (T1 < 60.f) {  // unreachable, as in the reference's nested where
        thresh = max_nan(0.5f, 0.9f * g0 - cont);
      } else {
        thresh = max_nan(0.3f, 0.7f * g0 - cont);
      }
      if (row[28 + k] > 0.5f && row[14 + k] > thresh) kidx = k;  // last winner
    }
    prev_T = row[44 + kidx + 1];
    prev_g = row[59 + kidx + 1];
    pitch[(size_t)s * F + f] = prev_T;
  }
  lp_out[s] = prev_T;
  lg_out[s] = prev_g;
}

}  // namespace

extern "C" int crispy_rd_scan(const float* packed, const float* lp_in, const float* lg_in,
                              float* pitch, float* lp_out, float* lg_out, int S, int F,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kTHREADS - 1) / kTHREADS;
  rd_scan_kernel<<<blocks, kTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, lp_in, lg_in, pitch, lp_out, lg_out, S, F);
  return static_cast<int>(cudaGetLastError());
}
