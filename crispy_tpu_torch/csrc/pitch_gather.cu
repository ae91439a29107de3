// K3: the pitch-delayed window gather, one thread block per (frame, stream).
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_ops.py::pitch_window_gather (body
// `_gather_kernel`): out[s, f, :] = ext[s, start : start + 960] with
// lax.dynamic_slice's start semantics: a negative starts[s, f] counts from the
// end (+ L), then the start is clamped to [0, L - 960].
// Its plain PyTorch version is ops_kernels.pitch_window_gather_reference.
//
// What bounds it on the H100: bytes. 960 floats are written per window and
// the windows overlap, so the reads are at most the whole of ext (S=128,
// F=500: 123.5 MB in, 245.8 MB out, ~0.11 ms at 3.35 TB/s).
//
// Design: the TPU version's aligned 16x128 DMA plus sublane and lane rotates
// only work around Mosaic's alignment rules. Here each block copies one
// window with 320 threads, three floats each; neighbouring threads touch
// neighbouring addresses, so the unaligned read and the aligned write are
// both coalesced. The copy is exact. Vectorised loads are a later concern.

#include <cuda_runtime.h>

namespace {

constexpr int kWIN = 960;
constexpr int kTHREADS = 320;

__global__ void __launch_bounds__(kTHREADS)
pitch_gather_kernel(const float* __restrict__ ext, const int* __restrict__ starts,
                    float* __restrict__ out, int L, int F) {
  const int f = blockIdx.x;
  const int s = blockIdx.y;
  const size_t sf = (size_t)s * F + f;
  int st = starts[sf];
  if (st < 0) st += L;
  st = st < 0 ? 0 : (st > L - kWIN ? L - kWIN : st);
  const float* src = ext + (size_t)s * L + st;
  float* dst = out + sf * kWIN;
  for (int j = threadIdx.x; j < kWIN; j += kTHREADS) dst[j] = src[j];
}

}  // namespace

extern "C" int crispy_pitch_gather(const float* ext, const int* starts, float* out, int S,
                                   int L, int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(F, S);
  pitch_gather_kernel<<<grid, kTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ext, starts, out, L, F);
  return static_cast<int>(cudaGetLastError());
}
