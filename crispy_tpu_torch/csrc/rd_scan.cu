// K2: the remove_doubling continuation scan, one warp per stream.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_rnn.py::rd_scan_pallas (body
// `_rd_kernel`). Per frame, the 14 subharmonic candidates are accepted against
// thresholds that depend on the previous frame's (period, gain); the last
// winner is picked and its output period and pitch gain carry to the next
// frame. Its plain PyTorch version is rnn_kernels.rd_scan_reference.
//
// What bounds it on the H100: the frame chain, not bytes. The packed
// [S, F, 74] f32 rows are read once and one f32 pitch per frame is written
// (S=128, F=500: 18.9 MB in, 0.26 MB out, ~6 us at 3.35 TB/s), but each stream
// is a chain of F frames, each needing the previous frame's (period, gain).
// The least it can take is F times the chain's dependent latency per frame.
// A loop with one thread per stream pays a round trip to device memory per
// frame on top: the reads of the winner's Tout and pg wait for the frame's
// candidates to be decided, and neighbouring streams' rows lie F x 296 B
// apart, so each warp-wide load touches 32 sectors.
//
// Design:
// - One warp per stream, four streams per block: one warp for each of the
//   SM's four schedulers, so no chain waits for another's slot. Lane k holds
//   candidate k (k < 14) and output slot k (k < 15: Tout[k], pg[k]; slot 0
//   keeps T0). The ragged edge of S exits whole warps.
// - Rows staged ahead: each warp copies its stream's rows into shared memory
//   in chunks of 32 frames (9.25 KB) with cp.async, the next chunk in flight
//   while this one is scanned (two buffers a warp, 74 KB a block), so the
//   chain waits on device memory only for the first chunk. A stream's rows
//   are contiguous, but 296 B is not a multiple of 16: a chunk starts 16-byte
//   aligned only when s x F is even. The copy takes any 4-byte aligned start
//   itself: the floats before the first 16-byte boundary and after the last
//   by 4-byte copies, the rest by 16-byte copies, with the chunk shifted in
//   shared memory by as many floats that both sides of every 16-byte copy
//   are aligned (the same shift for every chunk of a stream: 32 rows are
//   2,368 floats). Lanes read consecutive words of a row: no bank conflicts.
// - Off the chain, one frame ahead, each lane loads its words of the row
//   and forms what does not depend on the carry: a = 0.85 g0 or 0.7 g0 and
//   lo = 0.4 or 0.3 (T1 < 90 or not), the flag 5 (k+2)^2 < T0, gl = valid &&
//   g1 > lo, and c0 = gl && g1 > a, the choice when there is no continuation.
// - The chain per frame, from the carry (prev_T, prev_g) held in every lane:
//     pph = floorf(prev_T * 0.5f); d = |T1 - pph|          FMUL, FRND, FADD
//     c1 = gl && g1 > a - prev_g                           (beside it)
//     c2 = gl && g1 > a - 0.5f * prev_g                    (beside it)
//     win = d <= 1 ? c1 : (d <= 2 && flag) ? c2 : c0       FSETP, select
//     src = 32 - __clz(__ballot_sync(win))                 ballot, FLO, IADD
//     prev_T, prev_g = __shfl_sync(Tout / pg, src)         two shuffles
//   src is the last winner's slot kidx + 1, or 0 when no lane won.
//   Design floor, a count and not a measurement: 7 ALU operations at ~4
//   clocks, one ballot and one shuffle at ~25 clocks (the second shuffle
//   starts right behind the first), ~78 clocks a frame; chip_smoke.py
//   prints it for F frames at the SM clock.
// - Pitches: lane j keeps frame j of the chunk in a register, and the warp
//   writes the chunk's pitches in one coalesced store (no shared-memory
//   buffer needed: a chunk is 32 frames).
//
// Bit-exactness: the result decides pitch indices, so it equals the plain
// version bit for bit. The library is built with --fmad=false, so no product
// is contracted into an add, and this kernel fuses none. 0.85f * g0 is rounded
// before the subtraction, as the plain version rounds it, so forming it a
// frame ahead is exact. The plain version's g1 > max(lo, a - cont)
// (torch.clamp_min, which keeps a NaN) is evaluated as (g1 > lo) &&
// (g1 > a - cont): equal for every input, NaN included, since a NaN a - cont
// fails both forms. cont = 0 gives a - 0 = a exactly, so c0 is the plain
// version's choice on that branch. A NaN carry makes d NaN, neither
// continuation test holds and c0 is taken, as in the plain version's nested
// where; the plain version's T1 < 60 branch is unreachable and left out.

#include <cuda_runtime.h>

#include "device_guard.cuh"
#include <math.h>
#include <stdint.h>

#include "fft480.cuh"  // for its cp.async copy

namespace {

using fft480::cp_async;

constexpr int kW = 74;  // packed row: T1[14] g1[14] valid[14] g0 T0 Tout[15] pg[15]
constexpr int kCAND = 14;
constexpr int kFC = 32;      // frames per staged chunk: one pitch per lane
constexpr int kWARPS = 4;    // streams per block
constexpr int kBUF = kFC * kW + 4;  // floats per chunk buffer, room for the shift
constexpr size_t kSMEM_BYTES = sizeof(float) * 2 * kBUF * kWARPS;  // 75,904
constexpr unsigned kALL = 0xffffffffu;

static_assert(kFC == 32, "a chunk's pitches are one per lane");
static_assert((kFC * kW) % 4 == 0, "every chunk of a stream has the same 16-byte phase");
static_assert(kBUF % 4 == 0, "each buffer starts 16-byte aligned");

// Copy n >= 74 floats (whole rows) from src to dst as one cp.async group of
// the warp, where src + head and dst + head are 16-byte aligned (head < 4).
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int head, int lane) {
  if (lane < head) cp_async(dst + lane, src + lane, 4);
  const int quads = (n - head) >> 2;
  for (int i = lane; i < quads; i += 32) cp_async(dst + head + 4 * i, src + head + 4 * i, 16);
  const int t = head + 4 * quads + lane;
  if (lane < 4 && t < n) cp_async(dst + t, src + t, 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One frame's words for lane k, and what follows from them without the carry.
struct Lane {
  float T1, g1, a, Tout, pg;
  bool gl, c0, flag;
};

__device__ __forceinline__ Lane load_lane(const float* row, int k, float c5) {
  const int kk = min(k, kCAND);  // lanes past slot 14 read its words and never win
  Lane L;
  L.T1 = row[kk];
  L.g1 = row[kCAND + kk];
  const float valid = row[2 * kCAND + kk];
  const float g0 = row[42];
  L.Tout = row[44 + kk];
  L.pg = row[59 + kk];
  const bool lt90 = L.T1 < 90.f;
  L.a = lt90 ? 0.85f * g0 : 0.7f * g0;
  const float lo = lt90 ? 0.4f : 0.3f;
  L.gl = k < kCAND && valid > 0.5f && L.g1 > lo;
  L.c0 = L.gl && L.g1 > L.a;
  L.flag = c5 < row[43];  // 5 (k+2)^2 < T0
  return L;
}

__global__ void __launch_bounds__(32 * kWARPS)
rd_scan_kernel(const float* __restrict__ packed, const float* __restrict__ lp_in,
               const float* __restrict__ lg_in, float* __restrict__ pitch,
               float* __restrict__ lp_out, float* __restrict__ lg_out, int S, int F) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWARPS + warp;
  if (s >= S) return;  // whole warps: nothing below synchronises the block
  float* bufs = smem + warp * 2 * kBUF;
  const float* rows = packed + (size_t)s * F * kW;
  // floats from the stream's first row to the next 16-byte boundary
  const int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(rows) & 15u)) & 15u) >> 2);
  const int shift = (4 - head) & 3;  // bufs + shift + head is 16-byte aligned
  const int chunks = (F + kFC - 1) / kFC;
  const float ksf = static_cast<float>(2 + lane);
  const float c5 = 5.f * ksf * ksf;
  float prev_T = lp_in[s];
  float prev_g = lg_in[s];
  if (chunks > 0) stage(bufs + shift, rows, min(F, kFC) * kW, head, lane);
  for (int c = 0; c < chunks; ++c) {
    const int f0 = c * kFC;
    const int n = min(F - f0, kFC);
    const float* buf = bufs + (c & 1) * kBUF + shift;
    __syncwarp();  // every lane's reads of the other buffer (chunk c - 1) are done
    if (c + 1 < chunks) {
      stage(bufs + ((c + 1) & 1) * kBUF + shift, rows + (size_t)(f0 + kFC) * kW,
            min(F - f0 - kFC, kFC) * kW, head, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();  // chunk c, copied by all lanes, is visible to each
    Lane L = load_lane(buf, lane, c5);
    float out = 0.f;
    for (int j = 0; j < n; ++j) {
      const Lane next = load_lane(buf + min(j + 1, n - 1) * kW, lane, c5);
      const float pph = floorf(prev_T * 0.5f);
      const float d = fabsf(L.T1 - pph);
      const bool c1 = L.gl && L.g1 > L.a - prev_g;
      const bool c2 = L.gl && L.g1 > L.a - 0.5f * prev_g;
      const bool win = d <= 1.f ? c1 : (d <= 2.f && L.flag) ? c2 : L.c0;
      const int src = 32 - __clz(__ballot_sync(kALL, win));
      prev_T = __shfl_sync(kALL, L.Tout, src);
      prev_g = __shfl_sync(kALL, L.pg, src);
      if (lane == j) out = prev_T;
      L = next;
    }
    if (lane < n) pitch[(size_t)s * F + f0 + lane] = out;
  }
  if (lane == 0) {
    lp_out[s] = prev_T;
    lg_out[s] = prev_g;
  }
}

}  // namespace

extern "C" int crispy_rd_scan(const float* packed, const float* lp_in, const float* lg_in,
                              float* pitch, float* lp_out, float* lg_out, int S, int F,
                              int device, void* stream) {
  const ScopedDevice guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kWARPS - 1) / kWARPS;
  rd_scan_kernel<<<blocks, 32 * kWARPS, kSMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      packed, lp_in, lg_in, pitch, lp_out, lg_out, S, F);
  return static_cast<int>(cudaGetLastError());
}
