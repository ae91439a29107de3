// K1: the whole RNNoise network over F frames, one thread block per stream.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_rnn.py::nn_scan_pallas (body
// `_kernel`): input dense 42->24 (tansig), VAD GRU 24, noise GRU 48, denoise
// GRU 96 (ReLU candidates), the 22-band gain head and the VAD head. Gains are
// smoothed as max(graw, ALPHA_LASTG * lastg); a silent frame freezes every
// state. Its plain PyTorch version is rnn_kernels.nn_scan_reference.
//
// What bounds it on the H100: operations. ~86,952 multiply-adds per
// stream-frame, 2 x 86,952 x S x F FLOP in f32 (S=128, F=500: ~11.1 GFLOP,
// ~0.17 ms at 67 TFLOP/s), against only ~22 MB of input and output. But the
// frames of one stream form a recurrence, so in this first version the real
// limit is latency: each frame is a chain of 12 dependent phases.
//
// Design: the TPU's sequential frame grid axis becomes a loop over frames
// inside one block per stream; the 190-float state (vad | noise | denoise |
// lastg) and every intermediate live in shared memory, and threads map to
// output units of each layer with a __syncthreads() between layers. The
// ~350 KB of f32 weights are read from global memory: they stay resident in
// the 50 MB L2, and adjacent threads read adjacent columns of the row-major
// [in, out] matrices, so each weight row is one coalesced load. All sums
// accumulate in f32 (the Pallas kernel's dots run at HIGHEST precision).
// tansig reads the same 201-entry table as the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNB = 22;
constexpr int kNIN = 42;
constexpr int kDENSE = 24;
constexpr int kVAD = 24;
constexpr int kNOI = 48;
constexpr int kDEN = 96;
constexpr int kSTATE = kVAD + kNOI + kDEN + kNB;  // 190
constexpr int kTHREADS = 256;
constexpr float kALPHA_LASTG = 0.6f;

struct Weights {
  const float *w_id, *b_id;
  const float *w_vg, *u_vg, *b_vg;
  const float *w_ng, *u_ng, *b_ng;
  const float *w_dg, *u_dg, *b_dg;
  const float *w_do, *b_do;
  const float *w_vo, *b_vo;
  const float *table;
};

// A layer input made of up to three concatenated shared-memory segments.
struct Input {
  const float *a, *b, *c;
  int na, nb, nc;
};

__device__ __forceinline__ float tansig(const float* table, float x) {
  if (x != x) return 0.f;
  if (x >= 8.f) return 1.f;
  if (x <= -8.f) return -1.f;
  const float sign = x < 0.f ? -1.f : 1.f;
  const float ax = fabsf(x);
  const float fi = fminf(fmaxf(floorf(0.5f + 25.f * ax), 0.f), 200.f);
  const float dx = ax - 0.04f * fi;
  float y = table[static_cast<int>(fi)];
  const float dy = 1.f - y * y;
  y = y + dx * dy * (1.f - y * dx);
  return sign * y;
}

__device__ __forceinline__ float sigmoid(const float* table, float x) {
  return 0.5f + 0.5f * tansig(table, 0.5f * x);
}

// sum_i in[i] * w[i * ld + col]
__device__ __forceinline__ float dot_col(const Input& in, const float* __restrict__ w,
                                         int ld, int col) {
  float acc = 0.f;
  int r = 0;
  for (int i = 0; i < in.na; ++i, ++r) acc += in.a[i] * w[r * ld + col];
  for (int i = 0; i < in.nb; ++i, ++r) acc += in.b[i] * w[r * ld + col];
  for (int i = 0; i < in.nc; ++i, ++r) acc += in.c[i] * w[r * ld + col];
  return acc;
}

// One GRU step of width N over the block; h is updated in place unless keep.
// Gates are concatenated (z | r | h) on the output axis: w [in, 3N],
// u [N, 3N], b [3N].
template <int N>
__device__ void gru_step(const Input& in, const float* __restrict__ w,
                         const float* __restrict__ u, const float* __restrict__ b,
                         float* h, bool keep, const float* table, float* pre,
                         float* rec, float* zg, float* hr) {
  const int t = threadIdx.x;
  for (int o = t; o < 5 * N; o += kTHREADS) {
    if (o < 3 * N) {
      pre[o] = dot_col(in, w, 3 * N, o) + b[o];
    } else {
      const int j = o - 3 * N;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc += h[i] * u[i * 3 * N + j];
      rec[j] = acc;
    }
  }
  __syncthreads();
  for (int o = t; o < N; o += kTHREADS) {
    const float z = sigmoid(table, pre[o] + rec[o]);
    const float r = sigmoid(table, pre[N + o] + rec[N + o]);
    zg[o] = z;
    hr[o] = h[o] * r;
  }
  __syncthreads();
  for (int o = t; o < N; o += kTHREADS) {
    float acc = 0.f;
    for (int i = 0; i < N; ++i) acc += hr[i] * u[i * 3 * N + 2 * N + o];
    float cand = pre[2 * N + o] + acc;
    cand = cand < 0.f ? 0.f : cand;  // ReLU candidate (NaN passes, as torch.maximum)
    const float hn = zg[o] * h[o] + (1.f - zg[o]) * cand;
    if (!keep) h[o] = hn;  // only thread o reads h[o] in this phase
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTHREADS)
nn_scan_kernel(const float* __restrict__ feats, const unsigned char* __restrict__ silence,
               const float* __restrict__ state_in, float* __restrict__ graw_out,
               float* __restrict__ gs_out, float* __restrict__ vad_out,
               float* __restrict__ state_out, Weights W, int F) {
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ float table[201];
  __shared__ float st[kSTATE];
  __shared__ float x[kNIN];
  __shared__ float dense[kDENSE];
  __shared__ float pre[3 * kDEN];
  __shared__ float rec[2 * kDEN];
  __shared__ float zg[kDEN];
  __shared__ float hr[kDEN];
  __shared__ int keep_flag;

  float* hv = st;
  float* hn = st + kVAD;
  float* hd = st + kVAD + kNOI;
  float* lastg = st + kVAD + kNOI + kDEN;

  for (int i = t; i < 201; i += kTHREADS) table[i] = W.table[i];
  for (int i = t; i < kSTATE; i += kTHREADS) st[i] = state_in[(size_t)s * kSTATE + i];
  __syncthreads();

  for (int f = 0; f < F; ++f) {
    const size_t sf = (size_t)s * F + f;
    if (t < kNIN) x[t] = feats[sf * kNIN + t];
    if (t == 0) keep_flag = silence[sf] != 0;
    __syncthreads();
    const bool keep = keep_flag != 0;

    if (t < kDENSE) {
      const Input in{x, nullptr, nullptr, kNIN, 0, 0};
      dense[t] = tansig(table, dot_col(in, W.w_id, kDENSE, t) + W.b_id[t]);
    }
    __syncthreads();

    gru_step<kVAD>(Input{dense, nullptr, nullptr, kDENSE, 0, 0}, W.w_vg, W.u_vg, W.b_vg,
                   hv, keep, table, pre, rec, zg, hr);
    float vad_p = 0.f;
    if (t == 0) {  // the VAD head reads the final vad state; only thread 0 uses it
      const Input in{hv, nullptr, nullptr, kVAD, 0, 0};
      vad_p = sigmoid(table, dot_col(in, W.w_vo, 1, 0) + W.b_vo[0]);
    }
    gru_step<kNOI>(Input{dense, hv, x, kDENSE, kVAD, kNIN}, W.w_ng, W.u_ng, W.b_ng,
                   hn, keep, table, pre, rec, zg, hr);
    gru_step<kDEN>(Input{hv, hn, x, kVAD, kNOI, kNIN}, W.w_dg, W.u_dg, W.b_dg,
                   hd, keep, table, pre, rec, zg, hr);

    if (t < kNB) {
      const Input in{hd, nullptr, nullptr, kDEN, 0, 0};
      const float g = sigmoid(table, dot_col(in, W.w_do, kNB, t) + W.b_do[t]);
      const float lg = kALPHA_LASTG * lastg[t];
      const float gs = g < lg ? lg : g;
      graw_out[sf * kNB + t] = g;
      gs_out[sf * kNB + t] = gs;
      if (!keep) lastg[t] = gs;
    }
    if (t == 0) vad_out[sf] = keep ? 0.f : vad_p;
    __syncthreads();
  }
  for (int i = t; i < kSTATE; i += kTHREADS) state_out[(size_t)s * kSTATE + i] = st[i];
}

}  // namespace

extern "C" int crispy_nn_scan(const float* feats, const unsigned char* silence,
                              const float* state_in, float* graw, float* gsmooth,
                              float* vad, float* state_out, const float* w_id,
                              const float* b_id, const float* w_vg, const float* u_vg,
                              const float* b_vg, const float* w_ng, const float* u_ng,
                              const float* b_ng, const float* w_dg, const float* u_dg,
                              const float* b_dg, const float* w_do, const float* b_do,
                              const float* w_vo, const float* b_vo, const float* table,
                              int S, int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights W{w_id, b_id, w_vg, u_vg, b_vg, w_ng, u_ng, b_ng,
                  w_dg, u_dg, b_dg, w_do, b_do, w_vo, b_vo, table};
  nn_scan_kernel<<<S, kTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, silence, state_in, graw, gsmooth, vad, state_out, W, F);
  return static_cast<int>(cudaGetLastError());
}
