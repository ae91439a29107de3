// K1: the whole RNNoise network over F frames, in two variants.
//
// Replaces crispy_tpu/dsp/rnnoise/pallas_rnn.py::nn_scan_pallas (body
// `_kernel`): input dense 42->24 (tansig), VAD GRU 24, noise GRU 48, denoise
// GRU 96 (ReLU candidates), the 22-band gain head and the VAD head. Gains are
// smoothed as max(graw, ALPHA_LASTG * lastg); a silent frame freezes every
// state and writes vad 0. Its plain PyTorch version is
// rnn_kernels.nn_scan_reference.
//
// What bounds it on the H100: ~86,952 multiply-adds per stream-frame (S=128,
// F=500: ~11.1 GFLOP, ~0.17 ms at 67 TFLOP/s f32) against ~22 MB of input and
// output. But the frames of one stream form a recurrence: the real limit is
// the latency of one frame's chain of dependent layers, and the rate at which
// one SM can read the weights that chain needs.
//
// The resident variant (nn_scan_resident_kernel), for weights that are exact
// in fp16 (the int8/256 grid every RNNoise model is quantised to; the wrapper
// checks it):
// - The 86,952 matrix weights live in shared memory as fp16 (181.5 KB with
//   the padding of the tiles; the biases and the tansig table stay f32),
//   loaded once per block before the frame loop, widened to f32 as they are
//   read; every sum accumulates in f32 with __fmaf_rn.
// - Each matrix is cut into segments (rnn_kernels._SEGMENTS lists them in
//   the order of the W_* offsets below), each segment into tiles of one warp:
//   G lanes (1, 2 or 4) share an output column and split its input, 12 row
//   pairs a lane read as three 16-byte words, in two chains of 12
//   multiply-adds, then sum with at most two __shfl_xor_sync. No sum of
//   42-114 terms is one thread's chain. The wrapper packs each tile in the
//   order its lanes read it, so a warp reads consecutive words (no bank
//   conflicts).
// - The block's 32 warps are two groups. 18 warps run the chain of a frame,
//   dense -> VAD gates -> VAD candidate -> noise gates -> noise candidate ->
//   denoise gates -> denoise candidate, 7 steps with a barrier after each.
//   14 warps compute, beside it, what needs only the frame's features, the
//   previous frame's state or a state the chain has just made (the x, dense
//   and vad parts of the GRU inputs, the recurrent z|r products, the VAD
//   head, the previous frame's gains), each handed over through a named
//   barrier (bar.arrive / bar.sync) just before the chain step that adds it.
// - The next frame's 42 features are copied in with cp.async while the frame
//   computes; its silence flag is loaded into a register at the same time.
// - NS streams per block (1, 2 or 4, chosen from S so that the grid fits the
//   SMs in one wave): each weight read from shared memory feeds all of them.
//
// The f32 variant (nn_scan_f32_kernel), for weights that are not exact in
// fp16: one block of 256 threads per stream, f32 weights read from L2, one
// thread per output column, 12 phases per frame.
//
// tansig reads the same 201-entry table as the plain version, and both
// variants give NaN features the plain version's treatment.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNB = 22;
constexpr int kNIN = 42;
constexpr int kDENSE = 24;
constexpr int kVAD = 24;
constexpr int kNOI = 48;
constexpr int kDEN = 96;
constexpr int kSTATE = kVAD + kNOI + kDEN + kNB;  // 190
constexpr int kTABLE = 201;
constexpr float kALPHA_LASTG = 0.6f;

// Without branches (selects only), so that a warp's lanes never diverge on
// the chain: NaN gives 0, |x| >= 8 gives +-1, as in the plain version.
__device__ __forceinline__ float tansig(const float* table, float x) {
  const float ax = fabsf(x);
  const float fi = fminf(fmaxf(floorf(0.5f + 25.f * ax), 0.f), 200.f);  // NaN -> 0
  const float dx = ax - 0.04f * fi;
  float y = table[static_cast<int>(fi)];
  const float dy = 1.f - y * y;
  y = y + dx * dy * (1.f - y * dx);
  y = x < 0.f ? -y : y;
  y = x >= 8.f ? 1.f : y;
  y = x <= -8.f ? -1.f : y;
  return x != x ? 0.f : y;
}

__device__ __forceinline__ float sigmoid(const float* table, float x) {
  return 0.5f + 0.5f * tansig(table, 0.5f * x);
}

// z * h + (1 - z) * relu(cand); NaN passes the ReLU, as in torch.clamp_min.
__device__ __forceinline__ float gru_out(float z, float h, float cand) {
  cand = cand < 0.f ? 0.f : cand;
  return z * h + (1.f - z) * cand;
}

// max(g, ALPHA_LASTG * lastg) with NaN from either side, as torch.maximum.
__device__ __forceinline__ float smooth_gain(float g, float lastg) {
  const float lg = kALPHA_LASTG * lastg;
  return lg != lg ? lg : (g < lg ? lg : g);
}

// ---------------------------------------------------------------------------
// The f32 variant
// ---------------------------------------------------------------------------

constexpr int kF32_THREADS = 256;

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
  for (int o = t; o < 5 * N; o += kF32_THREADS) {
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
  for (int o = t; o < N; o += kF32_THREADS) {
    const float z = sigmoid(table, pre[o] + rec[o]);
    const float r = sigmoid(table, pre[N + o] + rec[N + o]);
    zg[o] = z;
    hr[o] = h[o] * r;
  }
  __syncthreads();
  for (int o = t; o < N; o += kF32_THREADS) {
    float acc = 0.f;
    for (int i = 0; i < N; ++i) acc += hr[i] * u[i * 3 * N + 2 * N + o];
    const float hn = gru_out(zg[o], h[o], pre[2 * N + o] + acc);
    if (!keep) h[o] = hn;  // only thread o reads h[o] in this phase
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kF32_THREADS)
nn_scan_f32_kernel(const float* __restrict__ feats, const unsigned char* __restrict__ silence,
                   const float* __restrict__ state_in, float* __restrict__ graw_out,
                   float* __restrict__ gs_out, float* __restrict__ vad_out,
                   float* __restrict__ state_out, Weights W, int F) {
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ float table[kTABLE];
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

  for (int i = t; i < kTABLE; i += kF32_THREADS) table[i] = W.table[i];
  for (int i = t; i < kSTATE; i += kF32_THREADS) st[i] = state_in[(size_t)s * kSTATE + i];
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
      const float gs = smooth_gain(g, lastg[t]);
      graw_out[sf * kNB + t] = g;
      gs_out[sf * kNB + t] = gs;
      if (!keep) lastg[t] = gs;
    }
    if (t == 0) vad_out[sf] = keep ? 0.f : vad_p;
    __syncthreads();
  }
  for (int i = t; i < kSTATE; i += kF32_THREADS) state_out[(size_t)s * kSTATE + i] = st[i];
}

// ---------------------------------------------------------------------------
// The resident variant
// ---------------------------------------------------------------------------

constexpr int kCH_WARPS = 18;                 // the chain group
constexpr int kBG_WARPS = 14;                 // the background group
constexpr int kCH_THREADS = kCH_WARPS * 32;
constexpr int kRES_THREADS = (kCH_WARPS + kBG_WARPS) * 32;
constexpr int kRUNS = 3;                      // runs of 4 pairs a lane multiplies per tile
constexpr int kXLD = 48;                      // a feature row, padded with zeros to 12 x 2 pairs
constexpr int kTILE = kRUNS * 4 * 32;         // __half2 words of a tile (one warp's work)

__host__ __device__ constexpr int tiles(int ncols, int g) {
  return (ncols + 32 / g - 1) / (32 / g);
}
__host__ __device__ constexpr int words(int ncols, int g) { return tiles(ncols, g) * kTILE; }

// Offsets (in __half2 words) of the packed segments (matrix, input, G lanes
// per column), in the order of rnn_kernels._SEGMENTS.
constexpr int W_DENSE = 0;                          // W_id,              x,  24 cols, G 2
constexpr int W_RV = W_DENSE + words(24, 2);     // U_vg[:, :48],      hv, G 1
constexpr int W_GAIN = W_RV + words(48, 1);      // W_do,              hd, 22 cols, G 4
constexpr int W_RN = W_GAIN + words(22, 4);      // U_ng[:, :96],      hn, G 2
constexpr int W_DXA = W_RN + words(96, 2);       // W_dg[72:, :96],    x,  G 2
constexpr int W_VG = W_DXA + words(96, 2);       // W_vg,              dense, 72 cols, G 1
constexpr int W_ND = W_VG + words(72, 1);        // W_ng[:24],         dense, G 1
constexpr int W_NX = W_ND + words(144, 1);       // W_ng[48:],         x,  G 2
constexpr int W_UVC = W_NX + words(144, 2);      // U_vg[:, 48:],      hr_v, G 1
constexpr int W_RDZ = W_UVC + words(24, 1);      // U_dg[:, :96],      hd, G 4
constexpr int W_DXB = W_RDZ + words(96, 4);      // W_dg[72:, 96:192], x,  G 2
constexpr int W_NH = W_DXB + words(96, 2);       // W_ng[24:48],       hv, G 1
constexpr int W_VO = W_NH + words(144, 1);       // W_vo,              hv, 1 col, G 1
constexpr int W_DV = W_VO + words(1, 1);         // W_dg[:24],         hv, G 1
constexpr int W_UNC = W_DV + words(288, 1);      // U_ng[:, 96:],      hr_n, G 2
constexpr int W_RDR = W_UNC + words(48, 2);      // U_dg[:, 96:192],   hd, G 4
constexpr int W_DXC = W_RDR + words(96, 4);      // W_dg[72:, 192:],   x,  G 2
constexpr int W_DGN = W_DXC + words(96, 2);      // W_dg[24:72],       hn, G 2
constexpr int W_UDC = W_DGN + words(288, 2);     // U_dg[:, 192:],     hr_d, G 4
constexpr int kWORDS = W_UDC + words(96, 4);
static_assert(kWORDS == 46464, "segment table changed: update rnn_kernels._SEGMENTS");

// Biases in shared memory.
constexpr int B_ID = 0, B_VG = B_ID + kDENSE, B_NG = B_VG + 3 * kVAD, B_DG = B_NG + 3 * kNOI,
              B_DO = B_DG + 3 * kDEN, B_VO = B_DO + kNB, kBIAS = B_VO + 2;
constexpr int kTABLE_PAD = 204;

// Per-stream buffers (floats; every input a multiple of 4, for float4
// reads). The state HV | HN | HD | LASTG is contiguous in the order of the
// packed state.
enum : int {
  X = 0,                  // 2 x kXLD, double-buffered features
  HV = X + 2 * kXLD,
  HN = HV + kVAD,
  HD = HN + kNOI,
  LASTG = HD + kDEN,
  DENSE = LASTG + kNB + 2,
  RECV = DENSE + kDENSE,  // hv @ U_vg z|r
  ZV = RECV + 2 * kVAD,
  HRV = ZV + kVAD,        // hv * r
  CPV = HRV + kVAD,       // candidate pre-activation, input part
  RECN = CPV + kVAD,
  PXN = RECN + 2 * kNOI,  // x part + bias
  PDN = PXN + 3 * kNOI,   // dense part
  ZN = PDN + 3 * kNOI,
  HRN = ZN + kNOI,
  CPN = HRN + kNOI,
  PXD = CPN + kNOI,       // x part + bias
  PVD = PXD + 3 * kDEN,   // vad part
  RECD = PVD + 3 * kDEN,
  ZD = RECD + 2 * kDEN,
  HRD = ZD + kDEN,
  CPD = HRD + kDEN,
  kLD = CPD + kDEN,       // 2016
};
static_assert(LASTG + kNB - HV == kSTATE, "state layout");
static_assert(kLD % 4 == 0 && HV % 4 == 0 && HN % 4 == 0 && HD % 4 == 0 && DENSE % 4 == 0 &&
              HRV % 4 == 0 && HRN % 4 == 0 && HRD % 4 == 0, "float4 reads");

struct Biases {
  const float *id, *vg, *ng, *dg, *do_, *vo;
};

template <int NS>
constexpr size_t resident_smem() {
  return (size_t)kWORDS * 4 + (kTABLE_PAD + kBIAS) * 4 + (size_t)NS * kLD * 4 + 4 * NS * 4;
}
static_assert(resident_smem<4>() <= 232448, "shared memory");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// acc[s] = sum over the tile's column (lane / G) of act[s][i] * w[i]: each
// lane reads its 12 pairs as 3 runs of 4 (a 16-byte word of fp16 weights,
// two float4 of inputs), multiplies in two chains, then the G lanes of the
// column sum by shuffles.
template <int G, int NS>
__device__ __forceinline__ void tile_dot(const __half2* w, const float* act, float (&acc)[NS]) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const uint4* wq = reinterpret_cast<const uint4*>(w);
  float acc2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = acc2[s] = 0.f;
#pragma unroll(NS >= 2 ? 1 : kRUNS)  // several streams: bound the registers
  for (int k = 0; k < kRUNS; ++k) {
    const uint4 q = wq[k * 32 + lane];
    const float2 w0 = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
    const float2 w1 = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
    const float2 w2 = __half22float2(*reinterpret_cast<const __half2*>(&q.z));
    const float2 w3 = __half22float2(*reinterpret_cast<const __half2*>(&q.w));
    const int i = 8 * (k * G + g);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(act + s * kLD + i);
      const float4 b = *reinterpret_cast<const float4*>(act + s * kLD + i + 4);
      acc[s] = __fmaf_rn(a.x, w0.x, acc[s]);
      acc2[s] = __fmaf_rn(b.x, w2.x, acc2[s]);
      acc[s] = __fmaf_rn(a.y, w0.y, acc[s]);
      acc2[s] = __fmaf_rn(b.y, w2.y, acc2[s]);
      acc[s] = __fmaf_rn(a.z, w1.x, acc[s]);
      acc2[s] = __fmaf_rn(b.z, w3.x, acc2[s]);
      acc[s] = __fmaf_rn(a.w, w1.y, acc[s]);
      acc2[s] = __fmaf_rn(b.w, w3.y, acc2[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] += acc2[s];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
  }
}

// The warp's share of one segment's tiles: t is the warp's next tile index
// in its group of nwarps, counted across the segments of one step, so that
// the step's tiles go round robin over the group. epi(s, col, sum) runs on
// the column's first lane.
template <int G, int NS, class Epi>
__device__ __forceinline__ void run_tiles(int& t, int nwarps, int woff, int ncols,
                                          const __half2* w, const float* act, Epi epi) {
  const int ntiles = tiles(ncols, G);
  const int lane = threadIdx.x & 31;
  for (; t < ntiles; t += nwarps) {
    float acc[NS];
    tile_dot<G, NS>(w + woff + t * kTILE, act, acc);
    const int c = t * (32 / G) + lane / G;
    if ((lane & (G - 1)) == 0 && c < ncols) {
#pragma unroll
      for (int s = 0; s < NS; ++s) epi(s, c, acc[s]);
    }
  }
  t -= ntiles;
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// Named barriers (0 is __syncthreads). CH: the chain group, BG: the
// background group. "X -> Y": X arrives, Y waits.
enum : int {
  BAR_CH = 1,     // CH only
  BAR_RV = 2,     // BG -> CH: VAD z|r recurrent products of frame f
  BAR_DENSE = 3,  // CH -> BG: the dense layer of frame f
  BAR_N = 4,      // BG -> CH: the noise GRU's x, dense and recurrent parts
  BAR_HV = 5,     // CH -> BG: the VAD state of frame f
  BAR_D = 6,      // BG -> CH: the denoise GRU's x, vad and recurrent parts
  BAR_FRAME = 7,  // CH -> BG: frame f done (states final, frame f + 1 loaded)
};

template <int NS>
__global__ void __launch_bounds__(kRES_THREADS, 1)
nn_scan_resident_kernel(const float* __restrict__ feats, const unsigned char* __restrict__ silence,
                        const float* __restrict__ state_in, float* __restrict__ graw_out,
                        float* __restrict__ gs_out, float* __restrict__ vad_out,
                        float* __restrict__ state_out, const uint4* __restrict__ packed,
                        Biases Bg, const float* __restrict__ table_g, int S, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const __half2* w = reinterpret_cast<const __half2*>(smem);
  float* table = reinterpret_cast<float*>(smem + (size_t)kWORDS * 4);
  float* bias = table + kTABLE_PAD;
  float* buf = bias + kBIAS;
  int* keep = reinterpret_cast<int*>(buf + NS * kLD);  // [4][NS], frame f at f & 3
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * NS;

  {
    uint4* w4 = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kWORDS / 4; i += kRES_THREADS) w4[i] = packed[i];
  }
  for (int i = tid; i < kTABLE; i += kRES_THREADS) table[i] = table_g[i];
  for (int i = tid; i < kBIAS; i += kRES_THREADS) {
    float v = 0.f;
    if (i < B_VG) v = Bg.id[i - B_ID];
    else if (i < B_NG) v = Bg.vg[i - B_VG];
    else if (i < B_DG) v = Bg.ng[i - B_NG];
    else if (i < B_DO) v = Bg.dg[i - B_DG];
    else if (i < B_VO) v = Bg.do_[i - B_DO];
    else if (i == B_VO) v = Bg.vo[0];
    bias[i] = v;
  }
  for (int i = tid; i < NS * kLD; i += kRES_THREADS) buf[i] = 0.f;  // pads stay 0
  __syncthreads();
  for (int i = tid; i < NS * kSTATE; i += kRES_THREADS) {
    const int s = i / kSTATE, j = i - s * kSTATE;
    if (s0 + s < S) buf[s * kLD + HV + j] = state_in[(size_t)(s0 + s) * kSTATE + j];
  }
  for (int i = tid; i < NS * kNIN; i += kRES_THREADS) {
    const int s = i / kNIN, j = i - s * kNIN;
    if (s0 + s < S && F > 0) buf[s * kLD + X + j] = feats[(size_t)(s0 + s) * F * kNIN + j];
  }
  if (tid < NS) keep[tid] = (s0 + tid < S && F > 0) ? silence[(size_t)(s0 + tid) * F] != 0 : 1;
  __syncthreads();

  // The gain head of frame fp: reads the final denoise state of fp.
  auto gain = [&](int fp) {
    const int* kp = keep + (fp & 3) * NS;
    return [=](int s, int c, float v) {
      if (s0 + s >= S) return;
      float* b = buf + s * kLD;
      const float g = sigmoid(table, v + bias[B_DO + c]);
      const float gs = smooth_gain(g, b[LASTG + c]);
      const size_t row = ((size_t)(s0 + s) * F + fp) * kNB + c;
      graw_out[row] = g;
      gs_out[row] = gs;
      if (!kp[s]) b[LASTG + c] = gs;
    };
  };
  auto store = [&](int off) {
    return [=](int s, int c, float v) { buf[s * kLD + off + c] = v; };
  };
  auto store_biased = [&](int off, int boff) {
    return [=](int s, int c, float v) { buf[s * kLD + off + c] = v + bias[boff + c]; };
  };
  const int warp = tid >> 5;

  if (warp < kCH_WARPS) {
    // The chain group: dense -> VAD gates -> VAD candidate -> noise gates ->
    // noise candidate -> denoise gates -> denoise candidate, each step on
    // the one before; what only needs the frame's features or the previous
    // frame's state comes from the background group.
    for (int f = 0; f < F; ++f) {
      const float* xf = buf + X + (f & 1) * kXLD;
      const int* kf = keep + (f & 3) * NS;
      int next_keep = 1;
      if (f + 1 < F) {  // prefetch frame f + 1
        float* xn = buf + X + ((f + 1) & 1) * kXLD;
        for (int i = tid; i < NS * kNIN; i += kCH_THREADS) {
          const int s = i / kNIN, j = i - s * kNIN;
          if (s0 + s < S)
            cp_async4(xn + s * kLD + j, feats + ((size_t)(s0 + s) * F + f + 1) * kNIN + j);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        if (tid < NS && s0 + tid < S) next_keep = silence[(size_t)(s0 + tid) * F + f + 1] != 0;
      }
      int t = warp;
      run_tiles<2, NS>(t, kCH_WARPS, W_DENSE, kDENSE, w, xf, [&](int s, int c, float v) {
        buf[s * kLD + DENSE + c] = tansig(table, v + bias[B_ID + c]);
      });
      bar_arrive(BAR_DENSE, kRES_THREADS);
      bar_sync(BAR_RV, kRES_THREADS);

      t = warp;
      run_tiles<1, NS>(t, kCH_WARPS, W_VG, 3 * kVAD, w, buf + DENSE, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float pre = v + bias[B_VG + c];
        if (c < kVAD) b[ZV + c] = sigmoid(table, pre + b[RECV + c]);
        else if (c < 2 * kVAD) b[HRV + c - kVAD] = b[HV + c - kVAD] * sigmoid(table, pre + b[RECV + c]);
        else b[CPV + c - 2 * kVAD] = pre;
      });
      bar_sync(BAR_CH, kCH_THREADS);

      t = warp;
      run_tiles<1, NS>(t, kCH_WARPS, W_UVC, kVAD, w, buf + HRV, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float h = gru_out(b[ZV + c], b[HV + c], b[CPV + c] + v);
        if (!kf[s]) b[HV + c] = h;
      });
      bar_arrive(BAR_HV, kRES_THREADS);
      bar_sync(BAR_N, kRES_THREADS);

      t = warp;
      run_tiles<1, NS>(t, kCH_WARPS, W_NH, 3 * kNOI, w, buf + HV, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float pre = (b[PXN + c] + b[PDN + c]) + v;
        if (c < kNOI) b[ZN + c] = sigmoid(table, pre + b[RECN + c]);
        else if (c < 2 * kNOI) b[HRN + c - kNOI] = b[HN + c - kNOI] * sigmoid(table, pre + b[RECN + c]);
        else b[CPN + c - 2 * kNOI] = pre;
      });
      bar_sync(BAR_CH, kCH_THREADS);

      t = warp;
      run_tiles<2, NS>(t, kCH_WARPS, W_UNC, kNOI, w, buf + HRN, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float h = gru_out(b[ZN + c], b[HN + c], b[CPN + c] + v);
        if (!kf[s]) b[HN + c] = h;
      });
      bar_sync(BAR_D, kRES_THREADS);

      t = warp;
      run_tiles<2, NS>(t, kCH_WARPS, W_DGN, 3 * kDEN, w, buf + HN, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float pre = (b[PXD + c] + b[PVD + c]) + v;
        if (c < kDEN) b[ZD + c] = sigmoid(table, pre + b[RECD + c]);
        else if (c < 2 * kDEN) b[HRD + c - kDEN] = b[HD + c - kDEN] * sigmoid(table, pre + b[RECD + c]);
        else b[CPD + c - 2 * kDEN] = pre;
      });
      bar_sync(BAR_CH, kCH_THREADS);

      t = warp;
      run_tiles<4, NS>(t, kCH_WARPS, W_UDC, kDEN, w, buf + HRD, [&](int s, int c, float v) {
        float* b = buf + s * kLD;
        const float h = gru_out(b[ZD + c], b[HD + c], b[CPD + c] + v);
        if (!kf[s]) b[HD + c] = h;
      });
      if (f + 1 < F) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        if (tid < NS) keep[((f + 1) & 3) * NS + tid] = next_keep;
      }
      bar_arrive(BAR_FRAME, kRES_THREADS);
      bar_sync(BAR_CH, kCH_THREADS);
    }
  } else {
    // The background group: the products that need only the frame's
    // features, the previous frame's state or a state the chain has just
    // made, each ready before the chain step that adds it.
    const int bw = warp - kCH_WARPS;
    for (int f = 0; f < F; ++f) {
      const float* xf = buf + X + (f & 1) * kXLD;
      const int* kf = keep + (f & 3) * NS;
      if (f > 0) bar_sync(BAR_FRAME, kRES_THREADS);
      int t = bw;
      run_tiles<1, NS>(t, kBG_WARPS, W_RV, 2 * kVAD, w, buf + HV, store(RECV));
      bar_arrive(BAR_RV, kRES_THREADS);

      t = bw;
      run_tiles<2, NS>(t, kBG_WARPS, W_NX, 3 * kNOI, w, xf, store_biased(PXN, B_NG));
      run_tiles<2, NS>(t, kBG_WARPS, W_RN, 2 * kNOI, w, buf + HN, store(RECN));
      if (f > 0) run_tiles<4, NS>(t, kBG_WARPS, W_GAIN, kNB, w, buf + HD, gain(f - 1));
      bar_sync(BAR_DENSE, kRES_THREADS);
      run_tiles<1, NS>(t, kBG_WARPS, W_ND, 3 * kNOI, w, buf + DENSE, store(PDN));
      bar_arrive(BAR_N, kRES_THREADS);

      t = bw;
      run_tiles<2, NS>(t, kBG_WARPS, W_DXA, kDEN, w, xf, store_biased(PXD, B_DG));
      run_tiles<2, NS>(t, kBG_WARPS, W_DXB, kDEN, w, xf, store_biased(PXD + kDEN, B_DG + kDEN));
      run_tiles<2, NS>(t, kBG_WARPS, W_DXC, kDEN, w, xf,
                          store_biased(PXD + 2 * kDEN, B_DG + 2 * kDEN));
      run_tiles<4, NS>(t, kBG_WARPS, W_RDZ, kDEN, w, buf + HD, store(RECD));
      run_tiles<4, NS>(t, kBG_WARPS, W_RDR, kDEN, w, buf + HD, store(RECD + kDEN));
      bar_sync(BAR_HV, kRES_THREADS);
      run_tiles<1, NS>(t, kBG_WARPS, W_DV, 3 * kDEN, w, buf + HV, store(PVD));
      run_tiles<1, NS>(t, kBG_WARPS, W_VO, 1, w, buf + HV, [&](int s, int, float v) {
        if (s0 + s < S)
          vad_out[(size_t)(s0 + s) * F + f] = kf[s] ? 0.f : sigmoid(table, v + bias[B_VO]);
      });
      bar_arrive(BAR_D, kRES_THREADS);
    }
    if (F > 0) {  // the last frame's gains
      bar_sync(BAR_FRAME, kRES_THREADS);
      int t = bw;
      run_tiles<4, NS>(t, kBG_WARPS, W_GAIN, kNB, w, buf + HD, gain(F - 1));
    }
  }
  __syncthreads();
  for (int i = tid; i < NS * kSTATE; i += kRES_THREADS) {
    const int s = i / kSTATE, j = i - s * kSTATE;
    if (s0 + s < S) state_out[(size_t)(s0 + s) * kSTATE + j] = buf[s * kLD + HV + j];
  }
}

template <int NS>
cudaError_t launch_resident(const float* feats, const unsigned char* silence,
                            const float* state_in, float* graw, float* gs, float* vad,
                            float* state_out, const void* packed, const Biases& B,
                            const float* table, int S, int F, cudaStream_t stream) {
  constexpr size_t smem = resident_smem<NS>();
  cudaError_t err = cudaFuncSetAttribute(nn_scan_resident_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nn_scan_resident_kernel<NS><<<(S + NS - 1) / NS, kRES_THREADS, smem, stream>>>(
      feats, silence, state_in, graw, gs, vad, state_out,
      static_cast<const uint4*>(packed), B, table, S, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" int crispy_nn_scan_f32(const float* feats, const unsigned char* silence,
                                  const float* state_in, float* graw, float* gsmooth,
                                  float* vad, float* state_out, const float* w_id,
                                  const float* b_id, const float* w_vg, const float* u_vg,
                                  const float* b_vg, const float* w_ng, const float* u_ng,
                                  const float* b_ng, const float* w_dg, const float* u_dg,
                                  const float* b_dg, const float* w_do, const float* b_do,
                                  const float* w_vo, const float* b_vo, const float* table,
                                  int S, int F, int device, void* stream) {
  const ScopedDevice guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights W{w_id, b_id, w_vg, u_vg, b_vg, w_ng, u_ng, b_ng,
                  w_dg, u_dg, b_dg, w_do, b_do, w_vo, b_vo, table};
  nn_scan_f32_kernel<<<S, kF32_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, silence, state_in, graw, gsmooth, vad, state_out, W, F);
  return static_cast<int>(cudaGetLastError());
}

// packed: the fp16 weights in segment order (rnn_kernels.pack_half_weights),
// n_half2 words of them, 16-byte aligned. Streams per block: the fewest of
// 1, 2, 4 that fit the grid onto the SMs in one wave.
extern "C" int crispy_nn_scan_resident(const float* feats, const unsigned char* silence,
                                       const float* state_in, float* graw, float* gsmooth,
                                       float* vad, float* state_out, const void* packed,
                                       const float* b_id, const float* b_vg, const float* b_ng,
                                       const float* b_dg, const float* b_do, const float* b_vo,
                                       const float* table, int n_half2, int S, int F,
                                       int device, void* stream) {
  if (n_half2 != kWORDS || reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScopedDevice guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ns = 1;
  while (ns < 4 && (S + ns - 1) / ns > sms) ns *= 2;
  const Biases B{b_id, b_vg, b_ng, b_dg, b_do, b_vo};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ns == 1)
    err = launch_resident<1>(feats, silence, state_in, graw, gsmooth, vad, state_out, packed, B,
                             table, S, F, st);
  else if (ns == 2)
    err = launch_resident<2>(feats, silence, state_in, graw, gsmooth, vad, state_out, packed, B,
                             table, S, F, st);
  else
    err = launch_resident<4>(feats, silence, state_in, graw, gsmooth, vad, state_out, packed, B,
                             table, S, F, st);
  return static_cast<int>(err);
}
