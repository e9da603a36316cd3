// One FastDiff LVC layer, fused, for Hopper.
//
// Replaces the Pallas TPU kernel ublock_layer_packed
// (prodiff_tpu/ops/pallas/ublock.py:221; body _fused_layer_compute, :51).
// On x, audio_down [B, T, 32], for the layer with conv dilation d = 3^i:
//   xa  = x + audio_down
//   y   = leaky_0.2(conv3_d(leaky_0.2(xa)) + conv_bias)   (SAME zero padding)
//   y   = LVC(y): per hop window l, bias[l] + taps(y) . K[l]  ([hop, 96] x [96, 64])
//   out = xa + sigmoid(y[:, :32]) * tanh(y[:, 32:])
// The LVC's taps are zero at times -1 and T (the conv of the zero padding is
// NOT zero: it is leaky(bias)), and read the neighbouring window's y at a
// window edge inside the sequence. The window kernels are read in place from
// the hoisted KernelPredictor stack [N, B, L, layers*96, 64] at (step, layer).
//
// What bounds it on the H100: float32 FMA throughput. Per row 18,432 FLOP
// (conv 6,144, LVC 12,288) against 384 bytes of activations, plus 24 KB of
// kernel per window. Block 2 of the LJSpeech net (hop 256, T = 131,072):
// 2.42 GFLOP = 36 us at the 67 TFLOP/s FP32 peak, against 63 MB = 19 us at
// 3.35 TB/s. Parity mode keeps the tensor cores out.
//
// Design: the TPU kernel runs the layer on a lane-packed [T/4, 128] layout
// with block-diagonal per-window kernels to fill 128-wide lanes; none of that
// carries over. Here one block of 256 threads owns a group of whole windows
// (lvc_window.cuh: 4 windows at hop 8, one at hop 64 and 256) and keeps
// every intermediate in shared memory:
//   1. stage xa for the group's rows plus a halo of d + 1 rows each side
//      (zero outside [0, T)) and the [3, 32, 32] conv weight (12 KB);
//   2. the dilated conv with leaky applied on the way in, + bias, leaky, for
//      the rows +-1, then y := 0 at times -1 and T;
//   3. per window the [hop, 96] x [96, 64] product against the staged kernel
//      (24 KB), + bias, the sigmoid * tanh gate in registers (thread owns the
//      pairs j and 32 + j), + xa, written once.
// Only x, audio_down, the window kernels and the output touch device memory.
// At hop 256 and d = 27 the block holds 112 KB of shared memory (2 blocks per
// SM); at hop 8, 128 KB.

#include "lvc_window.cuh"

using namespace lvcw;

namespace {

constexpr float SLOPE = 0.2f;
constexpr int CONV_ROWS = 4;  // conv rows per thread per pass (32 * 4 rows a pass)

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

template <int M>
__global__ void __launch_bounds__(NT)
ublock_layer_kernel(const float* __restrict__ x, const float* __restrict__ ad,
                    const float* __restrict__ cw, const float* __restrict__ cb, Stack s,
                    float* __restrict__ out, int T, int hop, int dil) {
  extern __shared__ __align__(16) float smem[];
  const int G = group_windows(hop);
  const int b = blockIdx.y, l0 = blockIdx.x * G, tid = threadIdx.x;
  const int nwin = min(G, s.L - l0);
  const int R = nwin * hop, t0 = l0 * hop, h = dil + 1;
  float* Ks = smem;                     // [G][KC][CO]
  float* lbs = Ks + G * KC * CO;         // [G][CO]
  float* Ws = lbs + G * CO;              // [3][C][C]: tap q, in ci, out co
  float* cbs = Ws + 3 * C * C;           // [C]
  float* xs = cbs + C;                   // [R + 2h][LD], row r = time t0 - h + r
  float* ys = xs + (G * hop + 2 * h) * LD;  // [R + 2][LD], row r = time t0 - 1 + r

  stage_windows(s, b, l0, nwin, Ks, lbs, tid);
  for (int i = tid; i < 3 * C * C; i += NT) {  // torch Conv1d weight [co][ci][q]
    const int q = i / (C * C), ci = (i / C) % C, co = i % C;
    Ws[i] = cw[(co * C + ci) * 3 + q];
  }
  if (tid < C) cbs[tid] = cb[tid];
  const size_t off = (size_t)b * T * C;
  for (int i = tid; i < (R + 2 * h) * C; i += NT) {
    const int r = i / C, c = i % C, t = t0 - h + r;
    xs[r * LD + c] = (t >= 0 && t < T) ? x[off + (size_t)t * C + c] + ad[off + (size_t)t * C + c]
                                       : 0.f;
  }
  __syncthreads();

  // 2. y rows r in [0, R + 2): tap q of row r reads xs row r + q * d
  const int rg = tid / 8, cg = tid % 8;
  const float4* W4 = reinterpret_cast<const float4*>(Ws);
  for (int base = 0; base < R + 2; base += 32 * CONV_ROWS) {
    float acc[CONV_ROWS][4];
    int rows[CONV_ROWS];
#pragma unroll
    for (int mm = 0; mm < CONV_ROWS; ++mm) {
      rows[mm] = min(base + rg + 32 * mm, R + 1);  // past the end: recompute the last row
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[mm][p] = cbs[4 * cg + p];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 w = W4[(q * C + ci) * (C / 4) + cg];
#pragma unroll
        for (int mm = 0; mm < CONV_ROWS; ++mm) {
          const float v = leaky(xs[(rows[mm] + q * dil) * LD + ci]);
          acc[mm][0] = fmaf(v, w.x, acc[mm][0]);
          acc[mm][1] = fmaf(v, w.y, acc[mm][1]);
          acc[mm][2] = fmaf(v, w.z, acc[mm][2]);
          acc[mm][3] = fmaf(v, w.w, acc[mm][3]);
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < CONV_ROWS; ++mm) {
      const int r = base + rg + 32 * mm;
      if (r >= R + 2) continue;
      const int t = t0 - 1 + r;
      const bool inside = t >= 0 && t < T;  // the LVC's taps are zero outside [0, T)
#pragma unroll
      for (int p = 0; p < 4; ++p) ys[r * LD + 4 * cg + p] = inside ? leaky(acc[mm][p]) : 0.f;
    }
  }
  __syncthreads();

  // 3. LVC + gate + residual
  const int pg = cg;
  for (int cr = 0; cr < R; cr += 32 * M) {
    const int rr0 = cr + rg * M;
    if (rr0 >= R) continue;  // a short last group (L % G != 0); M is 1 there
    float ag[M][4], af[M][4];
    window_rows<M>(ys, Ks, lbs, rr0 / hop, rr0, pg, ag, af);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* xa = xs + (rr0 + m + h) * LD + 4 * pg;
      float o[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) o[p] = xa[p] + tanhf(af[m][p]) / (1.f + expf(-ag[m][p]));
      reinterpret_cast<float4*>(out + off + (size_t)(t0 + rr0 + m) * C)[pg] =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int M>
int launch(const float* x, const float* ad, const float* cw, const float* cb, const Stack& s,
           float* out, int T, int hop, int dil, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ublock_layer_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = group_windows(hop);
  ublock_layer_kernel<M><<<dim3((s.L + G - 1) / G, s.B), NT, smem, stream>>>(
      x, ad, cw, cb, s, out, T, hop, dil);
  return (int)cudaGetLastError();
}

}  // namespace

// x, ad [B, T, 32]; cw [32, 32, 3] (torch Conv1d layout), cb [32];
// km [N, B, L, layers*96, 64], lb [N, B, L, layers*64] (a plain per-layer
// kmat is N = layers = 1); out [B, T, 32], distinct from x and ad. Reads step
// `step`, layer `layer`. One launch on `stream`; returns the launch error
// (cudaError_t) or 0.
extern "C" int ublock_layer_forward(const float* x, const float* ad, const float* cw,
                                    const float* cb, const float* km, const float* lb,
                                    float* out, int B, int T, int L, int hop, int dil,
                                    int layers, int step, int layer, void* stream_ptr) {
  if (B < 1 || L < 1 || !hop_supported(hop) || T != L * hop || dil < 1 || layers < 1 ||
      step < 0 || layer < 0 || layer >= layers)
    return (int)cudaErrorInvalidValue;
  const int G = group_windows(hop), h = dil + 1;
  const size_t smem =
      sizeof(float) * ((size_t)G * KC * CO + G * CO + 3 * C * C + C +
                       (size_t)(G * hop + 2 * h) * LD + (size_t)(G * hop + 2) * LD);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Stack s{km, lb, B, L, layers, step, layer};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (rows_per_thread(hop)) {
    case 8: return launch<8>(x, ad, cw, cb, s, out, T, hop, dil, smem, stream);
    case 4: return launch<4>(x, ad, cw, cb, s, out, T, hop, dil, smem, stream);
    case 2: return launch<2>(x, ad, cw, cb, s, out, T, hop, dil, smem, stream);
    default: return launch<1>(x, ad, cw, cb, s, out, T, hop, dil, smem, stream);
  }
}
