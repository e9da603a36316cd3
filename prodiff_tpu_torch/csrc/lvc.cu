// FastDiff's location-variable convolution (LVC) alone, for Hopper.
//
// Replaces the Pallas TPU kernel _lvc_single / lvc_pallas
// (prodiff_tpu/ops/pallas/lvc.py:28, :87). On x [B, T, 32] with per-window
// kernels [KC = 96, CO = 64] and biases [64], for every hop window l:
//   y[t, :] = bias[l] + sum_{d<3, c<32} x[t - 1 + d, c] * K[l][d*32 + c, :]
// with x zero outside [0, T); taps at a window edge read the neighbouring
// window's row. The kernels are read in place from the hoisted
// KernelPredictor stack [N, B, L, layers*96, 64] at (step, layer).
//
// What bounds it on the H100: float32 FMA throughput, narrowly. Per window
// row 12,288 FLOP against 384 bytes of activations, plus 24 KB of kernel per
// window: at hop 256 and T = 131,072 that is 1.61 GFLOP (24 us at the 67
// TFLOP/s FP32 peak) against 63 MB (19 us at 3.35 TB/s). Parity mode keeps the
// tensor cores out (float32 operands, TF32 off).
//
// Design: the TPU kernel builds each window's [hop, 3C] tap matrix in VMEM
// from one contiguous x block plus precomputed edge rows. Here one block of
// 256 threads owns a group of whole windows (lvc_window.cuh): it stages the
// group's rows plus one halo row each side (zero at the sequence ends) and
// the group's window kernels into shared memory once, then each thread
// accumulates 4 gate and 4 filter outputs for M rows in registers, reading
// every staged value from shared memory with no bank conflicts. No tensor
// cores, no TMA: a simple kernel that is right first.

#include "lvc_window.cuh"

using namespace lvcw;

namespace {

template <int M>
__global__ void __launch_bounds__(NT)
lvc_kernel(const float* __restrict__ x, Stack s, float* __restrict__ y, int T, int hop) {
  extern __shared__ __align__(16) float smem[];
  const int G = group_windows(hop);
  const int b = blockIdx.y, l0 = blockIdx.x * G, tid = threadIdx.x;
  const int nwin = min(G, s.L - l0);
  const int R = nwin * hop, t0 = l0 * hop;
  float* Ks = smem;              // [G][KC][CO]
  float* lbs = Ks + G * KC * CO;  // [G][CO]
  float* ys = lbs + G * CO;       // [R + 2][LD], row r = time t0 - 1 + r

  stage_windows(s, b, l0, nwin, Ks, lbs, tid);
  const float* xb = x + (size_t)b * T * C;
  for (int i = tid; i < (R + 2) * C; i += NT) {
    const int r = i / C, c = i % C, t = t0 - 1 + r;
    ys[r * LD + c] = (t >= 0 && t < T) ? xb[(size_t)t * C + c] : 0.f;
  }
  __syncthreads();

  const int rg = tid / 8, pg = tid % 8;
  float* yb = y + (size_t)b * T * CO;
  for (int cr = 0; cr < R; cr += 32 * M) {
    const int rr0 = cr + rg * M;
    if (rr0 >= R) continue;  // a short last group (L % G != 0); M is 1 there
    float ag[M][4], af[M][4];
    window_rows<M>(ys, Ks, lbs, rr0 / hop, rr0, pg, ag, af);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float* row = yb + (size_t)(t0 + rr0 + m) * CO;
      reinterpret_cast<float4*>(row)[pg] = make_float4(ag[m][0], ag[m][1], ag[m][2], ag[m][3]);
      reinterpret_cast<float4*>(row + C)[pg] = make_float4(af[m][0], af[m][1], af[m][2], af[m][3]);
    }
  }
}

template <int M>
int launch(const float* x, const Stack& s, float* y, int T, int hop, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lvc_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = group_windows(hop);
  lvc_kernel<M><<<dim3((s.L + G - 1) / G, s.B), NT, smem, stream>>>(x, s, y, T, hop);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, 32]; km [N, B, L, layers*96, 64], lb [N, B, L, layers*64] (a plain
// per-layer kmat [B, L, 96, 64] is N = layers = 1); y [B, T, 64] out. Reads
// step `step`, layer `layer`. One launch on `stream`; returns the launch
// error (cudaError_t) or 0.
extern "C" int lvc_forward(const float* x, const float* km, const float* lb, float* y, int B,
                           int T, int L, int hop, int layers, int step, int layer,
                           void* stream_ptr) {
  if (B < 1 || L < 1 || !hop_supported(hop) || T != L * hop || layers < 1 || step < 0 ||
      layer < 0 || layer >= layers)
    return (int)cudaErrorInvalidValue;
  const int G = group_windows(hop);
  const size_t smem = sizeof(float) * ((size_t)G * KC * CO + G * CO + (size_t)(G * hop + 2) * LD);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Stack s{km, lb, B, L, layers, step, layer};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (rows_per_thread(hop)) {
    case 8: return launch<8>(x, s, y, T, hop, smem, stream);
    case 4: return launch<4>(x, s, y, T, hop, smem, stream);
    case 2: return launch<2>(x, s, y, T, hop, smem, stream);
    default: return launch<1>(x, s, y, T, hop, smem, stream);
  }
}
