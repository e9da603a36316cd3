// The location-variable convolution's window product of the LVC kernel
// (lvc.cu); its constants and the hoisted-stack view (Stack) also serve the
// fused LVC-layer kernels' tiles (lvc_tiles.cuh).
//
// FastDiff's LVC: for output time t in hop window l,
//   y[t, :] = bias[l, :] + sum_{d<3, c<C} y_in[t - 1 + d, c] * K[l][d*C + c, :]
// with y_in zero outside [0, T). Kernel rows are tap-major (d = 0 is time
// t-1), as the KernelPredictor emits them. C = 32 input channels and
// CO = 2C = 64 outputs (gate | filter) are fixed: FastDiff's inner width.
//
// Block geometry (lvc.cu): one block of NT = 256 threads owns a group of
// G whole windows, R = G * hop rows. G = 32 / hop for hop 8 and 16 (so a
// group has 32 rows), else 1. The G window kernels (24 KB each) are staged
// into shared memory once; the rows are walked in chunks of 32 * M rows, M
// rows per thread. Thread (rg = tid / 8, pg = tid % 8) owns output pairs
// j = 4pg..4pg+3 (gate) and C + j (filter), so a gate can be formed in
// registers, for rows rg*M .. rg*M + M - 1 of the chunk.

#pragma once

#include <cuda_runtime.h>

namespace lvcw {

constexpr int C = 32;
constexpr int CO = 2 * C;
constexpr int KC = 3 * C;
constexpr int NT = 256;
constexpr int LD = C + 1;  // padded row of the staged activations
constexpr int MAX_SMEM = 232448;

// Windows per block: G. hop must be 8, 16 or a multiple of 32.
__host__ __device__ inline int group_windows(int hop) { return hop < 32 ? 32 / hop : 1; }

// Rows per thread in one chunk: the largest of 8, 4, 2, 1 with 32*M | G*hop.
__host__ __device__ inline int rows_per_thread(int hop) {
  const int q = hop < 32 ? 1 : hop / 32;
  return q % 8 == 0 ? 8 : q % 4 == 0 ? 4 : q % 2 == 0 ? 2 : 1;
}

__host__ inline bool hop_supported(int hop) {
  return hop == 8 || hop == 16 || (hop > 0 && hop % 32 == 0);
}

// Window (step, b, l, layer)'s kernel [KC, CO] and bias [CO] in the hoisted
// stacks km [N, B, L, layers*KC, CO] and lb [N, B, L, layers*CO].
struct Stack {
  const float* km;
  const float* lb;
  int B, L, layers, step, layer;

  __device__ const float* kernel(int b, int l) const {
    return km + (((size_t)step * B + b) * L + l) * ((size_t)layers * KC * CO) +
           (size_t)layer * KC * CO;
  }
  __device__ const float* bias(int b, int l) const {
    return lb + (((size_t)step * B + b) * L + l) * ((size_t)layers * CO) + (size_t)layer * CO;
  }
};

// Stage windows l0 .. l0+nwin-1 of batch row b into Ks [G][KC][CO] and
// lbs [G][CO] (16-byte aligned; each window's block is contiguous).
__device__ __forceinline__ void stage_windows(const Stack& s, int b, int l0, int nwin,
                                              float* Ks, float* lbs, int tid) {
  for (int w = 0; w < nwin; ++w) {
    const float4* src = reinterpret_cast<const float4*>(s.kernel(b, l0 + w));
    float4* dst = reinterpret_cast<float4*>(Ks + (size_t)w * KC * CO);
    for (int i = tid; i < KC * CO / 4; i += NT) dst[i] = src[i];
    const float* bsrc = s.bias(b, l0 + w);
    for (int i = tid; i < CO; i += NT) lbs[w * CO + i] = bsrc[i];
  }
}

// Accumulate the window product for M rows starting at block row rr0 (time
// t0 + rr0) against window g's staged kernel. ys row r holds time t0 - 1 + r,
// so tap d of row rr reads ys row rr + d.
template <int M>
__device__ __forceinline__ void window_rows(const float* ys, const float* Ks, const float* lbs,
                                            int g, int rr0, int pg, float (&ag)[M][4],
                                            float (&af)[M][4]) {
  const float4* K4 = reinterpret_cast<const float4*>(Ks + (size_t)g * KC * CO);
  const float* lb = lbs + g * CO;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ag[m][p] = lb[4 * pg + p];
      af[m][p] = lb[C + 4 * pg + p];
    }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float* yrow = ys + (rr0 + d) * LD;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 kg = K4[(d * C + c) * (CO / 4) + pg];
      const float4 kf = K4[(d * C + c) * (CO / 4) + C / 4 + pg];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float a = yrow[m * LD + c];
        ag[m][0] = fmaf(a, kg.x, ag[m][0]);
        ag[m][1] = fmaf(a, kg.y, ag[m][1]);
        ag[m][2] = fmaf(a, kg.z, ag[m][2]);
        ag[m][3] = fmaf(a, kg.w, ag[m][3]);
        af[m][0] = fmaf(a, kf.x, af[m][0]);
        af[m][1] = fmaf(a, kf.y, af[m][1]);
        af[m][2] = fmaf(a, kf.z, af[m][2]);
        af[m][3] = fmaf(a, kf.w, af[m][3]);
      }
    }
  }
}

}  // namespace lvcw
