// The constants of FastDiff's location-variable convolution (LVC) and the
// view of the hoisted window-kernel stack (Stack), shared by the LVC kernel
// (lvc.cu, K6) and the fused LVC-layer kernels' tiles (lvc_tiles.cuh: K4,
// K7).
//
// FastDiff's LVC: for output time t in hop window l,
//   y[t, :] = bias[l, :] + sum_{d<3, c<C} y_in[t - 1 + d, c] * K[l][d*C + c, :]
// with y_in zero outside [0, T). Kernel rows are tap-major (d = 0 is time
// t-1), as the KernelPredictor emits them. C = 32 input channels and
// CO = 2C = 64 outputs (gate | filter) are fixed: FastDiff's inner width.

#pragma once

#include <cuda_runtime.h>

namespace lvcw {

constexpr int C = 32;
constexpr int CO = 2 * C;
constexpr int KC = 3 * C;
constexpr int NT = 256;
constexpr int MAX_SMEM = 232448;

// The hops of K6 (lvc.cu) and of K4 (lvc_tiles.cuh's units): every multiple
// of 8, as lvc_pallas. Each 8-row tile of a unit then lies in one window.
// K4 also takes the multiples of 4 from hop 64 on
// (lvc_tiles.cuh:layer_hop_supported); K7 keeps its own gate (hop >= 64 and
// a multiple of 32, ublock_block.cu).
__host__ inline bool hop_supported(int hop) { return hop >= 8 && hop % 8 == 0; }

// Window (step, b, l, layer)'s kernel [KC, CO] and bias [CO] in the hoisted
// stacks km [N, B, L, layers*KC, CO] (window elements W: float, or bf16 in
// K4's and K7's bf16 builds) and lb [N, B, L, layers*CO] (float).
template <class W>
struct StackT {
  const W* km;
  const float* lb;
  int B, L, layers, step, layer;

  __device__ const W* kernel(int b, int l) const {
    return km + (((size_t)step * B + b) * L + l) * ((size_t)layers * KC * CO) +
           (size_t)layer * KC * CO;
  }
  __device__ const float* bias(int b, int l) const {
    return lb + (((size_t)step * B + b) * L + l) * ((size_t)layers * CO) + (size_t)layer * CO;
  }
};

using Stack = StackT<float>;

}  // namespace lvcw
