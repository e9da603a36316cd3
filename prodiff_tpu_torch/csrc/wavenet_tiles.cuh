// What the WaveNet residual-stack kernels share: K1 (wavenet_stack.cu,
// inference) and K5 (wavenet_train.cu, training) both run this layer, and
// both start with the step projection of every layer in one launch. Their
// GEMM tiles are in tile_gemm.cuh.
//
// One layer l of the stack on x [B,T,C], cond [B,T,H]:
//   y    = x + (step . W_s[l] + b_s[l])              (zero outside [0, T))
//   z    = sum_q y[t+q-1] . W_d[l,q] + b_d[l] + cond . W_c[l] + b_c[l]
//   g    = sigmoid(z[:, :C]) * tanh(z[:, C:])
//   o    = g . W_o[l] + b_o[l]
//   x    = (x + o[:, :C]) / sqrt(2);   skip += o[:, C:]
// and the stack returns skip / sqrt(L).

#pragma once

#include <cuda_runtime.h>

namespace wavenet {

constexpr float RSQRT2 = 0.70710678118654752f;

constexpr int SP_COLS = 32, SP_WARPS = 8;

// sp[l, b, c] = b_s[l, c] + sum_k step[b, k] * W_s[l, k, c]. A block owns 32
// columns of one (layer, sequence); its 8 warps take a slice of k each (lane
// = column, so every load is one coalesced 128-byte row), and the partial
// sums are added in warp order.
__global__ void __launch_bounds__(SP_COLS * SP_WARPS)
step_proj_kernel(const float* __restrict__ step, const float* __restrict__ diffw,
                 const float* __restrict__ diffb, float* __restrict__ sp, int B, int C) {
  __shared__ float part[SP_WARPS][SP_COLS];
  const int l = blockIdx.x, b = blockIdx.y, c = blockIdx.z * SP_COLS + threadIdx.x % SP_COLS;
  const int warp = threadIdx.x / SP_COLS, k_per = C / SP_WARPS;
  const float* w = diffw + (size_t)l * C * C + c;
  const float* s = step + (size_t)b * C;
  float acc = 0.f;
#pragma unroll 8
  for (int k = warp * k_per; k < (warp + 1) * k_per; ++k) acc = fmaf(s[k], w[(size_t)k * C], acc);
  part[warp][threadIdx.x % SP_COLS] = acc;
  __syncthreads();
  if (warp == 0) {
    for (int i = 1; i < SP_WARPS; ++i) acc += part[i][threadIdx.x];
    sp[((size_t)l * B + b) * C + c] = acc + diffb[(size_t)l * C + c];
  }
}

// step_proj_kernel for every layer and sequence on `stream` (C % 32 == 0).
inline cudaError_t launch_step_proj(const float* step, const float* diffw, const float* diffb,
                                    float* sp, int B, int C, int L, cudaStream_t stream) {
  step_proj_kernel<<<dim3(L, B, C / SP_COLS), SP_COLS * SP_WARPS, 0, stream>>>(
      step, diffw, diffb, sp, B, C);
  return cudaGetLastError();
}

}  // namespace wavenet
