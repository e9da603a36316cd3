// Trainable WaveNet residual stack (K5) for Hopper: the save-forward and the
// sequential backward chain.
//
// Replaces the Pallas TPU kernels _fwd_save_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:71) and _bwd_chain_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:161). The weight, cond and step
// gradients stay outside any kernel, as cuBLAS products
// (ops/wavenet_train.py:stack_param_grads), as the JAX package leaves them
// to XLA einsums.
//
// Save-forward: K1's pair of kernels a layer (wavenet_tiles.cuh), with the
// gate kernel also writing the layer input x to xs[l] and the pre-gate z
// (after b_d + cond . W_c + b_c) to zs[l]. 1 + 2L launches, as K1.
//
// Backward chain, per layer l from L-1 down to 0, on the carry dx [B,T,C]
// (dL/dx at the layer's output; zero above the top layer):
//   chain_gate_kernel: dgate = do . W_o[l]^T with do = [dx / sqrt(2), g / sqrt(L)]
//     formed as the tile is staged (never stored); the epilogue reads z from
//     zs[l] and writes dz[l] = (dgate * tanh(zf) * a(1-a), dgate * a (1-tanh^2(zf)))
//     with a = sigmoid(zg), as the column pair (j, C+j);
//   chain_dy_kernel: dy_t = dz_t . W1^T + dz_{t+1} . W0^T + dz_{t-1} . W2^T
//     (the forward's taps z_t = y_{t-1} W0 + y_t W1 + y_{t+1} W2, mirrored;
//     dz is zero outside [0, T)) from one staged dz tile of BM+2 rows at three
//     row offsets; the epilogue writes dy[l] and updates the carry in place,
//     dx = dx / sqrt(2) + dy.
// 2L launches. After the last, dx holds dL/dx0.
//
// Layouts: zs [L,B,T,2C], dy [L,B,T,C], dz [B,T,L,2C] (so the cond gradient
// is one [B*T, L*2C] x [L*2C, H] product). g is the cotangent of skip/sqrt(L).
//
// What bounds it on the H100: float32 FMA throughput, as K1 (parity mode:
// float32 operands, TF32 off). At B=16, T=1536, C=256, L=20 the chain is
// 515 GFLOP (7.7 ms at 67 TFLOP/s) against ~3 GB of saved activations
// (under 1 ms at 3.35 TB/s). The tiles are plain shared-memory SGEMM like
// K1's; wgmma/TMA and bf16 saves are later work.

#include "wavenet_tiles.cuh"

namespace {

using wavenet::BK;
using wavenet::BM;
using wavenet::LDA;
using wavenet::NT;
using wavenet::RSQRT2;
using wavenet::TM;

constexpr int BN = 64;                // output columns per block
constexpr int TN = 4;                 // columns per thread, strided by BN / TN
constexpr int NTX = BN / TN;          // 16 thread columns
constexpr int LDB = BN + 1;           // padded row of the transposed-weight tile
static_assert((BM / TM) * NTX == NT, "one thread per (TM rows, TN columns)");

// Bs[kk][n] = w[(n0 + n) * ld + k0 + kk]: rows [k0, k0+BK) of w^T for the
// block's BN columns; threads walk k fastest, so the reads are coalesced.
__device__ __forceinline__ void load_wt(const float* __restrict__ w, int ld, int k0,
                                        int n0, float* Bs, int tid) {
  for (int idx = tid; idx < BK * BN; idx += NT) {
    const int kk = idx % BK, n = idx / BK;
    Bs[kk * LDB + n] = w[(size_t)(n0 + n) * ld + k0 + kk];
  }
}

__device__ __forceinline__ void tile_fma_t(const float* As, int shift, const float* Bs,
                                           int ty, int tx, float (&acc)[TM][TN]) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], bv[TN];
#pragma unroll
    for (int m = 0; m < TM; ++m) a[m] = As[(ty * TM + m + shift) * LDA + kk];
#pragma unroll
    for (int n = 0; n < TN; ++n) bv[n] = Bs[kk * LDB + tx + n * NTX];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
  }
}

// dz[b, t, l, (j, C+j)] from dgate[t, j] = sum_k do[t, k] W_o[j, k], k < 2C.
__global__ void __launch_bounds__(NT)
chain_gate_kernel(const float* __restrict__ dx, const float* __restrict__ g,
                  const float* __restrict__ zs, const float* __restrict__ ow,
                  float* __restrict__ dz, int T, int C, int L, int l, float inv_sqrt_l) {
  __shared__ float As[BM * LDA];
  __shared__ float Bs[BK * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / NTX, tx = tid % NTX;
  const size_t row0 = (size_t)b * T;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < 2 * C; k0 += BK) {
    __syncthreads();
    // a chunk lies wholly in one half of do, since C % BK == 0
    const bool res = k0 < C;
    const float* src = res ? dx : g;
    const float scale = res ? RSQRT2 : inv_sqrt_l;
    const int kc = res ? k0 : k0 - C;
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK, t = t0 + r;
      As[r * LDA + kk] = t < T ? src[(row0 + t) * C + kc + kk] * scale : 0.f;
    }
    load_wt(ow, 2 * C, k0, j0, Bs, tid);
    __syncthreads();
    tile_fma_t(As, 0, Bs, ty, tx, acc);
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
    const float* zrow = zs + (row0 + t) * 2 * C;
    float* dzrow = dz + ((row0 + t) * L + l) * 2 * C;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int j = j0 + tx + n * NTX;
      const float a = 1.f / (1.f + expf(-zrow[j]));
      const float tb = tanhf(zrow[C + j]);
      const float dg = acc[m][n];
      dzrow[j] = dg * tb * a * (1.f - a);
      dzrow[C + j] = dg * a * (1.f - tb * tb);
    }
  }
}

// dy[b, t, c] = sum_q sum_d dz[b, t+1-q, l, d] W_d[q][c, d];  dx = dx / sqrt(2) + dy.
__global__ void __launch_bounds__(NT)
chain_dy_kernel(const float* __restrict__ dz, const float* __restrict__ dw,
                float* __restrict__ dx, float* __restrict__ dy, int T, int C, int L, int l) {
  __shared__ float As[(BM + 2) * LDA];
  __shared__ float Bs[BK * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / NTX, tx = tid % NTX;
  const size_t row0 = (size_t)b * T;
  float acc[TM][TN] = {};
  // As row r holds dz at frame t0 - 1 + r; output row m, tap q reads row m + 2 - q
  for (int d0 = 0; d0 < 2 * C; d0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < (BM + 2) * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK, t = t0 - 1 + r;
      As[r * LDA + kk] = (t >= 0 && t < T) ? dz[((row0 + t) * L + l) * 2 * C + d0 + kk] : 0.f;
    }
    for (int q = 0; q < 3; ++q) {
      if (q > 0) __syncthreads();
      load_wt(dw + (size_t)q * C * 2 * C, 2 * C, d0, j0, Bs, tid);
      __syncthreads();
      tile_fma_t(As, 2 - q, Bs, ty, tx, acc);
    }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const size_t i = (row0 + t) * C + j0 + tx + n * NTX;
      const float v = acc[m][n];
      dy[i] = v;
      dx[i] = dx[i] * RSQRT2 + v;
    }
  }
}

}  // namespace

// K1's stack that also saves xs [L,B,T,C] (each layer's input) and zs
// [L,B,T,2C] (each layer's pre-gate). Other arguments as
// wavenet_residual_stack (wavenet_stack.cu). 1 + 2L launches.
extern "C" int wavenet_stack_save_forward(
    float* x, float* skip, float* gate, float* sp, float* xs, float* zs,
    const float* cond, const float* step, const float* dw, const float* db,
    const float* diffw, const float* diffb, const float* cw, const float* cb,
    const float* ow, const float* ob, int B, int T, int C, int H, int L, void* stream_ptr) {
  return wavenet::run_stack<true>(x, skip, gate, sp, xs, zs, cond, step, dw, db, diffw,
                                  diffb, cw, cb, ow, ob, B, T, C, H, L,
                                  (cudaStream_t)stream_ptr);
}

// The top-down chain. zs [L,B,T,2C] from the save-forward; g [B,T,C] the
// cotangent of skip/sqrt(L); dw [L,3,C,2C], ow [L,C,2C]; dx [B,T,C] zeroed by
// the caller, out: dL/dx0; dz [B,T,L,2C] and dy [L,B,T,C] out. 2L launches
// on `stream`; returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_stack_backward_chain(
    const float* zs, const float* g, const float* dw, const float* ow, float* dx,
    float* dz, float* dy, int B, int T, int C, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % BN != 0 || C % BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(C / BN, (T + BM - 1) / BM, B);
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  for (int l = L - 1; l >= 0; --l) {
    chain_gate_kernel<<<grid, NT, 0, stream>>>(
        dx, g, zs + (size_t)l * B * T * 2 * C, ow + (size_t)l * C * 2 * C, dz, T, C, L, l,
        inv_sqrt_l);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chain_dy_kernel<<<grid, NT, 0, stream>>>(
        dz, dw + (size_t)l * 3 * C * 2 * C, dx, dy + (size_t)l * B * T * C, T, C, L, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
