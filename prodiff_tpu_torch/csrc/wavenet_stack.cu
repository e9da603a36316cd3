// WaveNet residual stack (the 20-layer diffusion denoiser loop) for Hopper.
//
// Replaces the Pallas TPU kernels fused_residual_stack
// (prodiff_tpu/ops/pallas/wavenet.py:177) and fused_residual_stack_tiled
// (prodiff_tpu/ops/pallas/wavenet.py:261); the layer body they share is
// _wavenet_layer_step (:124). Per layer l, on x [B,T,C], cond [B,T,H]:
//   y    = x + (step . W_s[l] + b_s[l])              (zero outside [0, T))
//   z    = sum_q y[t+q-1] . W_d[l,q] + b_d[l] + cond . W_c[l] + b_c[l]
//   g    = sigmoid(z[:, :C]) * tanh(z[:, C:])
//   o    = g . W_o[l] + b_o[l]
//   x    = (x + o[:, :C]) / sqrt(2);   skip += o[:, C:]
// and the stack returns skip / sqrt(L).
//
// What bounds it on the H100: float32 FMA throughput. In parity mode the
// operands are float32 and TF32 is off, so the tensor cores are out; at
// T=512, C=H=256 a layer is 0.67 GFLOP against 2.6 MB of weights, which
// the 50 MB L2 serves to every row tile.
//
// Design: the TPU kernel keeps x and skip in VMEM for the whole stack; one
// float32 [512, 256] carry is 512 KiB, more than the 227 KB of shared memory a
// block can have, so here the layer loop is a host loop and x/skip stay in
// device memory (L2-resident at B=1, T=512). Per layer two kernels:
//   gate_kernel: a row tile x 32 column PAIRS (j, C+j) per block, so the
//     gate is formed in registers in the epilogue and z never reaches memory;
//     the step projection and the sequence-end zero padding are applied as
//     the activation tile is staged into shared memory; the k=3 taps reuse one
//     staged tile (BM+2 rows) at three row offsets;
//   out_kernel: the output projection with the residual/skip update fused in
//     its epilogue (pairs (j, C+j) again), updating x and skip in place.
// One step_proj_kernel per stack computes W_s[l] . step for every layer
// first. Launches per stack: 1 + 2L. Tiles are plain shared-memory SGEMM;
// wgmma/TMA and a halo-tiled whole-stack kernel are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;  // frames per block
constexpr int BP = 32;  // column pairs per block
constexpr int BK = 32;  // reduction chunk
constexpr int TM = 4;   // frames per thread
constexpr int TP = 2;   // pairs per thread
constexpr int NT = (BM / TM) * (BP / TP);  // 128 threads
constexpr int LDA = BK + 1;                // padded row of the activation tile
constexpr float RSQRT2 = 0.70710678118654752f;

// sp[l, b, c] = b_s[l, c] + sum_k step[b, k] * W_s[l, k, c]
__global__ void step_proj_kernel(const float* __restrict__ step,
                                 const float* __restrict__ diffw,
                                 const float* __restrict__ diffb,
                                 float* __restrict__ sp, int B, int C) {
  const int l = blockIdx.x, b = blockIdx.y;
  const float* w = diffw + (size_t)l * C * C;
  const float* s = step + (size_t)b * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc = fmaf(s[k], w[(size_t)k * C + c], acc);
    sp[((size_t)l * B + b) * C + c] = acc + diffb[(size_t)l * C + c];
  }
}

// Stage rows [k0, k0+BK) of a [K, 2C] weight, columns j0.. and C+j0.. of
// the block's pairs, into Bs [BK][2*BP].
__device__ __forceinline__ void load_pair_cols(const float* __restrict__ w, int C,
                                               int k0, int j0, float* Bs, int tid) {
  for (int idx = tid; idx < BK * 2 * BP; idx += NT) {
    const int r = idx / (2 * BP), col = idx % (2 * BP);
    const int gc = col < BP ? j0 + col : C + j0 + col - BP;
    Bs[idx] = w[(size_t)(k0 + r) * 2 * C + gc];
  }
}

__device__ __forceinline__ void tile_fma(const float* As, int shift, const float* Bs,
                                         int ty, int tx, float (&acc1)[TM][TP],
                                         float (&acc2)[TM][TP]) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b1[TP], b2[TP];
#pragma unroll
    for (int m = 0; m < TM; ++m) a[m] = As[(ty * TM + m + shift) * LDA + kk];
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      b1[p] = Bs[kk * 2 * BP + tx * TP + p];
      b2[p] = Bs[kk * 2 * BP + BP + tx * TP + p];
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        acc1[m][p] = fmaf(a[m], b1[p], acc1[m][p]);
        acc2[m][p] = fmaf(a[m], b2[p], acc2[m][p]);
      }
  }
}

// gate[b, t, j] = sigmoid(z[t, j]) * tanh(z[t, C+j]) for one layer.
__global__ void __launch_bounds__(NT)
gate_kernel(const float* __restrict__ x, const float* __restrict__ sp,
            const float* __restrict__ cond, const float* __restrict__ dw,
            const float* __restrict__ db, const float* __restrict__ cw,
            const float* __restrict__ cb, float* __restrict__ gate,
            int T, int C, int H) {
  __shared__ float As[(BM + 2) * LDA];
  __shared__ float Bs[BK * 2 * BP];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BP;
  const int tid = threadIdx.x, ty = tid / (BP / TP), tx = tid % (BP / TP);
  const float* xb = x + (size_t)b * T * C;
  const float* spb = sp + (size_t)b * C;
  const float* cdb = cond + (size_t)b * T * H;
  float acc1[TM][TP] = {}, acc2[TM][TP] = {};

  // dilated conv (k=3, d=1): As row r holds frame t0 - 1 + r
  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < (BM + 2) * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK, t = t0 - 1 + r;
      As[r * LDA + c] = (t >= 0 && t < T) ? xb[(size_t)t * C + c0 + c] + spb[c0 + c] : 0.f;
    }
    for (int q = 0; q < 3; ++q) {
      if (q > 0) __syncthreads();
      load_pair_cols(dw + (size_t)q * C * 2 * C, C, c0, j0, Bs, tid);
      __syncthreads();
      tile_fma(As, q, Bs, ty, tx, acc1, acc2);
    }
  }
  // conditioner projection: rows 1..BM hold frames t0..t0+BM-1
  for (int h0 = 0; h0 < H; h0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK, t = t0 + r;
      As[(r + 1) * LDA + c] = t < T ? cdb[(size_t)t * H + h0 + c] : 0.f;
    }
    load_pair_cols(cw, C, h0, j0, Bs, tid);
    __syncthreads();
    tile_fma(As, 1, Bs, ty, tx, acc1, acc2);
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const int j = j0 + tx * TP + p;
      const float zg = acc1[m][p] + db[j] + cb[j];
      const float zf = acc2[m][p] + db[C + j] + cb[C + j];
      gate[((size_t)b * T + t) * C + j] = (1.f / (1.f + expf(-zg))) * tanhf(zf);
    }
  }
}

// o = gate . W_o + b_o;  x = (x + o[:, :C]) / sqrt(2);  skip = (skip + o[:, C:]) * scale
__global__ void __launch_bounds__(NT)
out_kernel(const float* __restrict__ gate, const float* __restrict__ ow,
           const float* __restrict__ ob, float* __restrict__ x,
           float* __restrict__ skip, int T, int C, int first, float skip_scale) {
  __shared__ float As[(BM + 2) * LDA];
  __shared__ float Bs[BK * 2 * BP];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BP;
  const int tid = threadIdx.x, ty = tid / (BP / TP), tx = tid % (BP / TP);
  const float* gb = gate + (size_t)b * T * C;
  float acc1[TM][TP] = {}, acc2[TM][TP] = {};
  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK, t = t0 + r;
      As[r * LDA + c] = t < T ? gb[(size_t)t * C + c0 + c] : 0.f;
    }
    load_pair_cols(ow, C, c0, j0, Bs, tid);
    __syncthreads();
    tile_fma(As, 0, Bs, ty, tx, acc1, acc2);
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const int j = j0 + tx * TP + p;
      const size_t i = ((size_t)b * T + t) * C + j;
      x[i] = (x[i] + (acc1[m][p] + ob[j])) * RSQRT2;
      const float s = acc2[m][p] + ob[C + j];
      skip[i] = (first ? s : skip[i] + s) * skip_scale;
    }
  }
}

}  // namespace

// x: [B,T,C] in: x0, out: the last layer's residual (scratch for the caller);
// skip: [B,T,C] out: skip / sqrt(L); gate: [B,T,C] scratch; sp: [L,B,C] scratch.
// Weights stacked over layers: dw [L,3,C,2C], db [L,2C], diffw [L,C,C],
// diffb [L,C], cw [L,H,2C], cb [L,2C], ow [L,C,2C], ob [L,2C]. Launches 1 + 2L
// kernels on `stream`; returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_residual_stack(
    float* x, float* skip, float* gate, float* sp, const float* cond,
    const float* step, const float* dw, const float* db, const float* diffw,
    const float* diffb, const float* cw, const float* cb, const float* ow,
    const float* ob, int B, int T, int C, int H, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % BP != 0 || C % BK != 0 || H % BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  step_proj_kernel<<<dim3(L, B), C < 1024 ? C : 1024, 0, stream>>>(step, diffw, diffb, sp, B, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C / BP, (T + BM - 1) / BM, B);
  const float last_scale = (float)(1.0 / sqrt((double)L));
  for (int l = 0; l < L; ++l) {
    gate_kernel<<<grid, NT, 0, stream>>>(
        x, sp + (size_t)l * B * C, cond, dw + (size_t)l * 3 * C * 2 * C,
        db + (size_t)l * 2 * C, cw + (size_t)l * H * 2 * C, cb + (size_t)l * 2 * C,
        gate, T, C, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    out_kernel<<<grid, NT, 0, stream>>>(
        gate, ow + (size_t)l * C * 2 * C, ob + (size_t)l * 2 * C, x, skip, T, C,
        l == 0, l == L - 1 ? last_scale : 1.f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
