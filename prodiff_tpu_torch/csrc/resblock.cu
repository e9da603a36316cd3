// HiFiGAN ResBlock1 stage (mean over the stage's ResBlock1s) for Hopper.
//
// Replaces the Pallas TPU kernels resblock_group_packed
// (prodiff_tpu/ops/pallas/resblock.py:357, the C <= 128 stages on the packed
// [B, T/P, 128] lane layout) and resblock_group_streamed (:222, the C = 256
// stage with its weights streamed per conv). On Hopper neither reason for
// the split holds (there are no 128-lane registers to fill, and every conv's
// weights stream through shared memory anyway), so one entry serves any C in
// {16, 32, 64, 128, 256}. It computes, on x [B, T, C]:
//   out = mean_j ResBlock1_j(x),   ResBlock1(h) = for each dilation d:
//         h = conv_k(leaky(conv_{k,d}(leaky(h)))) + h
// with leaky slope 0.1 and zero padding get_padding(k, d) at the true
// sequence ends (the TPU kernel re-zeroes its halo rows after every conv for
// the same effect). The standard stage is k = 3/7/11 x d = 1/3/5: 18 convs.
//
// What bounds it on the H100: float32 FMA throughput (parity mode keeps the
// tensor cores out): a k=11 conv at C=256 is 1.4 MFLOP per frame against
// 2.9 MB of taps; the C=16 stages are as many FLOPs spread over 64x the rows.
//
// Design: one fused direct-conv kernel per conv (18 launches per stage).
// A block owns BM frames x BN output channels. For each input-channel chunk
// it stages the frames its taps reach (BM + 2*pad rows) once, applying the
// optional pre-activation leaky and the sequence-end zeros on the way into
// shared memory, then walks the k taps against that one tile while each
// tap's [BK, BN] weight slice streams through shared memory (that streaming
// is all that is left of K3's reason to exist). Epilogues: leaky (first conv
// of a unit), + residual (second conv, in place), or + residual accumulated
// into the stage mean (last unit of each ResBlock). Tile shapes per C keep
// 256 threads at 4x4 outputs each: (BM, BN) = (64, 64), (128, 32), (256, 16).

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;  // input channels per staged chunk
constexpr int TM = 4;   // frames per thread
constexpr int TN = 4;   // output channels per thread
constexpr int NT = 256;
constexpr int LDA = BK + 1;
constexpr float SLOPE = 0.1f;

enum Epilogue { EPI_LEAKY = 0, EPI_RESID = 1, EPI_MEAN = 2 };

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

// dst[b, t, co] = epi(bias[co] + sum_{q, ci} act(in[b, t - pad + q*d, ci]) * w[q, ci, co])
template <int BM, int BN>
__global__ void __launch_bounds__(NT)
conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ bias, const float* res, float* dst,
            int T, int C, int k, int d, int pre_leaky, int epi, int first,
            int last, float n_res) {
  static_assert((BM / TM) * (BN / TN) == NT, "tile/thread mismatch");
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [BK][BN], 16-byte aligned
  float* As = Bs + BK * BN;                     // [BM + 2*pad][LDA]
  const int pad = (k - 1) / 2 * d;
  const int rows = BM + 2 * pad;
  const int b = blockIdx.z, t0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const float* inb = in + (size_t)b * T * C;
  float acc[TM][TN] = {};

  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < rows * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK, t = t0 - pad + r;
      float v = 0.f;
      if (t >= 0 && t < T) {
        v = inb[(size_t)t * C + c0 + c];
        if (pre_leaky) v = leaky(v);
      }
      As[r * LDA + c] = v;
    }
    for (int q = 0; q < k; ++q) {
      if (q > 0) __syncthreads();
      const float* wq = w + ((size_t)q * C + c0) * C + n0;
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx / BN, n = idx % BN;
        Bs[idx] = wq[(size_t)kk * C + n];
      }
      __syncthreads();
      const float* Aq = As + (ty * TM + q * d) * LDA;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = Aq[m * LDA + kk];
        const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * TN);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[m][0] = fmaf(a[m], bv.x, acc[m][0]);
          acc[m][1] = fmaf(a[m], bv.y, acc[m][1]);
          acc[m][2] = fmaf(a[m], bv.z, acc[m][2]);
          acc[m][3] = fmaf(a[m], bv.w, acc[m][3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
    const size_t row = ((size_t)b * T + t) * C;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int co = n0 + tx * TN + n;
      float v = acc[m][n] + bias[co];
      if (epi == EPI_LEAKY) {
        v = leaky(v);
      } else {
        v = v + res[row + co];
        if (epi == EPI_MEAN) {
          if (!first) v = dst[row + co] + v;
          if (last) v = v / n_res;
        }
      }
      dst[row + co] = v;
    }
  }
}

template <int BM, int BN>
int launch_conv(const float* in, const float* w, const float* bias,
                const float* res, float* dst, int B, int T, int C, int k, int d,
                int pre_leaky, int epi, int first, int last, float n_res,
                cudaStream_t stream) {
  const int pad = (k - 1) / 2 * d;
  const size_t smem = ((size_t)BK * BN + (size_t)(BM + 2 * pad) * LDA) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(C / BN, (T + BM - 1) / BM, B);
  conv_kernel<BM, BN><<<grid, NT, smem, stream>>>(
      in, w, bias, res, dst, T, C, k, d, pre_leaky, epi, first, last, n_res);
  return (int)cudaGetLastError();
}

int conv(const float* in, const float* w, const float* bias, const float* res,
         float* dst, int B, int T, int C, int k, int d, int pre_leaky, int epi,
         int first, int last, float n_res, cudaStream_t stream) {
  if (C % 64 == 0)
    return launch_conv<64, 64>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky,
                               epi, first, last, n_res, stream);
  if (C == 32)
    return launch_conv<128, 32>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky,
                                epi, first, last, n_res, stream);
  return launch_conv<256, 16>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky,
                              epi, first, last, n_res, stream);
}

}  // namespace

// x: [B,T,C] input (read only); out: [B,T,C] the stage mean; h, tmp: [B,T,C]
// scratch. w: the stage's convs in (resblock, unit, conv1/conv2) order, each
// [k, C, C] (tap, in, out); bias: [n_convs, C]. ksizes[j] / nunits[j] give
// resblock j's kernel size and unit count, dils the units' dilations in
// order. Launches 2 * sum(nunits) kernels on `stream`; returns the first
// launch error (cudaError_t) or 0.
extern "C" int resblock_stage(const float* x, float* out, float* h, float* tmp,
                              const float* w, const float* bias,
                              const int* ksizes, const int* nunits,
                              const int* dils, int n_res, int B, int T, int C,
                              void* stream_ptr) {
  if (B < 1 || T < 1 || n_res < 1 || !(C == 16 || C == 32 || C % 64 == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  size_t woff = 0;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    const int k = ksizes[j];
    const float* hin = x;
    for (int u = 0; u < nunits[j]; ++u) {
      const int d = dils[di++];
      int err = conv(hin, w + woff, bias + (size_t)ci * C, nullptr, tmp, B, T, C,
                     k, d, 1, EPI_LEAKY, 0, 0, 1.f, stream);
      if (err) return err;
      woff += (size_t)k * C * C;
      ++ci;
      const bool last_unit = u + 1 == nunits[j];
      err = conv(tmp, w + woff, bias + (size_t)ci * C, hin, last_unit ? out : h, B,
                 T, C, k, 1, 0, last_unit ? EPI_MEAN : EPI_RESID, j == 0,
                 j == n_res - 1, (float)n_res, stream);
      if (err) return err;
      woff += (size_t)k * C * C;
      ++ci;
      hin = h;
    }
  }
  return 0;
}
