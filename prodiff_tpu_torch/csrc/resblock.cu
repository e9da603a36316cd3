// HiFiGAN ResBlock1 stage (mean over the stage's ResBlock1s) for Hopper.
//
// Replaces the Pallas TPU kernels resblock_group_packed
// (prodiff_tpu/ops/pallas/resblock.py:357, the C <= 128 stages on the packed
// [B, T/P, 128] lane layout) and resblock_group_streamed (:222, the C = 256
// stage with its weights streamed per conv). On Hopper neither reason for
// the split holds (there are no 128-lane registers to fill, and every conv's
// weights stream through shared memory anyway), so one entry serves any C in
// {8, 16, 32, 64, 128, 256}. C = 8 is the last stage of a HiFiGAN that
// starts at 128 channels (V2), which the TPU kernel runs at pack 16. It computes, on x [B, T, C]:
//   out = mean_j ResBlock1_j(x),   ResBlock1(h) = for each dilation d:
//         h = conv_k(leaky(conv_{k,d}(leaky(h)))) + h
// with leaky slope 0.1 and zero padding get_padding(k, d) at the true
// sequence ends (the TPU kernel re-zeroes its halo rows after every conv for
// the same effect). The standard stage is k = 3/7/11 x d = 1/3/5: 18 convs.
//
// What bounds it on the H100: float32 FMA throughput (parity mode keeps the
// tensor cores out): a stage at T_mel = 512 is 17-135 GFLOP (0.25-2.0 ms at
// 67 TFLOP/s) against 17-34 MB of activations a conv. The first port lost
// most of that to its inner loop (one scalar shared load per 4 FMAs, a
// barrier for every tap of every channel chunk, scalar global loads).
//
// Design: one register-tiled direct-conv kernel per conv (18 launches a
// stage). A block owns BM frames x BN output channels; each thread an FM x 8
// fragment (FM consecutive frames by two groups of 4 channels BN/2 apart,
// the weights read as float4s), so a tap is FM + 2 shared loads per 8*FM
// FMAs (10 per 64 at FM = 8). The input channels run in chunks of BK = 8:
// a chunk stages all k taps' weights ([k][BK][BN], by cp.async) and the
// frames the taps reach (BM + 2 pad rows, k-major, through registers, with
// the pre-activation leaky and the zeros outside [0, T) applied on the way),
// double-buffered (tile_gemm.cuh:run_chunks), one barrier a chunk. The tile
// per C, (BM, BN, FM) = (512, 8, 4) at C = 8, (512, 16, 4), (256, 32, 4),
// (256, 64, 8) at C = 64 and 128, (128, 64, 4) at C = 256, gives 128-512
// blocks of 8 warps a stage at T_mel = 512 (C = 8: 256 blocks of 4 warps at
// T = 131,072, one chunk of BK = 8 channels, its two channel groups 0-3 and
// 4-7 with the one column of threads); the 4-row fragments at C = 32 and 256
// spill less at the 128-register cap that two blocks an SM need. Epilogues: leaky (first conv
// of a unit), + residual (second conv, in place), or + residual accumulated
// into the stage mean (last unit of each ResBlock). k is 3, 7 or 11 (a template
// argument), and the halo (k - 1) / 2 * d at most MAX_PAD frames a side.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using tile::add4;
using tile::ld4;
using tile::st4;

constexpr int BK = 8;        // input channels a staged chunk
constexpr int MAX_PAD = 32;  // frames of halo a side: (k - 1) / 2 * d <= MAX_PAD
constexpr float SLOPE = 0.1f;

enum Epilogue { EPI_LEAKY = 0, EPI_RESID = 1, EPI_MEAN = 2 };

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}

template <int BM, int BN, int FM>
__host__ __device__ constexpr int threads() { return (BM / FM) * (BN / 8); }

// Row stride of the k-major activation tile: BM + 2 pad rows, float4-aligned.
__host__ __device__ constexpr int tile_lda(int rows) { return (rows + 3) / 4 * 4; }

// Floats of shared memory a block uses: double-buffered [K][BK][BN] weights
// and [BK][lda] activation tiles, and 4 floats of slack for the last
// float4 read of a d = 1 fragment.
template <int BM, int BN, int K>
constexpr size_t smem_floats(int pad) {
  return 2 * ((size_t)K * BK * BN + (size_t)BK * tile_lda(BM + 2 * pad)) + 4;
}

// dst[b, t, co] = epi(bias[co] + sum_{q, ci} act(in[b, t - pad + q*d, ci]) * w[q, ci, co])
// for BM frames x BN output channels a block; each thread an FM x 8 fragment
// (FM frames, two groups of 4 channels BN/2 apart). With DIL1 (d = 1) the
// taps' rows overlap: a thread reads its FM + K - 1 rows once a k step, as
// float4s, for all K taps.
template <int BM, int BN, int FM, int K, bool DIL1>
__global__ void __launch_bounds__((BM / FM) * (BN / 8), 512 / ((BM / FM) * (BN / 8)))
conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ bias, const float* res, float* dst,
            int T, int C, int d, int pre_leaky, int epi, int first, int last, float n_res) {
  constexpr int NT = threads<BM, BN, FM>(), NTX = BN / 8;
  constexpr int MAX_ROWS = DIL1 ? BM + K - 1 : BM + 2 * MAX_PAD;
  constexpr int NA = tile::ceil_div(MAX_ROWS * BK / 4, NT);  // A float4s a thread
  constexpr int NB = K * BK * BN / 4;                                   // B float4s a chunk
  extern __shared__ float4 smem4[];
  const int pad = (K - 1) / 2 * d, rows = BM + 2 * pad, lda = tile_lda(rows);
  float* Bs[2] = {reinterpret_cast<float*>(smem4), reinterpret_cast<float*>(smem4) + K * BK * BN};
  float* As[2] = {Bs[1] + K * BK * BN, Bs[1] + K * BK * BN + BK * lda};
  const int b = blockIdx.z, t0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const float* inb = in + (size_t)b * T * C;

  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
    for (int f = tid; f < NB; f += NT) {
      const int q = f / (BK * BN / 4), k = f / (BN / 4) % BK, n = f % (BN / 4) * 4;
      tile::cp_async16(Bs[buf] + f * 4, w + ((size_t)q * C + i * BK + k) * C + n0 + n, true);
    }
    tile::cp_async_commit();
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, t = t0 - pad + r;
      ra[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && t >= 0 && t < T) {
        ra[s] = ld4(inb + (size_t)t * C + i * BK + (e & 1) * 4);
        if (pre_leaky) ra[s] = leaky4(ra[s]);
      }
    }
  };
  auto put = [&](int buf, int) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, k = (e & 1) * 4;
      if (r >= rows) continue;
      float* a = As[buf] + k * lda + r;
      a[0] = ra[s].x;
      a[lda] = ra[s].y;
      a[2 * lda] = ra[s].z;
      a[3 * lda] = ra[s].w;
    }
  };
  float acc[FM][8] = {};
  auto mac = [&](int buf, int) {
    const float* As_ = As[buf] + ty * FM;
    const float* Bs_ = Bs[buf] + tx * 4;
#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      constexpr int NR = DIL1 ? tile_lda(FM + K - 1) : 1;
      float rowv[NR];
      if constexpr (DIL1) {
#pragma unroll
        for (int i = 0; i < NR; i += 4) {
          const float4 v = ld4(As_ + k * lda + i);
          rowv[i] = v.x; rowv[i + 1] = v.y; rowv[i + 2] = v.z; rowv[i + 3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        float a[FM];
#pragma unroll
        for (int m = 0; m < FM; ++m) {
          if constexpr (DIL1)
            a[m] = rowv[q + m];
          else
            a[m] = As_[k * lda + q * d + m];
        }
        const float* br = Bs_ + (q * BK + k) * BN;
        const float4 b0 = ld4(br), b1 = ld4(br + BN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < FM; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
      }
    }
  };
  tile::run_chunks(C / BK, fetch, put, mac);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = n0 + h * (BN / 2) + tx * 4;
    const float4 bv = ld4(bias + co);
#pragma unroll
    for (int m = 0; m < FM; ++m) {
      const int t = t0 + ty * FM + m;
      if (t >= T) break;
      const size_t i = ((size_t)b * T + t) * C + co;
      float4 v = add4(make_float4(acc[m][h * 4], acc[m][h * 4 + 1], acc[m][h * 4 + 2],
                                  acc[m][h * 4 + 3]), bv);
      if (epi == EPI_LEAKY) {
        v = leaky4(v);
      } else {
        v = add4(v, ld4(res + i));
        if (epi == EPI_MEAN) {
          if (!first) v = add4(ld4(dst + i), v);
          if (last) v = make_float4(v.x / n_res, v.y / n_res, v.z / n_res, v.w / n_res);
        }
      }
      st4(dst + i, v);
    }
  }
}

template <int BM, int BN, int FM, int K, bool DIL1>
int launch_conv(const float* in, const float* w, const float* bias, const float* res,
                float* dst, int B, int T, int C, int d, int pre_leaky, int epi, int first,
                int last, float n_res, cudaStream_t stream) {
  // the largest smem this instantiation takes, allowed once a device
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    const size_t most = smem_floats<BM, BN, K>(DIL1 ? (K - 1) / 2 : MAX_PAD) * sizeof(float);
    e = cudaFuncSetAttribute(conv_kernel<BM, BN, FM, K, DIL1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  const int pad = (K - 1) / 2 * d;
  const size_t smem = smem_floats<BM, BN, K>(pad) * sizeof(float);
  const dim3 grid(C / BN, (T + BM - 1) / BM, B);
  conv_kernel<BM, BN, FM, K, DIL1><<<grid, threads<BM, BN, FM>(), smem, stream>>>(
      in, w, bias, res, dst, T, C, d, pre_leaky, epi, first, last, n_res);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int FM>
int conv_k(const float* in, const float* w, const float* bias, const float* res, float* dst,
           int B, int T, int C, int k, int d, int pre_leaky, int epi, int first, int last,
           float n_res, cudaStream_t stream) {
  switch (k * 2 + (d == 1)) {
#define RESBLOCK_CASE(K, DIL1)                                                                  \
  case K * 2 + DIL1:                                                                            \
    return launch_conv<BM, BN, FM, K, DIL1>(in, w, bias, res, dst, B, T, C, d, pre_leaky, epi, \
                                            first, last, n_res, stream);
    RESBLOCK_CASE(3, false) RESBLOCK_CASE(3, true) RESBLOCK_CASE(7, false)
    RESBLOCK_CASE(7, true) RESBLOCK_CASE(11, false) RESBLOCK_CASE(11, true)
#undef RESBLOCK_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile for each C: (BM frames, BN channels, FM frames a thread).
int conv(const float* in, const float* w, const float* bias, const float* res, float* dst,
         int B, int T, int C, int k, int d, int pre_leaky, int epi, int first, int last,
         float n_res, cudaStream_t stream) {
  if (C == 8)
    return conv_k<512, 8, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last,
                             n_res, stream);
  if (C == 16)
    return conv_k<512, 16, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first,
                              last, n_res, stream);
  if (C == 32)
    return conv_k<256, 32, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first,
                              last, n_res, stream);
  if (C <= 128)
    return conv_k<256, 64, 8>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first,
                              last, n_res, stream);
  return conv_k<128, 64, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last,
                           n_res, stream);
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
  if (B < 1 || T < 1 || n_res < 1 || !(C == 8 || C == 16 || C == 32 || C % 64 == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  size_t woff = 0;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    const int k = ksizes[j];
    const float* hin = x;
    for (int u = 0; u < nunits[j]; ++u) {
      const int d = dils[di++];
      if ((k - 1) / 2 * d > MAX_PAD) return (int)cudaErrorInvalidValue;
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
