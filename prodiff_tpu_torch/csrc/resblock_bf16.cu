// HiFiGAN ResBlock1 stage with bf16 tap stacks, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernels resblock_group_packed
// (prodiff_tpu/ops/pallas/resblock.py:357) and resblock_group_streamed
// (:222) as the JAX package runs them on its accelerator: with the tap
// stacks of prepare_resblock_stage(dtype=bfloat16) (:76), which NSF-HiFiGAN's
// nsf_fused_res_dtype "auto" selects there. It computes resblock.cu's
// function, on x [B, T, C]:
//   out = mean_j ResBlock1_j(x),   ResBlock1(h) = for each dilation d:
//         h = conv_k(leaky(conv_{k,d}(leaky(h)))) + h
// at the Pallas kernel's rounding points (_stage_walk, :147): each conv's
// input is leaky'd in float32 and then rounded to bf16 (yb =
// y.astype(wdtype)); the taps are bf16; each product of two bf16 values
// accumulates in float32; the bias, the leaky epilogue, the residual, the
// stage mean and the activations between convs stay float32. Zero padding
// get_padding(k, d) at the true sequence ends (the TPU kernel re-zeroes its
// halo rows after each conv).
//
// What bounds it on the H100: the bf16 tensor cores. A stage at T_mel = 512
// and the base config (C = 256 ... 16, 126 taps a stage) is 2 * 126 * T *
// C^2 a stage, 321 GFLOP for the five (0.325 ms at 989 TFLOP/s), against
// 17-34 MB of float32 activations a conv.
//
// Design: a direct conv as a tensor-core GEMM, one launch per conv (18 a
// stage, as resblock.cu). A block owns BM frames x BN output channels, its
// warps WM x WN tiles of MT 16-row by NT 8-column mma.sync m16n8k16 tiles
// (mma_bf16.cuh). The input channels run in chunks of BK = 16 (one k step):
// a chunk stages all K taps' weights ([K][BK][BN] bf16, by cp.async) and the
// BM + 2 pad frames the taps reach ([rows][BK] bf16, through registers,
// where the pre-activation leaky, the zeros outside [0, T) and the rounding
// to bf16 are applied), double-buffered (mma::run_stages), one barrier a
// chunk. Tap q of a dilated conv is the A tile read q * d rows further
// down, so the K taps share one staged tile. Both tiles are padded by 8
// bf16 a row, so ldmatrix reads them without bank conflicts. Epilogues as
// resblock.cu: leaky (first conv of a unit), + residual (second conv, in
// place), + residual into the stage mean (last unit of each ResBlock). The
// tile by C: (BM, BN) = (256, 16), (256, 32), (128, 64) at C >= 64. k is 3,
// 7 or 11 (a template argument), the halo (k - 1) / 2 * d at most MAX_PAD
// frames a side. wgmma, TMA and fusing a unit's two convs are later work.
//
// C = 8 (the last stage of a HiFiGAN that starts at 128 channels, which the
// TPU kernel runs at pack 16) has a kernel of its own, conv_kernel_c8: a tap
// of a C = 8 conv reduces over 8 input channels, half of an m16n8k16 k step.
// It PAIRS TWO TAPS in one k step rather than zero-padding the staged tile
// to 16 channels: k 0-7 are tap 2p's channels and k 8-15 tap 2p+1's. The A
// fragment's second half (the ldmatrix.x4 addresses of lanes 16-31) reads
// the staged rows d further down, the B fragment's rows 8-15 hold tap
// 2p+1's weights, and an odd k's last pair has a zero second tap (its A
// lanes reread tap 2p's rows: finite values times zero weights). So a
// 16-row tile takes ceil(k / 2) mma, 2/4/6 at k = 3/7/11, where zero-padding
// would take k mma with half of each wasted. The staged rows are 8 bf16 (16
// bytes) with no padding: the 8 rows of an ldmatrix phase are 128
// contiguous bytes, in distinct banks. One chunk holds all 8 input
// channels, so nothing is double-buffered; each lane builds its B fragments
// once from global memory (at most 6 pairs, 12 registers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using mma::bf16;

constexpr int BK = 16;       // input channels a staged chunk: one mma k step
constexpr int MAX_PAD = 32;  // frames of halo a side: (k - 1) / 2 * d <= MAX_PAD
constexpr int LDA = BK + mma::PAD;
constexpr float SLOPE = 0.1f;

enum Epilogue { EPI_LEAKY = 0, EPI_RESID = 1, EPI_MEAN = 2 };

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

// A block's tile: WM x WN warps, each MT x NT mma tiles.
template <int WM, int WN, int MT, int NT>
struct Tile {
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8, THREADS = WM * WN * 32;
  static constexpr int LDB = BN + mma::PAD;
};

// Bytes of shared memory a block uses at halo `pad`: double-buffered
// [K][BK][LDB] weights and [BM + 2 pad][LDA] activations.
template <class TL, int K>
__host__ __device__ constexpr size_t smem_bytes(int pad) {
  return 2 * ((size_t)K * BK * TL::LDB + (size_t)(TL::BM + 2 * pad) * LDA) * sizeof(bf16);
}

// dst[b, t, co] = epi(bias[co] + sum_{q, ci} bf16(act(in[b, t - pad + q d, ci])) w[q, ci, co])
template <int WM, int WN, int MT, int NT, int K>
__global__ void __launch_bounds__(WM * WN * 32)
conv_kernel(const float* __restrict__ in, const bf16* __restrict__ w,
            const float* __restrict__ bias, const float* res, float* dst, int T, int C, int d,
            int pre_leaky, int epi, int first, int last, float n_res) {
  using TL = Tile<WM, WN, MT, NT>;
  constexpr int BM = TL::BM, BN = TL::BN, NTH = TL::THREADS, LDB = TL::LDB;
  constexpr int TAPS = BK * LDB;                                  // a tap's staged weights
  constexpr int NB = K * BK * BN / 8;                             // 16-byte copies a chunk
  constexpr int NA = mma::ceil_div((BM + 2 * MAX_PAD) * (BK / 4), NTH);  // A float4s a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int pad = (K - 1) / 2 * d, rows = BM + 2 * pad;
  bf16* Bs[2] = {smem, smem + K * TAPS};
  bf16* As[2] = {smem + 2 * K * TAPS, smem + 2 * K * TAPS + rows * LDA};
  const int b = blockIdx.z, t0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp % WM * MT * 16;
  int ncol[NT];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) ncol[ni] = warp / WM * NT * 8 + ni * 8;
  const float* inb = in + (size_t)b * T * C;

  uint2 ra[NA];
  auto fetch = [&](int buf, int i) {
    for (int f = tid; f < NB; f += NTH) {
      const int q = f / (BK * BN / 8), k = f / (BN / 8) % BK, n = f % (BN / 8) * 8;
      mma::cp_async16(Bs[buf] + q * TAPS + k * LDB + n,
                      w + ((size_t)q * C + i * BK + k) * C + n0 + n, true);
    }
    mma::cp_async_commit();
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NTH, r = e >> 2, t = t0 - pad + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && t >= 0 && t < T) {
        v = mma::ld4(inb + (size_t)t * C + i * BK + (e & 3) * 4);
        if (pre_leaky) v = make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
      }
      ra[s] = mma::pack4(v);
    }
  };
  auto put = [&](int buf, int) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NTH, r = e >> 2;
      if (r < rows) *reinterpret_cast<uint2*>(As[buf] + r * LDA + (e & 3) * 4) = ra[s];
    }
  };
  float acc[MT][NT][4] = {};
  const int arow = lane & 15, akof = (lane >> 4) * 8;  // ldmatrix.x4 of A
  const int bk = lane & 15, bhalf = lane >> 4;         // ldmatrix.x4.trans of B
  auto mac = [&](int buf, int) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        mma::ldsm_x4_trans(r, Bs[buf] + q * TAPS + bk * LDB + ncol[2 * np + bhalf]);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        mma::ldsm_x4(a, As[buf] + (row0 + 16 * mi + q * d + arow) * LDA + akof);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma::mma16816(acc[mi][ni], a, bfr[ni][0], bfr[ni][1]);
      }
    }
  };
  mma::run_stages(C / BK, fetch, put, mac);

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + row0 + mma::frag_row(mi, half);
      if (t >= T) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int co = n0 + mma::frag_col(ncol[ni]);
        const size_t i = ((size_t)b * T + t) * C + co;
        const float2 bv = *reinterpret_cast<const float2*>(bias + co);
        float v0 = acc[mi][ni][2 * half] + bv.x, v1 = acc[mi][ni][2 * half + 1] + bv.y;
        if (epi == EPI_LEAKY) {
          v0 = leaky(v0);
          v1 = leaky(v1);
        } else {
          const float2 r = *reinterpret_cast<const float2*>(res + i);
          v0 += r.x;
          v1 += r.y;
          if (epi == EPI_MEAN) {
            if (!first) {
              const float2 o = *reinterpret_cast<const float2*>(dst + i);
              v0 = o.x + v0;
              v1 = o.y + v1;
            }
            if (last) {
              v0 /= n_res;
              v1 /= n_res;
            }
          }
        }
        *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
      }
    }
}

// conv_kernel at C = 8 with two taps a k step (see the header): WARPS warps,
// each MT 16-row tiles of the BM = WARPS * MT * 16 frames a block owns.
template <int WARPS, int MT, int K>
__global__ void __launch_bounds__(WARPS * 32)
conv_kernel_c8(const float* __restrict__ in, const bf16* __restrict__ w,
               const float* __restrict__ bias, const float* res, float* dst, int T, int d,
               int pre_leaky, int epi, int first, int last, float n_res) {
  constexpr int C = 8, BM = WARPS * MT * 16, NTH = WARPS * 32, NP = (K + 1) / 2;
  __shared__ __align__(16) bf16 As[(BM + 2 * MAX_PAD) * C];
  const int pad = (K - 1) / 2 * d, rows = BM + 2 * pad;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * MT * 16;
  const float* inb = in + (size_t)b * T * C;

  // B fragments: b0 holds k rows kr, kr + 1 of column lane / 4 (tap 2p's
  // channels kr, kr + 1), b1 the same rows of tap 2p + 1 (k rows 8 + kr).
  uint32_t bfr[NP][2];
  const int kr = 2 * (lane & 3), col = lane >> 2;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * p + h;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (q < K) {
        v.x = w[((size_t)q * C + kr) * C + col];
        v.y = w[((size_t)q * C + kr + 1) * C + col];
      }
      bfr[p][h] = *reinterpret_cast<uint32_t*>(&v);
    }

  // the frames the taps reach, leaky'd and rounded to bf16, zero outside [0, T)
  for (int e = tid; e < rows * 2; e += NTH) {
    const int r = e >> 1, t = t0 - pad + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = mma::ld4(inb + (size_t)t * C + (e & 1) * 4);
      if (pre_leaky) v = make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
    }
    *reinterpret_cast<uint2*>(As + r * C + (e & 1) * 4) = mma::pack4(v);
  }
  __syncthreads();

  float acc[MT][4] = {};
  const int arow = lane & 15, second = lane >> 4;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int q = 2 * p + second < K ? 2 * p + second : 2 * p;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t a[4];
      mma::ldsm_x4(a, As + (row0 + 16 * mi + arow + q * d) * C);
      mma::mma16816(acc[mi], a, bfr[p][0], bfr[p][1]);
    }
  }

  const int co = mma::frag_col(0);
  const float2 bv = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + row0 + mma::frag_row(mi, half);
      if (t >= T) continue;
      const size_t i = ((size_t)b * T + t) * C + co;
      float v0 = acc[mi][2 * half] + bv.x, v1 = acc[mi][2 * half + 1] + bv.y;
      if (epi == EPI_LEAKY) {
        v0 = leaky(v0);
        v1 = leaky(v1);
      } else {
        const float2 r = *reinterpret_cast<const float2*>(res + i);
        v0 += r.x;
        v1 += r.y;
        if (epi == EPI_MEAN) {
          if (!first) {
            const float2 o = *reinterpret_cast<const float2*>(dst + i);
            v0 = o.x + v0;
            v1 = o.y + v1;
          }
          if (last) {
            v0 /= n_res;
            v1 /= n_res;
          }
        }
      }
      *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
    }
}

template <int WARPS, int MT>
int conv_c8(const float* in, const bf16* w, const float* bias, const float* res, float* dst,
            int B, int T, int k, int d, int pre_leaky, int epi, int first, int last, float n_res,
            cudaStream_t stream) {
  constexpr int BM = WARPS * MT * 16;
  const dim3 grid((T + BM - 1) / BM, B);
  switch (k) {
#define RESBLOCK_C8_CASE(K)                                                                  \
  case K:                                                                                    \
    conv_kernel_c8<WARPS, MT, K><<<grid, WARPS * 32, 0, stream>>>(in, w, bias, res, dst, T, \
                                                                  d, pre_leaky, epi, first, \
                                                                  last, n_res);             \
    return (int)cudaGetLastError();
    RESBLOCK_C8_CASE(3) RESBLOCK_C8_CASE(7) RESBLOCK_C8_CASE(11)
#undef RESBLOCK_C8_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int WM, int WN, int MT, int NT, int K>
int launch_conv(const float* in, const bf16* w, const float* bias, const float* res, float* dst,
                int B, int T, int C, int d, int pre_leaky, int epi, int first, int last,
                float n_res, cudaStream_t stream) {
  using TL = Tile<WM, WN, MT, NT>;
  // the largest smem this instantiation takes, allowed once a device
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    e = cudaFuncSetAttribute(conv_kernel<WM, WN, MT, NT, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<TL, K>(MAX_PAD));
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  const size_t smem = smem_bytes<TL, K>((K - 1) / 2 * d);
  const dim3 grid(C / TL::BN, (T + TL::BM - 1) / TL::BM, B);
  conv_kernel<WM, WN, MT, NT, K><<<grid, TL::THREADS, smem, stream>>>(
      in, w, bias, res, dst, T, C, d, pre_leaky, epi, first, last, n_res);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int MT, int NT>
int conv_k(const float* in, const bf16* w, const float* bias, const float* res, float* dst,
           int B, int T, int C, int k, int d, int pre_leaky, int epi, int first, int last,
           float n_res, cudaStream_t stream) {
  switch (k) {
#define RESBLOCK_CASE(K)                                                                      \
  case K:                                                                                     \
    return launch_conv<WM, WN, MT, NT, K>(in, w, bias, res, dst, B, T, C, d, pre_leaky, epi, \
                                          first, last, n_res, stream);
    RESBLOCK_CASE(3) RESBLOCK_CASE(7) RESBLOCK_CASE(11)
#undef RESBLOCK_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile for each C: (WM, WN, MT, NT) warps and mma tiles.
int conv(const float* in, const bf16* w, const float* bias, const float* res, float* dst, int B,
         int T, int C, int k, int d, int pre_leaky, int epi, int first, int last, float n_res,
         cudaStream_t stream) {
  if (C == 8)
    return conv_c8<8, 2>(in, w, bias, res, dst, B, T, k, d, pre_leaky, epi, first, last, n_res,
                         stream);
  if (C == 16)
    return conv_k<8, 1, 2, 2>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last,
                              n_res, stream);
  if (C == 32)
    return conv_k<8, 1, 2, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last,
                              n_res, stream);
  return conv_k<4, 2, 2, 4>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last,
                            n_res, stream);
}

}  // namespace

// resblock.cu's resblock_stage with bf16 taps: x [B,T,C] float32 input (read
// only); out [B,T,C] the stage mean; h, tmp [B,T,C] float32 scratch. w: the
// stage's convs in (resblock, unit, conv1/conv2) order, each [k, C, C] (tap,
// in, out) bf16; bias [n_convs, C] float32. ksizes[j] / nunits[j] give
// resblock j's kernel size and unit count, dils the units' dilations in
// order. Launches 2 * sum(nunits) kernels on `stream`; returns the first
// launch error (cudaError_t) or 0.
extern "C" int resblock_stage_bf16(const float* x, float* out, float* h, float* tmp,
                                   const void* w_ptr, const float* bias, const int* ksizes,
                                   const int* nunits, const int* dils, int n_res, int B, int T,
                                   int C, void* stream_ptr) {
  if (B < 1 || T < 1 || n_res < 1 || !(C == 8 || C == 16 || C == 32 || C % 64 == 0))
    return (int)cudaErrorInvalidValue;
  const bf16* w = static_cast<const bf16*>(w_ptr);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  size_t woff = 0;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    const int k = ksizes[j];
    const float* hin = x;
    for (int u = 0; u < nunits[j]; ++u) {
      const int d = dils[di++];
      if ((k - 1) / 2 * d > MAX_PAD) return (int)cudaErrorInvalidValue;
      int err = conv(hin, w + woff, bias + (size_t)ci * C, nullptr, tmp, B, T, C, k, d, 1,
                     EPI_LEAKY, 0, 0, 1.f, stream);
      if (err) return err;
      woff += (size_t)k * C * C;
      ++ci;
      const bool last_unit = u + 1 == nunits[j];
      err = conv(tmp, w + woff, bias + (size_t)ci * C, hin, last_unit ? out : h, B, T, C, k, 1, 0,
                 last_unit ? EPI_MEAN : EPI_RESID, j == 0, j == n_res - 1, (float)n_res, stream);
      if (err) return err;
      woff += (size_t)k * C * C;
      ++ci;
      hin = h;
    }
  }
  return 0;
}
