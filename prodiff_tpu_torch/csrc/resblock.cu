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
// Design at C >= 16: one register-tiled direct-conv kernel per conv (18
// launches a stage). A block owns BM frames x BN output channels; each
// thread an FM x 8 fragment (FM consecutive frames by two groups of 4
// channels BN/2 apart, the weights read as float4s), so a tap is FM + 2
// shared loads per 8*FM FMAs (10 per 64 at FM = 8). The input channels run
// in chunks of BK = 8: a chunk stages all k taps' weights ([k][BK][BN], by
// cp.async) and the frames the taps reach (BM + 2 pad rows, k-major, through
// registers, with the pre-activation leaky and the zeros outside [0, T)
// applied on the way), double-buffered (tile_gemm.cuh:run_chunks), one
// barrier a chunk. The tile, (BM, BN, FM) = (512, 16, 4) at C = 16, (256,
// 32, 4) at C = 32, (256, 64, 8) at C = 64 and 128, (128, 64, 4) at C = 256,
// gives 128-512 blocks of 8 warps a stage at T_mel = 512; the 4-row
// fragments at C = 32 and 256 spill less at the 128-register cap that two
// blocks an SM need. Where that tile's grid has fewer than MIN_BLOCKS (128,
// about one an SM) blocks, a smaller one of the width's list is taken
// (pick_tile; ops/resblock.py:f32_tile mirrors it): HiFi-GAN V2's C = 64
// stage at T = 4,096 had 16 blocks of (256, 64, 8) on 132 SMs, and takes 128
// of (64, 32, 4), two warps each. Epilogues: leaky (first conv of a unit), +
// residual (second conv, in place), or + residual accumulated into the stage
// mean (last unit of each ResBlock). k is 3, 7 or 11 (a template argument),
// and the halo (k - 1) / 2 * d at most MAX_PAD frames a side.
//
// C = 8: the whole stage in one launch (c8_stage_kernel; the block plan and
// its walk in resblock_c8.cuh), as the Pallas kernel runs it. It replaces
// one launch a conv of a (512, 8, 4) tile, whose 18 dependent launches each
// read and wrote the [B, T, 8] activations (~12 MB a conv, ~200 MB a stage,
// against the 8.4 MB of x and out), with one chunk of BK = 8 channels and
// nothing overlapping its staging: 0.2331 ms at B = 1, T = 131,072 against
// a 0.0316 ms FMA bound. Here a block keeps x, the leaky'd h (the next
// conv1's input) and conv1's output in shared memory as two planes of 4
// channels ([2][rows][4] float4s: a warp's 16 rows are 256 contiguous
// bytes a plane), all the stage's taps (32 KB) and biases beside them, and
// the running h and the mean in registers (a frame keeps its thread). A
// thread owns 4 output channels of TILES rows (16-row tiles of its warp);
// a tap is 8 float4 weight loads (two addresses a warp) and 2 activation
// float4s a row for 32 FMAs a row, the taps a loop that is not unrolled
// (0.089-0.091 ms; unrolled for each k, 0.0945 in another run). The bound
// is FMA (0.0316 ms, plus ~8.6% of recomputed halo
// rows at M = 512); measured on an H100 80GB HBM3 at 700 W (C8_SKIP builds,
// tools/probe_bf16_kernels.py --c8-only): ~0.090 ms, of which the products
// ~0.072, the epilogues ~0.010, the loads, copies and barriers ~0.008. The
// products run at about half the FMA rate: 18 float4 shared loads per 160
// FMAs a tap and warp is the likely limit (the two lanes of a row read the
// same activations). Splitting the input channels across the lane pair
// (half the activation loads) needed 40 accumulators and spilled at the
// 128-register cap two blocks an SM allow: slower (0.102 ms), as were 3 or 4
// tiles a warp and 256-frame blocks.
//
#include <cuda_runtime.h>

#include "resblock_c8.cuh"
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

// The tiles (BM frames, BN channels, FM frames a thread) a width may take,
// in order of preference: the first whose grid has MIN_BLOCKS blocks, else
// the one with the most (ops/resblock.py:f32_tile mirrors this).
constexpr int MIN_BLOCKS = 128;
constexpr int N_TILES = 5;
constexpr int TILE_LIST[N_TILES][3] = {{512, 16, 4}, {256, 32, 4}, {256, 64, 8}, {128, 64, 4},
                                       {64, 32, 4}};

int pick_tile(int C, int B, int T) {
  static const int c16[] = {0}, c32[] = {1, 4}, c128[] = {2, 3, 4}, wide[] = {3, 4};
  const int* list = C == 16 ? c16 : C == 32 ? c32 : C <= 128 ? c128 : wide;
  const int n = C == 16 ? 1 : C == 32 || C > 128 ? 2 : 3;
  int best = list[0];
  long long most = -1;
  for (int i = 0; i < n; ++i) {
    const int* t = TILE_LIST[list[i]];
    const long long blocks = (long long)B * (C / t[1]) * ((T + t[0] - 1) / t[0]);
    if (blocks >= MIN_BLOCKS) return list[i];
    if (blocks > most) {
      most = blocks;
      best = list[i];
    }
  }
  return best;
}

int conv(const float* in, const float* w, const float* bias, const float* res, float* dst,
         int B, int T, int C, int k, int d, int pre_leaky, int epi, int first, int last,
         float n_res, cudaStream_t stream) {
  switch (pick_tile(C, B, T)) {
#define RESBLOCK_TILE(I, BM, BN, FM)                                                             \
  case I:                                                                                       \
    return conv_k<BM, BN, FM>(in, w, bias, res, dst, B, T, C, k, d, pre_leaky, epi, first, last, \
                              n_res, stream);
    RESBLOCK_TILE(0, 512, 16, 4) RESBLOCK_TILE(1, 256, 32, 4) RESBLOCK_TILE(2, 256, 64, 8)
    RESBLOCK_TILE(3, 128, 64, 4) RESBLOCK_TILE(4, 64, 32, 4)
#undef RESBLOCK_TILE
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- C = 8: the whole stage in one launch (see the header) ----

// C8_SKIP (0 in the kernel the port runs) leaves a part out, for measuring
// where the time goes (tools/probe_bf16_kernels.py --c8-only): bit 0 the
// convs' products and their operand loads, bit 1 the convs' epilogues, bit 2
// the global loads of x and the taps, bit 3 the ResBlocks' leaky'd copies of
// x. Its output is for measurement only.
#ifndef C8_SKIP
#define C8_SKIP 0
#endif

// a block's bytes: float32 taps; x, L and Y a row
constexpr c8::Bytes F32_BYTES = {4, 3 * 32};

// acc[i] (output channels 4 cg .. 4 cg + 3, cg = lane % 2, of this lane's
// row in tile i) = the conv of `in` ([2][nr] float4 planes of 4 channels,
// tile row r at r + GUARD) with taps w ([k][8][8], in x out) at dilation d,
// for the warp's tiles that meet rows [lo, hi). A tap is 8 float4 weight
// loads and, a tile, 2 activation float4s for 32 FMAs; the taps are a loop
// (not unrolled: a tap's body is ~180 instructions, so the instruction cache
// holds it for any k).
__device__ __forceinline__ void c8_conv(const float4* __restrict__ in, int nr,
                                        const float* __restrict__ w, int k, int d, int lo,
                                        int hi, int warp, int nwarps, float4 (&acc)[c8::TILES]) {
  const int lane = threadIdx.x & 31, cg = lane & 1;
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (C8_SKIP & 1) return;
  const float4* src = in + c8::GUARD + (lane >> 1) - (k - 1) / 2 * d;
#pragma unroll 1
  for (int q = 0; q < k; ++q, src += d, w += 64) {
    float4 wv[8];
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) wv[ci] = ld4(w + ci * 8 + 4 * cg);
#pragma unroll
    for (int i = 0; i < c8::TILES; ++i) {
      const int base = 16 * (warp + i * nwarps);
      if (base + 16 <= lo || base >= hi) continue;  // warp-uniform
      const float4 a0 = src[base], a1 = src[nr + base];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int ci = 0; ci < 8; ++ci) {
        acc[i].x = fmaf(a[ci], wv[ci].x, acc[i].x);
        acc[i].y = fmaf(a[ci], wv[ci].y, acc[i].y);
        acc[i].z = fmaf(a[ci], wv[ci].z, acc[i].z);
        acc[i].w = fmaf(a[ci], wv[ci].w, acc[i].w);
      }
    }
  }
}

// out[b, t0 .. t0 + M) = the stage mean, for x [B, T, 8]; wg the taps of
// every conv ([k][8][8] each, in weight order), bg the biases [n_convs][8].
// Shared memory: X, L (leaky(h): conv1's input) and Y (leaky(conv1 + b1):
// conv2's input) as [2][nr] float4 planes, then the taps and the biases.
__global__ void __launch_bounds__(32 * c8::MAX_WARPS)
c8_stage_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ wg,
                const float* __restrict__ bg, const __grid_constant__ c8::Stage st) {
  extern __shared__ float4 sm4[];
  const int nr = st.rows + 2 * c8::GUARD;
  float4* X = sm4;
  float4* L = X + 2 * nr;
  float4* Y = L + 2 * nr;
  float* W = reinterpret_cast<float*>(Y + 2 * nr);
  float* Bs = W + st.n_w;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nwarps = nt >> 5;
  const int lane = tid & 31, cg = lane & 1, r16 = lane >> 1;
  const int b = blockIdx.y, T = st.T, H = st.halo, t0 = blockIdx.x * st.M;
  const float* xb = x + (size_t)b * T * 8;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the taps, the biases and x on rows [-GUARD, rows + GUARD) (zero outside
  // [0, T)) by cp.async, every copy in flight at once
  for (int e = tid; e < (C8_SKIP & 4 ? 0 : st.n_w / 4); e += nt)
    tile::cp_async16(W + 4 * e, wg + 4 * e, true);
  for (int e = tid; e < st.n_b / 4; e += nt) tile::cp_async16(Bs + 4 * e, bg + 4 * e, true);
  for (int e = tid; e < 2 * nr; e += nt) {
    const int r = e >> 1, c = e & 1, t = t0 - H - c8::GUARD + r;
    const bool inside = t >= 0 && t < T;
    if (!(C8_SKIP & 4))
      tile::cp_async16(reinterpret_cast<float*>(X + c * nr + r),
                       inside ? xb + (size_t)t * 8 + 4 * c : xb, inside);
    Y[c * nr + r] = zero;
  }
  tile::cp_async_commit();
  tile::cp_async_wait_all();

  float4 h[c8::TILES], mean[c8::TILES], acc[c8::TILES];
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i) mean[i] = zero;
  int wo = 0, ci = 0;
  for (int u = 0; u < st.n_units;) {
    int reach = 0, end = u;  // this ResBlock's units [u, end) and its reach
    do {
      const int k = c8::unit_k(st.unit[end]);
      reach += (k - 1) / 2 * (c8::unit_d(st.unit[end]) + 1);
    } while (!c8::unit_last(st.unit[end++]));
    __syncthreads();  // X is in (and the last ResBlock's reads of L are done)
    for (int e = tid; e < (C8_SKIP & 8 ? 0 : 2 * nr); e += nt) L[e] = leaky4(X[e]);
    __syncthreads();
    int lo = H - reach, hi = H + st.M + reach;
    for (; u < end; ++u) {
      const int k = c8::unit_k(st.unit[u]), d = c8::unit_d(st.unit[u]);
      const bool first = c8::unit_first(st.unit[u]), last = u + 1 == end;
      lo += (k - 1) / 2 * d;
      hi -= (k - 1) / 2 * d;
      c8_conv(L, nr, W + wo, k, d, lo, hi, warp, nwarps, acc);
      wo += k * 64;
      const float4 b1 = ld4(Bs + 8 * ci + 4 * cg);
#pragma unroll
      for (int i = 0; i < c8::TILES; ++i) {
        const int r = 16 * (warp + i * nwarps) + r16, t = t0 - H + r;
        if (r < lo || r >= hi || (C8_SKIP & 2)) continue;
        Y[cg * nr + r + c8::GUARD] = t >= 0 && t < T ? leaky4(add4(acc[i], b1)) : zero;
      }
      ++ci;
      __syncthreads();
      lo += (k - 1) / 2;
      hi -= (k - 1) / 2;
      c8_conv(Y, nr, W + wo, k, 1, lo, hi, warp, nwarps, acc);
      wo += k * 64;
      const float4 b2 = ld4(Bs + 8 * ci + 4 * cg);
#pragma unroll
      for (int i = 0; i < c8::TILES; ++i) {
        const int r = 16 * (warp + i * nwarps) + r16, t = t0 - H + r;
        if (r < lo || r >= hi || (C8_SKIP & 2)) continue;
        const float4 v = t >= 0 && t < T ? add4(acc[i], b2) : zero;
        h[i] = add4(v, first ? X[cg * nr + r + c8::GUARD] : h[i]);
        if (last)
          mean[i] = add4(mean[i], h[i]);
        else
          L[cg * nr + r + c8::GUARD] = leaky4(h[i]);
      }
      ++ci;
      __syncthreads();
    }
  }
  const float n_res = (float)st.n_res;
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i) {
    const int r = 16 * (warp + i * nwarps) + r16, t = t0 - H + r;
    if (r < H || r >= H + st.M || t >= T) continue;
    st4(out + ((size_t)b * T + t) * 8 + 4 * cg,
        make_float4(mean[i].x / n_res, mean[i].y / n_res, mean[i].z / n_res, mean[i].w / n_res));
  }
}

int c8_stage(const float* x, float* out, const float* w, const float* bias, const int* ksizes,
             const int* nunits, const int* dils, int n_res, int B, int T, cudaStream_t stream) {
  c8::Stage st;
  c8::Plan plan;
  int err = c8::plan_stage(&st, &plan, ksizes, nunits, dils, n_res, B, T, F32_BYTES);
  if (err) return err;
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    e = cudaFuncSetAttribute(c8_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             c8::SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  c8_stage_kernel<<<dim3((T + plan.M - 1) / plan.M, B), 32 * plan.warps, plan.smem, stream>>>(
      x, out, w, bias, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Tile of the per-conv kernel at (C, B, T): out = {BM, BN, FM}; returns 0,
// or -1 for a width it does not take (a check for ops/resblock.py:f32_tile).
extern "C" int resblock_tile(int C, int B, int T, int* out) {
  if (!(C == 16 || C == 32 || (C > 0 && C % 64 == 0)) || B < 1 || T < 1) return -1;
  const int* t = TILE_LIST[pick_tile(C, B, T)];
  for (int i = 0; i < 3; ++i) out[i] = t[i];
  return 0;
}

// The C = 8 stage's block plan (resblock_c8.cuh:plan_stage with float32
// taps): out = {M, halo, rows, warps, smem, blocks}; returns its error (a
// check for ops/resblock.py:c8_plan).
extern "C" int resblock_c8_plan(const int* ksizes, const int* nunits, const int* dils, int n_res,
                                int B, int T, int* out) {
  return c8::export_plan(ksizes, nunits, dils, n_res, B, T, F32_BYTES, out);
}

// x: [B,T,C] input (read only); out: [B,T,C] the stage mean; h, tmp: [B,T,C]
// scratch (unused at C = 8). w: the stage's convs in (resblock, unit,
// conv1/conv2) order, each [k, C, C] (tap, in, out); bias: [n_convs, C].
// ksizes[j] / nunits[j] give resblock j's kernel size and unit count, dils
// the units' dilations in order. Launches 2 * sum(nunits) kernels on
// `stream`, one at C = 8; returns the first launch error (cudaError_t) or 0.
extern "C" int resblock_stage(const float* x, float* out, float* h, float* tmp,
                              const float* w, const float* bias,
                              const int* ksizes, const int* nunits,
                              const int* dils, int n_res, int B, int T, int C,
                              void* stream_ptr) {
  if (B < 1 || T < 1 || n_res < 1 || !(C == 8 || C == 16 || C == 32 || C % 64 == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (C == 8) return c8_stage(x, out, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
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
