// WaveNet residual stack (the 20-layer diffusion denoiser loop) for Hopper.
//
// Replaces the Pallas TPU kernels fused_residual_stack
// (prodiff_tpu/ops/pallas/wavenet.py:177) and fused_residual_stack_tiled
// (prodiff_tpu/ops/pallas/wavenet.py:261); the layer body they share is
// _wavenet_layer_step (:124), the layer of wavenet_tiles.cuh. It returns
// skip / sqrt(L).
//
// What bounds it on the H100: float32 FMA throughput in principle (parity
// mode: float32 operands, TF32 off, so no tensor cores; at B=1, T=512,
// C=H=256, L=20 the stack is 13.4 GFLOP, 0.2 ms at 67 TFLOP/s, against
// 28 MB of weights), but at the main path's small M = B*T (512-2048 frames)
// what bounded the first port was not the FMA pipe: a layer was two launches
// of 128 four-warp blocks (under one block an SM), each staging its chunks
// synchronously, so 41 dependent launches of ~76 us each made a 3.1 ms stack.
//
// Design, three launches a stack:
//   1. step_proj_kernel: sp[l] = step . W_s[l] + b_s[l] for every layer.
//   2. cond_kernel: zc[l] = cond . W_c[l] + b_c[l] + b_d[l] for every layer
//      at once, a [B*T, H] x [H, L*2C] register-tiled GEMM (N = 10,240 at
//      C = 256, which fills the card) reading W_c in place. It depends on no
//      layer, so it leaves the serial chain (20% of the stack's FLOPs).
//   3. chain_kernel: all L layers in one cooperative launch. The grid is
//      what can be co-resident (occupancy x SMs, capped at the tile count);
//      per layer a gate phase, a grid barrier, an out phase and a grid
//      barrier. In each phase the resident blocks walk the output tiles:
//      BM frames of one sequence x 32 column pairs (j, C+j), so the gate and
//      the residual/skip update form in registers. x, skip and the gate stay
//      in device memory (L2-resident: 0.5 MB each at T=512) and are read
//      through L2 only (cp.async.cg, ld.global.cg), since other blocks wrote
//      them before the barrier; the L1 path could return stale rows.
//   To fill the SMs at small M, each tile's reduction (K = 3C taps in the
//   gate phase, C in the out phase) is split across the block's 8 warps: a
//   staged chunk of 32 k rows gives each warp 4, each warp accumulates the
//   whole tile (FM x 8 fragments, tile_gemm.cuh), and the 8 partial tiles are
//   summed through shared memory before the epilogue. Chunks are
//   double-buffered (run_chunks: cp.async weights, register-staged
//   activations with the step projection and the zero padding outside
//   [0, T) applied), one barrier a chunk. BM is 32, 24 or 16 (8 x 8, 6 x 8
//   or 4 x 8 fragments), whichever finishes the tiles in the fewest rounds
//   of the grid (chosen by the wrapper, ops/wavenet_stack.py:chain_rows):
//   at B = 1 that is 16 at T = 512 (256 tiles for 264 slots), 24 at T = 640
//   (216 tiles) and 32 at T = 2048.
// zc costs 4*L*B*T*2C bytes (21 MB at B=1, T=512); above ZC_BUDGET the
// wrapper runs the layers in groups, one cond + one chain launch a group.

#include <cooperative_groups.h>

#include "tile_gemm.cuh"
#include "wavenet_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using tile::add4;
using tile::ld4;
using tile::ld4_l2;
using tile::st4;
using wavenet::RSQRT2;

// ---- cond_kernel: zc [G, B*T, 2C] -----------------------------------------

constexpr int CD_BM = 128, CD_BN = 128, CD_BK = 8, CD_NT = 256;
constexpr int CD_LDA = CD_BM + 4;

__global__ void __launch_bounds__(CD_NT, 2)
cond_kernel(const float* __restrict__ cond, const float* __restrict__ cw,
            const float* __restrict__ cb, const float* __restrict__ db,
            float* __restrict__ zc, int M, int C, int H) {
  constexpr int NTX = CD_BN / 16;  // 8 columns a thread: 16 threads across
  static_assert(CD_BM * CD_BK / 4 == CD_NT && CD_BK * CD_BN / 4 == CD_NT, "one float4 each");
  __shared__ __align__(16) float As[2][CD_BK * CD_LDA];
  __shared__ __align__(16) float Bs[2][CD_BK * CD_BN];
  const int g = blockIdx.z, m0 = blockIdx.y * CD_BM, n0 = blockIdx.x * CD_BN;
  const int tid = threadIdx.x, tx = tid % (2 * NTX), ty = tid / (2 * NTX);
  const int c2 = 2 * C;
  const float* w = cw + (size_t)g * H * c2;
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid / (CD_BN / 4), bn = tid % (CD_BN / 4) * 4;
  const bool bvalid = n0 + bn < c2;

  float4 ra;
  auto fetch = [&](int buf, int i) {
    tile::cp_async16(Bs[buf] + tid * 4,
                     bvalid ? w + (size_t)(i * CD_BK + bk) * c2 + n0 + bn : w, bvalid);
    tile::cp_async_commit();
    ra = m0 + ar < M ? ld4(cond + (size_t)(m0 + ar) * H + i * CD_BK + ak)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float acc[8][8] = {};
  tile::run_chunks(
      H / CD_BK, fetch, [&](int buf, int) { tile::put_a<CD_LDA>(As[buf], ar, ak, ra); },
      [&](int buf, int) {
        tile::frag_fma<8, CD_BK, 1, CD_LDA, CD_BN, 0>(As[buf], Bs[buf], ty * 8, tx * 4, acc);
      });

  const float* cbg = cb + (size_t)g * c2;
  const float* dbg = db + (size_t)g * c2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + h * (CD_BN / 2) + tx * 4;
    if (n >= c2) continue;
    const float4 bias = add4(ld4(cbg + n), ld4(dbg + n));
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int row = m0 + ty * 8 + m;
      if (row >= M) break;
      st4(zc + ((size_t)g * M + row) * c2 + n,
          add4(make_float4(acc[m][h * 4], acc[m][h * 4 + 1], acc[m][h * 4 + 2],
                           acc[m][h * 4 + 3]), bias));
    }
  }
}

// ---- chain_kernel: the layers, one cooperative launch ---------------------

constexpr int CH_NT = 256, CH_NW = CH_NT / 32;  // 8 warps, each a K slice
constexpr int BP = 32, BN = 2 * BP;              // 32 column pairs (j, C+j)
constexpr int KC = 32, KW = KC / CH_NW;          // chunk rows; 4 a warp

struct ChainArgs {
  float* x;      // [B,T,C] the residual, updated in place
  float* skip;   // [B,T,C]
  float* gate;   // [B,T,C] scratch
  const float* sp;  // [L,B,C]
  const float* zc;  // [G,B*T,2C] this group's conditioner terms (+ b_c + b_d)
  const float* dw;  // [L,3,C,2C]
  const float* ow;  // [L,C,2C]
  const float* ob;  // [L,2C]
  int B, T, C, L, l0, G;
  float last_scale;  // 1/sqrt(L)
};

template <int BM>
__host__ __device__ constexpr int chain_lda() { return BM + 4; }

template <int BM>
__host__ __device__ constexpr int chain_smem_floats() {
  constexpr int stage = 2 * (KC * chain_lda<BM>() + 3 * KC * BN);
  constexpr int red = CH_NW * BM * BN;
  return stage > red ? stage : red;
}

// The 8 warps' partial tiles into red [warp][BM][BN].
template <int BM, int FM>
__device__ __forceinline__ void put_partial(float* red, int w, int ty, int tx,
                                            const float (&acc)[FM][8]) {
#pragma unroll
  for (int m = 0; m < FM; ++m) {
    float* row = red + (w * BM + ty * FM + m) * BN;
    st4(row + tx * 4, make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
    st4(row + BP + tx * 4, make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]));
  }
}

// Sum of the 8 partials at (row r, pairs p..p+3): (first half, second half).
template <int BM>
__device__ __forceinline__ void sum_partials(const float* red, int r, int p, float4& lo,
                                             float4& hi) {
  lo = ld4(red + r * BN + p);
  hi = ld4(red + r * BN + BP + p);
#pragma unroll
  for (int w = 1; w < CH_NW; ++w) {
    lo = add4(lo, ld4(red + (w * BM + r) * BN + p));
    hi = add4(hi, ld4(red + (w * BM + r) * BN + BP + p));
  }
}

// B tile [NTAP][KC][BN] of a [.., 2C] weight: rows k0.. of each tap, pair
// columns j0.. and C+j0..
template <int NTAP>
__device__ __forceinline__ void copy_pairs(float* bs, const float* w, int C, int k0, int j0,
                                           int tid) {
  const size_t c2 = 2 * (size_t)C;
#pragma unroll
  for (int s = 0; s < NTAP * KC * BN / 4 / CH_NT; ++s) {
    const int f = tid + s * CH_NT;
    const int q = f / (KC * BN / 4), k = f / (BN / 4) % KC, n = f % (BN / 4) * 4;
    const size_t col = n < BP ? j0 + n : C + j0 + n - BP;
    tile::cp_async16(bs + f * 4, w + ((size_t)q * C + k0 + k) * c2 + col, true);
  }
  tile::cp_async_commit();
}

template <int BM>
__device__ void gate_tile(const ChainArgs& p, int l, int b, int t0, int j0, float* smem) {
  constexpr int FM = BM / 4, LDA = chain_lda<BM>();
  constexpr int NA = tile::ceil_div((BM + 2) * KC / 4, CH_NT);
  float* As[2] = {smem, smem + KC * LDA};
  float* Bs[2] = {smem + 2 * KC * LDA, smem + 2 * KC * LDA + 3 * KC * BN};
  const int tid = threadIdx.x, w = tid / 32, ty = tid % 32 / 8, tx = tid % 8;
  const int T = p.T, C = p.C;
  const float* xb = p.x + (size_t)b * T * C;
  const float* spb = p.sp + ((size_t)l * p.B + b) * C;
  const float* dw = p.dw + (size_t)l * 3 * C * 2 * C;

  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
    copy_pairs<3>(Bs[buf], dw, C, i * KC, j0, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CH_NT, r = e / (KC / 4), t = t0 - 1 + r;
      ra[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < BM + 2 && t >= 0 && t < T)
        ra[s] = add4(ld4_l2(xb + (size_t)t * C + i * KC + e % (KC / 4) * 4),
                     ld4(spb + i * KC + e % (KC / 4) * 4));
    }
  };
  auto put = [&](int buf, int) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CH_NT, r = e / (KC / 4);
      if (r < BM + 2) tile::put_a<LDA>(As[buf], r, e % (KC / 4) * 4, ra[s]);
    }
  };
  float acc[FM][8] = {};
  tile::run_chunks(C / KC, fetch, put, [&](int buf, int) {
    tile::frag_fma<FM, KW, 3, LDA, BN, KC * BN>(As[buf] + w * KW * LDA, Bs[buf] + w * KW * BN,
                                                ty * FM, tx * 4, acc);
  });

  put_partial<BM, FM>(smem, w, ty, tx, acc);
  __syncthreads();
  const float* zc = p.zc + ((size_t)(l - p.l0) * p.B + b) * T * 2 * C;
  for (int e = tid; e < BM * BP / 4; e += CH_NT) {
    const int r = e / (BP / 4), pj = e % (BP / 4) * 4, t = t0 + r;
    if (t >= T) continue;
    float4 zg, zf;
    sum_partials<BM>(smem, r, pj, zg, zf);
    const float* zrow = zc + (size_t)t * 2 * C + j0 + pj;
    zg = add4(zg, ld4(zrow));
    zf = add4(zf, ld4(zrow + C));
    st4(p.gate + ((size_t)b * T + t) * C + j0 + pj,
        make_float4(tile::sigmoid(zg.x) * tanhf(zf.x), tile::sigmoid(zg.y) * tanhf(zf.y),
                    tile::sigmoid(zg.z) * tanhf(zf.z), tile::sigmoid(zg.w) * tanhf(zf.w)));
  }
  __syncthreads();  // red aliases the next tile's staging buffers
}

template <int BM>
__device__ void out_tile(const ChainArgs& p, int l, int b, int t0, int j0, float* smem) {
  constexpr int FM = BM / 4, LDA = chain_lda<BM>();
  static_assert(BM * KC / 4 <= CH_NT, "one float4 of A a thread");
  float* As[2] = {smem, smem + KC * LDA};
  float* Bs[2] = {smem + 2 * KC * LDA, smem + 2 * KC * LDA + 3 * KC * BN};
  const int tid = threadIdx.x, w = tid / 32, ty = tid % 32 / 8, tx = tid % 8;
  const int T = p.T, C = p.C;
  const int ar = tid / (KC / 4), ak = tid % (KC / 4) * 4;
  const float* gb = p.gate + (size_t)b * T * C;
  const float* ow = p.ow + (size_t)l * C * 2 * C;

  float4 ra;
  auto fetch = [&](int buf, int i) {
    copy_pairs<1>(Bs[buf], ow, C, i * KC, j0, tid);
    ra = ar < BM && t0 + ar < T ? ld4_l2(gb + (size_t)(t0 + ar) * C + i * KC + ak)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto put = [&](int buf, int) {
    if (ar < BM) tile::put_a<LDA>(As[buf], ar, ak, ra);
  };
  float acc[FM][8] = {};
  tile::run_chunks(C / KC, fetch, put, [&](int buf, int) {
    tile::frag_fma<FM, KW, 1, LDA, BN, KC * BN>(As[buf] + w * KW * LDA, Bs[buf] + w * KW * BN,
                                                ty * FM, tx * 4, acc);
  });

  put_partial<BM, FM>(smem, w, ty, tx, acc);
  __syncthreads();
  const float* ob = p.ob + (size_t)l * 2 * C;
  const bool first = l == 0;
  const float scale = l == p.L - 1 ? p.last_scale : 1.f;
  for (int e = tid; e < BM * BP / 4; e += CH_NT) {
    const int r = e / (BP / 4), pj = e % (BP / 4) * 4, t = t0 + r;
    if (t >= T) continue;
    float4 res, sk;
    sum_partials<BM>(smem, r, pj, res, sk);
    const int j = j0 + pj;
    const size_t i = ((size_t)b * T + t) * C + j;
    st4(p.x + i, tile::scale4(add4(ld4_l2(p.x + i), add4(res, ld4(ob + j))), RSQRT2));
    sk = add4(sk, ld4(ob + C + j));
    if (!first) sk = add4(ld4_l2(p.skip + i), sk);
    st4(p.skip + i, tile::scale4(sk, scale));
  }
  __syncthreads();
}

template <int BM>
__global__ void __launch_bounds__(CH_NT, 2) chain_kernel(ChainArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int n_pt = p.C / BP, n_tt = tile::ceil_div(p.T, BM);
  const int n_tiles = p.B * n_tt * n_pt;
  for (int l = p.l0; l < p.l0 + p.G; ++l) {
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      gate_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    grid.sync();
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      out_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    if (l + 1 < p.l0 + p.G) grid.sync();
  }
}

// Co-resident blocks of chain_kernel<BM> on the current device (the smem
// attribute set and the occupancy asked once a device).
template <int BM>
cudaError_t chain_slots(int* slots) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *slots = cached[dev];
    return cudaSuccess;
  }
  const int smem = chain_smem_floats<BM>() * (int)sizeof(float);
  e = cudaFuncSetAttribute(chain_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<BM>, CH_NT, smem);
  *slots = per_sm * sms;
  if (e == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *slots;
  return e;
}

template <int BM>
cudaError_t launch_chain(ChainArgs p, cudaStream_t stream) {
  int slots = 0;
  cudaError_t e = chain_slots<BM>(&slots);
  if (e != cudaSuccess) return e;
  const int n_tiles = p.B * tile::ceil_div(p.T, BM) * (p.C / BP);
  const int grid = n_tiles < slots ? n_tiles : slots;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)chain_kernel<BM>, dim3(grid), dim3(CH_NT),
                                     args, chain_smem_floats<BM>() * sizeof(float), stream);
}

}  // namespace

// Blocks of the chain kernel that can be co-resident on the current device
// with tile rows bm (16, 24 or 32), or -1 on an error.
extern "C" int wavenet_chain_slots(int bm) {
  int slots = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (bm == 16) e = chain_slots<16>(&slots);
  if (bm == 24) e = chain_slots<24>(&slots);
  if (bm == 32) e = chain_slots<32>(&slots);
  return e == cudaSuccess ? slots : -1;
}

// x: [B,T,C] in: x0, out: the last layer's residual (scratch for the caller);
// skip: [B,T,C] out: skip / sqrt(L); gate: [B,T,C] scratch; sp: [L,B,C]
// scratch; zc: [group,B,T,2C] scratch. Weights stacked over layers:
// dw [L,3,C,2C], db [L,2C], diffw [L,C,C], diffb [L,C], cw [L,H,2C],
// cb [L,2C], ow [L,C,2C], ob [L,2C]. Runs the layers in groups of `group`:
// 1 + 2 * ceil(L / group) launches on `stream`, the chain with tile rows bm
// (16, 24 or 32). Needs C % 32 == 0, H % 8 == 0. Returns the first launch error
// (cudaError_t; a refused cooperative launch included) or 0.
extern "C" int wavenet_residual_stack(
    float* x, float* skip, float* gate, float* sp, float* zc, const float* cond,
    const float* step, const float* dw, const float* db, const float* diffw,
    const float* diffb, const float* cw, const float* cb, const float* ow,
    const float* ob, int B, int T, int C, int H, int L, int group, int bm, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || group < 1 || C % BP != 0 || H % CD_BK != 0 ||
      (bm != 16 && bm != 24 && bm != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = wavenet::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream);
  if (err != cudaSuccess) return (int)err;
  const int M = B * T, c2 = 2 * C;
  for (int l0 = 0; l0 < L; l0 += group) {
    const int G = L - l0 < group ? L - l0 : group;
    cond_kernel<<<dim3(tile::ceil_div(c2, CD_BN), tile::ceil_div(M, CD_BM), G), CD_NT, 0,
                  stream>>>(cond, cw + (size_t)l0 * H * c2, cb + (size_t)l0 * c2,
                            db + (size_t)l0 * c2, zc, M, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const ChainArgs p{x, skip, gate, sp, zc, dw, ow, ob, B, T, C, L, l0, G,
                      (float)(1.0 / sqrt((double)L))};
    err = bm == 16   ? launch_chain<16>(p, stream)
          : bm == 24 ? launch_chain<24>(p, stream)
                     : launch_chain<32>(p, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
