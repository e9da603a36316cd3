// WaveNet residual stack with bf16 weight streams (K1-bf16) for Hopper.
//
// Replaces the Pallas TPU kernels fused_residual_stack
// (prodiff_tpu/ops/pallas/wavenet.py:177) and fused_residual_stack_tiled
// (prodiff_tpu/ops/pallas/wavenet.py:261) when their stacked weights are
// bf16 (stack_wavenet_params(stream_dtype=bfloat16), the JAX package's
// default kernel route): in the layer body (_wavenet_layer_step, :124) every
// product takes bf16 operands (cdt = dw.dtype) and accumulates in float32,
// while the residual x, the skip sum and the step projection stay float32.
// Here y = x + step_proj, cond and the gate are rounded to bf16 as they are
// staged for the tensor cores (mma.sync m16n8k16 bf16 x bf16 -> f32,
// mma_bf16.cuh); x and skip stay float32 in registers and memory. It
// returns skip / sqrt(L). The float32 variant is wavenet_stack.cu.
//
// What bounds it on the H100: the products are 13.4 GFLOP at B=1, T=512,
// C=H=256, L=20, 0.014 ms at the bf16 dense rate (989 TFLOP/s), against
// 14 MB of bf16 weights (0.004 ms at 3.35 TB/s); at the main path's small
// M = B*T the grid barriers between the layers' phases and the weights'
// trips through L2 bound it first.
//
// Design, the float32 K1's three launches a stack (wavenet_stack.cu):
//   1. step_proj_kernel (mma_bf16.cuh): sp[l] = bf16(step) . W_s[l] + b_s[l].
//   2. cond_kernel: zc[l] = bf16(cond) . W_c[l] + b_c[l] + b_d[l] for every
//      layer of a group at once, a [B*T, H] x [H, L*2C] tensor-core GEMM
//      (64 x 64 tiles, four warps of 32 x 32).
//   3. chain_kernel: all layers in one cooperative launch (a gate phase, a
//      grid barrier, an out phase and a grid barrier a layer). A tile is
//      BM frames of one sequence x 32 column pairs (j, C+j); each of the 4
//      warps owns 8 pairs, as a gate n-tile and a filter n-tile of the mma,
//      so the gate forms in the accumulators' registers and the residual /
//      skip update too. Reductions run in chunks of 32 (two k16 steps),
//      double-buffered (run_stages): weights by cp.async, the gate phase's
//      activations through registers (x + sp, zero outside [0, T), rounded
//      to bf16), the out phase's bf16 gate by cp.async. The gate scratch is
//      bf16, the out product's operand. BM is 16 or 32 (whole m16 tiles),
//      chosen by the wrapper (ops/wavenet_stack.py:chain_rows with
//      CHAIN_ROWS_BF16). x, skip and the gate are read through L2 only,
//      since other blocks wrote them before the barrier.

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;
using mma::bf16;
using mma::PAD;
using wavenet_bf16::RSQRT2;

constexpr int KC = 32;           // reduction chunk (two k16 steps)
constexpr int LDA = KC + PAD;    // A row: KC bf16 + padding
constexpr int BN = 64, BP = 32;  // a tile's columns: 32 pairs (j, C+j)
constexpr int LDB = BN + PAD;

// ---- cond_kernel: zc [G, B*T, 2C] -----------------------------------------

constexpr int CD_BM = 64, CD_NT = 128;

__global__ void __launch_bounds__(CD_NT)
cond_kernel(const float* __restrict__ cond, const bf16* __restrict__ cw,
            const float* __restrict__ cb, const float* __restrict__ db, float* __restrict__ zc,
            int M, int C, int H) {
  __shared__ __align__(16) bf16 As[2][CD_BM * LDA];
  __shared__ __align__(16) bf16 Bs[2][KC * LDB];
  const int g = blockIdx.z, m0 = blockIdx.y * CD_BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, w = tid / 32, wm = w / 2, wn = w % 2;
  const int c2 = 2 * C;
  const bf16* wg = cw + (size_t)g * H * c2;
  constexpr int NA = CD_BM * KC / 4 / CD_NT;  // float4s of A a thread

  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // B: KC rows x 8 segments of 8 bf16
      const int f = tid + s * CD_NT, k = f / 8, n = f % 8 * 8;
      mma::cp_async16(Bs[buf] + k * LDB + n, wg + (size_t)(i * KC + k) * c2 + n0 + n, true);
    }
    mma::cp_async_commit();
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CD_NT, r = e / (KC / 4), k = e % (KC / 4) * 4;
      ra[s] = m0 + r < M ? mma::ld4(cond + (size_t)(m0 + r) * H + i * KC + k)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int buf, int) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CD_NT, r = e / (KC / 4), k = e % (KC / 4) * 4;
      *reinterpret_cast<uint2*>(As[buf] + r * LDA + k) = mma::pack4(ra[s]);
    }
  };
  float acc[2][4][4] = {};
  const int ncol[4] = {32 * wn, 32 * wn + 8, 32 * wn + 16, 32 * wn + 24};
  mma::run_stages(H / KC, fetch, put, [&](int buf, int) {
    mma::warp_mma<2, 4, 1, KC / 16, LDA, LDB, 0>(As[buf], Bs[buf], 32 * wm, ncol, acc);
  });

  const float* cbg = cb + (size_t)g * c2;
  const float* dbg = db + (size_t)g * c2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 32 * wm + mma::frag_row(mi, h);
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + mma::frag_col(ncol[ni]);
        *reinterpret_cast<float2*>(zc + ((size_t)g * M + row) * c2 + n) =
            make_float2(acc[mi][ni][2 * h] + cbg[n] + dbg[n],
                        acc[mi][ni][2 * h + 1] + cbg[n + 1] + dbg[n + 1]);
      }
    }
}

// ---- chain_kernel: the layers, one cooperative launch ---------------------

constexpr int CH_NT = 128;  // 4 warps, 8 pairs each

struct ChainArgs {
  float* x;         // [B,T,C] the residual, updated in place
  float* skip;      // [B,T,C]
  bf16* gate;       // [B,T,C] scratch: the out product's operand
  const float* sp;  // [L,B,C]
  const float* zc;  // [G,B*T,2C] this group's conditioner terms (+ b_c + b_d)
  const bf16* dw;   // [L,3,C,2C]
  const bf16* ow;   // [L,C,2C]
  const float* ob;  // [L,2C]
  int B, T, C, L, l0, G;
  float last_scale;  // 1/sqrt(L)
};

template <int BM>
__host__ __device__ constexpr int chain_smem_bytes() {
  return 2 * ((BM + 2) * LDA + 3 * KC * LDB) * (int)sizeof(bf16);
}

// B tile [NTAP][KC][BN] of a [.., 2C] weight: rows k0.. of each tap, pair
// columns j0.. and C+j0..
template <int NTAP>
__device__ __forceinline__ void copy_pairs(bf16* bs, const bf16* w, int C, int k0, int j0,
                                           int tid) {
  const size_t c2 = 2 * (size_t)C;
#pragma unroll
  for (int s = 0; s < NTAP * KC * 8 / CH_NT; ++s) {
    const int f = tid + s * CH_NT;
    const int q = f / (KC * 8), k = f / 8 % KC, n = f % 8 * 8;
    const size_t col = n < BP ? j0 + n : C + j0 + n - BP;
    mma::cp_async16(bs + (q * KC + k) * LDB + n, w + ((size_t)q * C + k0 + k) * c2 + col, true);
  }
  mma::cp_async_commit();
}

template <int BM>
__device__ void gate_tile(const ChainArgs& p, int l, int b, int t0, int j0, bf16* smem) {
  constexpr int MT = BM / 16, NA = mma::ceil_div((BM + 2) * KC / 4, CH_NT);
  bf16* As[2] = {smem, smem + (BM + 2) * LDA};
  bf16* Bs[2] = {smem + 2 * (BM + 2) * LDA, smem + 2 * (BM + 2) * LDA + 3 * KC * LDB};
  const int tid = threadIdx.x, w = tid / 32;
  const int T = p.T, C = p.C;
  const float* xb = p.x + (size_t)b * T * C;
  const float* spb = p.sp + ((size_t)l * p.B + b) * C;
  const bf16* dw = p.dw + (size_t)l * 3 * C * 2 * C;

  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
    copy_pairs<3>(Bs[buf], dw, C, i * KC, j0, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CH_NT, r = e / (KC / 4), k = i * KC + e % (KC / 4) * 4;
      const int t = t0 - 1 + r;
      ra[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < BM + 2 && t >= 0 && t < T)
        ra[s] = mma::add4(mma::ld4_l2(xb + (size_t)t * C + k), mma::ld4(spb + k));
    }
  };
  auto put = [&](int buf, int) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * CH_NT, r = e / (KC / 4);
      if (r < BM + 2)
        *reinterpret_cast<uint2*>(As[buf] + r * LDA + e % (KC / 4) * 4) = mma::pack4(ra[s]);
    }
  };
  float acc[MT][2][4] = {};
  const int ncol[2] = {8 * w, BP + 8 * w};
  mma::run_stages(C / KC, fetch, put, [&](int buf, int) {
    mma::warp_mma<MT, 2, 3, KC / 16, LDA, LDB, KC * LDB>(As[buf], Bs[buf], 0, ncol, acc);
  });

  const float* zc = p.zc + ((size_t)(l - p.l0) * p.B + b) * T * 2 * C;
  const int j = j0 + mma::frag_col(8 * w);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + mma::frag_row(mi, h);
      if (t >= T) continue;
      const float* zrow = zc + (size_t)t * 2 * C;
      const float zg0 = acc[mi][0][2 * h] + zrow[j], zg1 = acc[mi][0][2 * h + 1] + zrow[j + 1];
      const float zf0 = acc[mi][1][2 * h] + zrow[C + j];
      const float zf1 = acc[mi][1][2 * h + 1] + zrow[C + j + 1];
      mma::st_bf2(p.gate + ((size_t)b * T + t) * C + j, mma::sigmoid(zg0) * tanhf(zf0),
                  mma::sigmoid(zg1) * tanhf(zf1));
    }
}

template <int BM>
__device__ void out_tile(const ChainArgs& p, int l, int b, int t0, int j0, bf16* smem) {
  constexpr int MT = BM / 16;
  bf16* As[2] = {smem, smem + (BM + 2) * LDA};
  bf16* Bs[2] = {smem + 2 * (BM + 2) * LDA, smem + 2 * (BM + 2) * LDA + 3 * KC * LDB};
  const int tid = threadIdx.x, w = tid / 32;
  const int T = p.T, C = p.C;
  const bf16* gb = p.gate + (size_t)b * T * C;
  const bf16* ow = p.ow + (size_t)l * C * 2 * C;

  auto fetch = [&](int buf, int i) {
    copy_pairs<1>(Bs[buf], ow, C, i * KC, j0, tid);
    for (int f = tid; f < BM * 4; f += CH_NT) {  // A: BM rows x 4 segments of 8 bf16
      const int r = f / 4, k = f % 4 * 8, t = t0 + r;
      mma::cp_async16(As[buf] + r * LDA + k, t < T ? gb + (size_t)t * C + i * KC + k : gb, t < T);
    }
    mma::cp_async_commit();
  };
  float acc[MT][2][4] = {};
  const int ncol[2] = {8 * w, BP + 8 * w};
  mma::run_stages(C / KC, fetch, [](int, int) {}, [&](int buf, int) {
    mma::warp_mma<MT, 2, 1, KC / 16, LDA, LDB, 0>(As[buf], Bs[buf], 0, ncol, acc);
  });

  const float* ob = p.ob + (size_t)l * 2 * C;
  const bool first = l == 0;
  const float scale = l == p.L - 1 ? p.last_scale : 1.f;
  const int j = j0 + mma::frag_col(8 * w);
  const float2 obr = *reinterpret_cast<const float2*>(ob + j);
  const float2 obs = *reinterpret_cast<const float2*>(ob + C + j);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + mma::frag_row(mi, h);
      if (t >= T) continue;
      const size_t i = ((size_t)b * T + t) * C + j;
      const float2 xv = mma::ld2_l2(p.x + i);
      *reinterpret_cast<float2*>(p.x + i) =
          make_float2((xv.x + acc[mi][0][2 * h] + obr.x) * RSQRT2,
                      (xv.y + acc[mi][0][2 * h + 1] + obr.y) * RSQRT2);
      float2 sk = make_float2(acc[mi][1][2 * h] + obs.x, acc[mi][1][2 * h + 1] + obs.y);
      if (!first) {
        const float2 o = mma::ld2_l2(p.skip + i);
        sk = make_float2(o.x + sk.x, o.y + sk.y);
      }
      *reinterpret_cast<float2*>(p.skip + i) = make_float2(sk.x * scale, sk.y * scale);
    }
}

template <int BM>
__global__ void __launch_bounds__(CH_NT) chain_kernel(ChainArgs p) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int n_pt = p.C / BP, n_tt = mma::ceil_div(p.T, BM);
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

// Co-resident blocks of chain_kernel<BM> on the current device (asked once a
// device).
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
  const int smem = chain_smem_bytes<BM>();
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
  const int n_tiles = p.B * mma::ceil_div(p.T, BM) * (p.C / BP);
  const int grid = n_tiles < slots ? n_tiles : slots;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)chain_kernel<BM>, dim3(grid), dim3(CH_NT), args,
                                     chain_smem_bytes<BM>(), stream);
}

}  // namespace

// Blocks of the bf16 chain kernel that can be co-resident on the current
// device with tile rows bm (16 or 32), or -1 on an error.
extern "C" int wavenet_chain_slots_bf16(int bm) {
  int slots = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (bm == 16) e = chain_slots<16>(&slots);
  if (bm == 32) e = chain_slots<32>(&slots);
  return e == cudaSuccess ? slots : -1;
}

// As wavenet_residual_stack (wavenet_stack.cu) with the four weight matrices
// bf16 (dw [L,3,C,2C], diffw [L,C,C], cw [L,H,2C], ow [L,C,2C]) and the gate
// scratch bf16; x, skip, sp, zc, cond, step and the biases float32. Runs the
// layers in groups of `group`: 1 + 2 * ceil(L / group) launches on `stream`,
// the chain with tile rows bm (16 or 32). Needs C % 32 == 0, H % 32 == 0.
// Returns the first launch error (cudaError_t; a refused cooperative launch
// included) or 0.
extern "C" int wavenet_residual_stack_bf16(
    float* x, float* skip, bf16* gate, float* sp, float* zc, const float* cond,
    const float* step, const bf16* dw, const float* db, const bf16* diffw, const float* diffb,
    const bf16* cw, const float* cb, const bf16* ow, const float* ob, int B, int T, int C, int H,
    int L, int group, int bm, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || group < 1 || C % BP != 0 || H % KC != 0 ||
      (bm != 16 && bm != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = wavenet_bf16::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream);
  if (err != cudaSuccess) return (int)err;
  const int M = B * T, c2 = 2 * C;
  for (int l0 = 0; l0 < L; l0 += group) {
    const int G = L - l0 < group ? L - l0 : group;
    cond_kernel<<<dim3(c2 / BN, mma::ceil_div(M, CD_BM), G), CD_NT, 0, stream>>>(
        cond, cw + (size_t)l0 * H * c2, cb + (size_t)l0 * c2, db + (size_t)l0 * c2, zc, M, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const ChainArgs p{x, skip, gate, sp, zc, dw, ow, ob, B, T, C, L, l0, G,
                      (float)(1.0 / sqrt((double)L))};
    err = bm == 16 ? launch_chain<16>(p, stream) : launch_chain<32>(p, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
