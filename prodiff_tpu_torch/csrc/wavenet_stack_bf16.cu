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
// staged for the tensor cores (bf16 x bf16 -> f32: mma.sync in the step
// projection and the cond GEMM, mma_bf16.cuh; wgmma in the layer chain,
// hopper.cuh); x and skip stay float32. It returns skip / sqrt(L). The
// float32 variant is wavenet_stack.cu.
//
// What bounds it on the H100: the products are 13.4 GFLOP at B=1, T=512,
// C=H=256, L=20, 0.014 ms at the bf16 dense rate (989 TFLOP/s), against
// 14 MB of bf16 weights (0.004 ms at 3.35 TB/s). At the main path's small
// M = B*T the earlier design (one cooperative launch, a grid barrier after
// each layer's gate phase and out phase) spent 12.4 + 6.5 us a layer in the
// phases, streaming each phase's weight slice through L2 in 32-row chunks
// on the critical path, and 3 us at the barriers (PERF.md §7). This design
// spends ~12.5 us a layer (B=1, T=512, H100): 6.2 in the gate product, 1.8
// in the out product, ~1.8 in each of the two exchanges between a
// cluster's blocks, the rest in the epilogues (chip_smoke.py's stamped
// build, K1_STAMPS).
//
// Design, 1 + 2 x (layer groups) launches a stack (one step projection, then
// a cond GEMM and a chain launch per layer group):
//   1. step_proj_kernel (mma_bf16.cuh): sp[l] = bf16(step) . W_s[l] + b_s[l].
//   2. cond_kernel: zc[l] = bf16(cond) . W_c[l] + b_c[l] + b_d[l] for every
//      layer of a group at once, a [B*T, H] x [H, L*2C] tensor-core GEMM
//      (64 x 64 tiles, four warps of 32 x 32).
//   3. cluster_chain_kernel: the group's G layers with no grid barrier. A
//      thread-block cluster of CS = C / 32 blocks owns one row tile of bm
//      frames of one sequence; block r of it owns the 32 column pairs (j,
//      C + j), j = 32 r ..: its gate channels, its residual and skip
//      channels. The cluster computes a window of MW = 64 NWG frames, bm
//      plus G a side (fused_residual_stack_tiled's halo: each layer's k = 3
//      conv spoils one more frame at each window edge, so after G layers the
//      middle bm frames are exact; frames outside [0, T) are the conv's zero
//      padding at every layer), so no block needs another tile's rows. Each
//      layer, by wgmma (m64n64k16 a warpgroup, NWG warpgroups a block: A, y
//      or the gate, by ldmatrix from shared memory at the tap's row shift,
//      B the ring stage's two 64-byte-swizzled boxes as one N = 64 tile):
//      the gate phase (y [MW + 2][C] times the block's dw slice [3C][64];
//      the gate forms in the accumulators as the gate and filter n8 tiles of
//      one column meet in one thread), the block's gate slice copied to
//      every other block of the cluster; the out phase (the gate [MW][C]
//      times the block's ow slice [C][64]), x and skip updated in registers,
//      the next layer's y for the block's channels copied likewise. y and
//      the gate are channel-blocked in shared memory ([C/32][rows][32],
//      rows of 64 bytes swizzled as the boxes are), so a block's slice is
//      one run: one bulk copy to each other block (cp.async.bulk
//      shared::cluster), completing on that block's exchange mbarrier, and
//      a block waits for the others' slices there: no cluster barrier a
//      phase. A block rewrites its y (gate) slice only after every other
//      block has sent it the gate (y) that depends on its reading the
//      previous one, so one buffer of each suffices. x, skip and zc stay per
//      thread at the accumulators' positions; x and skip go to memory once,
//      at the group's end (the next group reads x from another buffer: a
//      neighbour's halo rows are read before they are rewritten). The weight
//      stream is off the critical path: the block's slices of dw and ow come
//      by TMA (two 128-row boxes of 32 columns a stage) into a ring of up to
//      8 16-KB stages, each completing on an mbarrier; a producer warp
//      keeps the ring full, so the next layer's weights are in flight while
//      a layer computes and while the cluster exchanges. The layer group
//      and NWG (1 or 2) are chosen together by
//      ops/wavenet_stack.py:bf16_schedule from the clusters that fit on the
//      card at once: a shorter group's narrower window can fill the card in
//      as few rounds (B=1, T=512: two groups of 10 layers, NWG 1).

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::bf16;
using mma::PAD;
using wavenet_bf16::RSQRT2;

constexpr int KC = 32;           // cond_kernel's reduction chunk (two k16 steps)
constexpr int LDA = KC + PAD;    // A row: KC bf16 + padding
constexpr int BN = 64;           // cond_kernel's tile columns
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

// ---- cluster_chain_kernel: a layer group, one cluster a row tile ----------

constexpr int PB = 32;             // column pairs a block: a channel block of 64 bytes a row
constexpr int BKR = 128;           // weight rows a ring stage
constexpr int BOX = BKR * PB * 2;  // bytes of one box: 128 rows x 32 bf16
constexpr int STAGE = 2 * BOX;     // gate (or residual) columns + filter (or skip) columns
constexpr int MAX_STAGES = 8, MAX_NWG = 2, MAX_CLUSTER = 16;
constexpr int SMEM_LIMIT = 232448;

// K1_SKIP (0 in the kernel the port runs) builds variants that leave a part
// out, for measuring where the time goes (tools/probe_bf16_kernels.py): bit
// 0 the weight stream (no copy, no wait: the products run on whatever the
// ring holds), bit 1 the exchange between the cluster's blocks (no copy, no
// wait), bit 2 the per-layer loads of zc, the out bias and the step
// projection (zeros), bit 3 the products' wgmma instructions (the loads and
// waits around them stay). Their outputs are for measurement only.
#ifndef K1_SKIP
#define K1_SKIP 0
#endif
constexpr bool RUN_STREAM = !(K1_SKIP & 1), RUN_EXCHANGE = !(K1_SKIP & 2),
               RUN_LAYER_LOADS = !(K1_SKIP & 4), RUN_WGMMA = !(K1_SKIP & 8);

// K1_STAMPS (0 in the kernel the port runs) builds a variant whose blocks
// stamp %globaltimer at each phase edge of each layer (thread 0, the first
// K1_STAMP_BLOCKS blocks of the grid), read by wavenet_read_stamps_bf16.
#ifndef K1_STAMPS
#define K1_STAMPS 0
#endif
constexpr int K1_STAMP_BLOCKS = 64, K1_STAMP_LAYERS = 64, K1_STAMP_EDGES = 6;
__device__ unsigned long long k1_stamps[K1_STAMPS ? K1_STAMP_BLOCKS * K1_STAMP_LAYERS * K1_STAMP_EDGES : 1];

__device__ __forceinline__ void k1_stamp(int layer, int edge) {
  if (!K1_STAMPS || threadIdx.x != 0) return;
  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (blk >= K1_STAMP_BLOCKS || layer >= K1_STAMP_LAYERS) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  k1_stamps[(blk * K1_STAMP_LAYERS + layer) * K1_STAMP_EDGES + edge] = t;
}

// The gate's nonlinearities by the fast exponential (a few units of float32's
// last place; the gate is rounded to bf16 next).
__device__ __forceinline__ float fast_sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float fast_tanh(float v) {
  return __fdividef(2.f, 1.f + __expf(-2.f * v)) - 1.f;
}

struct ClusterArgs {
  const float* x_in;  // [B,T,C] the group's input residual
  float* x_out;       // [B,T,C] the residual after the group (null for the last group)
  float* skip;        // [B,T,C]
  const float* sp;    // [L,B,C]
  const float* zc;    // [G,B*T,2C] this group's conditioner terms (+ b_c + b_d)
  const float* ob;    // [L,2C]
  int B, T, C, L, l0, G, bm, S;
  float last_scale;   // 1/sqrt(L)
};

// A block's shared memory at NWG warpgroups (a window of 64 NWG frames; as
// ops/wavenet_stack.py:cluster_plan): y [C/32][64 NWG + 8][32] and the gate
// [C/32][64 NWG][32] in bf16, channel-blocked (a block's 32 channels are one
// contiguous run, the unit of the exchange), then the weight ring and its
// mbarriers and the two exchange mbarriers.
__host__ __device__ constexpr int cluster_fixed(int C, int nwg) {
  return 1024 + (C / PB) * ((64 * nwg + 8) + 64 * nwg) * PB * 2 + 16;
}
__host__ __device__ constexpr int cluster_stages(int C, int nwg) {
  const int s = (SMEM_LIMIT - cluster_fixed(C, nwg)) / (STAGE + 16);
  return s > MAX_STAGES ? MAX_STAGES : s;
}
__host__ __device__ constexpr int cluster_smem(int C, int nwg) {
  return cluster_fixed(C, nwg) + cluster_stages(C, nwg) * (STAGE + 16);
}

// acc (this warp's m64n64 fragment: n8 tiles 0-3 the first box's 32 columns,
// 4-7 the second's) = A x the ring's next `stages` stages of `rows` weight
// rows (row = q C + k: tap q reads A q rows further down). A is
// channel-blocked, `bstride` bytes a channel block, rows of 64 bytes swizzled
// as the 64-byte TMA boxes are; `row` is this lane's first A row. A stage's
// eight k16 slices go to the tensor cores in one commit.
// acc (this warp's m64n64 fragment: n8 tiles 0-3 the first box's 32 columns,
// 4-7 the second's) = A x the ring's next `stages` stages of `rows` weight
// rows (row = q C + k: tap q reads A q rows further down). A is
// channel-blocked, `bstride` bytes a channel block, rows of 64 bytes swizzled
// as the 64-byte TMA boxes are; `row` is this lane's first A row. A stage's
// eight k16 slices are one wgmma group, waited for before the stage is
// released (loading the next stage while a group runs, with two sets of A
// registers, measured slower).
__device__ __forceinline__ void chain_product(float (&acc)[32], const unsigned char* A,
                                              int bstride, int row, int stages, int rows, int C,
                                              const unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, int S, int& n) {
  constexpr int SL = BKR / 16;
  const int lane = threadIdx.x & 31, akof = (lane >> 4) * 8;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  int q = 0, k0 = 0;  // the next slice's tap and first input channel
  for (int st = 0; st < stages; ++st, ++n) {
    if (RUN_STREAM) hopper::mbar_wait(full + n % S, (n / S) & 1);
    const unsigned char* Bs = ring + n % S * STAGE;
    const int valid = rows - st * BKR < BKR ? (rows - st * BKR) / 16 : SL;  // slices of this stage
    uint32_t a[SL][4];
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      if (j < valid)
        mma::ldsm_x4(a[j], reinterpret_cast<const bf16*>(
                               A + k0 / PB * bstride +
                               hopper::swz<64>((row + q) * 64 + (k0 % PB + akof) * 2)));
      k0 += 16;
      if (k0 == C) {
        k0 = 0;
        ++q;
      }
    }
#pragma unroll
    for (int j = 0; j < SL; ++j) hopper::fence_operand(a[j]);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < SL; ++j)
      if (j < valid && RUN_WGMMA)
        hopper::wgmma_rs<64>(acc, a[j], hopper::smem_desc<64>(Bs + 16 * j * 64, BOX, 512));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    __syncwarp();
    if (lane == 0 && RUN_STREAM) hopper::mbar_arrive(empty + n % S);
  }
}

template <int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
cluster_chain_kernel(const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap omap, ClusterArgs p) {
  // NWG consumer warpgroups, then one producer warp
  constexpr int MW = 64 * NWG, YR = MW + 8, THREADS = 128 * NWG, WARPS = 4 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = p.C, CB = C / PB, S = p.S, G = p.G;
  unsigned char* Yb = base + S * STAGE;  // [CB][YR][64 B]: row i is frame tw0 - 1 + i
  unsigned char* Gb = Yb + CB * YR * 64;  // [CB][MW][64 B]: row r is frame tw0 + r
  uint64_t* full = reinterpret_cast<uint64_t*>(Gb + CB * MW * 64);
  uint64_t* empty = full + S;
  uint64_t* ybar = empty + S;  // the other blocks' y slices have landed
  uint64_t* gbar = ybar + 1;   // ... their gate slices
  const int rank = blockIdx.x, j0 = rank * PB;
  const int b = blockIdx.z, t0 = blockIdx.y * p.bm, tw0 = t0 - G, T = p.T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NG = (3 * C + BKR - 1) / BKR, NO = (C + BKR - 1) / BKR, PER = NG + NO;
  const int total = G * PER;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, WARPS);
    }
    hopper::mbar_init(ybar, 1);
    hopper::mbar_init(gbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // the window's edge rows of y (0 and MW + 1 ..) are the conv's zero padding
  for (int e = tid; e < CB * (YR - MW) * 4; e += THREADS) {
    const int cb = e / ((YR - MW) * 4), r = e / 4 % (YR - MW), r_at = r == 0 ? 0 : MW + r;
    *reinterpret_cast<uint4*>(Yb + cb * YR * 64 + r_at * 64 + e % 4 * 16) = make_uint4(0, 0, 0, 0);
  }
  hopper::cluster_sync();  // every block's mbarriers are set before any exchange lands

  if (warp == WARPS) {  // the producer: the group's weight stages, in order
    if (lane == 0 && RUN_STREAM)
      for (int m = 0; m < total; ++m) {
        const int slot = m % S, l = p.l0 + m / PER, s = m % PER;
        hopper::mbar_wait(empty + slot, ((m / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full + slot, STAGE);
        const CUtensorMap* map = s < NG ? &dmap : &omap;
        const int wrow = s < NG ? l * 3 * C + s * BKR : l * C + (s - NG) * BKR;
        hopper::tma_load_2d(base + slot * STAGE, map, j0, wrow, full + slot);
        hopper::tma_load_2d(base + slot * STAGE + BOX, map, C + j0, wrow, full + slot);
      }
    return;
  }

  // this thread's accumulator positions: frames R(h) = 64 wg + 16 wq + g + 8 h
  // of the window, the block's pair columns c(j) = 8 j + 2 (lane % 4) and + 1
  const int r0 = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  float xo[4][2][2], sk[4][2][2];
  const float* xb = p.x_in + (size_t)b * T * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = tw0 + r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = t >= 0 && t < T
                           ? *reinterpret_cast<const float2*>(xb + (size_t)t * C + j0 + 8 * j + cl)
                           : make_float2(0.f, 0.f);
      xo[j][h][0] = v.x;
      xo[j][h][1] = v.y;
      sk[j][h][0] = sk[j][h][1] = 0.f;
    }
  }

  // this block's channel block of buf (bytes from `from`) to every other
  // block, then wait for theirs on bar (its phase `phase`)
  auto exchange = [&](unsigned char* from, int bytes, uint64_t* bar, int phase) {
    if (!RUN_EXCHANGE) {
      hopper::bar_sync(1, THREADS);
      return;
    }
    hopper::fence_async_shared();
    hopper::bar_sync(1, THREADS);
    if (tid == 0) {
      hopper::mbar_expect_tx(bar, (gridDim.x - 1) * bytes);
      for (int r = 0; r < (int)gridDim.x; ++r)
        if (r != rank)
          hopper::bulk_to_peer(hopper::map_rank(from, r), from, bytes, hopper::map_rank(bar, r));
    }
    hopper::mbar_wait(bar, phase);
  };
  unsigned char* my_y = Yb + rank * YR * 64;  // this block's channel blocks
  unsigned char* my_g = Gb + rank * MW * 64;
  // the step projection of layer l at this thread's columns
  auto load_sp = [&](int l, float2 (&spv)[4]) {
    const float* spl = p.sp + ((size_t)l * p.B + b) * C + j0 + cl;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      spv[j] = RUN_LAYER_LOADS || l == p.l0 ? *reinterpret_cast<const float2*>(spl + 8 * j)
                                            : make_float2(0.f, 0.f);
  };
  // y = bf16(x + sp) on this thread's positions, zero outside [0, T)
  auto put_y = [&](const float2 (&spv)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, t = tw0 + r;
        const bool in = t >= 0 && t < T;
        mma::st_bf2(reinterpret_cast<bf16*>(my_y + hopper::swz<64>((r + 1) * 64 + (8 * j + cl) * 2)),
                    in ? xo[j][h][0] + spv[j].x : 0.f, in ? xo[j][h][1] + spv[j].y : 0.f);
      }
    }
  };
  float2 spv[4], obr[4], obs[4];
  load_sp(p.l0, spv);
  put_y(spv);
  exchange(my_y + 64, MW * 64, ybar, 0);
  int yph = 1;

  const int arow = 16 * warp + (lane & 15);  // this lane's ldmatrix row (its warp's 16 of 64)
  int n = 0;                                 // ring stages taken
  float acc[32];
  for (int li = 0; li < G; ++li) {
    const int l = p.l0 + li;
    k1_stamp(li, 0);
    // the gate phase: z = y * dw + zc; the gate to every block. This
    // layer's zc, out bias and the next layer's step projection are loaded
    // first, to land while the products run.
    float zv[4][2][2][2];  // [j][h][gate, filter][2]
    const float* zcb = p.zc + ((size_t)li * p.B + b) * T * 2 * C + j0 + cl;
    const float* obl = p.ob + (size_t)l * 2 * C + j0 + cl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      obr[j] = RUN_LAYER_LOADS ? *reinterpret_cast<const float2*>(obl + 8 * j) : make_float2(0.f, 0.f);
      obs[j] = RUN_LAYER_LOADS ? *reinterpret_cast<const float2*>(obl + C + 8 * j)
                               : make_float2(0.f, 0.f);
    }
    if (li + 1 < G) load_sp(l + 1, spv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = tw0 + r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 zg = make_float2(0.f, 0.f), zf = zg;
        if (RUN_LAYER_LOADS && t >= 0 && t < T) {
          zg = *reinterpret_cast<const float2*>(zcb + (size_t)t * 2 * C + 8 * j);
          zf = *reinterpret_cast<const float2*>(zcb + (size_t)t * 2 * C + C + 8 * j);
        }
        zv[j][h][0][0] = zg.x;
        zv[j][h][0][1] = zg.y;
        zv[j][h][1][0] = zf.x;
        zv[j][h][1][1] = zf.y;
      }
    }
    chain_product(acc, Yb, YR * 64, arow, NG, 3 * C, C, base, full, empty, S, n);
    k1_stamp(li, 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float g0 = fast_sigmoid(acc[4 * j + 2 * h] + zv[j][h][0][0]) *
                         fast_tanh(acc[16 + 4 * j + 2 * h] + zv[j][h][1][0]);
        const float g1 = fast_sigmoid(acc[4 * j + 2 * h + 1] + zv[j][h][0][1]) *
                         fast_tanh(acc[16 + 4 * j + 2 * h + 1] + zv[j][h][1][1]);
        mma::st_bf2(reinterpret_cast<bf16*>(my_g + hopper::swz<64>((r0 + 8 * h) * 64 +
                                                                    (8 * j + cl) * 2)),
                    g0, g1);
      }
    k1_stamp(li, 2);
    exchange(my_g, MW * 64, gbar, li & 1);
    k1_stamp(li, 3);

    // the out phase: o = gate * ow + ob; x and skip in registers; the next y
    chain_product(acc, Gb, MW * 64, arow, NO, C, C, base, full, empty, S, n);
    k1_stamp(li, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xo[j][h][0] = (xo[j][h][0] + acc[4 * j + 2 * h] + obr[j].x) * RSQRT2;
        xo[j][h][1] = (xo[j][h][1] + acc[4 * j + 2 * h + 1] + obr[j].y) * RSQRT2;
        sk[j][h][0] += acc[16 + 4 * j + 2 * h] + obs[j].x;
        sk[j][h][1] += acc[16 + 4 * j + 2 * h + 1] + obs[j].y;
      }
    }
    if (li + 1 < G) {
      put_y(spv);
      exchange(my_y + 64, MW * 64, ybar, yph);
      yph ^= 1;
    }
    k1_stamp(li, 5);
  }

  // the tile's bm frames: x for the next group, skip (summed over groups)
  const bool last_group = p.l0 + G == p.L;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h, t = tw0 + r;
    if (r < G || r >= G + p.bm || t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t i = ((size_t)b * T + t) * C + j0 + 8 * j + cl;
      if (p.x_out) *reinterpret_cast<float2*>(p.x_out + i) = make_float2(xo[j][h][0], xo[j][h][1]);
      float2 v = make_float2(sk[j][h][0], sk[j][h][1]);
      if (p.l0 > 0) {
        const float2 o = *reinterpret_cast<const float2*>(p.skip + i);
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      if (last_group) v = make_float2(v.x * p.last_scale, v.y * p.last_scale);
      *reinterpret_cast<float2*>(p.skip + i) = v;
    }
  }
}

template <int NWG>
cudaError_t cluster_attrs() {
  cudaError_t e = cudaFuncSetAttribute(cluster_chain_kernel<NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(cluster_chain_kernel<NWG>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int NWG>
cudaLaunchConfig_t cluster_config(int C, int tiles, int B, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / PB, tiles, B);
  cfg.blockDim = dim3(128 * NWG + 32);
  cfg.dynamicSmemBytes = cluster_smem(C, NWG);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C / PB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NWG>
cudaError_t launch_cluster(const CUtensorMap& dmap, const CUtensorMap& omap, ClusterArgs p,
                           cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !ready[dev]) {
    if ((e = cluster_attrs<NWG>()) != cudaSuccess) return e;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  p.S = cluster_stages(p.C, NWG);
  if (p.S < 2 || p.bm < 1 || p.bm > 64 * NWG - 2 * p.G) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<NWG>(p.C, (p.T + p.bm - 1) / p.bm, p.B, stream, attr);
  return cudaLaunchKernelEx(&cfg, cluster_chain_kernel<NWG>, dmap, omap, p);
}

template <int NWG>
int cluster_slots(int C) {
  if (cluster_stages(C, NWG) < 2) return 0;
  if (cluster_attrs<NWG>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<NWG>(C, 1, 1, 0, attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, cluster_chain_kernel<NWG>, &cfg) == cudaSuccess ? n
                                                                                            : -1;
}

}  // namespace

// Clusters of the chain at (C, NWG) that fit on the current device at once
// (0 where the window does not fit in shared memory), or -1 on an error.
extern "C" int wavenet_cluster_slots_bf16(int C, int nwg) {
  if (C % PB || C / PB > MAX_CLUSTER) return -1;
  switch (nwg) {
    case 1: return cluster_slots<1>(C);
    case 2: return cluster_slots<2>(C);
    default: return -1;
  }
}

// Copies the K1_STAMPS build's stamps ([block][layer][edge] ns: a layer's
// start, after its gate product, after the gate epilogue, after the gate
// exchange, after the out product, after the y exchange) to host memory.
extern "C" int wavenet_read_stamps_bf16(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k1_stamps, n * sizeof(unsigned long long));
}

// Zeroes the stamps (a stamp left 0 was not taken: a group's later layers).
extern "C" int wavenet_clear_stamps_bf16() {
  void* at = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&at, k1_stamps);
  return (int)(e != cudaSuccess ? e : cudaMemset(at, 0, sizeof(k1_stamps)));
}

// Shared-memory bytes of a chain block at (C, NWG) (a check for
// ops/wavenet_stack.py:cluster_plan), 0 where it does not fit.
extern "C" int wavenet_cluster_smem_bf16(int C, int nwg) {
  return cluster_stages(C, nwg) < 2 ? 0 : cluster_smem(C, nwg);
}

// As wavenet_residual_stack (wavenet_stack.cu) with the four weight matrices
// bf16 (dw [L,3,C,2C], diffw [L,C,C], cw [L,H,2C], ow [L,C,2C]); x0, skip,
// sp, zc, cond, step and the biases float32. x0 is read only; xa and xb
// [B,T,C] hold the residual between layer groups (unused with one group).
// Runs the layers in groups of `group`: 1 + 2 * ceil(L / group) launches on
// `stream`, the chain with windows of 64 * nwg frames and row tiles of
// 64 * nwg - 2 * group (ops/wavenet_stack.py:bf16_schedule). Needs C % 32 == 0
// (C <= 512), H % 32 == 0. Returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_residual_stack_bf16(
    const float* x0, float* xa, float* xb, float* skip, float* sp, float* zc, const float* cond,
    const float* step, const bf16* dw, const float* db, const bf16* diffw, const float* diffb,
    const bf16* cw, const float* cb, const bf16* ow, const float* ob, int B, int T, int C, int H,
    int L, int group, int nwg, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || group < 1 || C % PB != 0 || C / PB > MAX_CLUSTER ||
      H % KC != 0 || nwg < 1 || nwg > MAX_NWG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = wavenet_bf16::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap dmap, omap;
  int e = hopper::make_map_2d(&dmap, dw, (uint64_t)L * 3 * C, 2 * C, BKR, PB,
                              CU_TENSOR_MAP_SWIZZLE_64B);
  if (!e) e = hopper::make_map_2d(&omap, ow, (uint64_t)L * C, 2 * C, BKR, PB,
                                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (e) return e;
  const int M = B * T, c2 = 2 * C;
  const float* x_in = x0;
  for (int l0 = 0, gi = 0; l0 < L; l0 += group, ++gi) {
    const int G = L - l0 < group ? L - l0 : group;
    cond_kernel<<<dim3(c2 / BN, mma::ceil_div(M, CD_BM), G), CD_NT, 0, stream>>>(
        cond, cw + (size_t)l0 * H * c2, cb + (size_t)l0 * c2, db + (size_t)l0 * c2, zc, M, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* x_out = l0 + G < L ? (gi % 2 ? xb : xa) : nullptr;
    const ClusterArgs p{x_in, x_out, skip, sp, zc, ob, B, T, C, L, l0, G, 64 * nwg - 2 * G, 0,
                        (float)(1.0 / sqrt((double)L))};
    err = nwg == 1 ? launch_cluster<1>(dmap, omap, p, stream)
                   : launch_cluster<2>(dmap, omap, p, stream);
    if (err != cudaSuccess) return (int)err;
    x_in = x_out;
  }
  return 0;
}
