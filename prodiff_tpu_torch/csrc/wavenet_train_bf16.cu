// Trainable WaveNet residual stack with bf16 operands and saves (K5a-bf16,
// K5b-bf16) for Hopper: the save-forward and the sequential backward chain.
//
// Replaces the Pallas TPU kernels _fwd_save_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:71) and _bwd_chain_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:161) with save_dtype = bfloat16
// and bf16 weight streams. The function, at the twins' rounding points
// (ops/wavenet_train.py:residual_stack_save_plain, residual_stack_chain_plain):
//   save-forward, per layer l on the float32 residual x and skip sum:
//     y = bf16(x + sp[l]),  sp[l] = bf16(step) . W_s[l] + b_s[l];
//     z = sum_q y[t+q-1] . W_d[l,q] + bf16(cond) . W_c[l] + b_d + b_c
//         (zero outside [0, T)); xs[l] = bf16(x), zs[l] = bf16(z);
//     o = bf16(sigmoid(z[:, :C]) tanh(z[:, C:])) . W_o[l] + b_o;
//     x = (x + o[:, :C]) / sqrt(2), skip += o[:, C:]; skip / sqrt(L) at the end;
//   backward chain, l from L-1 down to 0 on the float32 carry dx (0 at first):
//     dgate = bf16([dx / sqrt(2), g / sqrt(L)]) . W_o[l]^T;
//     dz = bf16(dgate tanh(zf) a (1 - a), dgate a (1 - tanh^2(zf))), a =
//         sigmoid(zg), from the bf16 zs[l];
//     dy_t = dz_t . W_d[1]^T + dz_{t+1} . W_d[0]^T + dz_{t-1} . W_d[2]^T;
//     dy[l] = bf16(dy), dx = dx / sqrt(2) + dy (float32, the unrounded dy).
// Every product takes bf16 operands and accumulates in float32 on the tensor
// cores (wgmma). The weight, cond and step gradients stay outside any kernel
// (ops/wavenet_train.py:stack_param_grads), as the JAX package leaves them to
// XLA einsums. The float32 variant is wavenet_train.cu.
//
// What bounds it on the H100 80GB HBM3 (700 W): at B=16, T=1536, C=H=256,
// L=20 the save-forward is 644 GFLOP (0.65 ms at 989 TFLOP/s) and the chain
// 515 GFLOP (0.52 ms), against ~0.76 GB of bf16 saves each way (0.23 ms at
// 3.35 TB/s): the tensor cores.
//
// The earlier design ran 1 + 2L and 2L launches of mma.sync tiles
// (64 frames x 32 column pairs, or 64 columns, a block): per layer a gate
// kernel and an out kernel through a bf16 gate in device memory, and the
// chain's dgate/dz kernel and dy kernel through dz. Each of the C/32 (C/64)
// column blocks of a frame tile re-read and re-rounded the tile's float32
// activations through registers and streamed its own weight slice from L2.
// Its device time at that shape on the H100 80GB HBM3 at 700 W
// (torch.profiler, tools/probe_bf16_kernels.py --k5-only): save_gate 9.60
// ms, save_out 1.73, step projection 0.014; chain_gate 1.52, chain_dy 2.81.
//
// This design, one launch a layer (save-forward: L + 2 launches, chain:
// L + 1; ops/wavenet_train.py:train_launches):
//   - A block owns a frame tile of one sequence (64 frames in the
//     save-forward, 128 in the chain) across ALL 2C columns, so a tile's
//     activations are staged and rounded once. Blocks are persistent (one an
//     SM) over the layer's tiles.
//   - Operands arrive by TMA, never through registers, in a ring of stages
//     fed by a producer warp (mbarriers, hopper.cuh). The save-forward is an
//     implicit GEMM: a stage holds a 64 x 64 slice of A, tap q's being y's
//     tile shifted by q - 1 frames (a box of its own; zeros outside [0, T)),
//     or the cond tile, and the matching 64-row weight slice; both swizzled
//     at 128 bytes. The chain's stages hold its dgate operand's slice (128 x
//     32, swizzled at 64 bytes) and a 32-row weight slice, or 64 weight rows
//     of its dy product.
//   - Rounding happens once where a value is made: bf16(cond) and bf16(g /
//     sqrt(L)) once a call (a prep launch); a layer's epilogue writes the
//     next layer's bf16 operand (y = bf16(x + sp[l+1]), bf16(dx / sqrt(2)))
//     beside the float32 x or dx, in two buffers that alternate (the next
//     layer's halo rows are other blocks' outputs).
//   - A layer's intermediate stays in shared memory: the gate goes from the
//     gate passes' epilogues into the out passes' A ([C/64][64][64],
//     swizzled as a TMA box would be); the chain's dz from the dgate
//     epilogue into the dy product. A chain tile computes dgate and dz on
//     128 frames from t0 - 1 and stores dy for the 126 in the middle (its
//     two edge rows of dz recomputed, not exchanged); dz is kept as 16-byte
//     channel chunks ([2C/8][frames][8]: a k16 slice of 64 frames from ANY
//     frame is one no-swizzle K-major descriptor, so a tap's row shift moves
//     only its start address, as resblock_bf16.cu does), and the zs tile
//     lands by TMA in that buffer (each thread reads zs and writes dz at the
//     same positions).
//   - Two consumer warpgroups take turns (ping-pong): a pass (64 column
//     pairs of the gate or out product, 128 output columns of dgate or dy)
//     runs on one warpgroup over the whole tile (one or two m64 subtiles), the next
//     pass on the other, so one's epilogue (the device-memory loads and
//     stores of x, skip, zs, y, xs, dz, dy, dx) overlaps the other's
//     products. The products run one after another in the ring's order (an
//     mbarrier hands the turn over), so a gate epilogue follows every
//     earlier product; a barrier waits for the whole gate (dz) before the
//     out (dy) passes, and an mbarrier holds the next tile's zs copy until
//     both have read dz. A producer warpgroup (one or two warps issuing
//     copies) gives its registers to the consumers (setmaxnreg: 40 / 232).
// Shared memory (ops/wavenet_train.py:save_plan / chain_plan compute the
// same; the card holds them equal): save-forward at C=H=256: the gate 32 KB
// and 8 stages of 24 KB; the chain: dz 136 KB (136 rows a channel chunk: a
// TMA destination starts 128-byte aligned) and 5 stages of 16 KB.
//
// Measured on the H100 80GB HBM3 at 700 W (chip_smoke.py --parent, in turns
// with the earlier design): the save-forward 3.10 ms against 11.32, the
// chain 3.38 against 4.45 (21% and 16% of the bounds). Builds that leave a
// part out (K5_SKIP; save-forward / chain): no activation copies 2.79 /
// 3.06 ms, no weight copies 2.78 / 3.29, no wgmma 2.87 / 2.72, no epilogue
// loads and stores 1.73 / 1.78, the ring's handshakes alone 0.71 / 0.92:
// the epilogues' device-memory traffic, not hidden behind the other
// warpgroup's products, is what is left.

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::bf16;
using wavenet_bf16::RSQRT2;

constexpr int BKR = 32;  // rows (k) of a chain dgate stage; its dy stages take 2 BKR
constexpr int MAX_STAGES = 8, MIN_STAGES = 2;
constexpr int SMEM_LIMIT = 232448;
constexpr int CONSUMERS = 256;  // two warpgroups, taking turns over the passes
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one or two warps work)

// K5_SKIP (0 in the kernels the port runs) builds variants that leave a part
// out, for measuring where the time goes (tools/probe_bf16_kernels.py): bit
// 0 the activation tiles' copies (y, the cond tile, zs, the dgate operand),
// bit 1 the weight copies, bit 2 the wgmma instructions, bit 3 the
// epilogues' device-memory loads and stores. Their outputs are for
// measurement only.
#ifndef K5_SKIP
#define K5_SKIP 0
#endif
constexpr bool RUN_ACT = !(K5_SKIP & 1), RUN_W = !(K5_SKIP & 2), RUN_MMA = !(K5_SKIP & 4),
               RUN_EPI = !(K5_SKIP & 8);

// ---- plans: a block's frames are 64 MT (MT m64 subtiles a warpgroup) -------

__host__ __device__ constexpr int clamp_stages(int s) {
  return s < 0 ? 0 : s > MAX_STAGES ? MAX_STAGES : s;
}

// Save-forward: NP column pairs (j, C + j) a pass (N = 2 NP accumulator
// columns), BK rows (k) a stage; the gate [C/BK][BM][BK] bf16 resident, an
// mbarrier, 1024 bytes of alignment slack; a stage holds the A slice (BM x
// BK) and the weight slice (BK x 2 NP).
__host__ __device__ constexpr int save_pairs(int C) { return C % 64 == 0 ? 64 : 32; }
__host__ __device__ constexpr int save_bk(int C, int H) {
  return C % 64 == 0 && H % 64 == 0 ? 64 : 32;
}
__host__ __device__ constexpr int save_fixed(int C, int mt) { return 1024 + 64 * mt * C * 2 + 16; }
__host__ __device__ constexpr int save_stage(int C, int H, int mt) {
  return (64 * mt + 2 * save_pairs(C)) * save_bk(C, H) * 2;
}
__host__ __device__ constexpr int save_stages(int C, int H, int mt) {
  return clamp_stages((SMEM_LIMIT - save_fixed(C, mt)) / (save_stage(C, H, mt) + 16));
}
__host__ __device__ constexpr int save_smem(int C, int H, int mt) {
  return save_fixed(C, mt) + save_stages(C, H, mt) * (save_stage(C, H, mt) + 16);
}
// 64-frame tiles: at the training shape (B=16, T=1536, C=H=256) measured
// 3.03 ms against 3.45 with 128 (H100 80GB HBM3, 700 W; 384 tiles on 132 SMs
// against 192), the chain the other way round (3.35 against 3.74).
__host__ __device__ constexpr int save_mt(int C, int H) {
  return save_stages(C, H, 1) >= MIN_STAGES ? 1 : 0;
}

// The chain's dz tile (BM + 2 frames) keeps halo_rows rows a channel chunk,
// so each chunk, a TMA destination, starts 128-byte aligned.
__host__ __device__ constexpr int halo_rows(int bm) { return bm + 8; }

// Chain: NCOL output columns a pass, dz [2C/8][halo_rows][8] bf16, three
// mbarriers; a stage holds a BM x BKR slice of the dgate operand and a
// BKR-row weight slice of NCOL columns, or a 2 BKR-row one of the dy product.
__host__ __device__ constexpr int chain_cols(int C) { return C % 128 == 0 ? 128 : 64; }
__host__ __device__ constexpr int chain_fixed(int C, int mt) {
  return 1024 + halo_rows(64 * mt) * 2 * C * 2 + 32;
}
__host__ __device__ constexpr int chain_stage(int C, int mt) {
  return 64 * mt * BKR * 2 + BKR * chain_cols(C) * 2 > 2 * BKR * chain_cols(C) * 2
             ? 64 * mt * BKR * 2 + BKR * chain_cols(C) * 2
             : 2 * BKR * chain_cols(C) * 2;
}
__host__ __device__ constexpr int chain_stages(int C, int mt) {
  return clamp_stages((SMEM_LIMIT - chain_fixed(C, mt)) / (chain_stage(C, mt) + 16));
}
__host__ __device__ constexpr int chain_smem(int C, int mt) {
  return chain_fixed(C, mt) + chain_stages(C, mt) * (chain_stage(C, mt) + 16);
}
__host__ __device__ constexpr int chain_mt(int C) {
  return chain_stages(C, 2) >= MIN_STAGES ? 2 : chain_stages(C, 1) >= MIN_STAGES ? 1 : 0;
}

// The gate's nonlinearities by the fast exponential (a few units of float32's
// last place; what they make is rounded to bf16 next), as K1-bf16's.
__device__ __forceinline__ float fast_sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float fast_tanh(float v) {
  return __fdividef(2.f, 1.f + __expf(-2.f * v)) - 1.f;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// A no-swizzle K-major wgmma descriptor of an interleaved tile at `p` (the
// k16 slice's first 16-byte chunk, at its first row): the slice's second
// chunk `chunk` bytes further, 8-row groups 128 bytes apart.
__device__ __forceinline__ uint64_t desc_rows(const unsigned char* p, int chunk) {
  return hopper::smem_desc_plain(p, chunk, 128);
}

template <int MT, int NACC>
__device__ __forceinline__ void fence_all(float (&acc)[MT][NACC]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) hopper::fence_operand(acc[m]);
}

// acc = the product over the ring's stages n .. n + nst - 1: for each, wait
// for it, issue body(slot, st)'s wgmma as one commit group, and release the
// stage (each of this warpgroup's warps arrives once) when its group is done.
template <int MT, int NACC, class Body>
__device__ __forceinline__ void ring_product(float (&acc)[MT][NACC], uint64_t* full,
                                             uint64_t* empty, int S, int n, int nst, Body body) {
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[m][e] = 0.f;
  for (int st = 0; st < nst; ++st, ++n) {
    hopper::mbar_wait(full + n % S, (n / S) & 1);
    fence_all(acc);
    hopper::wgmma_fence();
    body(n % S, st);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // (a group kept in flight across the next wait: within 2%)
    fence_all(acc);
    __syncwarp();
    if (lane0) hopper::mbar_arrive(empty + n % S);
  }
}

// A stage's bytes landing on `bar`: arrive with them (or without any, in a
// K5_SKIP build that leaves every copy of the stage out).
__device__ __forceinline__ void expect_stage(uint64_t* bar, uint32_t bytes) {
  if (bytes)
    hopper::mbar_expect_tx(bar, bytes);
  else
    hopper::mbar_arrive(bar);
}

__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
}

// Registers from the producer warpgroup (40 a thread) to the consumers (232).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// The warpgroups' products run one after another, in the ring's order:
// product q (q % 2 is its warpgroup) starts when product q - 1 has taken all
// its stages (each of that warpgroup's warps arrives on `done` once), so a
// warpgroup never waits on a ring slot whose earlier phase is still open (a
// parity wait would take it for done). Product q - 2 was this warpgroup's own,
// so `done` is at most one phase behind.
__device__ __forceinline__ void take_turn(uint64_t* done, int q) {
  if (q > 0) hopper::mbar_wait(done, (q - 1) & 1);
}

// ---- save-forward: one launch a layer --------------------------------------

struct SaveLayer {
  float* x;              // [B,T,C] the residual, updated in place (not on the last layer)
  float* skip;           // [B,T,C]
  bf16* y_next;          // [B,T,C] the next layer's y (null on the last layer)
  bf16* xs_next;         // xs[l + 1] (null on the last layer)
  bf16* zs;              // zs[l] [B,T,2C]
  const float* sp_next;  // sp[l + 1] [B,C] (null on the last layer)
  const float* db;       // layer l's biases, [2C] each: dilated, cond, out
  const float* cb;
  const float* ob;
  int B, T, C, H, l, first, last, S;
  float last_scale;  // 1 / sqrt(L)
};

// Layer l on every BM-frame tile, as an implicit GEMM: gate pass p (pairs
// j0 = p NP ..) reduces over K = 3C + H rows, tap q's rows reading y at the
// tile's frames shifted by q - 1 and the cond rows bf16(cond); out pass p
// reduces over the C gate channels. Passes alternate between the warpgroups.
// ymap / cmap read this layer's y [B,T,C] and bf16(cond) [B,T,H] in boxes of
// BK channels x BM frames (swizzled at 2 BK bytes: the K-major wgmma A);
// dmap / wcmap / omap the bf16 weights as [L*3C, 2C], [L*H, 2C], [L*C, 2C] in
// boxes of NP columns x BK rows (swizzled at 2 NP bytes: the N-contiguous B).
template <int MT, int NP, int BK>
__global__ void __launch_bounds__(THREADS, 1)
save_layer_kernel(const __grid_constant__ CUtensorMap ymap,
                  const __grid_constant__ CUtensorMap cmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const __grid_constant__ CUtensorMap wcmap,
                  const __grid_constant__ CUtensorMap omap, SaveLayer p) {
  constexpr int BM = 64 * MT, N = 2 * NP, PA = 2 * BK, PB = 2 * NP;  // PA, PB: row bytes
  constexpr int BBOX = BK * PB, ABYTES = BM * PA, STAGE = ABYTES + 2 * BBOX;
  constexpr int NT = NP / 8, GJ = NT < 4 ? NT : 4;  // n8 tiles a half; an epilogue group
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int C = p.C, H = p.H, S = p.S, T = p.T;
  unsigned char* G = base + S * STAGE;  // [C/BK][BM][BK], rows swizzled as A's boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(G + (C / BK) * ABYTES);
  uint64_t* empty = full + S;
  uint64_t* done = empty + S;  // a product has taken its stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_t = (T + BM - 1) / BM, n_tiles = tiles_t * p.B;
  const int n_pass = C / NP, ng = (3 * C + H) / BK, no = C / BK;
  const int per_tile = n_pass * (ng + no);  // ring stages a tile

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);  // a stage is one warpgroup's
    }
    hopper::mbar_init(done, 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer: a tile's gate stages (A and B), then its out stages (B)
    producer_regs();
    if (warp == CONSUMERS / 32 && lane == 0) {
      int n = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / tiles_t, t0 = tile % tiles_t * BM;
        for (int pass = 0; pass < 2 * n_pass; ++pass) {
          const bool gate = pass < n_pass;
          const int j0 = (gate ? pass : pass - n_pass) * NP;
          for (int st = 0; st < (gate ? ng : no); ++st, ++n) {
            const int slot = n % S, k = st * BK;
            unsigned char* stage = base + slot * STAGE;
            hopper::mbar_wait(empty + slot, ((n / S) & 1) ^ 1);
            expect_stage(full + slot,
                         (gate && RUN_ACT ? ABYTES : 0) + (RUN_W ? 2 * BBOX : 0));
            if (gate && RUN_ACT) {
              if (k < 3 * C)
                hopper::tma_load_3d(stage, &ymap, k % C, t0 - 1 + k / C, b, full + slot);
              else
                hopper::tma_load_3d(stage, &cmap, k - 3 * C, t0, b, full + slot);
            }
            if (!RUN_W) continue;
            const CUtensorMap* map = !gate ? &omap : k < 3 * C ? &dmap : &wcmap;
            const int row = !gate ? p.l * C + k : k < 3 * C ? p.l * 3 * C + k : p.l * H + k - 3 * C;
            hopper::tma_load_2d(stage + ABYTES, map, j0, row, full + slot);
            hopper::tma_load_2d(stage + ABYTES + BBOX, map, C + j0, row, full + slot);
          }
        }
      }
    }
  } else {
  consumer_regs();
  // consumers: a tile's products (its gate passes, then its out passes) go to
  // the warpgroups in turn, each on all BM frames; this thread's accumulator
  // rows 64 m + r0 (+ 8) in subtile m and, in n8 tile jt of each half,
  // columns 8 jt + cq (+ 1)
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + (lane >> 2), cq = 2 * (lane & 3);
  const size_t c2 = 2 * (size_t)C;
  float acc[MT][N / 2];
  // wgmma on a stage: A at `a` (K-major, swizzled at PA), B the stage's weights
  auto mma_stage = [&](const unsigned char* a, const unsigned char* stage) {
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (RUN_MMA)
          hopper::wgmma_ss<N>(acc[m], hopper::smem_desc<PA>(a + 64 * m * PA + 32 * s, 0, 8 * PA),
                              hopper::smem_desc<PB>(stage + ABYTES + 16 * s * PB, BBOX, 8 * PB));
  };
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int b = tile / tiles_t, t0 = tile % tiles_t * BM, n0 = i * per_tile;
    const int q0 = 2 * n_pass * i;  // the tile's first product (an even one: warpgroup 0's)

    // the gate passes: z for pairs j0 .., then zs and the gate (written after
    // every earlier product, the last tile's out passes included, has run)
    for (int pass = wg; pass < n_pass; pass += 2) {
      take_turn(done, q0 + pass);
      ring_product(acc, full, empty, S, n0 + pass * ng, ng, [&](int slot, int) {
        const unsigned char* stage = base + slot * STAGE;
        mma_stage(stage, stage);
      });
      warp_arrive(done);
      // in groups of GJ n8 tiles, each group's loads issued before its stores
      const int j0 = pass * NP;
#pragma unroll
      for (int j1 = 0; j1 < NT; j1 += GJ) {
        float2 bg[GJ], bf[GJ];  // b_d + b_c at the gate and filter columns
#pragma unroll
        for (int u = 0; u < GJ; ++u) {
          const int j = j0 + 8 * (j1 + u) + cq;
          const float2 d0 = ld2(p.db + j), c0 = ld2(p.cb + j);
          const float2 d1 = ld2(p.db + C + j), c1 = ld2(p.cb + C + j);
          bg[u] = make_float2(d0.x + c0.x, d0.y + c0.y);
          bf[u] = make_float2(d1.x + c1.x, d1.y + c1.y);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int u = 0; u < GJ; ++u) {
            const int jt = j1 + u, j = j0 + 8 * jt + cq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 64 * m + r0 + 8 * h, t = t0 + r;
              const float zg0 = acc[m][4 * jt + 2 * h] + bg[u].x;
              const float zg1 = acc[m][4 * jt + 2 * h + 1] + bg[u].y;
              const float zf0 = acc[m][4 * (jt + NT) + 2 * h] + bf[u].x;
              const float zf1 = acc[m][4 * (jt + NT) + 2 * h + 1] + bf[u].y;
              if (t < T && RUN_EPI) {
                bf16* zrow = p.zs + ((size_t)b * T + t) * c2;
                mma::st_bf2(zrow + j, zg0, zg1);
                mma::st_bf2(zrow + C + j, zf0, zf1);
              }
              mma::st_bf2(reinterpret_cast<bf16*>(G + j / BK * ABYTES +
                                                  hopper::swz<PA>(r * PA + j % BK * 2)),
                          fast_sigmoid(zg0) * fast_tanh(zf0), fast_sigmoid(zg1) * fast_tanh(zf1));
            }
          }
      }
    }
    // the whole gate (both warpgroups' channels), to the tensor cores' proxy
    hopper::fence_async_shared();
    hopper::bar_sync(1, CONSUMERS);

    // the out passes: o for residual / skip columns j0 .., then x, skip and
    // the next layer's y and xs (out pass p is product n_pass + p)
    for (int pass = (n_pass + wg) & 1; pass < n_pass; pass += 2) {
      take_turn(done, q0 + n_pass + pass);
      ring_product(acc, full, empty, S, n0 + n_pass * ng + pass * no, no, [&](int slot, int st) {
        mma_stage(G + st * ABYTES, base + slot * STAGE);
      });
      warp_arrive(done);
      const int j0 = pass * NP;
#pragma unroll
      for (int j1 = 0; j1 < NT; j1 += GJ) {
        float2 obr[GJ], obs[GJ], spv[GJ];
#pragma unroll
        for (int u = 0; u < GJ; ++u) {
          const int j = j0 + 8 * (j1 + u) + cq;
          obr[u] = ld2(p.ob + j);
          obs[u] = ld2(p.ob + C + j);
          spv[u] = p.last ? make_float2(0.f, 0.f) : ld2(p.sp_next + (size_t)b * C + j);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float2 xv[GJ][2], sv[GJ][2];
#pragma unroll
          for (int u = 0; u < GJ; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + 64 * m + r0 + 8 * h;
              const bool in = t < T && RUN_EPI;
              const size_t at = ((size_t)b * T + t) * C + j0 + 8 * (j1 + u) + cq;
              xv[u][h] = in && !p.last ? ld2(p.x + at) : make_float2(0.f, 0.f);
              sv[u][h] = in && !p.first ? ld2(p.skip + at) : make_float2(0.f, 0.f);
            }
#pragma unroll
          for (int u = 0; u < GJ; ++u) {
            const int jt = j1 + u, j = j0 + 8 * jt + cq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + 64 * m + r0 + 8 * h;
              if (t >= T || !RUN_EPI) continue;
              const size_t at = ((size_t)b * T + t) * C + j;
              float2 s = make_float2(sv[u][h].x + (acc[m][4 * (jt + NT) + 2 * h] + obs[u].x),
                                     sv[u][h].y + (acc[m][4 * (jt + NT) + 2 * h + 1] + obs[u].y));
              if (p.last) {
                s = make_float2(s.x * p.last_scale, s.y * p.last_scale);
              } else {
                const float2 xn =
                    make_float2((xv[u][h].x + (acc[m][4 * jt + 2 * h] + obr[u].x)) * RSQRT2,
                                (xv[u][h].y + (acc[m][4 * jt + 2 * h + 1] + obr[u].y)) * RSQRT2);
                *reinterpret_cast<float2*>(p.x + at) = xn;
                mma::st_bf2(p.xs_next + at, xn.x, xn.y);
                mma::st_bf2(p.y_next + at, xn.x + spv[u].x, xn.y + spv[u].y);
              }
              *reinterpret_cast<float2*>(p.skip + at) = s;
            }
          }
        }
      }
    }
  }
  }
}

// y0 = bf16(x0 + sp[0]), xs[0] = bf16(x0) and bf16(cond): the first layer's
// operands, and the conditioner rounded once for every layer.
__global__ void save_prep_kernel(const float* __restrict__ x0, const float* __restrict__ sp0,
                                 const float* __restrict__ cond, bf16* __restrict__ y0,
                                 bf16* __restrict__ xs0, bf16* __restrict__ condb, int T, int C,
                                 size_t nx, size_t nc) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nx + nc;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < nx) {
      const size_t e = 4 * i;
      const float4 v = mma::ld4(x0 + e);
      *reinterpret_cast<uint2*>(xs0 + e) = mma::pack4(v);
      const float* sp = sp0 + e / ((size_t)T * C) * C + e % C;
      *reinterpret_cast<uint2*>(y0 + e) = mma::pack4(mma::add4(v, mma::ld4(sp)));
    } else {
      const size_t e = 4 * (i - nx);
      *reinterpret_cast<uint2*>(condb + e) = mma::pack4(mma::ld4(cond + e));
    }
  }
}

// ---- backward chain: one launch a layer ------------------------------------

struct ChainLayer {
  float* dx;       // [B,T,C] the carry, updated in place
  bf16* dxs_next;  // [B,T,C] the next layer's bf16(dx / sqrt(2)) (null at layer 0)
  bf16* dz;        // [B,T,L,2C]
  bf16* dy;        // dy[l] [B,T,C]
  int B, T, C, L, l, first, S;
};

// Layer l on every tile of OUT = BM - 2 frames from t0 (dgate and dz on BM
// frames from t0 - 1); dgate pass p and dy pass p take output columns j0 =
// p NCOL .., passes alternating between the warpgroups. xmap reads this
// layer's bf16(dx / sqrt(2)) [B,T,C] and gmap bf16(g / sqrt(L)) [B,T,C] in
// boxes of BKR channels x BM rows (swizzled at 64 bytes: the dgate product's
// K-major A), zmap zs as [L*B, T, 2C] (boxes of 8 channels x BM rows, into
// dz's chunks); owmap / dwmap W_o^T
// [L*2C, C] and W_d^T [L*3*2C, C] (boxes of 64 columns x BKR / 2 BKR rows,
// swizzled at 128 bytes).
template <int MT, int NCOL>
__global__ void __launch_bounds__(THREADS, 1)
chain_layer_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap zmap,
                   const __grid_constant__ CUtensorMap owmap,
                   const __grid_constant__ CUtensorMap dwmap, ChainLayer p) {
  constexpr int BM = 64 * MT, OUT = BM - 2, KDY = 2 * BKR;
  constexpr int DG = 8;  // n8 tiles an epilogue group: its loads first
  constexpr int ABYTES = BM * BKR * 2, BBOX = BKR * 128, BOXES = NCOL / 64;
  constexpr int DGATE = ABYTES + BOXES * BBOX, DY = BOXES * KDY * 128;
  constexpr int STAGE = DGATE > DY ? DGATE : DY;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int C = p.C, S = p.S, T = p.T, c2 = 2 * C;
  const int ZS = halo_rows(BM) * 16;     // bytes a channel chunk of dz
  unsigned char* DZ = base + S * STAGE;  // [2C/8][halo_rows][8]: row i is frame t0 - 1 + i
  uint64_t* full = reinterpret_cast<uint64_t*>(DZ + (c2 / 8) * ZS);
  uint64_t* empty = full + S;
  uint64_t* zfull = empty + S;  // zs has landed in DZ
  uint64_t* zfree = zfull + 1;  // DZ is read: the next tile's zs may come
  uint64_t* done = zfree + 1;   // a product has taken its stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_t = (T + OUT - 1) / OUT, n_tiles = tiles_t * p.B;
  const int n_pass = C / NCOL, k_lo = p.first ? C : 0;  // the first layer's dx is 0
  const int nd = (c2 - k_lo) / BKR, ny = 3 * c2 / KDY, per_tile = n_pass * (nd + ny);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);  // a stage is one warpgroup's
    }
    hopper::mbar_init(zfull, 1);
    hopper::mbar_init(zfree, CONSUMERS / 32);
    hopper::mbar_init(done, 4);
    hopper::mbar_init_fence();
  }
  // dz's last two rows feed only the discarded output rows: zero
  for (int e = tid; e < c2 / 8 * 2; e += blockDim.x)
    *reinterpret_cast<uint4*>(DZ + e / 2 * ZS + (BM + e % 2) * 16) = make_uint4(0, 0, 0, 0);
  hopper::fence_async_shared();
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    producer_regs();
    if (warp == CONSUMERS / 32 && lane == 0) {  // a tile's dgate stages (A and B), then its dy stages (B)
      int n = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / tiles_t, t0 = tile % tiles_t * OUT;
        for (int pass = 0; pass < 2 * n_pass; ++pass) {
          const bool dgate = pass < n_pass;
          const int j0 = (dgate ? pass : pass - n_pass) * NCOL;
          for (int st = 0; st < (dgate ? nd : ny); ++st, ++n) {
            const int slot = n % S;
            unsigned char* stage = base + slot * STAGE;
            hopper::mbar_wait(empty + slot, ((n / S) & 1) ^ 1);
            expect_stage(full + slot, dgate ? (RUN_ACT ? ABYTES : 0) + (RUN_W ? BOXES * BBOX : 0)
                                            : RUN_W ? DY : 0);
            if (dgate) {
              const int k = k_lo + st * BKR;
              if (RUN_ACT)
                hopper::tma_load_3d(stage, k < C ? &xmap : &gmap, k % C, t0 - 1, b, full + slot);
              for (int bx = 0; bx < BOXES && RUN_W; ++bx)
                hopper::tma_load_2d(stage + ABYTES + bx * BBOX, &owmap, j0 + 64 * bx,
                                    p.l * c2 + k, full + slot);
            } else {  // stage row g: shift g / 2C reads W_d[2 - shift]^T
              const int g = st * KDY;
              for (int bx = 0; bx < BOXES && RUN_W; ++bx)
                hopper::tma_load_2d(stage + bx * KDY * 128, &dwmap, j0 + 64 * bx,
                                    (p.l * 3 + 2 - g / c2) * c2 + g % c2, full + slot);
            }
          }
        }
      }
    } else if (warp == CONSUMERS / 32 + 1 && lane == 0) {  // each tile's zs, into DZ
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int b = tile / tiles_t, t0 = tile % tiles_t * OUT;
        hopper::mbar_wait(zfree, (i & 1) ^ 1);
        expect_stage(zfull, RUN_ACT ? BM * c2 * 2 : 0);
        for (int k = 0; k < c2 && RUN_ACT; k += 8)
          hopper::tma_load_3d(DZ + k / 8 * ZS, &zmap, k, t0 - 1, p.l * p.B + b, zfull);
      }
    }
  } else {
  consumer_regs();
  // consumers: a tile's products (its dgate passes, then its dy passes) go to
  // the warpgroups in turn, each on all BM rows
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + (lane >> 2), cq = 2 * (lane & 3);
  float acc[MT][NCOL / 2];
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int b = tile / tiles_t, t0 = tile % tiles_t * OUT, n0 = i * per_tile;
    const int q0 = 2 * n_pass * i;  // the tile's first product (an even one: warpgroup 0's)

    // dgate for columns j0 .., then dz for the pairs (j, C + j) into DZ
    for (int pass = wg; pass < n_pass; pass += 2) {
      take_turn(done, q0 + pass);
      ring_product(acc, full, empty, S, n0 + pass * nd, nd, [&](int slot, int) {
        const unsigned char* stage = base + slot * STAGE;
#pragma unroll
        for (int s = 0; s < BKR / 16; ++s)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (RUN_MMA)
              hopper::wgmma_ss<NCOL>(
                  acc[m], hopper::smem_desc<2 * BKR>(stage + 64 * m * 2 * BKR + 32 * s, 0, 16 * BKR),
                  hopper::smem_desc<128>(stage + ABYTES + 16 * s * 128, BBOX, 1024));
      });
      warp_arrive(done);
      hopper::mbar_wait(zfull, i & 1);
      const int j0 = pass * NCOL;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int jt = 0; jt < NCOL / 8; ++jt) {
          const int j = j0 + 8 * jt + cq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * m + r0 + 8 * h, t = t0 - 1 + r;
            bf16* zg = reinterpret_cast<bf16*>(DZ + j / 8 * ZS + r * 16 + j % 8 * 2);
            bf16* zf = reinterpret_cast<bf16*>(DZ + (C + j) / 8 * ZS + r * 16 + j % 8 * 2);
            float g0 = 0.f, g1 = 0.f, f0 = 0.f, f1 = 0.f;
            if (t >= 0 && t < T) {
              const float2 vg = mma::bf2_to_f2(zg), vf = mma::bf2_to_f2(zf);
              const float a0 = fast_sigmoid(vg.x), a1 = fast_sigmoid(vg.y);
              const float tb0 = fast_tanh(vf.x), tb1 = fast_tanh(vf.y);
              const float d0 = acc[m][4 * jt + 2 * h], d1 = acc[m][4 * jt + 2 * h + 1];
              g0 = d0 * tb0 * a0 * (1.f - a0);
              g1 = d1 * tb1 * a1 * (1.f - a1);
              f0 = d0 * a0 * (1.f - tb0 * tb0);
              f1 = d1 * a1 * (1.f - tb1 * tb1);
            }
            mma::st_bf2(zg, g0, g1);
            mma::st_bf2(zf, f0, f1);
            if (r >= 1 && r <= OUT && t < T && RUN_EPI) {
              bf16* drow = p.dz + (((size_t)b * T + t) * p.L + p.l) * c2;
              mma::st_bf2(drow + j, g0, g1);
              mma::st_bf2(drow + C + j, f0, f1);
            }
          }
        }
    }
    // the whole dz tile (both warpgroups' pairs), to the tensor cores' proxy
    hopper::fence_async_shared();
    hopper::bar_sync(1, CONSUMERS);

    // dy for columns j0 ..; dx and the next layer's operand (dy pass p is
    // product n_pass + p)
    const int first_dy = (n_pass + wg) & 1;
    if (first_dy >= n_pass) warp_arrive(zfree);  // a warpgroup with no dy pass
    for (int pass = first_dy; pass < n_pass; pass += 2) {
      take_turn(done, q0 + n_pass + pass);
      ring_product(acc, full, empty, S, n0 + n_pass * nd + pass * ny, ny,
                   [&](int slot, int st) {
                     const unsigned char* stage = base + slot * STAGE;
#pragma unroll
                     for (int s = 0; s < KDY / 16; ++s) {
                       const int g = st * KDY + 16 * s, k = g % c2;
#pragma unroll
                       for (int m = 0; m < MT; ++m)
                         if (RUN_MMA)
                           hopper::wgmma_ss<NCOL>(
                               acc[m], desc_rows(DZ + k / 8 * ZS + (64 * m + g / c2) * 16, ZS),
                               hopper::smem_desc<128>(stage + 16 * s * 128, KDY * 128, 1024));
                     }
                   });
      warp_arrive(done);
      if (pass + 2 >= n_pass) warp_arrive(zfree);  // this warpgroup's last read of DZ
      const int j0 = pass * NCOL;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j1 = 0; j1 < NCOL / 8; j1 += DG) {  // groups of DG n8 tiles: loads first
          float2 dxv[DG][2];
#pragma unroll
          for (int u = 0; u < DG; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = 64 * m + r0 + 8 * h, t = t0 + o;
              dxv[u][h] = o < OUT && t < T && RUN_EPI
                              ? ld2(p.dx + ((size_t)b * T + t) * C + j0 + 8 * (j1 + u) + cq)
                              : make_float2(0.f, 0.f);
            }
#pragma unroll
          for (int u = 0; u < DG; ++u) {
            const int jt = j1 + u, c = j0 + 8 * jt + cq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = 64 * m + r0 + 8 * h, t = t0 + o;
              if (o >= OUT || t >= T || !RUN_EPI) continue;
              const size_t at = ((size_t)b * T + t) * C + c;
              const float v0 = acc[m][4 * jt + 2 * h], v1 = acc[m][4 * jt + 2 * h + 1];
              mma::st_bf2(p.dy + at, v0, v1);
              const float2 dn = make_float2(dxv[u][h].x * RSQRT2 + v0, dxv[u][h].y * RSQRT2 + v1);
              *reinterpret_cast<float2*>(p.dx + at) = dn;
              if (p.dxs_next) mma::st_bf2(p.dxs_next + at, dn.x * RSQRT2, dn.y * RSQRT2);
            }
          }
        }
    }
  }
  }
}

// gs = bf16(g / sqrt(L)): the skip half of every layer's dgate operand.
__global__ void chain_prep_kernel(const float* __restrict__ g, bf16* __restrict__ gs, size_t n4,
                                  float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x)
    *reinterpret_cast<uint2*>(gs + 4 * i) = mma::pack4(mma::scale4(mma::ld4(g + 4 * i), scale));
}

// ---- host ------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// The kernel's dynamic shared memory raised to the limit, once a device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
  return e;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int prep_blocks(size_t n, int sms) {
  const size_t want = (n + 255) / 256, most = (size_t)sms * 8;
  return (int)(want < most ? want : most);
}

struct SaveMaps {
  CUtensorMap y[2], cond, dw, cw, ow;
};

struct SaveCall {
  bf16 *ybuf, *xs, *zs;
  const float *sp, *db, *cb, *ob;
  int L, sms;
  cudaStream_t stream;
};

template <int MT, int NP, int BK>
int save_layers(const SaveMaps& m, SaveLayer p, const SaveCall& c) {
  static bool ready[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(save_layer_kernel<MT, NP, BK>, ready);
  if (e != cudaSuccess) return (int)e;
  const int B = p.B, T = p.T, C = p.C, tiles = (T + 64 * MT - 1) / (64 * MT) * B;
  const size_t btc = (size_t)B * T * C;
  p.S = save_stages(C, p.H, MT);
  for (int l = 0; l < c.L; ++l) {
    p.l = l;
    p.first = l == 0;
    p.last = l == c.L - 1;
    p.y_next = p.last ? nullptr : c.ybuf + (size_t)((l + 1) % 2) * btc;
    p.xs_next = p.last ? nullptr : c.xs + (size_t)(l + 1) * btc;
    p.zs = c.zs + (size_t)l * 2 * btc;
    p.sp_next = p.last ? nullptr : c.sp + (size_t)(l + 1) * B * C;
    p.db = c.db + (size_t)l * 2 * C;
    p.cb = c.cb + (size_t)l * 2 * C;
    p.ob = c.ob + (size_t)l * 2 * C;
    save_layer_kernel<MT, NP, BK><<<tiles < c.sms ? tiles : c.sms, THREADS,
                                    save_smem(C, p.H, MT), c.stream>>>(m.y[l % 2], m.cond, m.dw,
                                                                       m.cw, m.ow, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

struct ChainMaps {
  CUtensorMap x[2], g, zs, ow, dw;
};

template <int MT, int NCOL>
int chain_layers(const ChainMaps& m, ChainLayer p, bf16* dxs, bf16* dy, int sms,
                 cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(chain_layer_kernel<MT, NCOL>, ready);
  if (e != cudaSuccess) return (int)e;
  const int B = p.B, T = p.T, C = p.C, L = p.L;
  const int tiles = (T + 64 * MT - 3) / (64 * MT - 2) * B;
  const size_t btc = (size_t)B * T * C;
  p.S = chain_stages(C, MT);
  for (int l = L - 1, k = 0; l >= 0; --l, ++k) {
    p.l = l;
    p.first = l == L - 1;
    p.dxs_next = l == 0 ? nullptr : dxs + (size_t)((k + 1) % 2) * btc;
    p.dy = dy + (size_t)l * btc;
    chain_layer_kernel<MT, NCOL><<<tiles < sms ? tiles : sms, THREADS, chain_smem(C, MT),
                                   stream>>>(m.x[k % 2], m.g, m.zs, m.ow, m.dw, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// The plan of the save-forward (kind 0, at C and H) or the chain (kind 1, at
// C): out[0] m64 subtiles a warpgroup (the block's frames / 64; 0 where none
// fits), out[1] ring stages, out[2] shared-memory bytes, out[3] columns a
// pass (pairs for the save-forward), out[4] rows (k) a stage (the
// save-forward's; the chain's dgate stages). A check for
// ops/wavenet_train.py:save_plan / chain_plan.
extern "C" int wavenet_train_plan_bf16(int kind, int C, int H, int* out) {
  if (C < 32 || C % 32 || (kind == 1 && C % 64) || (kind == 0 && (H < 32 || H % 32)))
    return (int)cudaErrorInvalidValue;
  const int mt = kind == 0 ? save_mt(C, H) : chain_mt(C);
  out[0] = mt;
  out[1] = mt == 0 ? 0 : kind == 0 ? save_stages(C, H, mt) : chain_stages(C, mt);
  out[2] = mt == 0 ? 0 : kind == 0 ? save_smem(C, H, mt) : chain_smem(C, mt);
  out[3] = kind == 0 ? save_pairs(C) : chain_cols(C);
  out[4] = kind == 0 ? save_bk(C, H) : BKR;
  return 0;
}

// As wavenet_stack_save_forward (wavenet_train.cu) with the four weight
// matrices bf16 (dw [L,3,C,2C], diffw [L,C,C], cw [L,H,2C], ow [L,C,2C]) and
// the saves xs [L,B,T,C], zs [L,B,T,2C] bf16; x (x0 in, clobbered), skip, sp
// [L,B,C], cond, step and the biases float32; ybuf [2,B,T,C] and condb
// [B,T,H] bf16 scratch. Needs C % 32 == 0, H % 32 == 0 and a block that fits
// (wavenet_train_plan_bf16). L + 2 launches on `stream` (the step
// projection, the prep, one a layer); returns the first launch error
// (cudaError_t) or 0.
extern "C" int wavenet_stack_save_forward_bf16(
    float* x, float* skip, bf16* ybuf, bf16* condb, float* sp, bf16* xs, bf16* zs,
    const float* cond, const float* step, const bf16* dw, const float* db, const bf16* diffw,
    const float* diffb, const bf16* cw, const float* cb, const bf16* ow, const float* ob, int B,
    int T, int C, int H, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C < 32 || C % 32 || H < 32 || H % 32)
    return (int)cudaErrorInvalidValue;
  const int mt = save_mt(C, H);
  if (mt == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  if ((e = wavenet_bf16::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream)) != cudaSuccess)
    return (int)e;
  const size_t nx = (size_t)B * T * C / 4, nc = (size_t)B * T * H / 4;
  save_prep_kernel<<<prep_blocks(nx + nc, sms), 256, 0, stream>>>(x, sp, cond, ybuf, xs, condb, T,
                                                                   C, nx, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int np = save_pairs(C), bk = save_bk(C, H), bm = 64 * mt;
  const CUtensorMapSwizzle swz_a = bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapSwizzle swz_b = np == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  SaveMaps m;
  int err = 0;
  for (int k = 0; k < 2 && !err; ++k)
    err = hopper::make_map_3d(&m.y[k], ybuf + (size_t)k * B * T * C, B, T, C, bm, bk, swz_a);
  if (!err) err = hopper::make_map_3d(&m.cond, condb, B, T, H, bm, bk, swz_a);
  if (!err) err = hopper::make_map_2d(&m.dw, dw, (uint64_t)L * 3 * C, 2 * C, bk, np, swz_b);
  if (!err) err = hopper::make_map_2d(&m.cw, cw, (uint64_t)L * H, 2 * C, bk, np, swz_b);
  if (!err) err = hopper::make_map_2d(&m.ow, ow, (uint64_t)L * C, 2 * C, bk, np, swz_b);
  if (err) return err;
  const SaveLayer p{x, skip, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    B, T, C, H, 0, 0, 0, 0, (float)(1.0 / sqrt((double)L))};
  const SaveCall c{ybuf, xs, zs, sp, db, cb, ob, L, sms, stream};
  if (np == 64) return bk == 64 ? save_layers<1, 64, 64>(m, p, c) : save_layers<1, 64, 32>(m, p, c);
  return save_layers<1, 32, 32>(m, p, c);
}

// As wavenet_stack_backward_chain (wavenet_train.cu) with zs, dwt
// [L,3,2C,C], owt [L,2C,C], dz [B,T,L,2C] and dy [L,B,T,C] bf16; g and the
// carry dx (zeroed by the caller, out: dL/dx0) float32; dxs [2,B,T,C] and gs
// [B,T,C] bf16 scratch. Needs C % 64 == 0 and a block that fits
// (wavenet_train_plan_bf16). L + 1 launches on `stream` (the prep, one a
// layer); returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_stack_backward_chain_bf16(const bf16* zs, const float* g, const bf16* dwt,
                                                 const bf16* owt, float* dx, bf16* dz, bf16* dy,
                                                 bf16* dxs, bf16* gs, int B, int T, int C, int L,
                                                 void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C < 64 || C % 64) return (int)cudaErrorInvalidValue;
  const int mt = chain_mt(C);
  if (mt == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const size_t n4 = (size_t)B * T * C / 4;
  chain_prep_kernel<<<prep_blocks(n4, sms), 256, 0, stream>>>(g, gs, n4,
                                                              (float)(1.0 / sqrt((double)L)));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int bm = 64 * mt;
  ChainMaps m;
  int err = 0;
  for (int k = 0; k < 2 && !err; ++k)
    err = hopper::make_map_3d(&m.x[k], dxs + (size_t)k * B * T * C, B, T, C, bm, BKR,
                              CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err) err = hopper::make_map_3d(&m.g, gs, B, T, C, bm, BKR, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err) err = hopper::make_map_3d(&m.zs, zs, (uint64_t)L * B, T, 2 * C, bm, 8);
  if (!err)
    err = hopper::make_map_2d(&m.ow, owt, (uint64_t)L * 2 * C, C, BKR, 64,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = hopper::make_map_2d(&m.dw, dwt, (uint64_t)L * 3 * 2 * C, C, 2 * BKR, 64,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const ChainLayer p{dx, nullptr, dz, nullptr, B, T, C, L, 0, 0, 0};
  if (chain_cols(C) == 128)
    return mt == 2 ? chain_layers<2, 128>(m, p, dxs, dy, sms, stream)
                   : chain_layers<1, 128>(m, p, dxs, dy, sms, stream);
  return mt == 2 ? chain_layers<2, 64>(m, p, dxs, dy, sms, stream)
                 : chain_layers<1, 64>(m, p, dxs, dy, sms, stream);
}
