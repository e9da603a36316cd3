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
// stage mean and the activations between units stay float32. Zero padding
// get_padding(k, d) at the true sequence ends (the TPU kernel re-zeroes its
// halo rows after each conv).
//
// What bounds it on the H100: the bf16 tensor cores. A stage at T_mel = 512
// and the base config (C = 256 ... 16, 126 taps a stage) is 2 * 126 * T *
// C^2 a stage, 321 GFLOP for the five (0.325 ms at 989 TFLOP/s), against
// 17-34 MB of float32 activations a pass over the stage's [B, T, C].
//
// Design at C >= 16: one launch per unit, the unit's two convs fused
// (unit_kernel; 9 launches a stage of three ResBlock1s with three units
// each). conv2 reads conv1's output only as bf16(leaky(conv1 + bias)), so
// that tile stays in shared memory as bf16 (the same rounding, no change to
// the function) and no float32 intermediate goes through HBM. A block owns
// OUT = M1 - 2 P2 output frames of one sequence and all C channels (P2 =
// (k - 1) / 2, conv2's halo): it computes conv1 on the M1 frames from t0 -
// P2 (the halo recomputed, P2 frames a side) and conv2 on M1 frames from
// t0, of which the first OUT are stored. Shared memory, from a 1024-aligned
// base:
//   ring  S stages of weight rows (TMA boxes, swizzled), S * STAGE bytes;
//   X     M1 + 2 p1 frames of bf16(leaky(h_in)) (p1 = P2 d, conv1's halo),
//         zero outside [0, T);
//   Y     M1 + 2 P2 frames of bf16(leaky(conv1 + b1)), zero outside [0, T)
//         (its last 2 P2 rows zero: they feed only conv2's discarded rows);
//   the ring's full and empty mbarriers.
// X and Y are interleaved, [C/8][frames][8]: a 16-byte chunk of channels,
// frame after frame. A k16 slice of 64 frames from ANY frame is then one
// no-swizzle K-major wgmma descriptor (8-frame core matrices 128 bytes
// apart, the two 8-channel halves a chunk apart), so tap q of a dilated
// conv, the tile q * d frames further down, moves only the descriptor's
// start address: both operands come from shared memory, and the K taps
// share one staged tile. At C = 256 and (k, d) = (11, 5): X 57 KB, Y 37 KB,
// 8 stages of 16 KB, 223 KB of the 227 KB a block may take; at C <= 128 a
// block stays under 113 KB (two blocks an SM), at C <= 32 under 74 KB
// (three) (ops/resblock.py:unit_plan mirrors unit_smem, and a CPU test holds
// every stage shape of the repo's vocoders under the limit). The weights
// are streamed by the TMA: the stage's tap stacks are one tensor map over
// [rows = C * sum(k), C] bf16, a ring stage is BKR consecutive rows (taps
// q, input channels ci: row q C + ci of a conv) in boxes of 64 columns (C
// >= 64; one box of C columns below), swizzled at the box row's span, the
// N-contiguous B operand of wgmma (m64nNk16, N = C, or C / 2 a warpgroup at
// C = 256). One producer warp (its lane 0) runs ahead through both convs'
// stages; two consumer warpgroups wait on a stage's full mbarrier, issue
// its slices as one commit group and release the stage on its empty
// mbarrier once the group is done: no block barrier a stage. At C <= 32 the
// taps of both convs (under 45 KB) stay resident instead, loaded with X by
// the consumers: there a stage's fetch latency, not its bytes, was the
// cost. (Two blocks sharing the stream by TMA multicast measured 1.3-2.3x
// slower at C >= 64: the pair runs in lockstep.) Between the convs the
// consumers meet at a named barrier (after a proxy fence: the tensor cores
// read what the threads wrote); the epilogues are conv1's (leaky, zero
// outside [0, T),
// bf16 into Y) and conv2's (+ bias + residual, into h, or into the stage
// mean for a ResBlock's last unit), straight from the accumulators. A unit
// reads h_in and writes another buffer (h and tmp alternate: a block's halo
// rows are other blocks' outputs).
//
// C = 8 (the last stage of a HiFiGAN that starts at 128 channels, which the
// TPU kernel runs at pack 16): the whole stage in one launch
// (c8_stage_kernel; the block plan and its walk in resblock_c8.cuh), as the
// Pallas kernel runs it. It replaces one launch a conv (conv_kernel_c8, 18
// a stage: 0.1042 ms at B = 1, T = 131,072 against a 2.5 us bound of
// bytes), where each conv read and wrote the [B, T, 8] activations and the
// launches' chain, not the products, set the time. A block keeps in
// shared memory x (float32, the first unit's residual), the staged conv
// input (S: bf16(leaky(h)), rows of 16 bytes), conv1's output (Y:
// bf16(leaky(conv1 + b1)), conv2's input) and all the stage's taps (16
// KB); the running h and the mean stay in registers, in the mma
// accumulators' layout (a frame keeps its lane). A tap of a C = 8 conv
// reduces over 8 input channels, half of an m16n8k16 k step, so each k step
// PAIRS TWO TAPS: k 0-7 are tap 2p's channels and k 8-15 tap 2p+1's. The A
// fragment's second half (the ldmatrix.x4 addresses of lanes 16-31) reads
// the staged rows d further down, the B fragment's rows 8-15 hold tap
// 2p+1's weights, and an odd k's last pair has a zero second tap (its A
// lanes reread tap 2p's rows: finite values times zero weights). So a
// 16-row tile takes ceil(k / 2) mma, 2/4/6 at k = 3/7/11. The staged rows
// are 8 bf16 with no padding: the 8 rows of an ldmatrix phase are 128
// contiguous bytes, in distinct banks. mma.sync from ldmatrix, not wgmma: a
// conv is 2-6 k16 steps on 8 output columns, and a warp's tiles run from
// registers with no descriptor or fence between the 18 convs. The bound is
// bytes (x and out once: 8.4 MB, 2.5 us at T = 131,072); what the kernel
// takes is the chain of 18 convs with a barrier after each, at two blocks an
// SM (the 123 registers of 256 threads): measured on an H100 80GB HBM3 at
// 700 W (C8_SKIP builds, tools/probe_bf16_kernels.py --c8-only) ~0.037 ms,
// of which the products (ldmatrix, mma and their B fragments) ~0.016, the
// epilogues ~0.015, the loads, copies and barriers ~0.006. 3 or 2 tiles a
// warp (more warps, one block an SM) and 256- or 1024-frame blocks were
// slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "resblock_c8.cuh"

namespace {

using mma::bf16;

constexpr int MAX_PAD = 32;  // frames of halo a side: (k - 1) / 2 * d <= MAX_PAD
constexpr float SLOPE = 0.1f;
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_WARPS = 8, CONSUMERS = CONSUMER_WARPS * 32;
constexpr int UNIT_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_LIMIT = 232448;            // bytes a block may take
constexpr int SMEM_HALF = 115712;             // bytes a block with another beside it on an SM
constexpr int SMEM_THIRD = 75776;             // bytes a block with two others beside it

enum Epilogue { EPI_LEAKY = 0, EPI_RESID = 1, EPI_MEAN = 2 };

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

// unit_kernel's configuration at C: M1 frames a conv (128; 64 at C = 256),
// BKR weight rows a ring stage, LIMIT bytes of shared memory a block at most
// and MINB blocks an SM (the register budget). Its two consumer warpgroups
// take 64 frames each by all C columns, or at M1 = 64 the same 64 frames by
// C / 2 columns each.
template <int C_, int M1_, int BKR_, int LIMIT_, int MINB_>
struct UnitCfg {
  static constexpr int C = C_, M1 = M1_, BKR = BKR_, LIMIT = LIMIT_, MINB = MINB_;
  static constexpr int P = C < 64 ? 2 * C : 128;    // a box row's bytes: the swizzle span
  static constexpr int SUBS = C < 64 ? 1 : C / 64;  // boxes a stage
  static constexpr int STAGE = BKR * C * 2;         // bytes, a multiple of 1024
  static_assert(STAGE % 1024 == 0 && BKR % 16 == 0 && BKR <= 256, "stage");
  static constexpr int NWG = M1 == 128 ? C : C / 2;  // a warpgroup's columns
  static_assert(M1 == 128 || NWG % 64 == 0, "a split of N keeps whole 64-column boxes");
  // C <= 32: both convs' taps stay in shared memory, loaded by the consumers
  // with X (a few KB: no ring, no producer)
  static constexpr bool RESIDENT = C <= 32;
};

using Cfg16 = UnitCfg<16, 128, 256, SMEM_THIRD, 3>;
using Cfg32 = UnitCfg<32, 128, 256, SMEM_THIRD, 3>;
using Cfg64 = UnitCfg<64, 128, 128, SMEM_HALF, 2>;
using Cfg128 = UnitCfg<128, 128, 32, SMEM_HALF, 2>;
using Cfg256 = UnitCfg<256, 64, 32, SMEM_LIMIT, 1>;

// RESBLOCK_SKIP (0 in the kernel the port runs) leaves a part out, for
// measuring where the time goes (chip_smoke.py, tools/probe_bf16_kernels.py):
// bit 0 the taps' loads (no copy, no wait), bit 1 X's loads from h_in
// (zeros), bit 2 the output's loads and stores. Their outputs are for
// measurement only.
#ifndef RESBLOCK_SKIP
#define RESBLOCK_SKIP 0
#endif
constexpr bool RUN_STREAM = !(RESBLOCK_SKIP & 1), RUN_LOADS = !(RESBLOCK_SKIP & 2),
               RUN_STORES = !(RESBLOCK_SKIP & 4);

// The shared memory of unit_kernel<CF, K> at dilation d and its ring depth
// (ops/resblock.py:unit_plan computes the same).
template <class CF, int K>
__host__ __device__ constexpr int unit_stages(int d) {
  if (CF::RESIDENT) return 0;
  const int p2 = (K - 1) / 2, p1 = p2 * d;
  const int fixed = 1024 + ((CF::M1 + 2 * p1) + (CF::M1 + 2 * p2)) * CF::C * 2;
  const int per_conv = (K * CF::C + CF::BKR - 1) / CF::BKR;
  int s = (CF::LIMIT - fixed) / (CF::STAGE + 16);
  if (s > MAX_STAGES) s = MAX_STAGES;
  if (s > 2 * per_conv) s = 2 * per_conv;
  return s;
}

template <class CF, int K>
__host__ __device__ constexpr int unit_smem(int d) {
  const int p2 = (K - 1) / 2, p1 = p2 * d;
  return 1024 + ((CF::M1 + 2 * p1) + (CF::M1 + 2 * p2)) * CF::C * 2 +
         (CF::RESIDENT ? 2 * K * CF::C * CF::C * 2 : unit_stages<CF, K>(d) * (CF::STAGE + 16));
}

// One conv by wgmma: acc (this warpgroup's 64 x NWG tile at frames mbase..,
// columns nbase..) = the conv of the staged tile A ([C/8][rows][8] bf16,
// `cstride` bytes a chunk of 8 channels; tap q reads rows q * dil further
// down: a no-swizzle K-major descriptor from any row) with the ring's next
// NST stages (B the stage's swizzled N-contiguous tile). A stage's slices are
// one commit group, waited for before the stage is released (keeping it in
// flight across the next stage's wait measured slower).
template <class CF, int K>
__device__ __forceinline__ void conv_wgmma(const unsigned char* ring, uint64_t* full,
                                           uint64_t* empty, int S, int& n, const bf16* A,
                                           int cstride, int dil, int mbase, int nbase,
                                           float (&acc)[CF::NWG / 2]) {
  constexpr int C = CF::C, P = CF::P, BKR = CF::BKR, ROWS_W = K * C, SL = BKR / 16;
  constexpr int NST = (ROWS_W + BKR - 1) / BKR;
  const int lane = threadIdx.x & 31;
  const unsigned char* Ab = reinterpret_cast<const unsigned char*>(A);
  auto desc_a = [&](int g) {  // the A slice of weight row g: tap g / C, channels g % C ..
    return hopper::smem_desc_plain(Ab + g % C / 8 * cstride + (mbase + g / C * dil) * 16,
                                   cstride, 128);
  };
#pragma unroll
  for (int e = 0; e < CF::NWG / 2; ++e) acc[e] = 0.f;
  hopper::fence_operand(acc);
  hopper::wgmma_fence();
  if constexpr (CF::RESIDENT) {  // `ring` holds this conv's K * C rows of taps
#pragma unroll
    for (int g = 0; g < ROWS_W; g += 16)
      hopper::wgmma_ss<CF::NWG>(acc, desc_a(g), hopper::smem_desc<P>(ring + g * P, 0, 8 * P));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    return;
  }
  for (int st = 0; st < NST; ++st, ++n) {
    if (RUN_STREAM) hopper::mbar_wait(full + n % S, (n / S) & 1);
    const unsigned char* Bs = ring + n % S * CF::STAGE + (nbase / 64) * BKR * P;
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int g = st * BKR + 16 * s;
      if (g < ROWS_W)
        hopper::wgmma_ss<CF::NWG>(acc, desc_a(g),
                                  hopper::smem_desc<P>(Bs + 16 * s * P, BKR * P, 8 * P));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    __syncwarp();
    if (lane == 0 && RUN_STREAM) hopper::mbar_arrive(empty + n % S);
  }
}

// One unit: dst[b, t] = epi(b2 + conv2(bf16(leaky(b1 + conv1_d(bf16(leaky(hin)))))) + hin)
// for the OUT frames of this block (see the header). wmap: the stage's tap
// stacks as [rows, C] bf16; row1 / row2: the first row of conv1 / conv2.
template <class CF, int K>
__global__ void __launch_bounds__(UNIT_THREADS, CF::MINB)
unit_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ w,
            const float* __restrict__ hin, const float* __restrict__ b1,
            const float* __restrict__ b2, float* dst, int T, int d, int row1, int row2, int S,
            int epi, int first, int last, float n_res) {
  constexpr int C = CF::C, M1 = CF::M1, BKR = CF::BKR, P2 = (K - 1) / 2, YR = M1 + 2 * P2;
  constexpr int NST = (K * C + BKR - 1) / BKR;  // ring stages a conv
  constexpr int OUT = M1 - 2 * P2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int p1 = P2 * d, xr = M1 + 2 * p1;
  // X [C/8][xr][8] and Y [C/8][YR][8] bf16: 16-byte chunks of channels, then frames
  bf16* X = reinterpret_cast<bf16*>(base + (CF::RESIDENT ? 2 * K * C * CF::P : S * CF::STAGE));
  bf16* Y = X + xr * C;
  uint64_t* full = reinterpret_cast<uint64_t*>(Y + YR * C);
  uint64_t* empty = full + S;
  const int b = blockIdx.y, t0 = blockIdx.x * OUT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONSUMER_WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: both convs' weight stages
    if (lane == 0 && RUN_STREAM && !CF::RESIDENT) {
      int n = 0;
      for (int conv = 0; conv < 2; ++conv)
        for (int st = 0; st < NST; ++st, ++n) {
          const int slot = n % S;
          hopper::mbar_wait(empty + slot, ((n / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full + slot, CF::STAGE);
          unsigned char* dstp = base + slot * CF::STAGE;
#pragma unroll
          for (int sub = 0; sub < CF::SUBS; ++sub)
            hopper::tma_load_2d(dstp + sub * BKR * CF::P, &wmap, sub * 64,
                                (conv ? row2 : row1) + st * BKR, full + slot);
        }
    }
    return;
  }

  // X: bf16(leaky(h_in)) on frames t0 - P2 - p1 ..., zero outside [0, T), a
  // thread a frame's 8 channels (consecutive threads: consecutive frames);
  // Y's last 2 P2 rows zero. Then to the tensor cores' proxy.
  const float* hb = hin + (size_t)b * T * C;
#pragma unroll 4
  for (int e = tid; e < xr * (C / 8); e += CONSUMERS) {
    const int chunk = e / xr, r = e % xr, t = t0 - P2 - p1 + r;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (RUN_LOADS && t >= 0 && t < T) {
      v0 = mma::ld4(hb + (size_t)t * C + 8 * chunk);
      v1 = mma::ld4(hb + (size_t)t * C + 8 * chunk + 4);
      v0 = make_float4(leaky(v0.x), leaky(v0.y), leaky(v0.z), leaky(v0.w));
      v1 = make_float4(leaky(v1.x), leaky(v1.y), leaky(v1.z), leaky(v1.w));
    }
    const uint2 lo = mma::pack4(v0), hi = mma::pack4(v1);
    *reinterpret_cast<uint4*>(X + (chunk * xr + r) * 8) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  for (int e = tid; e < 2 * P2 * (C / 8); e += CONSUMERS)
    *reinterpret_cast<uint4*>(Y + ((e / (2 * P2)) * YR + M1 + e % (2 * P2)) * 8) =
        make_uint4(0, 0, 0, 0);
  if constexpr (CF::RESIDENT) {  // both convs' K * C tap rows, swizzled as a TMA box would be
    constexpr int CH = C / 8;    // 16-byte chunks a row
    for (int e = tid; e < 2 * K * C * CH; e += CONSUMERS) {
      const int conv = e / (K * C * CH), r = e / CH % (K * C), ch = e % CH;
      const uint4 v = RUN_STREAM ? *reinterpret_cast<const uint4*>(
                                       w + ((size_t)(conv ? row2 : row1) + r) * C + ch * 8)
                                 : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(base + conv * K * C * CF::P + hopper::swz<CF::P>(r * CF::P + ch * 16)) = v;
    }
  }
  hopper::fence_async_shared();
  hopper::bar_sync(1, CONSUMERS);

  // conv1's epilogue at (frame row j of Y, columns co, co + 1): bf16(leaky(v +
  // b1)), zero outside [0, T)
  auto to_y = [&](int j, int co, float v0, float v1) {
    const int t = t0 - P2 + j;
    const bool inside = t >= 0 && t < T;
    const float2 bv = *reinterpret_cast<const float2*>(b1 + co);
    mma::st_bf2(Y + ((co / 8) * YR + j) * 8 + co % 8, inside ? leaky(v0 + bv.x) : 0.f,
                inside ? leaky(v1 + bv.y) : 0.f);
  };
  // conv2's at output row r: + b2 + h_in, into dst (+ the stage mean's running sum)
  auto to_dst = [&](int r, int co, float v0, float v1) {
    const int t = t0 + r;
    if (r >= OUT || t >= T || (!RUN_STORES && T != -1)) return;  // T != -1: the product stays
    const size_t i = ((size_t)b * T + t) * C + co;
    const float2 bv = *reinterpret_cast<const float2*>(b2 + co);
    const float2 res = *reinterpret_cast<const float2*>(hin + i);
    v0 += bv.x + res.x;
    v1 += bv.y + res.y;
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
    *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
  };
  const int wg = warp / 4, wq = warp % 4;
  const int mbase = M1 == 128 ? 64 * wg : 0, nbase = M1 == 128 ? 0 : wg * CF::NWG;
  const int row = mbase + 16 * wq + (lane >> 2), col = nbase + 2 * (lane & 3);
  float acc[CF::NWG / 2];
  int n = 0;  // ring stages taken
  conv_wgmma<CF, K>(base, full, empty, S, n, X, xr * 16, d, mbase, nbase, acc);
#pragma unroll
  for (int j = 0; j < CF::NWG / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) to_y(row + 8 * h, col + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  hopper::fence_async_shared();
  hopper::bar_sync(1, CONSUMERS);
  conv_wgmma<CF, K>(CF::RESIDENT ? base + K * C * CF::P : base, full, empty, S, n, Y, YR * 16, 1,
                    mbase, nbase, acc);
#pragma unroll
  for (int j = 0; j < CF::NWG / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      to_dst(row + 8 * h, col + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// ---- C = 8: the whole stage in one launch (see the header) ----

// C8_SKIP (0 in the kernel the port runs) leaves a part out, for measuring
// where the time goes (tools/probe_bf16_kernels.py --c8-only): bit 0 the
// convs' products and their operand loads, bit 1 the convs' epilogues, bit 2
// the global loads of x and the taps, bit 3 the ResBlocks' staged copies of x.
// Its output is for measurement only.
#ifndef C8_SKIP
#define C8_SKIP 0
#endif

// a block's bytes: bf16 taps; x (float32) and the two bf16 staging tiles a row
constexpr c8::Bytes BF16_BYTES = {2, 32 + 2 * 16};

// acc[i] (the m16n8 accumulators of the warp's tile i) = the conv of the
// staged rows A ([nr][8] bf16, tile row r at r + GUARD) with taps w
// ([K][8][8] bf16, in x out) at dilation d, two taps a k16 step, for the
// warp's tiles that meet rows [lo, hi).
template <int K>
__device__ __forceinline__ void c8_conv(const bf16* __restrict__ A, const bf16* __restrict__ w,
                                        int d, int lo, int hi, int warp, int nwarps,
                                        float (&acc)[c8::TILES][4]) {
  constexpr int NP = (K + 1) / 2;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (C8_SKIP & 1) return;
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
        v.x = w[(q * 8 + kr) * 8 + col];
        v.y = w[(q * 8 + kr + 1) * 8 + col];
      }
      bfr[p][h] = *reinterpret_cast<uint32_t*>(&v);
    }
  // tap pairs outside, tiles inside: a pair's mma on the warp's tiles are
  // independent, so they issue back to back
  const int arow = c8::GUARD + (lane & 15) - (K - 1) / 2 * d, second = lane >> 4;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int q = 2 * p + second < K ? 2 * p + second : 2 * p;
#pragma unroll
    for (int i = 0; i < c8::TILES; ++i) {
      const int base = 16 * (warp + i * nwarps);
      if (base + 16 <= lo || base >= hi) continue;  // warp-uniform
      uint32_t a[4];
      mma::ldsm_x4(a, A + (base + arow + q * d) * 8);
      mma::mma16816(acc[i], a, bfr[p][0], bfr[p][1]);
    }
  }
}

__device__ __forceinline__ void c8_conv_k(int k, const bf16* A, const bf16* w, int d, int lo,
                                          int hi, int warp, int nwarps,
                                          float (&acc)[c8::TILES][4]) {
  if (k == 3)
    c8_conv<3>(A, w, d, lo, hi, warp, nwarps, acc);
  else if (k == 7)
    c8_conv<7>(A, w, d, lo, hi, warp, nwarps, acc);
  else
    c8_conv<11>(A, w, d, lo, hi, warp, nwarps, acc);
}

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}

// out[b, t0 .. t0 + M) = the stage mean, for x [B, T, 8]; wg the taps of
// every conv ([k][8][8] bf16 each, in weight order), bg the float32 biases
// [n_convs][8]. Shared memory: X [nr][8] float32, S and Y [nr][8] bf16, the
// taps, the biases. A lane's accumulators hold rows g and g + 8 (g = lane /
// 4) of each tile, columns 2 (lane % 4) and + 1.
__global__ void __launch_bounds__(32 * c8::MAX_WARPS)
c8_stage_kernel(const float* __restrict__ x, float* __restrict__ out, const bf16* __restrict__ wg,
                const float* __restrict__ bg, const __grid_constant__ c8::Stage st) {
  extern __shared__ float4 sm4[];
  const int nr = st.rows + 2 * c8::GUARD;
  float* X = reinterpret_cast<float*>(sm4);
  bf16* S = reinterpret_cast<bf16*>(X + nr * 8);
  bf16* Y = S + nr * 8;
  bf16* W = Y + nr * 8;
  float* Bs = reinterpret_cast<float*>(W + st.n_w);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nwarps = nt >> 5;
  const int lane = tid & 31, g = lane >> 2, co = 2 * (lane & 3);
  const int b = blockIdx.y, T = st.T, H = st.halo, t0 = blockIdx.x * st.M;
  const float* xb = x + (size_t)b * T * 8;

  // the taps, the biases and x on rows [-GUARD, rows + GUARD) (zero outside
  // [0, T)) by cp.async, every copy in flight at once
  for (int e = tid; e < (C8_SKIP & 4 ? 0 : st.n_w / 8); e += nt)
    mma::cp_async16(W + 8 * e, wg + 8 * e, true);
  for (int e = tid; e < st.n_b / 4; e += nt) mma::cp_async16(Bs + 4 * e, bg + 4 * e, true);
  for (int e = tid; e < 2 * nr; e += nt) {
    const int r = e >> 1, c = e & 1, t = t0 - H - c8::GUARD + r;
    const bool inside = t >= 0 && t < T;
    if (!(C8_SKIP & 4))
      mma::cp_async16(X + 8 * r + 4 * c, inside ? xb + (size_t)t * 8 + 4 * c : xb, inside);
    *reinterpret_cast<uint2*>(Y + 8 * r + 4 * c) = make_uint2(0, 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait_all();

  float h[c8::TILES][4], mean[c8::TILES][4], acc[c8::TILES][4];
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i) mean[i][0] = mean[i][1] = mean[i][2] = mean[i][3] = 0.f;
  int wo = 0, ci = 0;
  for (int u = 0; u < st.n_units;) {
    int reach = 0, end = u;  // this ResBlock's units [u, end) and its reach
    do {
      const int k = c8::unit_k(st.unit[end]);
      reach += (k - 1) / 2 * (c8::unit_d(st.unit[end]) + 1);
    } while (!c8::unit_last(st.unit[end++]));
    __syncthreads();  // X is in (and the last ResBlock's reads of S are done)
    for (int e = tid; e < (C8_SKIP & 8 ? 0 : 2 * nr); e += nt)
      *reinterpret_cast<uint2*>(S + 4 * e) =
          mma::pack4(leaky4(*reinterpret_cast<const float4*>(X + 4 * e)));
    __syncthreads();
    int lo = H - reach, hi = H + st.M + reach;
    for (; u < end; ++u) {
      const int k = c8::unit_k(st.unit[u]), d = c8::unit_d(st.unit[u]);
      const bool first = c8::unit_first(st.unit[u]), last = u + 1 == end;
      lo += (k - 1) / 2 * d;
      hi -= (k - 1) / 2 * d;
      c8_conv_k(k, S, W + wo, d, lo, hi, warp, nwarps, acc);
      wo += k * 64;
      const float2 b1 = *reinterpret_cast<const float2*>(Bs + 8 * ci + co);
#pragma unroll
      for (int i = 0; i < c8::TILES; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * (warp + i * nwarps) + g + 8 * half, t = t0 - H + r;
          if (r < lo || r >= hi || (C8_SKIP & 2)) continue;
          const bool inside = t >= 0 && t < T;
          mma::st_bf2(Y + 8 * (r + c8::GUARD) + co,
                      inside ? leaky(acc[i][2 * half] + b1.x) : 0.f,
                      inside ? leaky(acc[i][2 * half + 1] + b1.y) : 0.f);
        }
      ++ci;
      __syncthreads();
      lo += (k - 1) / 2;
      hi -= (k - 1) / 2;
      c8_conv_k(k, Y, W + wo, 1, lo, hi, warp, nwarps, acc);
      wo += k * 64;
      const float2 b2 = *reinterpret_cast<const float2*>(Bs + 8 * ci + co);
#pragma unroll
      for (int i = 0; i < c8::TILES; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * (warp + i * nwarps) + g + 8 * half, t = t0 - H + r;
          if (r < lo || r >= hi || (C8_SKIP & 2)) continue;
          const bool inside = t >= 0 && t < T;
          float* hv = h[i] + 2 * half;
          float2 res = make_float2(hv[0], hv[1]);
          if (first) res = *reinterpret_cast<const float2*>(X + 8 * (r + c8::GUARD) + co);
          hv[0] = (inside ? acc[i][2 * half] + b2.x : 0.f) + res.x;
          hv[1] = (inside ? acc[i][2 * half + 1] + b2.y : 0.f) + res.y;
          if (last) {
            mean[i][2 * half] += hv[0];
            mean[i][2 * half + 1] += hv[1];
          } else {
            mma::st_bf2(S + 8 * (r + c8::GUARD) + co, leaky(hv[0]), leaky(hv[1]));
          }
        }
      ++ci;
      __syncthreads();
    }
  }
  const float n_res = (float)st.n_res;
#pragma unroll
  for (int i = 0; i < c8::TILES; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (warp + i * nwarps) + g + 8 * half, t = t0 - H + r;
      if (r < H || r >= H + st.M || t >= T) continue;
      *reinterpret_cast<float2*>(out + ((size_t)b * T + t) * 8 + co) =
          make_float2(mean[i][2 * half] / n_res, mean[i][2 * half + 1] / n_res);
    }
}

int c8_stage(const float* x, float* out, const bf16* w, const float* bias, const int* ksizes,
             const int* nunits, const int* dils, int n_res, int B, int T, cudaStream_t stream) {
  c8::Stage st;
  c8::Plan plan;
  int err = c8::plan_stage(&st, &plan, ksizes, nunits, dils, n_res, B, T, BF16_BYTES);
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

template <class CF, int K>
int launch_unit(const CUtensorMap& map, const bf16* w, const float* hin, const float* b1, const float* b2,
                float* dst, int B, int T, int d, int row1, int row2, int epi, int first, int last,
                float n_res, cudaStream_t stream) {
  // the largest smem an instantiation takes, allowed once a device
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    e = cudaFuncSetAttribute(unit_kernel<CF, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CF::LIMIT);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  const int S = unit_stages<CF, K>(d);
  if (!CF::RESIDENT && S < 2) return (int)cudaErrorInvalidValue;
  constexpr int OUT = CF::M1 - (K - 1);
  unit_kernel<CF, K><<<dim3((T + OUT - 1) / OUT, B), UNIT_THREADS, unit_smem<CF, K>(d), stream>>>(
      map, w, hin, b1, b2, dst, T, d, row1, row2, S, epi, first, last, n_res);
  return (int)cudaGetLastError();
}

template <class CF>
int unit_k(const CUtensorMap& map, const bf16* w, const float* hin, const float* b1, const float* b2, float* dst,
           int B, int T, int k, int d, int row1, int row2, int epi, int first, int last,
           float n_res, cudaStream_t stream) {
  switch (k) {
#define RESBLOCK_UNIT_CASE(K)                                                                   \
  case K:                                                                                       \
    return launch_unit<CF, K>(map, w, hin, b1, b2, dst, B, T, d, row1, row2, epi, first, last, \
                              n_res, stream);
    RESBLOCK_UNIT_CASE(3) RESBLOCK_UNIT_CASE(7) RESBLOCK_UNIT_CASE(11)
#undef RESBLOCK_UNIT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class CF>
int unit_smem_k(int k, int d) {
  switch (k) {
    case 3: return unit_smem<CF, 3>(d);
    case 7: return unit_smem<CF, 7>(d);
    case 11: return unit_smem<CF, 11>(d);
    default: return -1;
  }
}

// The stage's units at C >= 16: one tensor map over the tap stacks, one
// launch a unit.
template <class CF>
int stage_units(const float* x, float* out, float* h, float* tmp, const bf16* w, const float* bias,
                const int* ksizes, const int* nunits, const int* dils, int n_res, int B, int T,
                cudaStream_t stream) {
  constexpr int C = CF::C;
  long long rows = 0;
  for (int j = 0; j < n_res; ++j) rows += 2LL * nunits[j] * ksizes[j] * C;
  CUtensorMap map;
  int err = hopper::make_map_2d(&map, w, (uint64_t)rows, C, CF::BKR, C < 64 ? C : 64,
                                hopper::swizzle_mode<CF::P>());
  if (err) return err;
  int row = 0, ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    const int k = ksizes[j];
    const float* hin = x;
    for (int u = 0; u < nunits[j]; ++u) {
      const int d = dils[di++];
      if ((k - 1) / 2 * d > MAX_PAD) return (int)cudaErrorInvalidValue;
      const bool last_unit = u + 1 == nunits[j];
      float* dst = last_unit ? out : (u % 2 ? tmp : h);
      err = unit_k<CF>(map, w, hin, bias + (size_t)ci * C, bias + (size_t)(ci + 1) * C, dst, B, T,
                       k, d, row, row + k * C, last_unit ? EPI_MEAN : EPI_RESID, j == 0,
                       j == n_res - 1, (float)n_res, stream);
      if (err) return err;
      row += 2 * k * C;
      ci += 2;
      hin = dst;
    }
  }
  return 0;
}

}  // namespace

// Shared-memory bytes of the unit kernel at (C, k, d), or -1 where it has no
// such instance (a check for ops/resblock.py:unit_plan).
extern "C" int resblock_unit_smem_bf16(int C, int k, int d) {
  switch (C) {
    case 16: return unit_smem_k<Cfg16>(k, d);
    case 32: return unit_smem_k<Cfg32>(k, d);
    case 64: return unit_smem_k<Cfg64>(k, d);
    case 128: return unit_smem_k<Cfg128>(k, d);
    case 256: return unit_smem_k<Cfg256>(k, d);
    default: return -1;
  }
}

// The C = 8 stage's block plan (resblock_c8.cuh:plan_stage with bf16 taps):
// out = {M, halo, rows, warps, smem, blocks}; returns its error (a check for
// ops/resblock.py:c8_plan).
extern "C" int resblock_c8_plan_bf16(const int* ksizes, const int* nunits, const int* dils,
                                     int n_res, int B, int T, int* out) {
  return c8::export_plan(ksizes, nunits, dils, n_res, B, T, BF16_BYTES, out);
}

// resblock.cu's resblock_stage with bf16 taps: x [B,T,C] float32 input (read
// only); out [B,T,C] the stage mean; h, tmp [B,T,C] float32 scratch (unused
// at C = 8). w: the
// stage's convs in (resblock, unit, conv1/conv2) order, each [k, C, C] (tap,
// in, out) bf16, 16-byte aligned; bias [n_convs, C] float32. ksizes[j] /
// nunits[j] give resblock j's kernel size and unit count, dils the units'
// dilations in order. C is 8, 16, 32, 64, 128 or 256. Launches one kernel a
// unit (sum(nunits)) at C >= 16, one a stage at C = 8, on `stream`; returns
// the first error (cudaError_t) or 0.
extern "C" int resblock_stage_bf16(const float* x, float* out, float* h, float* tmp,
                                   const void* w_ptr, const float* bias, const int* ksizes,
                                   const int* nunits, const int* dils, int n_res, int B, int T,
                                   int C, void* stream_ptr) {
  if (B < 1 || T < 1 || n_res < 1) return (int)cudaErrorInvalidValue;
  const bf16* w = static_cast<const bf16*>(w_ptr);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (C) {
    case 16: return stage_units<Cfg16>(x, out, h, tmp, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    case 32: return stage_units<Cfg32>(x, out, h, tmp, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    case 64: return stage_units<Cfg64>(x, out, h, tmp, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    case 128: return stage_units<Cfg128>(x, out, h, tmp, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    case 256: return stage_units<Cfg256>(x, out, h, tmp, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    case 8: return c8_stage(x, out, w, bias, ksizes, nunits, dils, n_res, B, T, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
