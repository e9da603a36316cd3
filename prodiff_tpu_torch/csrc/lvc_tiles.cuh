// One FastDiff LVC layer over a work unit of R consecutive rows, shared by
// the fused-layer kernel (ublock.cu, K4) and the one-launch block kernel
// (ublock_block.cu, K7). The layer, with conv dilation d:
//   xa  = x + audio_down
//   y   = leaky_0.2(conv3_d(leaky_0.2(xa)) + conv_bias)   (SAME zero padding)
//   y   = LVC(y): per hop window l, bias[l] + taps(y) . K[l]  ([hop, 96] x [96, 64])
//   out = xa + sigmoid(y[:, :32]) * tanh(y[:, 32:])
// The LVC's taps are zero at times -1 and T (the conv of the zero padding is
// leaky(bias), not zero) and read the neighbouring window's y at a window
// edge inside the sequence. T == L * hop.
//
// A unit is R rows t0 .. t0 + R - 1 of one batch row (t0 a multiple of R);
// the last unit of a row may reach past T, and its rows there are neither
// computed into y nor written. The hop is any multiple of 8
// (lvc_window.cuh:hop_supported): the window product works on 8-row tiles
// starting at multiples of 8, so each tile lies in one window, and a unit
// may span windows of any such hop (5 at hop 72, the most a tiled unit
// stages). The tiled plan also takes every multiple of 4 from hop 64 on
// (layer_hop_supported, as ublock_layer_packed's hop % 4 at C = 32): its
// SPLIT build gives the last 4 rows of a tile the next window's kernel
// where the window edge falls inside it. Two plans:
//   - tiled, hop >= 64 (FastDiff's audio-rate blocks, bound by FP32 FMAs):
//     R = 256; the unit's window kernels (up to 4 windows at hop 64 and 96)
//     are copied into shared memory; each thread computes 8 rows x 8 outputs
//     (gate j..j+3 and filter 32+j..32+j+3, so the gate forms in registers),
//     and the conv 4 rows x 8 outputs.
//   - streaming, hop < 64 (block 0, hop 8: bound by the window kernels'
//     bytes, 24.6 KB a window against 8 rows of work): R = 32; no kernel is
//     staged. A warp owns 8 rows (one window's, 8 | hop) and half of the
//     outputs, and reads its 12 KB of that window's kernel once, from HBM
//     into registers: 24 128-bit non-coherent loads a lane, issued once x +
//     audio_down is staged, so the SM has its unit's 98 KB in flight while
//     the conv runs. Not earlier: a barrier waits for the outstanding loads
//     of the threads that reach it (issued before the staging barrier, the
//     loads no longer overlapped the conv: 11.9 against 9.8 us a layer on an
//     H100 80GB HBM3 at 700 W, PERF.md).
// A unit, 256 threads:
//   1. tiled: cp.async (16 B, through L2) of the unit's window kernels and
//      biases, which land while 2 and 3 run;
//   2. xs := x + audio_down for times t0 - d - 1 .. t0 + R + d (zero outside
//      [0, T)), 16-byte loads issued in batches (a load-store loop would pay
//      one round trip to memory an iteration); x through L2 (in K7 other
//      blocks wrote it); streaming: then the window kernels' loads;
//   3. the conv, with leaky applied to each xs value as it is loaded (one
//      FMUL per 8 FMAs) and a warp's weights read as broadcasts, + bias,
//      leaky, into yT (k-major: yT[c][col], col = j + 3 for time t0 - 1 + j,
//      so the unit's own rows start 16-byte aligned); y := 0 outside [0, T);
//      the two edge rows (times t0 - 1 and t0 + R) by all threads, 4 lanes a
//      value;
//   4. thread 0 prefetches the block's next unit's rows and kernels into L2
//      (Hopper's bulk prefetch); the window product, + bias, the gate, + xa
//      (from xs), written once as float4s. Tiled: per channel c a thread
//      loads its 10 y values once for all three taps (two float4s and two
//      scalars) and two float4s of kernel per tap, 10 loads for 192 FMAs.
//      Streaming: a lane (channel quarter kq, column quad og) loads the same
//      4 y loads a channel for 96 FMAs against kernel in registers, then the
//      4 channel quarters are summed by shuffles (24 a lane) that leave each
//      lane one row's gate and filter quads.
// The conv weight is staged once per layer as [tap][in][out] (12 KB).
// Shared memory: at hop 256 and d = 27, 110,976 bytes (two blocks an SM); at
// hop 64, 185,472 (one); at hop 8, 28,800 (one block an SM: the streaming
// kernel's registers). The tiled kernels are compiled for the blocks an SM
// that their plan's shared memory allows (two_per_sm).
// Why the tiled unit does not double-buffer its window kernels: at T_mel =
// 512, B = 1, hop 64 (and hop 8) gives 128 units for 132 SMs, one unit a
// block, so there is no next unit; at hop 256 a second 24.6 KB buffer would
// take two 111 KB blocks an SM down to one.
//
// Window elements W: float, or bf16 in K4's and K7's bf16 builds (the
// window kernels of the JAX package's accelerator route, whose
// KernelPredictor computes in bf16). The function is the Pallas kernels':
// each bf16 window value is widened exactly and the product is float32
// (prodiff_tpu/ops/pallas/ublock.py:437-446, :772). The float build keeps
// the FMA product above; the bf16 build runs the window product on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32), the bf16 window the B
// operand as it is, never widened:
//   - the conv's epilogue splits each float32 y into TERMS bf16 terms (y =
//     y_0 + y_1 + y_2, each the rounded remainder: 24 significant bits, y's
//     own) and stores them in ys instead of yT; every term's product with
//     the exact window accumulates in float32, so the result keeps float32
//     accuracy (two terms leave 2^-17 of |y|, over the card tolerance on
//     wide-range activations: tests/test_torch_ublock_bf16_split.py);
//   - a k16 step's TERMS products go, smallest term first, into a zeroed
//     fragment that is then added to the sum in float32: the tensor cores
//     truncate what they add to an accumulator, and a chain of all 18 into
//     one left a 4-layer block on wide-range inputs further from its twin
//     than the float build;
//   - both plans stage the unit's windows as bf16 by cp.async (each kernel
//     row's 16-byte chunks swizzled by the row, kw_at); the tiled plan
//     issues its first unit's copies before it stages the conv weight, the
//     32-row plan (hop < 64) right behind its x loads (issued first, its 49
//     KB held the conv back);
//   - a warp's fragment holds gate columns 8j .. 8j + 7 beside filter
//     columns 32 + 8j .., so the gate forms in registers: tiled (R = 256),
//     a warp 32 rows x 64 outputs; R = 32, a warp 16 rows x 16 outputs. A
//     k16 step is one tap's 16 channels: A (the taps of y, rows shifted by
//     the tap) from ys by ldmatrix, B from the window by ldmatrix.trans. A
//     warp makes one pass a window its rows touch and writes that window's
//     rows in the pass, so every hop the plans take (a window edge inside
//     an m16 tile included: hop 8, 72, or hops of 4 mod 8) runs one code.
// The tiled plan's product is mma.sync too, in the unit's 256 rows: wgmma
// (m64n64k16, A from registers or from shared memory) and 128-row units were
// tried and not kept (PERF.md; no committed comparison). The rest of the
// unit (staging, the conv on FP32 FMAs, the gate) is the float unit's.
// Shared memory of the bf16 build at d = 27: hop
// 256 114,432 bytes (two blocks an SM), hop 64 152,064 (one), hop 8 80,384.
// The biases are float32 in both builds.
//
// LVCT_SKIP (0 in every kernel the port runs) builds variants that leave a
// phase out, for measuring where a unit's time goes (chip_smoke.py): bit 0
// the conv, bit 1 the window product with its kernel loads (the output is
// then xa). Their outputs are wrong by design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lvc_window.cuh"
#include "mma_bf16.cuh"
#include "tile_gemm.cuh"

#ifndef LVCT_SKIP
#define LVCT_SKIP 0
#endif

namespace lvct {

using lvcw::C;
using lvcw::CO;
using lvcw::KC;
using lvcw::MAX_SMEM;
using lvcw::NT;
using lvcw::StackT;
using bf16 = __nv_bfloat16;

constexpr float SLOPE = 0.2f;
constexpr int WS = 3 * C * C + C; // the staged conv weight and bias, floats

// Floats of one staged window: its kernel [KC][CO] of W values, then its
// float bias [CO].
template <class W>
__host__ __device__ constexpr int kw_floats() { return KC * CO * (int)sizeof(W) / 4 + CO; }
constexpr int TILED_MIN_HOP = 64;
constexpr int TILED_ROWS = 256, STREAM_ROWS = 32;
constexpr bool RUN_CONV = !(LVCT_SKIP & 1), RUN_WINDOWS = !(LVCT_SKIP & 2);
constexpr int TERMS = 3;  // bf16 terms of a float32 y in the bf16 build's product

// Whether window elements W take the tensor-core product (the bf16 build).
template <class W>
constexpr bool MMA = std::is_same_v<W, bf16>;

__host__ __device__ inline int unit_rows(int hop) {
  return hop >= TILED_MIN_HOP ? TILED_ROWS : STREAM_ROWS;
}

// K4's hops (K7 keeps its own gate): K6's, and from the tiled plan on every
// multiple of 4, which run_unit's SPLIT build takes (an 8-row tile then lies
// in one window or 4 + 4 rows in two).
__host__ inline bool layer_hop_supported(int hop) {
  return lvcw::hop_supported(hop) || (hop >= TILED_MIN_HOP && hop % 4 == 0);
}

// Whether hop needs run_unit's SPLIT build (a window edge inside a tile).
__host__ inline bool split_tiles(int hop) { return hop % 8 != 0; }

__host__ __device__ inline int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The most windows a unit (t0 a multiple of R) can touch.
__host__ __device__ inline int unit_windows(int hop) {
  const int R = unit_rows(hop);
  return (hop - gcd(R, hop) + R - 1) / hop + 1;
}

// Windows whose kernels a block stages in shared memory (none when the
// float build streams; the bf16 build stages them in both plans).
template <class W = float>
__host__ __device__ inline int staged_windows(int hop) {
  return hop >= TILED_MIN_HOP || MMA<W> ? unit_windows(hop) : 0;
}

// Floats of y as the product reads it: yT [C][R + 8] (float build), or the
// TERMS bf16 terms ys [TERMS][C / 8][R + 2][8] (bf16 build).
template <class W>
__host__ __device__ inline int y_floats(int R) {
  return MMA<W> ? TERMS * (R + 2) * C / 2 : C * (R + 8);
}

// Shared-memory floats of a block for conv dilations up to dmax.
template <class W = float>
__host__ __device__ inline int smem_floats(int hop, int dmax) {
  const int R = unit_rows(hop);
  return staged_windows<W>(hop) * kw_floats<W>() + WS + (R + 2 * (dmax + 1)) * C +
         y_floats<W>(R);
}

// Whether two blocks of smem_floats(hop, dmax) fit on one SM (228 KB, 1 KB
// reserved a block). Where they do (hop >= 256) the tiled kernel is
// compiled for two blocks an SM (at most 128 registers a thread); where they
// do not (hop 64 and 96: 185 KB; 152 KB with bf16 windows) for one, with
// the registers that frees.
template <class W = float>
__host__ __device__ inline bool two_per_sm(int hop, int dmax) {
  return 2 * (smem_floats<W>(hop, dmax) * 4 + 1024) <= 233472;
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, SLOPE * v); }

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}

__device__ __forceinline__ float gated(float xa, float g, float f) {
  return xa + tanhf(f) / (1.f + expf(-g));
}

// 16 bytes read once: non-coherent, not kept in L1. Volatile, so that the
// loads stay where they are issued (ahead of the phases they overlap).
__device__ __forceinline__ float4 ld4_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Four bf16 values (8 bytes) widened to float32 (exact).
__device__ __forceinline__ float4 widen4(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ld4_stream of four bf16 window values, widened.
__device__ __forceinline__ float4 ld4_stream(const bf16* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return widen4(v);
}

// Four window values from shared memory, as float32.
__device__ __forceinline__ float4 ld4w(const float* p) { return tile::ld4(p); }
__device__ __forceinline__ float4 ld4w(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// xs is [rows][32] with its 8 float4 columns swizzled by the row, so that
// rows 4 apart (one conv thread's neighbours) fall in different banks.
__device__ __forceinline__ int xs_at(int row, int c4) {
  return row * C + ((c4 ^ ((row >> 2) & 7)) << 2);
}

// The bf16 build's y terms: ys [TERMS][C / 8][R + 2][8] (bf16), row j =
// time t0 - 1 + j: each 8-channel chunk a column of 16-byte rows, so the 8
// consecutive rows an ldmatrix phase reads (from any row: a tap's shift)
// are 128 contiguous bytes, in distinct banks.
template <int R>
__device__ __forceinline__ int ys_at(int j, int c) {
  return ((c >> 3) * (R + 2) + j) * 8 + (c & 7);
}

// A staged bf16 window kernel [KC][CO]: row k's eight 16-byte chunks
// swizzled by k & 7 (ldmatrix.trans reads 8 consecutive rows of a chunk
// from distinct banks).
__device__ __forceinline__ int kw_at(int k, int n) {
  return k * CO + (((n >> 3) ^ (k & 7)) << 3) + (n & 7);
}

struct Tiles {
  float* Kb;  // [staged windows][kw_floats<W>()]: kernel [KC][CO] of W, then bias [CO]
  float* Ws;  // [3][C][C] (tap, in, out) then the bias [C]
  float* xs;  // [R + 2h][32] (swizzled), row i = time t0 - h + i, h = dmax + 1
  float* yT;  // float build: [C][R + 8], col j + 3 = time t0 - 1 + j
  bf16* ys;   // bf16 build, in yT's place: the y terms (ys_at)
};

template <bool STREAM = false, class W = float>
__device__ __forceinline__ Tiles carve(float* smem, int hop, int dmax) {
  const int R = unit_rows(hop);
  Tiles tl;
  tl.Kb = smem;
  tl.Ws = tl.Kb + (STREAM && !MMA<W> ? 0 : unit_windows(hop) * kw_floats<W>());
  tl.xs = tl.Ws + WS;
  tl.yT = tl.xs + (R + 2 * (dmax + 1)) * C;
  tl.ys = reinterpret_cast<bf16*>(tl.yT);
  return tl;
}

// One layer's operands: x_in [B, T, C] (written by other blocks in K7: read
// through L2 only), ad [B, T, C], cw [C, C, 3] (torch Conv1d layout), cb [C],
// the window stack at (step, layer), x_out [B, T, C].
template <class W>
struct LayerT {
  using Window = W;
  const float* x;
  const float* ad;
  const float* cw;
  const float* cb;
  StackT<W> s;
  float* out;
  int T, hop, dil;
};

// The conv weight as [tap][in][out]; the caller synchronises before use.
// Thread (warp w, lane = output channel co) loads float4s 3w .. 3w + 2 of
// co's 96 weights (torch layout [out][in][tap]), all in flight before the
// first store, and stores them with co consecutive across the warp (no bank
// conflicts).
template <class Lyr>
__device__ __forceinline__ void stage_conv(const Lyr& a, const Tiles& tl, int tid) {
  static_assert(3 * C * C == 3 * 4 * NT, "three float4s a thread");
  const int co = tid & 31, w = tid >> 5;
  float4 v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v[k] = __ldg(reinterpret_cast<const float4*>(a.cw + co * 3 * C) + 3 * w + k);
  const float cb = tid < C ? __ldg(a.cb + tid) : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 4 * (3 * w + k) + i, ci = f / 3, q = f % 3;  // f = ci * 3 + q
      tl.Ws[(q * C + ci) * C + co] = e[i];
    }
  }
  if (tid < C) tl.Ws[3 * C * C + tid] = cb;
}

// Start the copies of the windows that unit (b, t0) reads (a tiled unit, or
// any unit of the bf16 build); one commit group. bf16 kernels land swizzled
// (kw_at).
template <int R, class W>
__device__ __forceinline__ void issue_kernels(const LayerT<W>& a, int b, int t0, const Tiles& tl,
                                              int tid) {
  if constexpr (!RUN_WINDOWS) return;
  constexpr int KWF = kw_floats<W>(), PIECES = KC * CO * (int)sizeof(W) / 16;
  const int l0 = t0 / a.hop, l1 = (min(t0 + R, a.T) - 1) / a.hop;
  for (int l = l0; l <= l1; ++l) {
    const float* src = reinterpret_cast<const float*>(a.s.kernel(b, l));
    const float* bsrc = a.s.bias(b, l);
    float* dst = tl.Kb + (l - l0) * KWF;
    for (int i = tid; i < PIECES; i += NT) {
      if constexpr (MMA<W>)  // piece i: chunk i % 8 of kernel row i / 8
        tile::cp_async16(dst + kw_at(i >> 3, (i & 7) << 3) / 2, src + 4 * i, true);
      else
        tile::cp_async16(dst + 4 * i, src + 4 * i, true);
    }
    if (tid < CO / 4) tile::cp_async16(dst + KWF - CO + 4 * tid, bsrc + 4 * tid, true);
  }
  tile::cp_async_commit();
}

// Hopper's bulk L2 prefetch of `bytes` (a multiple of 16) at p (16-byte
// aligned): one instruction, no registers or shared memory.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Bring unit (b, t0)'s x + audio_down rows and window kernels toward L2
// while the current unit computes (thread 0 issues a few bulk prefetches).
template <int R, class W>
__device__ __forceinline__ void prefetch_unit(const LayerT<W>& a, int b, int t0) {
  const int h = a.dil + 1, lo = max(t0 - h, 0), hi = min(t0 + R + h, a.T);
  const size_t off = ((size_t)b * a.T + lo) * C;
  const unsigned bytes = (unsigned)(hi - lo) * C * sizeof(float);
  prefetch_l2(a.x + off, bytes);
  prefetch_l2(a.ad + off, bytes);
  for (int l = t0 / a.hop; l <= (min(t0 + R, a.T) - 1) / a.hop; ++l) {
    prefetch_l2(a.s.kernel(b, l), KC * CO * sizeof(W));
    prefetch_l2(a.s.bias(b, l), CO * sizeof(float));
  }
}

// A lane's share of one window's kernel for a streaming product (K4's
// streaming plan, and K6 below hop 64): rows (tap q, channel kq + 4i) of
// column quad col, channels 4 apart so that the 4 quarters' x rows fall in
// different banks. kb is the bias quad in the kq = 0 lanes, else 0 (the
// quarters' sum adds it once).
struct StreamKernel {
  float4 k[C / 4][3];
  float4 kb;
};

// Issue the 24 + 1 loads of a lane's StreamKernel: K the window's kernel
// [KC][CO] (float, or bf16 widened as it arrives), bias its [CO].
template <class W>
__device__ __forceinline__ void load_stream_share(const W* K, const float* bias, int kq,
                                                  int col, StreamKernel& sk) {
  K += col;
#pragma unroll
  for (int i = 0; i < C / 4; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q) sk.k[i][q] = ld4_stream(K + (q * C + kq + 4 * i) * CO);
  sk.kb = kq == 0 ? ld4_stream(bias + col) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// A lane's channel quarter kq of the window product for 8 rows, from x
// k-major (xT[c * ld + j] = x at time t - 1 + j, j < 10; xT + 1 16-byte
// aligned): 4 shared loads per 96 FMAs, acc[row][p] starting from the
// bias. The 4 quarters are then reduced by shuffles (xor 16, then xor 8:
// rows halve each step), leaving r2[m] = row 2kq + m of the lane's column
// quad. PRODUCT false (measurement only): r2 is the bias.
template <bool PRODUCT = true>
__device__ __forceinline__ void stream_quarters(const float* xT, int ld, int kq,
                                                const StreamKernel& sk, float (&r2)[2][4]) {
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    acc[m][0] = sk.kb.x; acc[m][1] = sk.kb.y; acc[m][2] = sk.kb.z; acc[m][3] = sk.kb.w;
  }
  if constexpr (PRODUCT) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float* xr = xT + (kq + 4 * i) * ld;  // time t - 1
      float v[10];
      v[0] = xr[0];
      const float4 u0 = tile::ld4(xr + 1), u1 = tile::ld4(xr + 5);
      v[1] = u0.x; v[2] = u0.y; v[3] = u0.z; v[4] = u0.w;
      v[5] = u1.x; v[6] = u1.y; v[7] = u1.z; v[8] = u1.w;
      v[9] = xr[9];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 k = sk.k[i][q];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float a = v[m + q];
          acc[m][0] = fmaf(a, k.x, acc[m][0]);
          acc[m][1] = fmaf(a, k.y, acc[m][1]);
          acc[m][2] = fmaf(a, k.z, acc[m][2]);
          acc[m][3] = fmaf(a, k.w, acc[m][3]);
        }
      }
    }
  }
  constexpr unsigned ALL = 0xffffffffu;
  const bool hi = kq & 2, lo = kq & 1;
  float r4[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)  // keep rows 4hi .. 4hi + 3
#pragma unroll
    for (int p = 0; p < 4; ++p)
      r4[m][p] = (hi ? acc[m + 4][p] : acc[m][p]) +
                 __shfl_xor_sync(ALL, hi ? acc[m][p] : acc[m + 4][p], 16);
#pragma unroll
  for (int m = 0; m < 2; ++m)  // keep rows 4hi + 2lo, + 1: rows 2kq, 2kq + 1
#pragma unroll
    for (int p = 0; p < 4; ++p)
      r2[m][p] = (lo ? r4[m + 2][p] : r4[m][p]) +
                 __shfl_xor_sync(ALL, lo ? r4[m][p] : r4[m + 2][p], 8);
}

// K4's streaming plan: warp w owns rows 8(w >> 1) .. + 7 of the unit and
// output half oh = w & 1 (gate 16oh .. + 15, filter 32 + 16oh .. + 15);
// lane (kq = lane >> 3, og = lane & 7) holds column quad col (og < 4: gate
// quad og, else filter quad og - 4) of its window's kernel.
__device__ __forceinline__ int stream_col(int tid) {
  const int og = tid & 7;
  return (og & 4 ? C : 0) + 16 * ((tid >> 5) & 1) + 4 * (og & 3);
}

// Issue the loads of a lane's StreamKernel for unit (b, t0).
template <class W>
__device__ __forceinline__ void load_stream_kernel(const LayerT<W>& a, int b, int t0, int tid,
                                                   StreamKernel& sk) {
  const int t = t0 + 8 * (tid >> 6);
  if (t >= a.T) return;  // the warp's rows are past the sequence end
  const int l = t / a.hop;
  load_stream_share(a.s.kernel(b, l), a.s.bias(b, l), (tid >> 3) & 3, stream_col(tid), sk);
}

// The streaming window product of unit (b, t0) (R rows; yT and xs staged):
// the lane's quarter sums (stream_quarters), then gate and filter quads meet
// (xor 4); each lane writes one row's 4 outputs.
template <int R, class W>
__device__ __forceinline__ void stream_product(const LayerT<W>& a, int b, int t0, const Tiles& tl,
                                               int tid, const StreamKernel& sk) {
  constexpr int LDY = R + 8;
  const int T = a.T, h = a.dil + 1;
  const int r0 = 8 * (tid >> 6), kq = (tid >> 3) & 3, og = tid & 7;
  if (t0 + r0 >= T) return;  // past the sequence end (8 | hop)
  float r2[2][4], o[4];
  stream_quarters(tl.yT + r0 + 3, LDY, kq, sk, r2);  // time t0 + r0 - 1
  constexpr unsigned ALL = 0xffffffffu;
  const bool filt = og & 4;
#pragma unroll
  for (int p = 0; p < 4; ++p)  // gate lanes keep row 2kq, filter lanes 2kq + 1
    o[p] = __shfl_xor_sync(ALL, filt ? r2[0][p] : r2[1][p], 4);
  const int row = r0 + 2 * kq + filt, c4 = (stream_col(tid) & (C - 1)) >> 2;
  float g[4], f[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    g[p] = filt ? o[p] : r2[0][p];
    f[p] = filt ? r2[1][p] : o[p];
  }
  const float4 xa = tile::ld4(tl.xs + xs_at(row + h, c4));
  tile::st4(a.out + ((size_t)b * T + t0 + row) * C + 4 * c4,
            make_float4(gated(xa.x, g[0], f[0]), gated(xa.y, g[1], f[1]),
                        gated(xa.z, g[2], f[2]), gated(xa.w, g[3], f[3])));
}

// The TERMS bf16 terms of the pair (a, b) (a in the low half of each word,
// as ldmatrix reads k order): term i rounds what terms 0 .. i-1 left. Each
// remainder is exact in float32.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
  }
}

// Store y values v[0 .. N-1] of channels c .. c + N - 1 (N = 4 or 8, c a
// multiple of N) at ys row j, as their TERMS terms.
template <int N, int R>
__device__ __forceinline__ void store_terms(bf16* ys, int j, int c, const float (&v)[N]) {
  static_assert(N == 4 || N == 8, "half or whole 16-byte chunks");
  uint32_t t[N / 2][TERMS];
#pragma unroll
  for (int p = 0; p < N / 2; ++p) split_pair(v[2 * p], v[2 * p + 1], t[p]);
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    bf16* dst = ys + i * (R + 2) * C + ys_at<R>(j, c);
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(t[0][i], t[1][i], t[2][i], t[3][i]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(t[0][i], t[1][i]);
  }
}

// The bf16 build's window product, + bias, the gate, + xa, for
// one warp on mma.sync: MT m16 tiles of rows r0 .. r0 + 16 MT - 1 of
// unit (b, t0) by NG channel groups j0 .. j0 + NG - 1 (n8 tiles: gate
// columns 8j, then filter columns 32 + 8j). acc = bias + sum over the 6 k16
// steps (tap q = ks / 2, channels 16 (ks & 1) ..) of taps(y) . K: a step's
// TERMS products, each an m16n8k16 bf16 mma, smallest term first, go into a
// zeroed float32 fragment that is then added to acc in float32 (see the
// file's head). One pass a window the rows touch, an m16 tile at a time; the
// pass writes that window's rows (those before T: T is a multiple of the
// hop).
template <int R, int MT, int NG>
__device__ __forceinline__ void mma_product(const LayerT<bf16>& a, int b, int t0, const Tiles& tl,
                                            int r0, int j0) {
  constexpr int NN = 2 * NG, TS = (R + 2) * C;
  const int T = a.T, h = a.dil + 1, lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int first = t0 + r0;
  if (first >= T) return;
  const int last = min(first + 16 * MT, T) - 1, l0 = t0 / a.hop;
  int ncol[NN];
#pragma unroll
  for (int ni = 0; ni < NN; ++ni) ncol[ni] = (ni < NG ? 0 : C - 8 * NG) + 8 * (j0 + ni);
  for (int l = first / a.hop; l <= last / a.hop; ++l) {
    const float* slot = tl.Kb + (l - l0) * kw_floats<bf16>();
    const bf16* K = reinterpret_cast<const bf16*>(slot);
    const float* bias = slot + kw_floats<bf16>() - CO;
    const int lo = l * a.hop - first, hi = (l + 1) * a.hop - first;  // the window's rows
#pragma unroll 1
    for (int mt = 0; mt < MT; ++mt) {
      if (16 * mt >= hi || 16 * mt + 16 <= lo) continue;  // no row in this window
      float acc[NN][4];
#pragma unroll
      for (int ni = 0; ni < NN; ++ni) {
        const float2 bv = *reinterpret_cast<const float2*>(bias + ncol[ni] + 2 * q4);
        acc[ni][0] = acc[ni][2] = bv.x;
        acc[ni][1] = acc[ni][3] = bv.y;
      }
#pragma unroll 2
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t bfr[NN][2];
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t r[4];
          mma::ldsm_x4_trans(r, K + kw_at(ks * 16 + (lane & 15), ncol[2 * np + (lane >> 4)]));
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
        // A: rows shifted by the tap; ys row j = unit row + q (time - 1 + q)
        const bf16* A = tl.ys + ys_at<R>(r0 + 16 * mt + (lane & 15) + ks / 2,
                                         (ks & 1) * 16 + (lane >> 4) * 8);
        float part[NN][4] = {};
#pragma unroll
        for (int i = TERMS - 1; i >= 0; --i) {
          uint32_t af[4];
          mma::ldsm_x4(af, A + i * TS);
#pragma unroll
          for (int ni = 0; ni < NN; ++ni) mma::mma16816(part[ni], af, bfr[ni][0], bfr[ni][1]);
        }
#pragma unroll
        for (int ni = 0; ni < NN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ni][e] += part[ni][e];
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = 16 * mt + g + 8 * e2;  // of the warp's rows
        if (row < lo || row >= hi || first + row >= T) continue;
        const int ur = r0 + row;  // of the unit's
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int ch = ncol[n] + 2 * q4;
          const float2 xa =
              *reinterpret_cast<const float2*>(tl.xs + xs_at(ur + h, ch >> 2) + (ch & 3));
          const float* gv = acc[n] + 2 * e2;
          const float* fv = acc[NG + n] + 2 * e2;
          *reinterpret_cast<float2*>(a.out + ((size_t)b * T + first + row) * C + ch) =
              make_float2(gated(xa.x, gv[0], fv[0]), gated(xa.y, gv[1], fv[1]));
        }
      }
    }
  }
}

// Unit (b, t0) of layer a; STREAM: the streaming plan (R = 32, the window
// kernels loaded into registers while the conv runs), else the tiled plan,
// whose window copies are in flight when `kernels_issued`, else started here;
// SPLIT (tiled, hop = 4 mod 8): a tile's last 4 rows read the window of its
// row 4 and are not written past T. The bf16 build (MMA<W>) stages the
// windows in both plans (as the tiled plan) and runs mma_product, which
// needs no SPLIT.
// Starts with a barrier (the block's previous unit is done with the tiles);
// the conv weight of this layer is staged before the call. The block's next
// unit of the layer, (nb, nt0) unless nb < 0, is prefetched into L2 as the
// window product starts.
template <int R, int M, int CM, int CN, bool STREAM = false, bool SPLIT = false, class W>
__device__ __forceinline__ void run_unit(const LayerT<W>& a, int b, int t0, const Tiles& tl,
                                         int tid, bool kernels_issued, int nb, int nt0) {
  static_assert(R == (NT / (C / CN)) * CM, "the conv is one pass of the block");
  static_assert(STREAM ? R == 8 * (NT / 64) : R == 32 * M && M % 4 == 0,
                "streaming: a warp pair a row group of 8; tiled: 32 row groups of M rows");
  static_assert(!SPLIT || (!STREAM && M == 8 && !MMA<W>),
                "SPLIT: the float build's tiled 8-row tiles in halves of 4");
  const int T = a.T, d = a.dil, h = d + 1;
  const size_t off = (size_t)b * T * C;
  constexpr bool STAGED = !STREAM || MMA<W>;  // the unit's windows in shared memory
  std::conditional_t<STREAM, StreamKernel, char> sk;  // the tiled plan holds none (bf16: unused)
  __syncthreads();
  if constexpr (!STREAM)
    if (!kernels_issued) issue_kernels<R>(a, b, t0, tl, tid);

  // 2. xs rows i = time t0 - h + i, XS_BATCH float4s of x and of audio_down
  // a thread in flight before they are stored
  constexpr int XS_BATCH = 4;
  const int nx4 = (R + 2 * h) * (C / 4);
  for (int i0 = tid; i0 < nx4; i0 += XS_BATCH * NT) {
    float4 vx[XS_BATCH], va[XS_BATCH];
#pragma unroll
    for (int k = 0; k < XS_BATCH; ++k) {
      const int i = i0 + k * NT, t = t0 - h + (i >> 3);
      vx[k] = va[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nx4 && t >= 0 && t < T) {
        const size_t g = off + (size_t)t * C + 4 * (i & 7);
        vx[k] = tile::ld4_l2(a.x + g);
        va[k] = __ldg(reinterpret_cast<const float4*>(a.ad + g));
      }
    }
    // the bf16 32-row plan's window copies, right behind its first x loads
    // (issued before them, their 49 KB would queue ahead of the x the conv
    // waits for)
    if constexpr (STREAM && MMA<W>)
      if (i0 == tid) issue_kernels<R>(a, b, t0, tl, tid);
#pragma unroll
    for (int k = 0; k < XS_BATCH; ++k) {
      const int i = i0 + k * NT;
      if (i < nx4) tile::st4(tl.xs + xs_at(i >> 3, i & 7), tile::add4(vx[k], va[k]));
    }
  }
  __syncthreads();
  // streaming: the window kernels' loads, in flight while the conv runs (a
  // barrier waits for a thread's outstanding loads, so they are issued
  // after the one above)
  if constexpr (!STAGED && RUN_WINDOWS) load_stream_kernel(a, b, t0, tid, sk);

  // 3. conv rows j = 1 .. R (times t0 .. t0 + R - 1); tap q of row j reads xs
  // row j + q * d.
  // A warp shares its CN columns (the weight loads are broadcasts); its
  // lanes take rows 4 apart within a quarter-warp (conflict-free under the
  // xs swizzle): CM consecutive rows a lane, or at CM = 1 the lane order
  // 0, 4, .., 28, 1, 5, ...
  constexpr int NRG = NT / (C / CN);  // row groups
  static_assert(CM > 1 ? CM == 4 : NRG == 32, "conv lane layouts");
  const float* Wt = tl.Ws;
  const float* cbs = tl.Ws + 3 * C * C;
  const int LDY = R + 8;
  if constexpr (RUN_CONV) {
    const int crg = tid % NRG, co0 = tid / NRG * CN;
    const int j0 = 1 + (CM == 1 ? (crg & 7) * 4 + (crg >> 3) : crg * CM);
    float acc[CM][CN];
#pragma unroll
    for (int m = 0; m < CM; ++m)
#pragma unroll
      for (int n = 0; n < CN; ++n) acc[m][n] = cbs[co0 + n];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        float xv[CM][4];
#pragma unroll
        for (int m = 0; m < CM; ++m) {
          const float4 v = leaky4(tile::ld4(tl.xs + xs_at(j0 + m + q * d, c4)));
          xv[m][0] = v.x; xv[m][1] = v.y; xv[m][2] = v.z; xv[m][3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* wr = Wt + (q * C + 4 * c4 + i) * C + co0;
          float wv[CN];
#pragma unroll
          for (int n = 0; n < CN; n += 4) {
            const float4 w = tile::ld4(wr + n);
            wv[n] = w.x; wv[n + 1] = w.y; wv[n + 2] = w.z; wv[n + 3] = w.w;
          }
#pragma unroll
          for (int m = 0; m < CM; ++m)
#pragma unroll
            for (int n = 0; n < CN; ++n) acc[m][n] = fmaf(xv[m][i], wv[n], acc[m][n]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < CM; ++m)
#pragma unroll
      for (int n = 0; n < CN; ++n) acc[m][n] = t0 + j0 - 1 + m < T ? leaky(acc[m][n]) : 0.f;
    if constexpr (MMA<W>) {
#pragma unroll
      for (int m = 0; m < CM; ++m) store_terms<CN, R>(tl.ys, j0 + m, co0, acc[m]);
    } else {
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        float* yc = tl.yT + (co0 + n) * LDY + 3 + j0;  // 16-byte aligned where CM = 4
        if constexpr (CM == 4) {
          tile::st4(yc, make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]));
        } else {
#pragma unroll
          for (int m = 0; m < CM; ++m) yc[m] = acc[m][n];
        }
      }
    }
  }
  if constexpr (RUN_CONV) {  // the edge rows j = 0 (time t0 - 1) and j = R + 1
     // (time t0 + R): thread (edge, channel o, quarter p) sums 8 input
     // channels, 4 lanes reduce
    const int e = tid >> 7, o = (tid >> 2) & 31, p = tid & 3;
    const int j = e ? R + 1 : 0, t = t0 - 1 + j;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 v = leaky4(tile::ld4(tl.xs + xs_at(j + q * d, 2 * p + k)));
        const float* wr = Wt + (q * C + 8 * p + 4 * k) * C + o;
        sum = fmaf(v.x, wr[0], sum);
        sum = fmaf(v.y, wr[C], sum);
        sum = fmaf(v.z, wr[2 * C], sum);
        sum = fmaf(v.w, wr[3 * C], sum);
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if constexpr (MMA<W>) {
      if (p == 0) {
        uint32_t terms[TERMS];
        split_pair((t >= 0 && t < T) ? leaky(sum + cbs[o]) : 0.f, 0.f, terms);
#pragma unroll
        for (int i = 0; i < TERMS; ++i)
          tl.ys[i * (R + 2) * C + ys_at<R>(j, o)] = __ushort_as_bfloat16((unsigned short)terms[i]);
      }
    } else {
      if (p == 0) tl.yT[o * LDY + 3 + j] = (t >= 0 && t < T) ? leaky(sum + cbs[o]) : 0.f;
    }
  }
  if constexpr (STAGED) tile::cp_async_wait_all();
  __syncthreads();

  // 4. window product + gate + residual
  if (tid == 0 && nb >= 0) prefetch_unit<R>(a, nb, nt0);
  if constexpr (MMA<W>) {
    const int w = tid >> 5;
    if constexpr (!RUN_WINDOWS) {  // the output is xa
      for (int i = tid; i < R * (C / 4); i += NT) {
        const int row = i >> 3, c4 = i & 7;
        if (t0 + row < T)
          tile::st4(a.out + off + (size_t)(t0 + row) * C + 4 * c4,
                    tile::ld4(tl.xs + xs_at(row + h, c4)));
      }
    } else if constexpr (STREAM) {  // 2 m16 tiles x 4 channel groups
      mma_product<R, 1, 1>(a, b, t0, tl, 16 * (w & 1), w >> 1);
    } else {  // 16 m16 tiles, two a warp, all 64 outputs
      mma_product<R, 2, 4>(a, b, t0, tl, 32 * w, 0);
    }
    return;
  }
  if constexpr (STREAM) {
    if constexpr (RUN_WINDOWS) {
      stream_product<R>(a, b, t0, tl, tid, sk);
    } else if (t0 + 8 * (tid >> 6) < T) {  // the output is xa
      const int row = 8 * (tid >> 6) + (tid & 7), c4 = (tid >> 3) & 7;
      tile::st4(a.out + off + (size_t)(t0 + row) * C + 4 * c4, tile::ld4(tl.xs + xs_at(row + h, c4)));
    }
    return;
  }
  // tiled: rows r0 .. r0 + M - 1, output pairs (4pg + p, 32 + 4pg + p)
  const int rg = tid >> 3, pg = tid & 7, r0 = rg * M;
  if (t0 + r0 >= T) return;  // past the sequence end (a whole row group: 8 | hop; SPLIT: 4 | T)
  constexpr int KWF = kw_floats<W>();
  const int w = (t0 + r0) / a.hop - t0 / a.hop;
  const float* Ks = tl.Kb + w * KWF;  // the window's slot: kernel, then bias at KWF - CO
  // SPLIT: rows M/2 .. M - 1 read K2, the window of row M/2 (K where that row
  // is past T: those rows are not written)
  const float* Ks2 = Ks;
  if constexpr (SPLIT) Ks2 = tl.Kb + (min(t0 + r0 + M / 2, T - 1) / a.hop - t0 / a.hop) * KWF;
  const W* K = reinterpret_cast<const W*>(Ks);
  const W* K2 = reinterpret_cast<const W*>(Ks2);
  float ag[M][4], af[M][4];
  {
    const float4 bg = tile::ld4(Ks + KWF - CO + 4 * pg), bf = tile::ld4(Ks + KWF - CO + C + 4 * pg);
    float4 bg2 = bg, bf2 = bf;
    if constexpr (SPLIT) {
      bg2 = tile::ld4(Ks2 + KWF - CO + 4 * pg);
      bf2 = tile::ld4(Ks2 + KWF - CO + C + 4 * pg);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 g = m < M / 2 ? bg : bg2, f = m < M / 2 ? bf : bf2;
      ag[m][0] = g.x; ag[m][1] = g.y; ag[m][2] = g.z; ag[m][3] = g.w;
      af[m][0] = f.x; af[m][1] = f.y; af[m][2] = f.z; af[m][3] = f.w;
    }
  }
#pragma unroll 2
  for (int c = 0; c < (RUN_WINDOWS ? C : 0); ++c) {
    const float* yr = tl.yT + c * LDY + r0 + 3;  // time t0 + r0 - 1
    float v[M + 2];
    v[0] = yr[0];
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const float4 u = tile::ld4(yr + 1 + m);
      v[m + 1] = u.x; v[m + 2] = u.y; v[m + 3] = u.z; v[m + 4] = u.w;
    }
    v[M + 1] = yr[M + 1];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const W* kr = K + (q * C + c) * CO + 4 * pg;
      const float4 kg1 = ld4w(kr), kf1 = ld4w(kr + C);
      float4 kg2 = kg1, kf2 = kf1;
      if constexpr (SPLIT) {
        const W* kr2 = K2 + (q * C + c) * CO + 4 * pg;
        kg2 = ld4w(kr2);
        kf2 = ld4w(kr2 + C);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float y = v[m + q];
        const float4 kg = m < M / 2 ? kg1 : kg2, kf = m < M / 2 ? kf1 : kf2;
        ag[m][0] = fmaf(y, kg.x, ag[m][0]);
        ag[m][1] = fmaf(y, kg.y, ag[m][1]);
        ag[m][2] = fmaf(y, kg.z, ag[m][2]);
        ag[m][3] = fmaf(y, kg.w, ag[m][3]);
        af[m][0] = fmaf(y, kf.x, af[m][0]);
        af[m][1] = fmaf(y, kf.y, af[m][1]);
        af[m][2] = fmaf(y, kf.z, af[m][2]);
        af[m][3] = fmaf(y, kf.w, af[m][3]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (SPLIT && t0 + r0 + m >= T) break;
    const float4 xa = tile::ld4(tl.xs + xs_at(r0 + m + h, pg));
    const float o[4] = {gated(xa.x, ag[m][0], af[m][0]), gated(xa.y, ag[m][1], af[m][1]),
                        gated(xa.z, ag[m][2], af[m][2]), gated(xa.w, ag[m][3], af[m][3])};
    tile::st4(a.out + off + (size_t)(t0 + r0 + m) * C + 4 * pg, make_float4(o[0], o[1], o[2], o[3]));
  }
}

// Blocks of `kernel` (`threads` threads, `smem` bytes) that fit on one SM of
// the current device, its shared-memory attribute raised as needed. Cached
// per device, kernel (`variant` < VARIANTS, one per kernel of a library) and
// size; static, so that two loaded libraries never share the cache.
constexpr int VARIANTS = 8;

template <class K>
static cudaError_t blocks_per_sm(K kernel, int variant, int smem, int* per_sm,
                                 int threads = NT) {
  constexpr int MAX_DEVICES = 64, SIZES = 16;
  static int attr[MAX_DEVICES][VARIANTS] = {};
  static int key[MAX_DEVICES][VARIANTS][SIZES] = {}, val[MAX_DEVICES][VARIANTS][SIZES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || variant < 0 || variant >= VARIANTS) return cudaErrorInvalidValue;
  int* keys = key[dev][variant];
  for (int i = 0; i < SIZES; ++i)
    if (keys[i] == smem) {
      *per_sm = val[dev][variant][i];
      return cudaSuccess;
    }
  if (smem > attr[dev][variant]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr[dev][variant] = smem;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < SIZES; ++i)
    if (keys[i] == 0) {
      keys[i] = smem;
      val[dev][variant][i] = *per_sm;
      break;
    }
  return cudaSuccess;
}

static inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The plans' template arguments: <R, M, CM, CN, STREAM>.
#define LVCT_TILED 256, 8, 4, 8, false
#define LVCT_STREAM 32, 8, 1, 4, true

}  // namespace lvct
