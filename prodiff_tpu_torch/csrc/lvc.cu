// FastDiff's location-variable convolution (LVC) alone, for Hopper.
//
// Replaces the Pallas TPU kernel _lvc_single / lvc_pallas
// (prodiff_tpu/ops/pallas/lvc.py:28, :87). On x [B, T, 32] with per-window
// kernels [KC = 96, CO = 64] and biases [64], for every hop window l:
//   y[t, :] = bias[l] + sum_{d<3, c<32} x[t - 1 + d, c] * K[l][d*32 + c, :]
// with x zero outside [0, T); taps at a window edge read the neighbouring
// window's row. The kernels are read in place from the hoisted
// KernelPredictor stack [N, B, L, layers*96, 64] at (step, layer). Every hop
// that lvc_pallas takes (a multiple of 8) and any L >= 1.
//
// What bounds it on the H100 depends on the hop. Per row 12,288 FLOP
// against 384 bytes of x and y, plus 24.8 KB of kernel and bias a window.
// The LJSpeech net at T_mel = 512: block 0 (hop 8, T = 4,096) moves 14 MB
// for 50 MFLOP (bound by bytes, 4.3 us at 3.35 TB/s), block 1 (hop 64) 25
// MB for 0.40 GFLOP (bytes, 7.5 us), block 2 (hop 256) 63 MB for 1.61 GFLOP
// (operations, 24 us at the 67 TFLOP/s FP32 peak). Parity mode keeps the
// tensor cores out (float32 operands, TF32 off).
//
// Design: the TPU kernel builds each window's [hop, 3C] tap matrix in VMEM
// and streams the window kernels from HBM grid step by grid step. Here a
// persistent grid (the co-resident blocks, from the occupancy API) walks
// work units in a fixed order, by one of two plans (ops/lvc.py:lvc_plan
// mirrors plan_for):
//   - streaming, hop < 64 (bound by the window kernels' bytes): a unit is
//     one warp's 8 rows of one window (8 | hop) x 32 of the 64 outputs. Its
//     lanes first issue their 12 KB share of the window's kernel, 24 + 1
//     128-bit non-coherent loads a lane straight into registers, then stage
//     the 10 x rows the taps read (warp-private shared memory, k-major, zero
//     outside [0, T)); a lane (channel quarter kq, column quad og) sums its
//     quarter for the 8 rows (4 shared loads per 96 FMAs), the quarters
//     meet by 24 shuffles, and each lane writes 2 rows' float4. The load
//     and the quarter product are K4's (lvc_tiles.cuh: load_stream_share,
//     stream_quarters). No block barrier: eight warps an SM keep 98 KB of
//     kernel in flight.
//   - pipelined, hop >= 64 (blocks 1 and 2): a unit is up to 128 rows of one
//     window (hop 64 and 72: a window; 200: 104 + 96 rows; 256: half of
//     one). A block is one producer warp and 256 consumer threads in
//     G = 256 / rows groups; a ring of S stages in shared memory (S a
//     multiple of G), each holding a unit's window kernel, bias and rows + 2
//     halo rows of x. The producer's lane 0 fills the stages of the units
//     after the ones being computed: three TMA 1-D bulk copies
//     (cp.async.bulk) a unit, completing on the stage's full mbarrier; the
//     consumers release a stage on its empty mbarrier. Group g takes units
//     g, g + G, ... A consumer thread holds 8 rows x 8 outputs (gate 4pg ..
//     4pg+3 and filter 32 + 4pg ..), starts from the bias and, per 4
//     channels, loads its 10 x rows as float4s once for all three taps and
//     24 float4s of kernel: 34 shared loads per 768 FMAs. The halo rows at
//     the sequence ends are zeroed in registers (TMA writes no zeros);
//     outputs go straight to global memory as float4s after the stage is
//     released, so the stores retire behind the next unit's product.
//     Why TMA and not cp.async: one thread issues a unit's 41 KB in three
//     instructions and no consumer spends registers or issue slots on it.
//     Why 128 rows and not a whole window at hop 256: two groups compute at
//     once, and the first fill and the last unit's stores are half as long
//     (measured: PERF.md §6).
//
// LVC_SKIP (0 in the kernel the port runs) builds variants that leave a
// phase out, for measuring where the time goes (chip_smoke.py): bit 0 the
// window product (the output is the bias; streaming, with the window
// kernels' loads), bit 1 the stores (kept behind a test the compiler
// cannot decide, so the product stays), bit 2 the pipelined plan's staging
// (no copy and no wait: the product runs on whatever the ring holds).
// Their outputs are for measurement only.

#include <cstdint>

#include "lvc_tiles.cuh"

#ifndef LVC_SKIP
#define LVC_SKIP 0
#endif

using lvcw::C;
using lvcw::CO;
using lvcw::KC;
using lvcw::MAX_SMEM;
using lvcw::NT;
using lvcw::Stack;

namespace {

constexpr bool RUN_PRODUCT = !(LVC_SKIP & 1), RUN_STORES = !(LVC_SKIP & 2),
               RUN_STAGING = !(LVC_SKIP & 4);
constexpr int STREAM_MAX_HOP = 64;  // hop < 64 streams
constexpr int WARPS = NT / 32;      // streaming warps; pipelined consumer warps
constexpr int XLD = 20;             // streaming: a warp's x tile [C][XLD], col 3 + j
constexpr int UNIT_MAX = 128;       // pipelined: rows a unit at most, one consumer thread a row
constexpr int PIPE_THREADS = NT + 32;
constexpr int KBYTES = KC * CO * 4, BBYTES = CO * 4;
constexpr int MAX_STAGES = 8;

struct Plan {
  int rows, pieces, groups, stages, smem;
};

__host__ __device__ inline int stage_bytes(int rows) { return KBYTES + BBYTES + (rows + 2) * C * 4; }

// The work unit at `hop`: streaming, a warp's 8 rows (pieces: the 8-row
// slices of a window); pipelined, `rows` rows of one window (the last of its
// `pieces` may be short), `groups` units at once, `stages` ring stages.
__host__ inline Plan plan_for(int hop) {
  if (hop < STREAM_MAX_HOP) return Plan{8, hop / 8, WARPS, 0, WARPS * C * XLD * 4};
  Plan p{};
  const int share = (hop + UNIT_MAX - 1) / UNIT_MAX;
  p.rows = ((hop + share - 1) / share + 7) / 8 * 8;
  p.pieces = (hop + p.rows - 1) / p.rows;
  p.groups = NT / p.rows;
  const int per = stage_bytes(p.rows) + 16;  // a stage and its two mbarriers
  const int fit = MAX_SMEM / per < MAX_STAGES ? MAX_SMEM / per : MAX_STAGES;
  p.stages = fit / p.groups * p.groups;
  p.smem = p.stages * per;
  return p;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LVC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LVC_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the TMA, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// hop < 64: every warp walks units (b, 8-row slice, output half oh).
__global__ void __launch_bounds__(NT, 1)
lvc_stream_kernel(const float* __restrict__ x, Stack s, float* __restrict__ y, int T, int hop) {
  extern __shared__ float4 smem4[];  // WARPS tiles [C][XLD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xw = reinterpret_cast<float*>(smem4) + warp * C * XLD;
  const int kq = lane >> 3, og = lane & 7;
  const int slices = T / 8, units = s.B * slices * 2;
  for (int u = blockIdx.x * WARPS + warp; u < units; u += gridDim.x * WARPS) {
    const int oh = u & 1, bs = u >> 1, b = bs / slices, t = bs % slices * 8;
    const int l = t / hop, col = 32 * oh + 4 * og;
    // 1. the lane's share of window l's kernel (column quad col)
    lvct::StreamKernel sk;
    lvct::load_stream_share(s.kernel(b, l), s.bias(b, l), kq, col, sk);

    // 2. x rows t - 1 .. t + 8, k-major: xw[c * XLD + 3 + j] = x[t - 1 + j][c]
    __syncwarp();  // the warp's previous unit has read xw
    const float* xb = x + (size_t)b * T * C;
    float4 v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = lane + 32 * r, tt = t - 1 + (i >> 3);
      v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < 80 && tt >= 0 && tt < T)
        v[r] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)tt * C + 4 * (i & 7)));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = lane + 32 * r, j = i >> 3, c = 4 * (i & 7);
      if (i < 80) {
        xw[c * XLD + 3 + j] = v[r].x;
        xw[(c + 1) * XLD + 3 + j] = v[r].y;
        xw[(c + 2) * XLD + 3 + j] = v[r].z;
        xw[(c + 3) * XLD + 3 + j] = v[r].w;
      }
    }
    __syncwarp();

    // 3. the lane's channel quarter for the 8 rows; the quarters meet, and
    // the lane keeps rows 2kq, 2kq + 1
    float r2[2][4];
    lvct::stream_quarters<RUN_PRODUCT>(xw + 3, XLD, kq, sk, r2);
    if (RUN_STORES || T == -1) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
        tile::st4(y + ((size_t)b * T + t + 2 * kq + m) * CO + col,
                  make_float4(r2[m][0], r2[m][1], r2[m][2], r2[m][3]));
    }
  }
}

// hop >= 64: the producer warp (threads NT .. NT + 31) and p.groups consumer
// groups of p.rows threads.
__global__ void __launch_bounds__(PIPE_THREADS, 1)
lvc_pipe_kernel(const float* __restrict__ x, Stack s, float* __restrict__ y, int T, int hop,
                Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int per = stage_bytes(p.rows), tid = threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)p.stages * per);
  uint64_t* empty = full + p.stages;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, p.rows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_b = s.L * p.pieces, units = s.B * per_b;

  if (tid >= NT) {  // the producer: lane 0 fills the stages, unit after unit
    if (tid != NT || !RUN_STAGING) return;
    for (int k = 0;; ++k) {
      const int u = blockIdx.x + k * gridDim.x;
      if (u >= units) break;
      const int st = k % p.stages, b = u / per_b, l = u % per_b / p.pieces;
      const int t0 = l * hop + u % p.pieces * p.rows, rows = min(p.rows, (l + 1) * hop - t0);
      const int lo = max(t0 - 1, 0), hi = min(t0 + rows + 1, T);
      unsigned char* stage = smem + (size_t)st * per;
      mbar_wait(empty + st, ((k / p.stages) & 1) ^ 1);  // the stage's last unit is done
      mbar_expect_tx(full + st, KBYTES + BBYTES + (hi - lo) * C * 4);
      bulk_load(stage, s.kernel(b, l), KBYTES, full + st);
      bulk_load(stage + KBYTES, s.bias(b, l), BBYTES, full + st);
      // stage row i = time t0 - 1 + i
      bulk_load(stage + KBYTES + BBYTES + (lo - t0 + 1) * C * 4, x + ((size_t)b * T + lo) * C,
                (hi - lo) * C * 4, full + st);
    }
    return;
  }

  if (tid >= p.groups * p.rows) return;  // no group (p.rows does not divide NT)
  const int g = tid / p.rows, lt = tid % p.rows, r0 = lt >> 3 << 3, pg = lt & 7;
  for (int k = g;; k += p.groups) {
    const int u = blockIdx.x + k * gridDim.x;
    if (u >= units) break;
    const int st = k % p.stages, b = u / per_b, l = u % per_b / p.pieces;
    const int t0 = l * hop + u % p.pieces * p.rows, rows = min(p.rows, (l + 1) * hop - t0);
    // every thread of the group waits, active or not: the group's next wait
    // on this stage relies on it (S is a multiple of G)
    if (RUN_STAGING) mbar_wait(full + st, (k / p.stages) & 1);
    const float* K = reinterpret_cast<const float*>(smem + (size_t)st * per);
    const float* xs = K + KC * CO + CO;  // row i = time t0 - 1 + i
    const bool active = r0 < rows;       // a short last unit (8 | rows)
    float ag[8][4], af[8][4];
    if (active) {
      const float4 bg = tile::ld4(K + KC * CO + 4 * pg), bf = tile::ld4(K + KC * CO + C + 4 * pg);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        ag[m][0] = bg.x; ag[m][1] = bg.y; ag[m][2] = bg.z; ag[m][3] = bg.w;
        af[m][0] = bf.x; af[m][1] = bf.y; af[m][2] = bf.z; af[m][3] = bf.w;
      }
      // the halo rows at the sequence ends are zero (not copied)
      const bool zlo = t0 == 0 && r0 == 0, zhi = t0 + rows == T && r0 + 8 == rows;
#pragma unroll 1
      for (int c4 = 0; c4 < (RUN_PRODUCT ? C / 4 : 0); ++c4) {
        const float* xr = xs + r0 * C + 4 * c4;  // time t0 + r0 - 1
        float4 xv[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xv[j] = tile::ld4(xr + j * C);
        if (zlo) xv[0] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (zhi) xv[9] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float* kr = K + (q * C + 4 * c4 + i) * CO + 4 * pg;
            const float4 kg = tile::ld4(kr), kf = tile::ld4(kr + C);
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const float a = at(xv[m + q], i);
              ag[m][0] = fmaf(a, kg.x, ag[m][0]);
              ag[m][1] = fmaf(a, kg.y, ag[m][1]);
              ag[m][2] = fmaf(a, kg.z, ag[m][2]);
              ag[m][3] = fmaf(a, kg.w, ag[m][3]);
              af[m][0] = fmaf(a, kf.x, af[m][0]);
              af[m][1] = fmaf(a, kf.y, af[m][1]);
              af[m][2] = fmaf(a, kf.z, af[m][2]);
              af[m][3] = fmaf(a, kf.w, af[m][3]);
            }
          }
      }
    }
    if (RUN_STAGING) mbar_arrive(empty + st);  // the stage is free; the stores retire behind
    if (active && (RUN_STORES || T == -1)) {
      float* yr = y + ((size_t)b * T + t0 + r0) * CO + 4 * pg;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        tile::st4(yr + m * CO, make_float4(ag[m][0], ag[m][1], ag[m][2], ag[m][3]));
        tile::st4(yr + m * CO + C, make_float4(af[m][0], af[m][1], af[m][2], af[m][3]));
      }
    }
  }
}

// Blocks of the persistent grid for (B, T, hop), or an error.
int lvc_grid_of(int B, int T, int hop, int* grid) {
  const Plan p = plan_for(hop);
  int per_sm = 0, sms = 0;
  cudaError_t e =
      hop < STREAM_MAX_HOP
          ? lvct::blocks_per_sm(lvc_stream_kernel, 0, p.smem, &per_sm)
          : lvct::blocks_per_sm(lvc_pipe_kernel, 1, p.smem, &per_sm, PIPE_THREADS);
  if (e == cudaSuccess) e = lvct::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // blocks with work: a streaming block takes WARPS units at once
  const long long units = hop < STREAM_MAX_HOP ? ((long long)B * (T / 8) * 2 + WARPS - 1) / WARPS
                                               : (long long)B * (T / hop) * p.pieces;
  const long long slots = (long long)per_sm * sms;
  *grid = (int)(units < slots ? units : slots);
  return *grid < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

// The plan at `hop` (ops/lvc.py:lvc_plan): out[0..4] = unit rows, pieces a
// window, groups, stages, shared-memory bytes a block. Returns 0, or
// cudaErrorInvalidValue for a hop the kernel does not take.
extern "C" int lvc_plan(int hop, int* out) {
  if (!lvcw::hop_supported(hop)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(hop);
  out[0] = p.rows;
  out[1] = p.pieces;
  out[2] = p.groups;
  out[3] = p.stages;
  out[4] = p.smem;
  return 0;
}

// Blocks of the persistent grid for (B, T, hop) on the current device, or -1.
extern "C" int lvc_grid(int B, int T, int hop) {
  int grid = 0;
  return lvcw::hop_supported(hop) && lvc_grid_of(B, T, hop, &grid) == 0 ? grid : -1;
}

// x [B, T, 32]; km [N, B, L, layers*96, 64], lb [N, B, L, layers*64] (a plain
// per-layer kmat [B, L, 96, 64] is N = layers = 1); y [B, T, 64] out. Reads
// step `step`, layer `layer`. One launch on `stream`; returns the launch
// error (cudaError_t) or 0.
extern "C" int lvc_forward(const float* x, const float* km, const float* lb, float* y, int B,
                           int T, int L, int hop, int layers, int step, int layer,
                           void* stream_ptr) {
  if (B < 1 || L < 1 || !lvcw::hop_supported(hop) || T != L * hop || layers < 1 || step < 0 ||
      layer < 0 || layer >= layers)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(hop);
  if (p.smem > MAX_SMEM || (hop >= STREAM_MAX_HOP && (p.stages < p.groups || p.stages % p.groups)))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int e = lvc_grid_of(B, T, hop, &grid);
  if (e != 0) return e;
  const Stack s{km, lb, B, L, layers, step, layer};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (hop < STREAM_MAX_HOP)
    lvc_stream_kernel<<<grid, NT, p.smem, stream>>>(x, s, y, T, hop);
  else
    lvc_pipe_kernel<<<grid, PIPE_THREADS, p.smem, stream>>>(x, s, y, T, hop, p);
  return (int)cudaGetLastError();
}
