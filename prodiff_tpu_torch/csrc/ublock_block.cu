// One whole FastDiff LVC block (all its layers) in one launch, for Hopper.
//
// Replaces the Pallas TPU kernel ublock_block_packed
// (prodiff_tpu/ops/pallas/ublock.py:583). On x, audio_down [B, T, 32], the
// block is out = layer_{n-1}( ... layer_0(x)), each layer being ublock.cu's
// (K4's) function with conv dilation d_i and layer i's window kernels read in
// place from the hoisted KernelPredictor stack [N, B, L, layers*96, 64] at
// (step, i).
//
// What bounds it on the H100: float32 FMA throughput, as for K4 at hop >= 64.
// The LJSpeech net at T_mel = 512: block 1 (hop 64, T = 32,768) 2.42 GFLOP =
// 36 us at the 67 TFLOP/s FP32 peak; block 2 (hop 256, T = 131,072) 9.66
// GFLOP = 144 us.
//
// Design: one cooperative launch over the block's layers. Each layer is K4's
// tiled pass (lvc_tiles.cuh: a persistent grid walks 256-row units, 8 x 8
// register tiles); between layers a grid barrier (cooperative_groups
// grid.sync(), as K1's chain in wavenet_stack.cu). Nothing is recomputed:
// layer i + 1 reads layer i's rows, its neighbours' included, after the
// barrier, through L2 (block 1's activations are 4.2 MB, block 2's 16.8 MB,
// in the 50 MB L2). Layers ping-pong between `out` and one scratch tensor so
// that the last writes `out` (ops/ublock.py:pingpong). Before each barrier a block stages the next
// layer's conv weight and starts the cp.async of its first unit's window
// kernels, which depend on nothing the layer writes: the barrier hides the
// staging that a chain of K4 launches pays at every launch. The grid is the
// co-resident block count (occupancy API), so a refused launch is an error
// the caller sees, never a fallback.
//
// The bf16 build (ublock_block_forward_bf16; W = bf16, K7-bf16) takes the
// bf16 window kernels of the JAX package's accelerator route and computes
// ublock_block_packed's function with them (each value widened exactly, the
// product in float32: ublock.py:772); through run_unit its window product
// runs on the tensor cores, as K4-bf16's (ublock.cu), and its first layer's
// first unit's windows are copied from the start.

#include <cooperative_groups.h>

#include "lvc_tiles.cuh"

namespace cg = cooperative_groups;
using namespace lvct;

namespace {

constexpr int MAX_LAYERS = 8;  // ops/ublock.py:MONO_MAX_LAYERS

// The block's operands, in the kernel's parameter space (read through the
// constant cache, so they hold no registers across the layer loop).
template <class W>
struct BlockArgs {
  LayerT<W> layer[MAX_LAYERS];
  int B, n, dmax;
};

template <class W, int MINB>
__global__ void __launch_bounds__(NT, MINB)
ublock_block_kernel(const __grid_constant__ BlockArgs<W> p) {
  extern __shared__ float4 smem4[];
  const Tiles tl = carve<false, W>(reinterpret_cast<float*>(smem4), p.layer[0].hop, p.dmax);
  cg::grid_group grid = cg::this_grid();
  constexpr int R = 256;
  const int tid = threadIdx.x, per_b = (p.layer[0].T + R - 1) / R, units = p.B * per_b;
  if constexpr (MMA<W>)
    issue_kernels<R>(p.layer[0], blockIdx.x / per_b, blockIdx.x % per_b * R, tl, tid);
  stage_conv(p.layer[0], tl, tid);
  for (int i = 0; i < p.n; ++i) {
    const LayerT<W>& a = p.layer[i];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n = u + gridDim.x < units ? u + gridDim.x : -1;
      // layer i > 0 (bf16: every layer): its first unit's kernels were issued
      // before the barrier (before the conv weight)
      run_unit<LVCT_TILED>(a, u / per_b, u % per_b * R, tl, tid,
                           (MMA<W> || i > 0) && u == (int)blockIdx.x, n < 0 ? -1 : n / per_b,
                           n % per_b * R);
    }
    if (i + 1 < p.n) {
      __syncthreads();  // the tiles are free
      stage_conv(p.layer[i + 1], tl, tid);
      issue_kernels<R>(p.layer[i + 1], blockIdx.x / per_b, blockIdx.x % per_b * R, tl, tid);
      grid.sync();
    }
  }
}

// Co-resident blocks of the kernel on the current device at (hop, dmax).
template <class W>
cudaError_t block_slots(int hop, int dmax, int* slots) {
  int per_sm = 0, sms = 0;
  const int smem = smem_floats<W>(hop, dmax) * (int)sizeof(float);
  const int v = sizeof(W) == 2 ? 2 : 0;  // the bf16 kernels' cache slots
  cudaError_t e = two_per_sm<W>(hop, dmax)
                      ? blocks_per_sm(ublock_block_kernel<W, 2>, v, smem, &per_sm)
                      : blocks_per_sm(ublock_block_kernel<W, 1>, v + 1, smem, &per_sm);
  if (e == cudaSuccess) e = sm_count(&sms);
  *slots = per_sm * sms;
  return e;
}

template <class W>
int block_forward(const float* const* src, float* const* dst, const float* ad, const float* cw,
                  const float* cb, const W* km, const float* lb, const int* dil, int n, int B,
                  int T, int L, int hop, int layers, int step, cudaStream_t stream) {
  if (n < 1 || n > MAX_LAYERS || layers != n || B < 1 || L < 1 || hop < TILED_MIN_HOP ||
      hop % 32 || T != L * hop || step < 0)
    return (int)cudaErrorInvalidValue;
  BlockArgs<W> p{};
  p.B = B;
  p.n = n;
  for (int i = 0; i < n; ++i) {
    if (dil[i] < 1) return (int)cudaErrorInvalidValue;
    p.dmax = dil[i] > p.dmax ? dil[i] : p.dmax;
    if ((const float*)dst[i] == src[i] || (i > 0 && src[i] != dst[i - 1]))
      return (int)cudaErrorInvalidValue;
    p.layer[i] = LayerT<W>{src[i], ad, cw + (size_t)i * C * C * 3, cb + i * C,
                           StackT<W>{km, lb, B, L, layers, step, i}, dst[i], T, hop, dil[i]};
  }
  const int smem = smem_floats<W>(hop, p.dmax) * (int)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t e = block_slots<W>(hop, p.dmax, &slots);
  if (e != cudaSuccess) return (int)e;
  const int units = B * ((T + 255) / 256);
  const int grid = units < slots ? units : slots;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  const void* kernel = two_per_sm<W>(hop, p.dmax) ? (const void*)ublock_block_kernel<W, 2>
                                                  : (const void*)ublock_block_kernel<W, 1>;
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, smem, stream);
}

}  // namespace

// Shared-memory bytes of one block of the kernel at (hop, the largest
// dilation), float32 windows (_bf16: bf16 windows).
extern "C" int ublock_block_smem(int hop, int dmax) {
  return smem_floats<float>(hop, dmax) * (int)sizeof(float);
}
extern "C" int ublock_block_smem_bf16(int hop, int dmax) {
  return smem_floats<bf16>(hop, dmax) * (int)sizeof(float);
}

// Blocks of the kernel that can be co-resident on the current device, or -1
// on an error.
extern "C" int ublock_block_slots(int hop, int dmax) {
  int slots = 0;
  return block_slots<float>(hop, dmax, &slots) == cudaSuccess ? slots : -1;
}
extern "C" int ublock_block_slots_bf16(int hop, int dmax) {
  int slots = 0;
  return block_slots<bf16>(hop, dmax, &slots) == cudaSuccess ? slots : -1;
}

// src[i], dst[i] [B, T, 32]: layer i's input and output (layer i + 1 reads
// dst[i]; a layer never writes what it reads; ops/ublock.py:pingpong plans
// them); ad [B, T, 32]; cw [n, 32, 32, 3] (torch Conv1d layout per layer),
// cb [n, 32]; km [N, B, L, n*96, 64] (float32 here, bf16 in
// ublock_block_forward_bf16), lb [N, B, L, n*64]; dil [n]. Runs the n layers
// of the block at stack step `step`. One cooperative launch on `stream`;
// returns the launch error (cudaError_t; a refused cooperative launch
// included) or 0.
extern "C" int ublock_block_forward(const float* const* src, float* const* dst, const float* ad,
                                    const float* cw, const float* cb, const float* km,
                                    const float* lb, const int* dil, int n, int B, int T, int L,
                                    int hop, int layers, int step, void* stream_ptr) {
  return block_forward<float>(src, dst, ad, cw, cb, km, lb, dil, n, B, T, L, hop, layers, step,
                              (cudaStream_t)stream_ptr);
}
extern "C" int ublock_block_forward_bf16(const float* const* src, float* const* dst,
                                         const float* ad, const float* cw, const float* cb,
                                         const void* km, const float* lb, const int* dil, int n,
                                         int B, int T, int L, int hop, int layers, int step,
                                         void* stream_ptr) {
  return block_forward<bf16>(src, dst, ad, cw, cb, static_cast<const bf16*>(km), lb, dil, n, B, T,
                             L, hop, layers, step, (cudaStream_t)stream_ptr);
}
