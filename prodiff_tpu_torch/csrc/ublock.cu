// One FastDiff LVC layer, fused, for Hopper.
//
// Replaces the Pallas TPU kernel ublock_layer_packed
// (prodiff_tpu/ops/pallas/ublock.py:221; body _fused_layer_compute, :51).
// On x, audio_down [B, T, 32], for the layer with conv dilation d = 3^i:
//   xa  = x + audio_down
//   y   = leaky_0.2(conv3_d(leaky_0.2(xa)) + conv_bias)   (SAME zero padding)
//   y   = LVC(y): per hop window l, bias[l] + taps(y) . K[l]  ([hop, 96] x [96, 64])
//   out = xa + sigmoid(y[:, :32]) * tanh(y[:, 32:])
// with the window kernels read in place from the hoisted KernelPredictor
// stack [N, B, L, layers*96, 64] at (step, layer).
//
// What bounds it on the H100 depends on the hop. Per row 18,432 FLOP (conv
// 6,144, LVC 12,288) against 384 bytes of activations, plus 24.6 KB of
// kernel a window. The LJSpeech net at T_mel = 512: block 0 (hop 8, T =
// 4,096) is bound by the kernels' bytes (14.3 MB = 4.3 us at 3.35 TB/s
// against 75 MFLOP), block 1 (hop 64) and block 2 (hop 256, 2.42 GFLOP =
// 36 us at the 67 TFLOP/s FP32 peak) by FMAs. Parity mode keeps the tensor
// cores out.
//
// Design: the TPU kernel runs the layer on a lane-packed [T/4, 128] layout
// with block-diagonal per-window kernels; none of that carries over. Here a
// persistent grid (as many blocks as fit on the card at once, from the
// occupancy API) walks work units of 256 rows (hop >= 64) or 32 rows
// (hop < 64) through lvc_tiles.cuh's run_unit: at hop >= 64 the window
// kernels are copied by cp.async while x + audio_down is staged and the conv
// runs, and the window product runs from 8 x 8 register tiles; below (block
// 0, bound by the kernels' bytes) each warp streams its window's kernel from
// HBM into registers, the loads in flight from the unit's start. At hops
// from 64 that are 4 mod 8 (ublock_layer_packed takes every multiple of 4)
// an 8-row tile may straddle a window edge: the tiled plan's SPLIT build
// reads a second window's kernel for the tile's last 4 rows.
//
// The bf16 build (ublock_layer_forward_bf16; template argument W = bf16,
// K4-bf16) takes the bf16 window kernels of the JAX package's accelerator
// route and computes ublock_layer_packed's function with them (each window
// value widened exactly, the product in float32: ublock.py:439-446). Its
// window product runs on the tensor cores (lvc_tiles.cuh:mma_product): the
// bf16 window is the B operand as it is, y the A operand as three bf16
// terms, each product accumulated in float32. Both plans stage the windows
// in shared memory (the tiled plan's first unit's copies start before the
// conv weight is staged, the 32-row plan's after its x loads). What bounds
// it: the conv's FP32 FMAs and the bytes
// (block 2: 0.80 GFLOP = 12 us at 67 TFLOP/s against 57 MB = 17 us at 3.35
// TB/s a layer; the product's 3 x 1.61 GFLOP at 989 TFLOP/s is 4.9 us).

#include "lvc_tiles.cuh"

using namespace lvct;

namespace {

// hop >= 64: the tiled plan, MINB blocks an SM (two_per_sm); SPLIT at hops
// that are 4 mod 8 (one block an SM: such a unit stages at least 2 windows)
template <class W, int MINB, bool SPLIT = false>
__global__ void __launch_bounds__(NT, MINB) ublock_tiled_kernel(LayerT<W> a, int B) {
  extern __shared__ float4 smem4[];
  constexpr int R = TILED_ROWS;
  const Tiles tl = carve<false, W>(reinterpret_cast<float*>(smem4), a.hop, a.dil);
  const int tid = threadIdx.x, per_b = (a.T + R - 1) / R;
  const int units = B * per_b;
  if constexpr (MMA<W>)  // the first unit's window copies, in flight while the conv weight is staged
    issue_kernels<R>(a, blockIdx.x / per_b, blockIdx.x % per_b * R, tl, tid);
  stage_conv(a, tl, tid);  // made visible by run_unit's barriers
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = u + gridDim.x < units ? u + gridDim.x : -1;
    run_unit<LVCT_TILED, SPLIT>(a, u / per_b, u % per_b * R, tl, tid,
                                MMA<W> && u == (int)blockIdx.x, n < 0 ? -1 : n / per_b,
                                n % per_b * R);
  }
}

// hop < 64: the streaming plan, one block an SM (its registers; the bf16
// build stages its 32-row units' windows instead)
template <class W>
__global__ void __launch_bounds__(NT, 1) ublock_stream_kernel(LayerT<W> a, int B) {
  extern __shared__ float4 smem4[];
  constexpr int R = STREAM_ROWS;
  const Tiles tl = carve<true, W>(reinterpret_cast<float*>(smem4), a.hop, a.dil);
  const int tid = threadIdx.x, per_b = (a.T + R - 1) / R;
  const int units = B * per_b;
  stage_conv(a, tl, tid);  // made visible by run_unit's barriers
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = u + gridDim.x < units ? u + gridDim.x : -1;
    run_unit<LVCT_STREAM>(a, u / per_b, u % per_b * R, tl, tid, false, n < 0 ? -1 : n / per_b,
                          n % per_b * R);
  }
}

// Whether (hop, W) runs the SPLIT tiled kernel: the float build at hops of 4
// mod 8 (the bf16 build's product takes a window edge anywhere, and its
// kernels are instantiated without SPLIT: ublock_tiled_kernel<W, 1, !MMA<W>>
// is then the one-block kernel).
template <class W>
bool split_kernel(int hop) {
  return !MMA<W> && split_tiles(hop);
}

// Blocks of the persistent grid for (B, T, hop, dil), or a negative error.
template <class W>
int layer_grid(int B, int T, int hop, int dil, int* grid) {
  const int smem = smem_floats<W>(hop, dil) * (int)sizeof(float), R = unit_rows(hop);
  const int v = sizeof(W) == 2 ? 4 : 0;  // the bf16 kernels' cache slots
  int per_sm = 0, sms = 0;
  cudaError_t e =
      hop < TILED_MIN_HOP ? blocks_per_sm(ublock_stream_kernel<W>, v, smem, &per_sm)
      : split_kernel<W>(hop)
          ? blocks_per_sm(ublock_tiled_kernel<W, 1, !MMA<W>>, v + 3, smem, &per_sm)
      : two_per_sm<W>(hop, dil)
          ? blocks_per_sm(ublock_tiled_kernel<W, 2>, v + 1, smem, &per_sm)
          : blocks_per_sm(ublock_tiled_kernel<W, 1>, v + 2, smem, &per_sm);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int units = B * ((T + R - 1) / R);
  *grid = units < per_sm * sms ? units : per_sm * sms;
  return *grid < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <class W>
int layer_forward(const float* x, const float* ad, const float* cw, const float* cb, const W* km,
                  const float* lb, float* out, int B, int T, int L, int hop, int dil, int layers,
                  int step, int layer, cudaStream_t stream) {
  if (B < 1 || L < 1 || !layer_hop_supported(hop) || T != L * hop || dil < 1 || layers < 1 ||
      step < 0 || layer < 0 || layer >= layers)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<W>(hop, dil) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int e = layer_grid<W>(B, T, hop, dil, &grid);
  if (e != 0) return e;
  const LayerT<W> a{x, ad, cw, cb, StackT<W>{km, lb, B, L, layers, step, layer}, out, T, hop, dil};
  if (hop < TILED_MIN_HOP)
    ublock_stream_kernel<W><<<grid, NT, smem, stream>>>(a, B);
  else if (split_kernel<W>(hop))
    ublock_tiled_kernel<W, 1, !MMA<W>><<<grid, NT, smem, stream>>>(a, B);
  else if (two_per_sm<W>(hop, dil))
    ublock_tiled_kernel<W, 2><<<grid, NT, smem, stream>>>(a, B);
  else
    ublock_tiled_kernel<W, 1><<<grid, NT, smem, stream>>>(a, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block of the layer kernel at (hop, dil), float32
// windows (_bf16: bf16 windows).
extern "C" int ublock_layer_smem(int hop, int dil) {
  return smem_floats<float>(hop, dil) * (int)sizeof(float);
}
extern "C" int ublock_layer_smem_bf16(int hop, int dil) {
  return smem_floats<bf16>(hop, dil) * (int)sizeof(float);
}

// Blocks of the layer kernel's persistent grid for (B, T, hop, dil) on the
// current device, or -1 on an error.
extern "C" int ublock_layer_grid(int B, int T, int hop, int dil) {
  int grid = 0;
  return layer_grid<float>(B, T, hop, dil, &grid) == 0 ? grid : -1;
}
extern "C" int ublock_layer_grid_bf16(int B, int T, int hop, int dil) {
  int grid = 0;
  return layer_grid<bf16>(B, T, hop, dil, &grid) == 0 ? grid : -1;
}

// x, ad [B, T, 32]; cw [32, 32, 3] (torch Conv1d layout), cb [32];
// km [N, B, L, layers*96, 64], lb [N, B, L, layers*64] (a plain per-layer
// kmat is N = layers = 1); out [B, T, 32], distinct from x and ad. Reads step
// `step`, layer `layer`. One launch on `stream`; returns the launch error
// (cudaError_t) or 0. km is float32 here, bf16 in ublock_layer_forward_bf16.
extern "C" int ublock_layer_forward(const float* x, const float* ad, const float* cw,
                                    const float* cb, const float* km, const float* lb,
                                    float* out, int B, int T, int L, int hop, int dil,
                                    int layers, int step, int layer, void* stream_ptr) {
  return layer_forward<float>(x, ad, cw, cb, km, lb, out, B, T, L, hop, dil, layers, step, layer,
                              (cudaStream_t)stream_ptr);
}
extern "C" int ublock_layer_forward_bf16(const float* x, const float* ad, const float* cw,
                                         const float* cb, const void* km, const float* lb,
                                         float* out, int B, int T, int L, int hop, int dil,
                                         int layers, int step, int layer, void* stream_ptr) {
  return layer_forward<bf16>(x, ad, cw, cb, static_cast<const bf16*>(km), lb, out, B, T, L, hop,
                             dil, layers, step, layer, (cudaStream_t)stream_ptr);
}
