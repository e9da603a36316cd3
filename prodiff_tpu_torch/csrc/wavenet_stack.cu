// WaveNet residual stack (the 20-layer diffusion denoiser loop) for Hopper.
//
// Replaces the Pallas TPU kernels fused_residual_stack
// (prodiff_tpu/ops/pallas/wavenet.py:177) and fused_residual_stack_tiled
// (prodiff_tpu/ops/pallas/wavenet.py:261); the layer body they share is
// _wavenet_layer_step (:124). Per layer l, on x [B,T,C], cond [B,T,H]:
//   y    = x + (step . W_s[l] + b_s[l])              (zero outside [0, T))
//   z    = sum_q y[t+q-1] . W_d[l,q] + b_d[l] + cond . W_c[l] + b_c[l]
//   g    = sigmoid(z[:, :C]) * tanh(z[:, C:])
//   o    = g . W_o[l] + b_o[l]
//   x    = (x + o[:, :C]) / sqrt(2);   skip += o[:, C:]
// and the stack returns skip / sqrt(L).
//
// What bounds it on the H100: float32 FMA throughput. In parity mode the
// operands are float32 and TF32 is off, so the tensor cores are out; at
// T=512, C=H=256 a layer is 0.67 GFLOP against 2.6 MB of weights, which
// the 50 MB L2 serves to every row tile.
//
// Design: the TPU kernel keeps x and skip in VMEM for the whole stack; one
// float32 [512, 256] carry is 512 KiB, more than the 227 KB of shared memory a
// block can have, so here the layer loop is a host loop and x/skip stay in
// device memory (L2-resident at B=1, T=512). Per layer two kernels:
//   gate_kernel: a row tile x 32 column PAIRS (j, C+j) per block, so the
//     gate is formed in registers in the epilogue and z never reaches memory;
//     the step projection and the sequence-end zero padding are applied as
//     the activation tile is staged into shared memory; the k=3 taps reuse one
//     staged tile (BM+2 rows) at three row offsets;
//   out_kernel: the output projection with the residual/skip update fused in
//     its epilogue (pairs (j, C+j) again), updating x and skip in place.
// One step_proj_kernel per stack computes W_s[l] . step for every layer
// first. Launches per stack: 1 + 2L. Tiles are plain shared-memory SGEMM;
// wgmma/TMA and a halo-tiled whole-stack kernel are later work. The kernels
// live in wavenet_tiles.cuh.

#include "wavenet_tiles.cuh"

// x: [B,T,C] in: x0, out: the last layer's residual (scratch for the caller);
// skip: [B,T,C] out: skip / sqrt(L); gate: [B,T,C] scratch; sp: [L,B,C] scratch.
// Weights stacked over layers: dw [L,3,C,2C], db [L,2C], diffw [L,C,C],
// diffb [L,C], cw [L,H,2C], cb [L,2C], ow [L,C,2C], ob [L,2C]. Launches 1 + 2L
// kernels on `stream`; returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_residual_stack(
    float* x, float* skip, float* gate, float* sp, const float* cond,
    const float* step, const float* dw, const float* db, const float* diffw,
    const float* diffb, const float* cw, const float* cb, const float* ow,
    const float* ob, int B, int T, int C, int H, int L, void* stream_ptr) {
  return wavenet::run_stack(x, skip, gate, sp, cond, step, dw, db, diffw, diffb, cw, cb, ow,
                            ob, B, T, C, H, L, (cudaStream_t)stream_ptr);
}
