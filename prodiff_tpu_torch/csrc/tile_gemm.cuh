// Register-tiled FP32 GEMM pieces shared by the WaveNet kernels (K1,
// wavenet_stack.cu; K5, wavenet_train.cu) and the ResBlock1 stage
// (resblock.cu), the ports of the Pallas TPU kernels fused_residual_stack
// (prodiff_tpu/ops/pallas/wavenet.py:177, :261), _fwd_save_single and
// _bwd_chain_single (ops/pallas/wavenet_train.py:71, :161) and
// resblock_group_packed/_streamed (ops/pallas/resblock.py:357, :222). The
// TPU kernels fed a 128x128 matrix unit from VMEM; here the same products
// run on the FP32 FMA pipe.
//
// What bounds those kernels on the H100 in parity mode (float32 operands,
// TF32 off, so no tensor cores) is the FP32 FMA pipe, and a plain
// shared-memory tile loses it to shared-memory loads (one scalar load per
// FMA or two). These pieces keep the FMA pipe fed:
//   - each thread accumulates an FM x 8 fragment: FM consecutive A rows by
//     two groups of 4 columns BN/2 apart, read as float4s (A as float2s where
//     FM = 6), so a k step is FM/4 + 2 128-bit loads per 8*FM FMAs (an A tile
//     is k-major, [k][rows]);
//   - a chunk of the reduction is staged while the previous one computes
//     (run_chunks): weights by cp.async, activations through registers, so
//     the zero padding, pre-activations and scales are applied on the way
//     into shared memory; one __syncthreads a chunk.

#pragma once

#include <cuda_runtime.h>

namespace tile {

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// A float4 that other blocks of the same launch may have written: read
// through L2 (ld.global.cg), never through the non-coherent L1 path.
__device__ __forceinline__ float4 ld4_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// 16 bytes global -> shared without a register round trip (cp.async.cg reads
// through L2); zero-filled where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Reduction rows k..k+3 (v.x..v.w) of row r into a k-major A tile.
template <int LDA>
__device__ __forceinline__ void put_a(float* As, int r, int k, float4 v) {
  As[k * LDA + r] = v.x;
  As[(k + 1) * LDA + r] = v.y;
  As[(k + 2) * LDA + r] = v.z;
  As[(k + 3) * LDA + r] = v.w;
}

// The double-buffered reduction over n chunks: fetch(buf, i) starts chunk
// i's copies into buffer buf (weights by cp.async, activations into
// registers), put(buf, i) stores those registers into the A tile, fma(buf, i)
// computes on the staged chunk. Chunk i+1 is fetched before chunk i computes
// and put after it, into the buffers chunk i-1 used, which every thread left
// at the last barrier: one __syncthreads a chunk.
template <class Fetch, class Put, class Fma>
__device__ __forceinline__ void run_chunks(int n, Fetch fetch, Put put, Fma fma) {
  fetch(0, 0);
  put(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int cur = i & 1;
    if (i + 1 < n) fetch(cur ^ 1, i + 1);
    fma(cur, i);
    if (i + 1 < n) {
      put(cur ^ 1, i + 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
}

// acc[m][n] += sum_{k < NK} sum_{q < NTAP} A[k][row0 + m + q] * B[q][k][col(n)],
// A k-major with row stride LDA, B [tap][k][BN] with tap stride TAPS floats;
// col(n) = col0 + n for n < 4 and col0 + BN/2 + n - 4 after. Rows 0 .. FM +
// NTAP - 2 of the thread are read once for every tap, as float4s where FM %
// 4 == 0, else as float2s (FM even).
template <int FM, int NK, int NTAP, int LDA, int BN, int TAPS>
__device__ __forceinline__ void frag_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int row0, int col0,
                                         float (&acc)[FM][8]) {
  static_assert(FM % 2 == 0 && (NTAP == 1 || NTAP == 3), "FM rows by float2s; 1 or 3 taps");
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const float* ar = As + k * LDA + row0;
    float a[FM + NTAP - 1];
    if constexpr (FM % 4 == 0) {
#pragma unroll
      for (int m = 0; m < FM; m += 4) {
        const float4 v = ld4(ar + m);
        a[m] = v.x; a[m + 1] = v.y; a[m + 2] = v.z; a[m + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < FM; m += 2) {
        const float2 v = *reinterpret_cast<const float2*>(ar + m);
        a[m] = v.x; a[m + 1] = v.y;
      }
    }
    if constexpr (NTAP == 3) {
      const float2 v = *reinterpret_cast<const float2*>(ar + FM);
      a[FM] = v.x;
      a[FM + 1] = v.y;
    }
#pragma unroll
    for (int q = 0; q < NTAP; ++q) {
      const float* br = Bs + q * TAPS + k * BN + col0;
      const float4 b0 = ld4(br), b1 = ld4(br + BN / 2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < FM; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[q + m], bv[n], acc[m][n]);
    }
  }
}

}  // namespace tile
