// bf16 tensor-core pieces shared by the bf16 WaveNet kernels (K1-bf16,
// wavenet_stack_bf16.cu; K5a/K5b-bf16, wavenet_train_bf16.cu), the ports of
// the Pallas TPU kernels fused_residual_stack / fused_residual_stack_tiled
// (prodiff_tpu/ops/pallas/wavenet.py:177, :261), _fwd_save_single and
// _bwd_chain_single (prodiff_tpu/ops/pallas/wavenet_train.py:71, :161) with
// bf16 weight streams: every product takes bf16 operands and accumulates in
// float32 (the TPU kernels' preferred_element_type=float32), as
// mma.sync.m16n8k16 bf16 x bf16 -> f32 on Hopper's tensor cores. The float32
// kernels' FMA tiles are tile_gemm.cuh; wgmma and TMA are later work.
//
// Layouts in shared memory, both padded by 8 bf16 a row so that the 8 rows
// an ldmatrix phase reads fall in distinct banks:
//   A [rows][k], k contiguous (activations: frames x channels), read by
//     ldmatrix.x4 as the m16 x k16 A fragment;
//   B [k][n], n contiguous (weights in the JAX package's [in, out] layout),
//     read by ldmatrix.x4.trans as two n8 x k16 B fragments.
// A warp's accumulators acc[MT][NT][4] hold MT row tiles of 16 by NT column
// tiles of 8: element (16 mi + g + 8 (e / 2), ncol[ni] + 2 q + e % 2) for
// lane = 4 g + q, which the epilogues walk with frag_rows / frag_col.
//
// Staging: run_stages double-buffers a reduction over chunks, as
// tile::run_chunks does for the FP32 tiles: chunk i+1's weights go to shared
// memory by cp.async and its activations through registers (where they are
// shifted, scaled, summed with the step projection and rounded to bf16)
// while chunk i computes; one __syncthreads a chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 of padding a shared-memory row

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 (cp.async.cg: never a stale L1 line of
// data another block wrote before a grid barrier); zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on one m16n8k16 tile: bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += sum_{k < KSTEPS*16} sum_{q < NTAP} A[row0 + 16 mi + q][k] B[q][k][ncol[ni]..]
// over one staged chunk: A [rows][LDA], B [tap][k][LDB] with tap stride
// TAPS elements; NT even (the n tiles are loaded in pairs).
template <int MT, int NT, int NTAP, int KSTEPS, int LDA, int LDB, int TAPS>
__device__ __forceinline__ void warp_mma(const bf16* __restrict__ As, const bf16* __restrict__ Bs,
                                         int row0, const int (&ncol)[NT],
                                         float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "n tiles load in pairs");
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, akof = (lane >> 4) * 8;  // ldmatrix.x4 of A
  const int bk = lane & 15, bhalf = lane >> 4;         // ldmatrix.x4.trans of B
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int q = 0; q < NTAP; ++q) {
      uint32_t b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, Bs + q * TAPS + (ks * 16 + bk) * LDB + ncol[2 * np + bhalf]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, As + (row0 + 16 * mi + q + arow) * LDA + ks * 16 + akof);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma16816(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }
}

// The reduction over n chunks, double-buffered: fetch(buf, i) starts chunk
// i's copies (cp.async) and loads its activations into registers, put(buf,
// i) stores those registers, mma(buf, i) computes on the staged chunk.
template <class Fetch, class Put, class Mma>
__device__ __forceinline__ void run_stages(int n, Fetch fetch, Put put, Mma mma) {
  fetch(0, 0);
  put(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int cur = i & 1;
    if (i + 1 < n) fetch(cur ^ 1, i + 1);
    mma(cur, i);
    if (i + 1 < n) {
      put(cur ^ 1, i + 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
}

// The two frame rows a lane's accumulators hold in row tile mi, and its
// first column in a column tile starting at n0.
__device__ __forceinline__ int frag_row(int mi, int half) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * half;
}
__device__ __forceinline__ int frag_col(int n0) { return n0 + 2 * (threadIdx.x & 3); }

__device__ __forceinline__ uint2 pack4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A float4 that other blocks of the same launch may have written: through L2.
__device__ __forceinline__ float4 ld4_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float2 ld2_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float2 bf2_to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

}  // namespace mma

namespace wavenet_bf16 {

constexpr float RSQRT2 = 0.70710678118654752f;
constexpr int SP_COLS = 32, SP_WARPS = 8;

// sp[l, b, c] = b_s[l, c] + sum_k bf16(step[b, k]) * W_s[l, k, c]: the step
// projection of every layer in one launch, its operands bf16 as the Pallas
// layer's (step_v.astype(cdt) . diffw). A [B, C] x [C, C] product a layer is
// too thin for the tensor cores: each product of two bf16 values is exact in
// float32, so an FMA in float32 computes what the mma would. A block owns 32
// columns of one (layer, sequence); its 8 warps take a slice of k each.
__global__ void __launch_bounds__(SP_COLS * SP_WARPS)
step_proj_kernel(const float* __restrict__ step, const mma::bf16* __restrict__ diffw,
                 const float* __restrict__ diffb, float* __restrict__ sp, int B, int C) {
  __shared__ float part[SP_WARPS][SP_COLS];
  const int l = blockIdx.x, b = blockIdx.y, c = blockIdx.z * SP_COLS + threadIdx.x % SP_COLS;
  const int warp = threadIdx.x / SP_COLS, k_per = C / SP_WARPS;
  const mma::bf16* w = diffw + (size_t)l * C * C + c;
  const float* s = step + (size_t)b * C;
  float acc = 0.f;
#pragma unroll 8
  for (int k = warp * k_per; k < (warp + 1) * k_per; ++k)
    acc = fmaf(__bfloat162float(__float2bfloat16(s[k])), __bfloat162float(w[(size_t)k * C]), acc);
  part[warp][threadIdx.x % SP_COLS] = acc;
  __syncthreads();
  if (warp == 0) {
    for (int i = 1; i < SP_WARPS; ++i) acc += part[i][threadIdx.x];
    sp[((size_t)l * B + b) * C + c] = acc + diffb[(size_t)l * C + c];
  }
}

inline cudaError_t launch_step_proj(const float* step, const mma::bf16* diffw, const float* diffb,
                                    float* sp, int B, int C, int L, cudaStream_t stream) {
  step_proj_kernel<<<dim3(L, B, C / SP_COLS), SP_COLS * SP_WARPS, 0, stream>>>(step, diffw, diffb,
                                                                              sp, B, C);
  return cudaGetLastError();
}

}  // namespace wavenet_bf16
