// Trainable WaveNet residual stack with bf16 operands and saves (K5a-bf16,
// K5b-bf16) for Hopper: the save-forward and the sequential backward chain.
//
// Replaces the Pallas TPU kernels _fwd_save_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:71) and _bwd_chain_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:161) with save_dtype = bfloat16
// and bf16 weight streams: the forward writes each layer's input xs and
// pre-gate zs in bf16; the chain reads zs back to float32, runs
// do . W_o^T and dz . W_d^T on bf16 operands with float32 accumulation,
// carries the layer-to-layer gradient in float32 and emits dy (and dz, which
// the weight gradients take) in bf16. The products run on the tensor cores
// (mma.sync m16n8k16 bf16 x bf16 -> f32, mma_bf16.cuh). The weight, cond and
// step gradients stay outside any kernel (ops/wavenet_train.py:
// stack_param_grads), as the JAX package leaves them to XLA einsums. The
// float32 variant is wavenet_train.cu, whose structure this keeps:
//
// Save-forward, 1 + 2L launches: step_proj_kernel (mma_bf16.cuh), then per
// layer save_gate_kernel (z = sum_q bf16(y)[t+q-1] . W_d[l,q] + bf16(cond) .
// W_c[l] + b_d + b_c with y = x + sp, zero outside [0, T); writes xs[l] =
// bf16(x), zs[l] = bf16(z) and the bf16 gate sigmoid(z[:, j]) tanh(z[:, C+j])
// of the float32 z) and save_out_kernel (o = gate . W_o[l] + b_o; x = (x +
// o[:, :C]) / sqrt(2), skip += o[:, C:], float32, in place).
//
// Backward chain, 2L launches, layer l from L-1 down to 0, on the float32
// carry dx [B,T,C]: chain_gate_kernel (dgate = bf16(do) . W_o[l]^T with do =
// [dx / sqrt(2), g / sqrt(L)]; dz = (dgate tanh(zf) a(1-a), dgate a
// (1-tanh^2(zf))), a = sigmoid(zg), from the bf16 zs, written bf16) and
// chain_dy_kernel (dy_t = dz_t . W1^T + dz_{t+1} . W0^T + dz_{t-1} . W2^T on
// the bf16 dz; dy written bf16, dx = dx / sqrt(2) + dy in float32 with the
// unrounded dy). Layouts as wavenet_train.cu: zs [L,B,T,2C], dy [L,B,T,C],
// dz [B,T,L,2C]; the chain reads W_o and W_d transposed (owt [L,2C,C], dwt
// [L,3,2C,C], bf16, made by the caller).
//
// What bounds it on the H100: at B=16, T=1536, C=H=256, L=20 the
// save-forward is 644 GFLOP (0.65 ms at 989 TFLOP/s) and the chain 515 GFLOP
// (0.52 ms) against ~1.5 GB of bf16 saves each way (~0.5 ms at 3.35 TB/s).
// These mma.sync tiles (64 frames x 32 column pairs, or 64 columns, 8 warps
// of 32 x 16) re-read their weights from L2 for every tile and stage the
// float32 activations through registers, so they stay far from that.

#include "mma_bf16.cuh"

namespace {

using mma::bf16;
using mma::PAD;
using wavenet_bf16::RSQRT2;

constexpr int KC = 32;         // reduction chunk (two k16 steps)
constexpr int LDA = KC + PAD;  // A row: KC bf16 + padding
constexpr int BM = 64;         // frames a block
constexpr int BN = 64, BP = 32;
constexpr int LDB = BN + PAD;
constexpr int NT = 256;  // 8 warps: 2 along the frames x 4 along the columns
constexpr int HALO = BM + 2;

// B tile [NTAP][KC][BN] of a [.., 2C] weight: rows k0.. of each tap, the pair
// columns j0.. and C+j0..
template <int NTAP>
__device__ __forceinline__ void copy_pairs(bf16* bs, const bf16* w, int C, int k0, int j0) {
  const size_t c2 = 2 * (size_t)C;
#pragma unroll
  for (int s = 0; s < NTAP * KC * 8 / NT; ++s) {
    const int f = threadIdx.x + s * NT;
    const int q = f / (KC * 8), k = f / 8 % KC, n = f % 8 * 8;
    const int jp = j0 + n % BP;
    const size_t col = n < BP ? jp : C + jp;
    mma::cp_async16(bs + (q * KC + k) * LDB + n, w + ((size_t)q * C + k0 + k) * c2 + col, jp < C);
  }
}

// z, xs, zs and the gate for 32 column pairs of one layer. Chunks 0 ..
// C/KC-1 are the conv's (A rows: frames t0-1 .. t0+BM of y, three taps), the
// rest the conditioner's (frames t0 .. t0+BM-1 of cond at rows 1 .. BM).
__global__ void __launch_bounds__(NT)
save_gate_kernel(const float* __restrict__ x, const float* __restrict__ sp,
                 const float* __restrict__ cond, const bf16* __restrict__ dw,
                 const float* __restrict__ db, const bf16* __restrict__ cw,
                 const float* __restrict__ cb, bf16* __restrict__ gate, bf16* __restrict__ xs,
                 bf16* __restrict__ zs, int T, int C, int H) {
  constexpr int NA = mma::ceil_div(HALO * KC / 4, NT);
  __shared__ __align__(16) bf16 As[2][HALO * LDA];
  __shared__ __align__(16) bf16 Bs[2][3 * KC * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BP;
  const int tid = threadIdx.x, w = tid / 32, wm = w / 4, wn = w % 4;
  const float* xb = x + (size_t)b * T * C;
  const float* cdb = cond + (size_t)b * T * H;
  const float* spb = sp + (size_t)b * C;
  const int n_conv = C / KC, n_chunks = n_conv + H / KC;

  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
    const bool conv = i < n_conv;
    if (conv)
      copy_pairs<3>(Bs[buf], dw, C, i * KC, j0);
    else
      copy_pairs<1>(Bs[buf], cw, C, (i - n_conv) * KC, j0);
    mma::cp_async_commit();
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e / (KC / 4), k = e % (KC / 4) * 4;
      const int t = t0 - 1 + r;
      ra[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < HALO && t >= 0 && t < T && (conv || (r >= 1 && r <= BM)))
        ra[s] = conv ? mma::ld4(xb + (size_t)t * C + i * KC + k)
                     : mma::ld4(cdb + (size_t)t * H + (i - n_conv) * KC + k);
    }
  };
  auto put = [&](int buf, int i) {
    const bool conv = i < n_conv;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e / (KC / 4), k = e % (KC / 4) * 4;
      if (r >= HALO) continue;
      float4 v = ra[s];
      const int t = t0 - 1 + r, c = i * KC + k;
      if (conv && t >= 0 && t < T) {
        if (blockIdx.x == 0 && r >= 1 && r <= BM)
          *reinterpret_cast<uint2*>(xs + ((size_t)b * T + t) * C + c) = mma::pack4(v);
        v = mma::add4(v, mma::ld4(spb + c));
      }
      *reinterpret_cast<uint2*>(As[buf] + r * LDA + k) = mma::pack4(v);
    }
  };
  float acc[2][2][4] = {};
  const int ncol[2] = {8 * wn, BP + 8 * wn};
  mma::run_stages(n_chunks, fetch, put, [&](int buf, int i) {
    if (i < n_conv)
      mma::warp_mma<2, 2, 3, KC / 16, LDA, LDB, KC * LDB>(As[buf], Bs[buf], 32 * wm, ncol, acc);
    else
      mma::warp_mma<2, 2, 1, KC / 16, LDA, LDB, 0>(As[buf], Bs[buf], 32 * wm + 1, ncol, acc);
  });

  const int j = j0 + mma::frag_col(8 * wn);
  if (j >= C) return;  // masked pairs (C % 32 == 0 leaves none)
  const size_t c2 = 2 * (size_t)C;
  const float bg0 = db[j] + cb[j], bg1 = db[j + 1] + cb[j + 1];
  const float bf0 = db[C + j] + cb[C + j], bf1 = db[C + j + 1] + cb[C + j + 1];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 32 * wm + mma::frag_row(mi, h);
      if (t >= T) continue;
      const float zg0 = acc[mi][0][2 * h] + bg0, zg1 = acc[mi][0][2 * h + 1] + bg1;
      const float zf0 = acc[mi][1][2 * h] + bf0, zf1 = acc[mi][1][2 * h + 1] + bf1;
      bf16* zrow = zs + ((size_t)b * T + t) * c2;
      mma::st_bf2(zrow + j, zg0, zg1);
      mma::st_bf2(zrow + C + j, zf0, zf1);
      mma::st_bf2(gate + ((size_t)b * T + t) * C + j, mma::sigmoid(zg0) * tanhf(zf0),
                  mma::sigmoid(zg1) * tanhf(zf1));
    }
}

// o = gate . W_o + b_o for 32 column pairs; x = (x + o[:, :C]) / sqrt(2),
// skip = (skip + o[:, C:]) * skip_scale, in place.
__global__ void __launch_bounds__(NT)
save_out_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ ow,
                const float* __restrict__ ob, float* __restrict__ x, float* __restrict__ skip,
                int T, int C, int first, float skip_scale) {
  __shared__ __align__(16) bf16 As[2][BM * LDA];
  __shared__ __align__(16) bf16 Bs[2][KC * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BP;
  const int tid = threadIdx.x, w = tid / 32, wm = w / 4, wn = w % 4;
  const bf16* gb = gate + (size_t)b * T * C;

  auto fetch = [&](int buf, int i) {
    copy_pairs<1>(Bs[buf], ow, C, i * KC, j0);
    const int r = tid / 4, k = tid % 4 * 8, t = t0 + r;  // A: BM rows x 4 segments
    mma::cp_async16(As[buf] + r * LDA + k, t < T ? gb + (size_t)t * C + i * KC + k : gb, t < T);
    mma::cp_async_commit();
  };
  float acc[2][2][4] = {};
  const int ncol[2] = {8 * wn, BP + 8 * wn};
  mma::run_stages(C / KC, fetch, [](int, int) {}, [&](int buf, int) {
    mma::warp_mma<2, 2, 1, KC / 16, LDA, LDB, 0>(As[buf], Bs[buf], 32 * wm, ncol, acc);
  });

  const int j = j0 + mma::frag_col(8 * wn);
  if (j >= C) return;
  const float2 obr = *reinterpret_cast<const float2*>(ob + j);
  const float2 obs = *reinterpret_cast<const float2*>(ob + C + j);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 32 * wm + mma::frag_row(mi, h);
      if (t >= T) continue;
      const size_t i = ((size_t)b * T + t) * C + j;
      const float2 xv = *reinterpret_cast<const float2*>(x + i);
      *reinterpret_cast<float2*>(x + i) =
          make_float2((xv.x + (acc[mi][0][2 * h] + obr.x)) * RSQRT2,
                      (xv.y + (acc[mi][0][2 * h + 1] + obr.y)) * RSQRT2);
      float2 s = make_float2(acc[mi][1][2 * h] + obs.x, acc[mi][1][2 * h + 1] + obs.y);
      if (!first) {
        const float2 o = *reinterpret_cast<const float2*>(skip + i);
        s = make_float2(o.x + s.x, o.y + s.y);
      }
      *reinterpret_cast<float2*>(skip + i) = make_float2(s.x * skip_scale, s.y * skip_scale);
    }
}

// B tile [NTAP][KC][BN] of a transposed [.., C] weight (64 plain columns
// j0..), tap q read from tap (flip ? 2 - q : q) of the source.
template <int NTAP>
__device__ __forceinline__ void copy_cols(bf16* bs, const bf16* w, int C, int rows_per_tap,
                                          int k0, int j0, bool flip) {
#pragma unroll
  for (int s = 0; s < NTAP * KC * 8 / NT; ++s) {
    const int f = threadIdx.x + s * NT;
    const int q = f / (KC * 8), k = f / 8 % KC, n = f % 8 * 8;
    const int src_tap = flip ? NTAP - 1 - q : q;
    mma::cp_async16(bs + (q * KC + k) * LDB + n,
                    w + ((size_t)src_tap * rows_per_tap + k0 + k) * C + j0 + n, true);
  }
}

// dz[b, t, l, (j, C+j)] from dgate[t, j] = sum_k bf16(do[t, k]) W_o^T[k, j], k < 2C.
__global__ void __launch_bounds__(NT)
chain_gate_kernel(const float* __restrict__ dx, const float* __restrict__ g,
                  const bf16* __restrict__ zs, const bf16* __restrict__ owt,
                  bf16* __restrict__ dz, int T, int C, int L, int l, float inv_sqrt_l) {
  constexpr int NA = BM * KC / 4 / NT;
  __shared__ __align__(16) bf16 As[2][BM * LDA];
  __shared__ __align__(16) bf16 Bs[2][KC * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, w = tid / 32, wm = w / 4, wn = w % 4;
  const size_t row0 = (size_t)b * T;

  // a chunk lies wholly in one half of do, since C % KC == 0
  float4 ra[NA];
  auto fetch = [&](int buf, int i) {
    copy_cols<1>(Bs[buf], owt, C, 0, i * KC, j0, false);
    mma::cp_async_commit();
    const bool res = i * KC < C;
    const float* src = res ? dx : g;
    const int kc = res ? i * KC : i * KC - C;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e / (KC / 4), k = e % (KC / 4) * 4;
      ra[s] = t0 + r < T ? mma::ld4(src + (row0 + t0 + r) * C + kc + k)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int buf, int i) {
    const float scale = i * KC < C ? RSQRT2 : inv_sqrt_l;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT;
      *reinterpret_cast<uint2*>(As[buf] + e / (KC / 4) * LDA + e % (KC / 4) * 4) =
          mma::pack4(mma::scale4(ra[s], scale));
    }
  };
  float acc[2][2][4] = {};
  const int ncol[2] = {16 * wn, 16 * wn + 8};
  mma::run_stages(2 * C / KC, fetch, put, [&](int buf, int) {
    mma::warp_mma<2, 2, 1, KC / 16, LDA, LDB, 0>(As[buf], Bs[buf], 32 * wm, ncol, acc);
  });

  const size_t c2 = 2 * (size_t)C;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 32 * wm + mma::frag_row(mi, h);
      if (t >= T) continue;
      const bf16* zrow = zs + (row0 + t) * c2;
      bf16* dzrow = dz + ((row0 + t) * L + l) * c2;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int j = j0 + mma::frag_col(ncol[ni]);
        const float2 zg = mma::bf2_to_f2(zrow + j), zf = mma::bf2_to_f2(zrow + C + j);
        const float a0 = mma::sigmoid(zg.x), a1 = mma::sigmoid(zg.y);
        const float tb0 = tanhf(zf.x), tb1 = tanhf(zf.y);
        const float d0 = acc[mi][ni][2 * h], d1 = acc[mi][ni][2 * h + 1];
        mma::st_bf2(dzrow + j, d0 * tb0 * a0 * (1.f - a0), d1 * tb1 * a1 * (1.f - a1));
        mma::st_bf2(dzrow + C + j, d0 * a0 * (1.f - tb0 * tb0), d1 * a1 * (1.f - tb1 * tb1));
      }
    }
}

// dy[b, t, c] = sum_q sum_d dz[b, t+1-q, l, d] W_d[q]^T[d, c];  dx = dx / sqrt(2) + dy.
// The A tile's row r holds dz at frame t0 - 1 + r; staged tap p is W_d[2 - p]^T,
// read at row m + p (frame t0 + m - 1 + p = t + 1 - q).
__global__ void __launch_bounds__(NT)
chain_dy_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ dwt,
                float* __restrict__ dx, bf16* __restrict__ dy, int T, int C, int L, int l) {
  __shared__ __align__(16) bf16 As[2][HALO * LDA];
  __shared__ __align__(16) bf16 Bs[2][3 * KC * LDB];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, w = tid / 32, wm = w / 4, wn = w % 4;
  const size_t row0 = (size_t)b * T, c2 = 2 * (size_t)C;

  auto fetch = [&](int buf, int i) {
    copy_cols<3>(Bs[buf], dwt, C, 2 * C, i * KC, j0, true);
    for (int f = tid; f < HALO * 4; f += NT) {  // A: HALO rows x 4 segments
      const int r = f / 4, k = f % 4 * 8, t = t0 - 1 + r;
      const bool ok = t >= 0 && t < T;
      mma::cp_async16(As[buf] + r * LDA + k, ok ? dz + ((row0 + t) * L + l) * c2 + i * KC + k : dz,
                      ok);
    }
    mma::cp_async_commit();
  };
  float acc[2][2][4] = {};
  const int ncol[2] = {16 * wn, 16 * wn + 8};
  mma::run_stages(2 * C / KC, fetch, [](int, int) {}, [&](int buf, int) {
    mma::warp_mma<2, 2, 3, KC / 16, LDA, LDB, KC * LDB>(As[buf], Bs[buf], 32 * wm, ncol, acc);
  });

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 32 * wm + mma::frag_row(mi, h);
      if (t >= T) continue;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const size_t i = (row0 + t) * C + j0 + mma::frag_col(ncol[ni]);
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        mma::st_bf2(dy + i, v0, v1);
        const float2 d = *reinterpret_cast<const float2*>(dx + i);
        *reinterpret_cast<float2*>(dx + i) = make_float2(d.x * RSQRT2 + v0, d.y * RSQRT2 + v1);
      }
    }
}

}  // namespace

// As wavenet_stack_save_forward (wavenet_train.cu) with the four weight
// matrices bf16 (dw [L,3,C,2C], diffw [L,C,C], cw [L,H,2C], ow [L,C,2C]),
// the gate scratch bf16 and the saves xs [L,B,T,C] and zs [L,B,T,2C] bf16;
// x, skip, sp, cond, step and the biases float32. Needs C % 32 == 0 and
// H % 32 == 0. 1 + 2L launches on `stream`; returns the first launch error
// (cudaError_t) or 0.
extern "C" int wavenet_stack_save_forward_bf16(
    float* x, float* skip, bf16* gate, float* sp, bf16* xs, bf16* zs, const float* cond,
    const float* step, const bf16* dw, const float* db, const bf16* diffw, const float* diffb,
    const bf16* cw, const float* cb, const bf16* ow, const float* ob, int B, int T, int C, int H,
    int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % BP != 0 || H % KC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = wavenet_bf16::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C / BP, mma::ceil_div(T, BM), B);
  const float last_scale = (float)(1.0 / sqrt((double)L));
  for (int l = 0; l < L; ++l) {
    save_gate_kernel<<<grid, NT, 0, stream>>>(
        x, sp + (size_t)l * B * C, cond, dw + (size_t)l * 3 * C * 2 * C, db + (size_t)l * 2 * C,
        cw + (size_t)l * H * 2 * C, cb + (size_t)l * 2 * C, gate, xs + (size_t)l * B * T * C,
        zs + (size_t)l * B * T * 2 * C, T, C, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    save_out_kernel<<<grid, NT, 0, stream>>>(gate, ow + (size_t)l * C * 2 * C,
                                             ob + (size_t)l * 2 * C, x, skip, T, C, l == 0,
                                             l == L - 1 ? last_scale : 1.f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// As wavenet_stack_backward_chain (wavenet_train.cu) with zs, dwt [L,3,2C,C],
// owt [L,2C,C], dz [B,T,L,2C] and dy [L,B,T,C] bf16; g and the carry dx
// (zeroed by the caller, out: dL/dx0) float32. Needs C % 64 == 0. 2L
// launches on `stream`; returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_stack_backward_chain_bf16(const bf16* zs, const float* g, const bf16* dwt,
                                                 const bf16* owt, float* dx, bf16* dz, bf16* dy,
                                                 int B, int T, int C, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % BN != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(C / BN, mma::ceil_div(T, BM), B);
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  for (int l = L - 1; l >= 0; --l) {
    chain_gate_kernel<<<grid, NT, 0, stream>>>(dx, g, zs + (size_t)l * B * T * 2 * C,
                                               owt + (size_t)l * 2 * C * C, dz, T, C, L, l,
                                               inv_sqrt_l);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chain_dy_kernel<<<grid, NT, 0, stream>>>(dz, dwt + (size_t)l * 3 * 2 * C * C, dx,
                                             dy + (size_t)l * B * T * C, T, C, L, l);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
