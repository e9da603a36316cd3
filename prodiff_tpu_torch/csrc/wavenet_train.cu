// Trainable WaveNet residual stack (K5) for Hopper: the save-forward and the
// sequential backward chain.
//
// Replaces the Pallas TPU kernels _fwd_save_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:71) and _bwd_chain_single
// (prodiff_tpu/ops/pallas/wavenet_train.py:161). The weight, cond and step
// gradients stay outside any kernel, as cuBLAS products
// (ops/wavenet_train.py:stack_param_grads), as the JAX package leaves them
// to XLA einsums.
//
// Save-forward, per layer l (the layer of wavenet_tiles.cuh), after one
// step_proj_kernel for every layer:
//   save_gate_kernel: z = sum_q y[t+q-1] . W_d[l,q] + cond . W_c[l] + b_d + b_c
//     with y = x + sp (zero outside [0, T)); writes the layer input x to
//     xs[l], z to zs[l] and gate = sigmoid(z[:, j]) tanh(z[:, C+j]);
//   save_out_kernel: o = gate . W_o[l] + b_o; x = (x + o[:, :C]) / sqrt(2)
//     and skip += o[:, C:] in place (skip / sqrt(L) after the last layer).
// 1 + 2L launches.
//
// Backward chain, per layer l from L-1 down to 0, on the carry dx [B,T,C]
// (dL/dx at the layer's output; zero above the top layer):
//   chain_gate_kernel: dgate = do . W_o[l]^T with do = [dx / sqrt(2), g / sqrt(L)]
//     formed as the tile is staged (never stored); the epilogue reads z from
//     zs[l] and writes dz[l] = (dgate * tanh(zf) * a(1-a), dgate * a (1-tanh^2(zf)))
//     with a = sigmoid(zg), as the column pair (j, C+j);
//   chain_dy_kernel: dy_t = dz_t . W1^T + dz_{t+1} . W0^T + dz_{t-1} . W2^T
//     (the forward's taps z_t = y_{t-1} W0 + y_t W1 + y_{t+1} W2, mirrored;
//     dz is zero outside [0, T)); the epilogue writes dy[l] and updates the
//     carry in place, dx = dx / sqrt(2) + dy.
// 2L launches. After the last, dx holds dL/dx0. The chain reads W_o and W_d
// transposed (owt [L,2C,C], dwt [L,3,2C,C], made by the caller once a call).
//
// Layouts: zs [L,B,T,2C], dy [L,B,T,C], dz [B,T,L,2C] (so the cond gradient
// is one [B*T, L*2C] x [L*2C, H] product). g is the cotangent of skip/sqrt(L).
//
// What bounds it on the H100: float32 FMA throughput (parity mode: float32
// operands, TF32 off, so no tensor cores). At B=16, T=1536, C=H=256, L=20 the
// save-forward is 644 GFLOP (9.6 ms at 67 TFLOP/s) and the chain 515 GFLOP
// (7.7 ms) against ~3 GB of saved activations each (under 1 ms at 3.35 TB/s).
// Per layer the GEMMs are M = B*T frames by N = 2C (forward) or C (chain)
// columns, over K = 3C + H, C, 2C and 3 x 2C.
//
// Design: each kernel is one register-tiled SGEMM with its taps and epilogue
// fused. A block computes BM = 128 frames of one sequence (blockIdx.z) by BN
// columns; each thread an 8 x 8 fragment, 8 consecutive frames by two groups
// of 4 columns BN/2 apart, read from shared memory as float4s: the A tile is
// k-major [BK][BM+4], the B tile [tap][BK][BN], so a k step is 4 128-bit loads
// per 64 FMAs, and a 3-tap step reads the thread's 10 A rows once for all
// three taps (9 loads per 192 FMAs). The forward's BN = 128 columns are 64
// pairs (j, C+j) (256 threads), so the gate forms in registers; pairs >= C
// (C % 64 == 32) are masked. The chain's BN = 64 columns of C (128 threads,
// so 768 blocks at the training shape, as the forward). Occupancy: 2 forward
// blocks an SM (128 registers; the gate kernel spills 64 bytes, which beat
// one block without the spill on the H100), 4 chain_gate blocks and 3
// chain_dy blocks (155 registers, no spill, which beat 4 blocks with one).
// The reduction runs in chunks of BK = 8, double-buffered (run_chunks, in
// tile_gemm.cuh, which K1 and the resblock stage share):
// chunk k+1's weights go to shared memory by cp.async and its activations
// through registers (where the step projection, do's scales and the zero
// padding outside [0, T) are applied, and the forward writes xs) while chunk
// k computes, with one __syncthreads a chunk. The conv taps read one staged
// tile of BM + 2 rows (frames t0-1 .. t0+BM of the block's own sequence) at
// row offsets 0, 1, 2.

#include "tile_gemm.cuh"
#include "wavenet_tiles.cuh"

namespace {

using wavenet::RSQRT2;

constexpr int BK = 8;         // reduction chunk
constexpr int BM = 128;       // frames per block
constexpr int LDA = BM + 4;   // k-major A row: BM + 2 halo rows, float4-aligned
constexpr int FWD_BN = 128;   // forward: 64 column pairs (j, C+j) a block
constexpr int FWD_NT = (BM / 8) * (FWD_BN / 8);  // 256 threads
constexpr int CH_BN = 64;     // chain: 64 columns of C a block
constexpr int CH_NT = (BM / 8) * (CH_BN / 8);    // 128 threads

using tile::ceil_div;
using tile::cp_async16;
using tile::cp_async_commit;
using tile::cp_async_wait_all;
using tile::ld4;
using tile::run_chunks;
using tile::sigmoid;
using tile::st4;

__device__ __forceinline__ void put_a(float* As, int r, int k, float4 v) {
  tile::put_a<LDA>(As, r, k, v);
}

// acc[m][n] += sum_k sum_q A[k][row0 + m + q] * B[q][k][col(n)] over one
// staged chunk (tile::frag_fma with 8 x 8 fragments).
template <int BN, int NTAP>
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int row0, int col0,
                                         float (&acc)[8][8]) {
  tile::frag_fma<8, BK, NTAP, LDA, BN, BK * BN>(As, Bs, row0, col0, acc);
}

// z and gate for 64 column pairs of one layer. Chunks 0 .. C/BK-1 are the
// conv's (A rows: frames t0-1 .. t0+BM of y, three taps), the rest the
// conditioner's (A rows: frames t0 .. t0+BM-1 of cond, one tap).
__global__ void __launch_bounds__(FWD_NT, 2)
save_gate_kernel(const float* __restrict__ x, const float* __restrict__ sp,
                 const float* __restrict__ cond, const float* __restrict__ dw,
                 const float* __restrict__ db, const float* __restrict__ cw,
                 const float* __restrict__ cb, float* __restrict__ gate,
                 float* __restrict__ xs, float* __restrict__ zs, int T, int C, int H) {
  constexpr int BN = FWD_BN, NT = FWD_NT, NTX = BN / 8;
  constexpr int NA = ceil_div((BM + 2) * BK / 4, NT);  // float4s of A a thread stages
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][3 * BK * BN];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * (BN / 2);
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const size_t c2 = 2 * (size_t)C;
  const float* xb = x + (size_t)b * T * C;
  const float* cdb = cond + (size_t)b * T * H;
  const float* spb = sp + (size_t)b * C;
  const int n_conv = C / BK, n_chunks = n_conv + H / BK;

  float4 ra[NA];
  auto load_a = [&](int i) {
    const bool conv = i < n_conv;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, k = (e & 1) * 4;
      const int t = conv ? t0 - 1 + r : t0 + r;
      ra[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < (conv ? BM + 2 : BM) && t >= 0 && t < T)
        ra[s] = conv ? ld4(xb + (size_t)t * C + i * BK + k)
                     : ld4(cdb + (size_t)t * H + (i - n_conv) * BK + k);
    }
  };
  auto store_a = [&](float* as, int i) {
    const bool conv = i < n_conv;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, k = (e & 1) * 4;
      if (r >= (conv ? BM + 2 : BM)) continue;
      float4 v = ra[s];
      const int t = t0 - 1 + r, c = i * BK + k;
      if (conv && t >= 0 && t < T) {
        if (blockIdx.x == 0 && r >= 1 && r <= BM) st4(xs + ((size_t)b * T + t) * C + c, v);
        const float4 st = ld4(spb + c);
        v = make_float4(v.x + st.x, v.y + st.y, v.z + st.z, v.w + st.w);
      }
      put_a(as, r, k, v);
    }
  };
  auto copy_b = [&](float* bs, int i) {
    const bool conv = i < n_conv;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (!conv && s > 0) break;
      const int f = tid + s * NT;  // float4 (q, k, n/4) of [3][BK][BN]
      const int q = f / (BK * BN / 4), k = f / (BN / 4) % BK, n = f % (BN / 4) * 4;
      const int jp = j0 + n % (BN / 2);
      const size_t col = n < BN / 2 ? jp : C + jp;
      const float* src = conv ? dw + ((size_t)q * C + i * BK + k) * c2 + col
                              : cw + ((size_t)(i - n_conv) * BK + k) * c2 + col;
      cp_async16(bs + f * 4, jp < C ? src : dw, jp < C);
    }
    cp_async_commit();
  };

  float acc[8][8] = {};
  run_chunks(
      n_chunks, [&](int buf, int i) { copy_b(Bs[buf], i); load_a(i); },
      [&](int buf, int i) { store_a(As[buf], i); },
      [&](int buf, int i) {
        if (i < n_conv)
          tile_fma<BN, 3>(As[buf], Bs[buf], ty * 8, tx * 4, acc);
        else
          tile_fma<BN, 1>(As[buf], Bs[buf], ty * 8, tx * 4, acc);
      });

  const int jb = j0 + tx * 4;
  if (jb >= C) return;  // masked pairs
  const float4 dbg = ld4(db + jb), dbf = ld4(db + C + jb);
  const float4 cbg = ld4(cb + jb), cbf = ld4(cb + C + jb);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = t0 + ty * 8 + m;
    if (t >= T) break;
    const float4 zg = make_float4(acc[m][0] + dbg.x + cbg.x, acc[m][1] + dbg.y + cbg.y,
                                  acc[m][2] + dbg.z + cbg.z, acc[m][3] + dbg.w + cbg.w);
    const float4 zf = make_float4(acc[m][4] + dbf.x + cbf.x, acc[m][5] + dbf.y + cbf.y,
                                  acc[m][6] + dbf.z + cbf.z, acc[m][7] + dbf.w + cbf.w);
    float* zrow = zs + ((size_t)b * T + t) * c2;
    st4(zrow + jb, zg);
    st4(zrow + C + jb, zf);
    st4(gate + ((size_t)b * T + t) * C + jb,
        make_float4(sigmoid(zg.x) * tanhf(zf.x), sigmoid(zg.y) * tanhf(zf.y),
                    sigmoid(zg.z) * tanhf(zf.z), sigmoid(zg.w) * tanhf(zf.w)));
  }
}

// o = gate . W_o + b_o for 64 column pairs; x = (x + o[:, :C]) / sqrt(2),
// skip = (skip + o[:, C:]) * skip_scale, in place.
__global__ void __launch_bounds__(FWD_NT, 2)
save_out_kernel(const float* __restrict__ gate, const float* __restrict__ ow,
                const float* __restrict__ ob, float* __restrict__ x,
                float* __restrict__ skip, int T, int C, int first, float skip_scale) {
  constexpr int BN = FWD_BN, NT = FWD_NT, NTX = BN / 8;
  static_assert(BM * BK / 4 == NT && BK * BN / 4 == NT, "one float4 of A and of B a thread");
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * (BN / 2);
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const size_t c2 = 2 * (size_t)C;
  const float* gb = gate + (size_t)b * T * C;
  const int n_chunks = C / BK;
  const int ar = tid >> 1, ak = (tid & 1) * 4;  // the thread's A float4: row, k
  const int bk = tid / (BN / 4), bn = tid % (BN / 4) * 4;  // and B float4
  const int bjp = j0 + bn % (BN / 2);
  const size_t bcol = bn < BN / 2 ? bjp : C + bjp;

  float4 ra;
  auto load_a = [&](int i) {
    ra = t0 + ar < T ? ld4(gb + (size_t)(t0 + ar) * C + i * BK + ak)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto copy_b = [&](float* bs, int i) {
    cp_async16(bs + tid * 4, bjp < C ? ow + ((size_t)i * BK + bk) * c2 + bcol : ow, bjp < C);
    cp_async_commit();
  };

  float acc[8][8] = {};
  run_chunks(
      n_chunks, [&](int buf, int i) { copy_b(Bs[buf], i); load_a(i); },
      [&](int buf, int) { put_a(As[buf], ar, ak, ra); },
      [&](int buf, int) { tile_fma<BN, 1>(As[buf], Bs[buf], ty * 8, tx * 4, acc); });

  const int jb = j0 + tx * 4;
  if (jb >= C) return;  // masked pairs
  const float4 obr = ld4(ob + jb), obs = ld4(ob + C + jb);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = t0 + ty * 8 + m;
    if (t >= T) break;
    const size_t i = ((size_t)b * T + t) * C + jb;
    const float4 xv = ld4(x + i);
    st4(x + i, make_float4((xv.x + (acc[m][0] + obr.x)) * RSQRT2,
                           (xv.y + (acc[m][1] + obr.y)) * RSQRT2,
                           (xv.z + (acc[m][2] + obr.z)) * RSQRT2,
                           (xv.w + (acc[m][3] + obr.w)) * RSQRT2));
    const float4 s = make_float4(acc[m][4] + obs.x, acc[m][5] + obs.y, acc[m][6] + obs.z,
                                 acc[m][7] + obs.w);
    float4 sv = s;
    if (!first) {
      const float4 o = ld4(skip + i);
      sv = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
    }
    st4(skip + i, make_float4(sv.x * skip_scale, sv.y * skip_scale, sv.z * skip_scale,
                              sv.w * skip_scale));
  }
}

// dz[b, t, l, (j, C+j)] from dgate[t, j] = sum_k do[t, k] W_o^T[k, j], k < 2C.
__global__ void __launch_bounds__(CH_NT, 4)
chain_gate_kernel(const float* __restrict__ dx, const float* __restrict__ g,
                  const float* __restrict__ zs, const float* __restrict__ owt,
                  float* __restrict__ dz, int T, int C, int L, int l, float inv_sqrt_l) {
  constexpr int BN = CH_BN, NT = CH_NT, NTX = BN / 8;
  constexpr int NA = BM * BK / 4 / NT;
  static_assert(BK * BN / 4 == NT, "one float4 of B a thread");
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const size_t row0 = (size_t)b * T;
  const int n_chunks = 2 * C / BK;
  const int bk = tid / (BN / 4), bn = tid % (BN / 4) * 4;

  // a chunk lies wholly in one half of do, since C % BK == 0
  float4 ra[NA];
  auto load_a = [&](int i) {
    const bool res = i * BK < C;
    const float* src = res ? dx : g;
    const int kc = res ? i * BK : i * BK - C;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, k = (e & 1) * 4;
      ra[s] = t0 + r < T ? ld4(src + (row0 + t0 + r) * C + kc + k)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](float* as, int i) {
    const float scale = i * BK < C ? RSQRT2 : inv_sqrt_l;
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT;
      const float4 v = ra[s];
      put_a(as, e >> 1, (e & 1) * 4,
            make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale));
    }
  };
  auto copy_b = [&](float* bs, int i) {
    cp_async16(bs + tid * 4, owt + ((size_t)i * BK + bk) * C + j0 + bn, true);
    cp_async_commit();
  };

  float acc[8][8] = {};
  run_chunks(
      n_chunks, [&](int buf, int i) { copy_b(Bs[buf], i); load_a(i); },
      [&](int buf, int i) { store_a(As[buf], i); },
      [&](int buf, int) { tile_fma<BN, 1>(As[buf], Bs[buf], ty * 8, tx * 4, acc); });

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = t0 + ty * 8 + m;
    if (t >= T) break;
    const float* zrow = zs + (row0 + t) * 2 * C;
    float* dzrow = dz + ((row0 + t) * L + l) * 2 * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * (BN / 2) + tx * 4;
      const float4 zg = ld4(zrow + j), zf = ld4(zrow + C + j);
      const float zgv[4] = {zg.x, zg.y, zg.z, zg.w}, zfv[4] = {zf.x, zf.y, zf.z, zf.w};
      float dg[4], df[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float a = sigmoid(zgv[n]);
        const float tb = tanhf(zfv[n]);
        const float d = acc[m][h * 4 + n];
        dg[n] = d * tb * a * (1.f - a);
        df[n] = d * a * (1.f - tb * tb);
      }
      st4(dzrow + j, make_float4(dg[0], dg[1], dg[2], dg[3]));
      st4(dzrow + C + j, make_float4(df[0], df[1], df[2], df[3]));
    }
  }
}

// dy[b, t, c] = sum_q sum_d dz[b, t+1-q, l, d] W_d[q]^T[d, c];  dx = dx / sqrt(2) + dy.
// The A tile's row r holds dz at frame t0 - 1 + r; staged tap p is W_d[2 - p]^T,
// read at row m + p (frame t0 + m - 1 + p = t + 1 - q).
__global__ void __launch_bounds__(CH_NT, 3)
chain_dy_kernel(const float* __restrict__ dz, const float* __restrict__ dwt,
                float* __restrict__ dx, float* __restrict__ dy, int T, int C, int L, int l) {
  constexpr int BN = CH_BN, NT = CH_NT, NTX = BN / 8;
  constexpr int NA = ceil_div((BM + 2) * BK / 4, NT);
  static_assert(3 * BK * BN / 4 == 3 * NT, "three float4s of B a thread");
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][3 * BK * BN];
  const int b = blockIdx.z, t0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const size_t row0 = (size_t)b * T, c2 = 2 * (size_t)C;
  const int n_chunks = 2 * C / BK;

  float4 ra[NA];
  auto load_a = [&](int i) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT, r = e >> 1, k = (e & 1) * 4, t = t0 - 1 + r;
      ra[s] = r < BM + 2 && t >= 0 && t < T
                  ? ld4(dz + ((row0 + t) * L + l) * c2 + i * BK + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](float* as) {
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      const int e = tid + s * NT;
      if (e >> 1 < BM + 2) put_a(as, e >> 1, (e & 1) * 4, ra[s]);
    }
  };
  auto copy_b = [&](float* bs, int i) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int f = tid + s * NT;  // float4 (p, k, n/4) of [3][BK][BN]
      const int p = f / (BK * BN / 4), k = f / (BN / 4) % BK, n = f % (BN / 4) * 4;
      cp_async16(bs + f * 4, dwt + ((size_t)(2 - p) * c2 + i * BK + k) * C + j0 + n, true);
    }
    cp_async_commit();
  };

  float acc[8][8] = {};
  run_chunks(
      n_chunks, [&](int buf, int i) { copy_b(Bs[buf], i); load_a(i); },
      [&](int buf, int) { store_a(As[buf]); },
      [&](int buf, int) { tile_fma<BN, 3>(As[buf], Bs[buf], ty * 8, tx * 4, acc); });

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = t0 + ty * 8 + m;
    if (t >= T) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t i = (row0 + t) * C + j0 + h * (BN / 2) + tx * 4;
      const float4 v = make_float4(acc[m][h * 4], acc[m][h * 4 + 1], acc[m][h * 4 + 2],
                                   acc[m][h * 4 + 3]);
      const float4 d = ld4(dx + i);
      st4(dy + i, v);
      st4(dx + i, make_float4(d.x * RSQRT2 + v.x, d.y * RSQRT2 + v.y, d.z * RSQRT2 + v.z,
                              d.w * RSQRT2 + v.w));
    }
  }
}

}  // namespace

// The residual stack that also saves xs [L,B,T,C] (each layer's input) and zs
// [L,B,T,2C] (each layer's pre-gate). Other arguments as
// wavenet_residual_stack (wavenet_stack.cu): x [B,T,C] in: x0, out: the last
// layer's residual; skip [B,T,C] out: skip / sqrt(L); gate [B,T,C] and sp
// [L,B,C] scratch. Needs C % 32 == 0 and H % 32 == 0. 1 + 2L launches on
// `stream`; returns the first launch error (cudaError_t) or 0.
extern "C" int wavenet_stack_save_forward(
    float* x, float* skip, float* gate, float* sp, float* xs, float* zs,
    const float* cond, const float* step, const float* dw, const float* db,
    const float* diffw, const float* diffb, const float* cw, const float* cb,
    const float* ow, const float* ob, int B, int T, int C, int H, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % 32 != 0 || H % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = wavenet::launch_step_proj(step, diffw, diffb, sp, B, C, L, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(C, FWD_BN / 2), ceil_div(T, BM), B);
  const float last_scale = (float)(1.0 / sqrt((double)L));
  for (int l = 0; l < L; ++l) {
    save_gate_kernel<<<grid, FWD_NT, 0, stream>>>(
        x, sp + (size_t)l * B * C, cond, dw + (size_t)l * 3 * C * 2 * C, db + (size_t)l * 2 * C,
        cw + (size_t)l * H * 2 * C, cb + (size_t)l * 2 * C, gate, xs + (size_t)l * B * T * C,
        zs + (size_t)l * B * T * 2 * C, T, C, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    save_out_kernel<<<grid, FWD_NT, 0, stream>>>(
        gate, ow + (size_t)l * C * 2 * C, ob + (size_t)l * 2 * C, x, skip, T, C, l == 0,
        l == L - 1 ? last_scale : 1.f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The top-down chain. zs [L,B,T,2C] from the save-forward; g [B,T,C] the
// cotangent of skip/sqrt(L); dwt [L,3,2C,C] and owt [L,2C,C] the transposed
// W_d and W_o; dx [B,T,C] zeroed by the caller, out: dL/dx0; dz [B,T,L,2C]
// and dy [L,B,T,C] out. Needs C % 64 == 0. 2L launches on `stream`; returns
// the first launch error (cudaError_t) or 0.
extern "C" int wavenet_stack_backward_chain(
    const float* zs, const float* g, const float* dwt, const float* owt, float* dx,
    float* dz, float* dy, int B, int T, int C, int L, void* stream_ptr) {
  if (B < 1 || T < 1 || L < 1 || C % CH_BN != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(C / CH_BN, ceil_div(T, BM), B);
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  for (int l = L - 1; l >= 0; --l) {
    chain_gate_kernel<<<grid, CH_NT, 0, stream>>>(
        dx, g, zs + (size_t)l * B * T * 2 * C, owt + (size_t)l * 2 * C * C, dz, T, C, L, l,
        inv_sqrt_l);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chain_dy_kernel<<<grid, CH_NT, 0, stream>>>(
        dz, dwt + (size_t)l * 3 * 2 * C * C, dx, dy + (size_t)l * B * T * C, T, C, L, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
