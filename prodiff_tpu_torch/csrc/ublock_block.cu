// One whole FastDiff LVC block (all its layers) in one launch, for Hopper.
//
// Replaces the Pallas TPU kernel ublock_block_packed
// (prodiff_tpu/ops/pallas/ublock.py:583). On x, audio_down [B, T, 32], the
// block is out = layer_{n-1}( ... layer_0(x)), each layer being ublock.cu's
// (K4's) function with conv dilation d_i:
//   xa  = x + audio_down
//   y   = leaky_0.2(conv3_d(leaky_0.2(xa)) + conv_bias)   (SAME zero padding)
//   y   = LVC(y): per hop window l, bias[l] + taps(y) . K[l]  ([hop, 96] x [96, 64])
//   out = xa + sigmoid(y[:, :32]) * tanh(y[:, 32:])
// with layer i's window kernels read in place from the hoisted KernelPredictor
// stack [N, B, L, layers*96, 64] at (step, i).
//
// What bounds it on the H100: float32 FMA throughput, as for K4. Per row and
// layer 18,432 FLOP of useful work. The LJSpeech net at T_mel = 512: block 1
// (hop 64, T = 32,768) 2.42 GFLOP = 36 us at the 67 TFLOP/s FP32 peak against
// 63 MB = 19 us at 3.35 TB/s; block 2 (hop 256, T = 131,072) 9.66 GFLOP =
// 144 us against 101 MB = 30 us. What K7 saves over four K4 launches is the
// activations' round trips through device memory between layers (x and
// audio_down are read once, out written once a block); what it pays is the
// recomputed halo below.
//
// Design: the TPU kernel walks a lane-packed [T/4, 128] layout with
// block-diagonal window kernels; none of that carries over. Here one block of
// 256 threads owns one hop window (R = hop rows, window l) and runs every
// layer on it in shared memory:
//   1. stage x and audio_down for the rows t0 - A0 .. t0 + R + A0 (zero
//      outside [0, T)), where A_n = 0 and A_i = A_{i+1} + d_i + 1 is the halo
//      layers i.. consume (dilations 1, 3, 9, 27: A = 44, 42, 38, 28, 0);
//   2. per layer i: stage the conv weight (12 KB) and window l's kernel
//      (24 KB); xa := x + audio_down over +-A_i; the conv with leaky on the way
//      in, for the rows +-(A_{i+1} + 1), then y := 0 outside [0, T) (the LVC's
//      taps are zero there; the conv of the zero padding is leaky(bias), not
//      zero); the window product + gate + residual for the rows +-A_{i+1},
//      written over xa in place (each element is read and written by one
//      thread); out-of-sequence rows := 0 so the next layer's conv sees SAME
//      zero padding; the last layer writes its R rows to `out`.
// The halo rows lie in windows l-1 and l+1 (the gate needs A_1 <= hop); their
// kernels are read from device memory (L2: the neighbouring blocks stage them)
// rather than staged, and at a sequence end those rows are set to 0, never
// computed from a clamped window. Recompute: a layer computes R + 2 A_{i+1}
// rows for R useful, +21% at hop 256 and +84% at hop 64 over the block.
// Shared memory: 173 KB at hop 256 (1 block per SM), 97 KB at hop 64 (2).

#include "lvc_window.cuh"

using namespace lvcw;

namespace {

constexpr float SLOPE = 0.2f;
constexpr int CONV_ROWS = 4;    // conv rows per thread per pass (32 * 4 rows a pass)
constexpr int MAX_LAYERS = 8;   // ops/ublock.py:MONO_MAX_LAYERS

struct Margins {
  int n;                       // layers
  int dil[MAX_LAYERS];
  int A[MAX_LAYERS + 1];
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : SLOPE * v; }

__device__ __forceinline__ float gate(float xa, float g, float f) {
  return xa + tanhf(f) / (1.f + expf(-g));
}

template <int M>
__global__ void __launch_bounds__(NT)
ublock_block_kernel(const float* __restrict__ x, const float* __restrict__ ad,
                    const float* __restrict__ cw, const float* __restrict__ cb, Stack s,
                    float* __restrict__ out, int T, int hop, Margins mg) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, l = blockIdx.x, tid = threadIdx.x;
  const int R = hop, t0 = l * hop, a0 = mg.A[0], rows = R + 2 * a0;
  float* Ks = smem;                 // [KC][CO], window l of the current layer
  float* lbs = Ks + KC * CO;        // [CO]
  float* Ws = lbs + CO;             // [3][C][C]: tap q, in ci, out co
  float* cbs = Ws + 3 * C * C;      // [C]
  float* xs = cbs + C;              // [rows][LD], row r = time t0 - a0 + r
  float* ads = xs + rows * LD;      // [rows][LD], same rows
  float* ys = ads + rows * LD;      // [R + 2 A_1 + 2][LD]; row j = time t0 - a_out - 1 + j

  const size_t off = (size_t)b * T * C;
  for (int i = tid; i < rows * C; i += NT) {
    const int r = i / C, c = i % C, t = t0 - a0 + r;
    const bool inside = t >= 0 && t < T;
    xs[r * LD + c] = inside ? x[off + (size_t)t * C + c] : 0.f;
    ads[r * LD + c] = inside ? ad[off + (size_t)t * C + c] : 0.f;
  }

  const int rg = tid / 8, pg = tid % 8;
  const float4* W4 = reinterpret_cast<const float4*>(Ws);
  for (int layer = 0; layer < mg.n; ++layer) {
    const int a_in = mg.A[layer], a_out = mg.A[layer + 1], dil = mg.dil[layer];
    const int r_in = a0 - a_in, r_out = a0 - a_out;
    Stack sl = s;
    sl.layer = layer;
    __syncthreads();  // the previous layer is done with Ks, Ws, xs and ys
    stage_windows(sl, b, l, 1, Ks, lbs, tid);
    const float* cwl = cw + (size_t)layer * C * C * 3;
    for (int i = tid; i < 3 * C * C; i += NT) {  // torch Conv1d weight [co][ci][q]
      const int q = i / (C * C), ci = (i / C) % C, co = i % C;
      Ws[i] = cwl[(co * C + ci) * 3 + q];
    }
    if (tid < C) cbs[tid] = cb[layer * C + tid];
    for (int i = tid; i < (R + 2 * a_in) * C; i += NT) {  // xa = x + audio_down
      const int r = r_in + i / C, c = i % C;
      xs[r * LD + c] += ads[r * LD + c];
    }
    __syncthreads();

    // conv: ys row j (time t0 - a_out - 1 + j); tap q reads xs row j + r_in + q * dil
    const int ny = R + 2 * a_out + 2;
    for (int base = 0; base < ny; base += 32 * CONV_ROWS) {
      float acc[CONV_ROWS][4];
      int rws[CONV_ROWS];
#pragma unroll
      for (int mm = 0; mm < CONV_ROWS; ++mm) {
        rws[mm] = min(base + rg + 32 * mm, ny - 1);  // past the end: recompute the last row
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[mm][p] = cbs[4 * pg + p];
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll 4
        for (int ci = 0; ci < C; ++ci) {
          const float4 w = W4[(q * C + ci) * (C / 4) + pg];
#pragma unroll
          for (int mm = 0; mm < CONV_ROWS; ++mm) {
            const float v = leaky(xs[(rws[mm] + r_in + q * dil) * LD + ci]);
            acc[mm][0] = fmaf(v, w.x, acc[mm][0]);
            acc[mm][1] = fmaf(v, w.y, acc[mm][1]);
            acc[mm][2] = fmaf(v, w.z, acc[mm][2]);
            acc[mm][3] = fmaf(v, w.w, acc[mm][3]);
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < CONV_ROWS; ++mm) {
        const int j = base + rg + 32 * mm;
        if (j >= ny) continue;
        const int t = t0 - a_out - 1 + j;
        const bool inside = t >= 0 && t < T;
#pragma unroll
        for (int p = 0; p < 4; ++p) ys[j * LD + 4 * pg + p] = inside ? leaky(acc[mm][p]) : 0.f;
      }
    }
    __syncthreads();

    // window product + gate + residual. Output row k (time t0 - a_out + k)
    // reads ys rows k .. k + 2 and xa at xs row r_out + k.
    const bool last = layer == mg.n - 1;
    for (int cr = 0; cr < R; cr += 32 * M) {  // window l's rows, staged kernel
      const int k0 = a_out + cr + rg * M;
      float ag[M][4], af[M][4];
      window_rows<M>(ys, Ks, lbs, 0, k0, pg, ag, af);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float* xa = xs + (r_out + k0 + m) * LD + 4 * pg;
        float o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) o[p] = gate(xa[p], ag[m][p], af[m][p]);
        if (last) {
          reinterpret_cast<float4*>(out + off + (size_t)(t0 + cr + rg * M + m) * C)[pg] =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) xa[p] = o[p];
        }
      }
    }
    for (int k = rg; k < 2 * a_out; k += 32) {  // halo rows: windows l - 1 and l + 1
      const bool left = k < a_out;
      const int kk = left ? k : R + k, lw = left ? l - 1 : l + 1;
      float* xa = xs + (r_out + kk) * LD + 4 * pg;
      if (lw < 0 || lw >= s.L) {  // outside the sequence: zero for the next layer's conv
#pragma unroll
        for (int p = 0; p < 4; ++p) xa[p] = 0.f;
        continue;
      }
      float ag[1][4], af[1][4];
      window_rows<1>(ys, sl.kernel(b, lw), sl.bias(b, lw), 0, kk, pg, ag, af);
#pragma unroll
      for (int p = 0; p < 4; ++p) xa[p] = gate(xa[p], ag[0][p], af[0][p]);
    }
  }
}

template <int M>
int launch(const float* x, const float* ad, const float* cw, const float* cb, const Stack& s,
           float* out, int T, int hop, const Margins& mg, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ublock_block_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ublock_block_kernel<M><<<dim3(s.L, s.B), NT, smem, stream>>>(x, ad, cw, cb, s, out, T, hop, mg);
  return (int)cudaGetLastError();
}

}  // namespace

// x, ad [B, T, 32]; cw [n, 32, 32, 3] (torch Conv1d layout per layer), cb [n, 32];
// km [N, B, L, n*96, 64], lb [N, B, L, n*64]; dil [n]; out [B, T, 32], distinct
// from x and ad. Runs the n layers of the block at stack step `step`. One
// launch on `stream`; returns the launch error (cudaError_t) or 0.
extern "C" int ublock_block_forward(const float* x, const float* ad, const float* cw,
                                    const float* cb, const float* km, const float* lb,
                                    float* out, const int* dil, int n, int B, int T, int L,
                                    int hop, int layers, int step, void* stream_ptr) {
  if (n < 1 || n > MAX_LAYERS || layers != n || B < 1 || L < 1 || hop < 64 || hop % 32 ||
      T != L * hop || step < 0)
    return (int)cudaErrorInvalidValue;
  Margins mg{};
  mg.n = n;
  mg.A[n] = 0;
  for (int i = n - 1; i >= 0; --i) {
    if (dil[i] < 1) return (int)cudaErrorInvalidValue;
    mg.dil[i] = dil[i];
    mg.A[i] = mg.A[i + 1] + dil[i] + 1;
  }
  if (mg.A[1] > hop) return (int)cudaErrorInvalidValue;  // halo beyond one neighbouring window
  const size_t smem = sizeof(float) * ((size_t)KC * CO + CO + 3 * C * C + C +
                                       (size_t)2 * (hop + 2 * mg.A[0]) * LD +
                                       (size_t)(hop + 2 * mg.A[1] + 2) * LD);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Stack s{km, lb, B, L, layers, step, 0};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (rows_per_thread(hop)) {
    case 8: return launch<8>(x, ad, cw, cb, s, out, T, hop, mg, smem, stream);
    case 4: return launch<4>(x, ad, cw, cb, s, out, T, hop, mg, smem, stream);
    case 2: return launch<2>(x, ad, cw, cb, s, out, T, hop, mg, smem, stream);
    default: return launch<1>(x, ad, cw, cb, s, out, T, hop, mg, smem, stream);
  }
}
