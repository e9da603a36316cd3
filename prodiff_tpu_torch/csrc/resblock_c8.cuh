// The C = 8 ResBlock stage in one launch: the block plan and the stage's
// description that csrc/resblock.cu (float32 taps) and
// csrc/resblock_bf16.cu (bf16 taps) share. ops/resblock.py:c8_plan mirrors
// plan_stage; each library exports it (resblock_c8_plan,
// resblock_c8_plan_bf16) for the card test that holds the two equal.
//
// C = 8 is the last stage of a HiFiGAN that starts at 128 channels (V2),
// which the TPU kernel (prodiff_tpu/ops/pallas/resblock.py:357
// resblock_group_packed at pack 16) runs as one call: each grid step DMAs
// its rows and a halo, walks all the stage's convs on that tile in VMEM,
// re-zeroes the rows outside [0, T) after each conv and writes only the
// stage mean. Both kernels here do the same on Hopper. A block owns M
// output frames of one sequence; it loads x on [t0 - halo, t0 + M + halo)
// once (zeros outside [0, T)), runs the ResBlocks one after another from
// that tile, each conv on a row range that shrinks by its padding (conv1's
// rows on conv2's halo are recomputed, as the Pallas walk does), and writes
// its M frames of the mean. The halo is the largest ResBlock's reach, sum
// over its units of get_padding(k, d) + get_padding(k, 1): 60 frames a side
// for V2's (3, 7, 11) x (1, 3, 5) (stage_meta at p = 1, without its
// rounding to 8 rows).
//
// Rows of a block: tile row r is frame t0 - halo + r, r in [0, rows), rows
// = M + 2 halo, stored at r + GUARD in buffers of rows + 2 GUARD: a warp
// owns the 16-row tiles warp, warp + nwarps, ... (TILES of them; nwarps =
// ceil(rows / (16 TILES))), and a tile that meets a conv's row range is
// computed whole, so its reads reach up to 15 rows (plus the conv's
// padding) past the range; its rows outside the range are not stored. A
// frame keeps its thread from conv to conv, so the running h and the mean
// stay in registers.
#pragma once

#include <cuda_runtime.h>

namespace c8 {

constexpr int C = 8;
constexpr int TILES = 5;                            // 16-row tiles a warp
constexpr int MAX_WARPS = 16;
constexpr int MAX_ROWS = 16 * TILES * MAX_WARPS;    // 1280: M + 2 halo at most
constexpr int GUARD = 16;                           // rows a side past the tile
constexpr int MAX_UNITS = 512;
constexpr int MAX_PAD = 32;                         // get_padding(k, d) <= MAX_PAD
constexpr int MIN_BLOCKS = 128;                     // about one block an SM
constexpr int SMEM_LIMIT = 232448;                  // bytes a block may take
constexpr int N_CHOICES = 4;
constexpr int M_CHOICES[N_CHOICES] = {512, 256, 128, 64};

// Unit u of the stage: its kernel size, dilation, and whether it opens or
// closes its ResBlock, packed in one int (a kernel parameter).
struct Stage {
  int n_units, n_res, halo, M, rows, T, n_w, n_b;  // n_w taps, n_b biases (elements)
  int unit[MAX_UNITS];
};

__host__ __device__ inline int unit_k(int e) { return e & 0xff; }
__host__ __device__ inline int unit_d(int e) { return (e >> 8) & 0xff; }
__host__ __device__ inline bool unit_first(int e) { return (e >> 16) & 1; }
__host__ __device__ inline bool unit_last(int e) { return (e >> 17) & 1; }

struct Plan {
  int M, halo, rows, warps, smem, blocks;
};

// Bytes a block takes: `by.row` a row of its buffers (float32: x, the
// leaky'd h and conv1's output, 3 x 32; bf16: x as float32 and two bf16
// staging tiles, 32 + 2 x 16), the taps at `by.tap` an element and the
// float32 biases.
struct Bytes {
  int tap, row;
};
inline int smem_bytes(int rows, int n_w, int n_b, Bytes by) {
  return (rows + 2 * GUARD) * by.row + n_w * by.tap + n_b * 4;
}

// Fill `st` and `plan` for the stage (ksizes[j], nunits[j] units a ResBlock,
// their dilations in order) at B sequences of T frames: the largest M whose
// grid has at least MIN_BLOCKS blocks among those that fit (rows <=
// MAX_ROWS, shared memory <= SMEM_LIMIT), else the smallest that fits.
// Returns 0, or cudaErrorInvalidValue where the stage is not one the kernel
// takes or no M fits.
inline int plan_stage(Stage* st, Plan* plan, const int* ksizes, const int* nunits,
                      const int* dils, int n_res, int B, int T, Bytes by) {
  if (B < 1 || T < 1 || n_res < 1) return (int)cudaErrorInvalidValue;
  int n = 0, halo = 0, n_w = 0;
  for (int j = 0; j < n_res; ++j) {
    const int k = ksizes[j];
    if ((k != 3 && k != 7 && k != 11) || nunits[j] < 1) return (int)cudaErrorInvalidValue;
    int reach = 0;
    for (int u = 0; u < nunits[j]; ++u, ++n) {
      const int d = dils[n];
      if (n >= MAX_UNITS || d < 1 || (k - 1) / 2 * d > MAX_PAD) return (int)cudaErrorInvalidValue;
      reach += (k - 1) / 2 * d + (k - 1) / 2;
      st->unit[n] = k | d << 8 | (u == 0) << 16 | (u + 1 == nunits[j]) << 17;
      n_w += 2 * k * C * C;
    }
    if (reach > halo) halo = reach;
  }
  const int n_b = 2 * n * C;
  int pick = -1;
  for (int i = 0; i < N_CHOICES; ++i) {
    const int M = M_CHOICES[i], rows = M + 2 * halo;
    if (rows > MAX_ROWS || smem_bytes(rows, n_w, n_b, by) > SMEM_LIMIT) continue;
    pick = i;
    if ((long long)B * ((T + M - 1) / M) >= MIN_BLOCKS) break;
  }
  if (pick < 0) return (int)cudaErrorInvalidValue;
  const int M = M_CHOICES[pick], rows = M + 2 * halo;
  st->n_units = n;
  st->n_res = n_res;
  st->halo = halo;
  st->M = M;
  st->rows = rows;
  st->T = T;
  st->n_w = n_w;
  st->n_b = n_b;
  plan->M = M;
  plan->halo = halo;
  plan->rows = rows;
  plan->warps = (rows + 16 * TILES - 1) / (16 * TILES);
  plan->smem = smem_bytes(rows, n_w, n_b, by);
  plan->blocks = B * ((T + M - 1) / M);
  return 0;
}

// The plan as the libraries export it: out = {M, halo, rows, warps, smem,
// blocks}; returns plan_stage's error.
inline int export_plan(const int* ksizes, const int* nunits, const int* dils, int n_res, int B,
                       int T, Bytes by, int* out) {
  Stage st;
  Plan p{};
  const int err = plan_stage(&st, &p, ksizes, nunits, dils, n_res, B, T, by);
  if (err) return err;
  const int v[6] = {p.M, p.halo, p.rows, p.warps, p.smem, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // namespace c8
