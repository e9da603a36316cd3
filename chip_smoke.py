#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --fastdiff-kernels

The second form builds the kernels and runs only the FastDiff kernel phase
(K4, K6, K7 against their twins, timed, without the phase splits and K6's
extra hops) and prints its JSON. It imports ``prodiff_tpu_torch`` from the
script's own directory, so a copy of the script beside another checkout's
package times that version's kernels.

Phases, each printing its lines before the last:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from ``prodiff_tpu_torch/csrc`` (one nvcc per
     source, all started together), timed;
  3. each kernel vs its plain PyTorch twin on the card, in parity mode
     (float32, TF32 off), at the main paths' full-width shapes: error against
     the stated tolerance, CUDA-event times of both and the share of the
     computed bound (K1 at T=512, 640 and 2048; the resblock stage at each of
     the five stages of one T_mel=512 vocoder pass), and K1 (T=640) and the
     C=128 resblock stage replayed from a CUDA graph; the FastDiff layer
     kernels (K4 ``ublock_layer``, K6 ``lvc``) at every (block, layer) of the
     LJSpeech net at T_mel=512, reading a hoisted 4-step kernel stack, timed
     by replaying a CUDA graph of four calls (one a step: the wrappers'
     host time exceeds these kernels') with each block's time and bound,
     K4's split by phase (each block timed again with variants of
     ``ublock.cu`` built without the conv, without the window product, and
     without both: ``LVCT_SKIP``), K6's (variants of ``lvc.cu`` built
     without the window product, without the stores, and with the product
     alone: ``LVC_SKIP``),
     K6's library yardstick (``torch.baddbmm`` on a prebuilt tap tensor),
     K6 at hops 24, 40, 72 and 200 (B=2), K4 at the hops its contract
     gained, 24, 40, 48, 56, 72 and 80, and 68, 100 and 260 (split tiles)
     (B=2, L=512, timed a layer beside its bound), and the block kernel (K7
     ``ublock_block``) at blocks 1 and 2 of that net, timed so beside its
     twin and the chain of four K4 launches it replaces, and replayed from
     a CUDA graph at block 2;
  4. the slice at full width on seeded random weights: the base-config
     teacher (4 encoder layers, hidden 256, 20x256 WaveNet, 4 steps,
     voicing/breath embeds) and the default NSF-HiFiGAN generator behind the
     port's web server on 127.0.0.1; three /api/infer requests (~2, 4, 6 s of
     audio) with the kernel launch counts of that run, a bit-identity check of
     two deterministic renders, the split of the 6 s request (every part
     timed in that request), that request's render under torch.profiler (K1,
     the resblock stage, the other kernels, the device's idle share), and
     one short render held against the same weights on the CPU (the plain
     path, no kernels): the teacher's mel as it enters the vocoder, and the
     wav;
  5. the FastDiff text->wav path at full width on seeded random weights: the
     2-step teacher of ``__graft_entry__._flagship(n_mels=80)`` and FastDiff-4
     at FastDiff's LJSpeech config (22.05 kHz, hop 256), one render at
     T_mel=512 (131,072 samples) through ``get_vocoder_cls("fastdiff")`` with
     the launch counts of that render (K1 2 x 3, K4 4 steps x 3 blocks x 4
     layers), the same render with the unfused layer (``fastdiff_packed:
     false``: K6 48 times), the same render with ``MONO_BLOCK`` (K7 8 times on
     blocks 1 and 2, K4 16 on block 0; within 1e-4 of the layer route's
     peak), the vocoder alone by each route in turns and under
     torch.profiler (kernel time, K4's and K7's shares, the device's idle
     share), a bit-identity check of two renders on injected noise, a
     32-frame render held against the same weights on the CPU, and one
     forward at upsample ratios [5, 5, 4] (hops 5, 25, 100, none a multiple
     of 8) by each layer: the unfused layer's 12 window products counted on
     the matmul route, the fused layer's 8 (hops 5 and 25) and 4 K4
     launches (hop 100), held against the CPU;
  5b. ``python -m prodiff_tpu_torch vocode wav2wav`` (in-process,
     ``__main__.main``) at full width on seeded random vocoder checkpoints:
     NSF-HiFiGAN (the openvpi 44.1 kHz generator, base-config audio, ACF
     pitch) on a 6.0 s tone at keyshift 0 and +3 (K2/K3 90 launches a
     render), and FastDiff-4 (LJSpeech config and audio, ``MONO_BLOCK``) on
     a 512-frame tone (K7 8, K4 16); the time split of each run (load,
     wav2spec, get_pitch, spec2wav, save_wav), the card's mel and f0 held
     against the CPU's, and each written wav against the same command run on
     the CPU (FastDiff on a 32-frame tone, the same noise injected);
  3c. K5, the trainable WaveNet stack, vs its plain twins at the training
     shape (B=16, T=1536, L=20, C=H=256): the save-forward's skip/xs/zs, the
     backward chain's dz/dy/dx0, and the 11 gradients of the autograd
     Function (kernels + cuBLAS) vs autograd through the plain stack, with
     CUDA-event times of each part and the computed bounds;
  6. SVS teacher training at full width through ``python -m prodiff_tpu_torch
     train svs`` (in-process, ``__main__.main``) on the port's synthetic
     dataset at the JAX bench's input-pipeline scale (128 items of
     1,440-1,536 frames x 128 mels, B=16, T=1536): 8 steps with validation
     and checkpoints every 4, then a resumed run to step 10; per-step launch
     counts (K5 on every training step, K1 only in validation), finite
     losses, the checkpoints and their params read back, the median step
     time; then one training step on a short batch held against the same
     step on the CPU (loss, every gradient, the params after the update).
  7. the variance stack at full width on seeded random weights, each model
     written as a JAX-format checkpoint into a temporary experiment tree: the
     duration predictor (conv 512), the pitch predictor (WaveNet 20 x 256 at
     dilation cycle 5, repeat_bins 64, 20 euler steps of rectified flow), the
     voicing and breath predictors (WaveNet 20 x 256 on K1, voicing, breath
     and tension in 48 bins, 4 DDPM steps) and a ``diff_type: reflow``
     flagship teacher (20 euler steps on K1); ``infer --pred_dur --pred_pitch
     spk1 --pred_voicing --pred_breath`` (in-process) on ``samples/example.ds``
     with its note fields made consistent (``variance_project``), and the
     same project through ``SVSInferHandler.handle`` with the teacher read
     as ``diff_type: prodiff``, the K1 and resblock launch counts of each
     asserted; each predictor held against the CPU
     (same weights, injected noise; atol 1e-3 + rtol 1e-3) and timed (CUDA
     events, median of 5 after a warm-up); the reflow render and a predicted
     render under torch.profiler (K1, the other kernels, the idle share); the
     reflow teacher's mel held against the CPU; and the web server's
     /api/pred_dur, /api/pred_pitch and an /api/infer of what they predicted;
  8. the variance stack's training at full width: one training step of the
     dur (conv 512), pitch (WaveNet 20 x 256, cycle 5), vari (20 x 256 on K5)
     tasks and of a diff_type: reflow flagship teacher (``svs``, on K5) on a
     short batch (B=2, T_mel=128), held against the CPU (loss, every
     gradient, the params after one AdamW step; K5 on the vari and teacher
     steps only); then ``binarize dur|pitch`` and ``train dur|pitch|vari``
     (3 steps and one validation each, in-process CLI) on a synthetic corpus
     of seeded tones and seeded vari shards, the launch counts of that run
     (K5a 41 and K5b 40 a vari step, none on dur and pitch; K1 3 in vari's
     validation and 12 in the vari inferer), each trained checkpoint read by
     its inferer for one segment, the step times, and the vari trainer's
     step at the training cell's batch (B=16, T=1536) under torch.profiler
     (K5a, K5b, cuBLAS, the rest, the device's idle share).
  9. the data pipeline at full width on seeded RMVPE (``E2E0(4, 1, (2, 2))``,
     its output bias peaked at one bin) and VR (``CascadedNet`` at nout 32,
     nout_lstm 128, n_fft 2048, hop 512) checkpoints, written where the base
     config's ``pe_ckpt``/``vr_ckpt``/``vocoder_ckpt`` point, in a temporary
     directory: ``preprocess`` of a TextGrid corpus (8 seeded 2-6 s tones at
     44.1 kHz), ``binarize svs`` with RMVPE and the VR model's voicing,
     breath and tension, ``train svs`` 2 steps on those shards (K5 41 + 40 a
     step), ``binarize svs_rectified`` with that flagship teacher (K1 12 an
     item), ``vocode wav2wav`` under the base config's ``pitch_extractor:
     rmvpe`` (K2/K3 90 a render), ``infer --isolate_aspiration
     --isolate_base_harmonic`` of ``samples/example.ds`` and ``/api/infer``
     with the VR gain (K1 12 and K2/K3 90 a render); each step's launches
     asserted, the shortest item's mel, f0, salience, harmonic part, voicing,
     breath and tension and the written wavs held against the CPU, RMVPE and
     VR timed by CUDA events, one binarized item under torch.profiler.
 10. distillation on the data pipeline's tree (its teacher trained 2 steps
     and its ``svs_rectified`` shards): ``train svs_rectified`` 3 steps with
     ``async_save`` (K5 41 + 40 a step, K1 in its validation), one student
     step held against the CPU (loss and every gradient within 1e-4 of each
     peak) and the step under torch.profiler, ``merge_rectified`` (the merged
     ``diffusion`` equal to the student's), ``infer`` of
     ``samples/example.ds`` from the merged teacher at ``timesteps: 1`` (K1
     3 and K2/K3 90 a batch; its mel held against the CPU),
     ``SVSTask.infer_mels`` on the card vs the CPU (injected noise), ``train
     svs`` resumed from an optax-layout checkpoint vs an unbroken run under
     deterministic algorithms (within 1e-5 of each tensor's peak), and
     ``train svs`` with ``profile_steps: 2`` (the trace names K5's kernels).
     Every kernel's entry of the JSON line gains ``launches_distillation``.
 13. (``phase_bf16``) the teacher's bf16 policy, then parity mode again: the
     bf16 variants of K1, K5a and K5b (``csrc/*_bf16.cu``, tensor-core
     wgmma) against their twins at the table's shapes (K1 at B=1, T=512,
     640 and 2048; K5 at B=16, T=1536), timed beside the float32 kernels,
     each with its bound at the bf16 dense rate (with ``--parent``: K5a/K5b-
     bf16 also at vari's H=128, in turns with the earlier design, both
     split by kernel, beside the same products as bf16 ``torch.matmul``
     calls); ``train svs`` with ``bf16: true`` by the CLI (K5a-bf16 22 and
     K5b-bf16 21 launches a step, ``ops/wavenet_train.py:train_launches``; its
     median step beside a float32 run's on the same items), ``train
     svs_rectified --precision fast`` and a ``train svs`` step with ``amp:
     true``; one bf16 teacher step against the same step on the CPU, which
     takes the card's route through the kernels' twins; a
     ``--precision fast`` render of ``samples/example.ds`` by the CLI (K1-bf16
     only) and its mel against the parity render's, and ``/api/infer`` in
     fast mode; the 250-step float32-vs-bf16 convergence check on the card
     (``tests/test_torch_bf16_convergence.py``, residual channels 64, the
     narrowest the kernels take). The bf16 entries of the JSON line carry
     the launches of this phase's main paths. The fast render also runs
     NSF-HiFiGAN with bf16 tap stacks (K2/K3-bf16, 45 launches a batch, no
     float32 K2/K3); its wav is held against the parity render's, and the
     fast vocoder alone against the float32 one on the parity mel, at the
     JAX package's bound for bf16 tap stacks (max |diff| < 0.05,
     correlation > 0.999); ``/api/infer`` in fast mode launches K1-bf16 and
     K2/K3-bf16 only.
 14. (``phase_bf16_vocoders``) the serving vocoders' bf16: K2/K3-bf16
     (``csrc/resblock_bf16.cu``, tensor-core mma.sync) at the five stages of
     a T_mel=512 pass, K4-bf16 and K7-bf16 (the bf16-window builds of
     ``ublock.cu`` and ``ublock_block.cu``, their window product on the
     tensor cores) at the LJSpeech hops 8, 64 and 256, each against its twin
     and timed beside its float32 kernel with two bounds (the FP32 rate's,
     and ``mma_bound``: their product's three bf16 terms at the tensor
     cores' rate, the conv at the FP32 rate); K4-bf16 per block also built
     without the conv / the window product (``LVCT_SKIP``), on wide-range
     activations (1e-3 .. 1e2) against the twin and, with a seeded bf16
     KernelPredictor's windows, against float64, K4-bf16 at hops 24-80 and
     the split tiles 68, 100, 260 (with ``--parent``: the earlier K4/K7
     builds in turns, both window dtypes);
     the FastDiff text->wav path in fast mode by each route (layer:
     K4-bf16 48; ``MONO_BLOCK``: K7-bf16 8 and K4-bf16 16; unfused: the
     float32 K6 48, as the JAX package gives ``lvc_pallas`` no bf16
     windows), and the fast FastDiff vocoder against the parity one on one
     mel and injected noise (2e-2 of the wav's peak).
 15. (``phase_other_vocoders``) the other vocoders: K2 and K2-bf16 at C = 8
     (HiFi-GAN V2's last stage at T_mel=512, T=131,072: the whole stage in
     one launch; the bf16 build pairs two taps in each k16 step) against the
     twin, timed as the kernel alone (a CUDA graph) and eagerly, K2/K3 at
     every stage of HiFi-GAN V1 and V2 in both tap dtypes, timed with their
     bounds (with ``--parent``: the earlier version's in turns); then
     ``vocode wav2wav`` (in-process) on a 6.0 s tone at the LJSpeech audio
     settings with ACF pitch through HiFi-GAN V1, V2, V3 (ResBlock2), V1
     with its NSF source and Parallel WaveGAN (parallel_wavegan.v1) in
     parity mode, and V1 and V2 in fast mode, on seeded checkpoints in the
     three layouts the wrappers read, the random draws injected: each
     render's launches (K2/K3 72 for V1, 55 for V2, 1 of V2's at C = 8;
     none for V3 and PWG; in fast mode K2/K3-bf16 36 for V1 and 28 for V2,
     1 of them at C = 8), host clock, kernel time and idle share
     (torch.profiler), each parity render held against the CPU on a
     32-frame tone, fast against parity at the bound for bf16 tap stacks.
 16. (``phase_multi_gpu``) multi-GPU training on the one card, the training
     cell's config (the flagship teacher, 20 x 256 WaveNet), dropout off in
     parts (a)-(c) and on in (e), and the denoiser's output projection
     seeded, on a seeded synthetic set
     of 48 items (three global batches of B=16, T=1536): (a) data parallel,
     two spawned ranks over gloo (NCCL refuses two ranks on one device),
     both on cuda:0, 8 rows each loaded per process: 3 steps (K5a 41 + K5b
     40 launches a rank a step, K1 3 for a validation batch), step 1's total
     loss and gradient norm within 1e-5 relative of the one-process
     trainer's on the same card and global batches and its reduced
     gradients, and every parameter after 3 steps, within 1e-4 of each
     tensor's peak, each tensor's 3-step update within 1e-3 of the
     one-process update's norm, rank 0's checkpoint restored by the
     one-process trainer;
     (b) ``model_parallel: 2`` on the same two ranks (the denoiser 128
     channels a rank, the encoder one head a rank, no kernel: torch.matmul
     as the JAX TP route): one forward's x0 prediction within 1e-4 of its
     peak, step 1's gathered gradients within 1e-3 of each tensor's peak of
     the one-process step on the plain route (the module loop, no K5; a
     different summation order end to end, as the card against the CPU),
     steps 1 and 2's total loss and gradient norm within 1e-4 relative of
     the plain route's, each tensor's 2-step update within 1e-3 of the plain
     route's update's norm (a rank that left a tensor unchanged reads 1), the gathered
     checkpoint the one-process layout key for key; every run of the phase
     under deterministic algorithms; (c) NCCL, the
     default backend under torchrun's environment, as a world of one: one
     step within 1e-6 relative of the one-process step, and an NCCL
     all-reduce of the gradient bucket; (d) sequence parallelism of the
     base config's denoiser (128 mel bins, hidden 256, 20 x 256, cycle 1,
     seeded weights) on the same two ranks (``WaveNet(sp=Mesh.sp)``: each
     rank its block of frames and a 20-frame halo exchanged point to
     point): the gathered forward at B=1, T=8,192 and at T=8,191 (uneven
     blocks) within 1e-4 of the output's peak of the one-process K1 forward
     and of its plain twin on the card, and at B=2, T=2,048 the gradients of
     ``sum(out * probe)`` (every parameter, summed over the ranks, and the
     gathered spec and cond) within 1e-4 of each tensor's peak of the
     one-process K5 route; each rank's K1 launches for one forward of its
     window and K5a + K5b for one backward, as ``stack_launches`` and
     ``train_launches`` count them there; each rank's window, the halo
     exchange's time and K1's on its window printed; (e) dropout on, at the
     cell's rate 0.1: two data-parallel steps of the two ranks (K5a 41 + K5b
     40 launches a rank a step) and two ``model_parallel: 2`` steps, each
     against the one-process steps on the same card and global batches with
     dropout 0.1 (the K5 route, and part (b)'s plain route): every mask a
     rank drew is its rows and, on the FFN's split hidden, its columns of
     the one-process step's, exactly, and part (b)'s bounds hold (each
     step's total loss and gradient norm within 1e-4 relative, step 1's
     gradients within 1e-3 of each tensor's peak, each tensor's two-step
     update within 1e-3 of the one-process update's norm: step 1 alone runs
     at the schedule's floor rate, where Adam's update is about lr *
     sign(g)); the ranks' and the one-process steps' dropout draws timed
     (CUDA events) beside each step, with the numbers a rank draws at the
     global shape against those it keeps. The per-rank step
     times (CUDA events) are printed beside the card's name and power
     limit, as two ranks sharing one card, not a scaling figure. The K1/K5
     entries of the JSON line gain the per-rank launches of this phase.
Each path runs with every launch count set to 0 just before it and read just
after; a kernel of the path that did not launch, or one off the path that
did, fails the run. The second-to-last line is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit, no
result line). There is no CPU mode: without a CUDA card the script exits
non-zero before printing anything.
"""

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 1234
# base config (prodiff_tpu/assets/base_config.yaml) keys the slice reads
BASE_HPARAMS = {
    "seed": SEED,
    "audio_num_mel_bins": 128,
    "audio_sample_rate": 44100,
    "hop_size": 512,
    "win_size": 2048,
    "fft_size": 2048,
    "fmin": 40,
    "fmax": 16000,
    "length_bucket_step": 128,
    "dropout": 0.1,
    "enc_layers": 4,
    "hidden_size": 256,
    "num_heads": 2,
    "enc_ffn_kernel_size": 9,
    "use_dur_embed": True,
    "use_voicing_embed": True,
    "use_breath_embed": True,
    "use_spk_id": True,
    "use_lang_id": True,
    "use_gender_id": False,
    "diff_type": "prodiff",
    "max_beta": 40,
    "timesteps": 4,
    "schedule_type": "vpsde",
    "timescale": 1000,
    "dilation_cycle_length": 1,
    "residual_layers": 20,
    "residual_channels": 256,
    "vocoder": "nsfhifigan",
}
SLICE_HPARAMS = dict(BASE_HPARAMS, num_spk=2, languages={"zh": 1},
                     precompile_buckets=[[64, 1024]])
# the openvpi 44.1 kHz NSF-HiFiGAN release's config.json (the Generator defaults)
VOCODER_H = {"num_mels": 128, "sampling_rate": 44100, "upsample_initial_channel": 512,
             "upsample_rates": [8, 8, 2, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4, 4],
             "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5]] * 3}
SPEAKERS = {"spk0": 0, "spk1": 1}
PHONES = ["SP", "AP"] + [f"p{i}" for i in range(60)]
PHONE_SET = {f"{p}/zh": p for p in PHONES}
REQUEST_SECONDS = (2.0, 4.0, 6.0)
K1_SHAPES = ((1, 512), (1, 640), (1, 2048))  # (B, T) at L=20, C=256, H=256; 640: a 6 s request
RES_STAGES = ((256, 4096), (128, 32768), (64, 65536), (32, 131072), (16, 262144))  # T_mel=512
RES_K, RES_D = (3, 7, 11), ((1, 3, 5),) * 3
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)  # float32 both sides; only the sum order differs
CPU_TOL = 1e-3  # card vs CPU render (mel and wav), relative to each one's peak (see phase 4)
# the H100 SXM's published float32 (non-tensor-core) peak and HBM rate, at 700 W:
# bound_ms is the larger of operations / FP32_PEAK and bytes / HBM_RATE
FP32_PEAK, HBM_RATE = 67e12, 3.35e12

# FastDiff text->wav (bench.py's e2e_fastdiff cell): __graft_entry__._flagship(n_mels=80)
FD_TEACHER_HPARAMS = dict(BASE_HPARAMS, num_spk=4, languages={"zh": 1, "jp": 2},
                          use_voicing_embed=False, use_breath_embed=False,
                          audio_num_mel_bins=80)
# FastDiff's LJSpeech config (Huang et al., IJCAI 2022; the JAX FastDiff defaults)
FD_CONFIG = {
    "audio_channels": 1, "inner_channels": 32, "cond_channels": 80,
    "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 4, "lvc_kernel_size": 3,
    "kpnet_hidden_channels": 64, "kpnet_conv_size": 3, "diffusion_step_embed_dim_in": 128,
    "diffusion_step_embed_dim_mid": 512, "diffusion_step_embed_dim_out": 512,
    "beta_0": 1e-6, "beta_T": 0.01, "T": 1000,
}
FD_T_MEL, FD_T_PH, FD_TEACHER_STEPS, FD_STEPS = 512, 16, 2, 4
FD_HOPS = (8, 64, 256)  # the LVC blocks' windows at 22.05 kHz / hop 256
FD_CPU_FRAMES = 32
# the JAX bench's real-input-pipeline train cell (bench.py:560-633)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_VAL_EVERY = 16, 1536, 10, 8, 4
TRAIN_HPARAMS = dict(
    audio_num_mel_bins=128, hidden_size=256, enc_layers=4, num_heads=2, residual_layers=20,
    residual_channels=256, max_frames=2000, max_tokens=TRAIN_B * TRAIN_T,
    max_sentences=TRAIN_B, batch_size_buckets=[TRAIN_B], length_bucket_step=128,
    mel_loss="l1:0.5|ssim:0.5", clip_grad_norm=1, val_check_interval=TRAIN_VAL_EVERY,
    tb_log_interval=1, num_sanity_val_steps=1, print_nan_grads=True, max_valid_sentences=1,
)
TRAIN_N_VALID = 2  # validation items: one batch each
# K5's gradients sum B*T frame products: held at 1e-4 of each one's peak;
# the card's training step vs the CPU's at 1e-3 of each gradient's peak
# (the CPU runs the plain module loop, a different summation order end to end)
GRAD_TOL, STEP_TOL = 1e-4, 1e-3
K1_LAUNCHES = 3  # a float32 stack: step projection, cond GEMM, the cooperative layer chain
RES_LAUNCHES, RES_BF16_LAUNCHES = 18, 9  # a T_mel stage: a launch a conv (float32), a unit (bf16)
# the bf16 serving kernels' split: a K1-bf16 build that stamps each layer's
# phases, and K2/K3-bf16 builds that leave a part out
K1_STAMPED = ("wavenet_stack_bf16", ("K1_STAMPS=1",))
# K4-bf16 and K7-bf16 (csrc/lvc_tiles.cuh: TERMS): y in LVC_TERMS bf16 terms
LVC_TERMS = 3
LVC_BF16_RATE = ("the window product x 3 bf16 terms on the bf16 dense tensor cores, 989 "
                 "TFLOP/s, plus the conv on FP32 FMAs, 67 TFLOP/s; HBM 3.35 TB/s (bf16 window "
                 "bytes); bound_fp32_rate_ms: every FMA at 67 TFLOP/s")
# with --parent: K4/K7-bf16 and the float32 K4/K7 against the earlier builds in turns
PARENT_LVC_KEYS = ("parent_ms", "in_turns_ms", "f32_parent_ms", "f32_in_turns_ms")
LVC_BF16_KEYS = ("bound_fp32_rate_ms", "bound_fp32_rate_by") + PARENT_LVC_KEYS
RES_BF16_SKIPS = {"no_weight_stream": "RESBLOCK_SKIP=1", "no_x_loads": "RESBLOCK_SKIP=2",
                  "no_output": "RESBLOCK_SKIP=4"}
# the earlier designs' times as PERF.md §6 records them (K1-bf16's
# cooperative chain at T=512/640/2048; K2/K3-bf16 at a launch a conv: the
# five stages, HiFi-GAN V1's and V2's; K4-bf16 and K7-bf16 with widened
# windows on FP32 FMAs, blocks 0-2 and 1-2), for the log only
EARLIER_BF16_MS = {"K1-bf16, cooperative chain": (0.4821, 0.5138, 0.8245),
                   "K4-bf16, widened windows on FP32 FMAs": (0.0404, 0.1013, 0.3609),
                   "K7-bf16, widened windows on FP32 FMAs": (0.1073, 0.3661),
                   "K2/K3-bf16 stages, a launch a conv": (0.5930, 0.9861, 0.6917, 0.5622, 0.5000),
                   "HiFi-GAN V1 bf16 stages, a launch a conv": (0.5955, 0.9878, 0.6890, 0.5631),
                   "HiFi-GAN V2 bf16 stages, a launch a conv": (0.2066, 0.1911, 0.1759, 0.1042)}
COUNTED = ("residual_stack", "resblock_stage", "ublock_layer", "ublock_block", "lvc",
           "residual_stack_save", "residual_stack_chain", "residual_stack_bf16",
           "residual_stack_save_bf16", "residual_stack_chain_bf16", "resblock_stage_bf16",
           "ublock_layer_bf16", "ublock_block_bf16", "resblock_stage_c8", "resblock_stage_c8_bf16")
# the bf16 phase: the H100 SXM's published dense bf16 tensor-core rate (700 W);
# kernel vs twin in bf16 at 1e-2 of the peak (the same rounding points, another
# float32 sum order: a value may cross a bf16 rounding boundary); a bf16
# training step card vs CPU at 2e-2 of each gradient's peak (the CPU takes the
# card's route through the kernels' twins, which round where the kernels do;
# the encoder's bf16 products may still round one unit apart); the fast
# render's mel vs the parity render's at 2e-2 of its peak
BF16_PEAK = 989e12
BF16_KERNEL_TOL, BF16_STEP_TOL, BF16_RENDER_TOL = 1e-2, 2e-2, 2e-2
# the serving vocoders' bf16 (phase 14): K2/K3-bf16 vs its twin at 7e-3 of the
# peak (18 chained bf16 roundings: another float32 sum order rounds a few conv
# inputs to the neighbouring bf16 value; the CPU twin is 2.1e-4 of the peak
# off the Pallas kernel); a render's wav with bf16 tap stacks vs float32 at the JAX
# package's bound (tests/test_nsf_packed.py:190-204); FastDiff-4 fast vs
# parity on one mel and injected noise at 2e-2 of the wav's peak
# (tests/test_torch_bf16_vocoders.py: 4.5e-3 on the CPU twins, held at 1.5e-2)
RES_BF16_TOL, WAV_BF16_MAX_ABS, WAV_BF16_CORR, FD_BF16_WAV_TOL = 7e-3, 0.05, 0.999, 2e-2
# the CLI runs of train svs take 5 steps each: steps 2-4 are timed, step 5 runs
# under torch.profiler (its launches and kernel time)
BF16_EXP, BF16_TRAIN_STEPS, BF16_CONV_CHANNELS = "bf16", 5, 64
# vocode wav2wav: NSF-HiFiGAN at the base config's audio settings (the openvpi
# 44.1 kHz generator), FastDiff at its LJSpeech audio settings (22.05 kHz, hop
# 256, 80 mels, fmin 80, fmax 7600), both with the built-in ACF extractor
VOCODE_NSF_AUDIO = {"audio_sample_rate": 44100, "audio_num_mel_bins": 128, "fft_size": 2048,
                    "win_size": 2048, "hop_size": 512, "fmin": 40, "fmax": 16000,
                    "pitch_extractor": "acf", "interp_uv": True}
VOCODE_FD_AUDIO = {"audio_sample_rate": 22050, "audio_num_mel_bins": 80, "fft_size": 1024,
                   "win_size": 1024, "hop_size": 256, "fmin": 80, "fmax": 7600,
                   "pitch_extractor": "acf", "interp_uv": True}
VOCODE_NSF_SAMPLES = 264600  # 6.0 s at 44.1 kHz: 516 mel frames
VOCODE_FD_SAMPLES = 131072  # 5.94 s at 22.05 kHz: 512 mel frames
VOCODE_KEYSHIFTS = (0, 3)
# FastDiff on random weights: the injected noise at 0.05 of a unit normal and
# the final conv at 0.1 keep the render inside save_wav's int16 range
VOCODE_FD_NOISE, VOCODE_FD_FINAL_SCALE = 0.05, 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int, torch) -> float:
    """Mean milliseconds per call by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, torch) -> dict:
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    ok = bool(torch.allclose(got, want, **KERNEL_TOL))
    log(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"tol(atol={KERNEL_TOL['atol']}, rtol={KERNEL_TOL['rtol']}) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def graph_replay(name, fn, want, torch) -> None:
    """Capture one call of ``fn`` into a CUDA graph (after a warm-up on a
    side stream), replay it and hold its output against ``want``; times the
    eager call and the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    res = compare(f"{name}, replayed from a CUDA graph", out, want, torch)
    log(f"{name}: captured into a CUDA graph; eager {timed_ms(fn, 20, torch):.4f} ms, replay "
        f"{timed_ms(graph.replay, 20, torch):.4f} ms (max abs err {res['max_abs_err']:.3e})")


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK) -> dict:
    """The least time the card could take: operations at ``peak`` (the FP32
    rate, or the bf16 tensor cores' for a bf16-operand kernel) or bytes at
    the HBM rate, whichever is longer."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def counters():
    from prodiff_tpu_torch.ops.lvc import lvc
    from prodiff_tpu_torch.ops.resblock import resblock_stage
    from prodiff_tpu_torch.ops.ublock import ublock_block, ublock_layer
    from prodiff_tpu_torch.ops.wavenet_stack import residual_stack
    from prodiff_tpu_torch.ops.wavenet_train import residual_stack_chain, residual_stack_save

    return {"residual_stack": residual_stack.launches, "resblock_stage": resblock_stage.launches,
            "ublock_layer": ublock_layer.launches, "ublock_block": ublock_block.launches,
            "lvc": lvc.launches,
            "residual_stack_save": residual_stack_save.launches,
            "residual_stack_chain": residual_stack_chain.launches,
            "residual_stack_bf16": residual_stack.bf16_launches,
            "residual_stack_save_bf16": residual_stack_save.bf16_launches,
            "residual_stack_chain_bf16": residual_stack_chain.bf16_launches,
            "resblock_stage_bf16": resblock_stage.bf16_launches,
            "ublock_layer_bf16": ublock_layer.bf16_launches,
            "ublock_block_bf16": ublock_block.bf16_launches,
            "resblock_stage_c8": resblock_stage.c8_launches,
            "resblock_stage_c8_bf16": resblock_stage.c8_bf16_launches}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def check_counts(path: str, want: dict) -> dict:
    """Every counter against ``want`` (0 for a kernel off the path)."""
    got = {k: c.count for k, c in counters().items()}
    want = {k: want.get(k, 0) for k in COUNTED}
    log(f"kernel launches during {path}: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{path}: the kernels did not run the expected number of times")
    return got


def phase_kernels(dev, torch):
    from prodiff_tpu_torch.ops import wavenet_stack as wn
    from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain

    rng = np.random.default_rng(SEED)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    n_layers, c, h = 20, 256, 256
    w = wn.StackedWaveNet(
        dilated_w=rand(n_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
        dilated_b=rand(n_layers, 2 * c, scale=0.1),
        diff_w=rand(n_layers, c, c, scale=c ** -0.5),
        diff_b=rand(n_layers, c, scale=0.1),
        cond_w=rand(n_layers, h, 2 * c, scale=h ** -0.5),
        cond_b=rand(n_layers, 2 * c, scale=0.1),
        out_w=rand(n_layers, c, 2 * c, scale=c ** -0.5),
        out_b=rand(n_layers, 2 * c, scale=0.1),
    )
    k1 = {"max_abs_err": 0.0, "by_shape": []}
    for b, t in K1_SHAPES:
        x0, cond, step = rand(b, t, c), rand(b, t, h), rand(b, c)
        got = wn.residual_stack(x0, cond, step, w)
        want = wn.residual_stack_plain(x0, cond, step, w)
        res = compare(f"K1 residual_stack L=20 C=256 H=256 B={b} T={t}", got, want, torch)
        ms = timed_ms(lambda: wn.residual_stack(x0, cond, step, w), 20, torch)
        plain_ms = timed_ms(lambda: wn.residual_stack_plain(x0, cond, step, w), 20, torch)
        layer = 3 * c * 2 * c + h * 2 * c + c * 2 * c  # MACs per frame and layer
        flops = 2 * b * t * n_layers * layer + 2 * b * n_layers * c * c
        nbytes = 4 * (2 * b * t * c + b * t * h + b * c + n_layers * (layer + c * c + 7 * c))
        lim = bound(flops, nbytes)
        rows = wn.chain_rows(b, t, c, wn._slots[(dev.index, torch.float32)])
        log(f"K1 B={b} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{lim['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB: {lim['bound_by']}), "
            f"share of bound {lim['bound_ms'] / ms:.3f}; {wn.stack_launches(b, t, c, n_layers)} launches "
            f"a stack, chain tile rows {rows}")
        k1["max_abs_err"] = max(k1["max_abs_err"], res["max_abs_err"])
        k1["by_shape"].append(dict(B=b, T=t, ms=ms, plain_ms=plain_ms, **lim,
                                   share=lim["bound_ms"] / ms))
        if t == 512:
            k1.update(ms=ms, plain_ms=plain_ms, **lim)
        if t == 640:  # the cooperative chain launch inside a CUDA graph (serving's warm-up route)
            graph_replay(f"K1 B={b} T={t}", lambda: wn.residual_stack(x0, cond, step, w), want, torch)

    res_total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "stages": []}
    flops = nbytes = 0
    for c, t in RES_STAGES:
        taps = 6 * sum(RES_K)  # 18 convs: 6 per kernel size
        st_flops, st_bytes = 2 * taps * c * c * t, 4 * (2 * t * c + taps * c * c + 18 * c)
        flops += st_flops
        nbytes += st_bytes
        ws = [rand(k * c * c, scale=(k * c) ** -0.5) for k in RES_K for _ in range(6)]
        weights, biases = torch.cat(ws), rand(18, c, scale=0.1)
        x = rand(1, t, c)
        got = resblock_stage(x, weights, biases, RES_K, RES_D)
        want = resblock_stage_plain(x, weights, biases, RES_K, RES_D)
        res = compare(f"resblock_stage C={c} T={t}", got, want, torch)
        ms = timed_ms(lambda: resblock_stage(x, weights, biases, RES_K, RES_D), 10, torch)
        plain_ms = timed_ms(lambda: resblock_stage_plain(x, weights, biases, RES_K, RES_D), 10, torch)
        lim = bound(st_flops, st_bytes)
        log(f"resblock C={c} T={t}: kernel {ms:.4f} ms, plain (18 cuDNN convs) {plain_ms:.4f} ms, "
            f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}), share of bound "
            f"{lim['bound_ms'] / ms:.3f}, kernel / cuDNN {ms / plain_ms:.3f}")
        res_total["max_abs_err"] = max(res_total["max_abs_err"], res["max_abs_err"])
        res_total["ms"] += ms
        res_total["plain_ms"] += plain_ms
        res_total["stages"].append(dict(C=c, T=t, ms=ms, plain_ms=plain_ms, **lim,
                                        share=lim["bound_ms"] / ms))
        if c == 128:
            graph_replay(f"resblock_stage C={c} T={t}",
                         lambda: resblock_stage(x, weights, biases, RES_K, RES_D), want, torch)
    res_total.update(bound(flops, nbytes))
    log(f"resblock, all 5 stages of one vocoder pass at T_mel=512: kernel "
        f"{res_total['ms']:.4f} ms, plain {res_total['plain_ms']:.4f} ms, "
        f"bound {res_total['bound_ms']:.4f} ms ({res_total['bound_by']}), share of bound "
        f"{res_total['bound_ms'] / res_total['ms']:.3f}")
    return k1, res_total


def capture_graph(calls, torch):
    """``calls`` (zero-argument callables) captured together into one CUDA
    graph, after a warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    return graph


def per_steps(fn):
    """One call of ``fn(step)`` for each step of a hoisted FastDiff stack."""
    return [lambda s=s: fn(s) for s in range(FD_STEPS)]


def in_turns(fns: dict, torch, rounds: int = 5) -> dict:
    """Host-clock milliseconds of each zero-argument call of ``fns`` (two
    labels), synchronised, run in turns (a, b, b, a) ``rounds`` times; the
    median, min and max of each."""
    a, b = fns
    times = {a: [], b: []}
    for _ in range(rounds):
        for label in (a, b, b, a):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fns[label]()
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - start) * 1e3)
    return {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in times.items()}


def graph_ms(calls, torch, reps: int = 10) -> float:
    """Milliseconds a call of ``calls``, captured together into one CUDA graph
    and replayed ``reps`` times between CUDA events: the kernels' time with
    the gaps between launches, without the host's (the wrappers' Python),
    which at a few microseconds of kernel is longer than the kernel."""
    graph = capture_graph(calls, torch)
    ms = timed_ms(graph.replay, reps, torch) / len(calls)
    del graph
    return ms


def clocks_under_load(calls, torch, seconds: float = 1.0) -> dict:
    """The card's SM clock (MHz) and power draw (W), medians of nvidia-smi
    samples taken while a CUDA graph of ``calls`` replays back to back for
    about ``seconds``."""
    graph = capture_graph(calls, torch)
    samples, errors, stop = [], [], threading.Event()

    def sample():
        try:
            while not stop.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, check=True, timeout=60).stdout
                samples.append([float(v) for v in out.splitlines()[0].split(",")])
        except Exception as e:  # raised again in the calling thread
            errors.append(e)

    graph.replay()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    end = time.time() + seconds
    while thread.is_alive() and (time.time() < end or len(samples) < 3):
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    del graph
    if errors or len(samples) < 3:
        raise RuntimeError(f"clocks_under_load: {len(samples)} nvidia-smi samples"
                           + (f", sampler failed: {errors[0]!r}" if errors else ""))
    mhz, watts = np.median(np.array(samples), axis=0)
    return {"sm_clock_mhz": float(mhz), "power_w": float(watts), "samples": len(samples)}


# K4's phase-skip variants (csrc/lvc_tiles.cuh: LVCT_SKIP), timed beside the kernel
K4_SKIPS = {"no_conv": 1, "no_window_product": 2, "neither": 3}
# K6's phase-skip variants (csrc/lvc.cu: LVC_SKIP): without the window
# product or the stores, and, at the pipelined blocks only, the product alone
# (neither staging nor stores)
K6_VARIANTS = {"no_window_product": "LVC_SKIP=1", "no_stores": "LVC_SKIP=2",
               "product_only": "LVC_SKIP=6"}
K6_PIPELINED_ONLY = ("product_only",)
# K6 at the hops of K6's contract that FastDiff's LJSpeech net does not run
# (B = 2; L a multiple of neither a unit's windows nor the SM count)
K6_EXTRA = ((24, 137), (40, 75), (72, 137), (200, 67))
# K4 at the hops its contract gained (every multiple of 8, as K6's, and the
# multiples of 4 from 64 on, as ublock_layer_packed's): B = 2, 512 windows
# (the LJSpeech net's T_mel), layer 3 (dilation 27) of the stack
K4_EXTRA_HOPS, K4_EXTRA_WINDOWS = (24, 40, 48, 56, 72, 80, 68, 100, 260), 512


def phase_fastdiff_kernels(dev, torch, split: bool = True):
    """K4 and K6 vs their twins at every (block, layer) of one FastDiff
    forward at T_mel=512, B=1, reading step ``s`` of a hoisted 4-step stack
    [4, 1, 512, 4*96, 64] (201 MB a block) in place. Times by ``graph_ms``
    over four calls, one a step, as the sampler reads them, so the window
    kernels come from HBM; ``ms``/``plain_ms`` sum the 12 calls of one
    forward, ``by_block`` sums each block's 4 (with its own bound). K7 vs its
    twin at the blocks it runs (1 and 2: hops 64, 256) on the same operands,
    reading step 2, timed beside its twin and the chain of four K4 launches
    over the same block (the JAX package's ``_MONO_BLOCK`` A/B), and replayed
    from a CUDA graph at hop 256; ``ms``/``plain_ms``/``k4_chain_ms`` sum the
    2 blocks of one forward. K6's row also gets the nearest library
    yardstick, ``torch.baddbmm(bias, taps, km)`` (one cuBLAS call: the
    window product and the bias, on a tap tensor built before the call, so
    not the whole function), timed the same way. With ``split``, each K4
    block is also timed with the phase-skip variants of ``K4_SKIPS`` and each
    K6 block with those of ``K6_VARIANTS`` (``phases_ms``), and K6 is held
    against its twin at the hops of ``K6_EXTRA``."""
    import torch.nn.functional as F

    from prodiff_tpu_torch.ops import cuda_build
    from prodiff_tpu_torch.ops import lvc as lvc_ops
    from prodiff_tpu_torch.ops import ublock as ublock_ops
    from prodiff_tpu_torch.ops.lvc import lvc, lvc_plain
    from prodiff_tpu_torch.ops.ublock import (mono_block_supported, ublock_block,
                                              ublock_block_plain, ublock_layer, ublock_layer_plain)

    rng = np.random.default_rng(SEED + 1)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    c, n_layers, n_win = 32, FD_CONFIG["lvc_layers_each_block"], FD_T_MEL
    dilations = [3 ** i for i in range(n_layers)]
    out = {}
    for name in ("ublock_layer", "lvc", "ublock_block"):
        out[name] = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0,
                     "by_block": []}
    out["ublock_block"]["k4_chain_ms"] = 0.0
    for blk, hop in enumerate(FD_HOPS):
        t = n_win * hop
        x, ad, y = rand(1, t, c), rand(1, t, c), rand(1, t, c)
        km = rand(FD_STEPS, 1, n_win, n_layers * 3 * c, 2 * c, scale=0.1)
        lb = rand(FD_STEPS, 1, n_win, n_layers * 2 * c, scale=0.1)
        window_bytes = 4 * n_win * (3 * c * 2 * c + 2 * c)  # one (step, layer)'s kernels
        cws, cbs = [], []
        rows = {name: {"block": blk, "hop": hop, "T": t, "ms": 0.0, "plain_ms": 0.0,
                       "layer_ms": [], "flops": 0, "bytes": 0} for name in ("ublock_layer", "lvc")}
        rows["lvc"]["baddbmm_ms"] = 0.0
        if split:
            rows["ublock_layer"]["phases_ms"] = dict.fromkeys(K4_SKIPS, 0.0)
            rows["lvc"]["phases_ms"] = {k: 0.0 for k in K6_VARIANTS if k not in K6_PIPELINED_ONLY
                                        or hop >= lvc_ops.STREAM_MAX_HOP}
        for i in range(n_layers):
            d = 3 ** i
            cw, cb = rand(c, c, 3, scale=0.2), rand(c, scale=0.1)
            cws.append(cw)
            cbs.append(cb)
            cases = {
                "ublock_layer": (ublock_layer, ublock_layer_plain,
                                 lambda fn, s: fn(x, ad, cw, cb, km, lb, d, hop, step_idx=s,
                                                  layer_idx=i),
                                 18432 * t, 4 * (3 * t * c + 3 * c * c + c) + window_bytes),
                "lvc": (lvc, lvc_plain, lambda fn, s: fn(y, km, lb, hop, step_idx=s, layer_idx=i),
                        12288 * t, 4 * (t * c + t * 2 * c) + window_bytes),
            }
            for name, (kernel, plain, call, flops, nbytes) in cases.items():
                got, want = call(kernel, i), call(plain, i)
                res = compare(f"{name} hop={hop} dilation={d} T={t} (step {i}, layer {i})",
                              got, want, torch)
                ms = graph_ms(per_steps(lambda s: call(kernel, s)), torch)
                plain_ms = graph_ms(per_steps(lambda s: call(plain, s)), torch)
                lim = bound(flops, nbytes)
                log(f"{name} hop={hop} dilation={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}), share of bound "
                    f"{lim['bound_ms'] / ms:.3f}")
                acc, row = out[name], rows[name]
                acc["max_abs_err"] = max(acc["max_abs_err"], res["max_abs_err"])
                for rec in (acc, row):
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["flops"] += flops
                    rec["bytes"] += nbytes
                row["layer_ms"].append(ms)
            # the library yardstick: the window product and the bias in one
            # cuBLAS call, on taps built here, outside the timed call
            taps = torch.cat([F.pad(y, (0, 0, 1, 1))[:, j: j + t] for j in range(3)], dim=2)
            taps = taps.view(n_win, hop, 3 * c)

            def baddbmm(s):
                return torch.baddbmm(lb[s, 0, :, i * 2 * c:(i + 1) * 2 * c].unsqueeze(1), taps,
                                     km[s, 0, :, i * 3 * c:(i + 1) * 3 * c])
            compare(f"torch.baddbmm hop={hop} (step {i}, layer {i}) vs the LVC's twin",
                    baddbmm(i).view(1, t, 2 * c), lvc_plain(y, km, lb, hop, i, i), torch)
            rows["lvc"]["baddbmm_ms"] += graph_ms(per_steps(baddbmm), torch)
            del taps
            if split:  # K6 built without a phase
                buf, phases = torch.empty(1, t, 2 * c, device=dev), rows["lvc"]["phases_ms"]
                for label in phases:
                    lib6 = lvc_ops.bind_library(cuda_build.load("lvc", (K6_VARIANTS[label],)))

                    def variant(s):
                        cuda_build.check(lib6.lvc_forward(
                            y.data_ptr(), km.data_ptr(), lb.data_ptr(), buf.data_ptr(), 1, t,
                            n_win, hop, n_layers, s, i, torch.cuda.current_stream().cuda_stream),
                            f"lvc_forward ({label})")
                    phases[label] += graph_ms(per_steps(variant), torch)
            if split:  # the same layer, built without some of its phases
                buf, phases = torch.empty_like(x), rows["ublock_layer"]["phases_ms"]
                for label, skip in K4_SKIPS.items():
                    lib = ublock_ops.bind_layer_library(
                        cuda_build.load("ublock", (f"LVCT_SKIP={skip}",)))

                    def skipped(s):
                        cuda_build.check(lib.ublock_layer_forward(
                            x.data_ptr(), ad.data_ptr(), cw.data_ptr(), cb.data_ptr(),
                            km.data_ptr(), lb.data_ptr(), buf.data_ptr(), 1, t, n_win, hop, d,
                            n_layers, s, i, torch.cuda.current_stream().cuda_stream),
                            f"ublock_layer_forward ({label})")
                    phases[label] += graph_ms(per_steps(skipped), torch)
        if split and hop == FD_HOPS[-1]:  # the block bound by operations: the FMA rate's clock
            row = rows["lvc"]
            row.update(clocks_under_load(per_steps(lambda s: lvc(y, km, lb, hop, s, 0)), torch))
            peak = torch.cuda.get_device_properties(0).multi_processor_count * 256 * \
                row["sm_clock_mhz"] * 1e6
            row["fp32_share_at_clock"] = row["flops"] / (row["ms"] * 1e-3) / peak
            log(f"lvc block {blk} (hop {hop}) replayed back to back: SM clock "
                f"{row['sm_clock_mhz']:.0f} MHz, power {row['power_w']:.1f} W (medians of "
                f"{row['samples']} nvidia-smi samples); its {n_layers} layers ran the FMA pipe at "
                f"{row['fp32_share_at_clock']:.3f} of its rate at that clock "
                f"({peak / 1e12:.1f} TFLOP/s)")
        if split:
            phases = rows["ublock_layer"]["phases_ms"]
            phases["all"] = rows["ublock_layer"]["ms"]
            log(f"ublock_layer block {blk} (hop {hop}) by phase, its {n_layers} layers: all "
                f"{phases['all']:.4f} ms, without the conv {phases['no_conv']:.4f}, without the "
                f"window product {phases['no_window_product']:.4f}, without both "
                f"{phases['neither']:.4f}")
            row = rows["lvc"]
            log(f"lvc block {blk} (hop {hop}) by phase, its {n_layers} layers: all "
                f"{row['ms']:.4f} ms, " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                    row["phases_ms"].items()))
        log(f"lvc block {blk} (hop {hop}): torch.baddbmm(bias, taps, km), taps built before "
            f"the call, its {n_layers} layers {rows['lvc']['baddbmm_ms']:.4f} ms")
        for name, row in rows.items():
            row.update(bound(row.pop("flops"), row.pop("bytes")))
            row["share"] = row["bound_ms"] / row["ms"]
            out[name]["by_block"].append(row)
            log(f"{name} block {blk} (hop {hop}, T={t}), its {n_layers} layers: kernel "
                f"{row['ms']:.4f} ms ({' + '.join(f'{v:.4f}' for v in row['layer_ms'])}), plain "
                f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"share of bound {row['share']:.3f}")
        if mono_block_supported(hop, dilations):
            def block(fn, s):
                return fn(x, ad, cws, cbs, km, lb, dilations, hop, s)

            def k4_chain(s):
                h = x
                for i, (cw, cb) in enumerate(zip(cws, cbs)):
                    h = ublock_layer(h, ad, cw, cb, km, lb, dilations[i], hop, s, i)
                return h

            got, want = block(ublock_block, 2), block(ublock_block_plain, 2)
            res = compare(f"K7 ublock_block hop={hop} T={t} (step 2, {n_layers} layers)", got, want,
                          torch)
            chain_err = float((k4_chain(2) - got).abs().max())
            ms = graph_ms(per_steps(lambda s: block(ublock_block, s)), torch)
            plain_ms = graph_ms(per_steps(lambda s: block(ublock_block_plain, s)), torch)
            chain_ms = graph_ms(per_steps(k4_chain), torch)
            ms2 = graph_ms(per_steps(lambda s: block(ublock_block, s)), torch)
            flops = 18432 * t * n_layers
            nbytes = 4 * (3 * t * c + n_layers * (3 * c * c + c)) + n_layers * window_bytes
            lim = bound(flops, nbytes)
            log(f"K7 ublock_block hop={hop} T={t}: kernel {ms:.4f} ms (again after the K4 chain: "
                f"{ms2:.4f}), plain {plain_ms:.4f} ms, the chain of {n_layers} K4 launches "
                f"{chain_ms:.4f} ms (vs K7 max abs {chain_err:.3e}; K7/chain {ms / chain_ms:.3f}), "
                f"bound {lim['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB: "
                f"{lim['bound_by']}), share of bound {lim['bound_ms'] / ms:.3f}")
            if hop == FD_HOPS[-1]:
                graph_replay(f"K7 ublock_block hop={hop}", lambda: block(ublock_block, 2), want,
                             torch)
            acc = out["ublock_block"]
            acc["max_abs_err"] = max(acc["max_abs_err"], res["max_abs_err"])
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            acc["k4_chain_ms"] += chain_ms
            acc["flops"] += flops
            acc["bytes"] += nbytes
            acc["by_block"].append(dict(block=blk, hop=hop, T=t, ms=ms, plain_ms=plain_ms,
                                        k4_chain_ms=chain_ms, **lim))
        del km, lb
    for name, acc in out.items():
        acc.update(bound(acc.pop("flops"), acc.pop("bytes")))
    for name in ("ublock_layer", "lvc"):
        acc = out[name]
        acc["bound_sum_of_blocks_ms"] = sum(r["bound_ms"] for r in acc["by_block"])
        log(f"{name}, the 12 layers of one FastDiff forward at T_mel={FD_T_MEL}: kernel "
            f"{acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, bound {acc['bound_ms']:.4f} ms "
            f"(the forward's FLOP and bytes together: {acc['bound_by']}), sum of the blocks' "
            f"bounds {acc['bound_sum_of_blocks_ms']:.4f} ms")
    out["lvc"]["baddbmm_ms"] = sum(r["baddbmm_ms"] for r in out["lvc"]["by_block"])
    if split:  # K6 at the hops of its contract beyond the LJSpeech net's
        for hop, n in K6_EXTRA:
            y = rand(2, n * hop, c)
            km = rand(FD_STEPS, 2, n, n_layers * 3 * c, 2 * c, scale=0.1)
            lb = rand(FD_STEPS, 2, n, n_layers * 2 * c, scale=0.1)
            for s_, i in ((0, 0), (FD_STEPS - 1, n_layers - 1)):
                res = compare(f"lvc hop={hop} B=2 L={n} (step {s_}, layer {i})",
                              lvc(y, km, lb, hop, s_, i), lvc_plain(y, km, lb, hop, s_, i), torch)
                out["lvc"]["max_abs_err"] = max(out["lvc"]["max_abs_err"], res["max_abs_err"])
    if split:  # K4 at the hops its contract gained (operands drawn on the card)
        out["ublock_layer"]["widened_hops"] = []
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)

        def drand(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale
        for hop in K4_EXTRA_HOPS:
            b, n, i, d = 2, K4_EXTRA_WINDOWS, n_layers - 1, dilations[-1]
            t = n * hop
            x, ad = drand(b, t, c), drand(b, t, c)
            cw, cb = drand(c, c, 3, scale=0.2), drand(c, scale=0.1)
            km = drand(FD_STEPS, b, n, n_layers * 3 * c, 2 * c, scale=0.1)
            lb = drand(FD_STEPS, b, n, n_layers * 2 * c, scale=0.1)

            def call(fn, s):
                return fn(x, ad, cw, cb, km, lb, d, hop, step_idx=s, layer_idx=i)
            res = compare(f"ublock_layer hop={hop} B={b} L={n} dilation={d} (step 0, layer {i})",
                          call(ublock_layer, 0), call(ublock_layer_plain, 0), torch)
            ms = graph_ms(per_steps(lambda s: call(ublock_layer, s)), torch)
            plain_ms = graph_ms(per_steps(lambda s: call(ublock_layer_plain, s)), torch)
            lim = bound(18432 * b * t, 4 * (3 * b * t * c + 3 * c * c + c)
                        + 4 * b * n * (3 * c * 2 * c + 2 * c))
            row = dict(hop=hop, B=b, T=t, dilation=d, ms=ms, plain_ms=plain_ms,
                       max_abs_err=res["max_abs_err"], **lim)
            out["ublock_layer"]["widened_hops"].append(row)
            out["ublock_layer"]["max_abs_err"] = max(out["ublock_layer"]["max_abs_err"],
                                                     res["max_abs_err"])
            log(f"ublock_layer hop={hop} B={b} T={t} dilation={d}: kernel {ms:.4f} ms a layer, "
                f"plain {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}), "
                f"share of bound {lim['bound_ms'] / ms:.3f}")
            del km, lb
    acc = out["ublock_block"]
    log(f"K7 ublock_block, blocks 1 and 2 of one FastDiff forward at T_mel={FD_T_MEL}: kernel "
        f"{acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, K4 chain {acc['k4_chain_ms']:.4f} ms, "
        f"bound {acc['bound_ms']:.4f} ms ({acc['bound_by']})")
    return out


def seeded_generator(torch):
    """The openvpi 44.1 kHz NSF-HiFiGAN architecture on random weights drawn
    from torch's global generator."""
    from prodiff_tpu_torch.models.nsf_hifigan import Generator

    gen = Generator.from_config(VOCODER_H)
    # the reference's N(0, 0.01) conv init leaves the wav bias-dominated and
    # nearly independent of the mel; scale by fan-in so the input reaches it
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] if isinstance(m, torch.nn.Conv1d) \
                    else w.shape[0] * w.shape[2] / m.stride[0]
                torch.nn.init.normal_(w, std=0.5 / fan_in ** 0.5)
    return gen


def build_models(torch):
    """Seeded full-width teacher + NSF-HiFiGAN state dicts (random weights)."""
    from prodiff_tpu_torch.infer.handler import phone_encoder
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher

    torch.manual_seed(SEED)
    n_vocab = len(phone_encoder(PHONE_SET))
    teacher = ProDiffTeacher(n_vocab, SLICE_HPARAMS)
    # the reference zero-inits the denoiser's output projection, which would
    # make the mel independent of the residual stack: give it seeded weights
    torch.nn.init.normal_(teacher.diffusion.denoise_fn.output_projection.weight, std=0.02)
    gen = seeded_generator(torch)
    n_t = sum(p.numel() for p in teacher.parameters())
    n_g = sum(p.numel() for p in gen.parameters())
    log(f"models: teacher {n_t / 1e6:.2f}M params, NSF-HiFiGAN {n_g / 1e6:.2f}M params (seed {SEED})")
    return teacher.state_dict(), gen.state_dict()


def make_handler(teacher_sd, voc_sd, dev, deterministic):
    from prodiff_tpu_torch.infer.handler import SVSInferHandler
    from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

    maps = {"phone_set": PHONE_SET, "spk_map": SPEAKERS,
            "lang_map": SLICE_HPARAMS["languages"]}
    voc = NsfHifiGAN(SLICE_HPARAMS, state_dict=voc_sd, config=VOCODER_H, device=dev)
    return SVSInferHandler(hparams=SLICE_HPARAMS, state_dict=teacher_sd, maps=maps,
                           vocoder=voc, device=dev, deterministic=deterministic)


def request_payload(seconds: float, rng) -> dict:
    n_ph = max(2, int(seconds / 0.12))
    dur = rng.uniform(0.5, 1.5, n_ph)
    dur = dur / dur.sum() * seconds
    n_frames = int(seconds * 44100 / 512) + 2
    return {
        "speaker": "spk0:0.6|spk1:0.4",
        "language": "zh",
        "ph_text_list": [PHONES[2 + int(i)] for i in rng.integers(0, 60, n_ph)],
        "ph_dur_list": [float(x) for x in dur],
        "pitch_list": [float(x) for x in 60 + 5 * np.sin(np.arange(n_frames) / 20)],
    }


def post(url: str, payload=None) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def capture_mel(handler) -> dict:
    """Record the mel each render hands the vocoder (the teacher's output,
    padded with the silence floor) and the wav it gets back, on the host,
    and the f0 beside the mel."""
    seen = {}
    spec2wav = handler.vocoder.spec2wav_batch

    def spy(mel, f0, **kw):
        seen["mel"], seen["f0"] = mel.detach().cpu().numpy(), f0
        wav = spec2wav(mel, f0, **kw)
        seen["wav"] = np.asarray(wav.detach().float().cpu()) if hasattr(wav, "detach") \
            else np.asarray(wav)
        return wav

    handler.vocoder.spec2wav_batch = spy
    return seen


class RequestSpans:
    """Host-clock spans of the parts of each /api/infer request, all taken
    in that request: the handler's front end (``prepare``), the render
    (teacher + vocoder + the wav's copy to the host, ``render_batch``), all
    of ``api_infer`` (adds validation, the segment's text fields and the wav
    to a list), and the server's ``json.dumps`` of the answer. Installed on
    the instances (and the server module's ``json``) before the server is
    made; ``spans`` holds the latest request's spans (after ``reset``) and
    ``segment`` the segment it rendered."""

    def __init__(self, web):
        import types

        import prodiff_tpu_torch.serve.handler as server_module

        self.web, self.module, self.json = web, server_module, server_module.json
        self.spans, self.segment = {}, None
        core = web.core

        def timed(name, fn):
            def run(*args):
                start = time.perf_counter()
                out = fn(*args)
                self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - start
                return out
            return run

        infer = core.infer

        def infer_seen(segment):
            self.segment = dict(segment)
            return infer(segment)

        core.prepare = timed("prepare", core.prepare)
        core.render_batch = timed("render", core.render_batch)
        core.infer = infer_seen
        web.api_infer = timed("api_infer", web.api_infer)
        server_module.json = types.SimpleNamespace(dumps=timed("server_json_dumps", self.json.dumps),
                                                   loads=self.json.loads)

    def reset(self):
        self.spans = {}

    def close(self):
        for attr in ("prepare", "render_batch", "infer"):
            del self.web.core.__dict__[attr]
        del self.web.__dict__["api_infer"]
        self.module.json = self.json


def post_timed(url: str, payload: dict):
    """(answer, seconds of the whole exchange, seconds of the client's
    ``json.loads`` of the answer, answer bytes)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        body = r.read()
    mid = time.perf_counter()
    out = json.loads(body)
    end = time.perf_counter()
    return out, end - start, end - mid, len(body)


def phase_slice(dev, torch):
    from prodiff_tpu_torch.serve.handler import WebHandler

    teacher_sd, voc_sd = build_models(torch)
    core = make_handler(teacher_sd, voc_sd, dev, deterministic=False)
    t0 = time.time()
    web = WebHandler(core=core, host="127.0.0.1", port=0)  # warm-up runs here
    log(f"server warm-up {time.time() - t0:.3f} s")
    spans = RequestSpans(web)
    server = web.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED)
    hop, sr = SLICE_HPARAMS["hop_size"], SLICE_HPARAMS["audio_sample_rate"]
    try:
        info = post(f"{base}/api/basic_info")
        if info["speakers"] != list(SPEAKERS) or info["samplerate"] != sr:
            raise AssertionError(f"basic_info: {info}")
        log(f"GET /api/basic_info: {json.dumps(info)}")
        reset_counts()
        for seconds in REQUEST_SECONDS:
            req = request_payload(seconds, rng)
            ph_acc = np.round(np.cumsum(req["ph_dur_list"]) / (hop / sr) + 0.5).astype(np.int64)
            mel_len = int(np.diff(ph_acc, prepend=0).sum())
            spans.reset()
            answer, latency, loads_s, n_body = post_timed(f"{base}/api/infer", req)
            wav = np.asarray(answer["wav"], np.float32)
            if wav.shape != (mel_len * hop,) or not np.isfinite(wav).all():
                raise AssertionError(f"/api/infer: wav {wav.shape}, want ({mel_len * hop},) finite")
            log(f"POST /api/infer {seconds:.0f} s of audio: mel_len {mel_len}, wav {wav.shape[0]} "
                f"samples, peak {np.abs(wav).max():.4f}, std {wav.std():.4f}, "
                f"latency {latency * 1000:.3f} ms "
                f"(RTF {latency / (wav.shape[0] / sr):.4f})")
        n = len(REQUEST_SECONDS)
        launches = check_counts("the requests", {
            "residual_stack": n * SLICE_HPARAMS["timesteps"] * K1_LAUNCHES,
            "resblock_stage": n * 5 * 18})
        ms = {k: round(v * 1000, 3) for k, v in spans.spans.items()}
        ms["client_json_loads"] = round(loads_s * 1000, 3)
        rest = latency * 1000 - ms["api_infer"] - ms["server_json_dumps"] - ms["client_json_loads"]
        log(f"{REQUEST_SECONDS[-1]:.0f} s request split, every part timed in that request (ms): "
            f"{json.dumps(ms)}; of its {latency * 1000:.3f} ms, {rest:.3f} ms are the HTTP exchange "
            f"itself (sockets, the server thread, the server's json.loads of the request; not "
            f"split further); answer {n_body} bytes")
        segment = spans.segment
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        spans.close()
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    profile_render(core, segment, mel_len, torch)

    # deterministic renders are bit-identical
    core.deterministic = True
    segment = {"ph_seq": " ".join(PHONES[2:14]), "ph_dur": " ".join(["0.06"] * 12),
               "f0_seq": " ".join(["220.0"] * 20), "f0_timestep": "0.05",
               "lang": "zh", "spk_name": "spk1"}
    a, b = core.infer(dict(segment)), core.infer(dict(segment))
    if not np.array_equal(a, b):
        raise AssertionError("two deterministic renders differ")
    log(f"deterministic render twice: bit-identical ({a.shape[0]} samples)")

    # the same short render on the CPU (plain path, no kernels, same weights):
    # the teacher's mel (K1's path) and the wav (the resblock kernel's path)
    cpu = make_handler(teacher_sd, voc_sd, torch.device("cpu"), deterministic=True)
    card_mel, cpu_mel = capture_mel(core), capture_mel(cpu)
    card_wav, cpu_wav = core.infer(dict(segment)), cpu.infer(dict(segment))
    if not np.array_equal(card_wav, a):
        raise AssertionError("a third deterministic render differs")
    mel_len = core.prepare(dict(segment))["mel_len"]  # the rest is the silence-floor padding
    for name, got, ref in (("mel", card_mel["mel"][:, :mel_len], cpu_mel["mel"][:, :mel_len]),
                           ("wav", card_wav, cpu_wav)):
        err, peak = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        log(f"card (kernels) vs CPU (plain) {name} {list(ref.shape)}: max_abs_err {err:.3e}, "
            f"peak {peak:.4f}, std {float(ref.std()):.4f}, tol {CPU_TOL} x peak")
        if not (np.isfinite(got).all() and err <= CPU_TOL * peak):
            raise AssertionError(f"the card's {name} disagrees with the CPU reference")
    return launches


def fastdiff_inputs(rng, t_ph: int, t_mel: int):
    """Seeded teacher inputs at B=1 (``__graft_entry__._example_inputs``):
    tokens, mel2ph, f0, language ids, speaker id."""
    tokens = rng.integers(3, 64, (1, t_ph))
    dur = rng.integers(4, 2 * max(t_mel // t_ph, 3), t_ph)
    mel2ph = np.full((1, t_mel), t_ph, np.int64)
    pos = 0
    for k in range(t_ph):
        mel2ph[0, pos: min(pos + dur[k], t_mel)] = k + 1
        pos += dur[k]
    f0 = rng.uniform(100, 500, (1, t_mel)).astype(np.float32)
    return tokens, mel2ph, f0, np.ones((1, t_ph), np.int64), np.zeros((1,), np.int64)


def fastdiff_models(dev, torch):
    """The FastDiff path's seeded models: the teacher on ``dev`` (eval), its
    state dict, and FastDiff's reference state dict."""
    from prodiff_tpu_torch.models.fastdiff import FastDiff as FastDiffNet
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher

    torch.manual_seed(SEED)
    teacher = ProDiffTeacher(64, FD_TEACHER_HPARAMS)
    torch.nn.init.normal_(teacher.diffusion.denoise_fn.output_projection.weight, std=0.02)
    teacher_sd = teacher.state_dict()
    torch.manual_seed(SEED + 2)
    fd_sd = FastDiffNet.from_config(FD_CONFIG).state_dict()  # a seeded reference state dict
    return teacher.to(dev).eval(), teacher_sd, fd_sd


def phase_fastdiff(dev, torch):
    """The FastDiff text->wav path at full width on seeded random weights."""
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.vocoders import get_vocoder_cls

    teacher, teacher_sd, fd_sd = fastdiff_models(dev, torch)
    n_fd = sum(v.numel() for v in fd_sd.values())
    log(f"FastDiff path: teacher {sum(p.numel() for p in teacher.parameters()) / 1e6:.2f}M params "
        f"(80 mels, {FD_TEACHER_STEPS} steps), FastDiff {n_fd / 1e6:.2f}M params "
        f"(LJSpeech config, {FD_STEPS} steps), seed {SEED}")
    vocoder = get_vocoder_cls("fastdiff")
    voc = vocoder({}, state_dict=fd_sd, config=FD_CONFIG, device=dev)
    voc_unfused = vocoder({"fastdiff_packed": False}, state_dict=fd_sd, config=FD_CONFIG, device=dev)
    hop = voc.hop
    rng = np.random.default_rng(SEED)
    tokens, mel2ph, f0, lang, spk = (torch.as_tensor(a, device=dev) for a in
                                     fastdiff_inputs(rng, FD_T_PH, FD_T_MEL))

    def acoustic(**noise):
        return teacher.infer(tokens, mel2ph, f0, infer_step=FD_TEACHER_STEPS, lang_seq=lang,
                             spk_embed_id=spk, **noise)

    def render(v, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        mel = acoustic(generator=gen)
        return mel, v.spec2wav(mel[0], generator=gen)

    for v in (voc, voc_unfused):  # warm-up: cuDNN plans, the allocator
        render(v, 0)
    torch.cuda.synchronize()
    reset_counts()
    gen = torch.Generator(dev).manual_seed(1)
    start = time.perf_counter()
    mel = acoustic(generator=gen)
    torch.cuda.synchronize()
    mid = time.perf_counter()
    wav = voc.spec2wav(mel[0], generator=gen)
    end = time.perf_counter()
    launches = check_counts("the FastDiff render", {
        "residual_stack": FD_TEACHER_STEPS * K1_LAUNCHES,
        "ublock_layer": FD_STEPS * len(FD_HOPS) * FD_CONFIG["lvc_layers_each_block"]})
    n_samples = FD_T_MEL * hop
    if wav.shape != (n_samples,) or not np.isfinite(wav).all():
        raise AssertionError(f"FastDiff render: wav {wav.shape}, want ({n_samples},) finite")
    log(f"FastDiff text->wav render T_mel={FD_T_MEL}: wav {wav.shape[0]} samples "
        f"({n_samples / 22050:.3f} s at 22.05 kHz), peak {np.abs(wav).max():.4f}, std "
        f"{wav.std():.4f}; {(end - start) * 1000:.3f} ms on the host clock (teacher "
        f"{(mid - start) * 1000:.3f} ms, FastDiff {(end - mid) * 1000:.3f} ms with the wav's copy "
        f"to the host; RTF {(end - start) / (n_samples / 22050):.5f})")

    reset_counts()
    gen = torch.Generator(dev).manual_seed(1)
    start = time.perf_counter()
    mel_u = acoustic(generator=gen)
    wav_u = voc_unfused.spec2wav(mel_u[0], generator=gen)
    end = time.perf_counter()
    launches_u = check_counts("the unfused-layer FastDiff render", {
        "residual_stack": FD_TEACHER_STEPS * K1_LAUNCHES,
        "lvc": FD_STEPS * len(FD_HOPS) * FD_CONFIG["lvc_layers_each_block"]})
    err, peak = float(np.abs(wav_u - wav).max()), float(np.abs(wav).max())
    log(f"unfused layer (K6) render: {(end - start) * 1000:.3f} ms; vs the fused layer (K4): "
        f"max abs err {err:.3e}, peak {peak:.4f}, tol {CPU_TOL} x peak")
    if not (torch.equal(mel_u, mel) and err <= CPU_TOL * peak):
        raise AssertionError("the unfused layer's render disagrees with the fused layer's")

    # the same render with MONO_BLOCK: K7 on the audio-rate blocks, K4 on block 0
    import prodiff_tpu_torch.models.fastdiff as fd_model
    from prodiff_tpu_torch.ops.ublock import mono_block_supported

    n_lay = FD_CONFIG["lvc_layers_each_block"]
    mono = [mono_block_supported(h, [3 ** i for i in range(n_lay)]) for h in FD_HOPS]
    fd_model.MONO_BLOCK = True
    try:
        render(voc, 0)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        gen = torch.Generator(dev).manual_seed(1)
        start = time.perf_counter()
        mel_m = acoustic(generator=gen)
        torch.cuda.synchronize()
        mid = time.perf_counter()
        wav_m = voc.spec2wav(mel_m[0], generator=gen)
        end = time.perf_counter()
    finally:
        fd_model.MONO_BLOCK = False
    launches_m = check_counts("the mono-block FastDiff render", {
        "residual_stack": FD_TEACHER_STEPS * K1_LAUNCHES,
        "ublock_block": FD_STEPS * sum(mono),
        "ublock_layer": FD_STEPS * n_lay * (len(FD_HOPS) - sum(mono))})
    err, peak = float(np.abs(wav_m - wav).max()), float(np.abs(wav).max())
    log(f"mono-block (K7) render: {(end - start) * 1000:.3f} ms on the host clock (teacher "
        f"{(mid - start) * 1000:.3f} ms, FastDiff {(end - mid) * 1000:.3f} ms with the wav's copy "
        f"to the host); vs the layer route (K4): max abs err {err:.3e}, peak {peak:.4f}, "
        f"tol 1e-4 x peak")
    if not (torch.equal(mel_m, mel) and np.isfinite(wav_m).all() and err <= 1e-4 * peak):
        raise AssertionError("the mono-block render disagrees with the layer route's")
    # the vocoder alone on that mel, the two routes in turns (layer, mono, mono,
    # layer) x 5, then each under torch.profiler: host clock vs kernel time
    times = {False: [], True: []}

    def vocoder_ms(mono_route):
        fd_model.MONO_BLOCK = mono_route
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            voc.spec2wav(mel[0], generator=torch.Generator(dev).manual_seed(1))
            return (time.perf_counter() - start) * 1e3
        finally:
            fd_model.MONO_BLOCK = False

    for _ in range(5):
        for mono_route in (False, True, True, False):
            times[mono_route].append(vocoder_ms(mono_route))
    ours = {"ublock_tiled_kernel": "K4 ublock_layer", "ublock_stream_kernel": "K4 ublock_layer",
            "ublock_block_kernel": "K7 ublock_block"}
    split = {m: kernel_split(lambda m=m: vocoder_ms(m), 2, ours, torch) for m in (False, True)}

    def idle(wall_ms, busy_ms):
        return f"{max(0.0, 1 - busy_ms / wall_ms):.3f}" if busy_ms > 0 else "not measured"

    log(f"FastDiff vocoder alone on the T_mel={FD_T_MEL} mel, 10 renders a route in turns (host "
        "clock, synchronised, with the wav's copy): " + "; ".join(
            f"{'mono-block (K7)' if m else 'layer (K4)'} median {sorted(v)[len(v) // 2]:.3f} ms, "
            f"min {min(v):.3f}, max {max(v):.3f}" for m, v in times.items()))
    for m, (wall_ms, busy_ms, sums, _) in split.items():
        log(f"FastDiff vocoder, {'mono-block (K7)' if m else 'layer (K4)'} route, under "
            f"torch.profiler (mean of 2 renders): {wall_ms:.3f} ms on the host clock, {busy_ms:.3f} "
            f"ms of kernel time (device idle share {idle(wall_ms, busy_ms)}); by group (ms): "
            + json.dumps({g: round(v, 4) for g, v in sums.items()}))
        for group in ("K4 ublock_layer", "K7 ublock_block")[: 1 + m]:
            if not sums[group] > 0:  # the profile lost a kernel's name
                raise AssertionError(f"the FastDiff profile found no {group} time")

    # two renders on injected noise are bit-identical
    nrng = np.random.default_rng(SEED + 3)

    def noise(*shape):
        return torch.tensor(nrng.normal(size=shape), dtype=torch.float32, device=dev)

    mb = FD_TEACHER_HPARAMS["audio_num_mel_bins"]
    t_noise = dict(init_noise=noise(1, 1, FD_T_MEL, mb),
                   step_noises=noise(FD_TEACHER_STEPS, 1, 1, FD_T_MEL, mb))
    v_noise = dict(init_noise=noise(1, n_samples, 1), step_noises=noise(FD_STEPS, 1, n_samples, 1))
    a, b = (voc.spec2wav(acoustic(**t_noise)[0], **v_noise) for _ in range(2))
    if not np.array_equal(a, b):
        raise AssertionError("two FastDiff renders on injected noise differ")
    log(f"FastDiff render on injected noise twice: bit-identical ({a.shape[0]} samples)")

    # a short render on the CPU (plain path, no kernels, same weights and noise)
    cpu = torch.device("cpu")
    teacher_cpu = ProDiffTeacher(64, FD_TEACHER_HPARAMS)
    teacher_cpu.load_state_dict(teacher_sd)
    teacher_cpu.eval()
    voc_cpu = vocoder({}, state_dict=fd_sd, config=FD_CONFIG, device=cpu)
    inputs = fastdiff_inputs(np.random.default_rng(SEED + 4), 4, FD_CPU_FRAMES)
    n_short = FD_CPU_FRAMES * hop
    short_noise = (np.random.default_rng(SEED + 5).normal(size=s).astype(np.float32) for s in (
        (1, 1, FD_CPU_FRAMES, mb), (FD_TEACHER_STEPS, 1, 1, FD_CPU_FRAMES, mb),
        (1, n_short, 1), (FD_STEPS, 1, n_short, 1)))
    short_noise = list(short_noise)
    got = {}
    for where, tch, v in (("card", teacher, voc), ("cpu", teacher_cpu, voc_cpu)):
        d = dev if where == "card" else cpu
        tk, m2p, f, lg, sp = (torch.as_tensor(x, device=d) for x in inputs)
        tn, ts, vn, vs = (torch.as_tensor(x, device=d) for x in short_noise)
        m = tch.infer(tk, m2p, f, infer_step=FD_TEACHER_STEPS, lang_seq=lg, spk_embed_id=sp,
                      init_noise=tn, step_noises=ts)
        got[where] = (m[0].cpu().numpy(), v.spec2wav(m[0], init_noise=vn, step_noises=vs))
    for i, name in enumerate(("mel", "wav")):
        g, ref = got["card"][i], got["cpu"][i]
        err, peak = float(np.abs(g - ref).max()), float(np.abs(ref).max())
        log(f"FastDiff path, card (kernels) vs CPU (plain) {name} {list(ref.shape)}: max_abs_err "
            f"{err:.3e}, peak {peak:.4f}, std {float(ref.std()):.4f}, tol {CPU_TOL} x peak")
        if not (np.isfinite(g).all() and err <= CPU_TOL * peak):
            raise AssertionError(f"FastDiff path: the card's {name} disagrees with the CPU reference")
    fastdiff_hops_off_8(dev, torch)
    return launches, launches_u, launches_m


FD_OFF_RATIOS, FD_OFF_FRAMES = (5, 5, 4), 32  # hops 5, 25, 100: none a multiple of 8


def fastdiff_hops_off_8(dev, torch) -> None:
    """One FastDiff forward at upsample ratios whose hops are not multiples
    of 8, routed by ``ops/lvc.py:on_kernels``: the unfused layer takes the
    matmul product on every layer and launches no K6; the fused layer takes
    it at hops 5 and 25 and launches K4 (split tiles) at hop 100; held
    against the CPU."""
    from prodiff_tpu_torch.models.fastdiff import FastDiff as FastDiffNet
    from prodiff_tpu_torch.ops.lvc import lvc_matmul

    cfg = dict(FD_CONFIG, upsample_ratios=list(FD_OFF_RATIOS))
    torch.manual_seed(SEED + 12)
    net = FastDiffNet.from_config(cfg).eval()  # seeded: the resamplers' shapes follow the ratios
    n = FD_OFF_FRAMES * int(np.prod(FD_OFF_RATIOS))
    rng = np.random.default_rng(SEED + 11)
    args = [torch.tensor(rng.normal(size=shape), dtype=torch.float32)
            for shape in ((1, n, 1), (1, FD_OFF_FRAMES, cfg["cond_channels"]))]
    args.append(torch.tensor([[37.0]]))
    with torch.no_grad():
        want = net(*args)
    net = net.to(dev)
    hops = [int(h) for h in np.cumprod(FD_OFF_RATIOS)]
    layers = cfg["lvc_layers_each_block"]
    for fused in (True, False):
        net.fused_layer = fused
        reset_counts()
        before = lvc_matmul.launches.count
        with torch.no_grad():
            got = net(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        routed = lvc_matmul.launches.count - before
        k4 = layers * sum(h >= 64 and h % 4 == 0 for h in hops) if fused else 0
        check_counts(f"a FastDiff forward at hops {hops} "
                     f"({'fused' if fused else 'unfused'} layer)", {"ublock_layer": k4})
        err, peak = float((got.cpu() - want).abs().max()), float(want.abs().max())
        log(f"FastDiff at hops {hops} (T_mel {FD_OFF_FRAMES}, "
            f"{n} samples), {'fused' if fused else 'unfused'} layer: {routed} window products on "
            f"the matmul route, {k4} K4 launches; card vs CPU max_abs_err {err:.3e}, peak "
            f"{peak:.4f}, tol {CPU_TOL} x peak")
        want_routed = len(hops) * layers - k4
        if routed != want_routed or not (torch.isfinite(got).all() and err <= CPU_TOL * peak):
            raise AssertionError("FastDiff at hops off the multiples of 8: wrong route or "
                                 "disagreement")


def vibrato_tone(n_samples: int, sr: int, seed: int) -> np.ndarray:
    """A seeded 220 Hz vibrato tone (+-1 semitone at 5 Hz), 4 partials at 1/k,
    white noise 30 dB below, a silent gap over 5% of it at 40%; float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    phase = 2 * np.pi * np.cumsum(220.0 * 2 ** (np.sin(2 * np.pi * 5 * t) / 12)) / sr
    y = sum(np.sin(k * phase) / k for k in range(1, 5))
    y = 0.4 * y / np.abs(y).max() + 0.4 * 10 ** (-30 / 20) * rng.normal(size=n_samples)
    gap = int(0.4 * n_samples)
    y[gap: gap + n_samples // 20] = 0.0
    return y.astype(np.float32)


class Spans:
    """Host-clock spans of patched callables, synchronised with the card."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.ms, self.saved = torch, targets, {}, []

    def __enter__(self):
        for owner, attr, name in self.targets:
            raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw

            def run(*args, _fn=fn, _name=name, **kw):
                start = time.perf_counter()
                out = _fn(*args, **kw)
                if self.torch.cuda.is_initialized():
                    self.torch.cuda.synchronize()
                self.ms[_name] = self.ms.get(_name, 0.0) + (time.perf_counter() - start) * 1e3
                return out

            self.saved.append((owner, attr, raw))
            setattr(owner, attr, staticmethod(run) if isinstance(raw, staticmethod) else run)
        return self

    def __exit__(self, *exc):
        for owner, attr, raw in reversed(self.saved):
            setattr(owner, attr, raw)


def phase_vocode(dev, torch):
    """``python -m prodiff_tpu_torch vocode wav2wav`` at full width through
    ``__main__.main`` on seeded random vocoder checkpoints in a temporary
    directory: NSF-HiFiGAN (openvpi 44.1 kHz generator, base-config audio,
    deterministic source) on a 6.0 s tone at keyshift 0 and +3, and FastDiff-4
    (LJSpeech config, ``MONO_BLOCK`` set) on a 512-frame tone; the launch
    counts and the time split of each run; the card's mel and f0 against the
    CPU's, and each written wav against the same CLI run on the CPU (FastDiff
    on a 32-frame tone, both with the same injected noise)."""
    import os
    import tempfile

    import yaml
    from scipy.io import wavfile

    import prodiff_tpu_torch.models.fastdiff as fd_model
    import prodiff_tpu_torch.utils.audio as audio
    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.models.fastdiff import FastDiff as FastDiffNet
    from prodiff_tpu_torch.ops.ublock import mono_block_supported
    from prodiff_tpu_torch.pe.acf import ACF
    from prodiff_tpu_torch.vocoders.fastdiff import FastDiff as FastDiffVocoder
    from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

    tmp = tempfile.mkdtemp(prefix="prodiff_torch_vocode_")
    os.makedirs(os.path.join(tmp, "nsf"))
    torch.manual_seed(SEED + 8)
    torch.save({"generator": seeded_generator(torch).state_dict()}, os.path.join(tmp, "nsf", "model"))
    with open(os.path.join(tmp, "nsf", "config.json"), "w") as f:
        json.dump(dict(VOCODER_H, n_fft=2048, win_size=2048, hop_size=512, fmin=40, fmax=16000), f)
    os.makedirs(os.path.join(tmp, "fastdiff"))
    torch.manual_seed(SEED + 9)
    net = FastDiffNet.from_config(FD_CONFIG)
    with torch.no_grad():
        net.final_conv[0].weight.mul_(VOCODE_FD_FINAL_SCALE)
    torch.save({"state_dict": {"model": net.state_dict()}},
               os.path.join(tmp, "fastdiff", "model_ckpt_steps_0.ckpt"))
    with open(os.path.join(tmp, "fastdiff", "config.yaml"), "w") as f:
        yaml.dump(FD_CONFIG, f)
    cells = {
        "nsfhifigan": (dict(VOCODE_NSF_AUDIO, vocoder="nsfhifigan", vocoder_deterministic=True,
                            vocoder_ckpt=os.path.join(tmp, "nsf", "model")), NsfHifiGAN,
                       VOCODE_NSF_SAMPLES, VOCODE_KEYSHIFTS),
        "fastdiff": (dict(VOCODE_FD_AUDIO, vocoder="fastdiff",
                          vocoder_ckpt=os.path.join(tmp, "fastdiff")), FastDiffVocoder,
                     VOCODE_FD_SAMPLES, (0,)),
    }

    def noise(n_samples, where):
        """FastDiff's injected noise for an n-sample render, the same on both devices."""
        rng = np.random.default_rng(SEED + 10)
        init = rng.normal(size=(1, n_samples, 1)) * VOCODE_FD_NOISE
        steps = rng.normal(size=(FD_STEPS, 1, n_samples, 1)) * VOCODE_FD_NOISE
        return {k: torch.tensor(v, dtype=torch.float32, device=where)
                for k, v in (("init_noise", init), ("step_noises", steps))}

    fd_render = FastDiffVocoder.spec2wav

    def render_with_noise(self, mel, **kw):
        return fd_render(self, mel, **noise(len(mel) * self.hop, self.device), **kw)

    n_lay = FD_CONFIG["lvc_layers_each_block"]
    n_mono = sum(mono_block_supported(h, [3 ** i for i in range(n_lay)]) for h in FD_HOPS)
    per_render = {"nsfhifigan": {"resblock_stage": 5 * 18},
                  "fastdiff": {"ublock_block": FD_STEPS * n_mono,
                               "ublock_layer": FD_STEPS * n_lay * (len(FD_HOPS) - n_mono)}}

    def cli(name, wav_path, keyshift, where):
        hp, cls, _, _ = cells[name]
        cfg = os.path.join(tmp, f"{name}.yaml")
        with open(cfg, "w") as f:
            yaml.dump(hp, f)
        out_dir = os.path.join(tmp, f"out_{name}_{keyshift}_{where}_{os.path.basename(wav_path)}")
        targets = [(cls, "__init__", "load"), (cls, "wav2spec", "wav2spec"),
                   (ACF, "get_pitch", "get_pitch"), (cls, "spec2wav", "spec2wav"),
                   (audio, "save_wav", "save_wav")]
        with Spans(torch, targets) as spans:
            start = time.perf_counter()
            port_cli(["vocode", "wav2wav", wav_path, "--config", cfg, "--keyshift", str(keyshift),
                      "--output_dir", out_dir, "--device", where])
            if where == "cuda":
                torch.cuda.synchronize()
            total = time.perf_counter() - start
        sr, wav = wavfile.read(os.path.join(out_dir, "tone.wav"))
        return wav, total, spans.ms

    fd_model.MONO_BLOCK = True
    launches = {}
    try:
        for name, (hp, cls, n_samples, keyshifts) in cells.items():
            sr = hp["audio_sample_rate"]
            wav_dir = os.path.join(tmp, f"in_{name}")
            os.makedirs(wav_dir)
            wav_path = os.path.join(wav_dir, "tone.wav")
            wavfile.write(wav_path, sr, vibrato_tone(n_samples, sr, SEED + 11))
            # the card's mel and f0 vs the CPU's on the same file
            for k in keyshifts:
                (wave, mel), (_, mel_cpu) = (cls.wav2spec(wav_path, hp, keyshift=k, device=d)
                                             for d in (dev, "cpu"))
                err, peak = float(np.abs(mel - mel_cpu).max()), float(np.abs(mel_cpu).max())
                f0, uv = ACF(hp, device=dev).get_pitch(wave, sr, len(mel), hop_size=hp["hop_size"],
                                                       interp_uv=False)
                f0_cpu, uv_cpu = ACF(hp, device="cpu").get_pitch(
                    wave, sr, len(mel), hop_size=hp["hop_size"], interp_uv=False)
                voiced = ~uv_cpu
                f0_err = float(np.max(np.abs(f0[voiced] - f0_cpu[voiced]) / f0_cpu[voiced]))
                log(f"vocode {name}: card vs CPU, keyshift {k}: mel {list(mel.shape)} max_abs_err "
                    f"{err:.3e} (peak {peak:.4f}, tol 1e-4 x peak); ACF f0 voiced {int(voiced.sum())}"
                    f"/{len(f0)} frames on both: {bool(np.array_equal(uv, uv_cpu))}, max rel err "
                    f"{f0_err:.3e} (tol 1e-3)")
                if not (err <= 1e-4 * peak and np.array_equal(uv, uv_cpu) and f0_err <= 1e-3
                        and voiced.sum() > len(f0) // 2):
                    raise AssertionError(f"vocode {name}: the card's mel or f0 disagrees with the CPU's")
            hop = hp["hop_size"]
            n_frames = (n_samples + hp["win_size"] - hop - hp["win_size"]) // hop + 1
            if name == "fastdiff":
                FastDiffVocoder.spec2wav = render_with_noise
            try:
                cli(name, wav_path, keyshifts[0], "cuda")  # warm-up: cuDNN plans, the allocator
                for k in keyshifts:
                    reset_counts()
                    wav, total, ms = cli(name, wav_path, k, "cuda")
                    launches[name] = check_counts(f"vocode wav2wav {name} keyshift {k}",
                                                  per_render[name])
                    if wav.shape != (n_frames * hop,):
                        raise AssertionError(f"vocode {name}: wav {wav.shape}, want ({n_frames * hop},)")
                    log(f"vocode wav2wav {name} keyshift {k}: {n_samples} samples in, {n_frames} mel "
                        f"frames, {wav.shape[0]} samples written (peak {int(np.abs(wav).max())} of "
                        f"32767); {total * 1000:.3f} ms on the host clock, RTF "
                        f"{total / (n_samples / sr):.5f}; split (ms): "
                        + json.dumps({k2: round(v, 3) for k2, v in ms.items()}))
                    if name == "fastdiff":  # the CPU reference runs a shorter tone
                        short = os.path.join(tmp, "in_fastdiff_short")
                        os.makedirs(short)
                        wav_path = os.path.join(short, "tone.wav")
                        wavfile.write(wav_path, sr, vibrato_tone(FD_CPU_FRAMES * hop, sr, SEED + 12))
                        wav, _, _ = cli(name, wav_path, k, "cuda")
                    wav_cpu, total_cpu, _ = cli(name, wav_path, k, "cpu")
                    err, peak = float(np.abs(wav.astype(np.float64) - wav_cpu).max()), \
                        float(np.abs(wav_cpu.astype(np.float64)).max())
                    log(f"vocode wav2wav {name} keyshift {k}: card vs CPU written wav "
                        f"{list(wav_cpu.shape)} max_abs_err {err:.0f} (int16 steps), peak {peak:.0f}, "
                        f"tol {CPU_TOL} x peak; the CPU run {total_cpu:.3f} s")
                    if not (0 < peak < 32767 and err <= CPU_TOL * peak):
                        raise AssertionError(f"vocode {name}: the card's wav disagrees with the CPU's")
            finally:
                FastDiffVocoder.spec2wav = fd_render
    finally:
        fd_model.MONO_BLOCK = False
    return launches


def grad_compare(name, got, want, tol, torch) -> float:
    """max |got - want| against ``tol`` x the reference's peak; raises beyond."""
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= tol * max(peak, 1e-12)
    log(f"{name}: max_abs_err={err:.3e} peak={peak:.4e} tol {tol} x peak {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the card disagrees with its reference")
    return err


def phase_train_kernels(dev, torch):
    """K5 vs its plain twins at the training shape, and the whole backward
    (chain kernel + cuBLAS weight gradients) vs autograd through the plain
    stack. Returns the K5a / K5b summaries for the kernels line."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn
    from prodiff_tpu_torch.ops import wavenet_train as wt

    rng = np.random.default_rng(SEED + 6)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    b, t, n_layers, c, h = TRAIN_B, TRAIN_T, 20, 256, 256
    w = wn.StackedWaveNet(
        dilated_w=rand(n_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
        dilated_b=rand(n_layers, 2 * c, scale=0.1),
        diff_w=rand(n_layers, c, c, scale=c ** -0.5), diff_b=rand(n_layers, c, scale=0.1),
        cond_w=rand(n_layers, h, 2 * c, scale=h ** -0.5), cond_b=rand(n_layers, 2 * c, scale=0.1),
        out_w=rand(n_layers, c, 2 * c, scale=c ** -0.5), out_b=rand(n_layers, 2 * c, scale=0.1),
    )
    x0, cond, step, g = rand(b, t, c), rand(b, t, h), rand(b, c), rand(b, t, c)
    tag = f"L={n_layers} C={c} H={h} B={b} T={t}"

    skip, xs, zs = wt.residual_stack_save(x0, cond, step, w)
    want = wt.residual_stack_save_plain(x0, cond, step, w)
    fwd_err = max(compare(f"K5a save-forward {name} {tag}", got, ref, torch)["max_abs_err"]
                  for name, got, ref in zip(("skip", "xs", "zs"), (skip, xs, zs), want))
    compare(f"K5a skip vs K1 {tag}", skip, wn.residual_stack(x0, cond, step, w), torch)
    del want
    dz, dy, dx0 = wt.residual_stack_chain(zs, g, w)
    ref_dz, ref_dy, ref_dx0 = wt.residual_stack_chain_plain(zs, g, w)
    chain_err = max(grad_compare(f"K5b chain {name} {tag}", got, ref, GRAD_TOL, torch)
                    for name, got, ref in (("dz", dz, ref_dz), ("dy", dy, ref_dy),
                                           ("dx0", dx0, ref_dx0)))
    del ref_dz, ref_dy, ref_dx0

    # the Function's 11 gradients vs autograd through the plain stack (on the card)
    ins = [a.clone().requires_grad_() for a in (x0, cond, step, *w)]
    got = torch.autograd.grad(wt.ResidualStackFn.apply(*ins), ins, g)
    ref = torch.autograd.grad(wn.residual_stack_plain(ins[0], ins[1], ins[2],
                                                      wn.StackedWaveNet(*ins[3:])), ins, g)
    names = ("x0", "cond", "step") + wn.StackedWaveNet._fields
    grad_err = max(grad_compare(f"K5 gradient {name}", a, r, GRAD_TOL, torch)
                   for name, a, r in zip(names, got, ref))
    del got, ref

    needs = (True,) * 11

    def plain_fwd_bwd():
        _, p_xs, p_zs = wt.residual_stack_save_plain(x0, cond, step, w)
        wt.stack_param_grads(p_xs, p_zs, *wt.residual_stack_chain_plain(p_zs, g, w), g, cond,
                             step, w, needs)

    ms = {
        "save": timed_ms(lambda: wt.residual_stack_save(x0, cond, step, w), 5, torch),
        "chain": timed_ms(lambda: wt.residual_stack_chain(zs, g, w), 5, torch),
        "backward": timed_ms(lambda: wt.stack_param_grads(
            xs, zs, *wt.residual_stack_chain(zs, g, w), g, cond, step, w, needs), 5, torch),
        "save_plain": timed_ms(lambda: wt.residual_stack_save_plain(x0, cond, step, w), 3, torch),
        "chain_plain": timed_ms(lambda: wt.residual_stack_chain_plain(zs, g, w), 3, torch),
        "plain_fwd_bwd": timed_ms(plain_fwd_bwd, 3, torch),
    }
    bt = b * t
    fwd_flops = 2 * bt * n_layers * (3 * c * 2 * c + h * 2 * c + c * 2 * c) + 2 * b * n_layers * c * c
    fwd_bytes = 4 * (bt * (c + h + c) + b * c + n_layers * (3 * c * 2 * c + h * 2 * c + c * 2 * c
                                                         + c * c + 7 * c) + n_layers * bt * 3 * c)
    chain_flops = 2 * bt * n_layers * (2 * c * c + 3 * 2 * c * c)
    chain_bytes = 4 * (n_layers * bt * 2 * c + bt * c + n_layers * (3 * c * 2 * c + c * 2 * c)
                       + n_layers * bt * 3 * c + bt * c)
    wgrad_flops = 2 * bt * n_layers * (3 * c * 2 * c + h * 2 * c + h * 2 * c + c * 2 * c)
    k5a = dict(max_abs_err=fwd_err, ms=ms["save"], plain_ms=ms["save_plain"], **bound(fwd_flops, fwd_bytes))
    k5b = dict(max_abs_err=chain_err, ms=ms["chain"], plain_ms=ms["chain_plain"],
               **bound(chain_flops, chain_bytes))
    log(f"K5a save-forward {tag}: kernel {ms['save']:.4f} ms, plain {ms['save_plain']:.4f} ms, bound "
        f"{k5a['bound_ms']:.4f} ms ({fwd_flops / 1e9:.1f} GFLOP, {fwd_bytes / 1e9:.3f} GB: "
        f"{k5a['bound_by']}), share of bound {k5a['bound_ms'] / ms['save']:.3f}")
    log(f"K5b backward chain {tag}: kernel {ms['chain']:.4f} ms, plain {ms['chain_plain']:.4f} ms, bound "
        f"{k5b['bound_ms']:.4f} ms ({chain_flops / 1e9:.1f} GFLOP, {chain_bytes / 1e9:.3f} GB: "
        f"{k5b['bound_by']}), share of bound {k5b['bound_ms'] / ms['chain']:.3f}")
    log(f"K5 whole backward (chain + cuBLAS weight/cond/step gradients, {wgrad_flops / 1e9:.1f} GFLOP "
        f"outside the chain): {ms['backward']:.4f} ms; the plain twins' forward + backward "
        f"{ms['plain_fwd_bwd']:.4f} ms; max gradient error {grad_err:.3e}")
    return k5a, k5b


# library kernels by substrings of their names, the first group that matches;
# cuDNN's implicit-GEMM convolutions (``sm80_xmma_fprop_implicit_gemm...``)
# also match "gemm", so the convolutions are looked for first
LIBRARY_GROUPS = {"convolution (cuDNN)": ("conv", "cudnn", "implicit", "winograd", "fft"),
                  "GEMM (cuBLAS)": ("gemm", "cutlass", "xmma", "gemv"),
                  "memcpy/memset": ("Memcpy", "Memset", "memcpy", "memset")}


def kernel_split(fn, n: int, ours: dict, torch):
    """torch.profiler over ``n`` calls of ``fn`` (after the caller's
    warm-up): (host-clock ms a call, kernel ms a call, {group: ms a call},
    [(ms, launches, name)] by kernel). The port's kernels are grouped by
    their exact function names (``ours``: name -> group), library kernels
    by substrings of theirs; the rest is "other"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us / 1e3 / n, e.count // n, e.key))
    other = "other (elementwise, reductions, indexing)"
    sums = {g: 0.0 for g in (*dict.fromkeys(ours.values()), *LIBRARY_GROUPS, other)}
    for ms, _, key in rows:
        # templates of anonymous-namespace types name them "(anonymous namespace)::T"
        name = re.search(r"(\w+)(?:<[^()]*>)?\(", key.replace("(anonymous namespace)::", ""))
        group = ours.get(name.group(1)) if name else None
        sums[group or next((g for g, keys in LIBRARY_GROUPS.items() if any(k in key for k in keys)),
                           other)] += ms
    return wall_ms, sum(ms for ms, _, _ in rows), sums, rows


def profile_render(core, segment, mel_len: int, torch) -> None:
    """Where one render of the 6 s request goes on the card: torch.profiler
    over two renders of its segment (teacher + vocoder + the wav's copy to
    the host), split into K1, the resblock stage, the other kernels and the
    device's idle share."""
    ours = {"step_proj_kernel": "K1 wavenet_stack", "cond_kernel": "K1 wavenet_stack",
            "chain_kernel": "K1 wavenet_stack", "conv_kernel": "K2/K3 resblock_stage"}
    core.infer(dict(segment))  # warm-up
    n = 2
    wall_ms, busy, sums, rows = kernel_split(lambda: core.infer(dict(segment)), n, ours, torch)
    if not rows:
        log("6 s render profile: the profiler saw no device time (not measured)")
        return
    log(f"{REQUEST_SECONDS[-1]:.0f} s render profile (torch.profiler, mean of {n} renders of the "
        f"request's segment, mel_len {mel_len}): {wall_ms:.3f} ms on the host clock, {busy:.3f} ms "
        f"of kernel time (device idle share {max(0.0, 1 - busy / wall_ms):.3f}); by group (ms): "
        + json.dumps({g: round(v, 3) for g, v in sums.items()}))
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:110]}")


def profile_train_step(trainer, batch, torch, label: str = "") -> dict:
    """Where one training step's device time goes: torch.profiler over two
    steps of the live trainer on one batch; the device time of every kernel
    by name, grouped, against the host-clock time of the window (the rest is
    the device's idle share). Returns the groups' ms a step."""
    for _ in range(2):  # warm-up
        trainer.train_step(batch)
    n = 2
    # the port's kernels (wavenet_train.cu) by their exact function names
    ours = {"save_gate_kernel": "K5a save-forward", "save_out_kernel": "K5a save-forward",
            "step_proj_kernel": "K5a save-forward", "chain_gate_kernel": "K5b backward chain",
            "chain_dy_kernel": "K5b backward chain"}
    wall_ms, busy, sums, rows = kernel_split(lambda: trainer.train_step(batch), n, ours, torch)
    label = label or f"training step (B={TRAIN_B} x T={TRAIN_T})"
    if not rows:
        log(f"{label} profile: the profiler saw no device time (not measured)")
        return {}
    log(f"{label} profile (torch.profiler, mean of {n} steps on one batch): {wall_ms:.3f} ms on "
        f"the host clock, {busy:.3f} ms of kernel time (device idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}); by group (ms): "
        + json.dumps({g: round(v, 3) for g, v in sums.items()}))
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    return sums


def train_config(data_dir: str) -> dict:
    from prodiff_tpu_torch.utils.synthetic import small_hparams

    hp = small_hparams(data_dir, **TRAIN_HPARAMS)
    hp.pop("work_dir")  # set from --exp_name
    return hp


def step_vs_cpu(label, task, make_model, batch, draws, dev, torch, tol=STEP_TOL,
                cpu_twins=False) -> dict:
    """One training step of ``make_model()``'s seeded weights (its denoiser's
    output projection seeded too: the reference zero-inits it) on a short
    numpy ``batch``, the same injected ``draws`` (t and noise, where the task
    takes them), dropout off: card (kernels + cuBLAS) vs CPU (the plain
    module loop, or with ``cpu_twins`` the card's route through the
    kernels' plain twins). The loss, every parameter's gradient and the
    params after one AdamW step are held within ``tol`` of each one's peak.
    Returns the kernel launches of the card's step."""
    import contextlib
    from unittest import mock

    from prodiff_tpu_torch.models import wavenet
    from prodiff_tpu_torch.training.optim import Optimizer
    from prodiff_tpu_torch.training.trainer import host_tensors

    torch.manual_seed(SEED)
    sd = make_model().state_dict()
    for key in sd:  # the teacher's, or a bare student's at denoise_fn
        if key.endswith("denoise_fn.output_projection.weight"):
            sd[key].normal_(std=0.02)
    out, launched = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = make_model()
        model.load_state_dict(sd)
        model.to(d).eval()  # dropout off; grad mode on, so the card runs K5
        opt = Optimizer(model.named_parameters(), task.hparams)
        lr = opt.lr()
        b = {k: v.to(d) for k, v in host_tensors(batch, pin=False).items()}
        before = {k: c.count for k, c in counters().items()}
        route = (mock.patch.object(wavenet, "on_kernels", lambda x, cycle: cycle == 1)
                 if cpu_twins and where == "cpu" else contextlib.nullcontext())
        with route:
            losses = task.compute_losses(model, b, **{k: torch.as_tensor(v, device=d)
                                                      for k, v in draws.items()})
            total = sum(losses.values())
            total.backward()
        if where == "card":
            torch.cuda.synchronize()
            launched = {k: c.count - before[k] for k, c in counters().items()
                        if c.count != before[k]}
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        opt.step()
        params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        out[where] = (total.detach().cpu(), grads, params)
    loss_err = grad_compare(f"{label}, one training step, card vs CPU: loss", out["card"][0],
                            out["cpu"][0], tol, torch)
    worst = ("", 0.0)
    for n in out["cpu"][1]:
        got, ref = out["card"][1][n], out["cpu"][1][n]
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-12)
        if not (torch.isfinite(got).all() and rel <= tol):
            raise AssertionError(f"{label}: gradient of {n}: card vs CPU {rel:.3e} x its peak")
        worst = max(worst, (n, rel), key=lambda x: x[1])
        # an element whose gradient is ~0 may take Adam's first step (at most ~lr)
        # either way, so the params also get twice the step's learning rate
        pg, pr = out["card"][2][n], out["cpu"][2][n]
        if float((pg - pr).abs().max()) > tol * float(pr.abs().max()) + 2 * lr:
            raise AssertionError(f"{label}: {n} after the update: card vs CPU beyond tolerance")
    log(f"{label}, one training step, card vs CPU: {len(out['cpu'][1])} parameter gradients "
        f"within {tol} x their peaks (worst {worst[0]}: {worst[1]:.3e}), loss "
        f"{float(out['cpu'][0]):.6f} (err {loss_err:.3e}), params after one AdamW step (lr "
        f"{lr:.1e}) within {tol} x their peaks + 2 lr; the card's step launched {launched}")
    return launched


def train_step_vs_cpu(trainer_hp, dev, torch):
    """One training step of a seeded full-width teacher on a short batch
    (B=2, T=128 of the synthetic set), same injected t and noise, dropout
    off: card (K5 + cuBLAS) vs CPU (the plain module loop)."""
    from prodiff_tpu_torch.tasks.svs import SVSTask

    task = SVSTask(trainer_hp)
    ds = task.train_iterator().dataset
    batch = ds.collater([ds[0], ds[1]])
    batch.pop("nsamples")
    batch = {k: v[:, :128] if k in ds.time_keys else v for k, v in batch.items()}
    rng = np.random.default_rng(SEED + 7)
    draws = {"t": np.array([1, 4]),
             "noise": rng.normal(size=(2, 1, *batch["mel"].shape[1:])).astype(np.float32)}
    step_vs_cpu("SVS teacher", task, task.build_model, batch, draws, dev, torch)


def phase_train(dev, torch):
    """The training path at full width through the train CLI, in-process."""
    import os
    import tempfile

    import yaml

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.utils.convert import load_flax_checkpoint, teacher_state_dict
    from prodiff_tpu_torch.utils.synthetic import make_svs_dataset
    from prodiff_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="prodiff_torch_train_")
    cwd = os.getcwd()
    data_dir = os.path.join(tmp, "data")
    t0 = time.time()
    make_svs_dataset(data_dir, n_train=128, n_valid=TRAIN_N_VALID, n_mels=128, seed=7,
                     t_ph_range=(32, 33), dur_range=(45, 49))
    hp = train_config(data_dir)
    cfg = os.path.join(tmp, "train.yaml")
    with open(cfg, "w") as f:
        yaml.dump(hp, f)
    log(f"synthetic dataset (128 train items, 128 mels, seed 7) and config written in "
        f"{time.time() - t0:.3f} s")

    calls = []  # (kind, global_step before, ms, launch deltas, batch shape)
    orig = {"train": Trainer.train_step, "val": Trainer.val_step}
    live = {}

    def wrap(kind):
        def run(self, batch):
            live["trainer"] = self
            torch.cuda.synchronize()
            before = {k: c.count for k, c in counters().items()}
            start = time.perf_counter()
            out = orig[kind](self, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            delta = {k: c.count - before[k] for k, c in counters().items()}
            calls.append((kind, self.global_step, ms, delta, tuple(batch["mel"].shape)))
            return out
        return run

    Trainer.train_step, Trainer.val_step = wrap("train"), wrap("val")
    argv = ["train", "svs", "--config", cfg, "--exp_name", "smoke"]
    os.chdir(tmp)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t0 = time.time()
        port_cli(argv + ["--max_steps", str(TRAIN_RESUME_AT)])
        t1 = time.time()
        port_cli(argv + ["--max_steps", str(TRAIN_STEPS)])
        t2 = time.time()
        torch.cuda.synchronize()
        totals = {k: c.count for k, c in counters().items()}
    finally:
        Trainer.train_step, Trainer.val_step = orig["train"], orig["val"]
        os.chdir(cwd)
    work = os.path.join(tmp, "checkpoints", "smoke", "svs")
    n_layers = hp["residual_layers"]
    per_train = {"residual_stack_save": 1 + 2 * n_layers, "residual_stack_chain": 2 * n_layers}
    per_val = {"residual_stack": K1_LAUNCHES}
    trains = [c for c in calls if c[0] == "train"]
    vals = [c for c in calls if c[0] == "val"]
    for kind, _, _, delta, shape in calls:
        want = per_train if kind == "train" else per_val
        if {k: v for k, v in delta.items() if v} != want or shape != (TRAIN_B, TRAIN_T, 128):
            raise AssertionError(f"a {kind} step launched {delta} on a {shape} batch, expected {want}")
    steps = [c[1] for c in trains]
    if steps != list(range(TRAIN_STEPS)):
        raise AssertionError(f"training steps ran from global steps {steps}")
    n_val = 1 + (TRAIN_RESUME_AT // TRAIN_VAL_EVERY) * TRAIN_N_VALID  # sanity batch + 2 validations
    if len(vals) != n_val:
        raise AssertionError(f"{len(vals)} validation batches, expected {n_val}")
    launches = check_counts("the training runs", {k: len(trains) * v for k, v in per_train.items()}
                            | {"residual_stack": len(vals) * per_val["residual_stack"]})
    log(f"train CLI: run 1 (steps 1-{TRAIN_RESUME_AT}) {t1 - t0:.3f} s, run 2 (restored at "
        f"step {trains[TRAIN_RESUME_AT][1]}, steps {TRAIN_RESUME_AT + 1}-{TRAIN_STEPS}) {t2 - t1:.3f} s, "
        f"wall clock with model build, validation and checkpoints; every training step launched "
        f"K5a {per_train['residual_stack_save']} and K5b {per_train['residual_stack_chain']} times "
        f"and K1 none; each of the {len(vals)} validation batches K1 {per_val['residual_stack']}")

    files = sorted(os.listdir(work))
    want_files = [f"model_ckpt_steps_{s}.ckpt" for s in (4, 8, 10)] + ["model_ckpt_best.pt"]
    if not all(f in files for f in want_files):
        raise AssertionError(f"work dir holds {files}, expected {want_files}")
    records = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    logged = [r for r in records if "tr/total_loss" in r]
    if [r["step"] for r in logged] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"logged steps {[r['step'] for r in logged]}")
    if not all(np.isfinite(v) for r in records for v in r.values()):
        raise AssertionError("a logged loss or gradient norm is not finite")
    log("logged per step (loss, grad norm): " + ", ".join(
        f"{r['step']}: {r['tr/total_loss']:.4f}/{r['tr/grad_norm']:.4f}" for r in logged))
    log("validation: " + ", ".join(f"step {r['step']}: {r['val/total_loss']:.4f}"
                                   for r in records if "val/total_loss" in r))

    trainer = live.pop("trainer")
    payload = load_flax_checkpoint(os.path.join(work, f"model_ckpt_steps_{TRAIN_STEPS}.ckpt"))
    if payload["global_step"] != TRAIN_STEPS:
        raise AssertionError(f"checkpoint at global_step {payload['global_step']}")
    read = teacher_state_dict(payload["state_dict"], trainer.hparams)
    live_sd = trainer.model.state_dict()
    if set(read) != set(live_sd) or not all(
            torch.equal(read[k], live_sd[k].cpu()) for k in live_sd):
        raise AssertionError("the params read back from the step-10 checkpoint differ from the model's")
    log(f"step-{TRAIN_STEPS} checkpoint read back through load_flax_checkpoint + teacher_state_dict: "
        f"{len(read)} tensors equal to the live model's "
        f"({os.path.getsize(os.path.join(work, f'model_ckpt_steps_{TRAIN_STEPS}.ckpt')) / 1e6:.1f} MB)")

    step_ms = sorted(c[2] for c in trains[1:])  # the first step warms the allocator up
    med = step_ms[len(step_ms) // 2]
    real = TRAIN_B * TRAIN_T
    log(f"training step (host clock, synchronised, steps 2-{TRAIN_STEPS}): median {med:.3f} ms, "
        f"min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}; {real / med * 1e3:.0f} frames/s at "
        f"B={TRAIN_B} x T={TRAIN_T}; validation batch median "
        f"{sorted(c[2] for c in vals)[len(vals) // 2]:.3f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    from prodiff_tpu_torch.training.trainer import DevicePrefetcher

    _, batch = next(iter(DevicePrefetcher(trainer.task.train_iterator(), dev)))
    profile_train_step(trainer, batch, torch)
    del trainer, live_sd, batch
    torch.cuda.empty_cache()
    train_step_vs_cpu(dict(hp, work_dir=work, task="svs"), dev, torch)
    return launches


# The variance phase: the predictors at the base config's widths (duration
# conv 512; pitch WaveNet 20 x 256 at dilation cycle 5, repeat_bins 64,
# euler reflow over sampling_steps 20; variance WaveNet 20 x 256 at dilation
# cycle 1 over voicing, breath and tension, 48 bins, 4 DDPM steps) and a
# diff_type: reflow teacher at the flagship width, on seeded random weights
VAR_EXP, VAR_STYLE = "variance", "spk1"
VAR_PHONES = dict(PHONE_SET, **{"a/zh": "a", "b/zh": "b"})  # + example.ds's phonemes
VAR_WORDS = dict({"ba": "b a"}, **{f"w{i}": f"p{2 * i} p{2 * i + 1}" for i in range(30)})
VAR_PHONE_KINDS = dict({"a": ("vowel", "vowel"), "b": ("consonant", "stop")},
                       **{f"p{i}": ("vowel", "vowel") if i % 2 else ("consonant", f"c{i % 3}")
                          for i in range(60)})
VAR_CATEGORIES = ["AP", "SP", "vowel", "stop", "c0", "c1", "c2"]
VAR_TOL = dict(atol=1e-3, rtol=1e-3)  # card vs CPU: durations (s), pitch (MIDI), curves (dB), mel
VAR_REPS = 5


def variance_project(proj: list) -> list:
    """``samples/example.ds`` (``proj``) with word-level note fields made consistent
    with its ``ph_num``: one note a word (``SP``/``AP`` words rest, the others
    sing the example's notes in order), each lasting its phonemes' given
    durations; ``ph_dur`` and ``f0_seq`` dropped, so the predictors make them.
    (As written, the file has fewer notes than words, on which the JAX
    package's predictors raise as the port's do.)"""
    out = []
    for seg in proj:
        phones, ph_dur = seg["ph_seq"].split(), [float(x) for x in seg["ph_dur"].split()]
        sung = iter(n for n in seg["note_seq"].split() if n != "rest")
        notes, durs, i = [], [], 0
        for n in (int(x) for x in seg["ph_num"].split()):
            word = phones[i:i + n]
            notes.append("rest" if set(word) <= {"SP", "AP"} else next(sung, "A3"))
            durs.append(f"{sum(ph_dur[i:i + n]):.2f}")
            i += n
        out.append({"offset": seg["offset"], "ph_seq": seg["ph_seq"], "ph_num": seg["ph_num"],
                    "note_seq": " ".join(notes), "note_dur": " ".join(durs),
                    "note_dur_seq": " ".join(durs), "note_slur": " ".join(["0"] * len(notes))})
    return out


def write_variance_tree(tmp: str, torch) -> dict:
    """``checkpoints/variance/{svs,dur,pitch,voicing,breath}`` under ``tmp``:
    each model built by the port on seeded weights and written as a JAX
    checkpoint (``*_flax_params``, ``utils/ckpt_utils.py``) with its
    ``config.yaml`` and maps; the NSF-HiFiGAN generator and a dictionary
    beside them. Returns the hparams by task."""
    import yaml

    from prodiff_tpu_torch.config import load_base_config
    from prodiff_tpu_torch.infer.handler import phone_encoder
    from prodiff_tpu_torch.models.duration import DurPredictor
    from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.models.vari_predictor import VariPredictor
    from prodiff_tpu_torch.utils import ckpt_utils, convert

    dict_dir = os.path.join(tmp, "dictionary")
    os.makedirs(dict_dir)
    with open(os.path.join(dict_dir, "zh.txt"), "w") as f:
        f.writelines(f"{w}\t{p}\n" for w, p in VAR_WORDS.items())
    with open(os.path.join(dict_dir, "zh_phones.txt"), "w") as f:
        f.writelines(f"{p} {k} {c}\n" for p, (k, c) in VAR_PHONE_KINDS.items())
    voc_dir = os.path.join(tmp, "nsf_hifigan")
    os.makedirs(voc_dir)
    torch.manual_seed(SEED)
    torch.save({"generator": seeded_generator(torch).state_dict()},
               os.path.join(voc_dir, "model"))
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump(VOCODER_H, f)

    base = load_base_config()
    hp = dict(base, seed=SEED, num_spk=len(SPEAKERS), languages={"zh": 1},
              datasets=[{"speaker": s} for s in SPEAKERS],
              dictionary={"zh": {"word": os.path.join(dict_dir, "zh.txt"),
                                 "phoneme": os.path.join(dict_dir, "zh_phones.txt")}},
              vocoder_ckpt=os.path.join(voc_dir, "model"), precompile_buckets=[[64, 512]])
    hps = {"svs": dict(hp, diff_type="reflow"), "dur": hp, "pitch": hp, "voicing": hp,
           "breath": hp}
    vocab = len(phone_encoder(VAR_PHONES))
    models = {
        "svs": (ProDiffTeacher(vocab, hps["svs"]), convert.teacher_flax_params),
        "dur": (DurPredictor(vocab, hp), convert.dur_predictor_flax_params),
        "pitch": (PitchPredictor(len(VAR_CATEGORIES) + 3, hp), convert.pitch_predictor_flax_params),
        "voicing": (VariPredictor(vocab, hp), convert.vari_predictor_flax_params),
        "breath": (VariPredictor(vocab, hp), convert.vari_predictor_flax_params),
    }
    maps = {"phone_set.json": VAR_PHONES, "spk_map.json": SPEAKERS, "lang_map.json": {"zh": 1},
            "ph_category_list.json": VAR_CATEGORIES}
    wanted = {"svs": ("phone_set.json", "spk_map.json", "lang_map.json"),
              "dur": ("phone_set.json",), "pitch": ("ph_category_list.json", "spk_map.json"),
              "voicing": ("phone_set.json",), "breath": ("phone_set.json",)}
    for task, (model, to_flax) in models.items():
        # the reference zero-inits each denoiser's output projection: seed it
        if hasattr(model, "diffusion"):
            out = model.diffusion.denoise_fn.output_projection
            torch.nn.init.normal_(out.weight, std=0.02)
        if isinstance(model, VariPredictor):
            # the curves diffuse in dB: centre each one's x0 in its clamp range,
            # so that a random net's curve is not pinned to the range's end
            r = model.diffusion.repeat_bins
            with torch.no_grad():
                for f, (lo, hi) in enumerate(model.diffusion.clamp_ranges):
                    out.bias[f * r:(f + 1) * r] = (lo + hi) / 2
        work = os.path.join(tmp, "checkpoints", VAR_EXP, task)
        os.makedirs(work)
        with open(os.path.join(work, "config.yaml"), "w") as f:
            yaml.dump(hps[task], f)
        for name in wanted[task]:
            with open(os.path.join(work, name), "w") as f:
                json.dump(maps[name], f)
        ckpt_utils.save_checkpoint(work, 1, {"state_dict": to_flax(model.state_dict(), hps[task]),
                                             "global_step": 1})
        n = sum(p.numel() for p in model.parameters())
        log(f"variance tree: {task} {type(model).__name__} {n / 1e6:.2f}M params, written as a "
            f"JAX checkpoint")
    return hps


def event_median_ms(fn, torch, reps: int = VAR_REPS) -> float:
    """Median of ``reps`` CUDA-event times of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def hold(name: str, got, ref) -> float:
    """Card vs CPU within ``VAR_TOL``; returns the largest error."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    ok = got.shape == ref.shape and np.isfinite(got).all() and np.allclose(got, ref, **VAR_TOL)
    log(f"card vs CPU {name} {list(ref.shape)}: max_abs_err {err:.3e}, range "
        f"[{ref.min():.3f}, {ref.max():.3f}], tol atol {VAR_TOL['atol']} + rtol {VAR_TOL['rtol']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the card's {name} disagrees with the CPU's")
    return err


def phase_variance(dev, torch):
    """The variance stack through the port's entry points at full width:
    ``infer --pred_dur --pred_pitch --pred_voicing --pred_breath`` on
    ``variance_project()`` with a reflow teacher, and the same project
    through ``SVSInferHandler.handle`` with the teacher read as prodiff
    (launch counts asserted),
    each predictor timed and held against the CPU on injected noise, the
    reflow teacher's render profiled and held against the CPU, and the web
    server's prediction routes. Returns the K1 launches of the render."""
    import copy
    import shutil
    import tempfile

    import yaml
    from scipy.io import wavfile

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.infer.handler import SVSInferHandler
    from prodiff_tpu_torch.serve.handler import WebHandler

    t_phase = time.time()
    marks = [t_phase]

    def mark(label):
        marks.append(time.time())
        log(f"variance phase, {label}: {marks[-1] - marks[-2]:.3f} s")

    tmp = tempfile.mkdtemp(prefix="prodiff_torch_variance_")
    root = os.path.join(tmp, "checkpoints")
    hps = write_variance_tree(tmp, torch)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples",
                           "example.ds")) as f:
        example = json.load(f)
    proj = variance_project(example)
    proj_fn = os.path.join(tmp, "example_pred.ds")
    with open(proj_fn, "w") as f:
        json.dump(proj, f)
    log(f"variance tree written in {time.time() - t_phase:.3f} s; project: "
        f"{[s['note_seq'] for s in proj]}")

    # 1. the CLI, in-process: every predictor, the reflow teacher, the vocoder
    acoustic_calls = []
    acoustic = SVSInferHandler._acoustic

    def counted(self, *args):
        acoustic_calls.append(args[1].shape)
        return acoustic(self, *args)

    def expected(steps):  # 2 curves x segments x 4 steps, and the teacher's steps a batch
        return {"residual_stack": K1_LAUNCHES * (2 * len(proj) * vari_steps
                                                 + steps * len(acoustic_calls)),
                "resblock_stage": len(acoustic_calls) * 5 * 18}

    def check_wav(label, seconds):
        out_wav = os.path.join(tmp, "infer_out", f"example_pred【{VAR_EXP}】.wav")
        sr, wav = wavfile.read(out_wav)
        os.remove(out_wav)
        if sr != hps["svs"]["audio_sample_rate"] or wav.ndim != 1 or wav.size == 0:
            raise AssertionError(f"{out_wav}: {sr} Hz, shape {wav.shape}")
        log(f"{label}: {seconds:.3f} s, wrote {wav.size} samples ({wav.size / sr:.3f} s, peak "
            f"{np.abs(wav).max()}), acoustic batches {[list(s) for s in acoustic_calls]}")

    vari_steps = hps["voicing"]["vari_prediction_args"]["timesteps"]
    cwd = os.getcwd()
    os.chdir(tmp)
    SVSInferHandler._acoustic = counted
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port_cli(["infer", proj_fn, "--exp_name", VAR_EXP, "--spk_name", "spk0", "--lang", "zh",
                  "--pred_dur", "--pred_pitch", VAR_STYLE, "--pred_voicing", "--pred_breath"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = check_counts("infer --pred_dur --pred_pitch --pred_voicing --pred_breath "
                                "(reflow teacher)", expected(hps["svs"]["sampling_steps"]))
    finally:
        SVSInferHandler._acoustic = acoustic
        os.chdir(cwd)
    check_wav(f"infer --pred_dur --pred_pitch {VAR_STYLE} --pred_voicing --pred_breath, reflow "
              f"teacher (in-process CLI, models loaded from JAX checkpoints)", cli_s)
    mark("the tree and the CLI render")

    # 2. the same render by the handler, the teacher read as diff_type
    # prodiff (4 DDPM steps: the same parameters, the svs config rewritten);
    # then each predictor held against the CPU and timed
    svs_cfg = os.path.join(root, VAR_EXP, "svs", "config.yaml")
    with open(svs_cfg, "w") as f:
        yaml.dump(dict(hps["svs"], diff_type="prodiff"), f)
    core = SVSInferHandler(VAR_EXP, checkpoints_root=root, pred_dur=True, pred_pitch=VAR_STYLE,
                           pred_voicing=True, pred_breath=True, device=dev,
                           out_dir=os.path.join(tmp, "infer_out"))
    with open(svs_cfg, "w") as f:  # the web server below reads the reflow teacher
        yaml.dump(hps["svs"], f)
    acoustic_calls.clear()
    SVSInferHandler._acoustic = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        core.handle(json.loads(json.dumps(proj)), proj_fn, "spk0", "zh")
        torch.cuda.synchronize()
        check_counts("SVSInferHandler(pred_dur, pred_pitch, pred_voicing, pred_breath).handle "
                     "(prodiff teacher)", expected(hps["svs"]["timesteps"]))
    finally:
        SVSInferHandler._acoustic = acoustic
    check_wav("the same project through SVSInferHandler.handle, prodiff teacher",
              time.perf_counter() - t0)
    seg = dict(proj[0], lang="zh", spk_name="spk0")
    phones = [core.ph_map[core.get_ph_text(p, "zh")] for p in seg["ph_seq"].split()]
    ph_num = [int(x) for x in seg["ph_num"].split()]
    note_dur = [float(x) for x in seg["note_dur"].split()]
    note_midi, note_rest = core._note_midi_seq(seg)
    note_dur_sec = np.array(seg["note_dur_seq"].split(), np.float32)
    prepared = core.prepare(dict(seg))
    mel_len, f0 = prepared["mel_len"], prepared["f0_seq"]
    timestep, t_pad = core.timestep, -(-mel_len // hps["pitch"]["length_bucket_step"]) * \
        hps["pitch"]["length_bucket_step"]
    tokens = core.dur_predictor.encode(phones)
    spk = core.pred_pitch_spk_id
    rng = np.random.default_rng(SEED + 7)
    pitch_noise = rng.normal(size=(1, 1, t_pad, 64)).astype(np.float32)
    n_feat = 3
    bins = hps["voicing"]["vari_prediction_args"]["repeat_bins"] // n_feat
    vari_init = rng.uniform(size=(1, n_feat, t_pad, bins)).astype(np.float32)
    vari_steps = rng.normal(size=(4, 1, n_feat, t_pad, bins)).astype(np.float32)

    def on(device, a):
        return torch.as_tensor(a, device=device)

    runs = {
        "dur": lambda inf, d: inf.run(tokens, ph_num, note_dur),
        "pitch": lambda inf, d: inf.run(note_midi, note_rest, note_dur_sec, mel_len, timestep,
                                        spk_id=spk, init_noise=on(d, pitch_noise)),
        "voicing": lambda inf, d: inf.run(note_midi, note_rest, note_dur_sec, mel_len, timestep,
                                          f0, init_noise=on(d, vari_init),
                                          step_noises=on(d, vari_steps)),
        "breath": lambda inf, d: inf.run(note_midi, note_rest, note_dur_sec, mel_len, timestep,
                                         f0, init_noise=on(d, vari_init),
                                         step_noises=on(d, vari_steps)),
    }
    def on_cpu(inferer):  # the same inferer with a copy of its weights on the CPU
        twin = copy.copy(inferer)
        twin.model, twin.device = copy.deepcopy(inferer.model).cpu(), torch.device("cpu")
        return twin

    cpu = {name: on_cpu(getattr(core, f"{name}_predictor"))
           for name in ("dur", "pitch", "voicing", "breath")}
    units = {"dur": "s", "pitch": "MIDI", "voicing": "dB", "breath": "dB"}
    times, errors = {}, {}
    raw = [torch.as_tensor(a) for a in cpu["dur"].model_inputs(tokens, ph_num, note_dur)]
    with torch.no_grad():
        errors["dur_model"] = hold("duration model's own output (s, before the alignment)",
                                   core.dur_predictor.model(*(a.to(dev) for a in raw)).cpu(),
                                   cpu["dur"].model(*raw))
    for name, run in runs.items():
        card_inf = getattr(core, f"{name}_predictor")
        got = run(card_inf, dev)
        errors[name] = hold(f"{name} predictor ({units[name]})", got, run(cpu[name], "cpu"))
        reset_counts()
        times[name] = event_median_ms(lambda: run(card_inf, dev), torch)
        n = counters()["residual_stack"].count
        log(f"{name} predictor on the card: median {times[name]:.3f} ms of {VAR_REPS} (CUDA "
            f"events around inferer.run: inputs to the card, the model, the result to the host; "
            f"mel_len {mel_len}, padded {t_pad}); K1 launches {n} in {VAR_REPS + 1} runs")
    del cpu
    mark("the predictors timed and held against the CPU")

    # 3. renders profiled: one predicted segment (every predictor, the prodiff
    # teacher, the vocoder; warm from the runs above), and the reflow
    # teacher's render of a segment with given durations and pitch on the web
    # server's handler (no predictors), whose teacher is then held against the
    # CPU
    ours = {"step_proj_kernel": "K1 wavenet_stack", "cond_kernel": "K1 wavenet_stack",
            "chain_kernel": "K1 wavenet_stack", "conv_kernel": "K2/K3 resblock_stage"}

    def profiled(label, fn, n):
        wall_ms, busy, sums, _ = kernel_split(fn, n, ours, torch)
        log(f"{label} (torch.profiler, mean of {n}): {wall_ms:.3f} ms host clock, {busy:.3f} ms "
            f"of kernel time (device idle share {max(0.0, 1 - busy / wall_ms):.3f}); by group "
            f"(ms): " + json.dumps({g: round(v, 3) for g, v in sums.items()}))

    profiled(f"predicted render of one segment (dur, pitch, voicing, breath, prodiff teacher, "
             f"vocoder; mel_len {mel_len})", lambda: core.infer(dict(seg)), 1)
    web = WebHandler(VAR_EXP, checkpoints_root=root, host="127.0.0.1", port=0, device=dev)
    teacher = web.core
    p = teacher.prepare(dict(example[1], lang="zh", spk_name="spk1"))  # given durations, f0
    teacher.render_batch([p])  # warm-up
    profiled(f"reflow render ({hps['svs']['sampling_steps']} euler steps + NSF-HiFiGAN, mel_len "
             f"{p['mel_len']})", lambda: teacher.render_batch([p]), 2)
    mark("the renders profiled")

    # 4. the reflow teacher held against the CPU; the web server's prediction
    # routes and a render of what they predict
    args = (p["ph_tokens"][None], p["mel2ph"][None], p["f0_seq"][None],
            np.full((1, p["t_ph"]), p["lang_id"]), p["spk_mix_embed"], None, p["voicing"][None],
            p["breath"][None])
    cpu_t = SVSInferHandler(hparams=teacher.hparams, maps={"phone_set": teacher.ph_map,
                                                           "spk_map": teacher.spk_map,
                                                           "lang_map": teacher.lang_map},
                            state_dict={k: v.cpu() for k, v in teacher.model.state_dict().items()},
                            vocoder=teacher.vocoder, deterministic=True, device="cpu")
    teacher.deterministic = True
    errors["reflow_mel"] = hold(f"reflow teacher mel (log10, {hps['svs']['sampling_steps']} "
                                f"euler steps from a zero start)",
                                teacher._acoustic(*args).cpu().numpy(), cpu_t._acoustic(*args))
    teacher.deterministic = False
    del cpu_t
    server = web.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        info = post(f"{url}/api/basic_info")
        if info["pitch_styles"] != list(SPEAKERS):
            raise AssertionError(f"basic_info pitch_styles {info['pitch_styles']}")
        words, word_dur = ["ba", "w3", "SP", "w7", "w11"], [0.45, 0.5, 0.2, 0.6, 0.55]
        t0 = time.perf_counter()
        dur = post(f"{url}/api/pred_dur", {"language": "zh", "word_list": words,
                                           "word_dur_list": word_dur, "start_time": 1.0})
        dur_ms = (time.perf_counter() - t0) * 1e3
        ph = [p for w in dur["note_ph_list"] for p in w]
        if len(dur["note_ph_list"]) != len(words) or len(ph) != 1 + 2 * 4 + 1 or \
                abs(ph[-1]["end_time"] - dur["start_time"] - 0.5 - sum(word_dur)) > 1e-4:
            raise AssertionError(f"/api/pred_dur: {dur}")
        phones = [p["ph"] for p in ph]
        ph_dur = [p["end_time"] - p["start_time"] for p in ph]
        ph_acc = np.round(np.cumsum(ph_dur) / web.timestep + 0.5).astype(np.int64)
        mel_len = int(ph_acc[-1])
        req = {"language": "zh", "ph_text_list": phones, "ph_dur_list": ph_dur,
               "note_midi_list": [-1.0, 57.0, 59.0, -1.0, 62.0, 60.0],
               "note_dur_list": [0.5] + word_dur, "style": VAR_STYLE}
        t0 = time.perf_counter()
        pitch = post(f"{url}/api/pred_pitch", req)["pitch"]
        pitch_ms = (time.perf_counter() - t0) * 1e3
        if len(pitch) != mel_len or not np.isfinite(pitch).all():
            raise AssertionError(f"/api/pred_pitch: {len(pitch)} values, want {mel_len}")
        t0 = time.perf_counter()
        wav = post(f"{url}/api/infer", {"speaker": "spk0", "language": "zh",
                                        "ph_text_list": phones, "ph_dur_list": ph_dur,
                                        "pitch_list": pitch})["wav"]
        infer_ms = (time.perf_counter() - t0) * 1e3
        if len(wav) != mel_len * web.hparams["hop_size"] or not np.isfinite(wav).all():
            raise AssertionError(f"/api/infer: {len(wav)} samples, want {mel_len} frames")
        log(f"web: /api/pred_dur {len(phones)} phonemes in {dur_ms:.3f} ms, /api/pred_pitch "
            f"{mel_len} frames in {pitch_ms:.3f} ms, /api/infer {len(wav)} samples in "
            f"{infer_ms:.3f} ms (HTTP 200 each, host clock at the client)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    mark("the reflow teacher held against the CPU, and the web routes")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"variance phase: {time.time() - t_phase:.3f} s; predictor medians (ms) "
        f"{json.dumps({k: round(v, 3) for k, v in times.items()})}; card vs CPU max errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errors.items()})}")
    return launches


# The variance-training phase: the dur, pitch and vari tasks and a reflow
# teacher at the base config's widths; the CLI route on a synthetic corpus of
# seeded tones (0.7 s at 44.1 kHz, 60 frames) and seeded vari shards
VT_EXP, VT_ITEMS, VT_STEPS = "vtrain", 8, 3
VT_B, VT_T_PH, VT_T_NOTE, VT_T_MEL = 2, 24, 12, 128  # the card-vs-CPU step's batch
VT_PHONES = {"a": ("vowel", "vowel"), "b": ("consonant", "stop"), "c": ("consonant", "fric")}


def variance_train_batches(hp: dict, rng, b: int = VT_B, t_ph: int = VT_T_PH,
                           t_note: int = VT_T_NOTE, t_mel: int = VT_T_MEL,
                           vocab: int = 10) -> dict:
    """A seeded batch (by default the short one, B=2, T_mel=128; the second
    item padded) for each task, with its injected draws; phoneme ids below
    ``vocab``."""
    from prodiff_tpu_torch.models.vari_predictor import variance_list

    tokens = rng.integers(3, vocab, (b, t_ph))
    tokens[1, t_ph - 4:] = 0
    mel2ph = np.repeat(np.arange(1, t_ph + 1), t_mel // t_ph + 1)[:t_mel][None].repeat(b, 0)
    mel2note = np.repeat(np.arange(1, t_note + 1), t_mel // t_note + 1)[:t_mel][None].repeat(b, 0)
    mel2ph[1, t_mel * 25 // 32:] = mel2note[1, t_mel * 25 // 32:] = 0
    notes = {"note_midi": rng.uniform(50, 70, (b, t_note)).astype(np.float32),
             "note_rest": rng.random((b, t_note)) < 0.3, "mel2note": mel2note}
    f0 = rng.uniform(100, 400, (b, t_mel)).astype(np.float32)
    base = rng.uniform(55, 65, (b, t_mel)).astype(np.float32)
    n_var = len(variance_list(hp))
    bins = hp["vari_prediction_args"]["repeat_bins"]

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "dur": ({"ph_seq": tokens, "onset": ((tokens > 0) & (np.arange(t_ph) % 3 == 0)) * 1,
                 "word_dur": rng.uniform(0.2, 0.6, (b, t_ph)).astype(np.float32),
                 "ph_dur": rng.uniform(0.05, 0.3, (b, t_ph)).astype(np.float32) * (tokens > 0)},
                {}),
        "pitch": (dict(notes, ph_seq=tokens, mel2ph=mel2ph, base_pitch=base,
                       pitch=base + normal(b, t_mel), spk_id=np.zeros(b, np.int64),
                       pitch_retake=(rng.random((b, t_mel)) < 0.5).astype(np.int32)),
                  {"t": np.resize(np.array([0.3, 0.8], np.float32), b),
                   "noise": normal(b, 1, t_mel, hp["f0_prediction_args"]["repeat_bins"])}),
        "vari": (dict(notes, ph_seq=tokens, mel2ph=mel2ph, f0=f0, spk_id=np.zeros(b, np.int64),
                      **{k: rng.uniform(-90, -15, (b, t_mel)).astype(np.float32)
                         for k in variance_list(hp)}),
                 {"t": np.resize(np.array([3, 0]), b),
                  "noise": normal(b, n_var, t_mel, bins // n_var)}),
        "svs": ({"ph_seq": tokens, "mel2ph": mel2ph, "f0": f0, "lang_seq": (tokens > 0) * 1,
                 "spk_id": np.zeros(b, np.int64),
                 "voicing": np.full((b, t_mel), -30.0, np.float32),
                 "breath": np.full((b, t_mel), -60.0, np.float32),
                 "mel": rng.uniform(-10, -2, (b, t_mel, hp["audio_num_mel_bins"])).astype(
                     np.float32)},
                {"t": np.resize(np.array([0.05, 0.6], np.float32), b),
                 "noise": normal(b, 1, t_mel, hp["audio_num_mel_bins"])}),
    }


def write_variance_corpus(tmp: str) -> str:
    """Seeded tones with labels (two words a phrase, one sung note and a
    rest) and a phoneme dictionary under ``tmp``; returns the corpus dir."""
    from scipy.io import wavfile

    raw = os.path.join(tmp, "raw")
    os.makedirs(os.path.join(raw, "wav"))
    rng = np.random.default_rng(SEED + 8)
    sr, labels = 44100, {}
    for i in range(VT_ITEMS):
        t = np.arange(int(sr * 0.7)) / sr
        wav = 0.4 * np.sin(2 * np.pi * 196.0 * 2 ** (rng.uniform(-4, 4) / 12) * t) * np.hanning(len(t))
        wavfile.write(os.path.join(raw, "wav", f"it{i}.wav"), sr, (wav * 32767).astype(np.int16))
        labels[f"it{i}"] = {"ph_seq": "SP b a c a", "ph_num": "1 2 2",
                            "ph_dur": f"0.1 0.08 {0.2 + 0.01 * i:.2f} 0.1 {0.22 - 0.01 * i:.2f}",
                            "note_seq": "rest G3 A3", "note_dur": "0.1 0.3 0.3"}
    with open(os.path.join(raw, "label.json"), "w") as f:
        json.dump(labels, f)
    with open(os.path.join(tmp, "zh_phones.txt"), "w") as f:
        f.writelines(f"{p} {k} {c}\n" for p, (k, c) in VT_PHONES.items())
    return raw


def write_vari_shards(data_dir: str, hp: dict, phone_set: dict) -> None:
    """The vari task's shards from seeded arrays (the data-pipeline phase
    runs the binarizers): one phrase an item, 60-128 frames."""
    from prodiff_tpu_torch.models.vari_predictor import variance_list
    from prodiff_tpu_torch.utils.indexed_datasets import IndexedDatasetBuilder

    os.makedirs(data_dir)
    with open(os.path.join(data_dir, "phone_set.json"), "w") as f:
        json.dump(phone_set, f)
    vocab = len(set(phone_set.values())) + 3
    rng = np.random.default_rng(SEED + 9)
    for prefix, n in (("valid", 1), ("train", VT_ITEMS)):
        builder, lengths = IndexedDatasetBuilder(data_dir, prefix), []
        for _ in range(n):
            t_mel, t_ph, t_note = int(rng.integers(60, 129)), 6, 3
            item = {"ph_seq": rng.integers(3, vocab, t_ph), "spk_id": 0,
                    "mel2ph": np.sort(rng.integers(1, t_ph + 1, t_mel)),
                    "mel2note": np.sort(rng.integers(1, t_note + 1, t_mel)),
                    "note_midi": rng.uniform(50, 70, t_note), "note_rest": np.zeros(t_note, bool),
                    "f0": rng.uniform(150, 300, t_mel).astype(np.float32), "length": t_mel}
            for name in variance_list(hp):
                item[name] = rng.uniform(-80, -20, t_mel).astype(np.float32)
            builder.add_item(item)
            lengths.append(t_mel)
        builder.finalize()
        np.save(os.path.join(data_dir, f"{prefix}_lengths.npy"), lengths)


def phase_variance_train(dev, torch):
    """The variance stack's training at full width: one training step of each
    task (and of a reflow teacher) held against the CPU; then ``binarize
    dur|pitch`` and ``train dur|pitch|vari`` through the CLI (in-process) on
    a synthetic corpus, each run ending in one validation, the launch counts
    of that run asserted (K5 on every vari step and K1 in vari's
    validation, none on dur and pitch), and each trained checkpoint read by
    its inferer for one segment; last, the live vari trainer's step profiled
    at the training cell's batch (B=16 x T=1536). Returns the launches of
    the run."""
    import shutil
    import tempfile

    import yaml

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.config import load_base_config, set_hparams
    from prodiff_tpu_torch.infer.inferers import (DurPredictorInferer, PitchPredictorInferer,
                                                  VariPredictorInferer)
    from prodiff_tpu_torch.models.duration import DurPredictor
    from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.models.vari_predictor import VariPredictor
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer, host_tensors

    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="prodiff_torch_vtrain_")
    raw = write_variance_corpus(tmp)
    hp = dict(load_base_config(), seed=SEED, data_dir=os.path.join(tmp, "data"),
              datasets=[{"data_dir": raw, "speaker": "s0", "language": "zh"}],
              dictionary={"zh": {"phoneme": os.path.join(tmp, "zh_phones.txt")}},
              languages={"zh": 1}, num_spk=1, test_num=1, valid_num=1, pitch_extractor="acf",
              max_updates=VT_STEPS, val_check_interval=VT_STEPS, num_sanity_val_steps=0,
              tb_log_interval=1, max_sentences=4, max_tokens=4000, mel_loss="l1:0.5|ssim:0.5")

    # 1. one step of each task, card vs CPU, on a short batch
    rng = np.random.default_rng(SEED + 10)
    batches = variance_train_batches(hp, rng)
    teacher_hp = dict(hp, diff_type="reflow")  # the base config is the flagship's width
    models = {"dur": lambda: DurPredictor(10, hp), "pitch": lambda: PitchPredictor(10, hp),
              "vari": lambda: VariPredictor(10, hp), "svs": lambda: ProDiffTeacher(10, teacher_hp)}
    n_layers = hp["vari_prediction_args"]["denoise_args"]["residual_layers"]
    per_k5 = {"residual_stack_save": 1 + 2 * n_layers, "residual_stack_chain": 2 * n_layers}
    for name, make in models.items():
        task = get_task_cls(name)(dict(teacher_hp if name == "svs" else hp, task=name))
        launched = step_vs_cpu(f"{name} task ({'reflow teacher' if name == 'svs' else 'full width'}"
                               f", B={VT_B}, T_mel={VT_T_MEL})", task, make, *batches[name], dev,
                               torch)
        if launched != (per_k5 if name in ("vari", "svs") else {}):
            raise AssertionError(f"{name}: the card's training step launched {launched}")
    t_steps = time.time()

    # 2. binarize dur|pitch, vari shards, train dur|pitch|vari, the inferers
    cfg = os.path.join(tmp, "vtrain.yaml")
    with open(cfg, "w") as f:
        yaml.dump(hp, f)
    calls, evals = [], []  # (task, launch deltas, ms)
    orig, orig_eval = Trainer.train_step, Trainer.evaluate
    live = {}

    def launched_by(fn, self, *args):
        torch.cuda.synchronize()
        before = {k: c.count for k, c in counters().items()}
        start = time.perf_counter()
        out = fn(self, *args)
        torch.cuda.synchronize()
        return out, {k: c.count - before[k] for k, c in counters().items()
                     if c.count != before[k]}, (time.perf_counter() - start) * 1e3

    def counted(self, batch):
        live[self.hparams["task"]] = self
        out, delta, ms = launched_by(orig, self, batch)
        calls.append((self.hparams["task"], delta, ms))
        return out

    def counted_eval(self, task, *args, **kw):
        out, delta, ms = launched_by(lambda s, t: orig_eval(s, t, *args, **kw), self, task)
        evals.append((self.hparams["task"], delta, ms))
        return out

    cwd = os.getcwd()
    os.chdir(tmp)
    Trainer.train_step, Trainer.evaluate = counted, counted_eval
    marks = {}
    try:
        reset_counts()
        t0 = time.time()
        for task in ("dur", "pitch"):
            port_cli(["binarize", task, "--config", cfg, "--exp_name", VT_EXP])
        marks["binarize"] = time.time() - t0
        with open(os.path.join(hp["data_dir"], "dur", "phone_set.json")) as f:
            write_vari_shards(os.path.join(hp["data_dir"], "vari"), hp, json.load(f))
        for task in ("dur", "pitch", "vari"):
            t0 = time.time()
            port_cli(["train", task, "--config", cfg, "--exp_name", VT_EXP])
            marks[f"train {task}"] = time.time() - t0
        t0 = time.time()
        dur_inf = DurPredictorInferer.from_workdir(VT_EXP, "checkpoints", None, device=dev)
        ph_dur = dur_inf.run(dur_inf.encode(["SP", "b", "a", "c", "a"]), [1, 2, 2], [0.1, 0.3, 0.3])
        pitch_inf = PitchPredictorInferer.from_workdir(VT_EXP, "checkpoints", device=dev)
        note_args = (np.array([57.0, 55.0, 57.0]), np.array([True, False, False]),
                     np.array([0.1, 0.3, 0.3]), 60, hp["hop_size"] / hp["audio_sample_rate"])
        f0_midi = pitch_inf.run(*note_args, spk_id=0)
        vari_inf = VariPredictorInferer(set_hparams(VT_EXP, "vari"), "voicing", device=dev)
        voicing = vari_inf.run(*note_args, 440.0 * 2 ** ((f0_midi - 69) / 12))
        torch.cuda.synchronize()
        marks["inferers"] = time.time() - t0
        vari_steps = sum(c[0] == "vari" for c in calls)
        launches = check_counts(
            "binarize dur|pitch, train dur|pitch|vari and the inferers on the trained checkpoints",
            {k: vari_steps * v for k, v in per_k5.items()}
            | {"residual_stack": (hp["vari_prediction_args"]["timesteps"] + 1) * K1_LAUNCHES})
    finally:
        Trainer.train_step, Trainer.evaluate = orig, orig_eval
        os.chdir(cwd)
    for task, delta, _ in calls:
        if delta != (per_k5 if task == "vari" else {}):
            raise AssertionError(f"a {task} training step launched {delta}")
    if [c[0] for c in calls] != [t for t in ("dur", "pitch", "vari") for _ in range(VT_STEPS)]:
        raise AssertionError(f"training steps ran as {[c[0] for c in calls]}")
    # one validation a run (the valid set is one item): K1 once in vari's
    want_evals = [(t, {"residual_stack": K1_LAUNCHES} if t == "vari" else {})
                  for t in ("dur", "pitch", "vari")]
    if [(t, d) for t, d, _ in evals] != want_evals:
        raise AssertionError(f"validations ran as {evals}, expected {want_evals}")
    if not (np.isfinite(ph_dur).all() and abs(ph_dur[1:3].sum() - 0.3) < 1e-4
            and f0_midi.shape == voicing.shape == (60,) and np.isfinite(f0_midi).all()
            and np.isfinite(voicing).all()):
        raise AssertionError(f"inferers from the trained checkpoints: durations {ph_dur}, "
                             f"f0 {f0_midi.shape}, voicing {voicing.shape}")
    for task in ("dur", "pitch", "vari"):
        work = os.path.join(tmp, "checkpoints", VT_EXP, task)
        records = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
        losses = [r["tr/total_loss"] for r in records if "tr/total_loss" in r]
        val = [r["val/total_loss"] for r in records if "val/total_loss" in r]
        if (len(losses) != VT_STEPS or not np.isfinite(losses).all() or len(val) != 1
                or not np.isfinite(val).all() or not os.path.exists(
                    os.path.join(work, f"model_ckpt_steps_{VT_STEPS}.ckpt"))):
            raise AssertionError(f"train {task}: logged losses {losses}, validation {val}, files "
                                 f"{os.listdir(work)}")
        ms = sorted(c[2] for c in calls if c[0] == task)
        val_ms = [e[2] for e in evals if e[0] == task][0]
        log(f"train {task} (CLI, in-process; smoke batches B <= 4 x T <= 128): losses "
            f"{[round(v, 4) for v in losses]}, validation {val[0]:.4f}; step times (host clock, "
            f"synchronised) median {ms[len(ms) // 2]:.3f} ms, min {ms[0]:.3f}, max "
            f"{ms[-1]:.3f}; validation {val_ms:.3f} ms; K5 launches a step "
            f"{per_k5 if task == 'vari' else 0}")
    log(f"inferers from the trained checkpoints: durations {np.round(ph_dur, 4).tolist()} s, f0 "
        f"{f0_midi.min():.2f}-{f0_midi.max():.2f} MIDI, voicing {voicing.min():.2f}-"
        f"{voicing.max():.2f} dB; seconds: " + json.dumps({k: round(v, 3) for k, v in marks.items()}))
    # the live vari trainer's step at the training cell's batch (the smoke
    # corpus's batches are 1/50 of its frames): where its time goes
    trainer = live["vari"]
    big = variance_train_batches(hp, np.random.default_rng(SEED + 13), TRAIN_B,
                                 TRAIN_T * VT_T_PH // VT_T_MEL, TRAIN_T * VT_T_NOTE // VT_T_MEL,
                                 TRAIN_T, vocab=len(trainer.task.ph_encoder))["vari"][0]
    batch = {k: v.to(dev) for k, v in host_tensors(big, pin=False).items()}
    reset_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    check_counts(f"one vari training step at B={TRAIN_B} x T={TRAIN_T}", per_k5)
    sums = profile_train_step(trainer, batch, torch,
                              label=f"vari training step (B={TRAIN_B} x T={TRAIN_T})")
    if sums and not sums.get("K5a save-forward", 0) > 0:
        raise AssertionError("the vari step's profile found no K5 time")
    del trainer, batch, live
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"variance-training phase: {time.time() - t_phase:.3f} s (card-vs-CPU steps "
        f"{t_steps - t_phase:.3f} s)")
    return launches


# The data-pipeline phase: preprocess -> binarize svs (RMVPE, VR voicing,
# breath and tension) -> train svs -> binarize svs_rectified -> vocode
# wav2wav under the base config's RMVPE -> infer --isolate_* -> /api/infer
# with the VR gain, on seeded full-width RMVPE (E2E0(4, 1, (2, 2))) and VR
# weights. VR has no config in the repository: the JAX constructor's defaults
# (nout 32, nout_lstm 128) at the base config's STFT (n_fft 2048, hop 512, mono)
DP_EXP = "datapipe"
DP_SECONDS = tuple(float(s) for s in np.linspace(2.0, 6.0, 8))  # the corpus: 8 tones at 44.1 kHz
DP_VR_CONFIG = {"n_fft": 2048, "hop_length": 512, "n_out": 32, "n_out_lstm": 128, "is_mono": True}
DP_PEAK_BIN = 150  # the seeded RMVPE's output bias peaks here (~179 Hz), as a trained salience would
DP_TRAIN_STEPS = 2
DP_WAV_TOL = 1e-4  # card vs CPU: the separated and harmonic wavs (float, peak ~0.4)
DP_PHONES = {"a": ("vowel", "vowel"), "b": ("consonant", "stop")}


def dp_seed_batch_norms(model, seed: int, torch):
    """Seeded BatchNorm statistics and affine parameters (eval mode would
    otherwise be the identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
                mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
    return model.eval()


def write_dp_checkpoints(tmp: str, torch) -> None:
    """The base config's checkpoint paths under ``tmp`` (the cwd of the
    phase): ``checkpoints/rmvpe/model.pt`` (``pe_ckpt``),
    ``checkpoints/vr/model.pt`` + ``config.yaml`` (``vr_ckpt``) and
    ``checkpoints/nsf_hifigan/model`` + ``config.json`` (``vocoder_ckpt``), all
    seeded torch state dicts under the reference's names."""
    import yaml

    from prodiff_tpu_torch.models.rmvpe import E2E0
    from prodiff_tpu_torch.models.vr import CascadedNet

    for sub in ("rmvpe", "vr", "nsf_hifigan"):
        os.makedirs(os.path.join(tmp, "checkpoints", sub))
    torch.manual_seed(SEED + 20)
    rmvpe = dp_seed_batch_norms(E2E0(4, 1, (2, 2)), SEED + 21, torch)
    with torch.no_grad():
        bias = rmvpe.fc[1].bias
        bias.fill_(-3.0)
        bias[DP_PEAK_BIN - 2:DP_PEAK_BIN + 3] = torch.tensor([0.5, 2.0, 4.0, 2.5, 1.0])
    torch.save(rmvpe.state_dict(), os.path.join(tmp, "checkpoints", "rmvpe", "model.pt"))
    torch.manual_seed(SEED + 22)
    vr = dp_seed_batch_norms(CascadedNet(DP_VR_CONFIG["n_fft"], DP_VR_CONFIG["hop_length"],
                                         DP_VR_CONFIG["n_out"], DP_VR_CONFIG["n_out_lstm"]),
                             SEED + 23, torch)
    torch.save(vr.state_dict(), os.path.join(tmp, "checkpoints", "vr", "model.pt"))
    with open(os.path.join(tmp, "checkpoints", "vr", "config.yaml"), "w") as f:
        yaml.dump(DP_VR_CONFIG, f)
    torch.manual_seed(SEED + 24)
    torch.save({"generator": seeded_generator(torch).state_dict()},
               os.path.join(tmp, "checkpoints", "nsf_hifigan", "model"))
    with open(os.path.join(tmp, "checkpoints", "nsf_hifigan", "config.json"), "w") as f:
        json.dump(VOCODER_H, f)
    n_r, n_v = (sum(p.numel() for p in m.parameters()) for m in (rmvpe, vr))
    log(f"data pipeline: seeded RMVPE E2E0 {n_r / 1e6:.2f}M params, VR CascadedNet "
        f"{n_v / 1e6:.2f}M params ({json.dumps(DP_VR_CONFIG)})")


def write_textgrid_corpus(tmp: str) -> str:
    """8 seeded vibrato tones (2-6 s, three partials and a breath of noise)
    with a TextGrid ``phone`` tier and ``.rawmid`` notes each, and
    ``dictionary/zh_phones.txt``; returns the corpus dir (no label.json)."""
    import pickle

    from scipy.io import wavfile

    raw = os.path.join(tmp, "raw")
    for sub in ("wav", "TextGrid", "midi"):
        os.makedirs(os.path.join(raw, sub))
    os.makedirs(os.path.join(tmp, "dictionary"))
    with open(os.path.join(tmp, "dictionary", "zh_phones.txt"), "w") as f:
        f.writelines(f"{p} {k} {c}\n" for p, (k, c) in DP_PHONES.items())
    rng = np.random.default_rng(SEED + 25)
    sr = 44100
    for i, seconds in enumerate(DP_SECONDS):
        n = int(round(seconds * sr))
        t = np.arange(n) / sr
        f0 = 196.0 * 2 ** (rng.uniform(-4, 4) / 12)
        phase = 2 * np.pi * np.cumsum(f0 * 2 ** (0.5 * np.sin(2 * np.pi * 5 * t) / 12)) / sr
        y = np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)
        y = 0.3 * y / np.abs(y).max() + 0.01 * rng.normal(size=n)
        y = y * np.minimum(1.0, np.minimum(t, t[-1] - t) / 0.05)  # 50 ms fades
        wavfile.write(os.path.join(raw, "wav", f"it{i}.wav"), sr, (y * 32767).astype(np.int16))
        n_words = int((seconds - 0.4) / 0.4)
        word = (seconds - 0.4) / n_words
        marks = [("SP", 0.2)] + [p for _ in range(n_words) for p in (("b", 0.08), ("a", word - 0.08))] \
            + [("SP", seconds - 0.2 - n_words * word)]
        edges = np.concatenate([[0.0], np.cumsum([d for _, d in marks])])
        lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
                 "xmin = 0", f"xmax = {seconds}", "tiers? <exists>", "size = 1", "item []:",
                 "    item [1]:", '        class = "IntervalTier"', '        name = "phone"',
                 "        xmin = 0", f"        xmax = {seconds}",
                 f"        intervals: size = {len(marks)}"]
        for j, (mark, _) in enumerate(marks):
            lines += [f"        intervals [{j + 1}]:", f"            xmin = {edges[j]:.6f}",
                      f"            xmax = {edges[j + 1]:.6f}", f'            text = "{mark}"']
        with open(os.path.join(raw, "TextGrid", f"it{i}.TextGrid"), "w") as f:
            f.write("\n".join(lines) + "\n")
        notes = [float(np.round(69 + 12 * np.log2(f0 / 440), 2))] * n_words
        with open(os.path.join(raw, "midi", f"it{i}.rawmid"), "wb") as f:
            pickle.dump({"note_midi": [60.0] + notes + [60.0],
                         "note_rest": [True] + [False] * n_words + [True],
                         "note_dur": [0.2] + [word] * n_words + [marks[-1][1]]}, f)
    return raw


def phase_data_pipeline(dev, torch):
    """The data pipeline through the port's entry points at full width, in a
    temporary directory that holds the base config's checkpoint paths:
    ``preprocess`` of a TextGrid corpus, ``binarize svs`` with the base
    config's RMVPE and the VR model's voicing, breath and tension, ``train
    svs`` for 2 steps on those shards, ``binarize svs_rectified`` with the
    trained flagship teacher, ``vocode wav2wav`` under the unmodified base
    config's ``pitch_extractor: rmvpe``, ``infer --isolate_aspiration
    --isolate_base_harmonic`` of ``samples/example.ds`` and one ``/api/infer``
    with the VR gain; each step's launches counted, the features held against
    the CPU, RMVPE and VR timed by CUDA events, one binarized item profiled.
    Returns the launches of the phase's main path, by kernel, and the tree it
    built (``tmp``, the config ``hp``, the trained teacher's work dir), which
    the distillation phase reuses and removes; on a failure it is removed
    here."""
    import shutil
    import tempfile

    import yaml
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.binarize import get_binarizer_cls
    from prodiff_tpu_torch.config import load_base_config
    from prodiff_tpu_torch.infer.handler import SVSInferHandler
    from prodiff_tpu_torch.models.vr import load_sep_model
    from prodiff_tpu_torch.separation import extract_harmonic_aperiodic
    from prodiff_tpu_torch.serve.handler import WebHandler
    from prodiff_tpu_torch.training.trainer import Trainer
    from prodiff_tpu_torch.utils.audio import load_wav
    from prodiff_tpu_torch.utils.indexed_datasets import IndexedDataset

    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="prodiff_torch_datapipe_")
    cwd = os.getcwd()
    os.chdir(tmp)  # the base config's relative checkpoint and dictionary paths resolve here
    spans, totals = {}, {k: 0 for k in COUNTED}

    def step(label, want, fn):
        """Run one step of the main path with the counts at 0, check them."""
        torch.cuda.synchronize()
        reset_counts()
        start = time.time()
        out = fn()
        torch.cuda.synchronize()
        spans[label] = round(time.time() - start, 3)
        for k, v in check_counts(f"data pipeline: {label}", want).items():
            totals[k] += v
        return out

    try:
        write_dp_checkpoints(tmp, torch)
        raw = write_textgrid_corpus(tmp)
        per_render = {"residual_stack": BASE_HPARAMS["timesteps"] * K1_LAUNCHES,
                      "resblock_stage": 5 * 18}

        # 1. preprocess (host only)
        step("preprocess", {}, lambda: port_cli(["preprocess", raw, "--extract_note",
                                                 "--override_ori_label"]))
        with open(os.path.join(raw, "label.json")) as f:
            labels = json.load(f)
        for name, seconds in zip(sorted(labels), DP_SECONDS):
            lab = labels[name]
            if not (abs(sum(map(float, lab["ph_dur"].split())) - seconds) < 1e-3
                    and sum(map(int, lab["ph_num"].split())) == len(lab["ph_seq"].split())
                    and len(lab["note_seq"].split()) == len(lab["note_dur"].split())):
                raise AssertionError(f"preprocess {name}: {lab}")

        # 2. binarize svs: RMVPE f0, VR voicing/breath/tension, on the card
        hp = dict(load_base_config(), seed=SEED, data_dir=os.path.join(tmp, "data"),
                  datasets=[{"data_dir": raw, "speaker": "s0", "language": "zh"}],
                  dictionary={"zh": {"phoneme": os.path.join(tmp, "dictionary", "zh_phones.txt")}},
                  languages={"zh": 1}, num_spk=1, test_num=1, valid_num=1,
                  val_check_interval=1000, num_sanity_val_steps=0, tb_log_interval=1,
                  vocoder_deterministic=True)
        hp["binarization_args"] = dict(hp["binarization_args"], with_voicing=True,
                                       with_breath=True, with_tension=True)
        cfg = os.path.join(tmp, "datapipe.yaml")
        with open(cfg, "w") as f:
            yaml.dump(hp, f)
        step("binarize svs", {}, lambda: port_cli(["binarize", "svs", "--config", cfg,
                                                   "--exp_name", DP_EXP]))
        shards = IndexedDataset(os.path.join(tmp, "data", "svs"), "train")
        items = [shards[i] for i in range(len(shards))]
        for it in items:
            for key in ("mel", "f0", "voicing", "breath", "tension", "mel2ph"):
                if len(it[key]) != it["length"] or not np.isfinite(it[key]).all():
                    raise AssertionError(f"binarized {key}: {np.shape(it[key])}, {it['length']}")
        log(f"binarize svs: {len(items)} train items, {sum(it['length'] for it in items)} frames; "
            f"f0 {min(it['f0'].min() for it in items):.2f}-{max(it['f0'].max() for it in items):.2f}"
            f" Hz, voicing {min(it['voicing'].min() for it in items):.2f}-"
            f"{max(it['voicing'].max() for it in items):.2f} dB, tension "
            f"{min(it['tension'].min() for it in items):.3f}-"
            f"{max(it['tension'].max() for it in items):.3f}")

        # the shortest item's features, card vs CPU (the same binarizer on
        # each): mel (log10), f0 (Hz), the curves (dB, logit) and the
        # salience within VAR_TOL
        svs_cls = get_binarizer_cls("svs")
        binarizers = {d: svs_cls(dict(hp, data_dir=os.path.join(tmp, f"check_{d}")), device=d)
                      for d in (dev, "cpu")}
        meta = {m["item_name"]: m for m in binarizers["cpu"].load_meta_data()}
        short = meta["it0"]
        got, ref = (binarizers[d].process_item(short) for d in (dev, "cpu"))
        errors = {k: hold(k, got[k], ref[k]) for k in ("mel", "f0", "voicing", "breath", "tension")}
        wav0, _ = load_wav(short["wav_fn"], sr=44100)
        audio16k = resample_poly(wav0, 160, 441)
        pes = {d: binarizers[d].pe for d in (dev, "cpu")}
        errors["salience"] = hold("RMVPE salience", pes[dev].salience(audio16k),
                                  pes["cpu"].salience(audio16k))
        vr_path = os.path.join(tmp, "checkpoints", "vr", "model.pt")
        parts = {d: extract_harmonic_aperiodic(wav0, vr_path, device=d) for d in (dev, "cpu")}
        err = float(np.abs(parts[dev][0] - parts["cpu"][0]).max())
        log(f"card vs CPU harmonic part {list(parts['cpu'][0].shape)}: max_abs_err {err:.3e}, peak "
            f"{np.abs(parts['cpu'][0]).max():.4f}, tol {DP_WAV_TOL}")
        if not err <= DP_WAV_TOL:
            raise AssertionError("the card's harmonic part disagrees with the CPU's")
        errors["harmonic"] = err

        # RMVPE and VR on the longest item, timed by CUDA events
        wav6, _ = load_wav(meta[f"it{len(DP_SECONDS) - 1}"]["wav_fn"], sr=44100)
        a16 = resample_poly(wav6, 160, 441)
        sep = load_sep_model(vr_path, dev)
        n_fft, hop = DP_VR_CONFIG["n_fft"], DP_VR_CONFIG["hop_length"]
        n_blocks = (len(wav6) // hop + 1) // 32 + 1
        x = torch.zeros(1, (32 * n_blocks - 1) * hop, device=dev)
        x[0, :len(wav6)] = torch.from_numpy(wav6).to(dev)
        with torch.no_grad():
            t_rmvpe = event_median_ms(lambda: pes[dev].salience(a16), torch)
            t_vr = event_median_ms(lambda: sep.separate(x), torch)
            t_model = event_median_ms(lambda: sep.model(torch.zeros(
                1, 2, n_fft // 2 + 1, 32 * n_blocks, device=dev)), torch)
        log(f"RMVPE on a {len(wav6) / 44100:.2f} s item ({len(a16)} samples at 16 kHz, "
            f"{len(a16) // 160 + 1} frames): salience {t_rmvpe:.3f} ms (CUDA events, median of "
            f"{VAR_REPS}, mel + E2E0 + copy to the host); VR separation {t_vr:.3f} ms (STFT + "
            f"CascadedNet + iSTFT, {32 * n_blocks} frames), CascadedNet alone {t_model:.3f} ms")
        binarizers[dev].process_item(meta[f"it{len(DP_SECONDS) - 1}"])  # warm-up
        wall_ms, busy, sums, rows = kernel_split(
            lambda: binarizers[dev].process_item(meta[f"it{len(DP_SECONDS) - 1}"]), 1, {}, torch)
        if rows:
            log(f"binarize svs, one {len(wav6) / 44100:.2f} s item profiled (torch.profiler): "
                f"{wall_ms:.3f} ms on the host clock, {busy:.3f} ms of kernel time (device idle "
                f"share {max(0.0, 1 - busy / wall_ms):.3f}); by group (ms): "
                + json.dumps({g: round(v, 3) for g, v in sums.items()}))
            for ms, count, key in sorted(rows, reverse=True)[:8]:
                log(f"  {ms:9.3f} ms  x{count:<5d} {key[:110]}")
        else:
            log("binarize svs item profile: the profiler saw no device time (not measured)")
        del binarizers, pes, sep

        # 3. train svs, 2 steps on the port's shards (K5 on each step)
        n_layers = hp["residual_layers"]
        per_step = {"residual_stack_save": 1 + 2 * n_layers, "residual_stack_chain": 2 * n_layers}
        steps_ms = []
        orig = Trainer.train_step

        def timed_step(self, batch):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(self, batch)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - start) * 1e3)
            return out

        Trainer.train_step = timed_step
        try:
            step("train svs", {k: DP_TRAIN_STEPS * v for k, v in per_step.items()},
                 lambda: port_cli(["train", "svs", "--config", cfg, "--exp_name", DP_EXP,
                                   "--max_steps", str(DP_TRAIN_STEPS)]))
        finally:
            Trainer.train_step = orig
        work = os.path.join(tmp, "checkpoints", DP_EXP, "svs")
        losses = [json.loads(ln)["tr/total_loss"] for ln in open(os.path.join(work, "metrics.jsonl"))
                  if "tr/total_loss" in ln]
        if len(losses) != DP_TRAIN_STEPS or not np.isfinite(losses).all() or not os.path.exists(
                os.path.join(work, f"model_ckpt_steps_{DP_TRAIN_STEPS}.ckpt")):
            raise AssertionError(f"train svs: losses {losses}, files {os.listdir(work)}")
        log(f"train svs on the port's shards: losses {[round(v, 4) for v in losses]}, step times "
            f"{[round(v, 3) for v in steps_ms]} ms (host clock, synchronised)")

        # 4. binarize svs_rectified with the trained flagship teacher (K1 4 steps an item)
        n_items = 2 * hp["test_num"] + hp["valid_num"] + len(items)  # valid + test + train
        rect_cfg = os.path.join(tmp, "rectified.yaml")
        with open(rect_cfg, "w") as f:
            yaml.dump(dict(hp, teacher_ckpt=work), f)
        step("binarize svs_rectified", {"residual_stack": n_items * per_render["residual_stack"]},
             lambda: port_cli(["binarize", "svs_rectified", "--config", rect_cfg,
                               "--exp_name", DP_EXP]))
        rect = IndexedDataset(os.path.join(tmp, "data", "svs_rectified"), "train")[0]
        if not (rect["x_0"].shape == rect["x_T"].shape == (rect["length"], 128)
                and rect["condition"].shape == (rect["length"], hp["hidden_size"])
                and np.isfinite(rect["x_0"]).all()):
            raise AssertionError(f"svs_rectified item: {[(k, np.shape(v)) for k, v in rect.items()]}")

        # 5. vocode wav2wav under the base config (pitch_extractor: rmvpe)
        voc_cfg = os.path.join(tmp, "vocode.yaml")
        with open(voc_cfg, "w") as f:
            yaml.dump({"base_config": "base", "vocoder_deterministic": True}, f)
        written = {}
        for name in ("it0", f"it{len(DP_SECONDS) - 1}"):
            wav_fn = meta[name]["wav_fn"]
            step(f"vocode wav2wav {name}", {"resblock_stage": per_render["resblock_stage"]},
                 lambda: port_cli(["vocode", "wav2wav", wav_fn, "--config", voc_cfg,
                                   "--output_dir", os.path.join(tmp, "voc_cuda")]))
            written[name] = wavfile.read(os.path.join(tmp, "voc_cuda", f"{name}.wav"))[1]
        port_cli(["vocode", "wav2wav", meta["it0"]["wav_fn"], "--config", voc_cfg,
                  "--output_dir", os.path.join(tmp, "voc_cpu"), "--device", "cpu"])
        wav_cpu = wavfile.read(os.path.join(tmp, "voc_cpu", "it0.wav"))[1].astype(np.float64)
        err, peak = float(np.abs(written["it0"] - wav_cpu).max()), float(np.abs(wav_cpu).max())
        log(f"vocode wav2wav (base config, RMVPE f0) card vs CPU written wav {list(wav_cpu.shape)}: "
            f"max_abs_err {err:.0f} (int16 steps), peak {peak:.0f}, tol {CPU_TOL} x peak")
        if not (0 < peak < 32767 and err <= CPU_TOL * peak):
            raise AssertionError("vocode wav2wav: the card's wav disagrees with the CPU's")

        # 6. infer --isolate_aspiration --isolate_base_harmonic of samples/example.ds
        example = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "example.ds")
        shutil.copy(example, os.path.join(tmp, "example.ds"))
        acoustic_calls = []
        acoustic = SVSInferHandler._acoustic

        def counted(self, *args):
            acoustic_calls.append(args[1].shape)
            return acoustic(self, *args)

        SVSInferHandler._acoustic = counted
        try:
            torch.cuda.synchronize()
            reset_counts()
            start = time.time()
            port_cli(["infer", "example.ds", "--exp_name", DP_EXP, "--spk_name", "s0",
                      "--isolate_aspiration", "--isolate_base_harmonic"])
            torch.cuda.synchronize()
            spans["infer --isolate_*"] = round(time.time() - start, 3)
            n_batches = len(acoustic_calls)
            for k, v in check_counts("data pipeline: infer --isolate_aspiration "
                                     "--isolate_base_harmonic",
                                     {k: n_batches * v for k, v in per_render.items()}).items():
                totals[k] += v
        finally:
            SVSInferHandler._acoustic = acoustic
        tracks = {}
        for suffix in ("sp", "ap", "bh"):
            sr, tracks[suffix] = wavfile.read(os.path.join(tmp, "infer_out",
                                                           f"example_{suffix}【{DP_EXP}】.wav"))
        if len({t.shape for t in tracks.values()}) != 1 or sr != 44100:
            raise AssertionError(f"isolate tracks: {[t.shape for t in tracks.values()]}")
        det = {d: SVSInferHandler(DP_EXP, deterministic=True, device=d, isolate_aspiration=True,
                                  isolate_base_harmonic=True, out_dir=os.path.join(tmp, f"iso_{d}"))
               for d in (dev, "cpu")}
        paths = {d: h.handle(None, "example.ds", "s0", "zh") for d, h in det.items()}
        for g, w in zip(paths[dev], paths["cpu"]):
            a, b = (wavfile.read(p)[1].astype(np.float64) for p in (g, w))
            err, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
            log(f"isolate track {os.path.basename(w)} card vs CPU (deterministic): max_abs_err "
                f"{err:.0f} (int16 steps), peak {peak:.0f}, tol {CPU_TOL} x peak + 1")
            if not (a.shape == b.shape and 0 < peak and err <= CPU_TOL * peak + 1):
                raise AssertionError(f"isolate {os.path.basename(w)}: the card's track disagrees")

        # 7. /api/infer with the VR gain
        web = WebHandler(core=det[dev], host="127.0.0.1", port=0)
        del det
        server = web.make_server()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/api/infer"
        try:
            rng = np.random.default_rng(SEED + 26)
            req = {"speaker": "s0", "language": "zh", "ph_text_list": ["SP", "b", "a", "b", "a", "SP"],
                   "ph_dur_list": [0.2, 0.08, 0.9, 0.08, 0.9, 0.2], "pitch_list": [57.0] * 200}
            curves = {"voicing_list": [float(v) for v in rng.uniform(-12, 6, 200)],
                      "breath_list": [float(v) for v in rng.uniform(-30, 0, 200)]}
            raw_wav = np.asarray(step("/api/infer", per_render, lambda: post(url, req))["wav"])
            gained = np.asarray(step("/api/infer with the VR gain", per_render,
                                     lambda: post(url, dict(req, **curves)))["wav"])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        from prodiff_tpu_torch.utils.pitch_utils import resample_align_curve

        sp, ap = extract_harmonic_aperiodic(raw_wav, vr_path, device="cpu")
        ts = hp["hop_size"] / hp["audio_sample_rate"]
        want = (sp * 10 ** (resample_align_curve(np.asarray(curves["voicing_list"]), ts,
                                                 1 / 44100, len(raw_wav)) * 0.05)
                + ap * 10 ** (resample_align_curve(np.asarray(curves["breath_list"]), ts,
                                                   1 / 44100, len(raw_wav)) * 0.05))
        err, peak = float(np.abs(gained - want).max()), float(np.abs(want).max())
        log(f"/api/infer with the VR gain vs the CPU's gain of the raw wav {list(want.shape)}: "
            f"max_abs_err {err:.3e}, peak {peak:.4f}, tol {CPU_TOL} x peak; raw peak "
            f"{np.abs(raw_wav).max():.4f}")
        if not (gained.shape == raw_wav.shape and err <= CPU_TOL * peak
                and np.abs(gained - raw_wav).max() > CPU_TOL * peak):
            raise AssertionError("/api/infer: the VR gain disagrees with the CPU's")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        os.chdir(cwd)
    log(f"data-pipeline phase: {time.time() - t_phase:.3f} s; spans (s): {json.dumps(spans)}; "
        f"card vs CPU max errors {json.dumps({k: float(f'{v:.3e}') for k, v in errors.items()})}; "
        f"launches {json.dumps(totals)}")
    return totals, {"tmp": tmp, "hp": hp, "teacher_work": work}


# The distillation phase: on the data-pipeline phase's tree (the base config,
# its teacher trained DP_TRAIN_STEPS steps, the port-binarized svs_rectified
# shards) train svs_rectified -> merge_rectified -> infer of the merged
# teacher at timesteps 1, plus validation sampling, a resumed run against an
# unbroken one and a profiled run
DISTILL_EXP = "distilled"
DISTILL_STEPS = 3  # svs_rectified steps; async checkpoints every 2
DISTILL_GRAD_TOL = 1e-4  # the student's step, card vs CPU: loss and gradients, of each one's peak
RESUME_TOL = 1e-5  # resumed vs unbroken params, of each tensor's peak
PROFILED_STEPS = 2  # profile_steps of the profiled run (its steps 11-12)


def check_trace_names_k5(path: str) -> None:
    """The Chrome trace holds K5's kernels (save-forward and backward chain)."""
    with open(path) as f:
        text = f.read()
    named = {k: text.count(k) for k in ("save_gate_kernel", "chain_gate_kernel")}
    log(f"profile trace {os.path.basename(path)} ({len(text) / 1e6:.2f} MB): K5 kernel "
        f"events {named}")
    if not all(named.values()):
        raise AssertionError("profile_steps: the trace names no K5 kernel")


def phase_distillation(dev, torch, tree):
    """The distillation loop through the port's entry points at full width,
    on the data-pipeline phase's tree (removed at the end): ``train
    svs_rectified`` (3 steps, ``async_save``) with one step held against the
    CPU, ``merge_rectified``, ``infer`` of ``samples/example.ds`` from the
    merged teacher at ``timesteps: 1`` (its mel held against the CPU),
    ``SVSTask.infer_mels`` on the card vs the CPU, ``train svs`` resumed from
    an optax-layout checkpoint against an unbroken run, and ``train svs``
    with ``profile_steps``. Returns the launches of the phase's path."""
    import shutil

    import yaml

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.infer.handler import SVSInferHandler
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer, host_tensors
    from prodiff_tpu_torch.utils import ckpt_utils

    t_phase = time.time()
    tmp, hp, teacher_work = tree["tmp"], tree["hp"], tree["teacher_work"]
    cwd = os.getcwd()
    os.chdir(tmp)
    spans, totals, errors = {}, {k: 0 for k in COUNTED}, {}
    n_layers = hp["residual_layers"]
    per_step = {"residual_stack_save": 1 + 2 * n_layers, "residual_stack_chain": 2 * n_layers}

    def step(label, want, fn):
        torch.cuda.synchronize()
        reset_counts()
        start = time.time()
        out = fn()
        torch.cuda.synchronize()
        spans[label] = round(time.time() - start, 3)
        for k, v in check_counts(f"distillation: {label}", want).items():
            totals[k] += v
        return out

    def train_cli(task, cfg, exp, steps, want, label=None):
        """``train`` through the CLI; returns the host-clock ms of each step."""
        times = []
        orig = Trainer.train_step

        def timed(self, batch):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(self, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            return out

        Trainer.train_step = timed
        try:
            step(label or f"train {task} ({exp})", want,
                 lambda: port_cli(["train", task, "--config", cfg, "--exp_name", exp,
                                   "--max_steps", str(steps), "--device", str(dev)]))
        finally:
            Trainer.train_step = orig
        return times

    def write_cfg(name, **kw):
        path = os.path.join(tmp, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.dump(dict(hp, **kw), f)
        return path

    try:
        # 1. train svs_rectified on the port's triplets, 3 steps, async checkpoints
        rect_cfg = write_cfg("distill", teacher_ckpt=teacher_work, async_save=True,
                             val_check_interval=2)
        rect_hp = dict(hp, task="svs_rectified", teacher_ckpt=teacher_work)
        rect_task = get_task_cls("svs_rectified")(rect_hp)
        n_val = len(rect_task.val_iterator())  # a validation runs K1 3 times a batch
        rect_ms = train_cli("svs_rectified", rect_cfg, DP_EXP, DISTILL_STEPS,
                            {k: DISTILL_STEPS * v for k, v in per_step.items()}
                            | {"residual_stack": n_val * K1_LAUNCHES})
        student_work = os.path.join(tmp, "checkpoints", DP_EXP, "svs_rectified")
        files = sorted(f for f in os.listdir(student_work) if f.endswith(".ckpt"))
        losses = [json.loads(ln)["tr/total_loss"]
                  for ln in open(os.path.join(student_work, "metrics.jsonl"))
                  if "tr/total_loss" in ln]
        if files != ["model_ckpt_steps_2.ckpt", "model_ckpt_steps_3.ckpt"] or len(
                losses) != DISTILL_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"train svs_rectified: files {files}, losses {losses}")
        log(f"train svs_rectified (async_save, {n_val} validation batch): losses "
            f"{[round(v, 4) for v in losses]}, step times {[round(v, 3) for v in rect_ms]} ms "
            f"(host clock, synchronised); checkpoints {files}")

        # one student step, card vs CPU, on the shortest triplet (t injected;
        # the DDPM student noises with the item's own x_T)
        ds = rect_task.train_iterator().dataset
        short = min(range(len(ds)), key=ds.size)
        batch = ds.collater([ds[short]])
        batch.pop("nsamples")
        step_launches = step_vs_cpu("svs_rectified student", rect_task, rect_task.build_model,
                                    batch, {"t": np.array([1])}, dev, torch,
                                    tol=DISTILL_GRAD_TOL)
        if step_launches != per_step:
            raise AssertionError(f"the student's step launched {step_launches}, not {per_step}")

        # the student's step under torch.profiler, at the training batch
        trainer = Trainer(dict(rect_hp, work_dir=os.path.join(tmp, "profiled_student")),
                          device=dev)
        trainer.build(rect_task)
        full = next(iter(rect_task.train_iterator()))
        full.pop("nsamples")
        full = {k: v.to(dev) for k, v in host_tensors(full, pin=False).items()}
        shape = tuple(full["x_0"].shape)
        profile_train_step(trainer, full, torch,
                           label=f"svs_rectified step (B={shape[0]} x T={shape[1]})")
        del trainer, full

        # 2. merge_rectified: the teacher's diffusion becomes the student's
        teacher_ckpt = os.path.join(teacher_work, f"model_ckpt_steps_{DP_TRAIN_STEPS}.ckpt")
        student_ckpt = os.path.join(student_work, f"model_ckpt_steps_{DISTILL_STEPS}.ckpt")
        step("merge_rectified", {}, lambda: port_cli(["merge_rectified", teacher_ckpt,
                                                      student_ckpt]))
        merged = ckpt_utils.load_checkpoint_file(teacher_ckpt + ".merged.ckpt")
        student = ckpt_utils.load_checkpoint_file(student_ckpt)["state_dict"]["params"]
        got_tree = merged["state_dict"]["params"]["diffusion"]

        def leaves(tree, path=""):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)]

        want_leaves, got_leaves = dict(leaves(student)), dict(leaves(got_tree))
        if set(want_leaves) != set(got_leaves) or not all(
                got_leaves[k].dtype == v.dtype and np.array_equal(got_leaves[k], v)
                for k, v in want_leaves.items()):
            raise AssertionError("merge_rectified: the merged diffusion is not the student's")
        log(f"merge_rectified: the merged teacher's diffusion equals the student's bit for bit "
            f"({len(want_leaves)} arrays)")

        # 3. infer of samples/example.ds from the merged teacher at timesteps 1
        exp_dir = os.path.join(tmp, "checkpoints", DISTILL_EXP, "svs")
        os.makedirs(exp_dir)
        with open(os.path.join(teacher_work, "config.yaml")) as f:
            exp_hp = yaml.safe_load(f)
        with open(os.path.join(exp_dir, "config.yaml"), "w") as f:
            yaml.dump(dict(exp_hp, timesteps=1), f)
        shutil.copy(teacher_ckpt + ".merged.ckpt",  # a name the handler finds
                    os.path.join(exp_dir, f"model_ckpt_steps_{DP_TRAIN_STEPS}.ckpt"))
        example = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "example.ds")
        shutil.copy(example, os.path.join(tmp, "example.ds"))
        batches = []
        acoustic = SVSInferHandler._acoustic

        def counted(self, *args):
            batches.append(args[1].shape)
            return acoustic(self, *args)

        SVSInferHandler._acoustic = counted
        try:
            t0 = time.perf_counter()
            # counts as the render of 1 DDPM step and 5 vocoder stages a batch,
            # known only after the call: checked just below
            torch.cuda.synchronize()
            reset_counts()
            port_cli(["infer", "example.ds", "--exp_name", DISTILL_EXP, "--spk_name", "s0",
                      "--device", str(dev)])
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            spans["infer (merged teacher)"] = round(render_s, 3)
            want = {"residual_stack": len(batches) * K1_LAUNCHES,
                    "resblock_stage": len(batches) * 5 * 18}
            for k, v in check_counts("distillation: infer of the merged teacher (timesteps 1)",
                                     want).items():
                totals[k] += v
        finally:
            SVSInferHandler._acoustic = acoustic
        log(f"infer of example.ds from the merged teacher (timesteps 1): {len(batches)} batches "
            f"{batches}, {render_s:.3f} s (host clock, CLI in-process, models loaded included)")
        mels = {}
        for d in (dev, "cpu"):
            handler = SVSInferHandler(DISTILL_EXP, deterministic=True, device=d,
                                      out_dir=os.path.join(tmp, f"merged_{d}"))
            seen = capture_mel(handler)
            handler.handle(None, "example.ds", "s0", "zh")
            mels[str(d)] = seen["mel"]
        ref = mels["cpu"]
        err = float(np.abs(mels[str(dev)] - ref).max())
        log(f"merged teacher's mel into the vocoder (last batch {list(ref.shape)}), card vs CPU: "
            f"max_abs_err {err:.3e}, peak {np.abs(ref).max():.4f}, tol {CPU_TOL} x peak")
        if not (mels[str(dev)].shape == ref.shape and err <= CPU_TOL * np.abs(ref).max()):
            raise AssertionError("the merged teacher's mel disagrees with the CPU's")
        errors["merged mel"] = err

        # 4. validation sampling: SVSTask.infer_mels on the card vs the CPU
        svs_hp = dict(hp, task="svs")
        svs_task = get_task_cls("svs")(svs_hp)
        payload = ckpt_utils.load_checkpoint_file(teacher_ckpt)
        vb = next(iter(svs_task.val_iterator()))
        vb.pop("nsamples")
        rng = np.random.default_rng(SEED + 30)
        b, t_mel, m = vb["mel"].shape
        noise = {"init_noise": rng.uniform(size=(b, 1, t_mel, m)).astype(np.float32),
                 "step_noises": rng.normal(size=(hp["timesteps"], b, 1, t_mel, m)
                                           ).astype(np.float32)}
        sampled = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = svs_task.build_model()
            svs_task.load_params_tree(model, payload["state_dict"])
            model.to(d).eval()
            tb = {k: v.to(d) for k, v in host_tensors(vb, pin=False).items()}
            tn = {k: torch.from_numpy(v).to(d) for k, v in noise.items()}
            run = lambda: svs_task.infer_mels(model, tb, **tn)  # noqa: E731
            out = step("infer_mels (validation sampling)",
                       {"residual_stack": hp["timesteps"] * K1_LAUNCHES}, run) if where == "card" \
                else run()
            sampled[where] = out.cpu().numpy()
        err = float(np.abs(sampled["card"] - sampled["cpu"]).max())
        peak = float(np.abs(sampled["cpu"]).max())
        log(f"SVSTask.infer_mels {list(sampled['cpu'].shape)} on injected noise, card vs CPU: "
            f"max_abs_err {err:.3e}, peak {peak:.4f}, tol {CPU_TOL} x peak")
        if not err <= CPU_TOL * peak:
            raise AssertionError("infer_mels: the card disagrees with the CPU")
        errors["infer_mels"] = err

        # 5. train svs resumed from a step-N checkpoint (optax's layout) vs
        # unbroken, with deterministic algorithms: by default the embedding
        # and gather backward add with atomics, so two runs of the same steps
        # differ in the last bits (2.6e-5 of the zero-initialised output
        # projection's peak after 3 steps on an H100)
        n = len(svs_task.train_iterator())  # one epoch: a resumed epoch starts over
        svs_cfg = write_cfg("resume", val_check_interval=1000)

        def resume_vs_unbroken(mode):
            ms = train_cli("svs", svs_cfg, f"unbroken_{mode}", n + 2,
                           {k: (n + 2) * v for k, v in per_step.items()})
            train_cli("svs", svs_cfg, f"broken_{mode}", n, {k: n * v for k, v in per_step.items()})
            opt_tree = ckpt_utils.load_checkpoint_file(os.path.join(
                tmp, "checkpoints", f"broken_{mode}", "svs", f"model_ckpt_steps_{n}.ckpt"))[
                "optimizer_state"]
            if sorted(opt_tree) != ["0", "1"] or int(opt_tree["1"]["0"]["count"]) != n:
                raise AssertionError(f"the step-{n} optimizer state is not optax's tree: "
                                     f"{sorted(opt_tree)}")
            train_cli("svs", svs_cfg, f"broken_{mode}", n + 2,
                      {k: 2 * v for k, v in per_step.items()}, label=f"train svs (resumed, {mode})")
            finals = [dict(leaves(ckpt_utils.load_checkpoint_file(os.path.join(
                tmp, "checkpoints", f"{e}_{mode}", "svs", f"model_ckpt_steps_{n + 2}.ckpt"))[
                "state_dict"])) for e in ("unbroken", "broken")]
            if set(finals[0]) != set(finals[1]):
                raise AssertionError("the resumed run's params differ in their names")
            worst = max((float(np.abs(finals[1][k] - v).max()) / max(float(np.abs(v).max()),
                                                                     1e-12), k)
                        for k, v in finals[0].items())
            log(f"train svs resumed at step {n} (optax-layout checkpoint) vs unbroken, {mode} "
                f"algorithms, params after step {n + 2}: worst {worst[0]:.3e} of a tensor's peak "
                f"({worst[1]}; {len(finals[0])} tensors)")
            return worst[0], ms

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            errors["resume"], svs_ms = resume_vs_unbroken("deterministic")
        finally:
            torch.use_deterministic_algorithms(False)
        if not errors["resume"] <= RESUME_TOL:
            raise AssertionError(f"the resumed run does not repeat the unbroken one (tol "
                                 f"{RESUME_TOL} of each tensor's peak)")

        # 6. train svs with profile_steps: a trace of steps 11-12 naming K5's kernels
        prof_cfg = write_cfg("profiled", val_check_interval=1000, profile_steps=PROFILED_STEPS)
        n_prof = 10 + PROFILED_STEPS
        train_cli("svs", prof_cfg, "profiled", n_prof, {k: n_prof * v for k, v in per_step.items()})
        prof_dir = os.path.join(tmp, "checkpoints", "profiled", "svs", "profile")
        traces = os.listdir(prof_dir)
        if traces != [f"trace_steps_10-{n_prof}.json"]:
            raise AssertionError(f"profile_steps: traces {traces}")
        check_trace_names_k5(os.path.join(prof_dir, traces[0]))

        rect_med, svs_med = float(np.median(rect_ms)), float(np.median(svs_ms))
        log(f"step times (host clock, median): svs_rectified {rect_med:.3f} ms, train svs "
            f"{svs_med:.3f} ms (deterministic algorithms) on the same items (the student skips "
            f"the encoder and embeds)")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"distillation phase: {time.time() - t_phase:.3f} s; spans (s): {json.dumps(spans)}; "
        f"card vs CPU max errors {json.dumps({k: float(f'{v:.3e}') for k, v in errors.items()})}; "
        f"launches {json.dumps(totals)}")
    return totals


def peak_compare(name, got, want, tol, torch) -> float:
    """``grad_compare`` of two tensors of any float dtype, in float32."""
    return grad_compare(name, got.float(), want.float(), tol, torch)


# set by main() with --parent: the earlier design's K1-bf16, K2/K3 (float32
# and bf16 taps) and K5a/K5b-bf16 wrappers (tools/probe_bf16_kernels.py),
# timed in turns beside this one's
PARENT = None


def k5_bf16_launches(n_layers: int = 20) -> dict:
    """K5a/K5b-bf16's launches a training step (one stack a step), by counter
    name (ops/wavenet_train.py:train_launches)."""
    import torch

    from prodiff_tpu_torch.ops.wavenet_train import train_launches

    save, chain = train_launches(TRAIN_B, TRAIN_T, 256, n_layers, torch.bfloat16)
    return {"residual_stack_save_bf16": save, "residual_stack_chain_bf16": chain}


def k1_bf16_launches(b: int, t: int, c: int = 256, n_layers: int = 20) -> int:
    """K1-bf16's launches for a stack at (B, T): the step projection, then a
    cond GEMM and a cluster chain per layer group of its schedule at this
    card's clusters (ops/wavenet_stack.py:bf16_schedule)."""
    import torch

    from prodiff_tpu_torch.ops import wavenet_stack as wn

    slots = wn._chain_slots(wn._library(torch.bfloat16), torch.device("cuda:0"), torch.bfloat16, c)
    return wn.stack_launches(b, t, c, n_layers, torch.bfloat16, slots)


def earlier_in_turns(name, earlier, this, reps, torch) -> dict:
    """The earlier design and this one in turns (earlier, this, this,
    earlier; ``timed_ms`` each): {"parent_ms": [2], "in_turns_ms": [2]}."""
    got = {"parent_ms": [timed_ms(earlier, reps, torch)],
           "in_turns_ms": [timed_ms(this, reps, torch) for _ in range(2)]}
    got["parent_ms"].append(timed_ms(earlier, reps, torch))
    log(f"{name} in turns with the earlier design: earlier {got['parent_ms']}, this "
        f"{got['in_turns_ms']} ms")
    return got


def k1_bf16_split(x0, cond, step, w, torch) -> dict:
    """Each layer's phases of the K1-bf16 chain (microseconds, the mean over
    the stamped blocks and layers): the stamped build (``K1_STAMPED``) run
    twice through the wrapper, its %globaltimer stamps read back."""
    import ctypes

    from prodiff_tpu_torch.ops import cuda_build
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    lib = cuda_build.load(*K1_STAMPED)
    lib.wavenet_residual_stack_bf16.argtypes = wn._ARGTYPES_BF16
    lib.wavenet_residual_stack_bf16.restype = ctypes.c_int
    lib.wavenet_cluster_slots_bf16.argtypes = [ctypes.c_int] * 2
    lib.wavenet_cluster_slots_bf16.restype = ctypes.c_int
    lib.wavenet_read_stamps_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wavenet_clear_stamps_bf16.restype = ctypes.c_int
    saved = wn._library
    wn._library = lambda dtype=None: lib
    try:
        wn.residual_stack(x0, cond, step, w)
        torch.cuda.synchronize()
        if lib.wavenet_clear_stamps_bf16():
            raise RuntimeError("wavenet_clear_stamps_bf16 failed")
        wn.residual_stack(x0, cond, step, w)
        torch.cuda.synchronize()
    finally:
        wn._library = saved
    blocks, layers, edges = 64, 64, 6
    host = (ctypes.c_ulonglong * (blocks * layers * edges))()
    if lib.wavenet_read_stamps_bf16(host, blocks * layers * edges):
        raise RuntimeError("wavenet_read_stamps_bf16 failed")
    split = probe_module().stamp_split(
        np.frombuffer(host, dtype=np.uint64).reshape(blocks, layers, edges))
    log("K1-bf16 chain, a layer (us, stamped build): "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    return split


def bf16_kernels(dev, torch) -> tuple:
    """K1-bf16 at B=1, T=512/640/2048 and K5a/K5b-bf16 at B=16, T=1536 (L=20,
    C=H=256) against their twins, timed (CUDA events, 3 warm-ups, mean of
    20; the twins mean of 3) beside the float32 kernels on the same
    (float32) weights, with bounds at the bf16 rate counting bf16 bytes for
    the bf16 weights, saves and the chain's outputs. Returns the kernels-line
    summaries of the three."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn
    from prodiff_tpu_torch.ops import wavenet_train as wt

    rng = np.random.default_rng(SEED + 13)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    n_layers, c, h = 20, 256, 256

    def weights():
        return wn.StackedWaveNet(
            dilated_w=rand(n_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
            dilated_b=rand(n_layers, 2 * c, scale=0.1),
            diff_w=rand(n_layers, c, c, scale=c ** -0.5), diff_b=rand(n_layers, c, scale=0.1),
            cond_w=rand(n_layers, h, 2 * c, scale=h ** -0.5), cond_b=rand(n_layers, 2 * c, scale=0.1),
            out_w=rand(n_layers, c, 2 * c, scale=c ** -0.5), out_b=rand(n_layers, 2 * c, scale=0.1))

    w32 = weights()
    w16 = wn.cast_stack(w32, torch.bfloat16)
    mat = n_layers * (3 * c * 2 * c + c * c + h * 2 * c + c * 2 * c)  # weight elements
    bias = n_layers * (2 * c + c + 2 * c + 2 * c)
    k1 = {"by_shape": []}
    for b, t in K1_SHAPES:
        x0, cond, step = rand(b, t, c), rand(b, t, h), rand(b, c)
        before = wn.residual_stack.bf16_launches.count
        got = wn.residual_stack(x0, cond, step, w16)
        torch.cuda.synchronize()
        n = wn.residual_stack.bf16_launches.count - before
        if n != k1_bf16_launches(b, t, c, n_layers):
            raise AssertionError(f"K1-bf16 launched {n} kernels, not {k1_bf16_launches(b, t)}")
        err = peak_compare(f"K1-bf16 vs its twin, B={b} T={t}", got,
                           wn.residual_stack_plain(x0, cond, step, w16), BF16_KERNEL_TOL, torch)
        ms = timed_ms(lambda: wn.residual_stack(x0, cond, step, w16), 20, torch)
        f32_ms = timed_ms(lambda: wn.residual_stack(x0, cond, step, w32), 20, torch)
        plain_ms = timed_ms(lambda: wn.residual_stack_plain(x0, cond, step, w16), 3, torch)
        split = k1_bf16_split(x0, cond, step, w16, torch)
        parent = {} if PARENT is None else earlier_in_turns(
            f"K1-bf16 B={b} T={t}", lambda: PARENT["k1"](x0, cond, step, w16),
            lambda: wn.residual_stack(x0, cond, step, w16), 20, torch)
        flops = 2 * b * t * n_layers * (3 * c * 2 * c + h * 2 * c + c * 2 * c) + 2 * b * n_layers * c * c
        nbytes = 2 * mat + 4 * (bias + b * t * (c + h + c) + b * c)
        lim = bound(flops, nbytes, BF16_PEAK)
        log(f"K1-bf16 B={b} T={t}: kernel {ms:.4f} ms ({n} launches), float32 K1 {f32_ms:.4f} ms, "
            f"plain twin {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB: {lim['bound_by']}), share of bound {lim['bound_ms'] / ms:.3f}")
        k1["by_shape"].append(dict(b=b, t=t, ms=ms, f32_ms=f32_ms, plain_ms=plain_ms,
                                   max_abs_err=err, phases_us=split, **parent, **lim))
    first = k1["by_shape"][0]
    k1.update({k: first[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_by")})
    k1["max_abs_err"] = max(r["max_abs_err"] for r in k1["by_shape"])

    b, t = TRAIN_B, TRAIN_T
    tag = f"L={n_layers} C={c} H={h} B={b} T={t}"
    x0, cond, step, g = rand(b, t, c), rand(b, t, h), rand(b, c), rand(b, t, c)
    saves, chains = wt.residual_stack_save.bf16_launches.count, wt.residual_stack_chain.bf16_launches.count
    skip, xs, zs = wt.residual_stack_save(x0, cond, step, w16)
    dz, dy, dx0 = wt.residual_stack_chain(zs, g, w16)
    torch.cuda.synchronize()
    got_n = (wt.residual_stack_save.bf16_launches.count - saves,
             wt.residual_stack_chain.bf16_launches.count - chains)
    if got_n != wt.train_launches(b, t, c, n_layers, torch.bfloat16):
        raise AssertionError(f"K5-bf16 launched {got_n}, not "
                             f"{wt.train_launches(b, t, c, n_layers, torch.bfloat16)}")
    want = wt.residual_stack_save_plain(x0, cond, step, w16)
    fwd_err = max(peak_compare(f"K5a-bf16 {name} vs its twin, {tag}", got, ref, BF16_KERNEL_TOL, torch)
                  for name, got, ref in zip(("skip", "xs", "zs"), (skip, xs, zs), want))
    del want
    chain_err = max(peak_compare(f"K5b-bf16 {name} vs its twin, {tag}", got, ref, BF16_KERNEL_TOL, torch)
                    for name, got, ref in zip(("dz", "dy", "dx0"), (dz, dy, dx0),
                                              wt.residual_stack_chain_plain(zs, g, w16)))
    _, _, zs32 = wt.residual_stack_save(x0, cond, step, w32)
    ms = {
        "save": timed_ms(lambda: wt.residual_stack_save(x0, cond, step, w16), 20, torch),
        "save_f32": timed_ms(lambda: wt.residual_stack_save(x0, cond, step, w32), 20, torch),
        "save_plain": timed_ms(lambda: wt.residual_stack_save_plain(x0, cond, step, w16), 3, torch),
        "chain": timed_ms(lambda: wt.residual_stack_chain(zs, g, w16), 20, torch),
        "chain_f32": timed_ms(lambda: wt.residual_stack_chain(zs32, g, w32), 20, torch),
        "chain_plain": timed_ms(lambda: wt.residual_stack_chain_plain(zs, g, w16), 3, torch),
    }
    del zs32
    bt = b * t
    fwd_flops = 2 * bt * n_layers * (3 * c * 2 * c + h * 2 * c + c * 2 * c) + 2 * b * n_layers * c * c
    fwd_bytes = 2 * mat + 4 * (bias + bt * (c + h + c) + b * c) + 2 * n_layers * bt * 3 * c
    chain_flops = 2 * bt * n_layers * (2 * c * c + 3 * 2 * c * c)
    chain_bytes = (2 * n_layers * (bt * 2 * c + 3 * c * 2 * c + c * 2 * c) + 4 * 2 * bt * c
                   + 2 * n_layers * bt * 3 * c)
    k5a = dict(max_abs_err=fwd_err, ms=ms["save"], f32_ms=ms["save_f32"], plain_ms=ms["save_plain"],
               **bound(fwd_flops, fwd_bytes, BF16_PEAK))
    k5b = dict(max_abs_err=chain_err, ms=ms["chain"], f32_ms=ms["chain_f32"],
               plain_ms=ms["chain_plain"], **bound(chain_flops, chain_bytes, BF16_PEAK))
    for name, k, flops, nbytes in (("K5a-bf16 save-forward", k5a, fwd_flops, fwd_bytes),
                                   ("K5b-bf16 backward chain", k5b, chain_flops, chain_bytes)):
        log(f"{name} {tag}: kernel {k['ms']:.4f} ms, float32 kernel {k['f32_ms']:.4f} ms, plain "
            f"twin {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB: {k['bound_by']}), share of bound {k['bound_ms'] / k['ms']:.3f}")
    del xs, zs, dz, dy, dx0, skip
    torch.cuda.empty_cache()
    if PARENT is not None and PARENT["k5"] is not None:
        k5_parent_in_turns(k5a, k5b, dev, torch)
    return k1, k5a, k5b


def k5_parent_in_turns(k5a: dict, k5b: dict, dev, torch) -> None:
    """K5a/K5b-bf16 and the earlier design's in turns at the training shape
    (B=16, T=1536, L=20, C=256) with H=256 (the teacher's) and H=128
    (vari's): each checked against the twins, timed (earlier, this, this,
    earlier), split by kernel (torch.profiler), beside the same products as
    bf16 torch.matmul calls (tools/probe_bf16_kernels.py:k5_probe). The
    teacher shape's turns go into the kernels' entries."""
    probe = probe_module()
    recs = probe.k5_probe(PARENT["k5"], torch, dev, emit_fn=lambda kind, **kw: log(
        f"K5-bf16 and the earlier design, {kind}: {json.dumps(kw)}"))
    for rec in recs:
        for who, err in rec["err_of_peak"].items():
            if not err <= BF16_KERNEL_TOL:
                raise AssertionError(f"K5-bf16 {who} at H={rec['h']}: {err:.3e} of the peak")
    first = recs[0]
    for k, kind in ((k5a, "save"), (k5b, "chain")):
        k["parent_ms"] = first["ms"][kind]["parent"]
        k["in_turns_ms"] = first["ms"][kind]["this"]
        k["vari_ms"] = recs[1]["ms"][kind]
        k["device_ms_by_kernel"] = {w: first["device_ms_by_kernel"][f"{kind}_{w}"]
                                    for w in ("parent", "this")}
        k["products_only_ms"] = first["products_only_ms"][kind]


def bf16_train_runs(tmp, dev, torch) -> dict:
    """``train svs`` by the CLI at the training cell's shape, float32 then
    ``bf16: true`` on the same items (each step timed and its launches
    counted), then ``train svs`` with ``amp: true`` and ``train
    svs_rectified --precision fast`` (``bf16: null``) on shorter runs; the
    last step of the float32 and the bf16 run under torch.profiler (its
    kernel launches and kernel time); the bf16 teacher step held against
    the same step on the CPU. Returns the launches of the bf16 run."""
    import yaml

    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.tasks.svs import SVSTask
    from prodiff_tpu_torch.training.trainer import Trainer
    from prodiff_tpu_torch.utils.synthetic import make_svs_dataset

    data_dir = os.path.join(tmp, "data")
    make_svs_dataset(data_dir, n_train=2 * TRAIN_B, n_valid=1, n_mels=128, seed=7,
                     t_ph_range=(32, 33), dur_range=(45, 49))
    hp = dict(train_config(data_dir), val_check_interval=10 ** 6, num_sanity_val_steps=0)
    calls, profiled, now = [], {}, {}
    orig = Trainer.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        before = {k: c.count for k, c in counters().items()}
        start = time.perf_counter()
        if now.get("profile") and len(calls) == now["steps"] - 1:
            box = []
            wall, busy, sums, rows = kernel_split(lambda: box.append(orig(self, batch)), 1, {},
                                                  torch)
            profiled[now["name"]] = dict(wall_ms=wall, busy_ms=busy, by_group_ms=sums,
                                         launches=sum(n for _, n, _ in rows))
            out = box[0]
        else:
            out = orig(self, batch)
        torch.cuda.synchronize()
        calls.append(((time.perf_counter() - start) * 1e3,
                      {k: c.count - before[k] for k, c in counters().items() if c.count != before[k]}))
        return out

    def run(name, task, steps, extra=(), profile=False, **keys):
        cfg = os.path.join(tmp, f"{name}.yaml")
        with open(cfg, "w") as f:
            yaml.dump(dict(hp, **keys), f)
        calls.clear()
        now.update(name=name, steps=steps, profile=profile)
        Trainer.train_step = timed
        try:
            port_cli(["train", task, "--config", cfg, "--exp_name", name, "--max_steps", str(steps),
                      "--device", str(dev), *extra])
        finally:
            Trainer.train_step = orig
        return list(calls)

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        runs = {"f32": run("f32", "svs", BF16_TRAIN_STEPS, profile=True, bf16=False)}
        reset_counts()
        runs["bf16"] = run("bf16", "svs", BF16_TRAIN_STEPS, profile=True, bf16=True)
        torch.cuda.synchronize()
        per_step = k5_bf16_launches()
        launches = check_counts(f"train svs with bf16: true ({BF16_TRAIN_STEPS} steps)",
                                {k: BF16_TRAIN_STEPS * v for k, v in per_step.items()})
        for label, run_calls in runs.items():
            want = per_step if label == "bf16" else {"residual_stack_save": 41,
                                                     "residual_stack_chain": 40}
            bad = [d for _, d in run_calls if d != want]
            if len(run_calls) != BF16_TRAIN_STEPS or bad:
                raise AssertionError(f"{label} steps launched {bad or len(run_calls)}")
        med = {k: sorted(ms for ms, _ in v[1:-1])[(len(v) - 3) // 2] for k, v in runs.items()}
        log(f"train svs (CLI, B={TRAIN_B} x T={TRAIN_T}, {BF16_TRAIN_STEPS} steps each, the same "
            f"items): median step (host clock, synchronised, steps 2-{BF16_TRAIN_STEPS - 1}) float32 "
            f"{med['f32']:.3f} ms, bf16 {med['bf16']:.3f} ms; every bf16 step launched "
            f"{json.dumps(per_step)} and no float32 kernel")
        for label, got in profiled.items():
            log(f"{label} step {BF16_TRAIN_STEPS} of train svs under torch.profiler: "
                f"{got['launches']} kernel launches, {got['busy_ms']:.3f} ms of kernel time, "
                f"{got['wall_ms']:.3f} ms on the host clock (profiler on; device idle share "
                f"{max(0.0, 1 - got['busy_ms'] / got['wall_ms']):.3f}); kernel time by group (ms): "
                f"{json.dumps({k: round(v, 3) for k, v in got['by_group_ms'].items()})}")
        amp = run("amp", "svs", 1, bf16=None, amp=True)
        if [d for _, d in amp] != [per_step]:
            raise AssertionError(f"train svs with amp: true launched {amp}")
        make_svs_dataset(os.path.join(tmp, "rect"), task="svs_rectified", rectified=True,
                         n_train=4, n_valid=1, n_mels=128, hidden=256)
        rect = run("rect", "svs_rectified", 2, extra=("--precision", "fast"),
                   data_dir=os.path.join(tmp, "rect"), bf16=None, max_sentences=4,
                   max_tokens=4 * 2000, batch_size_buckets=[1, 2, 4])
        if [d for _, d in rect] != [per_step] * 2:
            raise AssertionError(f"train svs_rectified --precision fast launched {rect}")
        log(f"train svs with amp: true (1 step) and train svs_rectified --precision fast (bf16: "
            f"null, 2 steps): each step launched {json.dumps(per_step)}")
    finally:
        os.chdir(cwd)
    task = SVSTask(dict(hp, bf16=True, work_dir=os.path.join(tmp, "checkpoints", "bf16", "svs"),
                        task="svs"))
    ds = task.train_iterator().dataset
    batch = ds.collater([ds[0], ds[1]])
    batch.pop("nsamples")
    batch = {k: v[:, :128] if k in ds.time_keys else v for k, v in batch.items()}
    rng = np.random.default_rng(SEED + 14)
    draws = {"t": np.array([1, 4]),
             "noise": rng.normal(size=(2, 1, *batch["mel"].shape[1:])).astype(np.float32)}
    launched = step_vs_cpu("SVS teacher in bf16 (bf16: true), the CPU through the kernels' twins",
                           task, task.build_model, batch, draws, dev, torch, tol=BF16_STEP_TOL,
                           cpu_twins=True)
    if launched != k5_bf16_launches():
        raise AssertionError(f"the bf16 step on the card launched {launched}")
    return launches


def write_bf16_tree(tmp, torch) -> None:
    """``checkpoints/bf16/svs`` under ``tmp``: the base config's teacher on
    seeded weights as a JAX-format checkpoint with its config and maps, and
    the NSF-HiFiGAN generator beside it."""
    import yaml

    from prodiff_tpu_torch.config import load_base_config
    from prodiff_tpu_torch.infer.handler import phone_encoder
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.utils import ckpt_utils, convert

    voc_dir = os.path.join(tmp, "nsf_hifigan")
    os.makedirs(voc_dir)
    torch.manual_seed(SEED)
    torch.save({"generator": seeded_generator(torch).state_dict()}, os.path.join(voc_dir, "model"))
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump(VOCODER_H, f)
    work = os.path.join(tmp, "checkpoints", BF16_EXP, "svs")
    os.makedirs(work)
    hp = dict(load_base_config(), **SLICE_HPARAMS, vocoder_ckpt=os.path.join(voc_dir, "model"),
              work_dir=work)
    teacher = ProDiffTeacher(len(phone_encoder(VAR_PHONES)), hp)
    torch.nn.init.normal_(teacher.diffusion.denoise_fn.output_projection.weight, std=0.02)
    ckpt_utils.write_checkpoint_file(
        os.path.join(work, "model_ckpt_steps_0.ckpt"),
        {"global_step": 0, "state_dict": convert.teacher_flax_params(teacher.state_dict(), hp)})
    with open(os.path.join(work, "config.yaml"), "w") as f:
        yaml.dump(hp, f)
    for name, m in (("phone_set", VAR_PHONES), ("spk_map", SPEAKERS),
                    ("lang_map", SLICE_HPARAMS["languages"])):
        with open(os.path.join(work, f"{name}.json"), "w") as f:
            json.dump(m, f)


def bf16_render(tmp, dev, torch) -> dict:
    """``infer samples/example.ds --precision fast`` by the CLI (K1-bf16 3
    launches a denoiser call and K2/K3-bf16 45 a batch, no float32 K1 or
    K2/K3) beside the same command in parity mode; the mel of a
    deterministic render in fast mode against the parity one, its wav at the
    JAX test's bound for bf16 tap stacks, and the fast vocoder alone on the
    parity render's mel; ``/api/infer`` served in fast mode. Returns the
    launches of the fast render."""
    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.infer.handler import SVSInferHandler
    from prodiff_tpu_torch.serve.handler import WebHandler

    import shutil

    write_bf16_tree(tmp, torch)
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "example.ds"),
                os.path.join(tmp, "example.ds"))
    batches = []
    acoustic = SVSInferHandler._acoustic

    def counted(self, *args):
        batches.append(args[1].shape)
        return acoustic(self, *args)

    cwd = os.getcwd()
    os.chdir(tmp)
    SVSInferHandler._acoustic = counted
    secs, launches = {}, None
    try:
        for mode in ("parity", "fast"):
            batches.clear()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            port_cli(["infer", "example.ds", "--exp_name", BF16_EXP, "--spk_name", "spk0",
                      "--device", str(dev), "--precision", mode])
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            steps = SLICE_HPARAMS["timesteps"] * sum(
                k1_bf16_launches(*shape) if mode == "fast" else K1_LAUNCHES for shape in batches)
            sfx = "_bf16" if mode == "fast" else ""
            got = check_counts(f"infer example.ds --precision {mode}",
                               {f"residual_stack{sfx}": steps,
                                f"resblock_stage{sfx}": len(batches) * 5 * (
                                    RES_BF16_LAUNCHES if mode == "fast" else RES_LAUNCHES)})
            if mode == "fast":
                launches = got
            if policy.precision() != "parity":
                raise AssertionError("the CLI left the precision mode changed")
    finally:
        SVSInferHandler._acoustic = acoustic
        os.chdir(cwd)
    seen, vocoders = {}, {}
    for mode in ("parity", "fast"):
        policy.set_precision(mode)
        try:
            handler = SVSInferHandler(BF16_EXP, checkpoints_root=os.path.join(tmp, "checkpoints"),
                                      deterministic=True, device=dev,
                                      out_dir=os.path.join(tmp, f"out_{mode}"))
            seen[mode] = capture_mel(handler)
            handler.handle(None, os.path.join(tmp, "example.ds"), "spk0", "zh")
            vocoders[mode] = handler.vocoder
        finally:
            policy.set_precision("parity")
    err = peak_compare("fast-mode render (K1-bf16) vs parity (K1) of example.ds, the mel into the "
                       "vocoder", torch.as_tensor(seen["fast"]["mel"]),
                       torch.as_tensor(seen["parity"]["mel"]), BF16_RENDER_TOL, torch)
    wav_fast, wav_parity = seen["fast"]["wav"], seen["parity"]["wav"]
    hold_wav("fast-mode render (K1-bf16, K2/K3-bf16) vs parity of example.ds, the last batch's "
             "wav", wav_fast, wav_parity)
    # the vocoder alone: the fast generator (bf16 tap stacks) on the parity mel
    reset_counts()
    alone = vocoders["fast"].spec2wav_batch(torch.as_tensor(seen["parity"]["mel"], device=dev),
                                            seen["parity"]["f0"], deterministic=True)
    torch.cuda.synchronize()
    check_counts("the fast vocoder on the parity mel", {"resblock_stage_bf16": 5 * RES_BF16_LAUNCHES})
    hold_wav("NSF-HiFiGAN with bf16 tap stacks vs float32 on the same (parity) mel, the last "
             "batch's wav", np.asarray(alone.float().cpu()), wav_parity)
    mel_p = torch.as_tensor(seen["parity"]["mel"], device=dev)
    turns = in_turns({m: lambda m=m: vocoders[m].spec2wav_batch(mel_p, seen["parity"]["f0"],
                                                               deterministic=True)
                      for m in ("parity", "fast")}, torch)
    log(f"NSF-HiFiGAN alone on that mel {list(mel_p.shape)}, parity (float32 stacks) and fast "
        f"(bf16 stacks) in turns, 10 each (host clock, synchronised, ms): "
        + json.dumps({k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in turns.items()}))
    fast_vs_parity_profile(
        f"NSF-HiFiGAN alone on that mel", {m: lambda m=m: vocoders[m].spec2wav_batch(
            mel_p, seen["parity"]["f0"], deterministic=True) for m in ("parity", "fast")},
        {"conv_kernel": "K2/K3 and K2/K3-bf16 resblock_stage",
         "unit_kernel": "K2/K3 and K2/K3-bf16 resblock_stage"}, torch)
    log(f"infer example.ds by the CLI ({len(batches)} batches {batches}, models loaded included): "
        f"parity {secs['parity']:.3f} s, fast {secs['fast']:.3f} s; the mel's max error "
        f"{err:.3e}")

    policy.set_precision("fast")
    try:
        core = SVSInferHandler(BF16_EXP, checkpoints_root=os.path.join(tmp, "checkpoints"),
                               device=dev)
        web = WebHandler(core=core, host="127.0.0.1", port=0)  # warm-up runs here
        reset_counts()
        wav = web.api_infer(request_payload(2.0, np.random.default_rng(SEED)))
        torch.cuda.synchronize()
        got = {k: c.count for k, c in counters().items() if c.count}
        if set(got) != {"residual_stack_bf16", "resblock_stage_bf16"}:
            raise AssertionError(f"/api/infer in fast mode launched {got}")
        log(f"/api/infer in fast mode (2 s request): launches {got}, {len(wav['wav'])} samples")
    finally:
        policy.set_precision("parity")
    return launches


def hold_wav(name, got, want) -> dict:
    """A bf16 render's wav against the float32 one at the JAX package's bound
    for bf16 tap stacks (``tests/test_nsf_packed.py:190-204``): max |diff| <
    0.05 and correlation > 0.999; raises beyond."""
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    err = float(np.abs(got - want).max())
    corr = float(np.corrcoef(got, want)[0, 1])
    ok = bool(np.isfinite(got).all()) and err < WAV_BF16_MAX_ABS and corr > WAV_BF16_CORR
    log(f"{name}: max_abs_err={err:.3e} (bound {WAV_BF16_MAX_ABS}), correlation {corr:.6f} (bound "
        f"{WAV_BF16_CORR}), peak {np.abs(want).max():.4f}, {got.size} samples "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the bf16 wav is off the float32 one")
    return {"max_abs_err": err, "correlation": corr}


def fast_vs_parity_profile(label, fns: dict, ours: dict, torch) -> None:
    """``kernel_split`` of each zero-argument render of ``fns`` (parity and
    fast, 2 calls each after a warm-up): host ms, kernel ms, the device's
    idle share, kernel launches and the time by group, a call."""
    for mode, fn in fns.items():
        fn()
        wall_ms, busy_ms, sums, rows = kernel_split(fn, 2, ours, torch)
        log(f"{label}, {mode}, under torch.profiler (mean of 2): {wall_ms:.3f} ms on the host "
            f"clock, {busy_ms:.3f} ms of kernel time (device idle share "
            f"{max(0.0, 1 - busy_ms / wall_ms):.3f}), {sum(n for _, n, _ in rows)} kernel "
            f"launches; by group (ms): " + json.dumps({g: round(v, 4) for g, v in sums.items()}))


def bf16_convergence(tmp, dev) -> None:
    """The 250-step float32-vs-bf16 loss curves on the card (the JAX test's
    small config, residual channels 64) with the JAX test's bounds."""
    import importlib.util

    # by its path: a package named ``tests`` elsewhere on sys.path would shadow the repo's
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_bf16_convergence.py")
    spec = importlib.util.spec_from_file_location("torch_bf16_convergence", path)
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    t0 = time.time()
    got = conv.check_curves(conv.convergence_curves(tmp, str(dev),
                                                    residual_channels=BF16_CONV_CHANNELS))
    log(f"convergence, 250 steps float32 vs bf16 on the card (small config, residual channels "
        f"{BF16_CONV_CHANNELS}): worst 25-step window {got['worst_window']:.4f} (bound 0.08), "
        f"tail {got['tail']:.4f} (bound 0.05; float32 {got['tail_f32']:.4f}, bf16 "
        f"{got['tail_bf16']:.4f}, head {got['head']:.4f}), {time.time() - t0:.3f} s")


def phase_bf16(dev, torch):
    """The bf16 policy's kernels and paths (the module docstring's phase 13).
    Returns the kernels-line summaries of K1/K5a/K5b-bf16 with the launches
    of their main paths, and K2/K3-bf16's launches in the fast render."""
    import shutil
    import tempfile

    from prodiff_tpu_torch import device as policy

    k1, k5a, k5b = bf16_kernels(dev, torch)
    tmp = tempfile.mkdtemp(prefix="prodiff_torch_bf16_")
    spans = {}
    try:
        t0 = time.time()
        train = bf16_train_runs(os.path.join(tmp, "train"), dev, torch)
        spans["train"] = time.time() - t0
        t0 = time.time()
        render = bf16_render(os.path.join(tmp, "render"), dev, torch)
        spans["render"] = time.time() - t0
        t0 = time.time()
        bf16_convergence(os.path.join(tmp, "convergence"), dev)
        spans["convergence"] = time.time() - t0
    finally:
        policy.set_precision("parity")
        shutil.rmtree(tmp, ignore_errors=True)
    if policy.precision() != "parity":
        raise AssertionError("the bf16 phase left fast mode on")
    log("bf16 phase spans (s): " + json.dumps({k: round(v, 3) for k, v in spans.items()}))
    k1["launches"] = render["residual_stack_bf16"]
    k5a["launches"] = train["residual_stack_save_bf16"]
    k5b["launches"] = train["residual_stack_chain_bf16"]
    return k1, k5a, k5b, render["resblock_stage_bf16"]


def res_variant(define: str, torch):
    """A call of the K2/K3-bf16 stage through a variant build of its source
    (``RES_BF16_SKIPS``), with the wrapper's arguments; for timing only."""
    import ctypes

    from prodiff_tpu_torch.ops import cuda_build

    fn = cuda_build.load("resblock_bf16", (define,)).resblock_stage_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w, biases, ksizes, dsizes):
        b, t, c = x.shape
        out, h, tmp = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)

        def arr(v):
            return (ctypes.c_int * len(v))(*v)

        err = fn(x.data_ptr(), out.data_ptr(), h.data_ptr(), tmp.data_ptr(), w.data_ptr(),
                 biases.data_ptr(), arr(list(ksizes)), arr([len(d) for d in dsizes]),
                 arr([d for ds in dsizes for d in ds]), len(ksizes), b, t, c,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"resblock_stage_bf16 ({define}): CUDA error {err}")
        return out

    return call


def bf16_vocoder_kernels(dev, torch) -> tuple:
    """K2/K3-bf16 at the five stages of one T_mel=512 vocoder pass, K4-bf16
    at every (block, layer) of the LJSpeech FastDiff net at T_mel=512 and
    K7-bf16 at blocks 1 and 2, each against its twin on the same bf16
    operands (the stage at ``RES_BF16_TOL`` of the peak: its chain of 18
    bf16 roundings turns the two sides' float32 sum orders into different
    roundings of a few conv inputs; K4/K7 at ``KERNEL_TOL``: both widen the
    same bf16 windows exactly), timed beside the float32 kernel on the same
    (float32) weights and windows, with bounds: the stage at the bf16 tensor
    cores' rate, K4/K7 at the FP32 rate counting the bf16 window bytes.
    K4/K7 are timed as ``phase_fastdiff_kernels`` times them (``graph_ms``
    over the four steps of a hoisted stack). Returns the kernels-line
    summaries of the three."""
    from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain
    from prodiff_tpu_torch.ops.ublock import (mono_block_supported, ublock_block,
                                              ublock_block_plain, ublock_layer, ublock_layer_plain)

    rng = np.random.default_rng(SEED + 15)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    res = {"max_abs_err": 0.0, "max_err_share_of_peak": 0.0, "ms": 0.0, "f32_ms": 0.0,
           "plain_ms": 0.0, "stages": []}
    res_variants = {name: res_variant(define, torch) for name, define in RES_BF16_SKIPS.items()}
    flops = nbytes = 0
    for c, t in RES_STAGES:
        taps = 6 * sum(RES_K)
        st_flops, st_bytes = 2 * taps * c * c * t, 4 * (2 * t * c + 18 * c) + 2 * taps * c * c
        flops += st_flops
        nbytes += st_bytes
        w32 = torch.cat([rand(k * c * c, scale=(k * c) ** -0.5) for k in RES_K for _ in range(6)])
        w16, biases, x = w32.to(torch.bfloat16), rand(18, c, scale=0.1), rand(1, t, c)
        before = counters()["resblock_stage_bf16"].count
        got = resblock_stage(x, w16, biases, RES_K, RES_D)
        torch.cuda.synchronize()
        if counters()["resblock_stage_bf16"].count - before != RES_BF16_LAUNCHES:
            raise AssertionError(f"K2/K3-bf16 did not launch {RES_BF16_LAUNCHES} units")
        want = resblock_stage_plain(x, w16, biases, RES_K, RES_D)
        err = peak_compare(f"K2/K3-bf16 resblock_stage C={c} T={t} vs its twin", got, want,
                           RES_BF16_TOL, torch)
        share = err / float(want.abs().max())
        ms = timed_ms(lambda: resblock_stage(x, w16, biases, RES_K, RES_D), 10, torch)
        f32_ms = timed_ms(lambda: resblock_stage(x, w32, biases, RES_K, RES_D), 10, torch)
        plain_ms = timed_ms(lambda: resblock_stage_plain(x, w16, biases, RES_K, RES_D), 3, torch)
        skips = {name: timed_ms(lambda fn=fn: fn(x, w16, biases, RES_K, RES_D), 10, torch)
                 for name, fn in res_variants.items()}
        parent = {} if PARENT is None else earlier_in_turns(
            f"K2/K3-bf16 C={c} T={t}", lambda: PARENT["stage"](x, w16, biases, RES_K, RES_D),
            lambda: resblock_stage(x, w16, biases, RES_K, RES_D), 10, torch)
        lim = bound(st_flops, st_bytes, BF16_PEAK)
        log(f"K2/K3-bf16 C={c} T={t}: kernel {ms:.4f} ms, float32 kernel {f32_ms:.4f} ms, plain "
            f"twin {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({st_flops / 1e9:.1f} GFLOP: "
            f"{lim['bound_by']}), share of bound {lim['bound_ms'] / ms:.3f}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_err_share_of_peak"] = max(res["max_err_share_of_peak"], share)
        for k, v in (("ms", ms), ("f32_ms", f32_ms), ("plain_ms", plain_ms)):
            res[k] += v
        log(f"K2/K3-bf16 C={c} T={t} with a part left out (ms): "
            + json.dumps({k: round(v, 4) for k, v in skips.items()}))
        res["stages"].append(dict(C=c, T=t, ms=ms, f32_ms=f32_ms, plain_ms=plain_ms,
                                  err_share_of_peak=share, skip_ms=skips, **parent, **lim,
                                  share=lim["bound_ms"] / ms))
    res.update(bound(flops, nbytes, BF16_PEAK))
    log(f"K2/K3-bf16, all 5 stages of one vocoder pass at T_mel=512: kernel {res['ms']:.4f} ms, "
        f"float32 kernel {res['f32_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s: {res['bound_by']}), "
        f"share of bound {res['bound_ms'] / res['ms']:.3f}")

    k4, k7 = lvc_bf16_kernels(dev, torch)
    return res, k4, k7


def mma_bound(t: int, n_layers: int, nbytes: float) -> dict:
    """The least time of K4-bf16's / K7-bf16's arithmetic over ``n_layers``
    layers of T = t rows: the window product's 12,288 FLOP a row x
    ``LVC_TERMS`` bf16 terms at the bf16 tensor cores' rate plus the conv's
    6,144 on FP32 FMAs, against ``nbytes`` at the HBM rate."""
    t_ops = n_layers * t * (12288 * LVC_TERMS / BF16_PEAK + 6144 / FP32_PEAK)
    t_bytes = nbytes / HBM_RATE
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def graph_in_turns(earlier, this, torch) -> dict:
    """``graph_ms`` of two lists of calls in turns (earlier, this, this,
    earlier): {"parent_ms": [2], "in_turns_ms": [2]}."""
    got = {"parent_ms": [graph_ms(earlier, torch)],
           "in_turns_ms": [graph_ms(this, torch) for _ in range(2)]}
    got["parent_ms"].append(graph_ms(earlier, torch))
    return got


def wide_range(rng, shape, torch, dev):
    """Normal values scaled element by element by 10 ** U(-3, 2) (magnitudes
    1e-3 to 1e2: tests/test_torch_ublock_bf16_split.py's activations)."""
    return torch.tensor(rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 2, size=shape),
                        dtype=torch.float32, device=dev)


def lvc_bf16_kernels(dev, torch) -> tuple:
    """K4-bf16 at every (block, layer) of the LJSpeech FastDiff net at
    T_mel=512 and K7-bf16 at blocks 1 and 2, each against its twin on the
    same bf16 windows at ``KERNEL_TOL`` (both compute with the windows
    widened exactly; the kernels' y in three bf16 terms keeps float32's
    bits), timed as ``phase_fastdiff_kernels`` times K4/K7 (``graph_ms``
    over the four steps of a hoisted stack) beside the float32 build on the
    same (float32) windows and the twin, with two bounds: the FP32 rate's
    (``bound``: every FMA at 67 TFLOP/s, bf16 window bytes) and the bf16
    build's arithmetic's (``mma_bound``). Per block also K4-bf16 built
    without the conv, the window product or both (``LVCT_SKIP``), and with
    ``--parent`` the earlier checkout's K4 / K7 in turns (earlier, this,
    this, earlier), both window dtypes; the variant and earlier builds are
    called through tools/probe_bf16_kernels.py's ``LvcBuild``. Then the
    wide-range check (``lvc_bf16_wide``) and K4-bf16 at the hops its
    contract takes beyond LJSpeech's (``lvc_bf16_widened_hops``). Returns
    the kernels-line summaries of K4-bf16 and K7-bf16."""
    from prodiff_tpu_torch.ops import cuda_build
    from prodiff_tpu_torch.ops.ublock import (mono_block_supported, ublock_block,
                                              ublock_block_plain, ublock_layer, ublock_layer_plain)

    rng = np.random.default_rng(SEED + 17)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    bf16 = torch.bfloat16
    lvc_build = probe_module().LvcBuild
    skips = {label: lvc_build(torch, cuda_build.load("ublock", (f"LVCT_SKIP={v}",))).layer
             for label, v in K4_SKIPS.items()}
    c, n_layers, n_win = 32, FD_CONFIG["lvc_layers_each_block"], FD_T_MEL
    dilations = [3 ** i for i in range(n_layers)]
    k4 = {"max_abs_err": 0.0, "ms": 0.0, "f32_ms": 0.0, "plain_ms": 0.0, "by_block": []}
    k7 = {"max_abs_err": 0.0, "ms": 0.0, "f32_ms": 0.0, "plain_ms": 0.0, "by_block": []}
    totals = {"k4": [0, 0, 0], "k7": [0, 0, 0]}  # FLOP, bytes, rows x layers
    for blk, hop in enumerate(FD_HOPS):
        t = n_win * hop
        x, ad = rand(1, t, c), rand(1, t, c)
        km16 = rand(FD_STEPS, 1, n_win, n_layers * 3 * c, 2 * c, scale=0.1).to(bf16)
        km32 = km16.float()
        lb = rand(FD_STEPS, 1, n_win, n_layers * 2 * c, scale=0.1)
        window_bytes = n_win * (2 * 3 * c * 2 * c + 4 * 2 * c)  # a (step, layer): bf16 kernels
        cws, cbs = [rand(c, c, 3, scale=0.2) for _ in dilations], [rand(c, scale=0.1)
                                                                    for _ in dilations]
        row = {"block": blk, "hop": hop, "T": t, "ms": 0.0, "f32_ms": 0.0, "plain_ms": 0.0,
               "max_abs_err": 0.0, "phases_ms": dict.fromkeys(K4_SKIPS, 0.0)}
        if PARENT is not None:
            row.update({k: [0.0, 0.0] for k in PARENT_LVC_KEYS})
        flops_b, bytes_b = 18432 * t * n_layers, n_layers * (4 * (3 * t * c + 3 * c * c + c)
                                                             + window_bytes)
        for i, d in enumerate(dilations):
            def call(fn, s, km, i=i, d=d):
                return fn(x, ad, cws[i], cbs[i], km, lb, d, hop, s, i)

            def steps(fn=ublock_layer, km=km16):
                return per_steps(lambda s: call(fn, s, km))
            res4 = compare(f"K4-bf16 ublock_layer hop={hop} dilation={d} (step {i}, layer {i}) vs "
                           f"its twin", call(ublock_layer, i, km16),
                           call(ublock_layer_plain, i, km16), torch)
            row["max_abs_err"] = max(row["max_abs_err"], res4["max_abs_err"])
            row["ms"] += graph_ms(steps(), torch)
            row["f32_ms"] += graph_ms(steps(km=km32), torch)
            row["plain_ms"] += graph_ms(steps(ublock_layer_plain), torch)
            for label, layer in skips.items():
                row["phases_ms"][label] += graph_ms(steps(layer), torch)
            if PARENT is not None:  # both builds, each against the earlier one in turns
                for pre, km in (("", km16), ("f32_", km32)):
                    turns = graph_in_turns(steps(PARENT["lvc"].layer, km), steps(km=km), torch)
                    for k, v in turns.items():
                        row[pre + k] = [a + b for a, b in zip(row[pre + k], v)]
        row["phases_ms"]["all"] = row["ms"]
        fp32 = bound(flops_b, bytes_b)
        row.update(bound_fp32_rate_ms=fp32["bound_ms"], bound_fp32_rate_by=fp32["bound_by"],
                   **mma_bound(t, n_layers, bytes_b))
        k4["max_abs_err"] = max(k4["max_abs_err"], row["max_abs_err"])
        log(f"K4-bf16 block {blk} (hop {hop}, T={t}), its {n_layers} layers: kernel "
            f"{row['ms']:.4f} ms, float32 K4 {row['f32_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; share "
            f"{row['bound_ms'] / row['ms']:.3f}), at the FP32 rate "
            f"{row['bound_fp32_rate_ms']:.4f} ms (share "
            f"{row['bound_fp32_rate_ms'] / row['ms']:.3f}); max |kernel - twin| "
            f"{row['max_abs_err']:.3e}")
        log(f"K4-bf16 block {blk} (hop {hop}) by phase (LVCT_SKIP builds), its {n_layers} layers: "
            + ", ".join(f"{k} {v:.4f}" for k, v in row["phases_ms"].items()))
        if PARENT is not None:
            log(f"K4-bf16 block {blk} (hop {hop}) in turns with the earlier design (its "
                f"{n_layers} layers): earlier {row['parent_ms']}, this {row['in_turns_ms']} ms; "
                f"float32 K4: earlier {row['f32_parent_ms']}, this {row['f32_in_turns_ms']} ms")
        for k in ("ms", "f32_ms", "plain_ms"):
            k4[k] += row[k]
        k4["by_block"].append(row)
        totals["k4"] = [a + v for a, v in zip(totals["k4"], (flops_b, bytes_b, t * n_layers))]
        if mono_block_supported(hop, dilations, bf16):
            def block(fn, s, km):
                return fn(x, ad, cws, cbs, km, lb, dilations, hop, s)

            def bsteps(fn=ublock_block, km=km16):
                return per_steps(lambda s: block(fn, s, km))
            res7 = compare(f"K7-bf16 ublock_block hop={hop} T={t} (step 2) vs its twin",
                           block(ublock_block, 2, km16), block(ublock_block_plain, 2, km16), torch)
            k7["max_abs_err"] = max(k7["max_abs_err"], res7["max_abs_err"])
            bytes7 = 4 * (3 * t * c + n_layers * (3 * c * c + c)) + n_layers * window_bytes
            fp32 = bound(flops_b, bytes7)
            row7 = dict(block=blk, hop=hop, T=t, ms=graph_ms(bsteps(), torch),
                        f32_ms=graph_ms(bsteps(km=km32), torch),
                        plain_ms=graph_ms(bsteps(ublock_block_plain), torch),
                        max_abs_err=res7["max_abs_err"], bound_fp32_rate_ms=fp32["bound_ms"],
                        bound_fp32_rate_by=fp32["bound_by"], **mma_bound(t, n_layers, bytes7))
            if PARENT is not None:
                for pre, km in (("", km16), ("f32_", km32)):
                    turns = graph_in_turns(bsteps(PARENT["lvc"].block, km), bsteps(km=km), torch)
                    row7.update({pre + k: v for k, v in turns.items()})
            log(f"K7-bf16 block {blk} (hop {hop}, T={t}): kernel {row7['ms']:.4f} ms, float32 K7 "
                f"{row7['f32_ms']:.4f} ms, plain {row7['plain_ms']:.4f} ms; bound "
                f"{row7['bound_ms']:.4f} ms ({row7['bound_by']}; share "
                f"{row7['bound_ms'] / row7['ms']:.3f}), at the FP32 rate "
                f"{row7['bound_fp32_rate_ms']:.4f} ms (share "
                f"{row7['bound_fp32_rate_ms'] / row7['ms']:.3f})"
                + (f"; in turns with the earlier design: earlier {row7['parent_ms']}, this "
                   f"{row7['in_turns_ms']} ms; float32 K7: earlier {row7['f32_parent_ms']}, this "
                   f"{row7['f32_in_turns_ms']} ms" if PARENT is not None else ""))
            for k in ("ms", "f32_ms", "plain_ms"):
                k7[k] += row7[k]
            k7["by_block"].append(row7)
            totals["k7"] = [a + v for a, v in zip(totals["k7"], (flops_b, bytes7, t * n_layers))]
        del km16, km32, lb
    for acc, (flops, nbytes, rows_layers) in ((k4, totals["k4"]), (k7, totals["k7"])):
        fp32 = bound(flops, nbytes)
        acc.update(bound_fp32_rate_ms=fp32["bound_ms"], bound_fp32_rate_by=fp32["bound_by"],
                   **mma_bound(rows_layers, 1, nbytes))
        for k in PARENT_LVC_KEYS if PARENT is not None else ():
            acc[k] = [sum(r[k][j] for r in acc["by_block"]) for j in range(2)]
    for name, acc in (("K4-bf16, the 12 layers", k4), ("K7-bf16, blocks 1 and 2", k7)):
        log(f"{name} of one FastDiff forward at T_mel={FD_T_MEL}: kernel {acc['ms']:.4f} ms, "
            f"float32 kernel {acc['f32_ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, bound "
            f"{acc['bound_ms']:.4f} ms ({acc['bound_by']}: the product's {LVC_TERMS} terms at "
            f"989 TFLOP/s, the conv at 67, bytes at 3.35 TB/s; share "
            f"{acc['bound_ms'] / acc['ms']:.3f}), at the FP32 rate {acc['bound_fp32_rate_ms']:.4f} "
            f"ms (share {acc['bound_fp32_rate_ms'] / acc['ms']:.3f})"
            + (f"; in turns with the earlier design: earlier {acc['parent_ms']}, this "
               f"{acc['in_turns_ms']} ms; float32: earlier {acc['f32_parent_ms']}, this "
               f"{acc['f32_in_turns_ms']} ms" if PARENT is not None else ""))
    k4["wide_range"] = lvc_bf16_wide(dev, torch)
    k4["widened_hops"] = lvc_bf16_widened_hops(dev, torch)
    k4["max_abs_err"] = max([k4["max_abs_err"]] + [r["max_abs_err"] for r in k4["widened_hops"]])
    torch.cuda.empty_cache()
    return k4, k7


def layer_f64(x, ad, cw, cb, km, lb, d, hop, layer, torch):
    """ublock_layer_plain's layer in float64 (step 0 of the stack, layer
    ``layer``): the reference of the wide-range check."""
    import torch.nn.functional as F

    from prodiff_tpu_torch.ops.ublock import dilated_conv, gated_residual

    xa = x.double() + ad.double()
    y = F.leaky_relu(dilated_conv(F.leaky_relu(xa, 0.2), cw.double(), cb.double(), d), 0.2)
    b, t, c = y.shape
    k = km[0, :, :, layer * 3 * c:(layer + 1) * 3 * c].double()
    bias = lb[0, :, :, layer * 2 * c:(layer + 1) * 2 * c].double()
    yp = F.pad(y, (0, 0, 1, 1))
    taps = torch.cat([yp[:, j: j + t] for j in range(3)], dim=2).view(b, t // hop, hop, 3 * c)
    return gated_residual(xa, (torch.matmul(taps, k) + bias[:, :, None, :]).reshape(b, t, 2 * c))


def lvc_bf16_wide(dev, torch) -> list:
    """K4-bf16 on wide-range x and audio_down (1e-3 .. 1e2) at the LJSpeech
    hops (B=1, 512 windows; layer 3, dilation 27), twice:
    - windows at the card tests' scale (normal x 0.1): against the twin at
      ``KERNEL_TOL``, the largest error and its share of the tolerance,
      which it must meet;
    - windows of a seeded bf16 KernelPredictor (std ~1): there the float32
      sums' rounding alone exceeds ``KERNEL_TOL`` (|gate, filter| reach
      ~1e3), so no float32 computation meets it against the twin, nor the
      twin against float64; K4-bf16, the float32 K4 and the twin are each
      held against the layer in float64 (``layer_f64``), and K4-bf16 must
      come no further from it than the float32 computations (the twin, the
      float32 K4) do. Its distance from the twin is logged."""
    from prodiff_tpu_torch.models.fastdiff import KernelPredictor
    from prodiff_tpu_torch.ops.ublock import ublock_layer, ublock_layer_plain

    rng = np.random.default_rng(SEED + 18)
    c, n_layers, n_win, i = 32, FD_CONFIG["lvc_layers_each_block"], FD_T_MEL, 3
    torch.manual_seed(SEED)
    kp = KernelPredictor(FD_CONFIG["cond_channels"], c, 2 * c, n_layers,
                         dtype=torch.bfloat16).to(dev)
    cond = torch.tensor(rng.normal(size=(1, n_win, FD_CONFIG["cond_channels"])) - 4.0,
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        kflat, bflat = kp(cond)
    kp_windows = (kflat.view(1, 1, n_win, n_layers * 3 * c, 2 * c),
                  bflat.float().view(1, 1, n_win, n_layers * 2 * c))

    def share(got, want):
        err = (got.double() - want.double()).abs()
        tol = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.double().abs()
        return {"max_abs_err": float(err.max()), "share_of_tol": float((err / tol).max()),
                "over_tol": int((err > tol).sum())}
    out = []
    for hop in FD_HOPS:
        t = n_win * hop
        x, ad = wide_range(rng, (1, t, c), torch, dev), wide_range(rng, (1, t, c), torch, dev)
        cw = torch.tensor(rng.normal(size=(c, c, 3)) * 0.2, dtype=torch.float32, device=dev)
        cb = torch.tensor(rng.normal(size=c) * 0.1, dtype=torch.float32, device=dev)
        card = (torch.tensor(rng.normal(size=(1, 1, n_win, n_layers * 3 * c, 2 * c)) * 0.1,
                             dtype=torch.float32, device=dev).to(torch.bfloat16),
                torch.tensor(rng.normal(size=(1, 1, n_win, n_layers * 2 * c)) * 0.1,
                             dtype=torch.float32, device=dev))
        rec = {"hop": hop, "T": t, "kp_window_std": float(kp_windows[0].float().std())}
        for scale, (km, lb) in (("card_scale", card), ("kp_scale", kp_windows)):
            def run(kmat=km):
                return ublock_layer(x, ad, cw, cb, kmat, lb, 3 ** i, hop, 0, i)
            twin = ublock_layer_plain(x, ad, cw, cb, km, lb, 3 ** i, hop, 0, i)
            if scale == "card_scale":
                rec[scale] = {"vs_twin": share(run(), twin)}
            else:
                ref = layer_f64(x, ad, cw, cb, km, lb, 3 ** i, hop, i, torch)
                rec[scale] = {"vs_float64": {"k4_bf16": share(run(), ref),
                                             "float32_k4": share(run(km.float()), ref),
                                             "twin": share(twin, ref)},
                              "vs_twin": share(run(), twin)}
        log(f"K4-bf16 on wide-range activations (1e-3 .. 1e2), hop {hop}: " + json.dumps(
            {k: rec[k] for k in ("card_scale", "kp_scale")}))
        if rec["card_scale"]["vs_twin"]["over_tol"]:
            raise AssertionError(f"K4-bf16 at hop {hop} is off its twin on wide-range activations")
        f64 = rec["kp_scale"]["vs_float64"]
        if f64["k4_bf16"]["max_abs_err"] > max(f64["twin"]["max_abs_err"],
                                                f64["float32_k4"]["max_abs_err"]):
            raise AssertionError(f"K4-bf16 at hop {hop} is further from float64 than the float32 "
                                 f"twin and K4 on wide-range activations with the "
                                 f"KernelPredictor's windows")
        out.append(rec)
    return out


def lvc_bf16_widened_hops(dev, torch) -> list:
    """K4-bf16 against its twin at the hops its contract takes beyond the
    LJSpeech net's (``K4_EXTRA_HOPS``: B=2, 512 windows, layer 3, dilation
    27; operands drawn on the card), timed a layer with both bounds."""
    from prodiff_tpu_torch.ops.ublock import ublock_layer, ublock_layer_plain

    c, n_layers = 32, FD_CONFIG["lvc_layers_each_block"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)

    def drand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    rows = []
    for hop in K4_EXTRA_HOPS:
        b, n, i, d = 2, K4_EXTRA_WINDOWS, n_layers - 1, 3 ** (n_layers - 1)
        t = n * hop
        x, ad = drand(b, t, c), drand(b, t, c)
        cw, cb = drand(c, c, 3, scale=0.2), drand(c, scale=0.1)
        km = drand(FD_STEPS, b, n, n_layers * 3 * c, 2 * c, scale=0.1).to(torch.bfloat16)
        lb = drand(FD_STEPS, b, n, n_layers * 2 * c, scale=0.1)

        def call(fn, s):
            return fn(x, ad, cw, cb, km, lb, d, hop, step_idx=s, layer_idx=i)
        res = compare(f"K4-bf16 ublock_layer hop={hop} B={b} L={n} dilation={d} (step 0, layer "
                      f"{i})", call(ublock_layer, 0), call(ublock_layer_plain, 0), torch)
        ms = graph_ms(per_steps(lambda s: call(ublock_layer, s)), torch)
        nbytes = 4 * (3 * b * t * c + 3 * c * c + c) + b * n * (2 * 3 * c * 2 * c + 4 * 2 * c)
        fp32 = bound(18432 * b * t, nbytes)
        row = dict(hop=hop, B=b, T=t, dilation=d, ms=ms, max_abs_err=res["max_abs_err"],
                   bound_fp32_rate_ms=fp32["bound_ms"], **mma_bound(b * t, 1, nbytes))
        log(f"K4-bf16 hop={hop} B={b} T={t} dilation={d}: kernel {ms:.4f} ms a layer, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; share {row['bound_ms'] / ms:.3f}), at "
            f"the FP32 rate {row['bound_fp32_rate_ms']:.4f} ms")
        rows.append(row)
        del km, lb
    return rows


def bf16_fastdiff_paths(dev, torch) -> dict:
    """The FastDiff text->wav path of ``phase_fastdiff`` (its seeded weights
    and inputs) in fast mode: the layer route launches K1-bf16 and K4-bf16
    only, the ``MONO_BLOCK`` route K1-bf16, K7-bf16 (blocks 1, 2) and K4-bf16
    (block 0), the unfused route (``fastdiff_packed: false``) K1-bf16 and the
    float32 K6 (the JAX package gives ``lvc_pallas`` no bf16 windows); then
    the fast vocoder alone against the parity one on the same mel and
    injected noise at ``FD_BF16_WAV_TOL`` of the wav's peak. Returns the
    launches of the layer and mono routes."""
    import prodiff_tpu_torch.models.fastdiff as fd_model
    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.vocoders import get_vocoder_cls

    teacher, _, fd_sd = fastdiff_models(dev, torch)
    vocoder = get_vocoder_cls("fastdiff")
    rng = np.random.default_rng(SEED)
    tokens, mel2ph, f0, lang, spk = (torch.as_tensor(a, device=dev) for a in
                                     fastdiff_inputs(rng, FD_T_PH, FD_T_MEL))
    n_lay, n_blocks = FD_CONFIG["lvc_layers_each_block"], len(FD_HOPS)
    launches = {}
    policy.set_precision("fast")
    try:
        voc = vocoder({}, state_dict=fd_sd, config=FD_CONFIG, device=dev)
        voc_unfused = vocoder({"fastdiff_packed": False}, state_dict=fd_sd, config=FD_CONFIG,
                              device=dev)
        if voc.model.lvc_blocks[0].kernel_predictor.dtype != torch.bfloat16 or \
                voc_unfused.model.lvc_blocks[0].kernel_predictor.dtype is not None:
            raise AssertionError("fast mode did not give the fused route, and it alone, a bf16 KP")

        def render(v, mono=False):
            fd_model.MONO_BLOCK = mono
            try:
                gen = torch.Generator(dev).manual_seed(1)
                mel = teacher.infer(tokens, mel2ph, f0, infer_step=FD_TEACHER_STEPS, lang_seq=lang,
                                    spk_embed_id=spk, generator=gen)
                return v.spec2wav(mel[0], generator=gen)
            finally:
                fd_model.MONO_BLOCK = False

        for label, v, mono, want in (
                ("layer", voc, False, {"ublock_layer_bf16": FD_STEPS * n_blocks * n_lay}),
                ("mono", voc, True, {"ublock_block_bf16": FD_STEPS * 2,
                                     "ublock_layer_bf16": FD_STEPS * n_lay}),
                ("unfused", voc_unfused, False, {"lvc": FD_STEPS * n_blocks * n_lay})):
            render(v, mono)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            start = time.perf_counter()
            wav = render(v, mono)
            ms = (time.perf_counter() - start) * 1e3
            k1 = FD_TEACHER_STEPS * k1_bf16_launches(1, FD_T_MEL, FD_TEACHER_HPARAMS[
                "residual_channels"], FD_TEACHER_HPARAMS["residual_layers"])
            launches[label] = check_counts(f"the FastDiff text->wav render in fast mode, {label} "
                                           f"route", dict(want, residual_stack_bf16=k1))
            if wav.shape != (FD_T_MEL * voc.hop,) or not np.isfinite(wav).all():
                raise AssertionError(f"fast FastDiff render ({label}): wav {wav.shape}")
            log(f"FastDiff text->wav in fast mode, {label} route: {ms:.3f} ms on the host clock "
                f"(with the wav's copy), peak {np.abs(wav).max():.4f}")
    finally:
        policy.set_precision("parity")
    # the fast vocoder (bf16 KP and windows) vs the parity one, same mel and noise
    voc_parity = vocoder({}, state_dict=fd_sd, config=FD_CONFIG, device=dev)
    nrng = np.random.default_rng(SEED + 16)
    n_samples = FD_T_MEL * voc.hop
    mel = torch.tensor(nrng.normal(size=(FD_T_MEL, FD_CONFIG["cond_channels"])) - 4.0,
                       dtype=torch.float32, device=dev)
    noise = dict(init_noise=torch.tensor(nrng.normal(size=(1, n_samples, 1)), dtype=torch.float32,
                                         device=dev),
                 step_noises=torch.tensor(nrng.normal(size=(FD_STEPS, 1, n_samples, 1)),
                                          dtype=torch.float32, device=dev))
    for mono in (False, True):
        fd_model.MONO_BLOCK = mono
        try:
            got, want = voc.spec2wav(mel, **noise), voc_parity.spec2wav(mel, **noise)
            turns = in_turns({"parity": lambda: voc_parity.spec2wav(mel, **noise),
                              "fast": lambda: voc.spec2wav(mel, **noise)}, torch)
        finally:
            fd_model.MONO_BLOCK = False
        route = f"K{7 if mono else 4}-bf16"
        peak_compare(f"FastDiff-4 in fast mode (bf16 KP, {route}) vs parity on one mel and "
                     f"injected noise, the wav", torch.as_tensor(got), torch.as_tensor(want),
                     FD_BF16_WAV_TOL, torch)
        log(f"FastDiff-4 alone ({route} route), parity and fast in turns, 10 each (host clock, "
            f"synchronised, with the wav's copy, ms): "
            + json.dumps({k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in turns.items()}))
    fast_vs_parity_profile(
        "FastDiff-4 alone (K4 route)", {"parity": lambda: voc_parity.spec2wav(mel, **noise),
                                        "fast": lambda: voc.spec2wav(mel, **noise)},
        {"ublock_tiled_kernel": "K4 ublock_layer", "ublock_stream_kernel": "K4 ublock_layer"},
        torch)
    return launches


def phase_bf16_vocoders(dev, torch):
    """The serving vocoders in fast mode (the module docstring's phase 14):
    the kernels, then the FastDiff paths (the SVS render's are
    ``bf16_render``'s, in phase 13). Returns the kernels-line summaries of
    K2/K3-, K4- and K7-bf16 with the launches of the FastDiff routes."""
    res, k4, k7 = bf16_vocoder_kernels(dev, torch)
    launches = bf16_fastdiff_paths(dev, torch)
    k4["launches"] = launches["layer"]["ublock_layer_bf16"]
    k4["launches_mono"] = launches["mono"]["ublock_layer_bf16"]
    k7["launches"] = launches["mono"]["ublock_block_bf16"]
    return res, k4, k7


# the other vocoders (phase 15): HiFi-GAN V1/V2/V3 (Kong et al., NeurIPS 2020,
# config_v1/v2/v3.json) and Parallel WaveGAN (kan-bayashi parallel_wavegan.v1,
# LJSpeech), behind vocode wav2wav at the LJSpeech audio settings
HIFIGAN_V1 = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
              "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 512,
              "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3,
              "audio_sample_rate": 22050}
HIFIGAN_V2 = dict(HIFIGAN_V1, upsample_initial_channel=128)
HIFIGAN_V3 = {"resblock": "2", "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
              "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 5, 7],
              "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]], "audio_sample_rate": 22050}
PWG_V1 = {"hop_size": 256, "generator_params": {
    "layers": 30, "stacks": 3, "residual_channels": 64, "gate_channels": 128,
    "skip_channels": 64, "aux_channels": 80, "aux_context_window": 2, "kernel_size": 3,
    "upsample_params": {"upsample_scales": [4, 4, 4, 4]}, "use_pitch_embed": False}}
OTHER_SAMPLES = 132300  # the 6.0 s tone at 22.05 kHz: 516 mel frames
OTHER_CPU_FRAMES = 32  # the card vs CPU renders run a 32-frame tone
# (name, config, vocoder, hparams, precision mode, K2/K3 launches a render and at C = 8)
OTHER_CELLS = (
    ("hifigan_v1", HIFIGAN_V1, "hifigan", {}, "parity", 72, 0),
    ("hifigan_v2", HIFIGAN_V2, "hifigan", {}, "parity", 3 * 18 + 1, 1),
    ("hifigan_v3", HIFIGAN_V3, "hifigan", {}, "parity", 0, 0),
    ("hifigan_v1_nsf", dict(HIFIGAN_V1, use_pitch_embed=True), "hifigan", {"use_nsf": True},
     "parity", 72, 0),
    ("pwg", PWG_V1, "pwg", {}, "parity", 0, 0),
    ("hifigan_v1_fast", HIFIGAN_V1, "hifigan", {}, "fast", 4 * RES_BF16_LAUNCHES, 0),
    ("hifigan_v2_fast", HIFIGAN_V2, "hifigan", {}, "fast", 3 * RES_BF16_LAUNCHES + 1, 1),
)
# the stages of V1 and V2 at T_mel = 512 (C, T)
HIFIGAN_STAGES = {"V1": ((256, 4096), (128, 32768), (64, 65536), (32, 131072)),
                  "V2": ((64, 4096), (32, 32768), (16, 65536), (8, 131072))}


# NSF-HiFiGAN's last stage at T_mel = 512 (its others are V1's shapes): with
# --parent, timed in turns too
NSF_LAST_STAGE = (16, 262144)
C8_TIMED = ("ms: the kernel alone, 10 replays of a CUDA graph of 4 calls; eager_ms: through "
            "the wrapper, CUDA events, 3 warm-ups, mean of 20")
PARENT_KEYS = ("parent_ms", "in_turns_ms", "parent_graph_ms", "in_turns_graph_ms")


def other_vocoder_kernels(dev, torch) -> dict:
    """K2 and K2-bf16 at C = 8 (V2's last stage, T_mel = 512: the whole
    stage in one launch) against the plain twin (float32 at ``KERNEL_TOL``,
    bf16 at ``RES_BF16_TOL`` of the peak), one launch each on its counters,
    timed as the kernel alone (``ms``: ``graph_ms`` of 4 calls, as K4/K6/K7:
    the wrapper's Python is longer than the kernel) and eagerly through the
    wrapper (``eager_ms``: CUDA events, 3 warm-ups, mean of 20); then K2/K3
    at every stage of V1 and V2 in both tap dtypes, timed (CUDA events, 3
    warm-ups, mean of 20) beside the twin and the bound. With ``--parent``,
    the earlier version's in turns (earlier, this, this, earlier): its
    per-conv C = 8 kernels both ways, and its float32 K2/K3 at every stage
    of V1, V2 and NSF-HiFiGAN's last. Returns the C = 8 rows and the stage
    table."""
    from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain

    rng = np.random.default_rng(SEED + 16)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    taps = 6 * sum(RES_K)
    out = {"stages": {}}
    stages = dict(HIFIGAN_STAGES)
    if PARENT is not None:
        stages["NSF-HiFiGAN last"] = (NSF_LAST_STAGE,)
    for model, shapes in stages.items():
        rows = []
        for c, t in shapes:
            w32 = torch.cat([rand(k * c * c, scale=(k * c) ** -0.5) for k in RES_K for _ in range(6)])
            w16, biases, x = w32.to(torch.bfloat16), rand(18, c, scale=0.1), rand(1, t, c)
            flops = 2 * taps * c * c * t
            row = {"C": c, "T": t}
            for dt, w in (("float32", w32), ("bf16", w16)):
                if model not in HIFIGAN_STAGES and dt == "bf16":
                    continue
                nbytes = 4 * (2 * t * c + 18 * c) + w.element_size() * taps * c * c
                lim = bound(flops, nbytes, FP32_PEAK if dt == "float32" else BF16_PEAK)

                def call():
                    return resblock_stage(x, w, biases, RES_K, RES_D)

                ms = timed_ms(call, 20, torch)
                row[dt] = dict(ms=ms, **lim, share=lim["bound_ms"] / ms)
                earlier = None if PARENT is None else PARENT["stage" if dt == "bf16" else "stage32"]
                if c == 8:
                    name = f"K2{'-bf16' if dt == 'bf16' else ''} C=8 T={t}"
                    counter = counters()["resblock_stage_c8_bf16" if dt == "bf16" else "resblock_stage_c8"]
                    before = counter.count
                    got = call()
                    torch.cuda.synchronize()
                    if counter.count - before != 1:
                        raise AssertionError(f"{name}: {counter.count - before} launches, not 1")
                    want = resblock_stage_plain(x, w, biases, RES_K, RES_D)
                    if dt == "float32":
                        err = compare(f"{name} vs its twin", got, want, torch)["max_abs_err"]
                    else:
                        err = peak_compare(f"{name} vs its twin", got, want, RES_BF16_TOL, torch)
                    graph = graph_ms([call] * 4, torch)
                    plain_ms = timed_ms(lambda: resblock_stage_plain(x, w, biases, RES_K, RES_D),
                                        20, torch)
                    parent = {}
                    if earlier is not None:
                        parent = earlier_in_turns(f"{name}, eager",
                                                  lambda: earlier(x, w, biases, RES_K, RES_D),
                                                  call, 20, torch)
                        parent.update(
                            parent_graph_ms=[graph_ms([lambda: earlier(x, w, biases, RES_K, RES_D)]
                                                      * 4, torch)],
                            in_turns_graph_ms=[graph_ms([call] * 4, torch) for _ in range(2)])
                        parent["parent_graph_ms"].append(graph_ms(
                            [lambda: earlier(x, w, biases, RES_K, RES_D)] * 4, torch))
                        log(f"{name} by CUDA graph in turns with the earlier design: earlier "
                            f"{parent['parent_graph_ms']}, this {parent['in_turns_graph_ms']} ms")
                    out[dt] = dict(max_abs_err=err, ms=graph, eager_ms=ms, plain_ms=plain_ms,
                                   **parent, **lim)
                    row[dt].update(ms=graph, eager_ms=ms, share=lim["bound_ms"] / graph)
                    log(f"{name}: kernel {graph:.4f} ms (CUDA graph), eager {ms:.4f} ms, plain "
                        f"twin {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({flops / 1e9:.3f} "
                        f"GFLOP, {nbytes / 1e6:.2f} MB: {lim['bound_by']}), share of bound "
                        f"{lim['bound_ms'] / graph:.3f}")
                elif earlier is not None and dt == "float32":
                    row[dt].update(earlier_in_turns(f"K2/K3 {model} C={c} T={t}",
                                                    lambda: earlier(x, w, biases, RES_K, RES_D),
                                                    call, 20, torch))
            log(f"HiFi-GAN {model} stage C={c} T={t}: "
                + ", ".join(f"{'float32 K2/K3' if dt == 'float32' else 'K2/K3-bf16'} "
                            f"{row[dt]['ms']:.4f} ms (bound {row[dt]['bound_ms']:.4f}, share "
                            f"{row[dt]['share']:.3f})" for dt in ("float32", "bf16") if dt in row))
            rows.append(row)
        out["stages"][model] = rows
        if model in HIFIGAN_STAGES:
            log(f"HiFi-GAN {model}, its 4 stages at T_mel=512: float32 "
                f"{sum(r['float32']['ms'] for r in rows):.4f} ms, bf16 "
                f"{sum(r['bf16']['ms'] for r in rows):.4f} ms")
    torch.cuda.empty_cache()
    return out


def scale_pwg_output(gen, torch, peak: float = 0.4) -> None:
    """Scale a random-weight PWG's last conv so that its wav peaks near
    ``peak`` on a unit-normal mel (its output is linear: unscaled, it can
    leave save_wav's int16 range)."""
    rng = np.random.default_rng(SEED + 17)
    c = torch.tensor(rng.normal(size=(1, 20, 80)), dtype=torch.float32)
    z = torch.tensor(rng.normal(size=(1, 16 * 256, 1)), dtype=torch.float32)
    with torch.no_grad():
        wav = gen(z, c)
        gen.last_conv_layers[3].weight.mul_(peak / float(wav.abs().max()))
        gen.last_conv_layers[3].bias.zero_()


def phase_other_vocoders(dev, torch):
    """``vocode wav2wav`` (in-process, ``__main__.main``) through HiFi-GAN V1,
    V2, V3, V1 with its NSF source and Parallel WaveGAN, in parity mode, and
    V1 and V2 in fast mode, at full width on seeded random checkpoints (V1,
    V2 and PWG in the layouts the wrappers resolve: a framework
    ``config.yaml`` + ``model_ckpt_steps_*.ckpt``, the release
    ``config.json`` + ``generator_v1``, ``checkpoint-*steps.pkl``), on the
    6.0 s tone at 22.05 kHz with ACF pitch and the random draws injected
    (the NSF source's phases and noise, PWG's ``z``, made on the CPU from one
    seed). Each render's launches (72 K2/K3 for V1, 55 for V2, 1 of them at
    C = 8; none for V3 and PWG), its host clock and, in a second run
    under torch.profiler, its kernel time and the device's idle share; each
    parity cell held against the same command on the CPU on a 32-frame tone;
    fast V1/V2 against parity at the bound for bf16 tap stacks. Before them,
    ``other_vocoder_kernels``. Returns (kernel rows, launches by cell)."""
    import shutil
    import tempfile

    import yaml
    from scipy.io import wavfile

    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.__main__ import main as port_cli
    from prodiff_tpu_torch.models.hifigan import HifiGanGenerator, source_draws
    from prodiff_tpu_torch.models.pwg import ParallelWaveGANGenerator
    from prodiff_tpu_torch.vocoders.hifigan import PWG, HifiGAN

    kern = other_vocoder_kernels(dev, torch)
    tmp = tempfile.mkdtemp(prefix="prodiff_torch_other_vocoders_")
    audio = dict(VOCODE_FD_AUDIO)

    def seeded_hifigan(h, seed):
        torch.manual_seed(seed)
        gen = HifiGanGenerator.from_config(h)
        with torch.no_grad():  # fan-in scaled, as seeded_generator; conv_post at 0.3
            for m in gen.modules():
                if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                    w = m.weight
                    fan_in = w.shape[1] * w.shape[2] if isinstance(m, torch.nn.Conv1d) \
                        else w.shape[0] * w.shape[2] / m.stride[0]
                    torch.nn.init.normal_(w, std=0.5 / fan_in ** 0.5)
            gen.conv_post.weight.mul_(0.3)
        return gen

    dirs = {}
    for i, (name, cfg, kind, _, mode, _, _) in enumerate(OTHER_CELLS):
        base = name.replace("_fast", "")
        if base in dirs:
            continue
        d = dirs[base] = os.path.join(tmp, base)
        os.makedirs(d)
        if kind == "pwg":
            torch.manual_seed(SEED + 20 + i)
            gen = ParallelWaveGANGenerator.from_config(PWG_V1).eval()
            scale_pwg_output(gen, torch)
            with open(os.path.join(d, "config.yaml"), "w") as f:
                yaml.dump({**PWG_V1, **audio}, f)
            torch.save({"model": {"generator": gen.state_dict()}, "steps": 400000},
                       os.path.join(d, "checkpoint-400000steps.pkl"))
        elif base == "hifigan_v2":  # the release layout
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(cfg, f)
            torch.save({"generator": seeded_hifigan(cfg, SEED + 20 + i).state_dict()},
                       os.path.join(d, "generator_v1"))
        else:  # the framework layout
            with open(os.path.join(d, "config.yaml"), "w") as f:
                yaml.dump({**cfg, **audio}, f)
            sd = {f"model_gen.{k}": v for k, v in seeded_hifigan(cfg, SEED + 20 + i).state_dict().items()}
            torch.save({"state_dict": sd}, os.path.join(d, "model_ckpt_steps_1000.ckpt"))

    sr, hop = audio["audio_sample_rate"], audio["hop_size"]
    tones = {}
    for label, n in (("full", OTHER_SAMPLES), ("short", OTHER_CPU_FRAMES * hop)):
        wav_dir = os.path.join(tmp, f"in_{label}")
        os.makedirs(wav_dir)
        tones[label] = os.path.join(wav_dir, "tone.wav")
        wavfile.write(tones[label], sr, vibrato_tone(n, sr, SEED + 11))

    def draws_for(n_frames, where):
        """The injected draws of an n-frame render, made on the CPU from one seed."""
        g = torch.Generator().manual_seed(SEED + 18)
        d = source_draws(1, n_frames * hop, 8, g)
        return tuple(t.to(where) for t in d)

    def z_for(n_frames, where):
        g = torch.Generator().manual_seed(SEED + 19)
        return torch.randn((1, n_frames * hop, 1), generator=g).to(where)

    hifigan_render, pwg_render = HifiGAN.spec2wav, PWG.spec2wav

    def cli(name, cell_hp, kind, tone, where, profiled=False):
        """One ``vocode wav2wav`` run: (the written wav, host-clock ms, and
        under torch.profiler the kernel ms and their split by group)."""
        cfg = os.path.join(tmp, f"{name}.yaml")
        with open(cfg, "w") as f:
            yaml.dump(dict(audio, vocoder=kind, vocoder_ckpt=dirs[name.replace("_fast", "")],
                           **cell_hp), f)
        out_dir = os.path.join(tmp, f"out_{name}_{where}_{os.path.basename(os.path.dirname(tone))}")
        argv = ["vocode", "wav2wav", tone, "--config", cfg, "--output_dir", out_dir,
                "--device", where]
        busy, sums = None, {}
        if profiled:
            wall_ms, busy, sums, _ = kernel_split(lambda: port_cli(argv), 1,
                                                  {"conv_kernel": "K2/K3 resblock_stage",
                                                   "unit_kernel": "K2/K3-bf16 resblock_stage",
                                                   "c8_stage_kernel": "K2 / K2-bf16 C=8"}, torch)
        else:
            start = time.perf_counter()
            port_cli(argv)
            if where == "cuda":
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        _, wav = wavfile.read(os.path.join(out_dir, "tone.wav"))
        return wav, wall_ms, busy, sums

    HifiGAN.spec2wav = lambda self, mel, **kw: hifigan_render(
        self, mel, draws=draws_for(len(mel), self.device), **kw)
    PWG.spec2wav = lambda self, mel, **kw: pwg_render(self, mel, z=z_for(len(mel), self.device), **kw)
    launches, wavs, report = {}, {}, {}
    n_frames = (OTHER_SAMPLES + audio["win_size"] - hop - audio["win_size"]) // hop + 1
    try:
        cli("hifigan_v2", {}, "hifigan", tones["short"], "cuda")  # warm-up: mel, ACF, allocator
        for name, _, kind, cell_hp, mode, n_res, n_c8 in OTHER_CELLS:
            policy.set_precision(mode)
            try:
                want = {"resblock_stage_bf16" if mode == "fast" else "resblock_stage": n_res,
                        "resblock_stage_c8_bf16" if mode == "fast" else "resblock_stage_c8": n_c8}
                reset_counts()
                wav, wall_ms, busy, sums = cli(name, cell_hp, kind, tones["full"], "cuda",
                                               profiled=True)
                launches[name] = check_counts(f"vocode wav2wav {name} ({mode})", want)
                if wav.shape != (n_frames * hop,):
                    raise AssertionError(f"{name}: wav {wav.shape}, want ({n_frames * hop},)")
                wavs[name] = wav.astype(np.float64) / 32767
                report[name] = {"host_ms": wall_ms, "rtf": wall_ms / 1e3 / (OTHER_SAMPLES / sr),
                                "kernel_ms": busy,
                                "idle_share": max(0.0, 1 - busy / wall_ms) if busy else None,
                                "by_group_ms": {g: round(v, 3) for g, v in sums.items()}}
                log(f"vocode wav2wav {name} ({mode}): {OTHER_SAMPLES} samples in, {n_frames} "
                    f"frames, peak {np.abs(wav).max()} of 32767; under torch.profiler "
                    f"{wall_ms:.3f} ms on the host clock (RTF {report[name]['rtf']:.5f}), kernel "
                    f"{busy:.3f} ms, device idle share "
                    f"{report[name]['idle_share'] if busy else 'not measured'}; by group (ms): "
                    + json.dumps(report[name]["by_group_ms"]))
                if mode == "parity":
                    card, *_ = cli(name, cell_hp, kind, tones["short"], "cuda")
                    cpu, cpu_ms, *_ = cli(name, cell_hp, kind, tones["short"], "cpu")
                    err = float(np.abs(card.astype(np.float64) - cpu).max())
                    peak = float(np.abs(cpu.astype(np.float64)).max())
                    log(f"vocode wav2wav {name}: card vs CPU written wav {list(cpu.shape)} "
                        f"max_abs_err {err:.0f} (int16 steps), peak {peak:.0f}, tol {CPU_TOL} x "
                        f"peak; the CPU run {cpu_ms:.3f} ms")
                    if not (0 < peak < 32767 and err <= CPU_TOL * peak):
                        raise AssertionError(f"{name}: the card's wav disagrees with the CPU's")
                else:
                    report[name].update(hold_wav(f"vocode wav2wav {name} vs parity", wavs[name],
                                                 wavs[name.replace("_fast", "")]))
            finally:
                policy.set_precision("parity")
    finally:
        HifiGAN.spec2wav, PWG.spec2wav = hifigan_render, pwg_render
        shutil.rmtree(tmp, ignore_errors=True)
    log("other vocoders: " + json.dumps(report))
    return kern, launches


# The multi-GPU phase: the training path's data and model axes on the one
# card, two ranks over gloo (NCCL refuses two ranks on one device), then
# NCCL, the default backend on the card, as a world of one
MG_ITEMS, MG_STEPS, MG_TP_STEPS = 48, 3, 2  # three global batches of B=16, T=1536
MG_JOIN_S = 300  # a rank that has not finished by then fails the phase
MG_STEP_RTOL, MG_PARAM_TOL, MG_NCCL_RTOL = 1e-5, 1e-4, 1e-6
# the tensor-parallel step against the one-process plain route (another
# summation order): step 1's and 2's total loss and gradient norm, relative,
# and each tensor's two-step update ||tp - one|| / ||one||, so a run that
# left a tensor unchanged reads 1
MG_TP_RTOL, MG_UPDATE_TOL = 1e-4, 1e-3
# (e): MG_TP_STEPS steps of each layout with the training cell's dropout (the
# base config's rate), held to part (b)'s bounds against the one-process steps
MG_DROPOUT = 0.1


def seed_output_projection(model, torch) -> None:
    """The denoiser's zero-initialised output projection drawn from a seeded
    normal (std 0.02), so the first step's gradients reach every layer."""
    p = dict(model.named_parameters())["diffusion.denoise_fn.output_projection.weight"]
    with torch.no_grad():
        p.copy_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(SEED)))


def multi_gpu_hparams(data_dir: str, work_dir: str, config: dict, **kw) -> dict:
    """``config`` (the training cell's), dropout off unless ``kw`` names a
    rate (parts (a)-(c) hold the steps to the one-process step with dropout
    off, as before; part (e) with the cell's rate)."""
    from prodiff_tpu_torch.utils.synthetic import small_hparams

    return small_hparams(data_dir, **{**config, "dropout": 0.0, "work_dir": work_dir,
                                      "num_sanity_val_steps": 0, **kw})


def recording_dropout(torch, dev):
    """A patch of ``Dropout.keep`` that keeps every mask drawn under it (on
    the device, with whether its module splits its columns over the model
    axis) and CUDA events around each draw (none off the card); and what it
    records."""
    from unittest import mock

    from prodiff_tpu_torch.models.common import Dropout

    rec = {"masks": [], "events": []}
    keep = Dropout.keep

    def recorded(self, shape, device):
        if dev.type != "cuda":
            mask = keep(self, shape, device)
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mask = keep(self, shape, device)
            end.record()
            rec["events"].append((start, end))
        rec["masks"].append((self.tp is not None, mask))
        return mask

    return rec, mock.patch.object(Dropout, "keep", recorded)


def dropout_record(rec, torch, n_data: int = 1) -> dict:
    """What :func:`recording_dropout` kept since the last call (one step),
    after a synchronisation, then forgotten: the draws' summed time (ms,
    CUDA events; 0.0 off the card), the masks on the host, the elements
    kept and those drawn at the global shape (``n_data`` times the rows,
    twice the columns of a mask split over the two model ranks)."""
    if rec["events"]:
        torch.cuda.synchronize()
    out = {"draw_ms": sum(a.elapsed_time(b) for a, b in rec["events"]),
           "masks": [(tp, m.cpu()) for tp, m in rec["masks"]],
           "kept_elements": sum(m.numel() for _, m in rec["masks"]),
           "drawn_elements": n_data * sum(m.numel() * (2 if tp else 1) for tp, m in rec["masks"])}
    rec["masks"].clear()
    rec["events"].clear()
    return out


def multi_gpu_rank(rank: int, world: int, port: int, parts: tuple, data_dir: str,
                   out_dir: str, device: str, config: dict) -> None:
    """One rank of each of ``parts`` in turn on ``device``; writes its
    results under ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from prodiff_tpu_torch.parallel.mesh import AGENT_STORE_ENV

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)  # as the one-process runs
    # gloo, named: NCCL refuses two ranks on one device, and this card is one;
    # every rank a client of the store the launcher holds on ``port``
    os.environ[AGENT_STORE_ENV] = "True"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=MG_JOIN_S))
    try:
        for part in parts:
            multi_gpu_part(rank, part, data_dir, out_dir, dev, config)
    finally:
        dist.destroy_process_group()


def multi_gpu_part(rank: int, part: str, data_dir: str, out_dir: str, dev, config: dict) -> None:
    """Part ``dp`` (data parallel: MG_STEPS steps, a validation batch, a
    checkpoint) or ``tp`` (``model_parallel: 2``: a forward on seeded draws,
    MG_TP_STEPS steps, a checkpoint) of one rank, the denoiser's output
    projection seeded; ``dp_dropout`` / ``tp_dropout`` (MG_TP_STEPS steps of
    each layout with the cell's dropout, its masks and each step's draws'
    time kept); or ``sp`` (:func:`multi_gpu_sp`)."""
    import contextlib

    import torch

    if part == "sp":
        return multi_gpu_sp(rank, out_dir, dev, torch)
    from prodiff_tpu_torch.parallel.megatron import gather_state_dict
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    layout, _, dropout = part.partition("_")
    hp = multi_gpu_hparams(data_dir, os.path.join(out_dir, f"work_{part}"), config,
                           model_parallel=2 if layout == "tp" else 1,
                           **({"dropout": MG_DROPOUT} if dropout else {}))
    trainer = Trainer(hp, device=dev)
    task = get_task_cls("svs")(hp)
    trainer.build(task)
    seed_output_projection(trainer.model, torch)
    trainer.replicate()
    batches = trainer._prefetcher(task.train_iterator(trainer.n_devices,
                                                      local_block=trainer._local_block()))
    res = {"rank": rank, "rows": [], "step_ms": [], "metrics": []}
    out = {}
    if part == "tp":
        whole = trainer._prefetcher(task.train_iterator(trainer.n_devices))
        _, first = next(iter(whole))
        whole.close()
        out["forward"] = multi_gpu_forward(trainer, first, torch).cpu()
    rec, patch = recording_dropout(torch, dev)
    masks = []
    n_steps = MG_STEPS if part == "dp" else MG_TP_STEPS
    reset_counts()
    for _, (_, batch) in zip(range(n_steps), batches):
        res["rows"].append(list(batch["_local_rows"]))
        with patch if dropout else contextlib.nullcontext():
            ms, metrics = event_timed(lambda: trainer.train_step(batch), dev, torch)
        if dropout:
            drawn = dropout_record(rec, torch, trainer.mesh.n_data)
            masks += drawn.pop("masks")
            for k, v in drawn.items():
                res.setdefault(k, []).append(v)
        if trainer.global_step == 0:  # step 1's gradients, slices gathered
            grads = {n: p.grad for n, p in trainer.model.named_parameters()}
            if trainer.tp_kinds:
                grads = gather_state_dict(grads, trainer.tp_kinds, trainer.mesh.tp)
            out["grads1"] = {n: g.detach().cpu() for n, g in grads.items()}
        trainer.global_step += 1
        res["step_ms"].append(ms)
        res["metrics"].append({k: float(v) for k, v in metrics.items()})
    batches.close()
    res["train_launches"] = {k: c.count for k, c in counters().items() if c.count}
    if part == "dp":
        reset_counts()
        res["val_losses"] = {k: float(v) for k, v in trainer.val_step(batch).items()}
        res["val_launches"] = {k: c.count for k, c in counters().items() if c.count}
    if dropout:
        torch.save(masks, os.path.join(out_dir, f"{part}_masks_rank{rank}.pt"))
    tree = trainer.params_tree()  # every rank of the model axis gathers
    if rank == 0:
        out["params"] = task.state_dict_of(tree)
    res["checkpoint"] = None if dropout else trainer.save_checkpoint()
    res["shapes"] = {n: list(p.shape) for n, p in trainer.model.named_parameters()}
    if rank == 0:
        torch.save(out, os.path.join(out_dir, f"{part}_tensors.pt"))
    with open(os.path.join(out_dir, f"{part}_rank{rank}.json"), "w") as f:
        json.dump(res, f)


# (d) sequence parallelism: the forward at one long segment, even and
# uneven over the two ranks, and the gradients at B=2
MG_SP_T, MG_SP_T_ODD, MG_SP_GRAD_B, MG_SP_GRAD_T = 8192, 8191, 2, 2048
MG_SP_TOL, MG_SP_REPS = 1e-4, 5


def sp_wavenet(dev, torch, sp=None):
    """The base config's denoiser (``prodiff_tpu_torch/assets/base_config.yaml``:
    128 mel bins, hidden 256, 20 layers x 256 channels, cycle 1) on weights
    seeded from SEED, its zero-initialised output projection drawn from a
    seeded normal (std 0.02) so every layer reaches the output."""
    from prodiff_tpu_torch.config import load_base_config
    from prodiff_tpu_torch.models.wavenet import WaveNet

    hp = load_base_config()
    torch.manual_seed(SEED)
    net = WaveNet(hp["audio_num_mel_bins"], hp["hidden_size"], hp["residual_layers"],
                  hp["residual_channels"], hp["dilation_cycle_length"], sp=sp)
    w = net.output_projection.weight
    with torch.no_grad():
        w.copy_(0.02 * torch.randn(w.shape, generator=torch.Generator().manual_seed(SEED)))
    return net.to(dev)


def sp_inputs(b: int, t: int, net, torch):
    """Seeded host inputs of one segment: spec [b, t, 128], the steps [b],
    cond [b, t, 256] and the probe of ``sum(out * probe)``."""
    gen = torch.Generator().manual_seed(SEED + t)
    in_dims = net.input_projection.in_channels
    hidden = net.residual_layers[0].conditioner_projection.in_channels
    return (torch.randn(b, t, in_dims, generator=gen), torch.randint(0, 4, (b,), generator=gen),
            torch.randn(b, t, hidden, generator=gen), torch.randn(b, t, in_dims, generator=gen))


def multi_gpu_sp(rank: int, out_dir: str, dev, torch) -> None:
    """Part ``sp`` of one rank: the sequence-parallel denoiser's forward at
    T=MG_SP_T and MG_SP_T_ODD (B=1) and its gradients at MG_SP_GRAD_B x
    MG_SP_GRAD_T, each with the rank's launches counted around it alone;
    then the halo exchange and K1 on the rank's window timed. Rank 0 writes
    the gathered outputs and gradients."""
    import torch.nn.functional as F

    from prodiff_tpu_torch.models.wavenet import conv1x1
    from prodiff_tpu_torch.ops.wavenet_stack import residual_stack, stack_launches
    from prodiff_tpu_torch.ops.wavenet_train import train_launches
    from prodiff_tpu_torch.parallel.halo import (
        gather_frames, gather_window, halo_width, split_frames, window_of)
    from prodiff_tpu_torch.parallel.mesh import create_mesh, sum_model_gradients

    mesh = create_mesh(model_parallel=2, device=dev)
    sp = mesh.sp
    net = sp_wavenet(dev, torch, sp)
    n_layers, c = len(net.residual_layers), net.residual_layers[0].dilated_conv.in_channels
    h = halo_width(n_layers, net.dilation_cycle_length)
    res, out = {"rank": rank, "halo": h, "forward": {}}, {}
    for t in (MG_SP_T, MG_SP_T_ODD):
        spec, steps, cond, _ = sp_inputs(1, t, net, torch)
        xs, cs, steps = split_frames(spec, sp).to(dev), split_frames(cond, sp).to(dev), steps.to(dev)
        win = window_of(xs.shape[1], sp, h, dev)
        with torch.no_grad():
            reset_counts()
            y = net(xs, steps, cs)
            torch.cuda.synchronize(dev)
            launches = {k: v.count for k, v in counters().items() if v.count}
            out[f"forward_{t}"] = gather_frames(y, sp).cpu()
            # the parts, timed on this rank's window (both ranks in step)
            exchange_ms = timed_ms(lambda: gather_window(win, sp, [xs, cs]), MG_SP_REPS, torch)
            spec_w, cond_w = gather_window(win, sp, [xs, cs])
            x0 = F.relu(conv1x1(spec_w, net.input_projection))
            step = net.mlp(net.diffusion_embedding(steps))
            w = net.stacked_weights()
            k1_ms = timed_ms(lambda: residual_stack(x0, cond_w, step, w), MG_SP_REPS, torch)
            forward_ms = timed_ms(lambda: net(xs, steps, cs), MG_SP_REPS, torch)
        res["forward"][str(t)] = dict(
            block=list(win.block), window=list(win.span), launches=launches,
            want={"residual_stack": stack_launches(1, win.span[1] - win.span[0], c, n_layers)},
            exchange_ms=exchange_ms, k1_ms=k1_ms, forward_ms=forward_ms)
    spec, steps, cond, probe = sp_inputs(MG_SP_GRAD_B, MG_SP_GRAD_T, net, torch)
    xs = split_frames(spec, sp).to(dev).requires_grad_()
    cs = split_frames(cond, sp).to(dev).requires_grad_()
    win = window_of(xs.shape[1], sp, h, dev)
    reset_counts()
    y = net(xs, steps.to(dev), cs)
    (y * split_frames(probe, sp).to(dev)).sum().backward()
    torch.cuda.synchronize(dev)
    launches = {k: v.count for k, v in counters().items() if v.count}
    save, chain = train_launches(MG_SP_GRAD_B, win.span[1] - win.span[0], c, n_layers)
    res["grad"] = dict(block=list(win.block), window=list(win.span), launches=launches,
                       want={"residual_stack_save": save, "residual_stack_chain": chain})
    sum_model_gradients(list(net.parameters()), mesh)
    out["grads"] = {n: p.grad.cpu() for n, p in net.named_parameters()}
    out["spec_grad"], out["cond_grad"] = (gather_frames(g, sp).cpu() for g in (xs.grad, cs.grad))
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "sp_tensors.pt"))
    with open(os.path.join(out_dir, f"sp_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def multi_gpu_sp_check(ranks: list, tmp: str, dev, torch) -> dict:
    """(d): the ranks' gathered forwards against the one-process K1 forward
    and its plain twin on the card, their gradients against the one-process
    K5 route's, each rank's launches against the counts of its window."""
    from unittest import mock

    from prodiff_tpu_torch.models import wavenet

    got = torch.load(os.path.join(tmp, "sp_tensors.pt"), weights_only=False)
    net = sp_wavenet(dev, torch)
    report = {"forward_err": {}, "plain_err": {}}
    for t in (MG_SP_T, MG_SP_T_ODD):
        spec, steps, cond, _ = sp_inputs(1, t, net, torch)
        args = (spec.to(dev), steps.to(dev), cond.to(dev))
        with torch.no_grad():
            k1 = net(*args).cpu()
            with mock.patch.object(wavenet, "on_kernels", lambda x, cycle: False):
                plain = net(*args).cpu()
        sharded = got[f"forward_{t}"]
        for key, want in (("forward_err", k1), ("plain_err", plain)):
            err = peak_err(sharded, want)
            if not err <= MG_SP_TOL:
                raise AssertionError(f"sp forward at T={t} vs the one-process "
                                     f"{'K1' if key == 'forward_err' else 'plain'} forward: "
                                     f"{err:.3e} x its peak, beyond {MG_SP_TOL}")
            report[key][str(t)] = err
    spec, steps, cond, probe = sp_inputs(MG_SP_GRAD_B, MG_SP_GRAD_T, net, torch)
    spec, cond = spec.to(dev).requires_grad_(), cond.to(dev).requires_grad_()
    (net(spec, steps.to(dev), cond) * probe.to(dev)).sum().backward()
    want = {n: p.grad.cpu() for n, p in net.named_parameters()}
    want.update(spec_grad=spec.grad.cpu(), cond_grad=cond.grad.cpu())
    report["grad_err"] = params_vs("sp gradients (params summed over the ranks, spec and cond "
                                   "gathered) vs the one-process K5 route",
                                   {**got["grads"], "spec_grad": got["spec_grad"],
                                    "cond_grad": got["cond_grad"]}, want, MG_SP_TOL)
    for r in ranks:
        for what, run in [(f"forward T={t}", r["forward"][t]) for t in r["forward"]] + [
                ("gradient", r["grad"])]:
            if run["launches"] != run["want"]:
                raise AssertionError(f"sp rank {r['rank']} {what}: launched {run['launches']}, "
                                     f"its window {run['window']} counts {run['want']}")
    report["launches"] = {str(r["rank"]): {"forward": {t: v["launches"] for t, v in
                                                       r["forward"].items()},
                                           "gradient": r["grad"]["launches"]} for r in ranks}
    return report


def event_timed(fn, dev, torch):
    """(milliseconds by CUDA events, ``fn()``): one call on the card, timed
    between two synchronisations (0.0 off the card)."""
    if dev.type != "cuda":
        return 0.0, fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def multi_gpu_forward(trainer, batch, torch):
    """The teacher's training forward (x0 prediction) in eval mode on the
    batch's seeded draws: t and noise from the generator seeded for step 0."""
    from prodiff_tpu_torch.parallel.mesh import batch_rows

    batch = dict(batch)
    rows = batch.pop("_local_rows", None)
    args, kwargs = trainer.task.model_inputs(batch)
    trainer.model.eval()
    with torch.no_grad(), batch_rows(rows):
        pred, _ = trainer.model(*args, gt_spec=batch["mel"], generator=trainer._seeded(0), **kwargs)
    return pred


def spawn_ranks(parts: tuple, data_dir: str, out_dir: str, dev, config: dict) -> dict:
    """Two spawned ranks that run ``parts`` in turn, joined within
    MG_JOIN_S, clients of the store this process holds (``rendezvous``); a
    rank that fails or hangs fails the phase. Returns each part's results,
    rank by rank."""
    import torch.multiprocessing as mp

    from prodiff_tpu_torch.parallel.mesh import rendezvous

    t0 = time.time()
    with rendezvous() as port:
        ctx = mp.start_processes(multi_gpu_rank, nprocs=2, join=False, start_method="spawn",
                                 args=(2, port, parts, data_dir, out_dir, str(dev), config))
        try:
            while not ctx.join(timeout=5):
                if time.time() - t0 > MG_JOIN_S:
                    raise AssertionError(f"multi_gpu: the ranks did not finish in {MG_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    log(f"multi_gpu {' + '.join(parts)}: two ranks (spawned, gloo, both on {dev}) ran in "
        f"{time.time() - t0:.3f} s with start-up")
    return {part: [json.load(open(os.path.join(out_dir, f"{part}_rank{r}.json")))
                   for r in range(2)] for part in parts}


def share(part: float, whole: float) -> str:
    """``part / whole`` as a percentage; "not measured" off the card (0 ms)."""
    return f"{part / whole:.4%}" if whole else "not measured"


def peak_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def params_vs(label: str, got: dict, want: dict, tol: float) -> float:
    """Every tensor of ``got`` within ``tol`` of ``want``'s peak; logs the
    three worst and returns the worst."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: the parameter names differ")
    errs = sorted(((peak_err(got[n].cpu(), want[n].cpu()), n, float(want[n].abs().max()))
                   for n in want), reverse=True)
    log(f"{label}: the worst tensors (error / its peak, peak): " + "; ".join(
        f"{n} {e:.3e}, {p:.3e}" for e, n, p in errs[:3]))
    if not errs[0][0] <= tol:
        raise AssertionError(f"{label}: {errs[0][0]:.3e} x a tensor's peak, beyond {tol}")
    return errs[0][0]


def updates_vs(label: str, got: dict, want: dict, before: dict, tol: float) -> float:
    """Each tensor's update from ``before`` in ``got`` against ``want``'s:
    ||(got - before) - (want - before)|| within ``tol`` x ||want - before||
    (a run that left a tensor unchanged reads 1); logs the three worst and
    returns the worst."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: the parameter names differ")
    errs = []
    for n in want:
        moved = want[n].cpu() - before[n].cpu()
        off = float((got[n].cpu() - before[n].cpu() - moved).norm())
        size = float(moved.norm())
        errs.append((off / size if size else (0.0 if off == 0 else math.inf), n, size))
    errs.sort(reverse=True)
    log(f"{label}: the worst tensors (||update error|| / ||update||, ||update||): " + "; ".join(
        f"{n} {e:.3e}, {m:.3e}" for e, n, m in errs[:3]))
    if not errs[0][0] <= tol:
        raise AssertionError(f"{label}: {errs[0][0]:.3e} of a tensor's update, beyond {tol}")
    return errs[0][0]


def multi_gpu_launches(dp: list, tp: list, n_steps: int = MG_STEPS) -> dict:
    """Each rank's launches: K5a/K5b on every one of the ``n_steps``
    data-parallel steps, K1 in its validation batch where it ran one; none
    on the tensor-parallel route."""
    per_step = {"residual_stack_save": 41, "residual_stack_chain": 40}
    for r in dp:
        if r["train_launches"] != {k: n_steps * v for k, v in per_step.items()}:
            raise AssertionError(f"dp rank {r['rank']}: K5 launched {r['train_launches']}")
        if "val_launches" in r and r["val_launches"] != {"residual_stack": K1_LAUNCHES}:
            raise AssertionError(f"dp rank {r['rank']}: validation launched {r['val_launches']}")
    for r in tp:
        if r["train_launches"]:
            raise AssertionError(f"tp rank {r['rank']} launched {r['train_launches']}: the "
                                 "tensor-parallel route runs no kernel")
    return per_step


def phase_multi_gpu(dev, torch, config=None):
    """Data and tensor parallelism on the one card (two ranks over gloo),
    held against the one-process trainer on the same batches, and NCCL as a
    world of one. ``config``: the training cell's hparams (TRAIN_HPARAMS)."""
    import shutil
    import tempfile

    from unittest import mock

    from prodiff_tpu_torch.models import wavenet
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer
    from prodiff_tpu_torch.utils import ckpt_utils
    from prodiff_tpu_torch.utils.synthetic import make_svs_dataset

    tmp = tempfile.mkdtemp(prefix="prodiff_torch_multi_gpu_")
    data_dir = os.path.join(tmp, "data")
    # every run of the phase (the ranks' and the one-process ones) under
    # deterministic algorithms: the embeddings' gather-backward atomics left
    # 2.6e-5 of a peak between two identical runs after 3 steps (PERF.md §7)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        make_svs_dataset(data_dir, n_train=MG_ITEMS, n_valid=TRAIN_N_VALID, n_mels=128, seed=7,
                         t_ph_range=(32, 33), dur_range=(45, 49))
        config = TRAIN_HPARAMS if config is None else config
        ranks = spawn_ranks(("dp", "tp", "sp", "dp_dropout", "tp_dropout"), data_dir, tmp, dev,
                            config)
        dp, tp, sp = ranks["dp"], ranks["tp"], ranks["sp"]
        dp_t = torch.load(os.path.join(tmp, "dp_tensors.pt"), weights_only=False)
        tp_t = torch.load(os.path.join(tmp, "tp_tensors.pt"), weights_only=False)

        # the one-process trainer on the same card and global batches
        hp = multi_gpu_hparams(data_dir, os.path.join(tmp, "work_one"), config)
        one = Trainer(hp, device=dev)
        task = get_task_cls("svs")(hp)
        one.build(task)
        seed_output_projection(one.model, torch)
        batches = [b for _, (_, b) in zip(range(MG_STEPS), one._prefetcher(task.train_iterator(2)))]
        forward = multi_gpu_forward(one, batches[0], torch)
        one_metrics = []
        snapshots = {0: {k: v.detach().cpu().clone() for k, v in one.model.state_dict().items()}}
        for i, batch in enumerate(batches):
            one_metrics.append({k: float(v) for k, v in one.train_step(batch).items()})
            if i == 0:
                grads1 = {n: p.grad.detach().cpu() for n, p in one.model.named_parameters()}
            one.global_step += 1
            snapshots[one.global_step] = {k: v.detach().cpu().clone()
                                          for k, v in one.model.state_dict().items()}
        one_ckpt = ckpt_utils.load_checkpoint_file(one.save_checkpoint())
        shape = tuple(batches[0]["mel"].shape)
        # the tensor-parallel route runs no kernel: its steps are held against
        # the one-process steps on the plain route (the module loop, no K5)
        plain = Trainer(dict(hp, work_dir=os.path.join(tmp, "work_plain")), device=dev)
        plain.build(get_task_cls("svs")(plain.hparams))
        seed_output_projection(plain.model, torch)
        plain_metrics = []
        with mock.patch.object(wavenet, "on_kernels", lambda x, cycle: False):
            for batch in batches[:MG_TP_STEPS]:
                plain_metrics.append({k: float(v) for k, v in plain.train_step(batch).items()})
                if plain.global_step == 0:
                    grads1_plain = {n: p.grad.detach().cpu()
                                    for n, p in plain.model.named_parameters()}
                plain.global_step += 1
        plain_after = {k: v.detach().cpu() for k, v in plain.model.state_dict().items()}
        del plain

        # (a) data parallel
        want = one_metrics[0]
        for r in dp:
            if r["rows"] != [[8 * r["rank"], 16]] * MG_STEPS:
                raise AssertionError(f"dp rank {r['rank']} took rows {r['rows']}")
            for key in ("total_loss", "grad_norm"):
                err = abs(r["metrics"][0][key] - want[key]) / abs(want[key])
                if not err <= MG_STEP_RTOL:
                    raise AssertionError(f"dp step 1 {key}: {err:.3e} relative, beyond {MG_STEP_RTOL}")
        dp_grad = params_vs("dp step-1 gradients", dp_t["grads1"], grads1, MG_PARAM_TOL)
        dp_worst = params_vs("dp params after 3 steps", dp_t["params"], snapshots[MG_STEPS],
                             MG_PARAM_TOL)
        dp_update = updates_vs("dp updates after 3 steps", dp_t["params"], snapshots[MG_STEPS],
                               snapshots[0], MG_UPDATE_TOL)
        per_step = multi_gpu_launches(dp, tp)
        log(f"multi_gpu (a) data parallel, 2 ranks x 8 rows of global B=16 x T={shape[1]} on "
            f"{dev} over gloo: step 1 total loss {dp[0]['metrics'][0]['total_loss']:.7f} vs one "
            f"process {want['total_loss']:.7f}, grad norm {dp[0]['metrics'][0]['grad_norm']:.7f} "
            f"vs {want['grad_norm']:.7f} (within {MG_STEP_RTOL} relative); its gradients max "
            f"{dp_grad:.3e} x a tensor's peak; params after "
            f"{MG_STEPS} steps: max {dp_worst:.3e} x a tensor's peak (tolerance {MG_PARAM_TOL}), "
            f"their updates max {dp_update:.3e} of their own (tolerance {MG_UPDATE_TOL}); "
            f"per rank K5a {per_step['residual_stack_save']} + K5b "
            f"{per_step['residual_stack_chain']} launches a step, K1 {K1_LAUNCHES} for one "
            f"validation batch")
        restored = Trainer(dict(hp, work_dir=os.path.join(tmp, "work_dp")), device=dev)
        restored.build(get_task_cls("svs")(restored.hparams))
        if not restored.restore_checkpoint() or restored.global_step != MG_STEPS:
            raise AssertionError("the one-process trainer did not restore the dp checkpoint")
        sd = restored.model.state_dict()
        if not all(torch.equal(sd[n].cpu(), dp_t["params"][n].cpu()) for n in sd):
            raise AssertionError("the restored dp checkpoint differs from rank 0's params")
        log(f"multi_gpu (a): the dp checkpoint (rank 0's) restored in the one-process trainer at "
            f"step {restored.global_step}, {len(sd)} tensors equal to rank 0's")
        del restored, sd

        # (b) tensor parallel
        fwd = peak_err(tp_t["forward"], forward.cpu())
        if not fwd <= MG_PARAM_TOL:
            raise AssertionError(f"tp forward: {fwd:.3e} x its peak, beyond {MG_PARAM_TOL}")
        # the ranks' matmuls and split sums against the module loop's convs: a
        # different summation order end to end, held as the card's step is
        # held against the CPU's (STEP_TOL)
        tp_grad = params_vs("tp step-1 gradients (gathered) vs the plain route's",
                            tp_t["grads1"], grads1_plain, STEP_TOL)
        k5_vs_plain = max(peak_err(grads1[n], grads1_plain[n]) for n in grads1)
        tp_vs_k5 = max(peak_err(tp_t["grads1"][n], grads1[n]) for n in grads1)
        log(f"multi_gpu (b): step 1's gradients, the one-process K5 route vs its plain route "
            f"{k5_vs_plain:.3e}, the tensor-parallel ranks vs the K5 route {tp_vs_k5:.3e} of a "
            f"tensor's peak (K5 is held to its twin at {GRAD_TOL})")
        tp_metric_err = 0.0
        for r in tp:
            for i, want_i in enumerate(plain_metrics):
                for key in ("total_loss", "grad_norm"):
                    err = abs(r["metrics"][i][key] - want_i[key]) / abs(want_i[key])
                    if not err <= MG_TP_RTOL:
                        raise AssertionError(f"tp step {i + 1} {key} on rank {r['rank']}: "
                                             f"{err:.3e} relative, beyond {MG_TP_RTOL}")
                    tp_metric_err = max(tp_metric_err, err)
        tp_worst = updates_vs("tp updates after 2 steps vs the plain route's", tp_t["params"],
                              plain_after, snapshots[0], MG_UPDATE_TOL)
        half = tp[0]["shapes"]["diffusion.denoise_fn.residual_layers.0.dilated_conv.weight"]
        tp_ckpt = ckpt_utils.load_checkpoint_file(os.path.join(tmp, "work_tp",
                                                               f"model_ckpt_steps_{MG_TP_STEPS}.ckpt"))
        flat = dict(tree_leaves(tp_ckpt["state_dict"]))
        one_flat = dict(tree_leaves(ckpt_utils.load_checkpoint_file(
            os.path.join(tmp, "work_one", f"model_ckpt_steps_{MG_STEPS}.ckpt"))["state_dict"]))
        if {k: v.shape for k, v in flat.items()} != {k: v.shape for k, v in one_flat.items()}:
            raise AssertionError("the tp checkpoint's layout differs from the one-process one")
        opt_keys = {k for k, _ in tree_leaves(tp_ckpt["optimizer_state"])}
        if opt_keys != {k for k, _ in tree_leaves(one_ckpt["optimizer_state"])}:
            raise AssertionError("the tp checkpoint's optimizer state differs in layout")
        log(f"multi_gpu (b) model_parallel 2 on 2 ranks (denoiser {half[0] // 2} channels a rank, "
            f"one attention head a rank): the forward's x0 prediction within {fwd:.3e} of its "
            f"peak, step 1's gathered gradients max {tp_grad:.3e} x a tensor's peak of the "
            f"one-process plain route's (tolerance {STEP_TOL}); steps 1-{MG_TP_STEPS}: total "
            f"loss {tp[0]['metrics'][0]['total_loss']:.7f} vs {plain_metrics[0]['total_loss']:.7f}"
            f", grad norm {tp[0]['metrics'][0]['grad_norm']:.7f} vs "
            f"{plain_metrics[0]['grad_norm']:.7f} at step 1, max {tp_metric_err:.3e} relative "
            f"(tolerance {MG_TP_RTOL}); each tensor's update after {MG_TP_STEPS} steps within "
            f"{tp_worst:.3e} of the plain route's (tolerance {MG_UPDATE_TOL}); the gathered "
            f"checkpoint holds the one-process layout "
            f"key for key ({len(flat)} weights, {len(opt_keys)} optimizer leaves); no kernel "
            f"launched (the tensor-parallel route is torch.matmul, as the JAX TP route runs no "
            f"Pallas kernel)")

        # (c) NCCL, the default backend on the card, as a world of one
        multi_gpu_nccl(hp, tmp, batches[0], one_metrics[0], snapshots[1], dev, torch)

        # (d) sequence parallelism of the denoiser
        del one
        sp_report = multi_gpu_sp_check(sp, tmp, dev, torch)
        log(f"multi_gpu (d) sequence parallel, the base config's denoiser on 2 ranks (halo "
            f"{sp[0]['halo']} frames a side): the gathered forward vs the one-process K1 forward "
            + ", ".join(f"T={t} {e:.3e}" for t, e in sp_report["forward_err"].items())
            + " and vs its plain twin " + ", ".join(f"T={t} {e:.3e}" for t, e in
                                                   sp_report["plain_err"].items())
            + f" of the output's peak; B={MG_SP_GRAD_B}, T={MG_SP_GRAD_T}: the gradients within "
            f"{sp_report['grad_err']:.3e} of each tensor's peak of the one-process K5 route "
            f"(tolerance {MG_SP_TOL}); launches per rank " + json.dumps(sp_report["launches"]))

        # (e) dropout on: two steps of each layout against the one-process steps
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        drop = multi_gpu_dropout(ranks, hp, batches, snapshots[0], tmp, dev, torch)
        for layout, d in drop.items():
            log(f"multi_gpu (e) {'data parallel' if layout == 'dp' else 'model_parallel 2'} with "
                f"dropout {MG_DROPOUT}, {MG_TP_STEPS} steps on global B=16 x T={shape[1]}: all "
                f"{d['masks']} masks of each rank its part of the one-process steps', exactly "
                f"({d['split_masks']} split over the model axis); step 1 total loss "
                f"{d['loss'][0]:.7f} vs {d['loss'][1]:.7f}, grad norm {d['grad_norm'][0]:.7f} vs "
                f"{d['grad_norm'][1]:.7f}, max {d['metric_err']:.3e} relative over the steps "
                f"(tolerance {MG_TP_RTOL}); step 1's gradients within {d['grad_err']:.3e} of each "
                f"tensor's peak (tolerance {STEP_TOL}), each tensor's update within "
                f"{d['update_err']:.3e} of its own (tolerance {MG_UPDATE_TOL}) of the one-process "
                f"{d['route']} steps'")
            for r in d["ranks"]:
                log(f"multi_gpu (e) {layout} rank {r['rank']}: steps " + ", ".join(
                    f"{ms:.3f} ms (draws {dm:.4f} ms, {share(dm, ms)})"
                    for ms, dm in zip(r["step_ms"], r["draw_ms"]))
                    + f"; {r['drawn_elements'][0]:,} numbers drawn a step for "
                    f"{r['kept_elements'][0]:,} kept; CUDA events, two ranks sharing one card "
                    f"({smi}; not a scaling figure)")
            log(f"multi_gpu (e) {layout} one process ({d['route']} route): steps " + ", ".join(
                f"{st['ms']:.3f} ms (draws {st['draw_ms']:.4f} ms, {share(st['draw_ms'], st['ms'])})"
                for st in d["one"]) + f"; {d['one'][0]['kept_elements']:,} numbers a step; CUDA "
                f"events ({smi})")
        for part, ranks in (("dp", dp), ("tp", tp)):
            log(f"multi_gpu {part}: step times by CUDA events, two ranks sharing one card ({smi}; "
                "not a scaling figure): " + "; ".join(
                    f"rank {r['rank']} " + ", ".join(f"{ms:.3f}" for ms in r["step_ms"]) + " ms"
                    for r in ranks))
        for r in sp:
            for t, run in r["forward"].items():
                log(f"multi_gpu sp rank {r['rank']} T={t}: block {run['block']}, window "
                    f"{run['window']}; halo exchange (gloo, staged through the host) "
                    f"{run['exchange_ms']:.4f} ms, K1 on the window {run['k1_ms']:.4f} ms, the "
                    f"rank's whole forward {run['forward_ms']:.4f} ms, CUDA events, mean of "
                    f"{MG_SP_REPS} (two ranks sharing one card, {smi}; not a scaling figure)")
            log(f"multi_gpu sp rank {r['rank']} gradient B={MG_SP_GRAD_B} T={MG_SP_GRAD_T}: block "
                f"{r['grad']['block']}, window {r['grad']['window']}")
        return {"k5_per_rank_step": per_step, "k1_per_rank_val_batch": K1_LAUNCHES,
                "sp": sp_report, "sp_ranks": sp,
                "dp_grad_err": dp_grad, "tp_grad_err": tp_grad, "dp_param_err": dp_worst,
                "dp_update_err": dp_update, "tp_update_err": tp_worst,
                "tp_metric_err": tp_metric_err, "tp_forward_err": fwd,
                "dp_step_ms": [r["step_ms"] for r in dp], "tp_step_ms": [r["step_ms"] for r in tp],
                "dropout": drop}
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)


def multi_gpu_dropout(ranks: dict, hp: dict, batches: list, before: dict, tmp: str, dev,
                      torch) -> dict:
    """(e): the ranks' MG_TP_STEPS steps with dropout on (parts
    ``dp_dropout`` and ``tp_dropout``) against the one-process steps on the
    same card and global batches at the same rate: the K5 route for the
    data-parallel ranks, the plain route for the tensor-parallel ones (part
    (b)'s reference). Every mask a rank drew is its rows and, on the FFN's
    split hidden, its columns of the one-process step's, exactly; then part
    (b)'s bounds: each step's total loss and gradient norm within
    MG_TP_RTOL relative, step 1's gradients (reduced, or gathered) within
    STEP_TOL of each tensor's peak, each tensor's update within
    MG_UPDATE_TOL of the one-process update's norm (over two steps, as in
    part (b): step 1 runs at the schedule's floor rate, 1e-7, where Adam's
    first update is about lr * sign(g) and the metric would read the signs
    of gradients near zero)."""
    import contextlib
    from unittest import mock

    from prodiff_tpu_torch.models import wavenet
    from prodiff_tpu_torch.parallel.megatron import TensorParallel
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    per_step = multi_gpu_launches(ranks["dp_dropout"], ranks["tp_dropout"], n_steps=MG_TP_STEPS)
    report = {}
    for layout, route in (("dp", "K5"), ("tp", "plain")):
        part = f"{layout}_dropout"
        one = Trainer(dict(hp, dropout=MG_DROPOUT, work_dir=os.path.join(tmp, f"work_one_{part}")),
                      device=dev)
        one.build(get_task_cls("svs")(one.hparams))
        seed_output_projection(one.model, torch)
        rec, patch = recording_dropout(torch, dev)
        plain = (mock.patch.object(wavenet, "on_kernels", lambda x, cycle: False)
                 if route == "plain" else contextlib.nullcontext())
        steps, masks = [], []
        reset_counts()
        for batch in batches[:MG_TP_STEPS]:
            with patch, plain:
                ms, metrics = event_timed(lambda: one.train_step(batch), dev, torch)
            drawn = dropout_record(rec, torch)
            masks += drawn.pop("masks")
            steps.append(dict(drawn, ms=ms, metrics={k: float(v) for k, v in metrics.items()}))
            if one.global_step == 0:
                grads = {n: p.grad.detach().cpu() for n, p in one.model.named_parameters()}
            one.global_step += 1
        one_launches = {k: c.count for k, c in counters().items() if c.count}
        want_launches = {k: MG_TP_STEPS * v for k, v in per_step.items()} if route == "K5" else {}
        if one_launches != want_launches:
            raise AssertionError(f"the one-process {route} steps with dropout launched {one_launches}")
        after = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
        del one
        got = torch.load(os.path.join(tmp, f"{part}_tensors.pt"), weights_only=False)
        metric_err, split = 0.0, 0
        for r in ranks[part]:
            got_masks = torch.load(os.path.join(tmp, f"{part}_masks_rank{r['rank']}.pt"),
                                   weights_only=False)
            if len(got_masks) != len(masks) or not masks:
                raise AssertionError(f"{part} rank {r['rank']} drew {len(got_masks)} masks, the "
                                     f"one-process steps {len(masks)}")
            row0 = r["rows"][0][0]
            split = 0
            for i, ((tp, mask), (_, want)) in enumerate(zip(got_masks, masks)):
                want = want[row0:row0 + mask.shape[0]]
                if tp:
                    cols = TensorParallel(None, r["rank"], 2).index("out", want.shape[-1])
                    want = want.index_select(-1, cols)
                    split += 1
                if not torch.equal(mask, want):
                    raise AssertionError(f"{part} rank {r['rank']}: mask {i} is not its part of "
                                         "the one-process step's")
            for i, step in enumerate(steps):
                for key in ("total_loss", "grad_norm"):
                    want = step["metrics"][key]
                    err = abs(r["metrics"][i][key] - want) / abs(want)
                    if not err <= MG_TP_RTOL:
                        raise AssertionError(f"{part} step {i + 1} {key} on rank {r['rank']}: "
                                             f"{err:.3e} relative, beyond {MG_TP_RTOL}")
                    metric_err = max(metric_err, err)
        # the FFN hidden of each encoder layer, each step
        if split != (MG_TP_STEPS * hp["enc_layers"] if layout == "tp" else 0):
            raise AssertionError(f"{part}: {split} masks split over the model axis")
        grad_err = params_vs(f"{part} step-1 gradients vs the one-process {route} step's",
                             got["grads1"], grads, STEP_TOL)
        update_err = updates_vs(f"{part} updates after {MG_TP_STEPS} steps vs the one-process "
                                f"{route} steps'", got["params"], after, before, MG_UPDATE_TOL)
        report[layout] = dict(
            masks=len(masks), split_masks=split, metric_err=metric_err, grad_err=grad_err,
            update_err=update_err, route=route,
            loss=[ranks[part][0]["metrics"][0]["total_loss"], steps[0]["metrics"]["total_loss"]],
            grad_norm=[ranks[part][0]["metrics"][0]["grad_norm"],
                       steps[0]["metrics"]["grad_norm"]],
            one=[{k: st[k] for k in ("ms", "draw_ms", "kept_elements")} for st in steps],
            ranks=[{k: r[k] for k in ("rank", "step_ms", "draw_ms", "kept_elements",
                                      "drawn_elements")} for r in ranks[part]])
    return report


def multi_gpu_nccl(hp: dict, tmp: str, batch, want: dict, after: dict, dev, torch) -> None:
    """(c): NCCL, the default backend on the card, as a world of one under
    torchrun's environment: one step on ``batch`` held against the
    one-process step's metrics ``want`` and params ``after``, and an NCCL
    all-reduce of the gradient bucket."""
    import torch.distributed as dist

    from prodiff_tpu_torch.parallel.mesh import AGENT_STORE_ENV, LAUNCHER_ENV, collective, rendezvous
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    before = {k: os.environ.get(k) for k in LAUNCHER_ENV + (AGENT_STORE_ENV,)}
    with rendezvous() as port:
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(port), **{AGENT_STORE_ENV: "True"})
        try:
            solo = Trainer(dict(hp, work_dir=os.path.join(tmp, "work_nccl")))
            if dist.get_backend() != "nccl" or solo.device != dev:
                raise AssertionError(f"the default backend is {dist.get_backend()} on {solo.device}")
            solo.build(get_task_cls("svs")(solo.hparams))
            seed_output_projection(solo.model, torch)
            got = {k: float(v) for k, v in solo.train_step(batch).items()}
            grads = [p.grad for p in solo.model.parameters() if p.grad is not None]
            flat_g = torch._utils._flatten_dense_tensors(grads)
            reduced = collective(dist.all_reduce, flat_g.clone(), dist.group.WORLD)
            if not torch.equal(reduced, flat_g):
                raise AssertionError("NCCL's all-reduce over a world of one changed the bucket")
            errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("total_loss", "grad_norm")}
            worst = params_vs("nccl params after 1 step", solo.model.state_dict(), after,
                              MG_NCCL_RTOL)
            if not max(errs.values()) <= MG_NCCL_RTOL:
                raise AssertionError(f"nccl step 1 vs one process: {errs}")
            log(f"multi_gpu (c) NCCL (the default backend, torchrun's environment, world of one): "
                f"one step, loss/grad norm within {max(errs.values()):.3e} relative, params within "
                f"{worst:.3e} of each peak (tolerance {MG_NCCL_RTOL}); an NCCL all-reduce of the "
                f"{flat_g.numel():,}-element gradient bucket")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def probe_module():
    """tools/probe_bf16_kernels.py (the bf16 serving kernels' measurements)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "probe_bf16_kernels.py")
    spec = importlib.util.spec_from_file_location("probe_bf16_kernels", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def set_parent(parent_dir: str, torch) -> None:
    """Builds the earlier version's K1-bf16, K2/K3 (both tap dtypes),
    K5a/K5b-bf16 and K4/K7 (its sources, as tools/probe_bf16_kernels.py
    copies them) for ``PARENT``, and logs that version's split: the stage's
    convs and, where its K1-bf16 is the cooperative chain (the earlier
    design), that chain's phases from a stamped copy (K5's split by kernel
    comes with its turns, in the bf16 phase). A K1-bf16 with this checkout's
    interface (the cluster chain) is called through this checkout's wrapper;
    K4/K7 through the probe's ``LvcBuild``."""
    global PARENT
    probe = probe_module()
    plain = probe.parent_sources(parent_dir, False)
    lvc = probe.LvcBuild(torch, probe.build_variant("ublock", plain, "PARENT"),
                         probe.build_variant("ublock_block", plain, "PARENT"))
    with open(os.path.join(plain, "wavenet_stack_bf16.cu")) as f:
        cooperative = probe.CHAIN_LOOP in f.read()
    k1_lib = probe.build_variant("wavenet_stack_bf16", plain, "PARENT")
    k1 = probe.ParentK1(k1_lib, torch) if cooperative else probe.variant_k1(k1_lib, torch)
    stage = probe.ParentStage(probe.build_variant("resblock_bf16", plain, "PARENT"), torch)
    stage32 = probe.ParentStage(probe.build_variant("resblock", plain, "PARENT"), torch,
                                "resblock_stage")
    dev = torch.device("cuda:0")
    probe.emit = lambda kind, **kw: log(f"earlier design, {kind}: {json.dumps(kw)}")
    if cooperative:
        stamped = probe.parent_sources(parent_dir, True)
        probe.k1_split(probe.ParentK1(probe.build_variant("wavenet_stack_bf16", stamped, "STAMPED"),
                                      torch), torch, dev)
    else:
        log("earlier design's K1-bf16: the cluster chain (this checkout's interface), timed in "
            "turns, not split")
    probe.stage_split(stage, torch, dev)
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prodiff_tpu_torch", "csrc")
    with open(os.path.join(plain, "wavenet_train_bf16.cu")) as f, \
            open(os.path.join(here, "wavenet_train_bf16.cu")) as g:
        same_k5 = f.read() == g.read()
    k5 = None
    if same_k5:
        log("earlier design's K5a/K5b-bf16: this checkout's source, not timed in turns")
    else:
        k5 = probe.ParentK5(probe.build_variant("wavenet_train_bf16", plain, "PARENT"), torch)
    PARENT = {"k1": k1, "stage": stage, "stage32": stage32, "k5": k5, "lvc": lvc}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument("--fastdiff-kernels", action="store_true",
                        help="build the kernels and run only the FastDiff kernel phase (K4, K6, "
                             "K7 vs their twins, timed), printing its JSON")
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of an earlier version: its K1-bf16, K2/K3 (both tap "
                             "dtypes, C = 8 included), K5a/K5b-bf16 and K4/K7-bf16 are built "
                             "and timed in turns beside this one's (and split, by "
                             "tools/probe_bf16_kernels.py)")
    args = parser.parse_args()
    t_script = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() is false)")
    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.ops import cuda_build

    policy.set_precision(policy.PARITY)
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; precision mode {policy.precision()}")

    sources = ("wavenet_stack", "resblock", "ublock", "ublock_block", "lvc", "wavenet_train",
               "wavenet_stack_bf16", "wavenet_train_bf16", "resblock_bf16")
    t0 = time.time()
    skips = () if args.fastdiff_kernels else tuple(
        ("ublock", (f"LVCT_SKIP={v}",)) for v in K4_SKIPS.values()) + tuple(
        ("lvc", (d,)) for d in K6_VARIANTS.values()) + (K1_STAMPED,) + tuple(
        ("resblock_bf16", (d,)) for d in RES_BF16_SKIPS.values())
    cuda_build.load_all(sources + skips)  # one nvcc per library, all at once
    log(f"kernel build (parallel nvcc) {time.time() - t0:.3f} s")
    for name in sources:
        regs = [ln.strip() for ln in cuda_build.build_log(name).splitlines() if "registers" in ln]
        log(f"ptxas {name}: {' | '.join(regs)}")

    if args.parent:
        set_parent(os.path.abspath(args.parent), torch)
    if args.fastdiff_kernels:
        import prodiff_tpu_torch

        log(f"package: {os.path.dirname(prodiff_tpu_torch.__file__)}")
        print(json.dumps(phase_fastdiff_kernels(dev, torch, split=False)))
        return 0
    spent = {}

    def timed_phase(name, fn):
        t_start = time.time()
        out = fn(dev, torch)
        spent[name] = round(time.time() - t_start, 3)
        log(f"phase {name}: {spent[name]:.3f} s")
        return out

    k1, res = timed_phase("kernels", phase_kernels)
    fd = timed_phase("fastdiff_kernels", phase_fastdiff_kernels)
    k5a, k5b = timed_phase("train_kernels", phase_train_kernels)
    launches = timed_phase("slice", phase_slice)
    fd_launches, fd_unfused_launches, fd_mono_launches = timed_phase("fastdiff", phase_fastdiff)
    vocode_launches = timed_phase("vocode", phase_vocode)
    train_launches = timed_phase("train", phase_train)
    variance_launches = timed_phase("variance", phase_variance)
    vt_launches = timed_phase("variance_train", phase_variance_train)
    dp_launches, dp_tree = timed_phase("data_pipeline", phase_data_pipeline)
    distill_launches = timed_phase("distillation", lambda d, t: phase_distillation(d, t, dp_tree))
    k1_bf16, k5a_bf16, k5b_bf16, res_bf16 = timed_phase("bf16", phase_bf16)
    res_bf16_k, k4_bf16, k7_bf16 = timed_phase("bf16_vocoders", phase_bf16_vocoders)
    res_bf16_k["launches"] = res_bf16
    other, other_launches = timed_phase("other_vocoders", phase_other_vocoders)
    mg = timed_phase("multi_gpu", phase_multi_gpu)
    log(f"phase seconds: {json.dumps(spent)}; script total {time.time() - t_script:.3f} s")
    log("the earlier designs' times, H100 80GB HBM3 at 700 W (PERF.md §6; not measured in this "
        "run): " + json.dumps(EARLIER_BF16_MS))

    def entry(name, source, replaces, n, m, counter):
        return dict(name=name, route="cuda", source=f"prodiff_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=n, max_abs_err=m["max_abs_err"], ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    library_ms=None,  # no single PyTorch call computes any of these
                    launches_distillation=distill_launches[counter])

    def bf16_entry(name, source, replaces, m, counter,
                   rate="bf16 dense tensor cores, 989 TFLOP/s; HBM 3.35 TB/s"):
        # launches: the bf16 phases' main paths (train svs with bf16: true for
        # K5, the --precision fast render for K1 and K2/K3, the fast FastDiff
        # render for K4 and K7); bound at the bf16 dense rate (K4/K7: FP32)
        return dict(entry(name, source, replaces, m["launches"], m, counter), f32_ms=m["f32_ms"],
                    bound_rate=rate)

    kernels = [
        dict(entry("wavenet_residual_stack", "wavenet_stack.cu",
                   "prodiff_tpu/ops/pallas/wavenet.py:177", launches["residual_stack"], k1,
                   "residual_stack"),
             by_shape=k1["by_shape"],
             launches_variance_render=variance_launches["residual_stack"],
             launches_variance_train=vt_launches["residual_stack"],
             launches_data_pipeline=dp_launches["residual_stack"],
             launches_multi_gpu_per_rank_val_batch=mg["k1_per_rank_val_batch"],
             launches_multi_gpu_sp_per_rank_forward={
                 f"rank{r['rank']}_T{t}": v["launches"]["residual_stack"]
                 for r in mg["sp_ranks"] for t, v in r["forward"].items()}),
        dict(entry("resblock_stage", "resblock.cu", "prodiff_tpu/ops/pallas/resblock.py:357",
                   launches["resblock_stage"], res, "resblock_stage"), stages=res["stages"],
             launches_data_pipeline=dp_launches["resblock_stage"],
             launches_other_vocoders={k: v["resblock_stage"] for k, v in other_launches.items()},
             hifigan_stages={m: [dict(C=r["C"], T=r["T"], **r["float32"]) for r in rows]
                             for m, rows in other["stages"].items()}),
        dict(entry("resblock_stage_c8", "resblock.cu", "prodiff_tpu/ops/pallas/resblock.py:357",
                   other_launches["hifigan_v2"]["resblock_stage_c8"], other["float32"],
                   "resblock_stage_c8"),
             eager_ms=other["float32"]["eager_ms"], timed=C8_TIMED,
             **{k: other["float32"][k] for k in PARENT_KEYS if k in other["float32"]},
             shape="HiFi-GAN V2's last stage: B=1, T=131072, C=8 (T_mel=512), the whole stage "
                   "in one launch; the TPU kernel's pack 16"),
        dict(entry("ublock_layer", "ublock.cu", "prodiff_tpu/ops/pallas/ublock.py:221",
                   fd_launches["ublock_layer"], fd["ublock_layer"], "ublock_layer"),
             bound_sum_of_blocks_ms=fd["ublock_layer"]["bound_sum_of_blocks_ms"],
             by_block=fd["ublock_layer"]["by_block"],
             widened_hops=fd["ublock_layer"]["widened_hops"]),
        dict(entry("lvc", "lvc.cu", "prodiff_tpu/ops/pallas/lvc.py:28",
                   fd_unfused_launches["lvc"], fd["lvc"], "lvc"),
             bound_sum_of_blocks_ms=fd["lvc"]["bound_sum_of_blocks_ms"], by_block=fd["lvc"]["by_block"],
             baddbmm_ms=fd["lvc"]["baddbmm_ms"],
             baddbmm_is="torch.baddbmm(bias, taps, km): the window product and the bias in one "
                        "cuBLAS call on a tap tensor built before it, not the whole function"),
        dict(entry("wavenet_stack_save_forward", "wavenet_train.cu",
                   "prodiff_tpu/ops/pallas/wavenet_train.py:71",
                   train_launches["residual_stack_save"], k5a, "residual_stack_save"),
             launches_variance_train=vt_launches["residual_stack_save"],
             launches_data_pipeline=dp_launches["residual_stack_save"],
             launches_multi_gpu_per_rank_step=mg["k5_per_rank_step"]["residual_stack_save"],
             launches_multi_gpu_sp_per_rank_backward={
                 f"rank{r['rank']}": r["grad"]["launches"]["residual_stack_save"] for r in mg["sp_ranks"]}),
        dict(entry("wavenet_stack_backward_chain", "wavenet_train.cu",
                   "prodiff_tpu/ops/pallas/wavenet_train.py:161",
                   train_launches["residual_stack_chain"], k5b, "residual_stack_chain"),
             launches_variance_train=vt_launches["residual_stack_chain"],
             launches_data_pipeline=dp_launches["residual_stack_chain"],
             launches_multi_gpu_per_rank_step=mg["k5_per_rank_step"]["residual_stack_chain"],
             launches_multi_gpu_sp_per_rank_backward={
                 f"rank{r['rank']}": r["grad"]["launches"]["residual_stack_chain"] for r in mg["sp_ranks"]}),
        dict(entry("ublock_block", "ublock_block.cu", "prodiff_tpu/ops/pallas/ublock.py:583",
                   vocode_launches["fastdiff"]["ublock_block"], fd["ublock_block"], "ublock_block"),
             k4_chain_ms=fd["ublock_block"]["k4_chain_ms"], by_block=fd["ublock_block"]["by_block"]),
        dict(bf16_entry("wavenet_residual_stack_bf16", "wavenet_stack_bf16.cu",
                        "prodiff_tpu/ops/pallas/wavenet.py:177", k1_bf16, "residual_stack_bf16"),
             by_shape=k1_bf16["by_shape"]),
        bf16_entry("wavenet_stack_save_forward_bf16", "wavenet_train_bf16.cu",
                   "prodiff_tpu/ops/pallas/wavenet_train.py:71", k5a_bf16, "residual_stack_save_bf16"),
        bf16_entry("wavenet_stack_backward_chain_bf16", "wavenet_train_bf16.cu",
                   "prodiff_tpu/ops/pallas/wavenet_train.py:161", k5b_bf16,
                   "residual_stack_chain_bf16"),
        dict(bf16_entry("resblock_stage_bf16", "resblock_bf16.cu",
                        "prodiff_tpu/ops/pallas/resblock.py:357", res_bf16_k,
                        "resblock_stage_bf16"),
             stages=res_bf16_k["stages"],
             max_err_share_of_peak=res_bf16_k["max_err_share_of_peak"],
             launches_other_vocoders={k: v["resblock_stage_bf16"]
                                      for k, v in other_launches.items()},
             hifigan_stages={m: [dict(C=r["C"], T=r["T"], **r["bf16"]) for r in rows]
                             for m, rows in other["stages"].items() if m in HIFIGAN_STAGES}),
        dict(entry("resblock_stage_c8_bf16", "resblock_bf16.cu",
                   "prodiff_tpu/ops/pallas/resblock.py:357",
                   other_launches["hifigan_v2_fast"]["resblock_stage_c8_bf16"], other["bf16"],
                   "resblock_stage_c8_bf16"),
             f32_ms=other["float32"]["ms"],
             bound_rate="bf16 dense tensor cores, 989 TFLOP/s; HBM 3.35 TB/s",
             eager_ms=other["bf16"]["eager_ms"], timed=C8_TIMED,
             **{k: other["bf16"][k] for k in PARENT_KEYS if k in other["bf16"]},
             shape="HiFi-GAN V2's last stage: B=1, T=131072, C=8 (T_mel=512), the whole stage "
                   "in one launch, two taps a k16 step"),
        dict(bf16_entry("ublock_layer_bf16", "ublock.cu", "prodiff_tpu/ops/pallas/ublock.py:221",
                        k4_bf16, "ublock_layer_bf16", LVC_BF16_RATE),
             by_block=k4_bf16["by_block"], launches_mono=k4_bf16["launches_mono"],
             **{k: k4_bf16[k] for k in LVC_BF16_KEYS if k in k4_bf16},
             wide_range=k4_bf16["wide_range"], widened_hops=k4_bf16["widened_hops"]),
        dict(bf16_entry("ublock_block_bf16", "ublock_block.cu",
                        "prodiff_tpu/ops/pallas/ublock.py:583", k7_bf16, "ublock_block_bf16",
                        LVC_BF16_RATE),
             by_block=k7_bf16["by_block"], **{k: k7_bf16[k] for k in LVC_BF16_KEYS if k in k7_bf16}),
    ]
    if fd_mono_launches["ublock_block"] != vocode_launches["fastdiff"]["ublock_block"]:
        raise AssertionError("K7 launched a different number of times in the mono render and vocode")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
