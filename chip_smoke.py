#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from ``prodiff_tpu_torch/csrc`` (nvcc), timed;
  3. each kernel vs its plain PyTorch twin on the card, in parity mode
     (float32, TF32 off), at the main path's full-width shapes: error against
     the stated tolerance and CUDA-event times of both;
  4. the slice at full width on seeded random weights: the base-config
     teacher (4 encoder layers, hidden 256, 20x256 WaveNet, 4 steps,
     voicing/breath embeds) and the default NSF-HiFiGAN generator behind the
     port's web server on 127.0.0.1; three /api/infer requests (~2, 4, 6 s of
     audio) with the kernel launch counts of that run, a bit-identity check of
     two deterministic renders, the host/render split of one 6 s request, and
     one short render held against the same weights on the CPU (the plain
     path, no kernels): the teacher's mel as it enters the vocoder, and the
     wav.
The second-to-last line is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit, no
result line). There is no CPU mode: without a CUDA card the script exits
non-zero before printing anything.
"""

import json
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
K1_SHAPES = ((1, 512), (1, 2048))  # (B, T) at L=20, C=256, H=256
RES_STAGES = ((256, 4096), (128, 32768), (64, 65536), (32, 131072), (16, 262144))  # T_mel=512
RES_K, RES_D = (3, 7, 11), ((1, 3, 5),) * 3
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)  # float32 both sides; only the sum order differs
CPU_TOL = 1e-3  # card vs CPU render (mel and wav), relative to each one's peak (see phase 4)


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
    k1 = {"max_abs_err": 0.0}
    for b, t in K1_SHAPES:
        x0, cond, step = rand(b, t, c), rand(b, t, h), rand(b, c)
        got = wn.residual_stack(x0, cond, step, w)
        want = wn.residual_stack_plain(x0, cond, step, w)
        res = compare(f"K1 residual_stack L=20 C=256 H=256 B={b} T={t}", got, want, torch)
        ms = timed_ms(lambda: wn.residual_stack(x0, cond, step, w), 20, torch)
        plain_ms = timed_ms(lambda: wn.residual_stack_plain(x0, cond, step, w), 20, torch)
        log(f"K1 B={b} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        k1["max_abs_err"] = max(k1["max_abs_err"], res["max_abs_err"])
        if t == 512:
            k1.update(ms=ms, plain_ms=plain_ms)

    res_total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for c, t in RES_STAGES:
        ws = [rand(k * c * c, scale=(k * c) ** -0.5) for k in RES_K for _ in range(6)]
        weights, biases = torch.cat(ws), rand(18, c, scale=0.1)
        x = rand(1, t, c)
        got = resblock_stage(x, weights, biases, RES_K, RES_D)
        want = resblock_stage_plain(x, weights, biases, RES_K, RES_D)
        res = compare(f"resblock_stage C={c} T={t}", got, want, torch)
        ms = timed_ms(lambda: resblock_stage(x, weights, biases, RES_K, RES_D), 10, torch)
        plain_ms = timed_ms(lambda: resblock_stage_plain(x, weights, biases, RES_K, RES_D), 10, torch)
        log(f"resblock C={c} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        res_total["max_abs_err"] = max(res_total["max_abs_err"], res["max_abs_err"])
        res_total["ms"] += ms
        res_total["plain_ms"] += plain_ms
    log(f"resblock, all 5 stages of one vocoder pass at T_mel=512: kernel "
        f"{res_total['ms']:.4f} ms, plain {res_total['plain_ms']:.4f} ms")
    return k1, res_total


def build_models(torch):
    """Seeded full-width teacher + NSF-HiFiGAN state dicts (random weights)."""
    from prodiff_tpu_torch.infer.handler import phone_encoder
    from prodiff_tpu_torch.models.nsf_hifigan import Generator
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher

    torch.manual_seed(SEED)
    n_vocab = len(phone_encoder(PHONE_SET))
    teacher = ProDiffTeacher(n_vocab, SLICE_HPARAMS)
    # the reference zero-inits the denoiser's output projection, which would
    # make the mel independent of the residual stack: give it seeded weights
    torch.nn.init.normal_(teacher.diffusion.denoise_fn.output_projection.weight, std=0.02)
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
    padded with the silence floor), on the host."""
    seen = {}
    spec2wav = handler.vocoder.spec2wav_batch

    def spy(mel, f0, **kw):
        seen["mel"] = mel.detach().cpu().numpy()
        return spec2wav(mel, f0, **kw)

    handler.vocoder.spec2wav_batch = spy
    return seen


def request_split(web, req, latency_s: float) -> None:
    """Time the parts of one request outside HTTP: the handler's front end
    (``prepare``), the render (teacher + vocoder + wav copy to the host), all
    of ``api_infer`` (adds request validation, the segment's text fields and
    the wav to a list), then ``json.dumps``/``json.loads`` of the answer."""
    core, spans = web.core, {}

    def timed(name, fn):
        def run(*args):
            start = time.perf_counter()
            out = fn(*args)
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - start
            return out
        return run

    core.prepare, core.render_batch = timed("prepare", core.prepare), timed("render", core.render_batch)
    try:
        result = timed("api_infer", web.api_infer)(req)
    finally:
        del core.prepare, core.render_batch
    body = timed("json_dumps", json.dumps)(result)
    timed("json_loads", json.loads)(body)
    ms = {k: round(v * 1000, 3) for k, v in spans.items()}
    log(f"{REQUEST_SECONDS[-1]:.0f} s request split, outside HTTP (one call, ms): {json.dumps(ms)}; the HTTP request "
        f"above took {latency_s * 1000:.3f} ms, which leaves "
        f"{latency_s * 1000 - ms['api_infer'] - ms['json_dumps'] - ms['json_loads']:.3f} ms for the "
        f"HTTP exchange itself (sockets, server thread, the client's array conversion; not split "
        f"further); answer {len(body)} bytes")


def phase_slice(dev, torch):
    from prodiff_tpu_torch.ops.resblock import resblock_stage
    from prodiff_tpu_torch.ops.wavenet_stack import residual_stack
    from prodiff_tpu_torch.serve.handler import WebHandler

    teacher_sd, voc_sd = build_models(torch)
    core = make_handler(teacher_sd, voc_sd, dev, deterministic=False)
    t0 = time.time()
    web = WebHandler(core=core, host="127.0.0.1", port=0)  # warm-up runs here
    log(f"server warm-up {time.time() - t0:.3f} s")
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
        residual_stack.launches.reset()
        resblock_stage.launches.reset()
        for seconds in REQUEST_SECONDS:
            req = request_payload(seconds, rng)
            last = req
            ph_acc = np.round(np.cumsum(req["ph_dur_list"]) / (hop / sr) + 0.5).astype(np.int64)
            mel_len = int(np.diff(ph_acc, prepend=0).sum())
            start = time.perf_counter()
            wav = np.asarray(post(f"{base}/api/infer", req)["wav"], np.float32)
            latency = time.perf_counter() - start
            if wav.shape != (mel_len * hop,) or not np.isfinite(wav).all():
                raise AssertionError(f"/api/infer: wav {wav.shape}, want ({mel_len * hop},) finite")
            log(f"POST /api/infer {seconds:.0f} s of audio: mel_len {mel_len}, wav {wav.shape[0]} "
                f"samples, peak {np.abs(wav).max():.4f}, std {wav.std():.4f}, "
                f"latency {latency * 1000:.3f} ms "
                f"(RTF {latency / (wav.shape[0] / sr):.4f})")
        launches = {"residual_stack": residual_stack.launches.count,
                    "resblock_stage": resblock_stage.launches.count}
        request_split(web, last, latency)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    n = len(REQUEST_SECONDS)
    want = {"residual_stack": n * SLICE_HPARAMS["timesteps"] * (1 + 2 * SLICE_HPARAMS["residual_layers"]),
            "resblock_stage": n * 5 * 18}
    log(f"kernel launches during the requests: {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the main path did not run the kernels the expected number of times")

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


def main() -> int:
    import torch

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

    t0 = time.time()
    for name in ("wavenet_stack", "resblock"):
        start = time.time()
        cuda_build.load(name)
        regs = [ln.strip() for ln in cuda_build.build_log(name).splitlines() if "registers" in ln]
        log(f"build {name}: {time.time() - start:.3f} s; ptxas: {' | '.join(regs)}")
    log(f"kernel build total {time.time() - t0:.3f} s")

    k1, res = phase_kernels(dev, torch)
    launches = phase_slice(dev, torch)

    kernels = [
        dict(name="wavenet_residual_stack", route="cuda",
             source="prodiff_tpu_torch/csrc/wavenet_stack.cu",
             replaces="prodiff_tpu/ops/pallas/wavenet.py:177",
             launches=launches["residual_stack"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="resblock_stage", route="cuda", source="prodiff_tpu_torch/csrc/resblock.cu",
             replaces="prodiff_tpu/ops/pallas/resblock.py:357",
             launches=launches["resblock_stage"], max_abs_err=res["max_abs_err"],
             ms=res["ms"], plain_ms=res["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
