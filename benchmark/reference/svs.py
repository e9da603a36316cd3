"""Plain PyTorch reference of the SVS cells: the phrase front end, the
ProDiff teacher (FastSpeech encoder, WaveNet denoiser, the x0-prediction
DDPM and the euler rectified flow), NSF-HiFiGAN and the teacher's training
step (l1 + SSIM losses, global-norm clip, Adam under the rsqrt schedule).

Written from the published descriptions in float32 with plain ``torch``
operations: no kernel, no cache, no batching of its own beyond what the
served semantics fix. It takes the weights as a name -> tensor map under
the torch state-dict names the checkpoints use (``encoder.layers.0.op...``,
``diffusion.denoise_fn...``; the vocoder's ``conv_pre``, ``ups.0`` ...).
Randomness (the sampler's start point and step noise, the sine source's
phase and noise, the training step's t, noise and dropout masks) is drawn
from ``torch.Generator`` streams seeded as the served system seeds them, so
both sides take the same draws.

Departures from a textbook model, each one a fixed part of the served
semantics: the DDPM starts from uniform noise; log10 mels reach the
vocoder through the factor 2.30259; padded mel frames are filled with
-5.0 before vocoding; the encoder's LayerNorm epsilon is 1e-6.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
MEL_PAD_LOG10 = -5.0
LOG10_TO_LN = 2.30259
LRELU_SLOPE = 0.1
RESERVED_TOKENS = 3  # <pad>, <EOS>, <UNK> precede the phone set's ids
DROPOUT_STREAM = 2 ** 30


@contextlib.contextmanager
def precision(tf32: bool = False) -> Iterator[None]:
    """Float32 products and convolutions as stated (TF32 off), or with
    ``tf32`` the card's TF32 path for both, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# ---- front end ---------------------------------------------------------------

def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def phone_ids(phone_set: Dict[str, str]) -> Dict[str, int]:
    """Phone name (``p0/zh``) -> token id: reserved ids first, then the
    phone set's sorted values."""
    vocab = sorted(set(phone_set.values()))
    index = {p: i + RESERVED_TOKENS for i, p in enumerate(vocab)}
    return {name: index[p] for name, p in phone_set.items()}


def resample_curve(points: np.ndarray, src_step: float, dst_step: float, length: int) -> np.ndarray:
    """Linear resampling of a control curve onto ``dst_step``, cut or held at
    its last value to ``length``."""
    t_max = (len(points) - 1) * src_step
    out = np.interp(np.arange(0, t_max, dst_step), src_step * np.arange(len(points)),
                    points).astype(points.dtype)
    if len(out) >= length:
        return out[:length]
    return np.concatenate([out, np.full(length - len(out), out[-1], out.dtype)])


def prepare(segment: dict, hp: dict, ids: Dict[str, int], spk_table: np.ndarray,
            spk_index: Dict[str, int]) -> dict:
    """One phrase -> tokens, frame-to-token map, f0 on the frame grid, the
    speaker mix and the constant voicing / breath curves."""
    step = hp["hop_size"] / hp["audio_sample_rate"]
    lang = segment["lang"]
    tokens = np.array([ids[f"{p}/{lang}"] for p in segment["ph_seq"].split()], np.int64)
    ph_dur = np.array(segment["ph_dur"].split(), np.float32)
    bounds = np.round(np.cumsum(ph_dur) / step + 0.5).astype(np.int64)
    frames = np.diff(bounds, prepend=0)
    mel_len = int(frames.sum())
    mel2ph = np.repeat(np.arange(1, len(tokens) + 1), frames).astype(np.int64)
    f0 = resample_curve(np.array(segment["f0_seq"].split(), np.float32),
                        float(segment["f0_timestep"]), step, mel_len)
    mix = [(name, float(w)) for name, w in (x.split(":") for x in segment["spk_name"].split("|"))]
    total = sum(w for _, w in mix)
    spk = sum((w / total) * spk_table[spk_index[name]] for name, w in mix).astype(np.float32)
    return {"tokens": tokens, "mel2ph": mel2ph, "mel_len": mel_len, "f0": f0,
            "lang": hp["languages"][lang], "spk": spk}


def batches(prepared: List[dict], bucket: int, max_b: int) -> List[tuple]:
    """Phrases grouped by padded (tokens to 16, frames to ``bucket``), in
    order of first appearance, each group cut into chunks of ``max_b``:
    [(phrase indices, padded tokens, padded frames)]."""
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(prepared):
        groups.setdefault((round_up(len(p["tokens"]), 16), round_up(p["mel_len"], bucket)),
                          []).append(i)
    return [(idxs[i:i + max_b], t_ph, t_mel) for (t_ph, t_mel), idxs in groups.items()
            for i in range(0, len(idxs), max_b)]


def pad_batch(items: List[dict], t_ph: int, t_mel: int, curves: Dict[str, float]) -> dict:
    """Padded inputs of one batch (numpy), zeros past each phrase."""
    b = len(items)
    out = {"tokens": np.zeros((b, t_ph), np.int64), "mel2ph": np.zeros((b, t_mel), np.int64),
           "f0": np.zeros((b, t_mel), np.float32), "lang": np.zeros((b, t_ph), np.int64),
           "spk": np.stack([p["spk"] for p in items])[:, None, :]}
    for name in curves:
        out[name] = np.zeros((b, t_mel), np.float32)
    for r, p in enumerate(items):
        n, m = len(p["tokens"]), p["mel_len"]
        out["tokens"][r, :n] = p["tokens"]
        out["lang"][r, :n] = p["lang"]
        out["mel2ph"][r, :m] = p["mel2ph"][:m]
        out["f0"][r, :m] = p["f0"][:m]
        for name, db in curves.items():
            out[name][r, :m] = db
    return out


# ---- encoder -----------------------------------------------------------------

class Dropout:
    """Inverted dropout drawing its keep masks, in call order, from one
    generator (``None``: off)."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p, self.generator = p, generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.p == 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / float(np.float32(1 - self.p)), 0.0)


def sinusoid_table(n: int, dim: int) -> torch.Tensor:
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000) / (half - 1)))
    arg = np.arange(n, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(arg), np.cos(arg)], axis=1)
    table[0] = 0
    return torch.from_numpy(table.astype(np.float32))


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def encoder(w: dict, tokens: torch.Tensor, extra: torch.Tensor, n_layers: int, n_heads: int,
            drop: Dropout) -> torch.Tensor:
    """FastSpeech encoder: scaled token embedding + extra + positions, pre-LN
    self-attention and conv-FFN layers, final LayerNorm; zero on padding."""
    pre = "encoder."
    hidden = w[pre + "embed_tokens.weight"].shape[1]
    pad = tokens == 0
    nonpad = (~pad).float()[:, :, None]
    pos = torch.cumsum((~pad).long(), 1) * (~pad).long()
    table = sinusoid_table(2049, hidden).to(tokens.device)
    x = hidden ** 0.5 * w[pre + "embed_tokens.weight"][tokens] + extra
    x = drop(x + table[pos]) * nonpad
    for i in range(n_layers):
        p = f"{pre}layers.{i}.op."
        b, t, _ = x.shape
        d = hidden // n_heads
        q, k, v = (layer_norm(x, w[p + "layer_norm1.weight"], w[p + "layer_norm1.bias"])
                   @ w[p + "self_attn.in_proj_weight"].t()).chunk(3, dim=-1)
        q = q.reshape(b, t, n_heads, d) * d ** -0.5
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k.reshape(b, t, n_heads, d))
        scores = scores.masked_fill(pad[:, None, None, :], torch.finfo(scores.dtype).min)
        att = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v.reshape(b, t, n_heads, d))
        att = att.reshape(b, t, hidden) @ w[p + "self_attn.out_proj.weight"].t()
        x = (x + drop(att)) * nonpad
        h = layer_norm(x, w[p + "layer_norm2.weight"], w[p + "layer_norm2.bias"])
        kernel = w[p + "ffn.ffn_1.weight"].shape[-1]
        h = F.conv1d(h.transpose(1, 2), w[p + "ffn.ffn_1.weight"], w[p + "ffn.ffn_1.bias"],
                     padding=kernel // 2).transpose(1, 2)
        h = drop(F.gelu(h * kernel ** -0.5))
        h = F.linear(h, w[p + "ffn.ffn_2.weight"], w[p + "ffn.ffn_2.bias"])
        x = (x + drop(h)) * nonpad
        x = x * nonpad
    return layer_norm(x, w[pre + "layer_norm.weight"], w[pre + "layer_norm.bias"]) * nonpad


def condition(w: dict, hp: dict, inp: dict, drop: Dropout, spk_id=None) -> torch.Tensor:
    """[B, T_mel, H]: encoder output at each frame's token plus the pitch,
    speaker, voicing and breath embeddings; zero on padding frames."""
    def lin(name, x):
        return F.linear(x[..., None], w[name + ".weight"], w[name + ".bias"])

    tokens, mel2ph = inp["tokens"], inp["mel2ph"]
    dur = torch.zeros(tokens.shape[0], tokens.shape[1] + 1, device=tokens.device)
    dur = dur.scatter_add(1, mel2ph, torch.ones_like(mel2ph, dtype=torch.float32))[:, 1:]
    extra = lin("dur_embed", dur) + w["lang_embed.weight"][inp["lang"]]
    enc = encoder(w, tokens, extra, hp["enc_layers"], hp["num_heads"], drop)
    enc = torch.cat([torch.zeros_like(enc[:, :1]), enc], 1)
    cond = torch.gather(enc, 1, mel2ph[..., None].expand(-1, -1, enc.shape[-1]))
    cond = cond + lin("pitch_embed", torch.log(1 + inp["f0"] / 700))
    cond = cond + (inp["spk"] if spk_id is None else w["spk_embed.weight"][spk_id][:, None, :])
    for name in ("voicing", "breath"):
        cond = cond + lin(f"{name}_embed", inp[name])
    return cond * (mel2ph > 0).float()[:, :, None]


# ---- denoiser and samplers ---------------------------------------------------

def conv1x1(x, w, b):
    return F.linear(x, w[:, :, 0], b)


def wavenet(w: dict, spec: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
            n_layers: int) -> torch.Tensor:
    """Non-causal gated WaveNet on [B, T, M] (dilation 1 in every layer)."""
    p = "diffusion.denoise_fn."
    c = w[p + "input_projection.weight"].shape[0]
    x = F.relu(conv1x1(spec, w[p + "input_projection.weight"], w[p + "input_projection.bias"]))
    half = c // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000) / (half - 1)))
    emb = t.float()[:, None] * freq[None, :]
    emb = torch.cat([emb.sin(), emb.cos()], -1)
    step = F.linear(emb, w[p + "mlp.0.weight"], w[p + "mlp.0.bias"])
    step = step * torch.tanh(F.softplus(step))
    step = F.linear(step, w[p + "mlp.2.weight"], w[p + "mlp.2.bias"])
    skip = torch.zeros_like(x)
    for i in range(n_layers):
        q = f"{p}residual_layers.{i}."
        y = x + F.linear(step, w[q + "diffusion_projection.weight"],
                         w[q + "diffusion_projection.bias"])[:, None, :]
        y = F.conv1d(y.transpose(1, 2), w[q + "dilated_conv.weight"], w[q + "dilated_conv.bias"],
                     padding=1).transpose(1, 2)
        y = y + conv1x1(cond, w[q + "conditioner_projection.weight"],
                        w[q + "conditioner_projection.bias"])
        y = torch.sigmoid(y[..., :c]) * torch.tanh(y[..., c:])
        y = conv1x1(y, w[q + "output_projection.weight"], w[q + "output_projection.bias"])
        x = (x + y[..., :c]) * 2.0 ** -0.5
        skip = skip + y[..., c:]
    x = skip * (1.0 / math.sqrt(n_layers))
    x = F.relu(conv1x1(x, w[p + "skip_projection.weight"], w[p + "skip_projection.bias"]))
    return conv1x1(x, w[p + "output_projection.weight"], w[p + "output_projection.bias"])


def ddpm_coefficients(hp: dict, device) -> Dict[str, torch.Tensor]:
    """The vpsde schedule over ``timesteps + 1`` entries and the DDPM's
    q-sample and posterior coefficients."""
    n = hp["timesteps"] + 1
    lo, hi = 0.1, hp["max_beta"]
    betas = np.array([1.0 - np.exp(-lo / n - 0.5 * (hi - lo) * (2 * t - 1) / n ** 2)
                      for t in range(1, n + 1)])
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    var = betas * (1.0 - ac_prev) / (1.0 - ac)
    out = {"sqrt_ac": np.sqrt(ac), "sqrt_1m_ac": np.sqrt(1.0 - ac),
           "c1": betas * np.sqrt(ac_prev) / (1.0 - ac),
           "c2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
           "log_var": np.log(np.maximum(var, 1e-20))}
    return {k: torch.tensor(v.astype(np.float32), device=device) for k, v in out.items()}


def sample_mel(w: dict, hp: dict, cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[B, T, M] mel from ``cond``: the 4-step DDPM (``diff_type: prodiff``,
    uniform start, step noise drawn before each step) or the euler flow over
    ``sampling_steps`` (``reflow``, normal start, min-max normalised)."""
    b, t = cond.shape[:2]
    shape = (b, 1, t, hp["audio_num_mel_bins"])
    kw = dict(generator=generator, device=cond.device)
    layers = hp["residual_layers"]

    def denoise(x, steps):
        return wavenet(w, x[:, 0], steps, cond, layers)[:, None]

    if hp["diff_type"] == "reflow":
        x = torch.randn(shape, **kw)
        n = int(hp["sampling_steps"])
        dt = 1.0 / n
        for tt in np.arange(n, dtype=np.float32) * np.float32(dt):
            scaled = float(np.float32(tt) * np.float32(hp["timescale"]))
            x = x + denoise(x, torch.full((b,), scaled, device=cond.device)) * dt
        lo, hi = hp["spec_min"][0], hp["spec_max"][0]
        return ((x + 1) / 2 * (hi - lo) + lo)[:, 0]
    co = ddpm_coefficients(hp, cond.device)
    x = torch.rand(shape, **kw)
    for ti in range(hp["timesteps"] - 1, -1, -1):
        noise = torch.randn(shape, **kw)
        x0 = denoise(x, torch.full((b,), ti, dtype=torch.long, device=cond.device))
        x = co["c1"][ti] * x0 + co["c2"][ti] * x
        if ti:
            x = x + torch.exp(0.5 * co["log_var"][ti]) * noise
    return x[:, 0]


# ---- vocoder -----------------------------------------------------------------

def sine_source(f0: torch.Tensor, upp: int, sr: int, generator: torch.Generator,
                harmonics: int = 8) -> torch.Tensor:
    """NSF harmonic source [B, T*upp, harmonics + 1]: per-frame phase
    increments summed in float64 and reduced mod 1, a random start phase for
    each overtone, 0.1 sine amplitude where voiced, plus Gaussian noise."""
    b, t = f0.shape
    dim = harmonics + 1
    harm = torch.arange(1, dim + 1, dtype=torch.float32, device=f0.device)
    rad = torch.remainder(f0[:, :, None] * harm / sr, 1.0)
    start = torch.rand((1, dim), generator=generator, device=f0.device)
    start[:, 0] = 0.0
    rad = torch.cat([rad[:, :1] + start[:, None, :], rad[:, 1:]], 1)
    inc = torch.remainder(rad * upp, 1.0).double()
    base = torch.remainder(torch.cumsum(inc, 1) - inc, 1.0).float()
    within = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    phase = base[..., None] + within * rad[..., None]
    sines = torch.sin(2 * np.pi * phase).permute(0, 1, 3, 2).reshape(b, t * upp, dim)
    uv = torch.repeat_interleave((f0 > 0).float()[:, :, None], upp, dim=1)
    noise = torch.randn(sines.shape, generator=generator, device=f0.device)
    return sines * 0.1 * uv + (uv * 0.003 + (1 - uv) * 0.1 / 3) * noise


def vocoder(w: dict, h: dict, mel: torch.Tensor, f0: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
    """NSF-HiFiGAN: log10 mel [B, T, M] and f0 [B, T] -> wav [B, T * hop]."""
    rates, ks = h["upsample_rates"], h["upsample_kernel_sizes"]
    upp = int(np.prod(rates))
    src = sine_source(f0, upp, h["sampling_rate"], generator)
    src = torch.tanh(F.linear(src, w["m_source.l_linear.weight"], w["m_source.l_linear.bias"]))
    src = src.transpose(1, 2)
    x = F.conv1d((mel * LOG10_TO_LN).transpose(1, 2), w["conv_pre.weight"], w["conv_pre.bias"],
                 padding=3)
    n_res = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, ks)):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), w[f"ups.{i}.weight"],
                               w[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        s = int(np.prod(rates[i + 1:])) if i + 1 < len(rates) else 1
        x = x + F.conv1d(src, w[f"noise_convs.{i}.weight"], w[f"noise_convs.{i}.bias"],
                         stride=s, padding=s // 2 if i + 1 < len(rates) else 0)
        acc = 0
        for j, (rk, ds) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
            y = x
            for u_i, d in enumerate(ds):
                p = f"resblocks.{i * n_res + j}."
                z = F.conv1d(F.leaky_relu(y, LRELU_SLOPE), w[p + f"convs1.{u_i}.weight"],
                             w[p + f"convs1.{u_i}.bias"], padding=(rk * d - d) // 2, dilation=d)
                z = F.conv1d(F.leaky_relu(z, LRELU_SLOPE), w[p + f"convs2.{u_i}.weight"],
                             w[p + f"convs2.{u_i}.bias"], padding=(rk - 1) // 2)
                y = z + y
            acc = acc + y
        x = acc / n_res
    x = F.conv1d(F.leaky_relu(x), w["conv_post.weight"], w["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0]


def render(teacher: dict, voc: dict, hp: dict, h: dict, inp: dict, lengths: Sequence[int],
           seed: int):
    """One padded batch (tensors on the device) -> (mel [B, T, M], wav [B, T * hop]):
    the sampler's draws from a generator seeded with ``seed``, the vocoder's
    from one seeded with 0, as a render draws them."""
    dev = inp["tokens"].device
    cond = condition(teacher, hp, inp, Dropout(0.0, None))
    mel = sample_mel(teacher, hp, cond, torch.Generator(dev).manual_seed(seed))
    voc_in = torch.full_like(mel, MEL_PAD_LOG10)
    for r, n in enumerate(lengths):
        voc_in[r, :n] = mel[r, :n]
    wav = vocoder(voc, h, voc_in, inp["f0"], torch.Generator(dev).manual_seed(0))
    return voc_in, wav


# ---- training ----------------------------------------------------------------

def ssim(a: torch.Tensor, b: torch.Tensor, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of [B, 1, H, W] images under an 11-tap Gaussian window (zero padding)."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    win = torch.tensor(np.outer(g, g).astype(np.float32), device=a.device)[None, None]

    def blur(x):
        return F.conv2d(x, win, padding=size // 2)

    mu1, mu2 = blur(a), blur(b)
    s11, s22, s12 = blur(a * a) - mu1 * mu1, blur(b * b) - mu2 * mu2, blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def train_losses(w: dict, hp: dict, batch: dict, seed: int, step: int) -> Dict[str, torch.Tensor]:
    """The teacher's training losses on one padded batch: t and noise from
    the generator seeded ``seed * 2**32 + step``, dropout masks from the one
    seeded ``seed * 2**32 + 2**30 + step``; l1 and SSIM (+6 bias) of the x0
    prediction on non-padding frames, weighted 0.5 each."""
    dev = batch["mel"].device
    drop = Dropout(hp["dropout"], torch.Generator(dev).manual_seed(
        seed * 2 ** 32 + DROPOUT_STREAM + step))
    cond = condition(w, hp, batch, drop, spk_id=batch["spk_id"])
    gen = torch.Generator(dev).manual_seed(seed * 2 ** 32 + step)
    x0 = batch["mel"][:, None]
    t = torch.randint(0, hp["timesteps"] + 1, x0.shape[:1], generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    co = ddpm_coefficients(hp, dev)
    xt = co["sqrt_ac"][t][:, None, None, None] * x0 + co["sqrt_1m_ac"][t][:, None, None, None] * noise
    pred = wavenet(w, xt[:, 0], t, cond, hp["residual_layers"])[:, None]
    mask = (batch["mel2ph"] > 0)[:, None, :, None].float()
    pred, x0 = pred * mask, x0 * mask
    return {"mel_l1": (pred - x0).abs().mean() * 0.5,
            "mel_ssim": (1 - ssim(pred + 6.0, x0 + 6.0)) * 0.5}


def rsqrt_lr(hp: dict, count: int) -> float:
    warm = hp["warmup_updates"]
    return max(hp["lr"] * min(count / warm, 1.0) * max(float(warm), float(count)) ** -0.5
               * hp["hidden_size"] ** -0.5, 1e-7)


def train_steps(w0: dict, hp: dict, batches_: List[dict], seed: int) -> dict:
    """``len(batches_)`` training steps from the weights ``w0``: per step the
    loss; the first step's clipped gradients; the weights after the last."""
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps = hp["optimizer_adam_beta1"], hp["optimizer_adam_beta2"], 1e-8
    losses, first = [], None
    for count, batch in enumerate(batches_):
        total = sum(train_losses(w, hp, batch, seed, count).values())
        grads = torch.autograd.grad(total, list(w.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(w.items(), grads)}
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= hp["clip_grad_norm"]:
                grads = {k: g / norm * hp["clip_grad_norm"] for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            k_ = count + 1
            bc1 = 1.0 - float(np.float32(b1) ** np.float32(k_))
            bc2 = 1.0 - float(np.float32(b2) ** np.float32(k_))
            lr = rsqrt_lr(hp, count)
            for k, v in w.items():
                mu[k].mul_(b1).add_((1 - b1) * grads[k])
                nu[k].mul_(b2).add_((1 - b2) * (grads[k] * grads[k]))
                v.sub_(lr * ((mu[k] / bc1) / ((nu[k] / bc2).sqrt() + eps)))
    return {"losses": losses, "first_grads": first,
            "weights": {k: v.detach() for k, v in w.items()}}
