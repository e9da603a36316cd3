"""The data pipeline of the PyTorch port vs the JAX package, on the CPU.

The complex STFT and iSTFT; RMVPE (``E2E0``, both decoders, the pitch
extractor from one ``torch.save``d checkpoint, the weight carrier);
``preprocess``; ``binarize svs`` (ACF, and RMVPE with the VR model's
voicing, breath and tension), ``binarize vari`` and ``binarize
svs_rectified`` (the teacher's noise injected on both sides), each compared
shard for shard with the JAX ``BinarizeHandler`` on one seeded corpus; then
``train svs`` for 3 steps on the port's own shards. Weights are seeded in
the port's modules, saved under the reference's torch names, and read by
each package's own loader; BatchNorm statistics are perturbed so eval mode
is not the identity.

Tolerances: the STFT 1e-5 and the iSTFT 2e-6 (float32 FFTs; times the
peak of the summed squared window over its value at each sample, which the
overlap-add is divided by, in the signal's last half frame); ``E2E0`` atol
5e-4 / rtol 1e-3 (as ``tests/test_rmvpe_vr.py`` holds the JAX module
against the torch reference); the decoders exactly. The extractor's f0 is
compared only on frames whose top two salience bins differ by more than ten
times the salience tolerance (random weights make near-ties, where the
argmax may fall either way). In the binarized shards: the log10 mel atol
1e-4; the f0 1e-3 relative (the ACF's device part runs in torch here, in
XLA there, as ``tests/test_torch_vocode.py`` holds it); the voicing and
breath curves atol 1e-3 dB, the tension 1e-3 (logit); the teacher's
condition and its sampled mel atol 1e-4 / rtol 1e-3; every integer field,
map and sidecar exactly. The binarize corpus's RMVPE has its output bias
peaked at one bin, as a trained model's salience peaks at the sung pitch, so
its f0 is defined on every frame.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from prodiff_tpu import separation as jax_separation
from prodiff_tpu.binarize import BinarizeHandler as JaxBinarizeHandler
from prodiff_tpu.binarize import svs as jax_svs_binarize
from prodiff_tpu.config import load_base_config as jax_base_config
from prodiff_tpu.models.rmvpe import E2E0 as JaxE2E0
from prodiff_tpu.models.rmvpe import convert_rmvpe
from prodiff_tpu.models.rmvpe import to_local_average_f0 as jax_local_average
from prodiff_tpu.models.rmvpe import to_viterbi_f0 as jax_viterbi
from prodiff_tpu.ops.stft_extras import istft as jax_istft
from prodiff_tpu.ops.stft_extras import stft_complex as jax_stft
from prodiff_tpu.pe import get_pe_cls as jax_get_pe_cls
from prodiff_tpu.preprocess import PreprocessHandler as JaxPreprocessHandler
from prodiff_tpu.utils.indexed_datasets import IndexedDataset as JaxIndexedDataset
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.binarize import BinarizeHandler
from prodiff_tpu_torch.binarize.svs import SVSRectifiedDiffusionBinarizer
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.rmvpe import E2E0, to_local_average_f0, to_viterbi_f0
from prodiff_tpu_torch.models.vr import CascadedNet
from prodiff_tpu_torch.ops.stft_extras import istft, nuttall_window, stft_complex
from prodiff_tpu_torch.pe import get_pe_cls
from prodiff_tpu_torch.pe.rmvpe import RMVPE
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import rmvpe_state_dict, teacher_flax_params
from prodiff_tpu_torch.utils.indexed_datasets import IndexedDataset
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder
from tests.test_data_pipeline import TEXTGRID_LONG

SR = 44100
SAL_TOL = dict(atol=5e-4, rtol=1e-3)
VR_CONFIG = {"n_fft": 256, "hop_length": 128, "n_out": 8, "n_out_lstm": 16, "is_mono": True}
PEAK_BIN = 150  # ~179 Hz: 10 * 2 ** ((150 * 20 + 1997.38) / 1200)


def perturb_batch_norms(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded running statistics and affine parameters on every BatchNorm."""
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


def seeded_rmvpe(seed: int = 0, peak_bin=None) -> E2E0:
    torch.manual_seed(seed)
    model = perturb_batch_norms(E2E0(4, 1, (2, 2)), seed + 1)
    if peak_bin is not None:
        with torch.no_grad():
            model.fc[1].bias.fill_(-3.0)
            model.fc[1].bias[peak_bin - 2:peak_bin + 3] = torch.tensor([0.5, 2.0, 4.0, 2.5, 1.0])
    return model


def save_rmvpe(path, seed: int = 0, peak_bin=None) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(seeded_rmvpe(seed, peak_bin).state_dict(), path)
    return str(path)


def seeded_vr(seed: int = 0) -> CascadedNet:
    torch.manual_seed(seed)
    net = CascadedNet(VR_CONFIG["n_fft"], VR_CONFIG["hop_length"], VR_CONFIG["n_out"],
                      VR_CONFIG["n_out_lstm"])
    return perturb_batch_norms(net, seed + 1)


def save_vr(dirname, seed: int = 0) -> str:
    """A seeded VR checkpoint and the ``config.yaml`` beside it."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, "model.pt")
    torch.save(seeded_vr(seed).state_dict(), path)
    with open(os.path.join(dirname, "config.yaml"), "w") as f:
        yaml.dump(VR_CONFIG, f)
    return path


def tone(seconds: float, f0: float, seed: int, sr: int = SR) -> np.ndarray:
    """A seeded vibrato tone with three partials and a breath of noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    phase = 2 * np.pi * np.cumsum(f0 * 2 ** (0.5 * np.sin(2 * np.pi * 5 * t) / 12)) / sr
    y = np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)
    y = 0.3 * y / np.abs(y).max() + 0.01 * rng.normal(size=t.shape)
    return (y * np.hanning(len(t))).astype(np.float32)


def write_corpus(root, n: int = 4, seconds: float = 0.6) -> str:
    """``n`` seeded tones of one length, with labels (two words, a note and
    a rest) and a phoneme dictionary under ``root``."""
    raw = root / "raw"
    (raw / "wav").mkdir(parents=True)
    rng = np.random.default_rng(60)
    labels = {}
    for i in range(n):
        y = tone(seconds, 196.0 * 2 ** (rng.uniform(-4, 4) / 12), seed=61 + i)
        wavfile.write(str(raw / "wav" / f"it{i}.wav"), SR, (y * 32767).astype(np.int16))
        labels[f"it{i}"] = {"ph_seq": "SP a b", "ph_num": "1 2", "note_seq": "G3 rest",
                            "ph_dur": f"0.15 {0.25 + 0.01 * i:.2f} {0.2 - 0.01 * i:.2f}",
                            "note_dur": "0.4 0.2"}
    with open(raw / "label.json", "w") as f:
        json.dump(labels, f)
    (root / "dict").mkdir(exist_ok=True)
    (root / "dict" / "zh_phones.txt").write_text("a vowel vowel\nb consonant stop\n")
    return str(raw)


def pipeline_hp(root, raw, task: str, **overrides) -> dict:
    """The base config at small widths over the corpus; 1 test, 2 valid, 2
    train items."""
    hp = jax_base_config()
    hp.update(
        task=task, data_dir=str(root / "data"), work_dir=str(root / "work"),
        datasets=[{"data_dir": raw, "speaker": "s0", "language": "zh"}],
        dictionary={"zh": {"phoneme": str(root / "dict" / "zh_phones.txt")}},
        languages={"zh": 1}, num_spk=1, test_num=1, valid_num=1, pitch_extractor="acf",
        audio_num_mel_bins=32, fft_size=1024, win_size=1024, hop_size=256,
        hidden_size=32, enc_layers=1, residual_layers=2, residual_channels=16,
        use_voicing_embed=False, use_breath_embed=False, use_tension_embed=False,
        max_frames=128, max_tokens=512, max_sentences=2, length_bucket_step=32,
        batch_size_buckets=[1, 2], val_check_interval=100, num_sanity_val_steps=0,
        tb_log_interval=1, warmup_updates=10, lr=0.05,
    )
    hp.update(overrides)
    return hp


@pytest.fixture(scope="module")
def jax_vr_model():
    """The JAX package keeps one VR model a process (``separation._VR_MODEL``);
    this module's tests share one VR checkpoint, and leave no model behind."""
    jax_separation._VR_MODEL = None
    yield
    jax_separation._VR_MODEL = None


# ---- STFT -----------------------------------------------------------------------

@pytest.mark.parametrize("window", ["hann", "nuttall"])
def test_stft_and_istft_match_jax(window):
    """Both functions on the same seeded signal; the Nuttall window (0 at its
    first sample) reconstructs the signal to its first and last sample."""
    n_fft, hop, length = 256, 64, 3001
    w = nuttall_window(n_fft) if window == "nuttall" else \
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    y = np.random.default_rng(7).normal(size=(2, length)).astype(np.float32)
    spec = stft_complex(torch.from_numpy(y), torch.from_numpy(w), n_fft, hop)
    want = np.asarray(jax_stft(jnp.asarray(y), jnp.asarray(w), n_fft, hop))
    assert spec.shape == want.shape == (2, n_fft // 2 + 1, 1 + length // hop)
    np.testing.assert_allclose(spec.numpy(), want, atol=1e-5, rtol=1e-5)
    # the overlap-add is divided by the summed squared window: where that sum
    # is small (the last half frame) both packages' float32 FFT rounding is
    # amplified by its inverse, so the bound there is 2e-6 times peak / sum
    n_frames = spec.shape[-1]
    wsq = np.zeros(n_fft + hop * (n_frames - 1))
    for i in range(n_frames):
        wsq[i * hop:i * hop + n_fft] += w.astype(np.float64) ** 2
    for n in (length, length - 100, length + 300):  # trimmed, and zero-padded past the end
        got = istft(spec, torch.from_numpy(w), n_fft, hop, n).numpy()
        ref = np.asarray(jax_istft(jnp.asarray(want), jnp.asarray(w), n_fft, hop, n))
        grid = np.pad(wsq[n_fft // 2:], (0, max(0, n - len(wsq) + n_fft // 2)),
                      constant_values=wsq.max())[:n]
        bound = 2e-6 * np.maximum(1.0, wsq.max() / np.maximum(grid, 1e-11))
        assert got.shape == ref.shape == (2, n) and (np.abs(got - ref) <= bound).all(), n
    got = istft(spec, torch.from_numpy(w), n_fft, hop, length).numpy()
    for ends in (slice(0, 8), slice(length - 8, length)):
        np.testing.assert_allclose(got[:, ends], y[:, ends], atol=2e-6)
    assert nuttall_window(n_fft)[0] < 1e-6


# ---- RMVPE ------------------------------------------------------------------------

def _jax_rmvpe(model: E2E0):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return JaxE2E0(4, 1, (2, 2)), jax.tree.map(jnp.asarray, convert_rmvpe(sd))


def test_rmvpe_e2e0_matches_jax():
    """Salience at mel T=32 from the port's seeded weights carried by
    ``convert_rmvpe``; the carrier back (``rmvpe_state_dict``) rebuilds the
    same state dict, and ``convert_rmvpe`` of its result is the same tree."""
    model = seeded_rmvpe(3)
    jax_model, params = _jax_rmvpe(model)
    mel = np.random.default_rng(8).normal(size=(2, 32, 128)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mel)).numpy()
    want = np.asarray(jax.jit(jax_model.apply)(params, jnp.asarray(mel)))
    assert got.shape == want.shape == (2, 32, 360)
    np.testing.assert_allclose(got, want, **SAL_TOL)

    back = rmvpe_state_dict(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    assert set(back) == set(sd)
    again = convert_rmvpe({k: v.numpy() for k, v in back.items()})
    jax.tree.map(np.testing.assert_array_equal, again, jax.tree.map(np.asarray, params))
    rebuilt = E2E0(4, 1, (2, 2)).eval()
    rebuilt.load_state_dict(back)
    with torch.no_grad():
        np.testing.assert_allclose(rebuilt(torch.from_numpy(mel)).numpy(), want, **SAL_TOL)


def test_rmvpe_decoders_match_jax():
    rng = np.random.default_rng(9)
    hidden = rng.uniform(0, 0.02, (40, 360)).astype(np.float32)
    centers = np.clip(120 + np.cumsum(rng.integers(-3, 4, 40)), 0, 359)
    hidden[np.arange(40), centers] = rng.uniform(0.01, 0.9, 40)  # some below the threshold
    hidden[5, :] = 0.0
    hidden[6, 355:] = 0.8  # a peak at the top edge
    for port, jax_fn in ((to_local_average_f0, jax_local_average), (to_viterbi_f0, jax_viterbi)):
        got, want = port(hidden), jax_fn(hidden)
        assert got.dtype == np.float32 and 0 < (got > 0).sum() < 40
        np.testing.assert_array_equal(got, want)


def test_rmvpe_get_pitch_matches_jax(tmp_path):
    """Both extractors read one saved checkpoint (``pe_ckpt``): the salience
    of a 0.7 s 44.1 kHz tone, then the f0 on the frames without a near-tie;
    the registry returns the port's RMVPE, and a missing checkpoint raises
    in both packages."""
    path = save_rmvpe(tmp_path / "rmvpe" / "model.pt", seed=4)
    hp = {"pe_ckpt": path}
    assert get_pe_cls("rmvpe") is RMVPE and get_pe_cls("RMVPE") is RMVPE
    pe, jax_pe = get_pe_cls("rmvpe")(hp, device="cpu"), jax_get_pe_cls("rmvpe")(hp)
    wav = tone(0.7, 220.0, seed=5)
    from scipy.signal import resample_poly

    audio16k = resample_poly(wav, 160, 441)
    sal = pe.salience(audio16k)
    mel = jax_pe._mel(audio16k)
    n = mel.shape[-1]
    mel = jnp.pad(mel, [(0, 0), (0, 0), (0, 32 * ((n - 1) // 32 + 1) - n)])
    jax_sal = np.asarray(jax_pe._jitted(jax_pe.params, mel.swapaxes(1, 2)))[0, :n]
    assert sal.shape == jax_sal.shape == (71, 360)
    np.testing.assert_allclose(pe.mel(audio16k).numpy(), np.asarray(jax_pe._mel(audio16k)),
                               atol=1e-4)
    np.testing.assert_allclose(sal, jax_sal, **SAL_TOL)

    top2 = np.sort(jax_sal, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 10 * (SAL_TOL["atol"] + SAL_TOL["rtol"] * top2[:, 1])
    assert clear.sum() >= n // 2, clear.sum()
    got, want = pe.infer_from_audio(wav, SR), jax_pe.infer_from_audio(wav, SR)
    np.testing.assert_allclose(got[clear], want[clear], rtol=1e-4)
    assert (got > 0).all()

    absent = {"pe_ckpt": str(tmp_path / "absent.pt")}
    with pytest.raises(FileNotFoundError):
        get_pe_cls("rmvpe")(absent, device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_get_pe_cls("rmvpe")(absent)


# ---- preprocess -------------------------------------------------------------------

def test_preprocess_matches_jax(tmp_path):
    """TextGrid -> label.json, then ph_num and notes from ``.rawmid``, by the
    port's CLI and the JAX handler on copies of one corpus; the label files
    are equal."""
    dict_root = tmp_path / "dictionary"
    dict_root.mkdir()
    (dict_root / "zh_phones.txt").write_text("a vowel vowel\nb consonant stop\n")
    raw_midi = {"note_midi": [57.0, 59.26, 60.0], "note_rest": [False, False, True],
                "note_dur": [0.25, 0.4, 0.35]}
    dirs = []
    for side in ("port", "jax"):
        d = tmp_path / side
        (d / "TextGrid").mkdir(parents=True)
        (d / "midi").mkdir()
        (d / "TextGrid" / "item1.TextGrid").write_text(TEXTGRID_LONG)
        (d / "TextGrid" / "notes.txt").write_text("skipped")
        (d / "midi" / "item1.rawmid").write_bytes(pickle.dumps(raw_midi))
        dirs.append(d)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the handlers read dictionary/{lang}_phones.txt from the cwd
    try:
        port_cli(["preprocess", str(dirs[0])])
        port_cli(["preprocess", str(dirs[0]), "--extract_note", "--override_ori_label"])
        JaxPreprocessHandler(str(dirs[1]), "zh").handle()
        JaxPreprocessHandler(str(dirs[1]), "zh").handle(extract_note=True, override_ori_label=True)
    finally:
        os.chdir(cwd)
    for name in ("label.json", "label_new.json"):
        got = json.loads((dirs[0] / name).read_text())
        assert got == json.loads((dirs[1] / name).read_text()), name
    label = json.loads((dirs[0] / "label.json").read_text())["item1"]
    assert label["ph_seq"] == "SP a b" and label["ph_num"] == "1 2"
    assert label["note_seq"] == "A3 B3+26 rest" and label["note_dur"] == "0.2500 0.4000 0.3500"


# ---- binarize -----------------------------------------------------------------------

def _assert_same_shards(got_dir, want_dir, prefix, float_tol):
    got, want = IndexedDataset(got_dir, prefix), JaxIndexedDataset(want_dir, prefix)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in float_tol:
                np.testing.assert_allclose(a, b, err_msg=k, **float_tol[k])
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
    for side in ("lengths.npy", "item_lengths.npz"):
        a, b = np.load(f"{got_dir}/{prefix}_{side}"), np.load(f"{want_dir}/{prefix}_{side}")
        if side.endswith(".npz"):
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in b.files)
        else:
            assert np.array_equal(a, b)
    a = np.load(f"{got_dir}/{prefix}_f0s_mean_std.npy")
    np.testing.assert_allclose(a, np.load(f"{want_dir}/{prefix}_f0s_mean_std.npy"), rtol=1e-3)


SHARD_TOL = {"mel": dict(atol=1e-4), "f0": dict(rtol=1e-3), "voicing": dict(atol=1e-3),
             "breath": dict(atol=1e-3), "tension": dict(atol=1e-3),
             "condition": dict(atol=1e-4, rtol=1e-3), "x_0": dict(atol=1e-4, rtol=1e-3)}


def _binarize_both(hp, root):
    """The port's ``BinarizeHandler`` (CPU) and the JAX one on one config,
    into ``data`` and ``jax_data``; returns both task dirs."""
    BinarizeHandler(dict(hp), device="cpu").handle()
    JaxBinarizeHandler(dict(hp, data_dir=str(root / "jax_data"))).handle()
    got, want = os.path.join(hp["data_dir"], hp["task"]), str(root / "jax_data" / hp["task"])
    maps = sorted(f for f in os.listdir(want) if f.endswith(".json"))
    assert maps == sorted(f for f in os.listdir(got) if f.endswith(".json")) != []
    for m in maps:
        with open(os.path.join(got, m)) as a, open(os.path.join(want, m)) as b:
            assert json.load(a) == json.load(b), m
    return got, want


@pytest.mark.parametrize("features", ["acf", "rmvpe_vr"])
def test_binarize_svs_matches_jax(features, tmp_path, jax_vr_model):
    raw = write_corpus(tmp_path)
    hp = pipeline_hp(tmp_path, raw, "svs")
    if features == "rmvpe_vr":
        hp.update(pitch_extractor="rmvpe",
                  pe_ckpt=save_rmvpe(tmp_path / "rmvpe" / "model.pt", peak_bin=PEAK_BIN),
                  vr_ckpt=save_vr(str(tmp_path / "vr")),
                  binarization_args=dict(hp["binarization_args"], with_voicing=True,
                                         with_breath=True, with_tension=True, shuffle=True))
    got, want = _binarize_both(hp, tmp_path)
    for prefix in ("valid", "test", "train"):
        _assert_same_shards(got, want, prefix, SHARD_TOL)
    item = IndexedDataset(got, "train")[0]
    assert item["mel"].shape == (item["length"], 32) and (item["f0"] > 0).all()
    if features == "rmvpe_vr":
        for k in ("voicing", "breath", "tension"):
            assert item[k].shape == (item["length"],) and np.ptp(item[k]) > 0, k


def test_binarize_vari_matches_jax(tmp_path, jax_vr_model):
    raw = write_corpus(tmp_path)
    hp = pipeline_hp(tmp_path, raw, "vari", vr_ckpt=save_vr(str(tmp_path / "vr")),
                     binarization_args=dict(jax_base_config()["binarization_args"],
                                            with_voicing=True, with_breath=True,
                                            with_tension=True))
    got, want = _binarize_both(hp, tmp_path)
    for prefix in ("valid", "test", "train"):
        _assert_same_shards(got, want, prefix, SHARD_TOL)
    item = IndexedDataset(got, "train")[0]
    assert set(item) >= {"voicing", "breath", "tension", "note_midi", "note_rest", "mel2note"}


def test_binarize_svs_rectified_matches_jax(tmp_path, monkeypatch):
    """The teacher's condition and its sampled mel, the same noise injected
    into both binarizers (the JAX one's ``jax.random`` draws replaced for the
    length of the test); the port's own draws are seeded per item."""
    raw = write_corpus(tmp_path)
    hp = pipeline_hp(tmp_path, raw, "svs_rectified", teacher_ckpt=str(tmp_path / "teacher"))
    torch.manual_seed(11)
    teacher = ProDiffTeacher(len(TokenTextEncoder(["AP", "SP", "a", "b"])), hp)
    with torch.no_grad():
        for p in teacher.parameters():
            p.add_(0.05 * torch.randn_like(p))
    ckpt_utils.save_checkpoint(str(tmp_path / "teacher"), 5, {
        "state_dict": teacher_flax_params(teacher.state_dict(), hp), "global_step": 5})

    rng = np.random.default_rng(12)
    noises = {}  # t_mel -> (x_T, init, steps), one set an item length

    def draws(t_mel):
        if t_mel not in noises:
            shape = (1, 1, t_mel, 32)
            noises[t_mel] = (rng.normal(size=shape).astype(np.float32),
                             rng.uniform(size=shape).astype(np.float32),
                             rng.normal(size=(4, *shape)).astype(np.float32))
        return noises[t_mel]

    def port_noise(self, item_idx, t_mel):
        x_t, init, steps = draws(t_mel)
        return {"x_T": torch.from_numpy(x_t), "init_noise": torch.from_numpy(init),
                "step_noises": torch.from_numpy(steps)}

    monkeypatch.setattr(SVSRectifiedDiffusionBinarizer, "draw_noise", port_noise)

    jax_init = jax_svs_binarize.SVSRectifiedDiffusionBinarizer.__init__

    def jax_injected_init(self, hparams):
        jax_init(self, hparams)
        teacher_apply = self.teacher.apply

        class Injected:  # the diffusion call (the one with rngs) takes the injected noise
            def apply(_, params, *args, method=None, rngs=None, **kw):
                if rngs is None:
                    return teacher_apply(params, *args, method=method, **kw)
                _, init, steps = draws(args[0].shape[1])
                return teacher_apply(params, *args, method=lambda m, c: m.diffusion(
                    c, infer=True, init_noise=jnp.asarray(init), step_noises=jnp.asarray(steps)))
        self.teacher = Injected()

    monkeypatch.setattr(jax_svs_binarize.SVSRectifiedDiffusionBinarizer, "__init__",
                        jax_injected_init)
    real_normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **kw: jnp.asarray(
        draws(shape[2])[0]) if len(shape) == 4 else real_normal(key, shape, *a, **kw))
    got, want = _binarize_both(hp, tmp_path)
    for prefix in ("valid", "test", "train"):
        _assert_same_shards(got, want, prefix, SHARD_TOL)
    item = IndexedDataset(got, "train")[0]
    assert item["condition"].shape == (item["length"], 32)
    assert item["x_0"].shape == item["x_T"].shape == (item["length"], 32)

    monkeypatch.undo()  # the port's own draws: seeded by item, reproducible
    binarizer = SVSRectifiedDiffusionBinarizer(dict(hp, data_dir=str(tmp_path / "own")),
                                               device="cpu")
    items = binarizer.load_meta_data()
    first = binarizer.process_item(items[0])
    again = SVSRectifiedDiffusionBinarizer(dict(hp, data_dir=str(tmp_path / "own")),
                                           device="cpu").process_item(items[0])
    second = binarizer.process_item(items[0])
    np.testing.assert_array_equal(first["x_0"], again["x_0"])
    assert not np.array_equal(first["x_T"], second["x_T"])  # item index 1: another seed


def test_binarize_svs_then_train_through_the_cli(tmp_path, monkeypatch):
    """``binarize svs`` and ``train svs`` (3 steps) through the port's CLI on
    the CPU; the checkpoint is written and its losses are finite."""
    monkeypatch.chdir(tmp_path)
    raw = write_corpus(tmp_path, n=6)
    hp = pipeline_hp(tmp_path, raw, "svs", max_updates=3)
    for key in ("task", "work_dir"):
        hp.pop(key)
    cfg = str(tmp_path / "svs.yaml")
    with open(cfg, "w") as f:
        yaml.dump(hp, f)
    port_cli(["binarize", "svs", "--config", cfg, "--exp_name", "dp", "--device", "cpu"])
    assert len(IndexedDataset(str(tmp_path / "data" / "svs"), "train")) == 4
    port_cli(["train", "svs", "--config", cfg, "--exp_name", "dp", "--device", "cpu"])
    work = tmp_path / "checkpoints" / "dp" / "svs"
    assert (work / "model_ckpt_steps_3.ckpt").exists()
    losses = [json.loads(ln)["tr/total_loss"] for ln in open(work / "metrics.jsonl")
              if "tr/total_loss" in ln]
    assert len(losses) == 3 and np.isfinite(losses).all()
