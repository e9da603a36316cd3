"""VR separation in the PyTorch port vs the JAX package, on the CPU.

``CascadedNet`` (n_fft 256, hop 128, nout 8, nout_lstm 16) and
``SeparationModel.predict_from_audio`` from the port's seeded weights carried
by ``convert_vr``, and the carrier back (``vr_state_dict``); the k-th
harmonic and the tension curve; the infer handler's
``--isolate_aspiration`` (2 tracks) and ``--isolate_base_harmonic`` (3
tracks) against the JAX handler; ``/api/infer``'s VR gain against the JAX
server's route, its fallback where ``vr_ckpt`` names no file, and its 400
and 500 answers.

Tolerances: ``CascadedNet`` atol 2e-4 / rtol 1e-3 and ``predict_from_audio``
atol 2e-3 / rtol 2e-2 (the bounds ``tests/test_rmvpe_vr.py`` holds the JAX
module to against the torch reference); the k-th harmonic atol 1e-5 (float32
FFTs of a 0.4-peak tone) and the tension 1e-3 (logit); the handler's tracks
and the VR-gain wav atol 2e-5 / rtol 1e-3 (as ``tests/test_torch_slice.py``
holds the render, ~1e-3 of its peak), their int16 files within one step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from prodiff_tpu import separation as jax_separation
from prodiff_tpu.binarize.utils import get_kth_harmonic as jax_kth_harmonic
from prodiff_tpu.binarize.utils import get_tension as jax_get_tension
from prodiff_tpu.infer.handler import SVSInferHandler as JaxHandler
from prodiff_tpu.models.vr import CascadedNet as JaxCascadedNet
from prodiff_tpu.models.vr import SeparationModel as JaxSeparationModel
from prodiff_tpu.models.vr import convert_vr
from prodiff_tpu.serve.handler import WebHandler as JaxWebHandler
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.binarize.utils import get_kth_harmonic, get_tension
from prodiff_tpu_torch.infer.handler import SVSInferHandler
from prodiff_tpu_torch.models.vr import CascadedNet, SeparationModel, load_sep_model
from prodiff_tpu_torch.separation import extract_harmonic_aperiodic
from prodiff_tpu_torch.serve.handler import WebHandler
from prodiff_tpu_torch.utils.convert import vr_state_dict
from tests.test_torch_data_pipeline import VR_CONFIG, save_vr, seeded_vr, tone
from tests.test_torch_slice import EXP, SEGMENTS, _request, _serve, make_experiment

TRACK_TOL = dict(atol=2e-5, rtol=1e-3)


def _jax_params(net: CascadedNet):
    return jax.tree.map(jnp.asarray, convert_vr({k: v.numpy() for k, v in net.state_dict().items()}))


def test_cascadednet_matches_jax_and_carries_back():
    net = seeded_vr(2)
    params = _jax_params(net)
    rng = np.random.default_rng(20)
    x = rng.normal(size=(1, VR_CONFIG["n_fft"] // 2 + 1, 64, 2)).astype(np.float32)
    jax_net = JaxCascadedNet(256, 128, nout=8, nout_lstm=16)
    want = np.asarray(jax.jit(jax_net.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert np.abs(np.hypot(got[..., 0], got[..., 1])).max() < 1  # the bounded mask

    back = vr_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(net.state_dict())
    again = convert_vr({k: v.numpy() for k, v in back.items()})
    jax.tree.map(np.testing.assert_array_equal, again, jax.tree.map(np.asarray, params))
    rebuilt = CascadedNet(256, 128, 8, 16).eval()
    rebuilt.load_state_dict(back)
    with torch.no_grad():
        rebuilt_out = rebuilt(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(rebuilt_out.numpy(), want, atol=2e-4, rtol=1e-3)


def test_predict_from_audio_matches_jax(tmp_path):
    """The whole separation (padding to 32 frames, STFT, mask, iSTFT) from
    one saved checkpoint read by ``load_sep_model`` and by the JAX model."""
    path = save_vr(str(tmp_path / "vr"), seed=3)
    sep = load_sep_model(path, device="cpu")
    assert isinstance(sep, SeparationModel) and not sep.model.training
    jax_sep = JaxSeparationModel(_jax_params(seeded_vr(3)), 256, 128, nout=8, nout_lstm=16)
    wav = (np.random.default_rng(21).normal(size=20000) * 0.1).astype(np.float32)
    got, want = sep.predict_from_audio(wav), jax_sep.predict_from_audio(wav)
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-2)
    harmonic, aperiodic = extract_harmonic_aperiodic(wav, path, device="cpu")
    np.testing.assert_array_equal(harmonic, got)
    np.testing.assert_array_equal(aperiodic, wav - harmonic)


@pytest.mark.parametrize("k", [0, 2])
def test_kth_harmonic_and_tension_match_jax(k):
    """A 0.5 s three-partial tone at 44.1 kHz, hop 256 / window 1024, with
    an f0 curve shorter than the frames and unvoiced frames to interpolate."""
    wav = tone(0.5, 220.0, seed=22)
    hop, win = 256, 1024
    f0 = np.full(80, 220.0)
    f0[[0, 1, 40, 41]] = 0
    got = get_kth_harmonic(k, wav, f0, hop, win, 44100, device="cpu")
    want = jax_kth_harmonic(k, wav, f0, hop, win, 44100)
    assert got.shape == want.shape == wav.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5)
    mel_len = len(wav) // hop
    got = get_tension(wav, mel_len, f0, hop, win, 44100, 21, device="cpu")
    want = jax_get_tension(wav, mel_len, f0, hop, win, 44100, 21)
    assert got.shape == want.shape == (mel_len,)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.fixture(scope="module")
def vr_experiment(tmp_path_factory):
    """``checkpoints/port/svs`` (``tests/test_torch_slice.py``) with a VR
    checkpoint in its config, as the cwd, and both packages' deterministic
    handlers on it, built once for this module's tests (each test resets
    what it changes); the JAX package's one-a-process VR model is cleared
    before and after."""
    root = tmp_path_factory.mktemp("vr_experiment")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        make_experiment(root)
        cfg = root / "checkpoints" / EXP / "svs" / "config.yaml"
        hp = yaml.safe_load(cfg.read_text())
        hp["vr_ckpt"] = save_vr(str(root / "vr"), seed=4)
        cfg.write_text(yaml.dump(hp))
        mp.setattr(jax_separation, "_VR_MODEL", None)
        yield root, SVSInferHandler(EXP, deterministic=True, device="cpu"), \
            JaxHandler(EXP, deterministic=True)


@pytest.mark.parametrize("base_harmonic", [False, True])
def test_isolate_tracks_match_jax(base_harmonic, vr_experiment):
    """``--isolate_aspiration`` writes sp and ap, ``--isolate_base_harmonic``
    sp (without its first harmonic), ap and bh: each segment's tracks and
    the stitched files against the JAX handler's, and the CLI's files."""
    _, port_h, jax_h = vr_experiment
    for h in (port_h, jax_h):
        h.isolate_aspiration, h.isolate_base_harmonic = True, base_harmonic
    try:
        _isolate_tracks(port_h, jax_h, base_harmonic)
    finally:
        for h in (port_h, jax_h):
            h.isolate_aspiration = h.isolate_base_harmonic = False
    with open("song.ds", "w") as f:
        json.dump(SEGMENTS, f)
    argv = ["infer", "song.ds", "--exp_name", EXP, "--spk_name", "spk0", "--device", "cpu",
            "--isolate_aspiration"] + (["--isolate_base_harmonic"] if base_harmonic else [])
    port_cli(argv)
    for s in ["sp", "ap", "bh"][:3 if base_harmonic else 2]:
        assert os.path.exists(os.path.join("infer_out", f"song_{s}【{EXP}】.wav"))


def _isolate_tracks(port_h, jax_h, base_harmonic):
    segments = [dict(s, lang="zh", spk_name="spk1") for s in SEGMENTS]
    for seg in segments:
        p, w = port_h.prepare(seg), jax_h.prepare(seg)
        got = port_h._postprocess(port_h.render_batch([p])[0], p["f0_seq"])
        want = jax_h._postprocess(jax_h.render_batch([w])[0], w["f0_seq"])
        assert len(got) == len(want) == (3 if base_harmonic else 2)
        for g, t in zip(got, want):
            assert g.shape == t.shape and np.abs(t).max() > 1e-4
            np.testing.assert_allclose(g, t, **TRACK_TOL)
    port_paths = port_h.handle([dict(s) for s in segments], "song_port.ds")
    jax_paths = jax_h.handle([dict(s) for s in segments], "song_jax.ds")
    suffixes = ["sp", "ap", "bh"][:len(port_paths)]
    assert [os.path.basename(p) for p in port_paths] == [f"song_port_{s}【{EXP}】.wav"
                                                         for s in suffixes]
    assert len(jax_paths) == len(port_paths)
    for g, w in zip(port_paths, jax_paths):
        (sr_g, a), (sr_w, b) = wavfile.read(g), wavfile.read(w)
        assert sr_g == sr_w == 44100 and a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def _jax_web(core):
    web = JaxWebHandler.__new__(JaxWebHandler)  # its route code, without the warm-up compile
    web.core, web.hparams, web.timestep = core, core.hparams, core.timestep
    web.host, web.port = "127.0.0.1", 0
    return web


def test_web_vr_gain_matches_jax(vr_experiment, tmp_path):
    """``/api/infer`` with both curves: the gained wav against the JAX
    route's (called in-process); over HTTP, the fallback to the raw wav where
    ``vr_ckpt`` names no file, 400 for a malformed curve, and 500 where the
    VR model fails (the JAX route answers the raw wav there)."""
    _, core, jax_core = vr_experiment
    vr_ckpt = core.hparams["vr_ckpt"]
    try:
        _web_vr_gain(core, jax_core, tmp_path)
    finally:
        core.hparams["vr_ckpt"] = jax_core.hparams["vr_ckpt"] = vr_ckpt
        jax_separation._VR_MODEL = None


def _web_vr_gain(core, jax_core, tmp_path):
    port_web, jax_web = WebHandler(core=core, host="127.0.0.1", port=0), _jax_web(jax_core)
    req = {"speaker": "spk0", "language": "zh", "ph_text_list": ["a", "c", "SP"],
           "ph_dur_list": [0.15, 0.2, 0.05], "pitch_list": [60.0] * 40}
    raw = np.asarray(port_web.api_infer(req)["wav"])
    curves = {"voicing_list": list(np.linspace(-12.0, 6.0, 40)),
              "breath_list": list(np.linspace(0.0, -30.0, 40))}
    got = np.asarray(port_web.api_infer(dict(req, **curves))["wav"])
    want = np.asarray(jax_web.api_infer(dict(req, **curves))["wav"])
    assert got.shape == want.shape == raw.shape
    np.testing.assert_allclose(got, want, **TRACK_TOL)
    assert np.abs(got - raw).max() > 1e-3 * np.abs(raw).max()  # the gain did something

    url, stop = _serve(port_web)
    try:
        code, out = _request(f"{url}/api/infer", dict(req, **dict(curves, breath_list=["x"])))
        assert code == 400 and "breath_list" in out["error"]
        core.hparams["vr_ckpt"] = str(tmp_path / "absent" / "model.pt")
        code, out = _request(f"{url}/api/infer", dict(req, **curves))
        assert code == 200
        np.testing.assert_array_equal(np.asarray(out["wav"]), raw)
        broken = tmp_path / "broken"
        broken.mkdir()
        (broken / "model.pt").write_bytes(b"not a checkpoint")
        (broken / "config.yaml").write_text(yaml.dump(VR_CONFIG))
        core.hparams["vr_ckpt"] = str(broken / "model.pt")
        code, out = _request(f"{url}/api/infer", dict(req, **curves))
        assert code == 500 and out["error"]
    finally:
        stop()
    jax_web.hparams["vr_ckpt"] = str(tmp_path / "absent" / "model.pt")
    jax_separation._VR_MODEL = None
    np.testing.assert_array_equal(np.asarray(jax_web.api_infer(dict(req, **curves))["wav"]),
                                  np.asarray(jax_web.api_infer(req)["wav"]))
