"""The whole text->wav slice: the PyTorch port vs the JAX package, on the CPU.

One experiment directory serves both: ``config.yaml`` and the maps, a teacher
checkpoint written by ``ckpt_utils.save_checkpoint`` from seeded JAX params,
and an NSF-HiFiGAN checkpoint saved from the port's ``Generator`` that the
JAX side loads through ``convert_nsf_hifigan``. Both handlers render
deterministically (zero diffusion noise, zero-phase noise-free source).

Tolerance on the wav: atol 2e-5 / rtol 1e-3, about 1e-3 of the ~0.02 peak
these seeded weights render; the two float32 pipelines differ only in the
order of their sums (measured ~1e-7). The stitched int16 files may differ by
one step of rounding.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prodiff_tpu.config import load_base_config
from prodiff_tpu.infer.handler import SVSInferHandler as JaxHandler
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.serve.handler import WebHandler as JaxWebHandler
from prodiff_tpu.utils import ckpt_utils
from prodiff_tpu.utils.text_encoder import TokenTextEncoder
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.infer.handler import SVSInferHandler
from prodiff_tpu_torch.models.nsf_hifigan import Generator
from prodiff_tpu_torch.serve.handler import WebHandler
from tests.test_torch_modules import perturb
from tests.test_torch_vocoder import VOCODER_H

EXP = "port"
SEGMENTS = [
    {"ph_seq": "SP a b c SP", "ph_dur": "0.05 0.2 0.3 0.25 0.1",
     "f0_seq": " ".join(str(200.0 + 5 * i) for i in range(20)), "f0_timestep": "0.05",
     "offset": 0.0},
    {"ph_seq": "a c b", "ph_dur": "0.15 0.1 0.2",
     "f0_seq": " ".join(["330.0"] * 10), "f0_timestep": "0.05", "offset": 0.85},
]


@pytest.fixture
def experiment(tmp_path, monkeypatch):
    """checkpoints/port/svs under a fresh cwd; returns the hparams."""
    monkeypatch.chdir(tmp_path)
    return make_experiment(tmp_path)


def make_experiment(tmp_path):
    """Write checkpoints/port/svs and the vocoder under ``tmp_path``; returns
    the hparams."""
    work = tmp_path / "checkpoints" / EXP / "svs"
    work.mkdir(parents=True)
    voc_dir = tmp_path / "nsf_hifigan"
    voc_dir.mkdir()
    hp = load_base_config()
    hp.update(
        audio_num_mel_bins=16, hidden_size=32, enc_layers=2, residual_layers=4,
        residual_channels=32, num_spk=2, languages={"zh": 1}, hop_size=32,
        fft_size=512, win_size=512,
        length_bucket_step=32, precompile_buckets=[[16, 32]],
        vocoder_ckpt=str(voc_dir / "model"), data_dir=str(tmp_path / "data"),
    )
    with open(work / "config.yaml", "w") as f:
        yaml.dump(hp, f)
    maps = {
        "phone_set.json": {f"{p}/zh": p for p in ["SP", "AP", "a", "b", "c"]},
        "spk_map.json": {"spk0": 0, "spk1": 1},
        "lang_map.json": {"zh": 1},
    }
    for name, content in maps.items():
        with open(work / name, "w") as f:
            json.dump(content, f)

    phones = sorted(set(maps["phone_set.json"].values()))
    teacher = JaxTeacher(vocab_size=len(TokenTextEncoder(phones, replace_oov="SP")), hparams=hp)
    tokens = jnp.ones((1, 4), jnp.int32)
    mel2ph = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(lambda rngs: teacher.init(
        rngs, tokens, mel2ph, jnp.full((1, 8), 200.0), lang_seq=tokens,
        spk_embed_id=jnp.zeros((1,), jnp.int32), voicing=jnp.zeros((1, 8)),
        breath=jnp.zeros((1, 8)), infer=True,
    ))({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)})
    ckpt_utils.save_checkpoint(str(work), 10, {"state_dict": perturb(params, scale=0.1),
                                               "global_step": 10})

    torch.manual_seed(0)
    gen = Generator.from_config(VOCODER_H)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.05 * torch.randn_like(p))
    torch.save({"generator": gen.state_dict()}, voc_dir / "model")
    with open(voc_dir / "config.json", "w") as f:
        json.dump(dict(VOCODER_H, n_fft=512, win_size=512, hop_size=32, fmin=40, fmax=16000), f)
    return hp


def _segments():
    return [dict(s, lang="zh", spk_name="spk0:0.3|spk1:0.7", keyshift=2, gender=0.0)
            for s in SEGMENTS]


def test_slice_matches_jax_handler(experiment):
    jax_h = JaxHandler(EXP, deterministic=True)
    port_h = SVSInferHandler(EXP, deterministic=True, device="cpu")
    want = jax_h.render_batch([jax_h.prepare(s) for s in _segments()])
    got = port_h.render_batch([port_h.prepare(s) for s in _segments()])
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(w).max() > 1e-3  # not a silent render
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-3)

    # whole project: bucket grouping + offset/cross-fade stitching + wav file
    from scipy.io import wavfile

    jax_path = jax_h.handle(_segments(), "song_jax.ds")[0]
    port_path = port_h.handle(_segments(), "song_port.ds")[0]
    (sr_w, wav_w), (sr_g, wav_g) = wavfile.read(jax_path), wavfile.read(port_path)
    assert sr_g == sr_w == 44100 and wav_g.shape == wav_w.shape
    assert np.abs(wav_g.astype(np.int32) - wav_w.astype(np.int32)).max() <= 1  # int16 rounding


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_web_api_and_cli(experiment):
    core = SVSInferHandler(EXP, deterministic=True, device="cpu")
    web = WebHandler(core=core, host="127.0.0.1", port=0)
    server = web.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, info = _request(f"{base}/api/basic_info")
        assert code == 200 and info["speakers"] == ["spk0", "spk1"] and info["samplerate"] == 44100
        req = {"speaker": "spk1", "language": "zh", "ph_text_list": ["a", "b", "SP"],
               "ph_dur_list": [0.2, 0.2, 0.1], "pitch_list": [57.0] * 60}
        code, out = _request(f"{base}/api/infer", req)
        assert code == 200, out
        wav = np.asarray(out["wav"])
        mel_len = int(np.round(0.5 / (32 / 44100) + 0.5))
        assert wav.shape == (mel_len * 32,) and np.isfinite(wav).all()
        code, err = _request(f"{base}/api/infer", {"speaker": "spk0"})
        assert code == 400 and "required" in err["error"]
        code, err = _request(f"{base}/api/infer", dict(req, speaker="nobody"))
        assert code == 400 and "nobody" in err["error"]
        code, err = _request(f"{base}/api/infer", dict(req, ph_dur_list=[0.2, 0.2]))
        assert code == 400 and "ph_dur_list" in err["error"]

        def contract_fault(_segment):  # a server-side check, not the client's fault
            raise ValueError("kernel operand dtype")

        core.infer, render = contract_fault, core.infer
        code, err = _request(f"{base}/api/infer", req)
        core.infer = render
        assert code == 500 and "kernel operand dtype" in err["error"]
        code, err = _request(f"{base}/api/pred_dur", {})
        assert code == 400 and "required" in err["error"]
        code, err = _request(f"{base}/api/pred_dur", {  # this experiment has no dur predictor
            "language": "zh", "word_list": ["a"], "word_dur_list": [0.5], "start_time": 0.0})
        assert code == 400 and "not loaded" in err["error"]
        code, err = _request(f"{base}/api/nope", {})
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    with open("song.ds", "w") as f:
        json.dump(SEGMENTS, f)
    port_cli(["infer", "song.ds", "--exp_name", EXP, "--spk_name", "spk0", "--device", "cpu"])
    assert os.path.exists(os.path.join("infer_out", f"song【{EXP}】.wav"))
    with pytest.raises(FileNotFoundError, match="dur"):  # no dur predictor in the experiment
        SVSInferHandler(EXP, pred_dur=True, device="cpu")


def _serve(web):
    """Start ``web``'s server on a free port; returns (base url, stop)."""
    server = web.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()
    return f"http://127.0.0.1:{server.server_address[1]}", stop


def test_web_infer_takes_vr_keys_as_jax(experiment):
    """``voicing_list`` alone, ``breath_list`` alone, and both: the port's
    ``/api/infer`` answers 200 with the wav of the request without them
    (one key alone is ignored; both ask for the VR gain, and without a VR
    model the raw wav is returned), as the JAX server's route answers."""
    core = SVSInferHandler(EXP, deterministic=True, device="cpu")
    jax_web = JaxWebHandler.__new__(JaxWebHandler)  # its route code, without the warm-up compile
    jax_web.core = JaxHandler(EXP, deterministic=True)
    jax_web.hparams, jax_web.timestep = jax_web.core.hparams, jax_web.core.timestep
    jax_web.host, jax_web.port = "127.0.0.1", 0
    req = {"speaker": "spk0", "language": "zh", "ph_text_list": ["a", "c", "SP"],
           "ph_dur_list": [0.15, 0.2, 0.05], "pitch_list": [60.0] * 40}
    curves = {"voicing_list": [-30.0] * 40, "breath_list": [-60.0] * 40}
    keyed = [{"voicing_list": curves["voicing_list"]}, {"breath_list": curves["breath_list"]},
             curves]
    for web in (WebHandler(core=core, host="127.0.0.1", port=0), jax_web):
        url, stop = _serve(web)
        try:
            code, out = _request(f"{url}/api/infer", req)
            assert code == 200, out
            raw = np.asarray(out["wav"])
            assert raw.size > 0 and np.abs(raw).max() > 1e-4
            for extra in keyed:
                code, out = _request(f"{url}/api/infer", dict(req, **extra))
                assert code == 200, (sorted(extra), out)
                np.testing.assert_array_equal(np.asarray(out["wav"]), raw, err_msg=str(sorted(extra)))
        finally:
            stop()


def test_chip_smoke_mirrors_base_config():
    """``chip_smoke.py`` builds the slice from in-code hparams (the card's
    machine need not have PyYAML); they must match the shipped base config,
    and its vocoder config the ``Generator`` defaults."""
    import inspect

    import chip_smoke

    base = load_base_config()
    for key, value in chip_smoke.BASE_HPARAMS.items():
        assert base[key] == value, key
    defaults = {k: p.default for k, p in inspect.signature(Generator).parameters.items()}
    for key, value in chip_smoke.VOCODER_H.items():
        want = defaults[key]
        want = [list(d) for d in want] if key == "resblock_dilation_sizes" else want
        assert (list(want) if isinstance(want, tuple) else want) == value, key
