"""The traffic generator: seeded songs and corpus, the same work under every
seed, and the padding metrics' arithmetic against hand counts."""

import os
from types import SimpleNamespace

import bench_tiny
import numpy as np
import pytest

import generate
import harness

SONG = bench_tiny.mix("song")
TRAIN = harness.load_json("traffic", "train.json")


def test_same_seed_same_song_other_seed_other_song():
    assert generate.song(SONG, 2 ** 31 + 3, 1) == generate.song(SONG, 2 ** 31 + 3, 1)
    assert generate.song(SONG, 2 ** 31 + 3, 1) != generate.song(SONG, 2 ** 31 + 4, 1)
    assert generate.song(SONG, 2 ** 31 + 3, 1) != generate.song(SONG, 2 ** 31 + 3, 2)


def test_sizes_follow_the_sources_published_totals():
    """Opencpop: 100 songs, 3,756 utterances, 5.2 hours: 38 phrases a song
    and 4.984 s a phrase on average, in the songs and in the corpus."""
    song = harness.load_json("traffic", "song.json")
    assert generate.phrases_per_song(song) == 38
    mean = generate.mean_length_s(song)
    assert mean == pytest.approx(4.984, abs=1e-3)
    lengths = np.concatenate([generate.phrase_lengths(song, k) for k in range(40)])
    assert lengths.mean() == pytest.approx(mean, rel=0.03)
    frames = generate.corpus_shapes(TRAIN)[:, 0]
    assert generate.mean_length_s(TRAIN) == mean
    assert frames.mean() * TRAIN["frame_s"] == pytest.approx(mean, rel=0.05)


@pytest.mark.parametrize("index", range(4))
def test_phrases_keep_their_lengths_under_every_seed(index):
    mix = harness.load_json("traffic", "song.json")
    lengths = generate.phrase_lengths(mix, index)
    assert len(lengths) == 38 and lengths.min() >= 1.0 and lengths.max() <= 17.97

    def shape(seed):
        return sorted((round(sum(map(float, p["ph_dur"].split())), 6), len(p["ph_seq"].split()))
                      for p in generate.song(mix, seed, index))

    assert shape(7) == shape(2 ** 31 + 99)
    assert shape(7) == sorted((round(float(s), 6), generate.phonemes_in(mix, s)) for s in lengths)


def test_melody_stays_in_range():
    rng = np.random.default_rng(0)
    f0 = generate.melody(SONG, rng, 6.0)
    lo = 440 * 2 ** ((SONG["midi_min"] - SONG["vibrato_semitones"] - 69) / 12)
    hi = 440 * 2 ** ((SONG["midi_max"] + SONG["vibrato_semitones"] - 69) / 12)
    assert len(f0) == int(np.ceil(6.0 / SONG["f0_timestep"])) + 2
    assert lo - 1e-6 <= f0.min() and f0.max() <= hi + 1e-6


def test_corpus_same_seed_same_items_same_shapes_every_seed():
    a = generate.corpus_items(TRAIN, 11, 8, 65, 2)[:5]
    b = generate.corpus_items(TRAIN, 11, 8, 65, 2)[:5]
    c = generate.corpus_items(TRAIN, 12, 8, 65, 2)[:5]
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["mel"], c[0]["mel"])
    assert [len(x["mel"]) for x in a] == [len(x["mel"]) for x in c]
    frames = generate.corpus_shapes(TRAIN)[:, 0]
    assert frames.min() >= round(1.0 / TRAIN["frame_s"]) and frames.max() <= 1548


def read_metric(name, **record):
    return harness.metric_reader(name)(SimpleNamespace(record=record, trace=None))


def test_pad_pct_on_a_hand_made_song():
    batches = [{"t_mel": 384, "lengths": [300, 350]}, {"t_mel": 128, "lengths": [100]}]
    want = 100 * ((384 - 300) + (384 - 350) + (128 - 100)) / (2 * 384 + 128)
    assert read_metric("pad_pct", batches=batches) == pytest.approx(want)


def test_train_batches_come_out_of_the_ports_batching(tmp_path):
    """The port's batching of the corpus under the base config: length-sorted
    token-budget batches, each padded to its batch-size bucket and to a
    multiple of 128 frames; ``train_pad_pct`` against a hand count."""
    from prodiff_tpu_torch.tasks.svs import SVSTask
    from prodiff_tpu_torch.utils.indexed_datasets import IndexedDatasetBuilder

    hp = dict(harness.load_json("configs", "svs-prodiff4-nsf44k.json")["hparams"],
              task="svs", data_dir=str(tmp_path), work_dir=str(tmp_path / "work"))
    items = generate.corpus_items(TRAIN, 5, 8, 65, 2)
    generate.write_corpus(os.path.join(tmp_path, "svs"), items,
                          {"phone_set": generate.phone_set("zh"), "spk_map": {"spk0": 0, "spk1": 1},
                           "lang_map": {"zh": 1}}, IndexedDatasetBuilder)
    batches = list(SVSTask(hp).train_iterator())
    assert sum(b["nsamples"] for b in batches) == len(items) == 888
    shapes = [b["mel"].shape[:2] for b in batches]
    longest = [int(np.count_nonzero(b["mel2ph"], axis=1).max()) for b in batches]
    bucket = [min(c for c in hp["batch_size_buckets"] if c >= b["nsamples"]) for b in batches]
    assert shapes == [(r, -(-t // 128) * 128) for r, t in zip(bucket, longest)]
    assert sum(1 for b in batches if b["nsamples"] == hp["max_sentences"]) >= len(batches) // 2
    real = [int(np.count_nonzero(b["mel2ph"])) for b in batches]
    want = 100 * (1 - sum(real) / sum(b * t for b, t in shapes))
    rows = [[(int(f), 1) for f in np.count_nonzero(b["mel2ph"], axis=1) if f] for b in batches]
    got = read_metric("train_pad_pct", shapes=shapes, rows=rows)
    assert got == pytest.approx(want)
    assert 10 < got < 30
