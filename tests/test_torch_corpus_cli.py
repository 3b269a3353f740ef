"""The port's corpus pipeline against the JAX package's: ``prepare-data``
(both schemes), ``preprocess``, ``split-data`` and ``data-midi`` write the
JAX command's files from the same MIDI bytes (the independent raw-SMF
corpus of ``tests/test_corpus_pipeline.py``), and the functions under them
(the event extraction, the tuple words, the REMI writer, the dataset
functions, the process pool and the native helper) give the JAX package's
output.  Mirrors ``tests/test_data.py``, ``test_cp_tokenizer.py``,
``test_native.py``, ``test_parallel_encode.py``, ``test_corpus_pipeline.py``
and ``test_cli_pipeline_cp.py``."""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_corpus_pipeline import write_corpus  # noqa: E402

from reinforcement_learning_in_music_generation_torch.apps import cli as tcli  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import cp_tokenizer as tcp  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import dataset as tds  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import events as tev  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import midifile as tmf  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import native as tnat  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import parallel_encode as tpe  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer as ttok  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.apps import cli as jcli  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import cp_tokenizer as jcp  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import events as jev  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import native as jnat  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import tokenizer as jtok  # noqa: E402

N_SONGS = 10


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(str(root / "midis"), n_songs=N_SONGS, seed=11)
    (root / "midis" / "broken.mid").write_bytes(b"MThd but not a MIDI file")
    return root


def _midis(corpus, broken=False):
    return sorted(str(p) for p in (corpus / "midis").iterdir()
                  if broken or p.name != "broken.mid")


@pytest.fixture(scope="module")
def cli_runs(corpus):
    """The whole CLI run of each package on the corpus, each into its
    own folder: prepare-data (tuple, cp), preprocess, split-data,
    data-midi."""
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        d = corpus / name
        cli.main(["prepare-data", "--midi-folder", str(corpus / "midis"),
                  "--save-folder", str(d / "tuple"), "--workers", "1"])
        cli.main(["prepare-data", "--midi-folder", str(corpus / "midis"),
                  "--save-folder", str(d / "cp"), "--scheme", "cp", "--cp-seq-len", "192",
                  "--workers", "1"])
        cli.main(["preprocess", "--worded-data", str(d / "tuple" / "worded_data.pickle"),
                  "--out", str(d / "packed" / "our_dataset.pickle"), "--max-seq-len", "160"])
        (d / "split").mkdir()
        shutil.copy(d / "tuple" / "worded_data.pickle", d / "split" / "worded_data.pickle")
        cli.main(["split-data", "--worded-data", str(d / "split" / "worded_data.pickle"),
                  "--seed", "3"])
        for row in (0, 2):
            cli.main(["data-midi", "--dataset", str(d / "packed" / "our_dataset.pickle"),
                      "--dictionary", str(d / "tuple" / "dictionary.pickle"),
                      "--row", str(row), "--out", str(d / "dec" / f"row{row}.mid")])
        out[name] = d
    return out


FILES = ["tuple/dictionary.pickle", "tuple/worded_data.pickle", "cp/dictionary.pkl",
         "packed/our_dataset.pickle", "split/worded_data_train.pickle",
         "split/worded_data_test.pickle", "dec/row0.mid", "dec/row2.mid"]


@pytest.mark.parametrize("name", FILES)
def test_cli_run_writes_the_jax_files(cli_runs, name):
    ours = (cli_runs["torch"] / name).read_bytes()
    assert ours and ours == (cli_runs["jax"] / name).read_bytes()


def test_cp_prepare_data_arrays_match_jax(cli_runs):
    """The npz holds a zip time stamp, so its arrays are compared."""
    ours = np.load(cli_runs["torch"] / "cp" / "train_data_linear.npz")
    ref = np.load(cli_runs["jax"] / "cp" / "train_data_linear.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["mask", "x", "y"]
    for k in ref.files:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes()
    assert ref["x"].shape == (N_SONGS, 192, 7)      # the broken file is skipped


def test_the_cli_run_is_not_empty(cli_runs):
    d = cli_runs["torch"]
    with open(d / "packed" / "our_dataset.pickle", "rb") as f:
        packed = pickle.load(f)
    assert packed["train_x"].shape[1:] == (160, 6) and packed["mask"].sum() > 0
    m = tmf.MidiFile(str(d / "dec" / "row0.mid"))
    assert m.instruments and len(m.instruments[0].notes) >= 4


# -- the events, words and writers under the commands ---------------------------------

@pytest.mark.parametrize("case", range(4))
def test_event_extraction_matches_jax(corpus, case):
    path = _midis(corpus)[case]
    assert tev.extract_tuple_events(path) == jev.extract_tuple_events(path)
    assert tev.group_by_bar(jev.extract_tuple_events(path)) == \
        jev.group_by_bar(jev.extract_tuple_events(path))
    for chords in (True, False):
        ours = [repr(e) for e in tev.extract_remi_events(path, with_chords=chords)]
        assert ours == [repr(e) for e in jev.extract_remi_events(path, with_chords=chords)]
    notes, tempos = jev.read_items(path)
    notes = jev.quantize_items([n for t in notes for n in t])
    chords = jev.extract_chord_items(notes)
    assert [repr(c) for c in tev.extract_chord_items(notes)] == [repr(c) for c in chords]
    max_time = max(n.end for n in notes)
    ours_g = tev.group_items(chords + tempos + notes, max_time)
    ref_g = jev.group_items(chords + tempos + notes, max_time)
    assert [[repr(i) for i in g] for g in ours_g] == [[repr(i) for i in g] for g in ref_g]
    for style in ("tuple", "remi"):
        ours_e = tev.item2event(ref_g, style=style)
        ref_e = jev.item2event(ref_g, style=style)
        assert [repr(e) for e in ours_e] == [repr(e) for e in ref_e]
    assert tev.events_to_tuple_events(jev.item2event(ref_g)) == \
        jev.events_to_tuple_events(jev.item2event(ref_g))


def test_tuple_words_and_dictionaries_match_jax(corpus, tmp_path):
    songs = [jev.group_by_bar(jev.extract_tuple_events(p)) for p in _midis(corpus)[:4]]
    e2w = jtok.construct_tuple_dict()[0]
    assert ttok.construct_tuple_dict() == jtok.construct_tuple_dict()
    assert ttok.tuple_events_to_words(songs, e2w) == jtok.tuple_events_to_words(songs, e2w)
    ttok.save_dict(jtok.construct_tuple_dict(), str(tmp_path / "t.pickle"))
    jtok.save_dict(jtok.construct_tuple_dict(), str(tmp_path / "j.pickle"))
    assert (tmp_path / "t.pickle").read_bytes() == (tmp_path / "j.pickle").read_bytes()
    assert ttok.load_dict(str(tmp_path / "j.pickle")) == jtok.load_dict(str(tmp_path / "j.pickle"))


@pytest.mark.parametrize("prompt", [False, True])
def test_remi_writer_bytes_match_jax(corpus, tmp_path, prompt):
    vocab = ["Bar_None", "Position_1/16", "Note Velocity_10", "Note On_60", "Note Duration_7",
             "Position_9/16", "Note Velocity_12", "Note On_64", "Note Duration_3",
             "Tempo Class_mid", "Tempo Value_30", "Chord_C:maj", "Position_5/16"]
    w2e = dict(enumerate(vocab))
    words = [0, 1, 9, 10, 1, 2, 3, 4, 12, 11, 0, 5, 6, 7, 8, 0, 0, 0]
    prompt_path = _midis(corpus)[0] if prompt else None
    ttok.write_midi_remi(words, w2e, str(tmp_path / "t.mid"), prompt_path=prompt_path)
    jtok.write_midi_remi(words, w2e, str(tmp_path / "j.mid"), prompt_path=prompt_path)
    assert (tmp_path / "t.mid").read_bytes() == (tmp_path / "j.mid").read_bytes()


def test_dataset_functions_match_jax(corpus, tmp_path):
    e2w = jtok.construct_tuple_dict()[0]
    songs = [jev.group_by_bar(jev.extract_tuple_events(p)) for p in _midis(corpus)]
    worded = jtok.tuple_events_to_words(songs, e2w)
    for kw in (dict(max_len=128), dict(max_len=256, n_step_bars=4, seed=5),
               dict(is_train=False, max_len=256)):
        ours = tds.prepare_data_for_training(worded, e2w, **kw)
        ref = jds.prepare_data_for_training(worded, e2w, **kw)
        assert pickle.dumps(ours) == pickle.dumps(ref)
    flat = jds.flatten_worded_songs(worded)
    assert tds.flatten_worded_songs(worded) == flat
    for kw in (dict(max_seq_len=100), dict(max_seq_len=300, seed=9)):
        ours, ref = tds.process_data(flat, **kw), jds.process_data(flat, **kw)
        assert pickle.dumps(ours) == pickle.dumps(ref)
    for wrap in (True, False):
        for name in ("t", "j"):
            (tmp_path / name).mkdir(exist_ok=True)
            with open(tmp_path / name / "w.pickle", "wb") as f:
                pickle.dump({"train": worded} if wrap else worded, f)
        assert tds.split_data(str(tmp_path / "t" / "w.pickle"), seed=2) == \
            jds.split_data(str(tmp_path / "j" / "w.pickle"), seed=2)
        for part in ("train", "test"):
            name = f"worded_data_{part}.pickle"
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_parallel_encode_matches_sequential_and_jax(corpus):
    paths = _midis(corpus, broken=True)
    seq = tcp.build_cp_training_data(paths, seq_len=96, workers=1)
    par = tcp.build_cp_training_data(paths, seq_len=96, workers=2)
    ref = jcp.build_cp_training_data(paths, seq_len=96, workers=1)
    for a, b, c in zip(seq[:3], par[:3], ref[:3]):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert seq[3] == ref[3]
    no_type = tcp.build_cp_training_data(paths, seq_len=96, with_type=False,
                                         with_chords=False, workers=1)
    ref_nt = jcp.build_cp_training_data(paths, seq_len=96, with_type=False,
                                        with_chords=False, workers=1)
    for a, b in zip(no_type[:3], ref_nt[:3]):
        assert a.tobytes() == b.tobytes()
    assert tpe.tuple_extract_corpus(paths, workers=2) == \
        tpe.tuple_extract_corpus(paths, workers=1)


def test_native_helper_matches_jax(corpus):
    assert tnat.available()
    lib = tnat._lib_path()
    assert lib.parent.parts[-2:] == ("build", "native") and lib.exists()
    for path in _midis(corpus)[:3]:
        ours, ref = tnat.parse_midi(path), jnat.parse_midi(path)
        for a, b in zip(ours[:2], ref[:2]):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].tobytes() == b[k].tobytes()
        assert ours[2] == ref[2]
    rng = np.random.default_rng(0)
    start = rng.integers(0, 20000, 300).astype(np.int32)
    end = start + rng.integers(1, 2000, 300).astype(np.int32)
    for a, b in zip(tnat.quantize(start, end), jnat.quantize(start, end)):
        assert a.tobytes() == b.tobytes()
    order = np.argsort(start, kind="stable")
    s, e = (x[order] // 120 * 120 for x in (start, end))
    pitch = rng.integers(22, 108, 300).astype(np.int16)
    vel = rng.integers(1, 127, 300).astype(np.int16)
    bpm = rng.uniform(40, 220, int(e.max() // 480) + 1)
    for a, b in zip(tnat.encode_tuple_words(s, e, pitch, vel, bpm),
                    jnat.encode_tuple_words(s, e, pitch, vel, bpm)):
        assert a.tobytes() == b.tobytes()


def test_native_falls_back_to_python(monkeypatch):
    """RLMG_NO_NATIVE: the quantizer's Python path, as the JAX module's."""
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_tried", False)
    monkeypatch.setenv("RLMG_NO_NATIVE", "1")
    assert not tnat.available()
    start = np.array([0, 59, 61, 179, 1000], np.int32)
    end = start + 200
    got = tnat.quantize(start, end)
    monkeypatch.setattr(jnat, "_lib", None)
    monkeypatch.setattr(jnat, "_tried", False)
    ref = jnat.quantize(start, end)
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(RuntimeError):
        tnat.encode_tuple_words(start, end, start.astype(np.int16), start.astype(np.int16),
                                np.ones(4))
