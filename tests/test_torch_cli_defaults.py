"""The port's command line against the JAX package's: every flag the two
parsers share has the same default, subcommand by subcommand (a port flag
that JAX lacks, ``--device``, is the port's own).  And the
``runtime_stats.json`` that ``generate`` writes: the port's copy of
``RuntimeStats`` against the JAX class on the same songs."""

import argparse
import json

import pytest

from reinforcement_learning_in_music_generation_torch.apps import cli as tcli
from reinforcement_learning_in_music_generation_torch.utils.metrics import RuntimeStats
from reinforcement_learning_in_music_generation_tpu.apps import cli as jcli
from reinforcement_learning_in_music_generation_tpu.utils import metrics as jmetrics

PORTED = ("generate", "pretrain", "discrim-pretrain", "my-pretrain", "dqn-train", "ppo-train",
          "inference", "serve", "prepare-data", "preprocess", "split-data", "data-midi")


def _subparsers(parser):
    return next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction)).choices


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.option_strings}


@pytest.mark.parametrize("cmd", PORTED)
def test_shared_flags_have_the_jax_defaults(cmd):
    ours = _defaults(_subparsers(tcli.build_parser())[cmd])
    ref = _defaults(_subparsers(jcli.build_parser())[cmd])
    shared = set(ours) & set(ref)
    assert shared and set(ours) - set(ref) <= {"device", "help"}
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}


def test_generate_dtype_defaults_to_bfloat16():
    args = tcli.build_parser().parse_args(["generate"])
    assert args.dtype == "bfloat16"


def test_serve_dtype_defaults_to_float32():
    """``serve`` keeps f32 weights by default, unlike ``generate``, as in JAX."""
    ours = tcli.build_parser().parse_args(["serve", "--requests", "r.jsonl"])
    ref = jcli.build_parser().parse_args(["serve", "--requests", "r.jsonl"])
    assert ours.dtype == ref.dtype == "float32"
    assert (ours.batch, ours.max_tokens, ours.poll) == (ref.batch, ref.max_tokens, ref.poll)


def test_generate_has_every_jax_flag():
    ours = set(_defaults(_subparsers(tcli.build_parser())["generate"]))
    ref = set(_defaults(_subparsers(jcli.build_parser())["generate"]))
    assert ref <= ours and {"prompt", "prompt_tokens", "continuous", "continuous_batch",
                            "dp", "tp"} <= ours


@pytest.mark.parametrize("flag", [["--prompt", "x.mid"], ["--greedy"], ["--dp", "2"],
                                  ["--tp", "2"]])
def test_continuous_refuses_what_jax_refuses(flag):
    args = ["generate", "--continuous", "--device", "cpu", "--layers", "1"] + flag
    with pytest.raises(SystemExit) as ours:
        tcli.main(args)
    assert "--continuous does not combine" in str(ours.value)


def test_runtime_stats_match_jax(tmp_path):
    songs = [(0.5, 120), (0.25, 64), (1.0, 333)]
    ours, ref = RuntimeStats(), jmetrics.RuntimeStats()
    for sec, n in songs:
        ours.add_song(sec, n)
        ref.add_song(sec, n)
    a = ours.dump(str(tmp_path / "ours.json"))
    b = ref.dump(str(tmp_path / "ref.json"))
    assert a == b
    with open(tmp_path / "ours.json") as f, open(tmp_path / "ref.json") as g:
        assert json.load(f) == json.load(g)
    assert list(a) == ["song_time", "words_len_list", "ave token time:", "ave song time"]
    assert RuntimeStats().dump(str(tmp_path / "empty.json"))["ave token time:"] == 0.0
