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
          "inference")


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
