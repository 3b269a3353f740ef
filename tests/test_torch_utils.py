"""The port's ``utils`` against the JAX package's, on the CPU: the exported
names (JAX's, the three orbax names among them: the port's sharded
checkpoint, tests/test_torch_checkpoint.py), ``expio``'s files byte for byte,
``load_params_lenient`` on a JAX-written pickle checkpoint, the two
plotting helpers, and ``profile_trace`` / ``summarize_trace`` on a CPU
capture (``torch.profiler``: the host's operator rows)."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import utils as tu
from reinforcement_learning_in_music_generation_torch.utils import saver as tsv
from reinforcement_learning_in_music_generation_tpu import utils as ju
from reinforcement_learning_in_music_generation_tpu.utils import checkpoint as jck

ORBAX = {"load_checkpoint_orbax", "save_checkpoint_orbax", "wait_for_checkpoints"}


def test_utils_exports_the_jax_names_but_orbax():
    assert set(tu.__all__) == set(ju.__all__) and ORBAX <= set(tu.__all__)
    assert all(callable(getattr(tu, n)) for n in tu.__all__ if n != "expio")


def test_expio_files_are_byte_equal_to_jax(tmp_path):
    for pkg in ("jax", "torch"):
        io = ju.expio if pkg == "jax" else tu.expio
        d = tmp_path / pkg
        io.write_config_log(str(d / "cfg.log"), "pretrain", "linear", 3, 4, 1e-4, dropout=0.1,
                            seed=7)
        for epoch, better in ((0, True), (1, False)):
            io.write_result_log(str(d / "result.log"), epoch, 3, 1.25 + epoch, 0.5, 0.25,
                                1.5, 1.75, better)
        io.write_csv(str(d / "pred" / "out.csv"), [("a.mid", "1"), ("b.mid", "0")])
    for name in ("cfg.log", "result.log", os.path.join("pred", "out.csv")):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    path = str(tmp_path / "torch" / "pred" / "out.csv")
    assert tu.expio.read_csv(path) == ju.expio.read_csv(path) == (["a.mid", "b.mid"], [1, 0])


def test_set_seed_seeds_numpy_python_and_torch():
    tu.expio.set_seed(11)
    ours = (np.random.random(), random.random(), torch.rand(2))
    np.random.seed(11)
    random.seed(11)
    torch.manual_seed(11)
    assert ours[0] == np.random.random() and ours[1] == random.random()
    assert torch.equal(ours[2], torch.rand(2))


def test_load_params_lenient_reads_a_jax_pickle(tmp_path):
    """Leaves whose key path and shape match take the checkpoint's values
    (in the template's dtype); a leaf of another shape and a leaf the
    checkpoint lacks keep the template's, as JAX's function gives."""
    rng = np.random.default_rng(0)
    saved = {"layers": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                        "b": rng.standard_normal(5).astype(np.float32)},
             "head": rng.standard_normal(4).astype(np.float32)}
    path = jck.save_checkpoint(str(tmp_path / "ck.pkl"), saved, step=3)
    template = {"layers": {"w": torch.zeros((2, 3)), "b": torch.zeros(4)},
                "head": torch.zeros(4, dtype=torch.bfloat16), "extra": torch.ones(2)}
    ours = tu.load_params_lenient(path, template)
    ref = ju.load_params_lenient(path, jax.tree_util.tree_map(lambda t: t.float().numpy(),
                                                              template))
    torch.testing.assert_close(ours["layers"]["w"], torch.from_numpy(saved["layers"]["w"]))
    assert torch.equal(ours["layers"]["b"], template["layers"]["b"])
    assert ours["head"].dtype == torch.bfloat16
    assert torch.equal(ours["head"], torch.from_numpy(saved["head"]).bfloat16())
    assert torch.equal(ours["extra"], template["extra"])
    for key in (("layers", "w"), ("layers", "b"), ("extra",)):
        a, b = ours, ref
        for k in key:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tri_loss_plot_and_make_loss_report_draw(tmp_path):
    tu.tri_loss_plot([1, 0.5], [0.9, 0.4], [2, 1], [3, 2], ["Expert", "Agent", "CE", "Total"],
                     str(tmp_path / "tri.png"))
    saver = tsv.Saver(str(tmp_path / "exp"))
    for step in range(1, 4):
        saver.add_summary("batch loss", 1.0 / step, step=step)
        saver.add_summary("epoch loss", 2.0 / step, step=step)
    saver.add_summary_msg("a line that is not a summary")
    saver.close()
    tu.make_loss_report(str(tmp_path / "exp" / "log.txt"), str(tmp_path / "loss.png"))
    for png in ("tri.png", "loss.png"):
        assert (tmp_path / png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plots_say_what_they_did_not_draw_without_matplotlib(monkeypatch, tmp_path, capsys):
    from reinforcement_learning_in_music_generation_torch.utils import plotting
    monkeypatch.setattr(plotting, "_plt", lambda path: print(f"{path} not drawn") or None)
    tu.tri_loss_plot([1], [1], [1], [1], ["a", "b", "c", "d"], str(tmp_path / "t.png"))
    log = tmp_path / "log.txt"
    log.write_text("batch loss | 1.0 | 1 | 0.1\n")
    tu.make_loss_report(str(log), str(tmp_path / "l.png"))
    assert not any(p.suffix == ".png" for p in tmp_path.iterdir())
    assert capsys.readouterr().out.count("not drawn") == 2


def test_profile_trace_and_summarize_trace_on_a_cpu_capture(tmp_path):
    x = torch.randn((64, 64))
    with tu.profile_trace(None):            # no log_dir: nothing is recorded
        x @ x
    assert not list(tmp_path.iterdir())
    with pytest.raises(FileNotFoundError):
        tu.summarize_trace(str(tmp_path))
    with tu.profile_trace(str(tmp_path)):
        for _ in range(2):
            torch.mm(x, x)
    rows = tu.summarize_trace(str(tmp_path), top=50, steps=2)
    kinds = {k: (us, n) for k, us, n in rows}
    assert kinds["aten::mm"][1] == 1.0 and kinds["aten::mm"][0] > 0
    assert [us for _, us, _ in rows] == sorted((us for _, us, _ in rows), reverse=True)
    assert len(tu.summarize_trace(str(tmp_path), top=1)) == 1
