"""The port's CLI (``hierarchicalgnn_torch/run.py``) on the CPU.

Mirrors ``tests/test_cli.py`` with ``--device cpu``: train -> resume ->
test, and transfer BC -> gMRT; resume's fallback from ``last`` to
``autosave`` to ``best`` (``hierarchicalgnn_tpu/run.py:75-88``); and the
device policy: ``--help`` returns before the device lock, ``cuda`` without
a card raises.
"""

import json
import os
import shutil

import pytest
import torch

from hierarchicalgnn_torch import run as cli
from hierarchicalgnn_torch.train import checkpoint as ckpt
from hierarchicalgnn_torch.utils import device_lock

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_cli.py's TINY_SETS
TINY_SETS = [
    "--set", "n_nodes_max=512", "--set", "n_edges_max=2048",
    "--set", "max_clusters=128", "--set", "max_particles=128",
    "--set", "latent=16", "--set", "n_interaction_graph_iters=1",
    "--set", "n_hierarchical_graph_iters=1", "--set", "knn=5",
    "--set", "knn_block_size=256", "--set", "gmm_iters=10",
    "--set", "train_split=[3,1,1]", "--set", "warmup=2",
    "--set", "use_pallas=false", "--set", "compute_dtype=null",
]
COMMON = ["--synthetic-particles", "20", "--log-every-n-steps", "0", "--device", "cpu"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_resume_test(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    cli.main(["train", "--model", "1", "--run-dir", run_dir, "--max-epochs", "1"]
             + COMMON + TINY_SETS)
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == [
        "best", "hparams.json", "last"]
    assert ckpt.load_hparams(run_dir)["model"] == "EC-IN"

    cli.main(["resume", "--run-dir", run_dir, "--max-epochs", "2"] + COMMON + TINY_SETS)
    assert ckpt.restore_checkpoint(run_dir, "last")["epoch"] == 1

    cli.main(["test", "--run-dir", run_dir, "--checkpoint", "last"] + COMMON + TINY_SETS)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "track_eff" in metrics
    records = _records(run_dir)
    # the JAX run log's record kinds: sanity, steps, epochs, test
    assert records[0]["epoch"] == -1 and "sanity_val_loss" in records[0]
    assert [r["epoch"] for r in records if "val_loss" in r] == [0, 1]
    assert [r["step"] for r in records if "training_loss" in r] == [1, 2, 3, 4, 5, 6]
    assert records[-1]["step"] == -1 and "test_track_eff" in records[-1]


def test_cli_transfer(tmp_path):
    src, dst = str(tmp_path / "bc"), str(tmp_path / "gmrt")
    cli.main(["train", "--model", "4", "--run-dir", src, "--max-epochs", "1"]
             + COMMON + TINY_SETS)
    cli.main(["transfer", "--model", "5", "--run-dir", dst, "--source-run", src,
              "--checkpoint", "last", "--max-epochs", "1"] + COMMON + TINY_SETS)
    assert ckpt.load_hparams(dst)["model"] == "gMRT"
    moved = ckpt.restore_checkpoint(dst, "last")
    assert moved["epoch"] == 0 and moved["step"] == 3


@pytest.mark.parametrize("damage", ["missing", "truncated"])
def test_resume_falls_back_to_autosave_then_best(tmp_path, capsys, damage):
    run_dir = str(tmp_path / "run")
    cli.main(["train", "--model", "1", "--run-dir", run_dir, "--max-epochs", "1"]
             + COMMON + TINY_SETS)
    last = ckpt.checkpoint_path(run_dir, "last")
    shutil.copy(last, ckpt.checkpoint_path(run_dir, "autosave"))
    for fallback, epochs in (("autosave", 2), ("best", 3)):
        if damage == "missing":
            os.remove(last)
        else:
            with open(last, "r+b") as f:
                f.truncate(100)
        capsys.readouterr()
        cli.main(["resume", "--run-dir", run_dir, "--max-epochs", str(epochs)]
                 + COMMON + TINY_SETS)
        out = capsys.readouterr().out
        assert f"checkpoint 'last' missing, using {fallback!r} (epoch {epochs - 2})" in out
        assert ckpt.restore_checkpoint(run_dir, "last")["epoch"] == epochs - 1
        if fallback == "autosave":
            os.remove(ckpt.checkpoint_path(run_dir, "autosave"))
    # an explicit --checkpoint wins over last
    cli.main(["resume", "--run-dir", run_dir, "--checkpoint", "best", "--max-epochs", "4"]
             + COMMON + TINY_SETS)
    assert "missing" not in capsys.readouterr().out
    assert ckpt.restore_checkpoint(run_dir, "last")["epoch"] == 3
    for name in ("last", "best"):
        os.remove(ckpt.checkpoint_path(run_dir, name))
    with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
        cli.main(["resume", "--run-dir", run_dir, "--max-epochs", "2"] + COMMON + TINY_SETS)


def test_help_returns_before_the_device_lock_and_cuda_needs_a_card(monkeypatch, tmp_path):
    taken = []
    monkeypatch.setattr(device_lock, "acquire", lambda *a, **k: taken.append(a) or True)
    with pytest.raises(SystemExit) as info:
        cli.main(["train", "--help"])
    assert info.value.code == 0 and not taken
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--run-dir", str(tmp_path / "r")] + TINY_SETS)
    assert not taken and not (tmp_path / "r").exists()


def test_overrides_match_jax():
    from hierarchicalgnn_tpu import run as j_cli

    args = cli.argparse.Namespace(set=TINY_SETS[1::2] + ["input_dir=synthetic://x"])
    assert cli._overrides(args) == j_cli._overrides(args)
