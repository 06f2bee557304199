"""Checkpoints of the port: save, restore, the best/last/autosave policy,
the numerics guard, ``Trainer.test`` and ``InferenceEngine.from_run``.

``hierarchicalgnn_torch/train/checkpoint.py`` and the checkpoint side of
``train/trainer.py`` against ``hierarchicalgnn_tpu/train/checkpoint.py``
and ``train/trainer.py:380-647``.  A restored checkpoint's next step is
held bit for bit on the CPU (tolerance 0: the same ops on the same values
in one process); ``hparams.json`` is held to the file the JAX
``save_checkpoint`` writes for the same hparams.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.data.synthetic import generate_dataset
from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.train import checkpoint as ckpt
from hierarchicalgnn_torch.train.trainer import Trainer

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_cli.py's TINY_SETS, f32
TINY = {"n_nodes_max": 512, "n_edges_max": 2048, "max_clusters": 128, "max_particles": 128,
        "latent": 16, "n_interaction_graph_iters": 1, "n_hierarchical_graph_iters": 1,
        "knn": 5, "knn_block_size": 256, "gmm_iters": 10, "train_split": [3, 1, 1],
        "warmup": 2, "use_pallas": False, "compute_dtype": None}


@pytest.fixture(scope="module")
def events():
    return generate_dataset(5, seed=42, n_particles=20)


def _trainer(run_dir, name="EC-IN", **extra):
    """EC-IN (no buffers, no auction) where the model does not matter; BC
    where buffers and optimizer moments of every kind must round-trip."""
    hp, model, pipeline = model_selector(name, {**TINY, **extra})
    return Trainer(hp, model, pipeline, run_dir=None if run_dir is None else str(run_dir),
                   log_every_n_steps=0, device="cpu")


def _snapshot(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_restore_gives_every_tensor_and_the_same_next_step(tmp_path, events):
    """save at step n, restore into a fresh trainer (another model object of
    other weights): every parameter, buffer, moment (``nu_max`` among them),
    the step and the epoch come back, and step n+1 is bitwise the step the
    saving trainer takes."""
    a = _trainer(tmp_path, "BC-HGNN-GMM")
    a.init_state(seed=3)
    trainset = a.make_datasets(events)[0]
    for _, _, batch in trainset[:2]:
        a.train_step(batch, 1)
    a._save("last", epoch=4)
    saved = a.state_dict(4)
    next_a = a.train_step(trainset[2][2], 1)
    after_a = _snapshot(a)

    b = _trainer(tmp_path, "BC-HGNN-GMM")
    b.init_state(seed=9)
    assert b.restore("last") == 4
    got = b.state_dict(4)
    assert got["step"] == saved["step"] == 2 and got["epoch"] == 4
    assert got["opt_state"]["count"] == 2
    for part in ("params", "buffers"):
        assert list(got[part]) == list(saved[part])
        for key, value in saved[part].items():
            assert torch.equal(got[part][key], value), (part, key)
    for key in ("mu", "nu", "nu_max"):
        for name, value in saved["opt_state"][key].items():
            assert torch.equal(got["opt_state"][key][name], value), (key, name)
    assert any(bool(v.any()) for v in saved["opt_state"]["nu_max"].values())
    assert {k for k, _ in b.model.named_buffers()} >= {
        "hgnn.score_cut", "hgnn.bipartite_graph_construction.knn_radius"}

    next_b = b.train_step(b.make_datasets(events)[0][2][2], 1)
    assert next_b == next_a
    after_b = _snapshot(b)
    assert all(torch.equal(after_a[k], after_b[k]) for k in after_a)


def test_fit_from_a_state_dict_equals_fit_that_goes_on(events):
    """``fit(state=...)`` starts from the checkpoint dict as if the trainer
    that made it went on."""
    a = _trainer(None)
    a.init_state(seed=1)
    a.fit(events, max_epochs=1, num_sanity_val_steps=0)
    state = a.state_dict(0)
    hist_a = a.fit(events, max_epochs=2, start_epoch=1, num_sanity_val_steps=0)
    b = _trainer(None)
    hist_b = b.fit(events, max_epochs=2, state=state, start_epoch=1, num_sanity_val_steps=0)
    for rec_a, rec_b in zip(hist_a, hist_b):
        rec_a.pop("epoch_time"), rec_b.pop("epoch_time")
        assert rec_a == rec_b
    assert a.step == b.step == 6
    snap_a, snap_b = _snapshot(a), _snapshot(b)
    assert all(torch.equal(snap_a[k], snap_b[k]) for k in snap_a)


def test_hparams_json_matches_jax(tmp_path):
    """``hparams.json`` holds what the JAX ``save_checkpoint`` writes for the
    same hparams: the same keys and values."""
    from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
    from hierarchicalgnn_tpu.train.checkpoint import save_checkpoint as j_save

    for name in ("BC-HGNN-GMM", "Embedding-IN"):
        hp_j = j_selector(name, TINY)[0]
        hp_t = model_selector(name, TINY)[0]
        j_save(str(tmp_path / "jax"), "last", {"step": np.zeros((), np.int32)}, hp_j)
        ckpt.save_checkpoint(str(tmp_path / "torch"), "last", {"step": 0}, hp_t)
        with open(tmp_path / "jax" / "checkpoints" / "hparams.json") as f:
            want = json.load(f)
        assert ckpt.load_hparams(str(tmp_path / "torch")) == want
        assert "model" in want and "train_split" in want


def test_save_is_atomic_and_restore_errors(tmp_path, events, monkeypatch):
    """A failed save leaves the previous file whole and no temporary file;
    a missing checkpoint raises FileNotFoundError, an unreadable one or one
    of another model ValueError (the errors ``resume`` falls back on)."""
    t = _trainer(tmp_path)
    t.init_state(seed=0)
    t._save("last", 0)
    before = open(ckpt.checkpoint_path(str(tmp_path), "last"), "rb").read()

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        t._save("last", 1)
    monkeypatch.undo()
    assert open(ckpt.checkpoint_path(str(tmp_path), "last"), "rb").read() == before
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["hparams.json", "last"]

    with pytest.raises(FileNotFoundError):
        t.restore("best")
    with open(ckpt.checkpoint_path(str(tmp_path), "autosave"), "wb") as f:
        f.write(before[: len(before) // 2])
    with pytest.raises(ValueError, match="unreadable"):
        t.restore("autosave")
    other = _trainer(tmp_path, latent=8)
    with pytest.raises(ValueError, match="do not match"):
        _trainer(tmp_path, "BC-HGNN-GMM").restore("last")
    with pytest.raises(ValueError, match="shape"):
        other.restore("last")


@pytest.mark.parametrize("save_every,start,end,want", [
    (1, 0, 3, [("best", 0), ("last", 0), ("last", 1), ("best", 2), ("last", 2)]),
    (2, 0, 3, [("best", 0), ("last", 1), ("best", 2), ("last", 2)]),
    # counted from start_epoch; the final epoch always saves
    (2, 1, 4, [("best", 1), ("last", 2), ("best", 3), ("last", 3)]),
])
def test_best_and_last_policy(events, monkeypatch, save_every, start, end, want):
    """``last`` every ``save_every_n_epochs`` counted from ``start_epoch`` and
    at the final epoch; ``best`` whenever ``track_eff`` >= the best so far
    (the validation metrics are scripted: 0.5, 0.4, 0.5 from the first
    epoch)."""
    t = _trainer(None, save_every_n_epochs=save_every)
    effs = iter([0.5, 0.4, 0.5])
    monkeypatch.setattr(t, "validate", lambda valset, epoch: {"track_eff": next(effs)})
    saves = []
    monkeypatch.setattr(t, "_save", lambda name, epoch: saves.append((name, epoch)))
    t.fit(events, max_epochs=end, start_epoch=start, num_sanity_val_steps=0)
    assert sorted(saves, key=lambda s: (s[1], s[0])) == sorted(want, key=lambda s: (s[1], s[0]))


@pytest.mark.parametrize("error", [RuntimeError("boom"), KeyboardInterrupt()])
def test_autosave_on_exception_records_the_epoch_in_flight(tmp_path, events, monkeypatch,
                                                           error):
    """An exception in epoch 1 (the 5th step) saves ``autosave`` with epoch 1
    and the state it had, then re-raises the original error."""
    t = _trainer(tmp_path)
    calls = []
    real = t._forward_backward

    def flaky(batch, epoch):
        calls.append(epoch)
        if len(calls) == 5:
            raise error
        return real(batch, epoch)

    monkeypatch.setattr(t, "_forward_backward", flaky)
    with pytest.raises(type(error)):
        t.fit(events, max_epochs=3, num_sanity_val_steps=0)
    assert calls[-1] == 1
    state = ckpt.restore_checkpoint(str(tmp_path), "autosave")
    assert state["epoch"] == 1 and state["step"] == 4
    live = dict(t.model.named_parameters())
    assert all(torch.equal(v, live[k].detach()) for k, v in state["params"].items())


def test_autosave_failure_never_masks_the_error(tmp_path, events, monkeypatch, capsys):
    t = _trainer(tmp_path)
    monkeypatch.setattr(t, "_forward_backward", lambda batch, epoch: 1 / 0)

    def no_disk(name, epoch):
        raise OSError("read-only")

    monkeypatch.setattr(t, "_save", no_disk)
    with pytest.raises(ZeroDivisionError):
        t.fit(events, max_epochs=1, num_sanity_val_steps=0)
    assert "autosave-on-exception failed" in capsys.readouterr().out


def test_debug_numerics_guard(tmp_path, events):
    """A poisoned weight makes the step's loss NaN: under ``debug_numerics``
    the step raises FloatingPointError naming the non-finite parameters and
    saves ``autosave``; without it the step returns the NaN."""
    for guard in (False, True):
        t = _trainer(tmp_path, debug_numerics=guard)
        t.init_state(seed=0)
        weight = next(p for p in t.model.parameters() if p.ndim == 2)
        with torch.no_grad():
            weight[0, 0] = float("nan")
        batch = t.make_datasets(events)[0][0][2]
        if not guard:
            assert math.isnan(t.train_step(batch, 0)["training_loss"])
            continue
        with pytest.raises(FloatingPointError, match="non-finite training step") as info:
            t.train_step(batch, 0)
        # the NaN spreads to every weight in the update: the report names up
        # to 8 of them
        msg = str(info.value)
        assert "'training_loss': nan" in msg and re.search(r"'params': \{\"\['", msg)
        assert ckpt.restore_checkpoint(str(tmp_path), "autosave")["step"] == 1


def test_trainer_test_logs_the_test_split(tmp_path, events):
    t = _trainer(tmp_path)
    t.init_state(seed=0)
    metrics = t.test(events)
    assert {"val_loss", "track_eff", "track_pur", "hit_eff", "hit_pur"} == set(metrics)
    last = json.loads(open(tmp_path / "metrics.jsonl").read().splitlines()[-1])
    assert last["step"] == -1 and last["test_track_eff"] == metrics["track_eff"]


def test_from_run_serves_the_saved_weights(tmp_path, events):
    """``InferenceEngine.from_run(device="cpu")`` rebuilds the model from
    ``hparams.json`` and loads the checkpoint's parameters and buffers: its
    eval forward equals the trainer's, and the buffers are the trained ones."""
    t = _trainer(tmp_path, "BC-HGNN-GMM")
    t.fit(events, max_epochs=1, num_sanity_val_steps=0)
    engine = InferenceEngine.from_run(str(tmp_path), "last", device="cpu")
    assert engine.device.type == "cpu" and engine.hparams["latent"] == 16
    trained = t.model.state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in engine.model.state_dict().items())
    assert float(engine.model.hgnn.score_cut) != float("inf")
    batch = t.make_datasets(events)[1][0][2]
    ours, theirs = t._val_forward(batch), engine.forward(batch)
    assert torch.equal(ours[1], theirs[1])  # bipartite scores
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_run(str(tmp_path), "autosave", device="cpu")
