"""Training loop of the five models on one device.

Counterpart of ``hierarchicalgnn_tpu/train/trainer.py``:
  * deterministic dataset split: seed-42 shuffle, then seed-0 split
  * a train step: forward in training mode (buffer updates), the
    pipeline's loss (for BC and gMRT with the matching truth), backward
    through the kernels, clip, AdamW(amsgrad)
  * gradient accumulation (an int, or an ``{epoch: k}`` schedule)
  * sanity validation before training, per-epoch validation with the
    tracking metrics, epoch time and (gMRT) phase times, a JSONL metric log
  * checkpoints: ``last`` every ``save_every_n_epochs``, ``best`` by
    ``track_eff``, ``autosave`` on any exception; ``restore``; ``test``
  * the ``debug_numerics`` guard; training from the native streaming loader

    hparams, model, pipeline = model_selector("BC-HGNN-GMM")
    trainer = Trainer(hparams, model, pipeline, run_dir="runs/bc")  # device="cuda"
    history = trainer.fit(raw_events, max_epochs=2)
    epoch = trainer.restore("last")                 # resume from the run
    trainer.fit(raw_events, max_epochs=4, start_epoch=epoch + 1)

The model holds the parameters and buffers and the optimizer its moments,
so the train state is the trainer's own; ``state_dict``/``load_state``
carry it as a checkpoint.

``mesh_shape`` routes the steps as in the JAX trainer (``trainer.py:253-277``):
with ``graph`` > 1 every training step is the graph-partitioned step
(``parallel/graph_shard.py::make_sharded_train_step``, ``graph`` ranks that
share the device, or run on ``devices`` as ``make_mesh`` places them), and
with ``data`` > 1 besides, each step takes ``data`` events (a ragged tail
repeats the last one).  ``data`` also sets the
schedule's steps per epoch, ⌈n_train / data⌉.
"""

from __future__ import annotations

import math
import time
import traceback
from typing import Sequence

import numpy as np
import torch

from hierarchicalgnn_torch.data.event import Event, preprocess_event
from hierarchicalgnn_torch.evaluation.tracking import eval_metrics
from hierarchicalgnn_torch.ops.graph import bidirectionalize
from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
from hierarchicalgnn_torch.parallel.mesh import make_mesh
from hierarchicalgnn_torch.train import checkpoint as ckpt_lib
from hierarchicalgnn_torch.train.optim import apply_gradients, make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to
from hierarchicalgnn_torch.utils.device import resolve_device
from hierarchicalgnn_torch.utils.logging import MetricLogger
from hierarchicalgnn_torch.utils.sanitize import finite_report


def split_dataset(events: Sequence, train_split: Sequence[int],
                  shuffle_seed: int = 42, split_seed: int = 0):
    """seed-42 shuffle, then a seed-0 permutation split (reference semantics)."""
    events = list(events)
    order = np.random.default_rng(shuffle_seed).permutation(len(events))
    events = [events[i] for i in order[: sum(train_split)]]
    order2 = np.random.default_rng(split_seed).permutation(len(events))
    n_train, n_val, _ = train_split
    train = [events[i] for i in order2[:n_train]]
    val = [events[i] for i in order2[n_train:n_train + n_val]]
    test = [events[i] for i in order2[n_train + n_val:]]
    return train, val, test


class Trainer:
    """``hparams``, ``model``, ``pipeline``: as ``model_selector`` returns
    them.  ``run_dir``: where ``metrics.jsonl`` and ``checkpoints/`` go
    (None: no file is written and no checkpoint saved).  ``device``
    defaults to the card and raises without one.  ``devices``: where the
    graph-partitioned step's ranks run (``parallel/mesh.py::make_mesh``'s
    ``devices``; None: all on ``device``); too few for ``mesh_shape``'s
    ``data x graph`` raise here, in the JAX mesh's words.  With ``graph`` 1
    no mesh is built (as in the JAX trainer) and ``devices`` is unused."""

    def __init__(self, hparams: dict, model, pipeline, run_dir: str | None = None,
                 log_every_n_steps: int = 50, device: str | torch.device = "cuda",
                 devices=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.devices = devices
        if devices is not None and self._mesh("graph") > 1:
            make_mesh(self._mesh("data"), self._mesh("graph"), devices=devices)
        self.model = model.to(self.device)
        self.pipeline = pipeline
        self.run_dir = run_dir
        self.logger = MetricLogger(run_dir, log_every_n_steps,
                                   wandb_project=hparams.get("wandb_project"))
        self.optimizer = None
        self._sharded = None         # the graph-partitioned step, under mesh_shape.graph > 1
        self.last_stats: dict = {}   # host syncs and auction rounds of the last step
        self.step_log: list[dict] = []  # one record per optimizer step of fit()
        self._cur_epoch = 0          # the epoch in flight, for the autosave
        self._probes = None

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def make_datasets(self, raw_events: Sequence[dict]):
        """Preprocess raw events once; returns (train, val, test) lists of
        (raw, host Event, Event on the device) triples."""
        rng = np.random.default_rng(12345)
        processed = []
        for raw in raw_events:
            ev = preprocess_event(raw, self.hparams, rng=rng)
            processed.append((raw, ev, event_to(ev, self.device)))
        return split_dataset(processed, self.hparams["train_split"])

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Seeded weights, default buffers, zero optimizer moments."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self._new_optimizer()

    def _new_optimizer(self):
        self.optimizer = make_optimizer(self.model.parameters(), self.hparams,
                                        self._steps_per_epoch())
        if self._mesh("graph") > 1:
            self._sharded = make_sharded_train_step(
                self.pipeline, self.optimizer, self.hparams["mesh_shape"], self.hparams,
                device=self.device, devices=self.devices)

    def _mesh(self, axis: str) -> int:
        """The size of ``mesh_shape``'s ``axis`` (1 without one)."""
        return int((self.hparams.get("mesh_shape") or {}).get(axis, 1) or 1)

    def _step_events(self) -> int:
        """Events a training step takes: ``data`` under the graph partition,
        else one (``trainer.py:265-266`` of the JAX package)."""
        return self._mesh("data") if self._sharded is not None else 1

    @property
    def step(self) -> int:
        """Optimizer steps taken (the checkpoint's ``step``)."""
        return 0 if self.optimizer is None else self.optimizer.count

    def state_dict(self, epoch: int) -> dict:
        """The whole train state as a checkpoint (copies on the CPU)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() or restore() before state_dict()")
        state = ckpt_lib.train_state(self.model, self.optimizer)
        state["epoch"] = int(epoch)
        return state

    def load_state(self, state: dict):
        """Parameters, buffers, optimizer moments and step from a
        checkpoint dict; raises ValueError if it is another model's."""
        ckpt_lib.load_model_state(self.model, state)
        self._new_optimizer()
        opt = state["opt_state"]
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {key: opt[key][name].to(self.device).clone()
                                       for key in ckpt_lib.MOMENTS}
        self.optimizer.count = int(opt["count"])

    def _save(self, name: str, epoch: int):
        if self.run_dir is not None:
            ckpt_lib.save_checkpoint(self.run_dir, name, self.state_dict(epoch), self.hparams)

    def restore(self, name: str) -> int:
        """Load ``run_dir/checkpoints/name`` into the model and optimizer;
        returns its epoch."""
        state = ckpt_lib.restore_checkpoint(self.run_dir, name)
        self.load_state(state)
        return int(state["epoch"])

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _steps_per_epoch(self) -> int:
        """⌈n_train / data⌉: with a data axis the fit loop takes ``data``
        events a step (``trainer.py:101-109`` of the JAX package)."""
        n = max(self.hparams["train_split"][0], 1)
        return max(-(-n // self._mesh("data")), 1)

    def _params(self):
        return list(self.model.parameters())

    def _forward_backward(self, batch, epoch):
        """One training forward and backward.  Returns (grads, metrics):
        this event's gradients, one per parameter (None where the loss does
        not reach it), and the metrics as tensors, ``grad_norm`` (before
        any clipping) among them.  Under ``mesh_shape.graph`` > 1 it is the
        graph-partitioned step's, over ``batch``'s ``data`` events."""
        if self._sharded is not None:
            grads, metrics = self._sharded.forward_backward(batch, epoch)
            self.last_stats = dict(self._sharded.last_stats)
            return grads, metrics
        self.model.train()
        self.last_stats = {}
        loss, metrics = self.pipeline.loss(batch, epoch, stats=self.last_stats)
        grads = torch.autograd.grad(loss, self._params(), allow_unused=True)
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([g for g in grads if g is not None])))
        return grads, metrics

    def _apply(self, grads):
        apply_gradients(self.optimizer, self._params(), grads)

    def _read_metrics(self, metrics: dict) -> dict:
        """The step's metrics as floats, read back as one stacked vector."""
        names = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                           device=self.device).reshape(())
                           for k in names])
        self.last_stats["host_syncs"] = self.last_stats.get("host_syncs", 0) + 1
        return dict(zip(names, vec.tolist()))

    def _check_numerics(self, values: dict, epoch):
        """The ``debug_numerics`` guard on a step's metrics (the values the
        step's one readback brought): a non-finite one saves ``autosave``
        and raises FloatingPointError naming the non-finite parameters and
        buffers."""
        if not self.hparams.get("debug_numerics") or all(map(math.isfinite, values.values())):
            return
        report = {"metrics": {k: v for k, v in values.items() if not math.isfinite(v)},
                  "params": finite_report(dict(self.model.named_parameters()), max_leaves=8),
                  "buffers": finite_report(dict(self.model.named_buffers()), max_leaves=8)}
        self._save("autosave", self._cur_epoch)
        raise FloatingPointError(f"non-finite training step (epoch {epoch}): {report}")

    def train_step(self, batch, epoch) -> dict:
        """One optimizer step on one event (under ``mesh_shape`` {data B,
        graph G > 1}: on a list of B events); returns the pipeline's metrics
        (``training_loss`` and, by model, ``embedding_loss``,
        ``assignment_loss`` or ``intermediate_loss``, ``score_cut``,
        ``clusters``, ``knn_exact``) and ``grad_norm``."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        grads, metrics = self._forward_backward(batch, epoch)
        self._apply(grads)
        values = self._read_metrics(metrics)
        self._check_numerics(values, epoch)
        return values

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _val_forward(self, batch: Event):
        self.model.eval()
        return self.model(batch.x, batch.graph, batch.node_mask)

    def evaluate_event(self, raw: dict, host_batch: Event, batch: Event, out=None):
        """Tracking metrics against the unmodified raw event, from the
        candidates of the model's own kind."""
        hp = self.hparams
        if out is None:
            out = self._val_forward(batch)
        bipartite = self.model.candidates(out, host_batch, hp)
        pid = np.asarray(raw["pid"])
        pt = np.asarray(raw["pt"]).copy()
        pt[pid == 0] = 0.0
        return eval_metrics(bipartite, pid, pt, primary=raw.get("primary"),
                            pt_cut=hp["ptcut"], nhits_cut=hp["n_hits"],
                            majority_cut=hp["majority_cut"], use_primary=False)

    @torch.no_grad()
    def validate(self, valset, epoch: int) -> dict:
        """One forward per event: the loss and the track candidates share
        its outputs.  Returns the means over ``valset``."""
        agg: dict[str, list] = {}
        for raw, host_batch, batch in valset:
            out = self._val_forward(batch)
            loss, _ = self.pipeline.loss_from_outputs(out, batch, epoch)
            rec = {"val_loss": float(loss),
                   **self.evaluate_event(raw, host_batch, batch, out=out)}
            for k, v in rec.items():
                agg.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def test(self, raw_events: Sequence[dict]) -> dict:
        """The validation metrics of the current weights on the test split,
        logged as ``test_*``."""
        _, _, testset = self.make_datasets(raw_events)
        metrics = self.validate(testset, epoch=10 ** 9)
        self.logger.log(metrics, step=-1, prefix="test_", force_print=True)
        return metrics

    def _phase_times(self, valset) -> dict:
        """Pooling and graph-construction times of the first validation
        event (reference ``gmrt_base.py:61-73``); on by default for gMRT,
        ``log_phase_times`` for the other hierarchical pipelines."""
        hp = self.hparams
        if not hp.get("log_phase_times", hp.get("model") == "gMRT") or not valset:
            return {}
        if self._probes is None:
            from hierarchicalgnn_torch.utils.phase_probe import PhaseProbes
            self._probes = PhaseProbes(hp)
        batch = valset[0][2]
        out = self._val_forward(batch)
        emb = out[2] if isinstance(out, tuple) else out
        return self._probes.measure(emb, bidirectionalize(batch.graph), batch.node_mask)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, raw_events: Sequence[dict], max_epochs: int | None = None,
            state: dict | None = None, start_epoch: int = 0,
            num_sanity_val_steps: int = 2, shuffle_seed: int = 0) -> list[dict]:
        """Train epochs ``start_epoch .. max_epochs - 1``; returns one
        validation record per epoch (with ``epoch_time``).  Starts from
        ``state`` (a checkpoint dict) when given, else from the current
        weights once ``init_state`` or ``restore`` ran, else from
        ``init_state(init_seed)``.  Any exception saves ``autosave`` (with
        the epoch in flight) and is re-raised."""
        hp = self.hparams
        max_epochs = max_epochs or hp["max_epochs"]
        trainset, valset, _ = self.make_datasets(raw_events)
        self._start_from(state)
        if num_sanity_val_steps:
            sanity = self.validate(valset[:num_sanity_val_steps], 0)
            self.logger.log(sanity, step=0, epoch=-1, prefix="sanity_", force_print=True)

        accum = hp.get("accumulate_grad_batches") or 1

        def accum_for_epoch(epoch):
            if not isinstance(accum, dict):
                return int(accum)
            table = {int(k): int(v) for k, v in accum.items()}
            reached = [k for k in sorted(table) if k <= epoch]
            return table[reached[-1]] if reached else 1

        rng = np.random.default_rng(shuffle_seed)
        self._cur_epoch = start_epoch
        try:
            return self._fit_epochs(trainset, valset, rng, start_epoch, max_epochs,
                                    accum_for_epoch)
        except (Exception, KeyboardInterrupt):
            self._autosave_safe()
            raise

    def _start_from(self, state):
        """A checkpoint dict when given, else the current weights once
        ``init_state`` or ``restore`` ran, else ``init_state(init_seed)``
        (the parameter-init seed of seed studies; the data split and shuffle
        seeds stay fixed)."""
        if state is not None:
            self.load_state(state)
        elif self.optimizer is None:
            self.init_state(seed=int(self.hparams.get("init_seed") or 0))

    def _autosave_safe(self):
        """The autosave of a failed fit; a failure of its own is printed and
        never masks the original error."""
        try:
            self._save("autosave", self._cur_epoch)
        except Exception:
            print("autosave-on-exception failed (continuing to re-raise the original "
                  "error):", flush=True)
            traceback.print_exc()

    def _fit_epochs(self, trainset, valset, rng, start_epoch, max_epochs, accum_for_epoch):
        save_every = int(self.hparams.get("save_every_n_epochs") or 1)
        best, history = -1.0, []
        bs = self._step_events()
        for epoch in range(start_epoch, max_epochs):
            self._cur_epoch = epoch
            t0 = time.time()
            k = accum_for_epoch(epoch)
            if k > 1 and bs > 1:
                # accumulation would bypass the data axis (trainer.py:474-480)
                raise ValueError("accumulate_grad_batches>1 is not supported with "
                                 "mesh_shape.data>1 (the accumulation path would bypass "
                                 "the data-sharded step)")
            acc, since, metrics = None, 0, None
            order = list(rng.permutation(len(trainset)))
            # ``bs`` events a step; a ragged tail repeats its last event
            # (trainer.py:449-466 of the JAX package)
            for j in range(0, len(order), bs):
                group = [trainset[i][2] for i in order[j:j + bs]]
                group += group[-1:] * (bs - len(group))
                grads, metrics = self._forward_backward(group if bs > 1 else group[0],
                                                        epoch)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self._params(), grads)]
                acc = grads if acc is None else torch._foreach_add(acc, grads)
                since += 1
                if since == k:
                    self._flush(acc, since, metrics, epoch)
                    acc, since = None, 0
            if since:  # the ragged tail
                self._flush(acc, since, metrics, epoch)
            val = self._end_epoch(valset, epoch, time.time() - t0, with_phase_times=True)
            history.append(val)
            # the final epoch always saves
            if (epoch + 1 - start_epoch) % save_every == 0 or epoch == max_epochs - 1:
                self._save("last", epoch)
            if val.get("track_eff", 0.0) >= best:
                best = val.get("track_eff", 0.0)
                self._save("best", epoch)
        return history

    def _end_epoch(self, valset, epoch, epoch_time, with_phase_times=False) -> dict:
        val = self.validate(valset, epoch)
        val["epoch_time"] = epoch_time
        if with_phase_times:
            try:
                val.update(self._phase_times(valset))
            except Exception:
                # the phase probes are a diagnostic: a failure is printed and
                # the run goes on, as in the JAX package
                print("phase-time probes failed (continuing):", flush=True)
                traceback.print_exc()
        self.logger.log(val, step=self.step, epoch=epoch, force_print=True)
        return val

    def _flush(self, acc, count, metrics, epoch):
        """Apply the mean of ``count`` accumulated gradients; log the last
        event's metrics."""
        self._apply(acc if count == 1 else torch._foreach_div(acc, float(count)))
        values = self._read_metrics(metrics)
        self._check_numerics(values, epoch)
        self.step_log.append({"epoch": epoch, **values})
        self.logger.log(values, step=self.step, epoch=epoch)

    def fit_streaming(self, train_paths: Sequence[str], val_events: Sequence[dict],
                      steps_per_epoch: int, max_epochs: int | None = None,
                      state: dict | None = None, n_threads: int = 4,
                      queue_capacity: int = 8, shuffle_seed: int = 0) -> list[dict]:
        """Train from the native prefetching loader (``data/native_loader.py``)
        instead of preloaded events: the large-dataset path.  One event per
        step (under ``mesh_shape`` {data B, graph G > 1}: B events),
        ``steps_per_epoch`` steps per epoch, then validation on
        ``val_events`` (raw event dicts), ``last`` every epoch and ``best``
        by ``track_eff``.  Returns one validation record per epoch."""
        from hierarchicalgnn_torch.data.native_loader import NativeEventLoader

        hp = self.hparams
        max_epochs = max_epochs or hp["max_epochs"]
        rng = np.random.default_rng(12345)
        valset = []
        for raw in val_events:
            ev = preprocess_event(raw, hp, rng=rng)
            valset.append((raw, ev, event_to(ev, self.device)))
        self._start_from(state)
        bs = self._step_events()
        best, history = -1.0, []
        with NativeEventLoader(list(train_paths), loop=True, n_threads=n_threads,
                               queue_capacity=queue_capacity,
                               shuffle_seed=shuffle_seed) as loader:
            for epoch in range(max_epochs):
                self._cur_epoch = epoch
                t0 = time.time()
                for _ in range(steps_per_epoch):
                    group = [event_to(preprocess_event(next(loader), hp, rng=rng),
                                      self.device) for _ in range(bs)]
                    metrics = self.train_step(group if bs > 1 else group[0], epoch)
                    self.logger.log(metrics, step=self.step, epoch=epoch)
                val = self._end_epoch(valset, epoch, time.time() - t0)
                history.append(val)
                self._save("last", epoch)
                if val.get("track_eff", 0.0) >= best:
                    best = val.get("track_eff", 0.0)
                    self._save("best", epoch)
        return history
