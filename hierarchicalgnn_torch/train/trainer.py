"""Training loop of the five models on one device.

Counterpart of ``hierarchicalgnn_tpu/train/trainer.py``:
  * deterministic dataset split: seed-42 shuffle, then seed-0 split
  * a train step: forward in training mode (buffer updates), the
    pipeline's loss (for BC and gMRT with the matching truth), backward
    through the kernels, clip, AdamW(amsgrad)
  * gradient accumulation (an int, or an ``{epoch: k}`` schedule)
  * per-epoch validation with the tracking metrics

    hparams, model, pipeline = model_selector("BC-HGNN-GMM")
    trainer = Trainer(hparams, model, pipeline)      # device="cuda"
    trainer.init_state(seed=0)
    history = trainer.fit(raw_events, max_epochs=2)

The model holds the parameters and buffers and the optimizer its moments,
so there is no separate train state.  Not ported yet: checkpoints and
resume, the streaming loader, phase timing, metric loggers, the numerics
sanitizer and every sharded branch.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from hierarchicalgnn_torch.data.event import Event, preprocess_event
from hierarchicalgnn_torch.evaluation.tracking import eval_metrics
from hierarchicalgnn_torch.train.optim import make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to
from hierarchicalgnn_torch.utils.device import resolve_device


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
    them.  ``device`` defaults to the card and raises without one."""

    def __init__(self, hparams: dict, model, pipeline,
                 device: str | torch.device = "cuda"):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.pipeline = pipeline
        self.optimizer = None
        self.last_stats: dict = {}   # host syncs and auction rounds of the last step
        self.step_log: list[dict] = []  # one record per optimizer step of fit()

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
    # steps
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Seeded weights, default buffers, zero optimizer moments."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.optimizer = make_optimizer(self.model.parameters(), self.hparams,
                                        self._steps_per_epoch())

    def _steps_per_epoch(self) -> int:
        return max(self.hparams["train_split"][0], 1)

    def _params(self):
        return list(self.model.parameters())

    def _forward_backward(self, batch: Event, epoch):
        """One training forward and backward.  Returns (grads, metrics):
        this event's gradients, one per parameter (None where the loss does
        not reach it), and the metrics as tensors, ``grad_norm`` (before
        any clipping) among them."""
        self.model.train()
        self.last_stats = {}
        loss, metrics = self.pipeline.loss(batch, epoch, stats=self.last_stats)
        grads = torch.autograd.grad(loss, self._params(), allow_unused=True)
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([g for g in grads if g is not None])))
        return grads, metrics

    def _apply(self, grads):
        for p, g in zip(self._params(), grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def _read_metrics(self, metrics: dict) -> dict:
        """The step's metrics as floats, read back as one stacked vector."""
        names = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                           device=self.device).reshape(())
                           for k in names])
        self.last_stats["host_syncs"] = self.last_stats.get("host_syncs", 0) + 1
        return dict(zip(names, vec.tolist()))

    def train_step(self, batch: Event, epoch) -> dict:
        """One optimizer step on one event; returns the pipeline's metrics
        (``training_loss`` and, by model, ``embedding_loss``,
        ``assignment_loss`` or ``intermediate_loss``, ``score_cut``,
        ``clusters``) and ``grad_norm``."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        grads, metrics = self._forward_backward(batch, epoch)
        self._apply(grads)
        return self._read_metrics(metrics)

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

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, raw_events: Sequence[dict], max_epochs: int | None = None,
            num_sanity_val_steps: int = 2, shuffle_seed: int = 0) -> list[dict]:
        """Train for ``max_epochs``; returns one validation record per epoch
        (with ``epoch_time``).  Continues from the current weights when
        ``init_state`` was already called."""
        hp = self.hparams
        max_epochs = max_epochs or hp["max_epochs"]
        trainset, valset, _ = self.make_datasets(raw_events)
        if self.optimizer is None:
            self.init_state(seed=int(hp.get("init_seed") or 0))
        if num_sanity_val_steps:
            self.validate(valset[:num_sanity_val_steps], 0)

        accum = hp.get("accumulate_grad_batches") or 1

        def accum_for_epoch(epoch):
            if not isinstance(accum, dict):
                return int(accum)
            table = {int(k): int(v) for k, v in accum.items()}
            reached = [k for k in sorted(table) if k <= epoch]
            return table[reached[-1]] if reached else 1

        rng = np.random.default_rng(shuffle_seed)
        history = []
        for epoch in range(max_epochs):
            t0 = time.time()
            k = accum_for_epoch(epoch)
            acc, since, metrics = None, 0, None
            for i in rng.permutation(len(trainset)):
                grads, metrics = self._forward_backward(trainset[i][2], epoch)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self._params(), grads)]
                acc = grads if acc is None else torch._foreach_add(acc, grads)
                since += 1
                if since == k:
                    self._flush(acc, since, metrics, epoch)
                    acc, since = None, 0
            if since:  # the ragged tail
                self._flush(acc, since, metrics, epoch)
            val = self.validate(valset, epoch)
            val["epoch_time"] = time.time() - t0
            history.append(val)
        return history

    def _flush(self, acc, count, metrics, epoch):
        """Apply the mean of ``count`` accumulated gradients; log the last
        event's metrics."""
        self._apply(acc if count == 1 else torch._foreach_div(acc, float(count)))
        self.step_log.append({"epoch": epoch, **self._read_metrics(metrics)})
