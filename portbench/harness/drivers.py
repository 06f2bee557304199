"""The two sides of a comparison: the port under test and the plain reference.

Each driver trains one model from the same raw events and the same initial
weights, and exposes what the comparison reads: a training step's loss, the
first gradient as the optimizer took it, the parameters.  ``PORT`` is the package under test;
``REFERENCE`` the frozen plain copy in ``portbench/reference/hgnn``, which
imports nothing of the port; the cell's model file builds its model and
loss (``reference_model``, ``reference_pipeline``).  ``dtype`` of a
reference driver is "float32" for the reference itself and
"float8_e4m3fn" for the control.
"""

from __future__ import annotations

import importlib
import inspect

import numpy as np
import torch

from portbench.harness import weights

PORT = "hierarchicalgnn_torch"
REFERENCE = "portbench.reference.hgnn"


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def reference_hparams(hp: dict, dtype: str) -> dict:
    """``hp`` as the reference runs it: computed in ``dtype``, with nothing
    recomputed in the backward."""
    config = _mod(REFERENCE, "utils.config")
    return config.process_hparams({**hp, "compute_dtype": dtype, "remat": False})


def preprocess_rng(slot: int):
    """The generator a training event's preprocessing draws from (edge
    dropping is off in both configurations, so nothing draws from it)."""
    return np.random.default_rng(slot)


class _Train:
    """What both training drivers share: ``step``, ``first_gradient``,
    ``params`` and the stage owners."""

    root: str

    def owners(self) -> dict:
        hgnn = getattr(self.model, "hgnn", None)
        return {"clustering": (hgnn, "clustering")} if hgnn is not None else {}

    def batch(self, raw: dict, slot: int):
        ev = _mod(self.root, "data.event").preprocess_event(raw, self.hp, rng=preprocess_rng(slot))
        return _mod(self.root, "train.pipelines").event_to(ev, self.device)

    def first_gradient(self) -> dict:
        """The gradient of the first step as the optimizer took it (after
        clipping), from its first moment: mu = (1 - b1) g after one step.
        An optimizer that never stepped holds no moment: its gradient is 0."""
        opt = self.optimizer
        return {name: (opt.state[p]["mu"] / (1.0 - opt.b1)).cpu() if "mu" in opt.state[p]
                else torch.zeros(p.shape) for name, p in self.model.named_parameters()}

    def params(self) -> dict:
        return {name: p.detach().cpu().clone() for name, p in self.model.named_parameters()}


class PortTrain(_Train):
    """``Trainer.train_step`` of the port, the call the window drives."""

    root = PORT

    def __init__(self, hp: dict, device, seed: int):
        """``seed``: the seed the weights are drawn from."""
        from hierarchicalgnn_torch.models.registry import model_selector
        from hierarchicalgnn_torch.train.trainer import Trainer

        self.device = torch.device(device)
        self.hp, self.model, pipeline = model_selector(hp["model"], hp)
        self.trainer = Trainer(self.hp, self.model, pipeline, run_dir=None, device=device)
        self.trainer.init_state(0)
        weights.fill(self.model, seed)
        self.optimizer = self.trainer.optimizer

    def step(self, batch, epoch) -> dict:
        return self.trainer.train_step(batch, epoch)

    def save(self) -> dict:
        """The model's parameters and buffers, copied on the card."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def restore(self, state: dict):
        """Back to ``state`` (``save``) in place, the optimizer's moments
        zeroed and its count at 0, as a fresh optimizer holds them: the next
        steps repeat those taken from ``state``."""
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(state[k])
            for moments in self.optimizer.state.values():
                for t in moments.values():
                    t.zero_()
        self.optimizer.count = 0

    @property
    def last_stats(self) -> dict:
        return self.trainer.last_stats


class RefTrain(_Train):
    """The reference's step: forward, loss, gradient, clip, AdamW-amsgrad.
    ``model_file``: the cell's (``Cell.model``)."""

    root = REFERENCE

    def __init__(self, model_file, hp: dict, device, state: dict, dtype: str = "float32"):
        optim = _mod(REFERENCE, "train.optim")
        self.device = torch.device(device)
        self.hp = reference_hparams(hp, dtype)
        self.model = model_file.reference_model(self.hp).to(self.device)
        self.model.load_state_dict(state)
        self.pipeline = model_file.reference_pipeline(self.model, self.hp)
        self.optimizer = optim.make_optimizer(self.model.parameters(), self.hp,
                                              max(self.hp["train_split"][0], 1))
        self._apply = optim.apply_gradients
        self.last_stats: dict = {}

    def step(self, batch, epoch) -> dict:
        self.model.train()
        loss, _ = self.pipeline.loss(batch, epoch)
        params = list(self.model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self._apply(self.optimizer, params, grads)
        return {"training_loss": float(loss.detach())}


class ReferenceStages:
    """The reference's stage functions, for ``stages.stage_diffs``: each
    takes the program's recorded inputs.  ``model_file``: the cell's."""

    def __init__(self, model_file, hp: dict, device):
        self.hp = reference_hparams(hp, "float32")
        self.device = torch.device(device)
        self.knn = _mod(REFERENCE, "ops.knn").knn
        self.knn_graph = _mod(REFERENCE, "ops.knn").knn_graph
        self._model_file = model_file
        self._model = None

    def _block(self):
        if self._model is None:
            self._model = self._model_file.reference_model(self.hp).to(self.device)
        return self._model.hgnn

    def clustering(self, args, kwargs, score_cut):
        emb, graph, node_mask, _, _, training = args
        graph = _mod(REFERENCE, "ops.graph").Graph(*graph)
        plan = _mod(REFERENCE, "ops.sorted_agg").build_sorted_plan(
            graph.senders, graph.receivers, graph.edge_mask, emb.shape[0])
        block = self._block()
        with torch.no_grad():
            block.score_cut.copy_(score_cut)
        return block.clustering(emb, graph, node_mask, plan, None, training)

    def matching(self, args, kwargs, auction=None):
        """The reference's matching; ``auction``, where given, is the
        answer its auction gives in place of its own."""
        kwargs = {**kwargs, "stats": None}
        module = _mod(REFERENCE, "train.matching")
        if auction is None:
            return module.match_particles_to_candidates(*args, **kwargs)
        own = module.auction_match
        module.auction_match = lambda *a, **k: auction
        try:
            return module.match_particles_to_candidates(*args, **kwargs)
        finally:
            module.auction_match = own

    def auction(self, args, kwargs):
        kwargs = {**kwargs, "stats": None}
        return _mod(REFERENCE, "train.auction").auction_match(*args, **kwargs)

    def pair_scores_outside(self, args, kwargs, dense) -> int:
        """Entries of ``dense``, the program's ``[P_max, C_max]`` float32
        sums of a matching call's scores, that lie farther from the exact
        sum than float32's rounding allows in any order of the adds:
        ``(n - 1) u / (1 - (n - 1) u)`` of the sum of the magnitudes for n
        terms (u = 2^-24), and 2^-40 of it for the float64 sums' own
        rounding.  Every entry when the shapes differ."""
        matching = _mod(REFERENCE, "train.matching")
        a = inspect.signature(matching.match_particles_to_candidates).bind(*args, **kwargs)
        a = a.arguments
        c_max = int(a["max_clusters"])
        flat = a["pid_compact"].long()[a["bip_senders"]] * c_max + a["bip_receivers"]
        mask = a["bip_mask"]
        x = torch.where(mask, a["scores"].double(), 0.0)

        def sums(v):
            out = torch.zeros(a["particle_pid"].shape[0] * c_max, dtype=torch.float64,
                              device=v.device)
            return out.index_add_(0, flat, v).reshape(-1, c_max)

        exact, size, terms = sums(x), sums(x.abs()), sums(mask.double())
        if tuple(dense.shape) != tuple(exact.shape):
            return int(max(dense.numel(), exact.numel()))
        k = torch.clamp(terms - 1.0, min=0.0) * 2.0 ** -24
        bound = (k / (1.0 - k) + 2.0 ** -40) * size
        return int(torch.count_nonzero((dense.double() - exact).abs() > bound))
