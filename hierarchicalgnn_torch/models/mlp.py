"""NN primitives: the MLP factory, the dim-matching layer and the masked
batch norm.

Counterpart of ``hierarchicalgnn_tpu/models/mlp.py``.  Numerics follow the
JAX package: exact (erf) GELU, LayerNorm eps 1e-5, BatchNorm momentum 0.1 /
eps 1e-5 with unbiased running variance.
Initialisation follows the reference's ``kaiming_init``: zero biases,
N(0, 1/sqrt(fan_in)) for each MLP's first layer and N(0, sqrt(2)/sqrt(fan_in))
for the rest, drawn from an explicit ``torch.Generator``.

Tensor parallelism (``parallel/tp.py``): inside :func:`tensor_parallel`, an
``MLP`` or ``MatchDims`` that a rank runs reads this rank's shards from the
rank's :class:`TPBinding` and writes out the collectives that XLA's
partitioner derives in the JAX package: an all-gather of the column blocks
before a layer that needs its whole input, a ``psum`` after a row-split
layer, the LayerNorm moments over a split width by ``psum``.  Outside it
both run as they always did.  A binding without split leaves only places
the model: a graph-sharded rank on another card than the model's reads its
card's copies of the parameters through it (``parallel/graph_shard.py``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hierarchicalgnn_torch.models.buffers import placed, read_buffer, write_buffer
from hierarchicalgnn_torch.utils.device import torch_dtype

_ACTIVATIONS = {
    "GELU": lambda x: F.gelu(x, approximate="none"),
    "Tanh": torch.tanh,
    "ReLU": F.relu,
    "SiLU": F.silu,
    "Sigmoid": torch.sigmoid,
    "ELU": F.elu,
    "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}") from None


def _save_matmuls_context():
    """Selective-checkpoint context for ``remat: "dots"``: matmul outputs are
    saved, the elementwise tail (LayerNorm, activation) is recomputed."""
    from torch.utils import checkpoint as ckpt

    if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
        raise NotImplementedError(
            'remat "dots" needs torch.utils.checkpoint.'
            "create_selective_checkpoint_contexts, which this torch lacks")
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default, aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return ckpt.create_selective_checkpoint_contexts(policy)


def _check_remat(remat):
    if remat not in (True, False, "dots"):
        raise ValueError(f"remat must be True, False or 'dots', got {remat!r}")
    return remat


def _apply_remat(fn, remat, *args):
    """``fn(*args)``, recomputed in the backward pass per ``remat``."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        kwargs = {"context_fn": _save_matmuls_context} if remat == "dots" else {}
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

_TP = threading.local()


class TPBinding:
    """One ``model`` rank's view of the tensor-parallel layout: ``comm``, its
    handle on the rank group (``parallel/comm.py``), and ``leaves``, for each
    parameter of the model (by ``id``) the tensor this rank reads and the
    torch dim it is split on (None: the whole leaf, this rank's view of it)."""

    def __init__(self, comm, leaves: dict):
        self.comm = comm
        self.leaves = leaves

    def leaf(self, param):
        """(the tensor this rank reads for ``param``, its split dim or None)."""
        return self.leaves[id(param)]

    def block(self, x):
        """This rank's column block of the last dim of a whole ``x``."""
        width, n = x.shape[-1], self.comm.n_parts
        if width % n:
            raise ValueError(f"width {width} does not split over {n} ranks")
        return x.narrow(-1, self.comm.index * (width // n), width // n)


def bound(param):
    """The tensor the calling thread reads for ``param``: its rank's, inside
    :func:`tensor_parallel`, else ``param`` itself."""
    binding = getattr(_TP, "binding", None)
    return param if binding is None else binding.leaf(param)[0]


@contextlib.contextmanager
def tensor_parallel(binding: TPBinding):
    """Within the block, the calling thread's MLPs and MatchDims run as the
    rank of ``binding``."""
    previous = getattr(_TP, "binding", None)
    _TP.binding = binding
    try:
        yield binding
    finally:
        _TP.binding = previous


def _run_steps(steps, state, remat):
    """Run ``steps``, pairs (local, fn) with ``fn(*state) -> state``, on the
    tuple ``state``.  Each run of local steps between two collectives is one
    function, recomputed in the backward pass per ``remat``; the collectives
    stay outside every recomputed function (the recompute runs on the
    backward's thread, where no other rank waits at a rendezvous)."""
    segment = []

    def flush(state):
        if not segment:
            return state
        fns = tuple(segment)
        segment.clear()

        def run(*values):
            for fn in fns:
                values = fn(*values)
            return values

        return _apply_remat(run, remat, *state)

    for local, fn in steps:
        if local:
            segment.append(fn)
        else:
            state = fn(*flush(state))
    return flush(state)


class _TPLayers:
    """One rank's forward of an ``MLP`` or ``MatchDims`` under tensor
    parallelism, built layer by layer as steps between collectives.
    ``split`` says whether the activation at the end of the steps so far is
    this rank's column block of the features (else it is whole)."""

    def __init__(self, binding: TPBinding, dtype):
        self.tp, self.dtype = binding, dtype
        self.steps, self.split = [], False

    def local(self, fn):
        self.steps.append((True, fn))

    def whole(self):
        """All-gather the activation if it is split."""
        if self.split:
            gather = self.tp.comm.all_gather_features
            self.steps.append((False, lambda x: (gather(x),)))
            self.split = False

    def linear(self, lin: nn.Linear):
        """A column-split weight ``[out / M, in]`` takes a whole input and
        leaves this rank's block of the output; a row-split one ``[out, in /
        M]`` takes this rank's block of the input, its partial products are
        summed over the ranks (in f32) and the bias is added once, after the
        sum; a whole weight takes a whole input."""
        dtype = self.dtype
        w, dim = self.tp.leaf(lin.weight)
        b, _ = self.tp.leaf(lin.bias)
        if dim == 1:
            if not self.split:
                self.local(lambda x: (self.tp.block(x),))
            psum = self.tp.comm.psum
            self.local(lambda x: (F.linear(x, w.to(dtype)).float(),))
            self.steps.append((False, lambda part: (psum(part),)))
            self.local(lambda total: ((total + b.to(dtype).float()).to(dtype),))
            self.split = False
        else:
            self.whole()
            self.local(lambda x: (F.linear(x, w.to(dtype), b.to(dtype)),))
            self.split = dim == 0

    def norm(self, norm: nn.LayerNorm):
        """LayerNorm over the features.  Over a split width the mean and the
        variance come from ``psum``s of the ranks' partial sums in f32, then
        each rank applies its block of the scale and the bias."""
        dtype = self.dtype
        w, _ = self.tp.leaf(norm.weight)
        b, _ = self.tp.leaf(norm.bias)
        if not self.split:
            self.local(lambda x: (F.layer_norm(x, norm.normalized_shape, w.to(dtype),
                                               b.to(dtype), norm.eps),))
            return
        width, psum = norm.normalized_shape[0], self.tp.comm.psum
        self.local(lambda x: (x, x.float().sum(-1, keepdim=True)))
        self.steps.append((False, lambda x, s: (x, psum(s) / width)))
        self.local(lambda x, mean: (x, mean, (x.float() - mean).square().sum(-1, keepdim=True)))
        self.steps.append((False, lambda x, mean, ss: (x, mean, psum(ss) / width)))
        self.local(lambda x, mean, var: ((
            (x.float() - mean) * torch.rsqrt(var + norm.eps) * w.to(dtype).float()
            + b.to(dtype).float()).to(dtype),))

    def act(self, fn):
        self.local(lambda x: (fn(x),))

    def __call__(self, x, remat):
        self.whole()
        return _run_steps(self.steps, (x,), remat)[0]


class MLP(nn.Module):
    """``Linear -> [LayerNorm] -> act`` x (L-1) -> ``Linear [-> LN -> act]``.

    ``hidden_layers`` counts Linear layers; ``output_activation=None`` drops
    the trailing norm and activation.  With ``compute_dtype`` set
    ("bfloat16"), weights and activations are cast to it and the result
    returns in the input's dtype (``mlp.py:105-129``); without it the MLP
    computes and returns f32.

    ``remat`` (the JAX package's ``maybe_remat``): ``True`` recomputes the
    whole MLP in the backward pass (``torch.utils.checkpoint``), ``"dots"``
    saves the matmul outputs and recomputes the rest, ``False`` saves
    everything.  It changes memory and time, never the result.
    """

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 hidden_layers: int, hidden_activation: str = "GELU",
                 output_activation: Optional[str] = "GELU",
                 layer_norm: bool = False, compute_dtype: Optional[str] = None,
                 remat: bool | str = False):
        super().__init__()
        self.remat = _check_remat(remat)
        sizes = [input_size] + [hidden_size] * (hidden_layers - 1) + [output_size]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        n_norms = (hidden_layers - 1) + (output_activation is not None)
        self.norms = nn.ModuleList(
            nn.LayerNorm(sizes[i + 1], eps=1e-5) for i in range(n_norms)
        ) if layer_norm else nn.ModuleList()
        self.hidden_act = activation(hidden_activation)
        self.output_act = (activation(output_activation)
                           if output_activation is not None else None)
        self.compute_dtype = torch_dtype(compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Draws on the CPU from ``generator`` and copies to the weights'
        device, so a seed gives the same weights on any device."""
        for i, lin in enumerate(self.linears):
            scale = 1.0 if i == 0 else math.sqrt(2.0)
            with torch.no_grad():
                lin.weight.copy_(torch.empty(lin.weight.shape).normal_(
                    0.0, scale / math.sqrt(lin.in_features), generator=generator))
                lin.bias.zero_()
        for norm in self.norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _norm(self, i, x, dtype):
        norm = self.norms[i]
        return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                            norm.bias.to(dtype), norm.eps)

    def forward(self, x):
        binding = getattr(_TP, "binding", None)
        if binding is not None:
            return self._tp_forward(x, binding)
        return _apply_remat(self._forward, self.remat, x)

    def _tp_forward(self, x, binding: TPBinding):
        """:meth:`_forward` as one rank of the tensor-parallel group."""
        in_dtype = x.dtype
        dtype = self.compute_dtype or torch.float32
        layers = _TPLayers(binding, dtype)
        layers.local(lambda v: (v.to(dtype),))
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            layers.linear(lin)
            if i < last:
                if self.norms:
                    layers.norm(self.norms[i])
                layers.act(self.hidden_act)
        if self.output_act is not None:
            if self.norms:
                layers.norm(self.norms[last])
            layers.act(self.output_act)
        if self.compute_dtype is not None:
            layers.whole()
            layers.local(lambda v: (v.to(in_dtype),))
        return layers(x, self.remat)

    def _forward(self, x):
        in_dtype = x.dtype
        dtype = self.compute_dtype or torch.float32
        x = x.to(dtype)
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))
            if i < last:
                if self.norms:
                    x = self._norm(i, x, dtype)
                x = self.hidden_act(x)
        if self.output_act is not None:
            if self.norms:
                x = self._norm(last, x, dtype)
            x = self.output_act(x)
        return x.to(in_dtype) if self.compute_dtype is not None else x


class MatchDims(nn.Module):
    """One ``Linear -> [LayerNorm] -> [activation]`` in f32: the gMRT cheap
    encoder (``mlp.py:147-163`` of the JAX package).  It has no compute
    dtype; its weight draws like an MLP's first layer."""

    def __init__(self, input_size: int, output_size: int,
                 output_activation: Optional[str] = "GELU",
                 layer_norm: bool = False, remat: bool | str = False):
        super().__init__()
        self.remat = _check_remat(remat)
        self.linear = nn.Linear(input_size, output_size)
        self.norm = nn.LayerNorm(output_size, eps=1e-5) if layer_norm else None
        self.output_act = (activation(output_activation)
                           if output_activation is not None else None)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded like :meth:`MLP.reset_parameters` (drawn on the CPU)."""
        with torch.no_grad():
            self.linear.weight.copy_(torch.empty(self.linear.weight.shape).normal_(
                0.0, 1.0 / math.sqrt(self.linear.in_features), generator=generator))
            self.linear.bias.zero_()
        if self.norm is not None:
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)

    def forward(self, x):
        binding = getattr(_TP, "binding", None)
        if binding is not None:
            layers = _TPLayers(binding, torch.float32)
            layers.linear(self.linear)
            if self.norm is not None:
                layers.norm(self.norm)
            if self.output_act is not None:
                layers.act(self.output_act)
            return layers(x, self.remat)
        return _apply_remat(self._forward, self.remat, x)

    def _forward(self, x):
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.output_act(x) if self.output_act is not None else x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over a masked 1-D batch of scalars (``mlp.py:166-212``).

    Training mode normalizes with the batch statistics of the unmasked
    entries and updates the running buffers (momentum 0.1, unbiased
    variance; ``models/buffers.py``); eval mode uses the running statistics.
    ``comm``: the batch is split over the ranks of a shard group
    (``parallel/comm.py``); the moments of a training batch are then summed
    over the ranks (``mlp.py:180-200`` of the JAX package), so every rank
    normalizes with the whole batch's statistics.
    """

    def __init__(self, momentum: float = 0.1, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))
        self.register_buffer("running_mean", torch.zeros(1))
        self.register_buffer("running_var", torch.ones(1))

    def forward(self, x, mask=None, training: bool = False, comm=None):
        if training:
            psum = comm.psum if comm is not None else (lambda v: v)
            w = mask.float()
            count, total = psum(torch.stack([torch.sum(w), torch.sum(w * x)]))
            n = torch.clamp(count, min=1.0)
            mean = total / n
            var = psum(torch.sum(w * torch.square(x - mean))) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                m = self.momentum
                write_buffer(self.running_mean,
                             read_buffer(self.running_mean) * (1 - m) + m * mean)
                write_buffer(self.running_var,
                             read_buffer(self.running_var) * (1 - m) + m * unbiased)
        else:
            mean, var = placed(self.running_mean)[0], placed(self.running_var)[0]
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * bound(self.scale)[0] + bound(self.bias)[0]
