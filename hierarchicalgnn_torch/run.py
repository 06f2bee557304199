"""Command-line runner: train / resume / test / transfer.

Counterpart of ``hierarchicalgnn_tpu/run.py`` (the reference's
``Notebooks/script.py`` entry points ``main``, ``resume``,
``update``/``switch`` and ``test`` as one CLI):

  python -m hierarchicalgnn_torch.run train --model 4 --run-dir runs/bc
  python -m hierarchicalgnn_torch.run resume --run-dir runs/bc
  python -m hierarchicalgnn_torch.run test --run-dir runs/bc
  python -m hierarchicalgnn_torch.run transfer --run-dir runs/gmrt \\
      --source-run runs/bc --model 5

Every command runs on the card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs it on the CPU, where the JAX CLI reads
its platform from ``JAX_PLATFORMS``.  On the card the process first takes
the single-tenant device lock (``utils/device_lock.py``), after the
arguments are parsed, so ``--help`` never waits for it.  Data comes from
``--input-dir`` (a directory of event files, ``data/reader.py``) or the
synthetic generator when the config's ``input_dir`` is ``synthetic://``
(every shipped config).  The JAX CLI's persistent compile cache has no
counterpart: nothing here is compiled per program, and the CUDA kernels
are built once into ``build/`` by their sources' hashes.
"""

from __future__ import annotations

import argparse
import json

import torch


def _load_events(hparams, args):
    n_events = sum(hparams["train_split"])
    input_dir = args.input_dir or hparams.get("input_dir", "synthetic://")
    if str(input_dir).startswith("synthetic://"):
        from hierarchicalgnn_torch.data.synthetic import generate_dataset
        return generate_dataset(n_events, seed=42, n_particles=args.synthetic_particles)
    from hierarchicalgnn_torch.data.reader import load_event_dir
    return load_event_dir(input_dir, hparams["datatype_names"], limit=n_events)


def _overrides(args):
    o = {}
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        o[k] = v
    return o


def _build(args):
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.train.trainer import Trainer

    hparams, model, pipeline = model_selector(args.model, _overrides(args))
    trainer = Trainer(hparams, model, pipeline, run_dir=args.run_dir,
                      log_every_n_steps=args.log_every_n_steps, device=args.device)
    return hparams, trainer


def cmd_train(args):
    hparams, trainer = _build(args)
    trainer.fit(_load_events(hparams, args), max_epochs=args.max_epochs)


def cmd_resume(args):
    from hierarchicalgnn_torch.train.checkpoint import load_hparams

    args.model = load_hparams(args.run_dir)["model"]
    hparams, trainer = _build(args)
    events = _load_events(hparams, args)
    # the newest checkpoint first; fall back if, e.g., a kill destroyed
    # `last` (missing: FileNotFoundError, unreadable: ValueError)
    names = ["last", "autosave", "best"]
    if args.checkpoint:                 # an explicit --checkpoint wins
        names = [args.checkpoint] + [n for n in names if n != args.checkpoint]
    for name in names:
        try:
            epoch = trainer.restore(name)
            break
        except (FileNotFoundError, ValueError) as e:
            print(f"resume: checkpoint {name!r} unusable ({e}); trying next")
    else:
        raise FileNotFoundError(f"no restorable checkpoint in {args.run_dir} (tried {names})")
    if name != names[0]:
        print(f"resume: checkpoint {names[0]!r} missing, using {name!r} (epoch {epoch})")
    trainer.fit(events, max_epochs=args.max_epochs, start_epoch=epoch + 1)


def cmd_test(args):
    from hierarchicalgnn_torch.train.checkpoint import load_hparams

    args.model = load_hparams(args.run_dir)["model"]
    hparams, trainer = _build(args)
    events = _load_events(hparams, args)
    trainer.restore(args.checkpoint or "best")
    print(json.dumps(trainer.test(events)))


def cmd_transfer(args):
    """Initialise a model from another run's checkpoint (strict=False),
    e.g. gMRT <- a pretrained BC (reference ``script.py:53-173``)."""
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.train.checkpoint import (
        load_hparams, load_model_state, restore_checkpoint, transfer_params)

    hparams, trainer = _build(args)
    events = _load_events(hparams, args)
    trainer.init_state()
    # the source run's checkpoint in the source run's own model structure
    _, source, _ = model_selector(load_hparams(args.source_run)["model"], _overrides(args))
    load_model_state(source, restore_checkpoint(args.source_run, args.checkpoint or "best"))
    transfer_params(trainer.model, source, skip_prefixes=tuple(args.skip or []))
    trainer.fit(events, max_epochs=args.max_epochs)


def main(argv=None):
    p = argparse.ArgumentParser(prog="hierarchicalgnn_torch.run")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("train", cmd_train), ("resume", cmd_resume),
                     ("test", cmd_test), ("transfer", cmd_transfer)):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--model", default="4",
                        help="model name or ID 1-5 (default: 4 = BC-HGNN-GMM)")
        sp.add_argument("--run-dir", default="runs/run")
        sp.add_argument("--input-dir", default=None)
        sp.add_argument("--max-epochs", type=int, default=None)
        sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="hparam overrides (sweep configs)")
        sp.add_argument("--log-every-n-steps", type=int, default=50)
        sp.add_argument("--synthetic-particles", type=int, default=120)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
        # None: resume tries last, autosave, best in that order; test and
        # transfer take best.  An explicit value always wins.
        sp.add_argument("--checkpoint", default=None)
        if name == "transfer":
            sp.add_argument("--source-run", required=True)
            sp.add_argument("--skip", action="append",
                            help="parameter path prefixes to keep from init")
    # parse before taking the device lock: --help or a mistyped command
    # prints its usage at once instead of waiting behind a running job
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from hierarchicalgnn_torch.utils import device_lock
        from hierarchicalgnn_torch.utils.device import resolve_device

        resolve_device(args.device)
        device_lock.acquire(wait_s=6 * 3600.0, status=print)
    args.fn(args)


if __name__ == "__main__":
    main()
