"""One process of tests/test_torch_distributed.py: the port's ``data`` axis
over a ``torch.distributed`` group of CPU processes (gloo).

    python tests/_torch_distributed_worker.py <process> <n_processes> <store> <dir>

The processes meet through the ``file://`` store ``<store>`` (which must not
exist yet); ``<dir>`` holds the parent's ``ec_in_variables.npz`` (the JAX
EC-IN's flax variables) and receives ``<check>_<process>.npz``, each
process's state after a step.  Every process generates the same events and
keeps only its own.  One line ``RESULT {json}`` per check goes to stdout.
The checks, in order:

  * ``mesh``: the global mesh of 2 graph ranks a process is ``{data 2,
    graph 2}``; ``make_mesh`` of 2 events a process is ``{data 4, graph
    1}``; ``make_mesh`` and ``make_global_mesh`` raise where they must;
  * ``dp``: EC-IN ``make_dp_train_step`` over ``{data 2}``, one event per
    process, through ``globalize_batch`` and ``replicate(check=True)``;
  * ``sharded``: EC-IN ``make_sharded_train_step`` over ``{data 2, graph 2}``;
  * ``tp``: EC-IN ``make_tp_train_step`` over ``{data 2, model 2}``;
  * ``bc``: BC-HGNN-GMM ``make_dp_train_step`` over ``{data 2}`` at epoch 50;
  * ``drift``: ``assert_host_identical`` on BC's state, then again after the
    last process moved one element of one parameter by one ulp;
  * ``thread``: a cross-process gather from a rank thread is refused.
"""

import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_parallel.py's TINY (the test file checks that they are equal)
TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 1,
        "n_hierarchical_graph_iters": 1, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "train_split": [4, 2, 2], "warmup": 2, "use_pallas": False,
        "compute_dtype": "float32"}
N_THREADS = 1         # torch's intra-op threads, the same in the parent
STEPS_PER_EPOCH = 2   # the JAX oracle's make_optimizer(hparams, 2)
BC_EPOCH = 50         # of emb_epoch 100: both of BC's losses carry weight
GROUP_TIMEOUT_S = 120
DATA_SEED, N_PARTICLES = 5, 12  # tests/test_distributed.py's events


def flat(tree, prefix=""):
    """Nested dicts of arrays or tensors -> {"a/b": numpy array}."""
    import numpy as np
    import torch

    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flat(value, path))
        elif isinstance(value, torch.Tensor):
            out[path] = value.detach().cpu().numpy()
        else:
            out[path] = np.asarray(value)
    return out


def nested(arrays):
    """The inverse of :func:`flat`."""
    out = {}
    for path, value in arrays.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def report(**fields):
    print("RESULT " + json.dumps(fields), flush=True)


def exact(metrics):
    """Every metric of a step, exactly (as float hex)."""
    return {k: float(v).hex() for k, v in metrics.items()}


def main(process, world, store, out_dir):
    import numpy as np
    import torch

    from hierarchicalgnn_torch import convert
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_dataset
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.parallel import distributed, tp
    from hierarchicalgnn_torch.parallel.comm import run_sharded
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
    from hierarchicalgnn_torch.parallel.mesh import batch_sharding, make_mesh
    from hierarchicalgnn_torch.parallel.step import make_dp_train_step, stack_events
    from hierarchicalgnn_torch.train.checkpoint import train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer
    from hierarchicalgnn_torch.train.pipelines import event_to

    torch.set_num_threads(N_THREADS)
    group = distributed.initialize(init_method=f"file://{store}", num_processes=world,
                                   process_id=process, device="cpu",
                                   timeout_s=GROUP_TIMEOUT_S)
    raws = generate_dataset(world, seed=DATA_SEED, n_particles=N_PARTICLES)
    variables = nested(dict(np.load(os.path.join(out_dir, "ec_in_variables.npz"))))

    def save(check, state):
        np.savez(os.path.join(out_dir, f"{check}_{process}.npz"), **flat(state))

    # the mesh
    mesh = distributed.make_global_mesh(graph_per_host=2)
    refused = {}
    for label, make in (("make_mesh 3 over 2 processes", lambda: make_mesh(3, 1, group)),
                        ("make_mesh 1 over 2 processes", lambda: make_mesh(1, 2, group)),
                        ("graph_per_host 0", lambda: distributed.make_global_mesh(0))):
        try:
            make()
            refused[label] = False
        except ValueError:
            refused[label] = True
    wide = make_mesh(4, 1, group)  # two events a process
    report(check="mesh", shape=mesh.shape, world=mesh.world_size, process=mesh.process,
           local_events=mesh.local_events, offset=mesh.offset, refused=refused,
           wide=wide.shape, wide_local=[wide.local_events, wide.offset])

    def ec_in():
        hp, model, pipeline = model_selector("EC-IN", TINY)
        convert.load_jax_variables(model, variables)
        event = event_to(preprocess_event(raws[process], hp), "cpu")
        optimizer = make_optimizer(list(model.parameters()), hp, STEPS_PER_EPOCH)
        return hp, model, pipeline, optimizer, event

    def local_batch(event, mesh):
        return distributed.globalize_batch(stack_events([event]), batch_sharding(mesh))

    # the DP step over the processes
    hp, model, pipeline, optimizer, event = ec_in()
    mesh = distributed.make_global_mesh()
    batch = local_batch(event, mesh)
    distributed.replicate(train_state(model, optimizer), mesh, check=True)
    metrics = make_dp_train_step(pipeline, optimizer, mesh)(batch, 0)
    state = train_state(model, optimizer)
    distributed.assert_host_identical(state, "EC-IN DP state")
    save("dp", {"state": state, "flax": convert.to_jax_variables(model)["params"]})
    report(check="dp", mesh=mesh.shape, offset=batch.offset, count=batch.count,
           loss=float(distributed.read_replicated(metrics["training_loss"])).hex(),
           metrics=exact(metrics))

    # the graph-sharded step: data over the processes, graph over 2 threads each
    hp, model, pipeline, optimizer, event = ec_in()
    mesh = distributed.make_global_mesh(graph_per_host=2)
    step = make_sharded_train_step(pipeline, optimizer, mesh, hp, device="cpu")
    metrics = step(local_batch(event, mesh), 0)
    state = train_state(model, optimizer)
    distributed.assert_host_identical(state, "EC-IN sharded state")
    save("sharded", {"state": state, "flax": convert.to_jax_variables(model)["params"]})
    report(check="sharded", mesh=mesh.shape, loss=float(metrics["training_loss"]).hex(),
           metrics=exact(metrics),
           matching_spmd=step.matching_spmd, collectives=step.last_stats["collectives"],
           gathers=step.last_stats["process_gathers"],
           gather_bytes=step.last_stats["process_gather_bytes"])

    # the TP step: data over the processes, model over 2 threads each
    hp, model, pipeline, optimizer, event = ec_in()
    mesh = distributed.make_global_mesh()
    state, step = tp.make_tp_train_step(pipeline, optimizer, tp.make_tp_mesh(mesh, 2, hp["hidden"]),
                                        train_state(model, optimizer), hp["hidden"],
                                        device="cpu")
    state, metrics = step(state, local_batch(event, mesh), 0)
    distributed.assert_host_identical(state, "EC-IN TP state")
    save("tp", {"state": tp.unshard_state(state),
                "flax": convert.tp_to_jax_variables(model, state)["params"]})
    report(check="tp", loss=float(metrics["training_loss"]).hex(), metrics=exact(metrics),
           n_split=len(state.split),
           collectives=step.last_stats["collectives"])

    # BC: the buffers over the processes' events
    hp, model, pipeline = model_selector("BC-HGNN-GMM", TINY)
    event = event_to(preprocess_event(raws[process], hp), "cpu")
    optimizer = make_optimizer(list(model.parameters()), hp, STEPS_PER_EPOCH)
    mesh = distributed.make_global_mesh()
    metrics = make_dp_train_step(pipeline, optimizer, mesh)(local_batch(event, mesh), BC_EPOCH)
    state = train_state(model, optimizer)
    distributed.assert_host_identical(state, "BC DP state")
    save("bc", {"state": state})
    report(check="bc", loss=float(metrics["training_loss"]).hex(), metrics=exact(metrics),
           score_cut=float(metrics["score_cut"]),
           fingerprint=distributed.fingerprint(state).hex())

    # one ulp of one parameter in the last process
    distributed.assert_host_identical(state, "BC state before the drift")
    name = "ignn.node_encoder.linears.0.weight"
    if process == world - 1:
        p = state["params"][name].view(-1)
        p[3] = torch.nextafter(p[3], torch.tensor(float("inf")))
    try:
        distributed.assert_host_identical(state, "BC state after the drift")
        report(check="drift", raised=False)
    except ValueError as exc:
        report(check="drift", raised=True, message=str(exc))

    # a rank thread may not meet the other processes
    try:
        run_sharded(lambda comm: distributed.gather_from_processes(
            [torch.ones(2)], group), 2, device="cpu")
        report(check="thread", refused=False)
    except RuntimeError as exc:
        report(check="thread", refused=True, message=str(exc))

    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
