"""One process of tests/test_torch_devices_run.py: the ``data`` axis over a
gloo group of CPU processes whose ``graph`` ranks are placed on devices.

    python tests/_torch_devices_worker.py <process> <n_processes> <store>

Each process takes its own event of the same two and runs EC-IN's
graph-sharded step over ``{data 2 across the processes, graph 2 in each}``
twice from the same start: once on ``make_global_mesh(2)`` (every rank on
the process's one device) and once on ``make_global_mesh(2, devices=["cpu",
"cpu"])`` (the placement path).  It prints one line ``RESULT {json}``: the
meshes' shapes and devices, and each step's loss (float hex) and state
fingerprint.
"""

import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
N_THREADS = 1


def main(process, world, store):
    import torch

    from _torch_distributed_worker import DATA_SEED, N_PARTICLES, STEPS_PER_EPOCH, TINY
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_dataset
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.parallel import distributed
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
    from hierarchicalgnn_torch.parallel.mesh import batch_sharding
    from hierarchicalgnn_torch.parallel.step import stack_events
    from hierarchicalgnn_torch.train.checkpoint import train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer
    from hierarchicalgnn_torch.train.pipelines import event_to

    torch.set_num_threads(N_THREADS)
    distributed.initialize(init_method=f"file://{store}", num_processes=world,
                           process_id=process, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    raws = generate_dataset(world, seed=DATA_SEED, n_particles=N_PARTICLES)
    result = {"process": process, "steps": {}}
    wide = distributed.make_global_mesh(2, devices=["cpu"] * 4)  # two events a process
    result["wide"] = [wide.shape, wide.local_events, wide.offset,
                      [[str(d) for d in row] for row in wide.devices]]
    for label, devices in (("none", None), ("cpu x 2", ["cpu", "cpu"])):
        hp, model, pipeline = model_selector("EC-IN", TINY)
        model.reset_parameters(torch.Generator().manual_seed(0))
        optimizer = make_optimizer(list(model.parameters()), hp, STEPS_PER_EPOCH)
        event = event_to(preprocess_event(raws[process], hp), "cpu")
        mesh = distributed.make_global_mesh(2, devices=devices)
        batch = distributed.globalize_batch(stack_events([event]), batch_sharding(mesh))
        distributed.replicate(train_state(model, optimizer), mesh, check=True)
        step = make_sharded_train_step(pipeline, optimizer, mesh, hp, device="cpu")
        metrics = step(batch, 0)
        state = train_state(model, optimizer)
        distributed.assert_host_identical(state, f"EC-IN sharded state, devices {label}")
        result["steps"][label] = {
            "mesh": mesh.shape, "local_events": mesh.local_events,
            "devices": None if mesh.devices is None else [[str(d) for d in row]
                                                          for row in mesh.devices],
            "loss": float(metrics["training_loss"]).hex(),
            "fingerprint": distributed.fingerprint(state).hex(),
            "gathers": step.last_stats["process_gathers"]}
    print("RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
