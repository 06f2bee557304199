"""The tiny shapes at which the CPU tests drive the harness."""

from portbench.harness import cell as cell_lib

TINY = {"n_nodes_max": 512, "n_edges_max": 1024, "max_clusters": 128, "max_particles": 128,
        "latent": 32, "n_interaction_graph_iters": 2, "n_hierarchical_graph_iters": 2,
        "knn": 10}


def tiny_cell(name: str, **hp):
    """The cell ``name`` at tiny shapes (``shrink``)."""
    return shrink(cell_lib.load(name), **hp)


def shrink(cell, **hp):
    """``cell`` at tiny shapes: a pool of 3 events of 40 particles (so that
    a short window steps through each), and ``hp`` over the
    configuration."""
    cell.hp.update(TINY, **hp)
    cell.traffic.update({"n_particles": 40, "pool_events": 3})
    return cell
