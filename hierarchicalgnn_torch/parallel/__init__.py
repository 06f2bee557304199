"""Parallel execution: the shard group (``comm``), the flat-IN halo
demonstration (``halo``), the partitioned forward and training step of the
five models (``graph_shard``), tensor parallelism (``tp``), the event-mean
step over a data axis (``step``), the ``{data, graph}`` mesh (``mesh``) and
the data axis over the processes of a ``torch.distributed`` group
(``distributed``)."""
