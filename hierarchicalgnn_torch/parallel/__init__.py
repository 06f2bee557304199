"""Graph-partitioned execution: the shard group (``comm``), the flat-IN halo
demonstration (``halo``), the partitioned forward and training step of the
five models (``graph_shard``) and the event-mean step over a data axis
(``step``)."""
