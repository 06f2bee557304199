"""Graph-partitioned execution: the shard group (``comm``), the flat-IN halo
demonstration (``halo``) and the partitioned forward of the five models
(``graph_shard``)."""
