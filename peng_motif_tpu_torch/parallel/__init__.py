"""Data-parallel counting: shards of the corpus over a device mesh
(sharded.py), and over several processes joined by torch.distributed
(multihost.py).  Counting is the only phase that reads sequences, so
its integer reductions are the pipeline's entire communication
surface."""
