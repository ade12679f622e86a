"""Parallelism of the port (counterpart of ``blurr_tpu/parallel``).

``mesh.py``: the ranks (one process each, ``torch.distributed``), the
(data, seq, model) mesh, ``init_multihost``, the tensor-parallel rule
table, ``shard_params``, ``sp_constrain``, ``fsdp_dim`` and the
collectives with their differentiable forms (the point-to-point rotation
of ring attention among them); ``tensor_parallel.py``: the TP linears and
the vocabulary-split embedding that carry the rules out, for the servers,
the open-loop evaluator and training, and the sharded tensors' places in
the one-card tree; ``fsdp.py``: FSDP (ZeRO-3) over the data ranks, and the
one-card tree gathered from and cut into the ranks; ``pipeline.py``: the
(data, pipe) mesh, the stages' layers and the GPipe schedule;
``train.py``: the training step, on one card or over a mesh (data,
tensor, sequence and pipeline parallelism), and the ranks of a trainer.
Ring attention itself is ``ops/ring_attention.py``."""
