"""Parallelism of the port (counterpart of ``blurr_tpu/parallel``).

``mesh.py``: the ranks (one process each, ``torch.distributed``), the
(data, model) mesh, ``init_multihost``, the tensor-parallel rule table,
``shard_params``, ``fsdp_dim`` and the collectives with their
differentiable forms; ``tensor_parallel.py``: the TP linears and the
vocabulary-split embedding that carry the rules out, for the servers, the
open-loop evaluator and training, and the sharded tensors' places in the
one-card tree; ``fsdp.py``: FSDP (ZeRO-3) over the data ranks, and the
one-card tree gathered from and cut into the ranks; ``train.py``: the
training step, on one card or over a mesh, and the ranks of a trainer.
Sequence parallelism and ring attention, and the GPipe pipeline, are
ROADMAP Queue 1 item 6b part 2."""
