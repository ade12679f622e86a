"""Parallelism of the port (counterpart of ``blurr_tpu/parallel``).

``mesh.py``: the ranks (one process each, ``torch.distributed``), the
(data, model) mesh, the tensor-parallel rule table, ``shard_params`` and the
collectives; ``tensor_parallel.py``: the TP linears and the vocabulary-split
embedding that carry the rules out, which the servers and the open-loop
evaluator run. ``train.py``: the training step on one card. M14's training
half (data, tensor and FSDP training steps, sequence parallelism and ring
attention, the GPipe pipeline, ``init_multihost``) is ROADMAP Queue 1 item
6b."""
