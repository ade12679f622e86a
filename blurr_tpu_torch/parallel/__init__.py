"""Training step of the port (one card). The meshes, tensor, sequence and
pipeline parallelism of ``blurr_tpu/parallel`` are ROADMAP M14."""
