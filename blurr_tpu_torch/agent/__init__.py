"""Closed-loop evaluation of the port (counterpart of ``blurr_tpu/agent``)."""
