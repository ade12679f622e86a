"""Client for the action server's length-prefixed JSON protocol: the
port's own copy of ``blurr_tpu/serving/client.py:ActionClient``, without
``reload`` (the port's server has no hot reload yet)."""

from __future__ import annotations

import base64
import socket

import numpy as np

from blurr_tpu_torch.serving.protocol import recv_msg, send_msg


class ActionClient:
    """Blocking client; one connection, request/response in lockstep.
    Usable as a context manager: ``with ActionClient(port=p) as c: ...``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8787,
                 timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def __enter__(self) -> "ActionClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def predict(self, image: np.ndarray, instruction: str, proprio) -> np.ndarray:
        image = np.ascontiguousarray(image, np.uint8)
        send_msg(self.sock, {
            "instruction": instruction,
            "image": base64.b64encode(image.tobytes()).decode("ascii"),
            "image_shape": list(image.shape),
            "proprio": list(np.asarray(proprio, np.float64)),
        })
        return np.asarray(self._answer()["actions"], np.float32)

    def stats(self) -> dict:
        """Server-side observability snapshot ({"kind": "stats"} message);
        also serves as a health check — a live server always answers."""
        send_msg(self.sock, {"kind": "stats"})
        return self._answer()

    def _answer(self) -> dict:
        resp = recv_msg(self.sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    def close(self) -> None:
        self.sock.close()
