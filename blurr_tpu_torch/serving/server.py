"""Action server for the port: the Pi-0 control step over TCP.

Counterpart of ``blurr_tpu/serving/server.py:ActionServer`` on its
single-request path (``max_batch == 1``): ``predict``, ``stats``,
``serve_forever``, ``stop`` and the connection handler. The wire protocol
(4-byte big-endian length + UTF-8 JSON, images as base64) is the port's copy
of the JAX package's (``serving/protocol.py``), so the JAX package's
``ActionClient`` and the port's own (``serving/client.py``) both drive this
server.

Each request: validate, tokenize the instruction (cached), move the image
to the device and normalize it there, draw the flow noise that JAX draws
for (seed, request index) (``ops/prng.py``), run the control step under
the device lock (``PiZero.infer_action``, or ``infer_action_naive`` when the
config sets ``use_prefix_kv_cache`` false, as the ``baseline`` preset
does), return the raw action chunk [horizon, action_dim]. An image of
any HxW (uint8, 3 channels) is accepted: one that is not ``image_size``
square goes through the Lanczos resize ladder first
(``utils/image.py:lanczos_resize_uint8``), as in the JAX server. Dynamic
batching, tensor/data parallelism, hot reload and backpressure are not
ported yet.
"""

from __future__ import annotations

import base64
import collections
import logging
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.processing import build_processor, process_images
from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.serving.protocol import ProtocolError, recv_msg, send_msg
from blurr_tpu_torch.utils.image import lanczos_resize_uint8

log = logging.getLogger(__name__)


class ActionServer:
    """Serves Pi-0 action chunks from the port's model on ``device``.

    ``checkpoint_path`` "random" (or None, "none", "") draws the weights on
    the device from a generator seeded with ``seed`` (the JAX server draws
    its random weights from ``PRNGKey(0)`` with JAX's init, so the two
    random-weight servers hold different weights; the noise of each request
    is JAX's). A path loads a reference ``.pt`` checkpoint
    (``checkpoint.load_checkpoint``) onto the device, cast to the model
    dtype, which follows the config's ``use_bf16``; an orbax directory
    raises ``NotImplementedError``. Then the quantization tiers of the
    config (action int8 / cached-fp / w8a8 / w4a8, vlm w8a8 / w4a8)
    quantize the weights in place on the device, in the order of the JAX
    ``_build_params``; the int8 KV cache is quantized in every control step.
    """

    def __init__(self, cfg, checkpoint_path: Optional[str] = "random", *, device,
                 seed: int = 42):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if cfg.get("use_bf16") else torch.float32
        self.seed = int(seed)
        self.model = PiZero(cfg, device=self.device, dtype=self.dtype)
        if str(checkpoint_path or "random").lower() in ("random", "none"):
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(self.seed)
            )
        else:
            load_checkpoint(self.model, str(checkpoint_path))
        self.model.enable_action_quantization()
        self.model.enable_vlm_quantization()
        self.model.eval()
        # the baseline / vanilla presets turn the prefix cache off
        self.prefix_cache = bool(cfg.get("use_prefix_kv_cache", True))
        self.processor = build_processor(cfg)
        self._image_size = int(cfg["vision"]["config"]["image_size"])
        self._proprio_dim = int(cfg["proprio_dim"])
        self._noise_shape = (
            1, self.model.spec.num_action_tokens, self.model.spec.action_dim
        )
        self._checkpoint_desc = str(checkpoint_path or "random")
        self._req_idx = 0
        self._lock = threading.Lock()  # device stream + request index
        self._tok_cache = {}
        self._tok_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._stats_lock = threading.Lock()
        self._t_start = time.monotonic()
        self._n_requests = 0
        self._n_errors = 0
        self._latencies_ms: "collections.deque[float]" = collections.deque(
            maxlen=4096
        )

    # ------------------------------------------------------------------

    def _tokens(self, instruction: str):
        with self._tok_lock:
            cached = self._tok_cache.get(instruction)
        if cached is None:
            out = self.processor.tokenize([instruction])
            cached = (out["input_ids"], out["attention_mask"])
            with self._tok_lock:
                if len(self._tok_cache) >= 1024:  # bound daemon memory
                    self._tok_cache.pop(next(iter(self._tok_cache)), None)
                self._tok_cache[instruction] = cached
        return cached

    def _prepare(self, image: np.ndarray, instruction: str, proprio):
        """Validate one request on the host and move it to the device:
        (ids, attention mask, pixel values, proprio), batch dim 1."""
        proprio = np.asarray(proprio, np.float32)
        if proprio.shape != (self._proprio_dim,):
            raise ValueError(
                f"proprio must have shape ({self._proprio_dim},), got "
                f"{proprio.shape}"
            )
        if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
            raise ValueError(f"image must be HxWx3 uint8, got {image.dtype} {image.shape}")
        size = self._image_size
        if image.shape[:2] != (size, size):
            # the resize ladder the env adapters use: the same pixels
            image = lanczos_resize_uint8(image, size, size)
        ids, am = self._tokens(instruction)
        dev = self.device
        chw = torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1)))
        px = process_images(chw[None].to(dev)).to(self.dtype)
        pr = torch.from_numpy(proprio[None, None]).to(dev, self.dtype)
        ids = torch.from_numpy(ids).to(dev, torch.long)
        am = torch.from_numpy(am).to(dev)
        return ids, am, px, pr

    def noise(self, request_idx: int) -> torch.Tensor:
        """The flow noise of request ``request_idx``, on the device: JAX's
        ``normal(fold_in(PRNGKey(seed), request_idx), (1, n_tok, act_dim),
        dtype)``, as ``blurr_tpu/agent/eval_agent.py:make_noise_infer``
        draws it."""
        key = prng.fold_in(prng.prng_key(self.seed), request_idx)
        return prng.normal(key, self._noise_shape, self.dtype, self.device)

    def _step(self, ids, am, px, pr, request_idx: int) -> np.ndarray:
        noise = self.noise(request_idx)
        infer = self.model.infer_action if self.prefix_cache else self.model.infer_action_naive
        actions = infer(ids, am, px, pr, noise)
        return actions[0].float().cpu().numpy()  # waits for the device

    def warmup(self) -> float:
        """Run one dummy request (builds the kernels on first use); returns
        the seconds it took. It does not count as a request."""
        t0 = time.monotonic()
        size = self._image_size
        inputs = self._prepare(
            np.zeros((size, size, 3), np.uint8), "warmup",
            [0.0] * self._proprio_dim,
        )
        with self._lock:
            self._step(*inputs, request_idx=0)
        return time.monotonic() - t0

    def predict(self, image: np.ndarray, instruction: str, proprio) -> np.ndarray:
        """One control step; counts requests and errors and records the
        end-to-end (prepare + device + fetch) latency for ``stats()``."""
        t0 = time.monotonic()
        try:
            inputs = self._prepare(image, instruction, proprio)
            with self._lock:
                idx = self._req_idx
                self._req_idx += 1
                result = self._step(*inputs, request_idx=idx)
        except Exception:
            with self._stats_lock:
                self._n_errors += 1
            raise
        with self._stats_lock:
            self._n_requests += 1
            self._latencies_ms.append((time.monotonic() - t0) * 1000.0)
        return result

    def stats(self) -> dict:
        """Server-side counters (JSON-safe); the health-check answer."""
        with self._stats_lock:
            lat = list(self._latencies_ms)
            n_req, n_err = self._n_requests, self._n_errors
            uptime = time.monotonic() - self._t_start
        out = {
            "requests_total": n_req,
            "errors_total": n_err,
            "uptime_s": round(uptime, 3),
            "max_batch": 1,
            "closed": self._closed,
            "latency_window": len(lat),
            "checkpoint": self._checkpoint_desc,
            "device": str(self.device),
        }
        if lat:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            out.update(
                latency_ms_p50=round(float(p50), 3),
                latency_ms_p95=round(float(p95), 3),
                latency_ms_p99=round(float(p99), 3),
                latency_ms_mean=round(float(np.mean(lat)), 3),
            )
        return out

    # ------------------------------------------------------------------

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8787,
                      ready_event: Optional[threading.Event] = None) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        log.info("ActionServer listening on %s:%d", host, self.port)
        if ready_event is not None:
            ready_event.set()
        try:
            while True:
                conn, _ = self._sock.accept()
                threading.Thread(
                    target=self._handle, args=(conn,), daemon=True
                ).start()
        except OSError:
            pass  # socket closed by stop()

    def stop(self) -> None:
        self._closed = True
        if self._sock is not None:
            try:  # wakes the accept() of serve_forever (close alone does not)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    req = recv_msg(conn)
                except ProtocolError as exc:
                    log.warning("protocol error from client: %s", exc)
                    try:
                        send_msg(conn, {"error": f"ProtocolError: {exc}"})
                    except OSError:
                        return
                    if not exc.recoverable:
                        return  # framing lost: drop the connection
                    continue
                except OSError:
                    return
                if req is None:
                    return
                try:
                    send_msg(conn, self._respond(req))
                except OSError:
                    return

    def _respond(self, req) -> dict:
        """The reply to one decoded request (errors become {"error": ...})."""
        if not isinstance(req, dict):
            return {"error": "request must be a JSON object, got "
                             f"{type(req).__name__}"}
        kind = req.get("kind", "predict")
        if kind == "stats":
            return self.stats()
        if kind != "predict":
            return {"error": f"unknown request kind: {kind!r}"}
        try:
            image = np.frombuffer(
                base64.b64decode(req["image"]), np.uint8
            ).reshape(tuple(req["image_shape"]))
            t0 = time.monotonic()
            actions = self.predict(image, req["instruction"], req["proprio"])
            return {
                "actions": actions.tolist(),
                "latency_ms": (time.monotonic() - t0) * 1000.0,
            }
        except Exception as exc:  # keep the connection alive
            log.exception("request failed")
            return {"error": f"{type(exc).__name__}: {exc}"}
