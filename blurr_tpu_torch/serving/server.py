"""Action server for the port: the Pi-0 control step over TCP.

Counterpart of ``blurr_tpu/serving/server.py:ActionServer``: ``predict``,
dynamic batching, backpressure, hot reload, ``stats``, ``serve_forever``,
``stop`` and the connection handler. The wire protocol (4-byte big-endian
length + UTF-8 JSON, images as base64) is the port's copy of the JAX
package's (``serving/protocol.py``), so the JAX package's ``ActionClient``
and the port's own (``serving/client.py``) both drive this server.

Each request: validate, tokenize the instruction (cached), move the image
to the device and normalize it there (``_prepare``, in the caller's thread,
so a malformed request never fails a co-batched one). An image of any HxW
(uint8, 3 channels) is accepted: one that is not ``image_size`` square goes
through the Lanczos resize ladder first (``utils/image.py``), as in the JAX
server. Then the control step (``PiZero.infer_action``, or
``infer_action_naive`` when the config sets ``use_prefix_kv_cache`` false,
as the ``baseline`` preset does) with the flow noise JAX draws for (seed,
index) (``ops/prng.py``), under the device lock; the answer is the raw
action chunk [horizon, action_dim].

With ``max_batch`` 1 each request runs its own step, and the index counts
requests. With ``max_batch`` > 1 a batcher thread collects the requests
that arrive within ``batch_window_ms`` of the first, pads them to a bucket
(the next power of 2, or always ``max_batch`` under ``bucket_mode`` 'max')
by repeating the last request, and runs one step on the bucket; the index
then counts batches, and the bucket's noise is one draw of the bucket's
shape. ``max_queue`` > 0 rejects a request ("Overloaded") while that many
wait unclaimed. ``reload_checkpoint`` swaps the weights while serving.
Tensor and data parallelism (``tp`` / ``dp`` > 1) are not ported yet.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import gc
import logging
import queue
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


def refuse(**flags) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP milestone of the
    first flag ``name=(set, milestone)`` that is set."""
    for name, (bad, milestone) in flags.items():
        if bad:
            raise NotImplementedError(
                f"{name} is not ported to the PyTorch server yet (ROADMAP {milestone})")


def model_signature(model: torch.nn.Module) -> dict:
    """What a reloaded model must share with the served one: the name,
    shape and dtype of each tensor of its state dict, and the type of the
    module at each name (the quantized linears of ``ops/quant.py`` hold
    their tensors as buffers, so a type tells their layouts apart)."""
    return {
        "tensors": {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()},
        "modules": {k: type(m) for k, m in model.named_modules()},
    }


class _PendingRequest:
    """One enqueued request awaiting a batched device step."""

    __slots__ = ("inputs", "event", "result", "error", "claimed")

    def __init__(self, inputs):
        self.inputs = inputs
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        # set by the batcher the moment it dequeues the request: a claimed
        # request will complete (its batch is computing), so its caller keeps
        # waiting even through stop(); only unclaimed requests are abandoned
        self.claimed = False


class ActionServer:
    """Serves Pi-0 action chunks from the port's model on ``device``.

    ``checkpoint_path`` "random" (or None, "none", "") draws the weights on
    the device from a generator seeded with ``seed`` (the JAX server draws
    its random weights from ``PRNGKey(0)`` with JAX's init, so the two
    random-weight servers hold different weights; the noise of each step
    is JAX's). A path loads a reference ``.pt`` checkpoint
    (``checkpoint.load_checkpoint``) onto the device, cast to the model
    dtype, which follows the config's ``use_bf16``; a directory is a
    parameter tree of ``scripts/train_pi0_flow_torch.py --save-dir``
    (``checkpoint.restore_params``), its quantized linears and LoRA
    adapters rebuilt as saved (a QLoRA tree serves unmerged, its int4
    products through the int4 kernel), the scales kept fp32. Then the
    quantization tiers of the config (action int8 / cached-fp / w8a8 /
    w4a8, vlm w8a8 / w4a8) quantize the remaining ``nn.Linear``s in place on
    the device (an adapter or an already quantized linear is skipped, as
    JAX skips dicts), in the order of the JAX ``_build_params``; the int8
    KV cache is quantized in every control step.
    ``max_batch``, ``batch_window_ms``, ``max_queue`` and ``bucket_mode``
    are dynamic batching's, as in JAX (the module docstring).
    """

    def __init__(self, cfg, checkpoint_path: Optional[str] = "random", *, device="cuda",
                 seed: int = 42, max_batch: int = 1, batch_window_ms: float = 2.0,
                 tp: int = 1, dp: int = 1, max_queue: int = 0, bucket_mode: str = "pow2"):
        refuse(tp=(tp > 1, "M14"), dp=(dp > 1, "M14"))
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if cfg.get("use_bf16") else torch.float32
        self.seed = int(seed)
        self.model = self._build_model(checkpoint_path)
        self._signature = model_signature(self.model)
        # the baseline / vanilla presets turn the prefix cache off
        self.prefix_cache = bool(cfg.get("use_prefix_kv_cache", True))
        self.processor = build_processor(cfg)
        self._image_size = int(cfg["vision"]["config"]["image_size"])
        self._proprio_dim = int(cfg["proprio_dim"])
        self._noise_dims = (self.model.spec.num_action_tokens, self.model.spec.action_dim)
        self._checkpoint_desc = str(checkpoint_path or "random")
        self._init_runtime(max_batch, batch_window_ms, max_queue, bucket_mode)

    def _build_model(self, checkpoint_path) -> PiZero:
        """A ready-to-serve model: a fresh ``PiZero`` on the device, the
        random draw or the checkpoint, then the quantization tiers (JAX
        ``_build_params``). Startup and ``reload_checkpoint`` both build
        through here, so the two cannot drift."""
        model = PiZero(self.cfg, device=self.device, dtype=self.dtype)
        if str(checkpoint_path or "random").lower() in ("random", "none"):
            model.init_params(torch.Generator(device=self.device).manual_seed(self.seed))
        else:
            load_checkpoint(model, str(checkpoint_path))
        model.enable_action_quantization()
        model.enable_vlm_quantization()
        return model.eval()

    def _init_runtime(self, max_batch: int = 1, batch_window_ms: float = 2.0,
                      max_queue: int = 0, bucket_mode: str = "pow2") -> None:
        """The request state every server shares: the device lock and the
        step index, the tokenization cache, the request queue and its
        batcher thread, the socket and the counters (JAX
        ``ActionServer._init_runtime``)."""
        if bucket_mode not in ("pow2", "max"):
            raise ValueError(f"bucket_mode {bucket_mode!r}: expected 'pow2' or 'max'")
        self.bucket_mode = bucket_mode
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = batch_window_ms / 1000.0
        # > 0 bounds the requests queued unclaimed; the rest are rejected
        self.max_queue = max(0, int(max_queue))
        self.tp = self.dp = 1
        self._req_idx = 0
        self._lock = threading.Lock()  # device stream + step index + model
        self._tok_cache = {}
        self._tok_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._queue: "queue.Queue[Optional[_PendingRequest]]" = queue.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._t_start = time.monotonic()
        self._n_requests = 0
        self._n_errors = 0
        self._n_rejected = 0
        self._n_batches = 0
        self._live_slots = 0
        self._padded_slots = 0
        self._n_reloads = 0
        self._latencies_ms: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._batcher: Optional[threading.Thread] = None
        if self.max_batch > 1:
            self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
            self._batcher.start()

    def _on_device(self):
        """Make ``self.device`` the thread's current CUDA device (it is
        per thread: a server on cuda:1 must not launch on cuda:0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

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

    def noise(self, request_idx: int, batch: int = 1) -> torch.Tensor:
        """The flow noise of step ``request_idx``, on the device: JAX's
        ``normal(fold_in(PRNGKey(seed), request_idx), (batch, n_tok,
        act_dim), dtype)``, as ``blurr_tpu/agent/eval_agent.py:
        make_noise_infer`` draws it for a whole bucket."""
        key = prng.fold_in(prng.prng_key(self.seed), request_idx)
        return prng.normal(key, (batch, *self._noise_dims), self.dtype, self.device)

    def _step(self, ids, am, px, pr, request_idx: int) -> np.ndarray:
        """The device work of one step over the batch of ``ids``: the action
        chunks [B, horizon, action_dim] on the host (the fetch waits for the
        device)."""
        noise = self.noise(request_idx, ids.shape[0])
        infer = self.model.infer_action if self.prefix_cache else self.model.infer_action_naive
        actions = infer(ids, am, px, pr, noise)
        return actions.float().cpu().numpy()

    def _post(self, out: np.ndarray) -> np.ndarray:
        """``_step``'s output [B, ...] -> the answers [B, ...] (host side).
        Pi-0's chunk is already continuous; the OpenVLA server detokenizes
        (and unnormalizes) here."""
        return out.astype(np.float32)

    def _dummy_request(self):
        """(image, instruction, proprio) of the warmup request."""
        size = self._image_size
        return (np.zeros((size, size, 3), np.uint8), "warmup", [0.0] * self._proprio_dim)

    def _bucket(self, n: int) -> int:
        """The batch a step over ``n`` live requests runs at."""
        if self.bucket_mode == "max":
            return self.max_batch
        return 1 << (n - 1).bit_length()

    def _buckets(self) -> list:
        """Every batch the server can run at: 1, 2, 4, ... up to the first
        power of 2 >= max_batch under 'pow2'; max_batch alone under 'max'."""
        return sorted({self._bucket(n) for n in range(1, self.max_batch + 1)})

    def _warm(self, bucket: int) -> float:
        """One dummy step at batch ``bucket`` (on the card: builds the
        kernels and warms the allocator for that shape); returns its
        seconds. It does not count as a request."""
        t0 = time.monotonic()
        inputs = self._prepare(*self._dummy_request())
        batched = tuple(torch.cat([a] * bucket) for a in inputs)
        with self._lock, self._on_device():
            self._require_model()
            self._post(self._step(*batched, request_idx=0))
        return time.monotonic() - t0

    def warmup(self) -> float:
        """One dummy step at every bucket the server can run; returns the
        seconds they took."""
        t0 = time.monotonic()
        for bucket in self._buckets():
            log.info("warmup: bucket %d took %.2f s", bucket, self._warm(bucket))
        return time.monotonic() - t0

    def predict(self, image: np.ndarray, instruction: str, proprio) -> np.ndarray:
        """One request; counts requests and errors and records the
        end-to-end (prepare + queue + device + fetch) latency for
        ``stats()``."""
        t0 = time.monotonic()
        try:
            result = self._predict_impl(image, instruction, proprio)
        except Exception:
            with self._stats_lock:
                self._n_errors += 1
            raise
        with self._stats_lock:
            self._n_requests += 1
            self._latencies_ms.append((time.monotonic() - t0) * 1000.0)
        return result

    def _predict_impl(self, image: np.ndarray, instruction: str, proprio) -> np.ndarray:
        inputs = self._prepare(image, instruction, proprio)
        if self.max_batch <= 1:
            with self._lock, self._on_device():
                self._require_model()
                out = self._step(*inputs, request_idx=self._req_idx)
                self._req_idx += 1
            return self._post(out)[0]
        if self._closed:
            raise RuntimeError("ActionServer is shut down")
        if self.max_queue and self._queue.qsize() >= self.max_queue:
            with self._stats_lock:
                self._n_rejected += 1
            raise RuntimeError(
                f"Overloaded: {self._queue.qsize()} requests queued "
                f"(max_queue={self.max_queue}); retry later"
            )
        pending = _PendingRequest(inputs)
        self._queue.put(pending)
        # bounded waits: a request that raced stop()'s sentinel, or a dead
        # batcher, must not hang its caller; a claimed request is in a
        # computing batch and will complete, so it keeps waiting
        while not pending.event.wait(timeout=1.0):
            batcher_dead = self._batcher is not None and not self._batcher.is_alive()
            if pending.claimed:
                if batcher_dead:  # died mid-batch without setting the events
                    raise RuntimeError("ActionServer batcher died while computing the request")
                continue
            if self._closed or batcher_dead:
                raise RuntimeError("ActionServer shut down while the request was queued")
        if pending.error is not None:
            raise pending.error
        return pending.result

    # ------------------------------------------------------------------
    # dynamic batching

    def _batch_loop(self) -> None:
        with self._on_device():
            while True:
                first = self._queue.get()
                if first is None:  # shutdown sentinel
                    return
                first.claimed = True
                batch = [first]
                shutdown = False
                deadline = time.monotonic() + self.batch_window_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if item is None:  # shutdown sentinel mid-collection
                        shutdown = True
                        break
                    item.claimed = True
                    batch.append(item)
                self._run_batch(batch)
                if shutdown:
                    return

    def _run_batch(self, batch) -> None:
        """Pad ``batch`` to its bucket by repeating the last request, run one
        step on the bucket, fetch the whole bucket and slice its live rows
        on the host. A failed step fails every request of the bucket."""
        n = len(batch)
        pad = self._bucket(n) - n
        with self._stats_lock:
            self._n_batches += 1
            self._live_slots += n
            self._padded_slots += pad
        try:
            inputs = tuple(
                torch.cat([b.inputs[i] for b in batch] + [batch[-1].inputs[i]] * pad)
                for i in range(len(batch[0].inputs))
            )
            with self._lock, self._on_device():
                self._require_model()
                out = self._step(*inputs, request_idx=self._req_idx)
                self._req_idx += 1
            out = self._post(out[:n])
            for i, b in enumerate(batch):
                b.result = out[i]
                b.event.set()
        except Exception as exc:
            log.exception("batched step failed (%d requests)", n)
            for b in batch:
                b.error = exc
                b.event.set()

    # ------------------------------------------------------------------
    # hot reload

    def _checked(self, model, path: str):
        """``model`` if its signature is the startup model's, else
        ``ValueError``. Every model the server rebinds passes this, so the
        live model's signature is the startup one, and a reload after a
        failed ``drop_first`` (no live model) is checked as strictly."""
        got = model_signature(model)
        for part in ("tensors", "modules"):
            want, have = self._signature[part], got[part]
            if want != have:
                name = next(k for k in sorted(want.keys() | have.keys())
                            if want.get(k) != have.get(k))
                raise ValueError(
                    f"checkpoint {path!r} is structurally incompatible with the "
                    f"serving config: {part[:-1]} {name!r} is {have.get(name)}, the "
                    f"server's is {want.get(name)}; restart the server with the "
                    "matching config instead")
        return model

    def reload_checkpoint(self, path: str, drop_first: bool = False) -> dict:
        """Swap in the weights of ``path`` while serving (JAX
        ``reload_checkpoint``). The new model is built by ``_build_model``,
        as at startup, and checked against the served one (``_checked``).

        Atomic (the default): built off the lock, then rebound under it, so
        a step in flight finishes on the old model and the next runs the
        new one; on any failure the old model keeps serving.
        ``drop_first=True`` frees the old model before building (for models
        too big to hold twice): requests stall on the lock for the load, and
        a failed load leaves the server without weights, every request
        failing "no weights loaded", until a reload succeeds."""
        path = str(path)
        if drop_first:
            with self._lock, self._on_device():
                old = self._checkpoint_desc
                self.model = None
                self._checkpoint_desc = f"(reloading from {old})"
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                try:
                    self.model = self._checked(self._build_model(path), path)
                    self._checkpoint_desc = path
                except Exception:
                    self._checkpoint_desc = f"(reload of {path!r} FAILED)"
                    raise
        else:
            with self._on_device():
                new = self._checked(self._build_model(path), path)
            with self._lock:
                self.model = new
                self._checkpoint_desc = path
        with self._stats_lock:
            self._n_reloads += 1
        log.info("hot-reloaded checkpoint: %s (drop_first %s)", path, drop_first)
        return {"reloaded": path, "drop_first": bool(drop_first)}

    def _require_model(self) -> None:
        """Called under ``self._lock``: a ``drop_first`` reload holds the
        lock while the model is None, so requests stall on the lock; None
        here means that reload failed."""
        if self.model is None:
            raise RuntimeError("no weights loaded (a drop_first reload failed); "
                               "reload a checkpoint")

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Server-side counters (JSON-safe); the health-check answer. The
        batch counters appear once a batch has run: occupancy is live
        requests per batch, padding_frac the share of padded slots."""
        with self._stats_lock:
            lat = list(self._latencies_ms)
            n_req, n_err, n_rej = self._n_requests, self._n_errors, self._n_rejected
            n_batch, live, padded = self._n_batches, self._live_slots, self._padded_slots
            n_reloads = self._n_reloads
            uptime = time.monotonic() - self._t_start
        out = {
            "requests_total": n_req,
            "errors_total": n_err,
            "rejected_total": n_rej,
            "queue_depth": self._queue.qsize(),
            "uptime_s": round(uptime, 3),
            "max_batch": self.max_batch,
            "bucket_mode": self.bucket_mode,
            "dp": self.dp,
            "tp": self.tp,
            "closed": self._closed,
            "latency_window": len(lat),
            "checkpoint": self._checkpoint_desc,
            "reloads_total": n_reloads,
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
        if n_batch:
            out.update(
                batches_total=n_batch,
                live_slots_total=live,
                padded_slots_total=padded,
                batch_occupancy_mean=round(live / n_batch, 3),
                padding_frac=round(padded / max(1, live + padded), 4),
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
        self._closed = True  # reject new requests before the sentinel lands
        if self._sock is not None:
            try:  # wakes the accept() of serve_forever (close alone does not)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        if self._batcher is not None:
            self._queue.put(None)  # shutdown sentinel

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
        if kind not in ("predict", "reload"):
            return {"error": f"unknown request kind: {kind!r}"}
        try:
            if kind == "reload":
                return self.reload_checkpoint(str(req["path"]),
                                              drop_first=bool(req.get("drop_first", False)))
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
            log.exception("%s failed", kind)
            return {"error": f"{type(exc).__name__}: {exc}"}
