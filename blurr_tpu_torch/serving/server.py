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

With ``tp`` or ``dp`` > 1 (JAX ``_init_parallel``) the server runs
``tp * dp`` ranks, one process each (``parallel/mesh.py``): this process is
rank 0 (the TCP front, the batcher, ``stats()``) and spawns ranks 1 .. n-1,
each of which builds the same model through ``_build_model`` and shards it
(``parallel/mesh.py:shard_params``: tensor parallelism over each data
row's ``tp`` ranks), then waits for rank 0's orders on its pipe: a step
(the warmup's too), a reload, the kernel counts, or stop. In a step rank 0
draws the bucket's noise (one draw for the whole bucket, as one process
does) and broadcasts the ids, mask, pixels, proprio and noise; each data
rank takes its rows and rank 0 gathers the actions, so they are the
one-process bucket's. dp must be a power of 2 with ``max_batch >= dp``
(and dividing it under 'max'); the smallest bucket is dp. A rank that
raises fails its request, and every later one: the server is broken and
says which rank failed; nothing waits longer than the process group's
timeout (``PG_TIMEOUT_S``) or a deadline. A reload under tp or dp builds
on every rank while requests wait on the lock, and swaps on every rank
only once all have built. One process runs one such server at a time
(``torch.distributed``'s default group is the process's); after ``stop()``
neither the process group nor a rank's process remains. A known fault with
no known cause: in ``chip_smoke.py``'s long process, ``torch.profiler``
has recorded no device activity after parallel servers had run there
(shorter processes that run them record as before), so a profile taken
in the server's process afterwards must be checked for events.
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
import torch.distributed as dist

from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.models.pi0.processing import build_processor, process_images
from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.ops.flash_attention import flash_attention
from blurr_tpu_torch.ops.int4_matmul import int4_matmul
from blurr_tpu_torch.ops.int8_matmul import int8_matmul
from blurr_tpu_torch.parallel.mesh import (
    PG_TIMEOUT_S,
    Mesh,
    Workers,
    all_gather,
    broadcast_tensors,
    data_rows,
    free_tcp_init_method,
    init_ranks,
    make_mesh,
    shard_params,
)
from blurr_tpu_torch.serving.protocol import ProtocolError, recv_msg, send_msg
from blurr_tpu_torch.utils.image import lanczos_resize_uint8

log = logging.getLogger(__name__)

# the kernels of the served paths, whose launches ``rank_launches`` reads
SERVED_KERNELS = {"flash_attention": flash_attention, "int4_matmul": int4_matmul,
                  "int8_matmul": int8_matmul}
# how long rank 0 waits for the other ranks to build a model (startup, reload)
BUILD_DEADLINE_S = 900.0


def _rank_main(rank: int, conn, cls, ctor: dict) -> None:
    """A spawned rank of a parallel server: build as rank 0 does, then serve
    rank 0's orders until it says stop (or goes away)."""
    try:
        server = cls(**{**ctor, "_rank": rank})
    except BaseException as exc:  # the reason goes to rank 0, then the process ends
        log.exception("rank %d failed to start", rank)
        conn.send(("error", f"{type(exc).__name__}: {exc}"))
        return
    conn.send(("ready",))
    server._serve_rank(conn)


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
    are dynamic batching's, as in JAX (the module docstring). ``tp`` /
    ``dp`` > 1 run the ranks of the module docstring; ``init_method`` is
    their rendezvous (``tcp://`` or ``file://``; None: a free localhost
    port). ``_rank`` is set only where a spawned rank builds its server.
    """

    def __init__(self, cfg, checkpoint_path: Optional[str] = "random", *, device="cuda",
                 seed: int = 42, max_batch: int = 1, batch_window_ms: float = 2.0,
                 tp: int = 1, dp: int = 1, max_queue: int = 0, bucket_mode: str = "pow2",
                 init_method: Optional[str] = None, _rank: int = 0):
        ctor = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.cfg = cfg
        self._init_parallel(tp, dp, max_batch, bucket_mode, device, init_method, _rank, ctor)
        self.dtype = torch.bfloat16 if cfg.get("use_bf16") else torch.float32
        self.seed = int(seed)
        with self._ranks_stop_on_error():
            self.model = self._build_model(checkpoint_path)
        self._signature = model_signature(self.model)
        # the baseline / vanilla presets turn the prefix cache off
        self.prefix_cache = bool(cfg.get("use_prefix_kv_cache", True))
        # only rank 0 prepares requests (a tokenizer can take seconds to load)
        self.processor = build_processor(cfg) if self.rank == 0 else None
        self._image_size = int(cfg["vision"]["config"]["image_size"])
        self._proprio_dim = int(cfg["proprio_dim"])
        self._noise_dims = (self.model.spec.num_action_tokens, self.model.spec.action_dim)
        self._checkpoint_desc = str(checkpoint_path or "random")
        if self.rank == 0:
            self._join_ranks()
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
        return shard_params(model, self.mesh).eval()

    # ------------------------------------------------------------------
    # ranks (tensor and data parallelism)

    def _init_parallel(self, tp: int, dp: int, max_batch: int, bucket_mode: str, device,
                       init_method: Optional[str], rank: int, ctor: dict) -> None:
        """Check tp / dp (JAX ``_init_parallel`` and its 'max' check), then,
        with more than one rank, spawn ranks 1 .. n-1 (on rank 0), join the
        process group and lay out the (dp, tp) mesh. Sets ``tp``, ``dp``,
        ``rank``, ``mesh``, ``backend`` and ``device`` (this rank's)."""
        if bucket_mode not in ("pow2", "max"):
            raise ValueError(f"bucket_mode {bucket_mode!r}: expected 'pow2' or 'max'")
        self.tp, self.dp = max(1, int(tp)), max(1, int(dp))
        self.rank, self.world = int(rank), self.tp * self.dp
        self.mesh, self.backend, self._workers, self._broken = Mesh(), None, None, None
        if self.dp > 1:
            if self.dp & (self.dp - 1):
                raise ValueError(f"dp={self.dp}: must be a power of 2 so every power-of-2 "
                                 "batch bucket >= dp splits evenly over the data ranks")
            if max_batch < self.dp:
                raise ValueError(f"dp={self.dp} needs dynamic batching with max_batch >= dp "
                                 f"(got max_batch={max_batch}): DP serving splits the batch "
                                 "over ranks")
            if bucket_mode == "max" and max_batch % self.dp:
                raise ValueError(f"bucket_mode='max' pads every batch to max_batch="
                                 f"{max_batch}, which must be divisible by dp={self.dp} "
                                 "for the data-parallel split")
        if self.world == 1:
            self.device = torch.device(device)
            return
        if self.rank == 0:
            init_method = init_method or free_tcp_init_method()
            self._workers = Workers(self.world, _rank_main,
                                    (type(self), {**ctor, "init_method": init_method}))
        try:
            self.backend, self.device = init_ranks(self.rank, self.world, init_method, device)
            self.mesh = make_mesh(self.dp, self.tp)
        except Exception as exc:
            if self._workers is not None:
                errs = self._workers.pending_errors()
                self._workers.join(PG_TIMEOUT_S)
                if errs:
                    raise RuntimeError("; ".join(errs)) from exc
            raise
        log.info("rank %d of %d (dp %d x tp %d): backend %s, device %s", self.rank,
                 self.world, self.dp, self.tp, self.backend, self.device)

    @contextlib.contextmanager
    def _ranks_stop_on_error(self):
        """Rank 0's startup after the spawn: on any error the other ranks
        are stopped and the process group left before it propagates."""
        try:
            yield
        except BaseException:
            self._shutdown_ranks()
            raise

    def _join_ranks(self) -> None:
        """Rank 0, after its own build: every other rank has built too."""
        if self._workers is None:
            return
        try:
            self._workers.replies(BUILD_DEADLINE_S)
        except Exception:
            self._shutdown_ranks()
            raise

    def _shutdown_ranks(self) -> None:
        """Stop the other ranks (by a deadline) and leave the process group."""
        workers, self._workers = self._workers, None
        if workers is None:
            return
        try:
            workers.send(("stop",))
        except RuntimeError as exc:
            log.warning("stopping the ranks: %s", exc)
        workers.join(PG_TIMEOUT_S)
        if dist.is_initialized():
            dist.destroy_process_group()

    def _run(self, tensors) -> torch.Tensor:
        """One step's device work on every rank (rank 0 calls it under the
        lock): the inputs broadcast, each rank's ``_forward``, and the other
        ranks' replies read by a deadline. A failure on any rank breaks the
        server (every later step raises) and names the rank."""
        if self._workers is None:
            if self.world > 1:
                raise RuntimeError("the server is stopped: its other ranks have left")
            return self._forward(*tensors)
        if self._broken is not None:
            raise RuntimeError(f"the server is broken: {self._broken}")
        try:
            self._workers.send(("step",))
            out = self._forward(*broadcast_tensors(tensors, self.device))
            self._workers.replies(PG_TIMEOUT_S)
        except Exception as exc:
            self._broken = "; ".join(self._workers.pending_errors()) or f"rank 0: {exc}"
            log.error("parallel step failed: %s", self._broken)
            raise RuntimeError(f"parallel step failed: {self._broken}") from exc
        return out

    def _forward(self, *tensors) -> torch.Tensor:
        """This rank's part of a step on the whole bucket's inputs: its data
        rows through ``_infer``, then every data rank's rows gathered."""
        out = self._infer(*(data_rows(t, self.mesh) for t in tensors))
        return all_gather(out, self.mesh.data_group, 0)

    def _serve_rank(self, conn) -> None:
        """Ranks 1 .. n-1: serve rank 0's orders until "stop". A failed step
        sends its reason to rank 0 and ends the process (so rank 0's
        collectives fail at once); a refused reload keeps serving."""
        pending = None
        try:
            while True:
                try:
                    order = conn.recv()
                except EOFError:
                    return  # rank 0 is gone
                op, reply = order[0], ("ok",)
                if op == "stop":
                    conn.send(reply)
                    return
                try:
                    with self._on_device():
                        if op == "step":
                            self._forward(*broadcast_tensors(None, self.device))
                        elif op == "reload":
                            _, path, drop_first = order
                            if drop_first:
                                self.model = None
                                self._free_memory()
                            pending = self._checked(self._build_model(path), path)
                        elif op == "commit":
                            self.model, pending = pending, None
                        elif op == "abort":
                            pending = None
                            if order[1]:  # a failed drop_first reload: no weights
                                self.model = None
                        elif op == "launches":
                            reply = ("ok", {k: fn.launches for k, fn in SERVED_KERNELS.items()})
                        elif op == "zero_launches":
                            for fn in SERVED_KERNELS.values():
                                fn.launches = 0
                        else:
                            raise ValueError(f"unknown order {op!r}")
                except Exception as exc:
                    log.exception("rank %d: %s failed", self.rank, op)
                    conn.send(("error", f"{op}: {type(exc).__name__}: {exc}"))
                    if op == "reload":
                        continue
                    return
                conn.send(reply)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    def rank_launches(self, zero: bool = False) -> list:
        """The served kernels' launch counts of every rank ([rank 0, rank 1,
        ...], each {name: count}); ``zero`` sets them to 0 on every rank
        instead (and returns them as they were)."""
        counts = [{k: fn.launches for k, fn in SERVED_KERNELS.items()}]
        with self._lock:
            if self._workers is not None:
                self._workers.send(("launches",))
                counts += [r[1] for r in self._workers.replies(PG_TIMEOUT_S)]
                if zero:
                    self._workers.send(("zero_launches",))
                    self._workers.replies(PG_TIMEOUT_S)
        if zero:
            for fn in SERVED_KERNELS.values():
                fn.launches = 0
        return counts

    def _free_memory(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _init_runtime(self, max_batch: int = 1, batch_window_ms: float = 2.0,
                      max_queue: int = 0, bucket_mode: str = "pow2") -> None:
        """The request state every server shares: the device lock and the
        step index, the tokenization cache, the request queue and its
        batcher thread, the socket and the counters (JAX
        ``ActionServer._init_runtime``); ``bucket_mode`` is checked by
        ``_init_parallel``."""
        self.bucket_mode = bucket_mode
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = batch_window_ms / 1000.0
        # > 0 bounds the requests queued unclaimed; the rest are rejected
        self.max_queue = max(0, int(max_queue))
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
        device). The noise is drawn here, on rank 0, for the whole bucket."""
        noise = self.noise(request_idx, ids.shape[0])
        return self._run((ids, am, px, pr, noise)).float().cpu().numpy()

    def _infer(self, ids, am, px, pr, noise) -> torch.Tensor:
        """The model's step on this rank's rows."""
        infer = self.model.infer_action if self.prefix_cache else self.model.infer_action_naive
        return infer(ids, am, px, pr, noise)

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
        """The batch a step over ``n`` live requests runs at (at least dp:
        the smallest bucket the data ranks split)."""
        if self.bucket_mode == "max":
            return self.max_batch
        return max(self.dp, 1 << (n - 1).bit_length())

    def _buckets(self) -> list:
        """Every batch the server can run at: dp (1 without data
        parallelism), 2 dp, 4 dp, ... up to the first power of 2 >=
        max_batch under 'pow2'; max_batch alone under 'max'."""
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
        if self.max_batch <= 1 and self.dp == 1:
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
        if self._workers is not None:
            self._reload_ranks(path, drop_first)
        elif drop_first:
            with self._lock, self._on_device():
                old = self._checkpoint_desc
                self.model = None
                self._checkpoint_desc = f"(reloading from {old})"
                self._free_memory()
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

    def _reload_ranks(self, path: str, drop_first: bool) -> None:
        """``reload_checkpoint`` under tp or dp: every rank builds (and
        checks) the new model while requests wait on the lock; all swap
        once all have built, else none does (``drop_first``: none keeps
        weights)."""
        with self._lock, self._on_device():
            if self._broken is not None:
                raise RuntimeError(f"the server is broken: {self._broken}")
            old = self._checkpoint_desc
            if drop_first:
                self.model = None
                self._checkpoint_desc = f"(reloading from {old})"
                self._free_memory()
            self._workers.send(("reload", path, drop_first))
            new = error = None
            try:
                new = self._checked(self._build_model(path), path)
            except Exception as exc:
                error = exc
            try:
                self._workers.replies(BUILD_DEADLINE_S)
            except RuntimeError as exc:
                error = error or exc
            if error is not None:
                self._workers.send(("abort", drop_first))
                self._workers.replies(PG_TIMEOUT_S)
                if drop_first:
                    self._checkpoint_desc = f"(reload of {path!r} FAILED)"
                raise error
            self._workers.send(("commit",))
            self._workers.replies(PG_TIMEOUT_S)
            self.model, self._checkpoint_desc = new, path

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
        """Stop serving: close the socket, end the batcher and, under tp or
        dp, stop the other ranks (once the step in flight has finished) and
        leave the process group."""
        self._closed = True  # reject new requests before the sentinel lands
        if self._sock is not None:
            try:  # wakes the accept() of serve_forever (close alone does not)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        if self._batcher is not None:
            self._queue.put(None)  # shutdown sentinel
        if self._workers is not None:
            with self._lock:
                self._shutdown_ranks()

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
