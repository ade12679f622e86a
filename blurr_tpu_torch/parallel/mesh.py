"""Ranks, the (data, seq, model) and (data, pipe) meshes, the tensor-parallel
rule table and the collectives.

Counterpart of ``blurr_tpu/parallel/mesh.py`` for serving. JAX lays a
``('data', 'model')`` ``Mesh`` over the chips of one process and lets GSPMD
insert the collectives that its ``NamedSharding`` rules imply; here each
rank is a process of its own (``torch.distributed``), the rules pick the TP
wrapper of each module (``parallel/tensor_parallel.py``), and those
wrappers call the collectives of this module explicitly.

**Ranks.** ``make_mesh(data, model)`` lays ``data x model`` ranks out as
JAX's grid does, rank = d * model + m, and gives each rank its model group
(the ``model`` ranks of its data row, which split the weights) and its data
group (the ``data`` ranks of its model column, which split the batch).
``init_ranks`` joins the process group on the backend ``pick_backend``
chooses: ``gloo`` on the CPU; on CUDA, ``nccl`` when every rank has a card
of its own (``world <= torch.cuda.device_count()``), else ``gloo``, since
NCCL refuses two ranks on one device. The choice is logged and passed
explicitly; nothing falls back to another backend. Each rank computes on
``rank_device``: ``cuda:rank % device_count``, or the CPU when asked.
``Workers`` spawns ranks 1 .. n-1 for rank 0 (``spawn`` context), each with
a pipe to rank 0 for its orders and replies, and joins them by a deadline.

**The rule table** (``rule_for``; JAX ``_spec_for_path``, rule for rule).
Per module path of the port's models, which axis its weight splits over
the model ranks:

- the Pi-0 mixtures (``joint.*``): ``q_proj``, ``gate_proj``, ``up_proj``
  column (their outputs), ``o_proj``, ``down_proj`` row (their inputs);
  ``k_proj`` and ``v_proj`` whole (Gemma is multi-query: its one KV head is
  replicated, as JAX replicates ``k_w`` / ``v_w``);
- LLaMA (``llama.*``, multi-head): the same, with ``k_proj`` and ``v_proj``
  column too, and ``lm_head`` on the vocabulary (its logits gathered);
- ``embed_tokens`` (Pi-0's and LLaMA's) on the vocabulary: each rank holds
  ``V / tp`` rows, looks up the ids it holds and the ranks sum;
- the SigLIP layers (Pi-0's ``vision_tower``, OpenVLA's ``siglip``
  tower): ``q_proj`` / ``k_proj`` / ``v_proj`` / ``fc1`` column,
  ``out_proj`` / ``proj`` / ``fc2`` row. OpenVLA's fused ``qkv`` matches no
  JAX name (``qkv_w``), so it stays whole, and its ``proj`` (JAX
  ``out_w``) then takes a whole input, which the row wrapper slices;
- everything else whole (DINOv2, the projectors, the action encoder and
  decoder, the norms).

JAX's weights are ``[in, out]`` (stacked ``[L, in, out]``) where an
``nn.Linear`` holds ``[out, in]``, so JAX's last axis is the port's dim 0.
The leaves of a quantized or LoRA weight follow their parent as JAX's
rules say: ``q`` / ``q8a`` / ``fp`` as the weight, a per-channel ``s`` with
the output, ``lora_a`` with a row parent's input and ``lora_b`` with a
column parent's output; a w4a8 ``q4`` under any TP rule splits on its block
axis only, with the matching columns of its padded scales (the w4a8 rule of
``parallel/tensor_parallel.py``). A column layer's bias is cut with its
output; a row layer's is added once after the sum (JAX keeps biases whole
and GSPMD slices them at the add).

``shard_params(model, mesh)`` re-lays every w4a8 packing for the model
axis first (``ops/quant.py:repack_w4a8_tree``), then swaps each
rule-bearing module for its TP wrapper in place, holding the rank's slice
only. Tied modules stay tied: Pi-0's proprio mixture is the action
mixture's module, and OpenVLA's tied head reads the sharded embedding.

**The collectives** (sum- and max-all-reduce, the all-gather along an
axis, broadcast, and a tuple of tensors broadcast with its shapes) are the
only calls into ``torch.distributed`` the TP wrappers and the servers
make. A bf16 or fp16 tensor is reduced in fp32 and cast back. A group of
one rank is ``None`` and every collective on it is the identity. They
carry no gradient; training goes through their differentiable forms, four
``torch.autograd.Function``s in Megatron's pattern, which GSPMD derives in
JAX from the same shardings:

- ``copy_to_group``: forward the identity, backward a sum-all-reduce (a
  whole input entering the rank's slice of the work: each rank's gradient
  of it is a partial sum);
- ``reduce_from_group``: forward a sum-all-reduce, backward the identity
  (the rank's partial products summed; the loss after it is replicated, so
  its gradient is whole on every rank);
- ``gather_from_group``: forward an all-gather along an axis, backward the
  rank's own slice of the (replicated) gradient;
- ``scatter_to_group``: forward the rank's slice along an axis, backward an
  all-gather of the ranks' gradients.

``torch.distributed.nn.functional.all_reduce`` is not used: it all-reduces
in its backward too, which with a loss replicated on every model rank makes
each gradient tp times too large.

**Training** (M14's training half): ``init_multihost`` (JAX ``mesh.py:61``)
joins a launcher's process group; ``fsdp_dim`` is ``_augment_fsdp``'s
choice of the axis a tensor shards on over the data ranks
(``parallel/fsdp.py`` carries it out).

**Sequence and pipeline axes.** ``make_mesh(data, model, seq)`` adds JAX's
'seq' axis: ``data x seq x model`` ranks, rank = (d * seq + s) * model + m,
each with its seq group (the ``seq`` ranks that split the tokens of one
data row and model column). ``parallel/pipeline.py:make_pipeline_mesh``
lays out JAX's ``('data', 'pipe')`` grid, rank = d * pipe + p, with a pipe
group. One ``Mesh`` holds either: rank = ((d * pipe + p) * seq + s) * model
+ m, with ``seq`` or ``pipe`` one. ``sp_constrain(x, mesh)`` is JAX's
``sp_constrain``: the rank's contiguous 1/seq slice of the token axis (dim
1). Two more differentiable collectives serve them:

- ``gather_sum_from_group``: forward an all-gather along an axis, backward
  a reduce-scatter of the SUM of the ranks' gradients. Sequence
  parallelism gathers K/V with it: every rank's queries read every rank's
  keys, so a K/V slice's gradient is the sum of all ranks' contributions
  (``gather_from_group`` would keep only this rank's, too small and
  silent). FSDP's weight gather is the same Function;
- ``rotate_to_prev``: each rank's tensors go to the previous rank of the
  group and the next rank's arrive (JAX's ``ppermute`` of ring attention),
  backward the reverse rotation, on ``dist.batch_isend_irecv``.

``send`` / ``recv`` carry the pipeline's hidden states and their
gradients between stages. The point-to-point calls take CUDA tensors on
``nccl``; on ``gloo``, whose ``send`` / ``recv`` / ``batch_isend_irecv``
abort on a CUDA tensor, it goes through a host buffer (logged once a
process).
"""

from __future__ import annotations

import datetime
import itertools
import logging
import multiprocessing as mp
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger(__name__)

COLUMN, ROW, VOCAB = "column", "row", "vocab"
# the process group's timeout: a collective whose peer has died raises
# after this long at the latest (a dead peer's closed socket usually first)
PG_TIMEOUT_S = 30.0

_MIXTURE_RULES = {"q_proj": COLUMN, "o_proj": ROW, "gate_proj": COLUMN,
                  "up_proj": COLUMN, "down_proj": ROW}
_LLAMA_RULES = {**_MIXTURE_RULES, "k_proj": COLUMN, "v_proj": COLUMN, "lm_head": VOCAB}
# biases held beside their linear (LLaMA's Qwen2 knob), by that linear
_SEPARATE_BIASES = {"q_b": "q_proj", "k_b": "k_proj", "v_b": "v_proj"}
_SIGLIP_RULES = {"q_proj": COLUMN, "k_proj": COLUMN, "v_proj": COLUMN, "out_proj": ROW,
                 "proj": ROW, "fc1": COLUMN, "fc2": ROW}


def rule_for(path: str) -> Optional[str]:
    """The TP rule of the module (or parameter) at ``path`` in the port's
    Pi-0 or OpenVLA model: ``COLUMN``, ``ROW``, ``VOCAB`` or None (whole)."""
    parts = path.split(".")
    name = parts[-1]
    if "joint" in parts:
        return _MIXTURE_RULES.get(name)
    if "llama" in parts and name in _LLAMA_RULES:
        return _LLAMA_RULES[name]
    if name == "embed_tokens":
        return VOCAB
    if ("vision_tower" in parts or "siglip" in parts) and ("layers" in parts or "blocks" in parts):
        return _SIGLIP_RULES.get(name)
    return None


# ---------------------------------------------------------------------------
# Ranks and the mesh
# ---------------------------------------------------------------------------


def pick_backend(device: torch.device, world: int) -> str:
    """gloo on the CPU; on CUDA nccl when each of the ``world`` ranks has a
    card of its own, else gloo (NCCL refuses two ranks on one device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:rank % device_count``
    for a CUDA ``device``, else ``device`` (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_ranks(rank: int, world: int, init_method: str, device) -> Tuple[str, torch.device]:
    """Join the process group of ``world`` ranks at ``init_method`` (a
    ``tcp://`` or ``file://`` URL) as ``rank``, on the backend
    ``pick_backend`` gives, with a timeout of ``PG_TIMEOUT_S``. Returns
    (backend, this rank's device)."""
    dev = rank_device(device, rank)
    backend = pick_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("rank %d of %d: backend %s on %s (%s)", rank, world, backend, dev, init_method)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return backend, dev


def free_tcp_init_method() -> str:
    """``tcp://127.0.0.1:<port>`` with a port that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


# the variables a launcher (torchrun, a cluster's job script) sets for each rank
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(device="cuda") -> int:
    """Join the launcher's process group (JAX ``init_multihost``): the
    rank, the world and the rendezvous come from ``LAUNCHER_ENV``
    (``env://``), the rank computes on ``multihost_device`` (the card of its
    local rank, or the CPU when ``device`` is the CPU), on the backend
    ``pick_backend`` gives for the ranks of this host
    (``LOCAL_WORLD_SIZE``, else the world). Returns the
    rank. Without that environment, or with a world of one, it logs JAX's
    warning and carries on single-process (rank 0): a genuine failure to
    join must be visible, since N independent runs would all write the
    same save directory."""
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if missing or world == 1:
        reason = (f"no launcher environment ({', '.join(missing)} unset)" if missing
                  else "WORLD_SIZE is 1")
        log.warning("init_multihost: %s; continuing single-process (process_count=1). If "
                    "this host is part of a multi-host job, start it with a launcher that "
                    "sets %s.", reason, ", ".join(LAUNCHER_ENV))
        return 0
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    device = rank_device(device, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = pick_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    log.info("init_multihost: rank %d of %d (local rank %d) on %s, backend %s, env://%s:%s",
             rank, world, local, device, backend, os.environ["MASTER_ADDR"],
             os.environ["MASTER_PORT"])
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return rank


def multihost_device(device) -> torch.device:
    """The device of this rank inside a launcher's group: ``rank_device``
    of its local rank (``cuda:LOCAL_RANK % device_count``: the ranks of a
    host with fewer cards than ranks share them), else ``device``."""
    if dist.is_initialized() and "LOCAL_RANK" in os.environ:
        return rank_device(device, int(os.environ["LOCAL_RANK"]))
    return torch.device(device)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``data x pipe x seq x model`` grid and its
    groups (None where the axis has one rank; ``seq`` or ``pipe`` is one).
    Built by ``make_mesh`` or ``parallel/pipeline.py:make_pipeline_mesh``;
    a Mesh with no groups still tells ``shard_params`` which slice a rank
    holds."""

    data: int = 1
    model: int = 1
    rank: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    seq: int = 1
    pipe: int = 1
    seq_group: Optional[object] = None
    pipe_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.pipe * self.seq * self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def seq_rank(self) -> int:
        return self.rank // self.model % self.seq

    @property
    def pipe_rank(self) -> int:
        return self.rank // (self.model * self.seq) % self.pipe

    @property
    def data_rank(self) -> int:
        return self.rank // (self.model * self.seq * self.pipe)


def build_mesh(data: int = 1, model: int = 1, seq: int = 1, pipe: int = 1) -> Mesh:
    """The grid over the initialised process group, rank = ((d * pipe + p)
    * seq + s) * model + m, with a group for each axis of more than one
    rank (the ranks that differ along it alone). Every rank calls it
    (``dist.new_group`` is collective)."""
    if seq > 1 and pipe > 1:
        raise ValueError("sequence parallelism (sp_axis) and pipeline parallelism use "
                         "different meshes; compose sp with data/tensor axes instead")
    world = data * pipe * seq * model
    if world == 1:
        return Mesh()
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(f"a mesh of data {data} x pipe {pipe} x seq {seq} x model {model} "
                           f"needs an initialised process group of {world} ranks")
    rank = dist.get_rank()
    sizes = {"data": data, "pipe": pipe, "seq": seq, "model": model}
    order = ("data", "pipe", "seq", "model")  # rank-major to minor

    def rank_of(coords):
        r = 0
        for axis in order:
            r = r * sizes[axis] + coords[axis]
        return r

    groups = {}
    for axis in ("model", "data", "seq", "pipe"):  # the same order on every rank
        if sizes[axis] == 1:
            continue
        others = [a for a in order if a != axis]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            coords = dict(zip(others, fixed))
            ranks = [rank_of({**coords, axis: i}) for i in range(sizes[axis])]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(data, model, rank, groups.get("model"), groups.get("data"), seq, pipe,
                groups.get("seq"), groups.get("pipe"))


def make_mesh(data: int = 1, model: int = 1, seq: int = 1) -> Mesh:
    """JAX's ``('data', 'seq', 'model')`` mesh over the initialised process
    group (rank = (d * seq + s) * model + m); ``seq`` one gives the
    ``data x model`` grid. Every rank calls it."""
    return build_mesh(data=data, model=model, seq=seq)


def sp_constrain(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """JAX's ``sp_constrain``: the rank's contiguous 1/seq slice of the
    token axis (dim 1) of ``x`` [B, S, ...]; ``x`` itself without a seq
    axis. Raises ``ValueError`` when the axis does not split."""
    if mesh is None or mesh.seq == 1:
        return x
    n = x.shape[1]
    if n % mesh.seq:
        raise ValueError(f"an axis of {n} does not split over {mesh.seq} ranks")
    w = n // mesh.seq
    return x.narrow(1, mesh.seq_rank * w, w)


def data_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of a bucket ``x`` [B, ...] that this rank's data index
    takes (B / data contiguous rows; JAX's ``batch_sharding``)."""
    if mesh.data == 1:
        return x
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} rows does not split over {mesh.data} data ranks")
    n = b // mesh.data
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]


class Workers:
    """Ranks 1 .. world-1 of rank 0: spawned processes running
    ``target(rank, conn, *args)``, each with a pipe ``conn`` to rank 0.

    ``send`` writes one order to every worker; ``replies`` reads one reply
    from each by a deadline and raises, naming the rank, when a worker
    replied with an error, died, or did not answer in time. ``join``
    stops them by a deadline (a worker still alive then is killed)."""

    def __init__(self, world: int, target: Callable, args: Sequence = ()):
        ctx = mp.get_context("spawn")
        self.procs, self.conns = [], []
        for rank in range(1, world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=target, args=(rank, child, *args), daemon=True,
                            name=f"blurr-rank-{rank}")
            p.start()
            child.close()
            self.procs.append(p)
            self.conns.append(parent)

    def send(self, msg) -> None:
        for rank, conn in enumerate(self.conns, 1):
            try:
                conn.send(msg)
            except (BrokenPipeError, OSError) as exc:
                raise RuntimeError(f"rank {rank} is gone: {exc}") from exc

    def replies(self, timeout_s: float) -> List:
        """One reply from each worker, in rank order (every worker's is read,
        so each order keeps one reply); a reply ``("error", text)`` raises
        once all are read."""
        deadline = time.monotonic() + timeout_s
        out, errors = [], []
        for rank, (conn, p) in enumerate(zip(self.conns, self.procs), 1):
            while not conn.poll(min(1.0, max(0.0, deadline - time.monotonic()))):
                if not p.is_alive() and not conn.poll(0):
                    raise RuntimeError(f"rank {rank} died (exit code {p.exitcode})")
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"rank {rank} did not answer within {timeout_s:.0f} s")
            try:
                reply = conn.recv()
            except EOFError as exc:
                raise RuntimeError(f"rank {rank} died (exit code {p.exitcode})") from exc
            if isinstance(reply, tuple) and reply and reply[0] == "error":
                errors.append(f"rank {rank} failed: {reply[1]}")
            out.append(reply)
        if errors:
            raise RuntimeError("; ".join(errors))
        return out

    def pending_errors(self) -> List[str]:
        """Errors the workers have sent and nobody read (after a collective
        failed on rank 0: the reason is usually a worker's)."""
        errs = []
        for rank, conn in enumerate(self.conns, 1):
            try:
                while conn.poll(0):
                    reply = conn.recv()
                    if isinstance(reply, tuple) and reply and reply[0] == "error":
                        errs.append(f"rank {rank} failed: {reply[1]}")
            except (EOFError, OSError):
                pass
        return errs

    def join(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                log.warning("%s did not stop within %.0f s; killed", p.name, timeout_s)
                p.kill()
                p.join(5.0)
        for conn in self.conns:
            conn.close()


# ---------------------------------------------------------------------------
# Collectives (the only calls into torch.distributed the TP layers make)
# ---------------------------------------------------------------------------

_HALF = (torch.bfloat16, torch.float16)


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if group is None:
        return x
    t = x.float() if x.dtype in _HALF else x.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; half in fp32)."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (a new tensor)."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (equal shapes)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` into ``x`` on every rank of ``group``
    (the world when None), in place."""
    dist.broadcast(x, src, group=group)
    return x


def broadcast_tensors(tensors: Optional[Sequence[torch.Tensor]], device,
                      src: int = 0) -> Tuple[torch.Tensor, ...]:
    """Broadcast a tuple of tensors from global rank ``src`` to the world:
    ``src`` passes them, every other rank passes None and gets them on
    ``device``. Their dtypes and shapes go first, as one object."""
    meta = [None if tensors is None else [(t.dtype, tuple(t.shape)) for t in tensors]]
    dist.broadcast_object_list(meta, src)
    return tuple(broadcast(tensors[i].to(device).contiguous() if tensors is not None
                           else torch.empty(shape, dtype=dtype, device=device), src)
                 for i, (dtype, shape) in enumerate(meta[0]))


def _own(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` over ``group``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"an axis of {x.shape[dim]} does not split over {n} ranks")
    w = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * w, w).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``g`` over ``group``, this rank's equal slice along
    ``dim`` (half in fp32; on gloo, which has no reduce-scatter, a
    sum-all-reduce and the rank's slice)."""
    if dist.get_backend(group) == "nccl":
        n = dist.get_world_size(group)
        src = g.movedim(dim, 0).float().contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.to(g.dtype).movedim(0, dim).contiguous()
    return _own(all_reduce_sum(g, group), group, dim)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


# gloo's point-to-point calls read a CUDA tensor's device pointer as a host
# address (torch 2.11: the process aborts, "writev ... Bad address"), so a
# CUDA tensor goes through a host buffer there
_logged_host_p2p = []


def _via_host(t: torch.Tensor, group) -> bool:
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if not _logged_host_p2p:
        _logged_host_p2p.append(True)
        log.info("point-to-point transfers of CUDA tensors on gloo go through host buffers")
    return True


def group_peer(group, offset: int) -> int:
    """The global rank of the rank ``offset`` places after this one in
    ``group``, around the ring."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def exchange(sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[torch.Tensor, int]],
             group) -> None:
    """Send each (tensor, global rank) of ``sends`` and fill each (buffer,
    global rank) of ``recvs`` in place, all at once
    (``dist.batch_isend_irecv``); returns when every transfer is done."""
    ops, back = [], []
    for t, peer in sends:
        t = t.detach().contiguous()
        if _via_host(t, group):
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t, peer, group))
    for buf, peer in recvs:
        into = buf
        if _via_host(buf, group):
            into = torch.empty(buf.shape, dtype=buf.dtype)
            back.append((buf, into))
        ops.append(dist.P2POp(dist.irecv, into, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, host in back:
        buf.copy_(host)


def send(tensors: Sequence[torch.Tensor], dst: int, group) -> None:
    """``tensors`` to global rank ``dst`` of ``group`` (in order)."""
    exchange([(t, dst) for t in tensors], (), group)


def recv(like: Sequence[Tuple[Sequence[int], torch.dtype]], src: int, group, device
         ) -> List[torch.Tensor]:
    """Tensors of the (shape, dtype) of ``like`` from global rank ``src``
    of ``group``, on ``device``."""
    out = [torch.empty(tuple(shape), dtype=dtype, device=device) for shape, dtype in like]
    exchange((), [(t, src) for t in out], group)
    return out


def rotated(tensors: Sequence[torch.Tensor], group, offset: int) -> List[torch.Tensor]:
    """Each rank's ``tensors`` sent ``offset`` places back around the ring
    of ``group``; what the rank ``offset`` places on sends arrives."""
    if dist.get_world_size(group) == 1:
        return [t.clone() for t in tensors]
    to, frm = group_peer(group, -offset), group_peer(group, offset)
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    exchange([(t, to) for t in tensors], [(b, frm) for b in out], group)
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(rotated(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, *rotated(grads, ctx.group, -1))


def rotate_to_prev(tensors: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """Every rank's ``tensors`` go to the previous rank of ``group`` and the
    next rank's arrive (JAX's ``ppermute`` with ``(i, i - 1)``); the
    gradients go the other way. The tensors travel together, in one
    exchange each way, so every rank's backward pairs them alike."""
    return _Rotate.apply(group, *tensors)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed as it is."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient of this
    rank's slice goes back to it."""
    return x if group is None else _Gather.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``; the ranks' gradients
    gathered back into the whole."""
    return x if group is None else _Scatter.apply(x, group, dim)


def gather_sum_from_group(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; this rank's slice of
    the SUM of the ranks' gradients goes back to it (every rank reads every
    rank's slice, as sequence parallelism's K/V and FSDP's weights are)."""
    return x if group is None else _GatherSum.apply(x, group, dim)


def fsdp_dim(shape: Sequence[int], data: int, tp_dim: Optional[int] = None,
             transposed: bool = False) -> Optional[int]:
    """The axis of a tensor of the port's ``shape`` that FSDP shards over
    ``data`` ranks (JAX ``_augment_fsdp``): the largest axis the TP rule
    leaves free (``tp_dim`` is the port's axis it splits, if any) that
    ``data`` divides, the first in JAX's axis order on a tie; None when
    there is none (the tensor stays replicated). ``transposed`` marks an
    ``nn.Linear`` weight, [out, in] where JAX holds [in, out]: JAX's last
    axis is the port's dim 0. JAX's stacked layer axis [L, ...] has no
    counterpart (the port holds each layer's tensors in its own module)."""
    if data <= 1 or not shape:
        return None
    order = list(range(len(shape)))
    if transposed:
        order.reverse()  # the port's axes in JAX's order
    best = None
    for d in order:
        if d != tp_dim and shape[d] >= data and shape[d] % data == 0:
            if best is None or shape[d] > shape[best]:
                best = d
    return best


# ---------------------------------------------------------------------------
# Sharding a model
# ---------------------------------------------------------------------------


def _parent(root: nn.Module, path: str) -> Tuple[nn.Module, str]:
    *head, attr = path.split(".")
    mod = root
    for p in head:
        mod = getattr(mod, p) if not p.isdigit() else mod[int(p)]
    return mod, attr


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap every module of ``model`` that ``rule_for`` gives a rule for
    its TP wrapper over ``mesh``'s model axis, in place, each holding the
    rank's slice only (the full tensors go with the modules they replace).
    A model axis of 1 leaves the model as it is (data parallelism
    replicates). w4a8 packings are re-laid for the axis first."""
    if mesh.model == 1:
        return model
    from blurr_tpu_torch.ops.quant import repack_w4a8_tree
    from blurr_tpu_torch.parallel import tensor_parallel as tp

    repack_w4a8_tree(model, mesh.model)
    done = set()
    for path, mod in list(model.named_modules()):
        rule = rule_for(path)
        if rule is None or any(path.startswith(p + ".") for p in done) or not tp.is_linear(mod):
            continue
        parent, attr = _parent(model, path)
        setattr(parent, attr, tp.parallel_linear(mod, rule, mesh))
        done.add(path)
    for path, p in list(model.named_parameters()):
        *head, name = path.split(".")
        if name == "embed_tokens":
            parent, attr = _parent(model, path)
            delattr(parent, attr)
            setattr(parent, attr, tp.VocabParallelEmbedding.from_table(p, mesh))
        elif name in _SEPARATE_BIASES and rule_for(".".join(head + [_SEPARATE_BIASES[name]])):
            # a bias kept beside its linear (Qwen2's q/k/v): cut with its output
            parent, attr = _parent(model, path)
            setattr(parent, attr, nn.Parameter(tp.column_slice(p, mesh),
                                               requires_grad=p.requires_grad))
    for path, mod in list(model.named_modules()):
        # Pi-0's k and v stay whole (one KV head) under the rank's query heads
        parts = path.split(".")
        if "joint" in parts and parts[-1] in ("k_proj", "v_proj") and tp.is_linear(mod):
            parent, attr = _parent(model, path)
            setattr(parent, attr, tp.ReplicatedLinear(mod, mesh))
    return model
