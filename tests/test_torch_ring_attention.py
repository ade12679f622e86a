"""Ring attention (``blurr_tpu_torch/ops/ring_attention.py``) on spawned
``gloo`` ranks against the JAX package's ``ring_attention`` and
``grouped_attention`` on the CPU (``tests/test_ring_attention.py``'s cases,
and ``dryrun_multichip`` section 8).

Two spawns, one per world size (2 and 4 ranks, rendezvous through a
``FileStore``), in a module fixture; every rank runs every case of its
world through ``ring_attention_whole`` (each rank its slice of the tokens,
the whole output and the whole input gradients gathered back), and rank 0
reports. The inputs come from a numpy seed, the same on both sides, and
each case is held at JAX's own bound: outputs ``rtol=1e-5, atol=1e-6``,
the gradients ``rtol=1e-4, atol=1e-5``, bf16 inputs ``2e-2``, section 8's
output ``5e-5`` and gradients ``rtol=5e-4, atol=5e-5``. The bf16 case runs
on 4 ranks (JAX's test shards over 8).
"""

import pickle
import time

import numpy as np
import pytest
import torch

SPAWN_DEADLINE_S = 300.0
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6  # tests/test_ring_attention.py
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
DRYRUN_OUT, DRYRUN_RTOL, DRYRUN_ATOL = 5e-5, 5e-4, 5e-5  # parallel/train.py section 8


def _qkv(b=2, nh=4, kvh=1, s=16, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for h in (nh, kvh, kvh))


def _valid(b, s, lengths=None, starts=None):
    """bool [B, S]: keys [start, length) of each row valid."""
    lengths = lengths or [s] * b
    starts = starts or [0] * b
    pos = np.arange(s)[None]
    return (pos < np.array(lengths)[:, None]) & (pos >= np.array(starts)[:, None])


# every case: (name, world, q/k/v, kwargs, dtype, gradient loss or None)
CASES = [
    *((f"plain-n{n}-{'causal' if c else 'full'}", n, _qkv(), {"causal": c, "softclamp": None},
       "float32", None) for n in (2, 4) for c in (False, True)),
    ("gqa-clamp50", 4, _qkv(nh=8, kvh=2, s=12, seed=1), {"causal": True, "softclamp": 50.0},
     "float32", None),
    ("padding", 4, _qkv(s=16, seed=2),
     {"causal": True, "softclamp": None, "k_valid": _valid(2, 16, [13, 9])}, "float32", None),
    ("fully-masked-rows", 4, _qkv(s=16, seed=6),
     {"causal": True, "softclamp": None, "k_valid": _valid(2, 16, starts=[0, 5])}, "float32",
     None),
    ("bf16-128", 4, _qkv(s=128, seed=4), {"causal": True, "softclamp": None}, "bfloat16", None),
    ("default-clamp", 2, _qkv(s=8, seed=5), {"causal": False}, "float32", None),
    ("gradients", 2, _qkv(s=8, seed=3), {"causal": True, "softclamp": None}, "float32",
     "square"),
    ("dryrun-8", 2, _qkv(b=2, nh=4, kvh=2, s=8, d=16, seed=8), {"causal": True}, "float32",
     "sin"),
]


# ---------------------------------------------------------------------------
# The ranks (spawned processes, without JAX)
# ---------------------------------------------------------------------------


def _run_case(case, group):
    from blurr_tpu_torch.ops.ring_attention import ring_attention_whole

    _, _, qkv, kw, dtype, loss = case
    kw = dict(kw)
    if "k_valid" in kw:
        kw["k_valid"] = torch.from_numpy(kw["k_valid"])
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(loss is not None)
               for x in qkv)
    out = ring_attention_whole(q, k, v, group, **kw)
    res = {"out": out.detach().float().numpy()}
    if loss is not None:
        total = (out**2).sum() if loss == "square" else torch.sin(out).sum()
        res["loss"] = float(total)
        res["grads"] = [g.numpy() for g in torch.autograd.grad(total, (q, k, v))]
    return res


def _rank(rank, world, init_method, path, queue):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from blurr_tpu_torch.parallel import mesh as t_mesh

        with open(path, "rb") as f:
            cases = pickle.load(f)
        t_mesh.init_ranks(rank, world, init_method, "cpu")
        group = t_mesh.make_mesh(seq=world)
        out = {case[0]: _run_case(case, group) for case in cases}
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException as exc:  # the parent raises it
        queue.put((rank, exc))
        raise


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: {rank: {case: result}}} of both spawns."""
    import multiprocessing as mp
    import queue as queue_lib

    ctx = mp.get_context("spawn")
    started = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ring{world}")
        path = tmp / "cases.pkl"
        with open(path, "wb") as f:
            pickle.dump([c for c in CASES if c[1] == world], f)
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, world, f"file://{tmp}/store", str(path), q),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        started[world] = (procs, q)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    results, failed = {}, True
    try:
        for world, (procs, q) in started.items():
            got = {}
            while len(got) < world:
                try:
                    rank, out = q.get(timeout=max(0.1, deadline - time.monotonic()))
                except queue_lib.Empty:
                    raise RuntimeError(f"ring ranks of world {world} did not answer")
                if isinstance(out, BaseException):
                    raise RuntimeError(f"rank {rank} of world {world} failed") from out
                got[rank] = out
            results[world] = got
        failed = False
    finally:
        for procs, _ in started.values():
            for p in procs:  # after a failure the others may wait on it: no grace
                p.join(0.0 if failed else max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
    return results


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------


def _jax(case):
    """(JAX ring_attention's output, grouped_attention's, and their
    gradients when the case has a loss) on the case's inputs."""
    import jax
    import jax.numpy as jnp

    from blurr_tpu.ops.attention import grouped_attention
    from blurr_tpu.ops.ring_attention import ring_attention
    from blurr_tpu.parallel.mesh import make_mesh

    _, n, qkv, kw, dtype, loss = case
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in qkv)
    b, _, s, _ = q.shape
    mask = jnp.ones((b, s, s), bool)
    if kw.get("causal", True):
        mask = mask & jnp.tril(jnp.ones((s, s), bool))[None]
    if "k_valid" in kw:
        mask = mask & jnp.asarray(kw["k_valid"])[:, None, :]
    clamp = {"softclamp": kw["softclamp"]} if "softclamp" in kw else {}
    mesh = make_mesh(seq=n)
    jkw = {k_: (jnp.asarray(v_) if k_ == "k_valid" else v_) for k_, v_ in kw.items()}

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh, **jkw)

    def plain(q, k, v):
        return grouped_attention(q, k, v, mask=mask, **clamp)

    # jitted: one compile each, where eager dispatch takes seconds
    out = {"ring": np.asarray(jax.jit(ring)(q, k, v), np.float32),
           "plain": np.asarray(jax.jit(plain)(q, k, v), np.float32), "mask": np.asarray(mask)}
    if loss is not None:
        f = (lambda o: (o**2).sum()) if loss == "square" else (lambda o: jnp.sin(o).sum())
        for name, fn in (("ring", ring), ("plain", plain)):
            val, grads = jax.jit(jax.value_and_grad(lambda *a: f(fn(*a)), argnums=(0, 1, 2)))(
                q, k, v)
            out[f"{name}_loss"], out[f"{name}_grads"] = float(val), [np.asarray(g) for g in grads]
    return out


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _got(ranks, case):
    """Rank 0's result, after checking every rank has the same."""
    world = ranks[case[1]]
    for r in range(1, case[1]):
        np.testing.assert_array_equal(world[r][case[0]]["out"], world[0][case[0]]["out"])
    return world[0][case[0]]


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[0].startswith("plain")] +
                         ["gqa-clamp50", "default-clamp"])
def test_ring_matches_jax_ring_and_plain(ranks, name):
    case = _case(name)
    got, want = _got(ranks, case)["out"], _jax(case)
    for ref in ("ring", "plain"):
        np.testing.assert_allclose(got, want[ref], rtol=OUT_RTOL, atol=OUT_ATOL, err_msg=ref)


@pytest.mark.parametrize("name", ["padding", "fully-masked-rows"])
def test_ring_padding_mask(ranks, name):
    """``k_valid`` travels with its block: the valid rows equal the plain
    attention's; a query row that sees no key is exactly 0, as JAX's ring
    gives (the plain softmax gives the uniform mean there)."""
    case = _case(name)
    got, want = _got(ranks, case)["out"], _jax(case)
    rows = want["mask"].any(-1)[:, None, :].repeat(got.shape[1], 1)  # [B, NH, S]
    np.testing.assert_allclose(got[rows], want["plain"][rows], rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(got, want["ring"], rtol=OUT_RTOL, atol=OUT_ATOL)
    if name == "fully-masked-rows":
        assert (~rows).any() and not got[~rows].any()


def test_ring_bf16_long_sequence(ranks):
    case = _case("bf16-128")
    got, want = _got(ranks, case)["out"], _jax(case)
    np.testing.assert_allclose(got, want["plain"], rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("name, tol", [
    ("gradients", (OUT_RTOL, OUT_ATOL, GRAD_RTOL, GRAD_ATOL)),
    ("dryrun-8", (DRYRUN_OUT, DRYRUN_OUT, DRYRUN_RTOL, DRYRUN_ATOL)),
])
def test_ring_gradients_match(ranks, name, tol):
    """The rotation's backward (the reverse rotation) gives q, k and v the
    gradients of the plain attention and of JAX's ring."""
    out_rtol, out_atol, grad_rtol, grad_atol = tol
    case = _case(name)
    got, want = _got(ranks, case), _jax(case)
    for ref in ("ring", "plain"):
        np.testing.assert_allclose(got["loss"], want[f"{ref}_loss"], rtol=out_rtol,
                                   atol=out_atol)
        for g, w in zip(got["grads"], want[f"{ref}_grads"]):
            np.testing.assert_allclose(g, w, rtol=grad_rtol, atol=grad_atol, err_msg=ref)
