"""The port's training data pipeline (``blurr_tpu_torch.data``) against the
JAX package's (``blurr_tpu.data``) on the CPU.

The shard format is byte-compatible: a directory either package writes,
the other reads (the same manifest and ``.npy`` files). The loader hands out
the same batches (the same per-epoch permutation), with and without its
producer thread, and ``restore(step)`` resumes the same stream. The
transform's pixels are bit-equal to JAX's (both take the same rung of the
resize ladder, then the same numpy arithmetic), and the normalized proprio
and actions equal.
"""

import json

import numpy as np
import pytest
import torch

from blurr_tpu import data as j_data
from blurr_tpu_torch import data as t_data

STATS = {
    "action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
               "mean": [0.0] * 7, "std": [0.02] * 7},
    "proprio": {"p01": [-0.3] * 7, "p99": [0.3] * 7, "mean": [0.0] * 7, "std": [0.1] * 7},
    "num_transitions": 100,
}


def _raw(n, seed=0, size=(48, 64)):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, (n, *size, 3), np.uint8),
        "proprio": rng.uniform(-0.4, 0.4, (n, 7)).astype(np.float32),
        "action": rng.uniform(-0.08, 0.08, (n, 4, 7)).astype(np.float32),
        "input_ids": rng.randint(0, 100, (n, 12)).astype(np.int32),
        "step_id": np.arange(n, dtype=np.int64),
    }


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer, reader", [(j_data, t_data), (t_data, j_data)],
                         ids=["jax-writes", "port-writes"])
def test_shards_cross_read(tmp_path, writer, reader):
    arrays = _raw(11)
    manifest = writer.write_dataset(tmp_path / "ds", arrays, shard_size=4, statistics=STATS)
    assert [s["num_examples"] for s in manifest["shards"]] == [4, 4, 3]
    assert reader.is_sharded_dataset(tmp_path / "ds")
    ds = reader.ShardedDataset(tmp_path / "ds")
    assert ds.num_examples == 11 and ds.statistics == STATS
    idx = np.array([9, 0, 4, 4, 7, 1])
    _same_batch(ds.gather_batch(idx), {k: v[idx] for k, v in arrays.items()})


def test_shard_files_are_the_same_bytes(tmp_path):
    arrays = _raw(7)
    j_data.write_dataset(tmp_path / "j", arrays, shard_size=3)
    with t_data.ShardWriter(tmp_path / "t", shard_size=3) as w:  # example by example
        for i in range(7):
            w.add({k: v[i] for k, v in arrays.items()})
    j_files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert j_files == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in j_files:
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    assert json.loads((tmp_path / "t" / "manifest.json").read_text())["num_examples"] == 7


def test_writer_refuses_what_jax_refuses(tmp_path):
    w = t_data.ShardWriter(tmp_path / "ds", shard_size=2)
    w.add({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="signature"):
        w.add({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="inconsistent"):
        w.add_batch({"a": np.zeros((2, 3), np.float32), "b": np.zeros((3,), np.int32)})
    ds_dir = tmp_path / "ok"
    t_data.write_dataset(ds_dir, {"a": np.zeros((2, 3), np.float32)})
    with pytest.raises(IndexError):
        t_data.ShardedDataset(ds_dir).gather("a", np.array([2]))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_and_restore_match_jax(tmp_path, prefetch, shuffle):
    """Three epochs of batches (10 examples, batch 3: the tail dropped),
    seed 5; then restore(4) in both resumes at the same batch; an
    example_range window (the validation split) too."""
    t_data.write_dataset(tmp_path / "ds", _raw(10, seed=2), shard_size=4)
    kw = dict(seed=5, shuffle=shuffle)
    with j_data.ShardedBatchLoader(tmp_path / "ds", 3, **kw) as jl, \
            t_data.ShardedBatchLoader(tmp_path / "ds", 3, prefetch=prefetch, **kw) as tl:
        assert tl.batches_per_epoch == jl.batches_per_epoch == 3
        for _ in range(9):
            _same_batch(tl.next_batch(), jl.next_batch())
        assert tl.state() == jl.state() == {"consumed": 9}
        jl.restore(4)
        tl.restore({"consumed": 4})
        for _ in range(4):
            _same_batch(tl.next_batch(), jl.next_batch())
    jv = j_data.ShardedBatchLoader(tmp_path / "ds", 2, shuffle=False, example_range=(6, 10))
    tv = t_data.ShardedBatchLoader(tmp_path / "ds", 2, shuffle=False, example_range=(6, 10))
    for _ in range(3):
        _same_batch(tv.next_batch(), jv.next_batch())


def test_loader_surfaces_a_producer_error(tmp_path):
    t_data.write_dataset(tmp_path / "ds", _raw(6), shard_size=3)

    def broken(batch):
        raise RuntimeError("bad transform")

    with t_data.ShardedBatchLoader(tmp_path / "ds", 2, transform=broken, prefetch=2) as tl:
        with pytest.raises(RuntimeError, match="bad transform"):
            tl.next_batch()


def test_transform_pixels_bit_equal_to_jax(tmp_path):
    """Raw 48x64 frames resized to the model's 28x28 by the same rung of
    the Lanczos ladder, then (x/255 - 0.5)/0.5: the same bits; proprio
    (repeated over cond_steps) and actions (gripper passed through) bound-
    and gaussian-normalized as JAX's."""
    raw = _raw(4, seed=3)
    for kind in ("bound", "gaussian"):
        kw = dict(image_size=(28, 28), action_normalization_type=kind,
                  proprio_normalization_type=kind, cond_steps=2)
        want = j_data.Pi0TrainTransform(STATS, **kw)(dict(raw))
        got = t_data.Pi0TrainTransform(STATS, **kw)(dict(raw))
        _same_batch(got, want)
        assert got["pixel_values"].shape == (4, 3, 28, 28)
        assert got["proprios"].shape == (4, 2, 7)
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(STATS))
    _same_batch(t_data.Pi0TrainTransform(str(path), image_size=(28, 28))(dict(raw)),
                j_data.Pi0TrainTransform(str(path), image_size=(28, 28))(dict(raw)))


def test_transform_for_config_matches_jax():
    """The bridge_tiny config: its image size and cond_steps, the
    statistics from the manifest when given, else the config's file."""
    from blurr_tpu.benchmarks import load_cfg
    from blurr_tpu_torch.presets import load_config

    raw = _raw(2, seed=4)
    j_cfg, t_cfg = load_cfg("config/eval/bridge_tiny.yaml"), load_config(
        "config/eval/bridge_tiny.yaml")
    for stats in (STATS, None):
        want = j_data.transform_for_config(j_cfg, dataset_statistics=stats)(dict(raw))
        got = t_data.transform_for_config(t_cfg, dataset_statistics=stats)(dict(raw))
        _same_batch(got, want)
        assert got["pixel_values"].shape[-1] == 56


def test_device_prefetch_on_the_cpu():
    """Tensors of the same values, in order, depth batches ahead; depth 0
    refused."""
    batches = [{"a": np.full((2, 3), i, np.float32), "ids": np.arange(2, dtype=np.int32) + i}
               for i in range(5)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(1)
            yield b

    feed = t_data.device_prefetch(source(), depth=2, device="cpu")
    first = next(feed)
    assert len(pulled) == 3  # the first batch handed out, two more in flight
    got = [first, *feed]
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert isinstance(g["a"], torch.Tensor) and g["ids"].dtype == torch.int32
        np.testing.assert_array_equal(g["a"].numpy(), b["a"])
    with pytest.raises(ValueError, match="depth"):
        next(t_data.device_prefetch(iter(batches), depth=0, device="cpu"))
