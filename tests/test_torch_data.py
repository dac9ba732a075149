"""The training data path of the PyTorch port against the JAX package's
(``utils/data.py``): the shard format both ways, the batch order for every
(seed, epoch, host sharding) and a resume from ``(epoch, step)``, the
prefetch's pass-through, and a ``Trainer`` fed from shards (JAX
``tests/test_data.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.utils import data as jax_data
from flash_attention_metal_tpu_torch.models import ModelConfig, Trainer, make_optimizer
from flash_attention_metal_tpu_torch.utils import data


def _write(tmp_path, writer, sizes=(1000, 700), high=50000, prefix="shard"):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"{prefix}{i}.bin")
        writer(p, rng.integers(0, high, size=n))
        paths.append(p)
    return paths


@pytest.mark.parametrize("high", [50000, 100000], ids=["uint16", "uint32"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shards_written_by_either_package_read_in_the_other(tmp_path, direction, high):
    """Same bytes, same header: a shard of either package reads in the
    other, window for window (uint16 below 65536, uint32 above)."""
    write, read = ((jax_data.write_token_shard, data.TokenDataset) if direction == "jax_to_port"
                   else (data.write_token_shard, jax_data.TokenDataset))
    paths = _write(tmp_path, write, high=high)
    ours = _write(tmp_path, (data.write_token_shard if direction == "jax_to_port"
                             else jax_data.write_token_shard), high=high, prefix="other")
    for p, o in zip(paths, ours):
        assert open(p, "rb").read() == open(o, "rb").read()
        assert open(p + ".json").read() == open(o + ".json").read()
    ds = read(paths)
    assert ds.n_tokens == 1700 and ds.n_windows(15) == 1000 // 16 + 700 // 16
    raw = np.fromfile(paths[1], dtype=np.uint16 if high < 2**16 else np.uint32)
    first_of_second = 1000 // 16
    np.testing.assert_array_equal(ds.window(first_of_second, 15), raw[:16])


def test_bad_shards_and_tokens_are_refused(tmp_path):
    p = str(tmp_path / "x.bin")
    with pytest.raises(ValueError, match="1-D"):
        data.write_token_shard(p, np.zeros((2, 2), np.int64))
    with pytest.raises(ValueError, match="non-negative"):
        data.write_token_shard(p, np.asarray([1, -1]))
    data.write_token_shard(p, np.arange(10))
    with open(p + ".json", "w") as f:
        f.write('{"magic": "other", "dtype": "uint16", "n_tokens": 10}')
    with pytest.raises(ValueError, match="fam_tokens_v1"):
        data.TokenDataset(p)


@pytest.mark.parametrize("seed,num_hosts,batch", [(7, 1, 4), (3, 2, 2), (11, 3, 3)])
def test_batch_order_matches_jax(tmp_path, seed, num_hosts, batch):
    """The same windows in the same order, epoch by epoch and host by host,
    and a resume from any (epoch, step) continues the stream."""
    paths = _write(tmp_path, data.write_token_shard)
    ds, jds = data.TokenDataset(paths), jax_data.TokenDataset(paths)
    for host in range(num_hosts):
        kw = dict(batch_size=batch, seq_len=15, seed=seed, host_id=host, num_hosts=num_hosts,
                  epochs=2)
        ours = list(data.batch_iterator(ds, **kw))
        theirs = list(jax_data.batch_iterator(jds, **kw))
        assert len(ours) == len(theirs) > 2
        for (x, tag), (y, jtag) in zip(ours, theirs):
            assert tag == jtag and x.dtype == np.int32
            np.testing.assert_array_equal(x, y)
        e, s = ours[len(ours) // 2][1]
        resumed = list(data.batch_iterator(ds, **kw, start_epoch=e, start_step=s))
        assert [t for _, t in resumed] == [t for _, t in ours[len(ours) // 2:]]
        for (x, _), (y, _) in zip(resumed, ours[len(ours) // 2:]):
            np.testing.assert_array_equal(x, y)
    hosts = [tuple(r) for h in range(num_hosts)
             for b, _ in data.batch_iterator(ds, batch_size=batch, seq_len=15, seed=seed,
                                             host_id=h, num_hosts=num_hosts, epochs=1)
             for r in b]
    assert len(hosts) == len(set(hosts))  # no window served twice
    with pytest.raises(ValueError, match="batch_size"):
        next(data.batch_iterator(ds, batch_size=10_000, seq_len=15))


def test_prefetch_passes_tags_through(tmp_path):
    """``prefetch_to_device(..., device="cpu")``: int32 tensors, the
    ``(epoch, step)`` tags untouched, every batch in order; nested leaves
    too; a ``sharding`` that is not a ``parallel.mesh.Sharding`` raises."""
    ds = data.TokenDataset(_write(tmp_path, data.write_token_shard))
    it = data.batch_iterator(ds, batch_size=2, seq_len=15, epochs=1)
    want = list(data.batch_iterator(ds, batch_size=2, seq_len=15, epochs=1))
    out = list(data.prefetch_to_device(it, size=3, device="cpu"))
    assert len(out) == len(want) > 0
    for (batch, tag), (w, wtag) in zip(out, want):
        assert torch.is_tensor(batch) and batch.dtype == torch.int32 and batch.shape == (2, 16)
        assert tag == wtag and isinstance(tag, tuple)
        assert torch.equal(batch, torch.from_numpy(w))
    nested = next(data.prefetch_to_device(iter([{"x": np.ones(3, np.int32), "n": 5,
                                                 "l": [np.zeros(2)]}]), device="cpu"))
    assert torch.is_tensor(nested["x"]) and nested["n"] == 5 and torch.is_tensor(nested["l"][0])
    with pytest.raises(TypeError, match="Sharding"):
        next(data.prefetch_to_device(iter([]), sharding=object()))


def test_prefetch_sharding_gives_each_rank_its_block_in_batch_order(tmp_path):
    """``prefetch_to_device(sharding=batch_sharding(mesh))``: on a mesh dp 2
    x tp 2 x sp 2 each rank takes the (dp, sp) block of every global batch
    of ``batch_iterator`` (JAX's order); the blocks tile the batch, and the
    tp ranks of one block read the same."""
    from flash_attention_metal_tpu_torch.models.parallel_train import batch_sharding
    from flash_attention_metal_tpu_torch.parallel.mesh import Mesh

    ds = data.TokenDataset(_write(tmp_path, data.write_token_shard))
    want = [b for b, _ in data.batch_iterator(ds, batch_size=4, seq_len=15, epochs=1)]
    got = {}
    for rank in range(8):
        # The block is a function of the coordinates alone: no group needed.
        mesh = Mesh(("dp", "tp", "sp"), (2, 2, 2), rank, "gloo", torch.device("cpu"), {})
        it = data.batch_iterator(ds, batch_size=4, seq_len=15, epochs=1)
        got[rank] = [b for b, _ in data.prefetch_to_device(it, device="cpu",
                                                           sharding=batch_sharding(mesh))]
    assert len(got[0]) == len(want) > 0
    for i, w in enumerate(want):
        blocks = [[got[dp * 4 + tp * 2 + sp][i] for sp in range(2)] for dp in range(2)
                  for tp in range(2)]
        for tp_blocks in (blocks[0], blocks[2]):
            assert tp_blocks[0].shape == (2, 8)
        rows = [torch.cat(blocks[dp * 2], dim=1) for dp in range(2)]
        assert torch.equal(torch.cat(rows, dim=0), torch.from_numpy(w))
        assert all(torch.equal(a, b) for a, b in zip(blocks[0], blocks[1]))


@pytest.mark.parametrize("attn_dropout", [0.0, 0.1])
def test_trainer_from_shards(tmp_path, attn_dropout):
    """End to end: memmapped shards -> batches -> prefetch -> ``Trainer``
    (JAX ``tests/test_data.py::test_trainer_from_shards``), with and without
    attention dropout: finite losses."""
    cfg = ModelConfig(vocab_size=50304, d_model=128, n_layers=1, n_heads=2, n_kv_heads=2,
                      head_dim=64, d_ff=128, max_seq_len=128, dtype=torch.float32,
                      attn_dropout=attn_dropout)
    ds = data.TokenDataset(_write(tmp_path, data.write_token_shard))
    stream = (b for b, _ in data.prefetch_to_device(
        data.batch_iterator(ds, batch_size=2, seq_len=63, seed=1), device="cpu"))
    tr = Trainer(cfg, optimizer=make_optimizer(warmup_steps=1), seed=0, device="cpu")
    out = tr.train(stream, steps=3)
    assert len(out["losses"]) == 3 and out["final_step"] == 3
    assert all(np.isfinite(x) for x in out["losses"])
