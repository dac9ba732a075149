"""PyTorch port: the backward autotuner and the router that follows it.

What a CPU run can show: the cache key, the lookup and its memo, the
router's order of precedence (explicit blocks, then a saved decision, then
the rule), ``autotune_bwd`` writing one entry (it races the plain versions
on the host clock, under the key ``cpu/...``), and a training step that the
cache sends through the fused backward, equal to the split-routed step.
Cache files live in a temporary directory; the port's ``DEFAULT_CACHE`` is
pointed at them and the memo reset around each test.
"""

import json

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch.config import BlockSizes
from flash_attention_metal_tpu_torch.harness import autotune
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
from flash_attention_metal_tpu_torch.models import trainer as tr
from flash_attention_metal_tpu_torch.models.transformer import ModelConfig
from flash_attention_metal_tpu_torch.utils.roofline import dq_slot_count


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A cache path the lookups read; the memo is reset before and after."""
    path = tmp_path / "autotune_cache_torch.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(path))
    autotune.reset_memo()
    yield path
    autotune.reset_memo()


def _write(path, entries):
    path.write_text(json.dumps(entries))
    autotune.reset_memo()


def _key(q, k, causal=True):
    b, h, n, d = q.shape
    return autotune._key("bwd", b, h, k.shape[1], n, k.shape[2], d, causal, q.dtype, q.device)


def test_key_format_names_the_device_and_the_kv_heads():
    """The JAX key (``chip/kind/b..h..q..kv..d../causal../dtype``) with the
    KV head count after the q-heads; the CPU's plain versions key as cpu."""
    key = autotune._key("bwd", 4, 16, 8, 2048, 2048, 64, True, torch.bfloat16, "cpu")
    assert key == "cpu/bwd/b4h16kv_heads8q2048kv2048d64/causal1/bfloat16"
    assert autotune._key("bwd", 1, 2, 2, 128, 256, 64, False, torch.float32, "cpu") == \
        "cpu/bwd/b1h2kv_heads2q128kv256d64/causal0/float32"
    assert autotune.DEFAULT_CACHE != "autotune_cache.json"


def test_lookup_reads_the_cache_once_and_misses_without_it(cache):
    q = torch.zeros((1, 2, 128, 64))
    args = (1, 2, 2, 128, 128, 64, True, torch.float32)
    assert autotune.lookup_bwd(*args, device="cpu") is None  # no file
    _write(cache, {_key(q, q): {"impl": "fused", "blocks": {}, "us": 1.0}})
    assert autotune.lookup_bwd(*args, device="cpu") == ("fused", {})
    assert autotune.lookup_bwd(1, 2, 1, 128, 128, 64, True, torch.float32, device="cpu") is None
    cache.write_text("{}")  # the memo holds the first read until it is reset
    assert autotune.lookup_bwd(*args, device="cpu") is not None
    autotune.reset_memo()
    assert autotune.lookup_bwd(*args, device="cpu") is None


def test_unknown_impl_raises(cache):
    q = torch.zeros((1, 2, 128, 64))
    _write(cache, {_key(q, q): {"impl": "fast", "blocks": {}, "us": 1.0}})
    with pytest.raises(ValueError, match="unknown backward impl"):
        fb.bwd_route(q, q, None, causal=True)


def test_router_order_of_precedence(cache):
    q = torch.zeros((1, 2, 128, 64))
    off = torch.zeros(1, dtype=torch.int32)
    # No cache file: the rule (tri for a static offset, split for a tensor).
    assert fb.bwd_route(q, q, None, causal=True) == "tri"
    assert fb.bwd_route(q, q, off, causal=True) == "split"
    # A fused decision wins for both offsets.
    _write(cache, {_key(q, q): {"impl": "fused", "blocks": {}}})
    assert fb.bwd_route(q, q, None, causal=True) == "fused"
    assert fb.bwd_route(q, q, off, causal=True) == "fused"
    # Explicit blocks skip the lookup.
    assert fb.bwd_route(q, q, off, causal=True, block_sizes=BlockSizes()) == "split"
    # A split decision where tri would otherwise apply.
    _write(cache, {_key(q, q): {"impl": "split", "blocks": {}}})
    assert fb.bwd_route(q, q, None, causal=True) == "split"
    # A tri decision only where the triangular kernel applies.
    _write(cache, {_key(q, q): {"impl": "tri", "blocks": {}}})
    assert fb.bwd_route(q, q, None, causal=True) == "tri"
    assert fb.bwd_route(q, q, off, causal=True) == "split"
    # Another shape misses: the rule.
    q2 = torch.zeros((1, 2, 256, 64))
    assert fb.bwd_route(q2, q2, None, causal=True) == "tri"
    assert fb.bwd_route(q2, q2, off, causal=True) == "split"


def test_a_fused_decision_whose_tile_is_not_built_raises(cache):
    """The fused kernel's tiles are built in: a saved decision that names a
    tile is refused, not ignored."""
    q = torch.zeros((1, 2, 128, 64))
    lse = torch.zeros((1, 2, 128))
    _write(cache, {_key(q, q): {"impl": "fused", "blocks": {"block_kv_fused": 128}}})
    with pytest.raises(ValueError, match="tiles"):
        fb.flash_attention_bwd_auto(q, q, q, q, q, lse, causal=True)


def test_autotune_bwd_on_the_cpu_writes_one_entry(cache):
    logs = []
    impl, blocks = autotune.autotune_bwd((1, 2, 2, 128, 64), dtype=torch.float32, device="cpu",
                                         iters=1, log=logs.append)
    entries = json.loads(cache.read_text())
    key = "cpu/bwd/b1h2kv_heads2q128kv128d64/causal1/float32"
    assert list(entries) == [key]
    assert entries[key]["impl"] == impl and entries[key]["blocks"] == blocks
    assert set(entries[key]["raced_us"]) == {"split", "fused", "tri"}
    assert len(logs) == 3
    # A second call returns the stored decision without racing.
    assert autotune.autotune_bwd((1, 2, 2, 128, 64), dtype=torch.float32, device="cpu",
                                 log=logs.append) == (impl, blocks)
    assert len(logs) == 3
    # GQA: no triangular candidate.
    assert [c[0] for c in autotune.bwd_candidates(4, 2, True, torch.bfloat16)] == ["split", "fused"]


def test_record_bwd_stores_a_decision_the_router_follows_at_once(cache):
    """A decision stored by hand (as ``chip_smoke.py`` does for the training
    shapes) is read by the next lookup, with no memo reset in between."""
    q, k = torch.zeros((1, 2, 128, 64)), torch.zeros((1, 1, 128, 64))
    assert fb.bwd_route(q, k, None, causal=True) == "split"  # GQA: no tri
    autotune.record_bwd((1, 2, 1, 128, 64), "fused", {}, dtype=torch.float32, device="cpu")
    assert fb.bwd_route(q, k, None, causal=True) == "fused"
    assert fb.bwd_route(q, k, None, causal=False) == "split"  # another key
    with pytest.raises(ValueError, match="unknown backward impl"):
        autotune.record_bwd((1, 2, 1, 128, 64), "fast", {}, dtype=torch.float32, device="cpu")


def test_autotune_main_refuses_a_missing_card():
    assert autotune.main(["--phase", "train"]) == 1


CFG = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=64, d_ff=256, max_seq_len=256, dtype=torch.float32)


def test_training_step_through_the_fused_route_equals_the_split_step(cache, monkeypatch):
    """A saved "fused" decision for the model's attention shape sends the
    op's backward to the fused kernel's plain version (counted here); one
    AdamW step then equals the split-routed step within 1e-5."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 128)).astype(np.int64))

    def step():
        t = tr.Trainer(CFG, optimizer=tr.make_optimizer(warmup_steps=1), seed=0, device="cpu")
        loss = t.step(tokens)
        return loss, [p.detach().clone() for p in tr.param_leaves(t.state.params)]

    fused_calls = []
    real = fb.flash_attention_bwd_fused_plain
    monkeypatch.setattr(fb, "flash_attention_bwd_fused_plain",
                        lambda *a, **k: (fused_calls.append(1), real(*a, **k))[1])
    loss_split, params_split = step()
    assert fused_calls == []
    q = torch.zeros((2, CFG.n_heads, 128, 64))
    k = torch.zeros((2, CFG.n_kv_heads, 128, 64))
    _write(cache, {_key(q, k): {"impl": "fused", "blocks": {}}})
    loss_fused, params_fused = step()
    # Two layers under remat: each backward runs the fused route once.
    assert len(fused_calls) == CFG.n_layers
    assert abs(loss_fused - loss_split) < 1e-6
    for a, b in zip(params_fused, params_split):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_the_op_bounds_the_fused_workspace_by_its_int_offset(cache, monkeypatch):
    """The op hands the backward its offset as an int32 tensor, and an int
    offset also as ``q_offset_max``: the fused kernel then reads each
    offset no higher than it.  A tensor offset gives no bound."""
    q = torch.zeros((1, 2, 128, 64), requires_grad=True)
    kv = torch.zeros((1, 2, 128, 64))
    _write(cache, {_key(q, kv): {"impl": "fused", "blocks": {}}})
    seen = []
    real = fb.flash_attention_bwd_fused
    monkeypatch.setattr(fb, "flash_attention_bwd_fused",
                        lambda *a, **k: (seen.append(k["q_offset_max"]), real(*a, **k))[1])
    from flash_attention_metal_tpu_torch.ops.attention import flash_attention

    flash_attention(q, kv, kv, causal=True).sum().backward()
    flash_attention(q, kv, kv, 0, causal=True).sum().backward()
    flash_attention(q, kv, kv, torch.zeros(1, dtype=torch.int32), causal=True).sum().backward()
    assert seen == [0, 0, None]


def test_router_declines_a_fused_decision_whose_workspace_does_not_fit(cache, monkeypatch):
    """A saved "fused" decision is followed while the dQ workspace (an fp32
    accumulator of dQ's size and a counter per 32 query rows of each
    q-head) stays within ``FUSED_WORKSPACE_SHARE`` of the free bytes, and
    declined for the untuned rule past it, whatever the offset.  The CPU
    has no workspace, so the free bytes are injected."""
    q = torch.zeros((2, 4, 256, 64))
    off = torch.zeros(2, dtype=torch.int32)
    _write(cache, {_key(q, q): {"impl": "fused", "blocks": {}}})
    # 2 x 4 x 256 x 64 fp32 values, the ticket and 8 counters per head.
    need = 4 * (2 * 4 * 256 * 64 + 1 + 2 * 4 * 8)
    assert fb.fused_workspace_bytes(q) == need
    monkeypatch.setattr(fb, "_free_device_bytes", lambda device: need / fb.FUSED_WORKSPACE_SHARE)
    assert fb.bwd_route(q, q, None, causal=True) == "fused"
    assert fb.bwd_route(q, q, off, causal=True) == "fused"
    monkeypatch.setattr(fb, "_free_device_bytes", lambda device: need / fb.FUSED_WORKSPACE_SHARE - 1)
    assert fb.bwd_route(q, q, None, causal=True) == "tri"
    assert fb.bwd_route(q, q, off, causal=True) == "split"


def test_dq_slot_count_matches_the_kernels_packing():
    """``roofline.dq_slot_count`` counts the slots ``csrc/dq_slots.cuh``
    packs for the triangular backward (``flash_tri.dq_slots_shape``)."""
    assert dq_slot_count(2048, 2048, 0) == 528
    assert dq_slot_count(2048, 2048, 2047) == 1024
    assert dq_slot_count(128, 128, -70) == 1
    assert dq_slot_count(200, 300, 100) == 3 + 4 + 5 + 5
    assert ft.dq_slots_shape(4, 16, 2048, 2048, 0, 128) == (4 * 16 * 528, 64, 128)
