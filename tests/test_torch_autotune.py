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
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flash_attention_metal_tpu_torch.config import BlockSizes
from flash_attention_metal_tpu_torch.harness import autotune
from flash_attention_metal_tpu_torch.kernels import flash_bwd as fb
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_tri as ft
from flash_attention_metal_tpu_torch.models import trainer as tr
from flash_attention_metal_tpu_torch.models.transformer import ModelConfig


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
    # No cache file: the rule, the split pair for every offset (the H100's
    # race: split beat tri and fused at every shape raced).
    assert fb.bwd_route(q, q, None, causal=True) == "split"
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
    assert fb.bwd_route(q2, q2, None, causal=True) == "split"
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
    assert fb.bwd_route(q, q, None, causal=True) == "split"
    assert fb.bwd_route(q, q, off, causal=True) == "split"


def _tri_bwd_launch(monkeypatch, shape_q, n_kv, off) -> dict:
    """What ``flash_tri_bwd`` hands the C entry for meta tensors of the
    given shapes: the workspace it allocated (bytes, through
    ``flash_bwd.dq_workspace``) and the entry's counter count, offset and
    lengths.  The library and the stream are stand-ins."""
    seen = {}
    real = ft.dq_workspace

    def workspace(q, ws=None):
        ws, args = real(q, ws)
        seen["workspace_bytes"] = ws.numel() * ws.element_size()
        return ws, args

    def entry(*args):
        seen["n_counters"], seen["n_q"], seen["n_kv"], seen["off"] = (
            args[11], args[14], args[15], args[18])
        return 0

    monkeypatch.setattr(ft, "dq_workspace", workspace)
    monkeypatch.setattr(ft, "_lib", lambda: SimpleNamespace(fam_flash_tri_bwd=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    b, h, n_q, d = shape_q
    q = torch.empty(shape_q, dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, h, n_kv, d), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((b, h, n_q), device="meta")
    before = ft.flash_attention_bwd_tri.launches
    dq, dk, dv = ft.flash_tri_bwd(q, kv, kv, q, rows, rows, off, sm_scale=d ** -0.5)
    assert ft.flash_attention_bwd_tri.launches == before + 1
    assert dq.dtype == torch.bfloat16 and dk.dtype == dv.dtype == torch.float32
    return seen


def test_tri_bwd_workspace_is_the_fused_kernels_at_high_occupancy(monkeypatch):
    """The triangular backward's dQ workspace is the fused kernel's
    (``dq_workspace_shape``): at the bench's high-occupancy shape
    ``[16,8,2048,64]`` 16,777,216 fp32 accumulator words and 8,193 int32
    counters (the ticket, one per 32 query rows of each head), 67,141,636
    bytes, where the first design's 528 slots of 64 x 64 fp32 per head took
    1,107,296,256."""
    seen = _tri_bwd_launch(monkeypatch, (16, 8, 2048, 64), 2048, 0)
    assert seen["workspace_bytes"] == 67_141_636
    assert seen["workspace_bytes"] == 4 * fb.dq_workspace_shape(16, 8, 2048, 64)[0]
    assert seen["n_counters"] == fb.dq_counter_count(16, 8, 2048) == 8193
    assert (seen["n_q"], seen["n_kv"], seen["off"]) == (2048, 2048, 0)
    assert 16 * 8 * 528 * 64 * 64 * 4 == 1_107_296_256


@pytest.mark.parametrize("n_kv,off", [(2048, 0), (2048, 2047), (2048, -1000), (1024, 0),
                                      (4096, 300)],
                         ids=["off0", "off2047", "off_neg1000", "kv1024", "kv4096_off300"])
def test_tri_bwd_workspace_ignores_offset_and_n_kv(monkeypatch, n_kv, off):
    """The workspace grows with the query rows only: the offset (0 against
    2047, where the slots were 528 and 1024 a head, or negative) and n_kv
    leave it at 67,141,636 bytes for q ``[16,8,2048,64]``; the offset
    reaches the entry as given."""
    seen = _tri_bwd_launch(monkeypatch, (16, 8, 2048, 64), n_kv, off)
    assert seen["workspace_bytes"] == 67_141_636
    assert (seen["n_kv"], seen["off"]) == (n_kv, off)


def _fwd_key(q, k, causal=True):
    b, h, n, d = q.shape
    return autotune._key("fwd", b, h, k.shape[1], n, k.shape[2], d, causal, q.dtype, q.device)


def test_untuned_backward_rule_is_the_split_pair_the_h100_race_chose(cache):
    """Pinned: with no saved decision every call takes the split pair,
    plain causal calls with equal heads and a static offset included (the
    race on the card: split 1024.9 us against tri 1190.0 and fused 1191.8 at
    [16, 8, 2048, 64], 2034.5 against 2220.9 and 2221.3 at D 128; PERF.md
    §6).  The triangular backward runs only where a saved decision names
    it."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 2, 128, 64), dtype=dtype)
        for off in (None, 0, 5):
            assert fb.bwd_route(q, q, off, causal=True) == "split"
    assert autotune.untuned_route("bwd", 16, 8, 8, 2048, 2048, 64, True, torch.bfloat16) == "split"
    q = torch.zeros((1, 2, 128, 64))
    autotune.record_bwd((1, 2, 2, 128, 64), "tri", {}, dtype=torch.float32, device="cpu")
    assert fb.bwd_route(q, q, None, causal=True) == "tri"


def test_fwd_route_follows_a_saved_decision_and_declines_one_that_does_not_apply(cache):
    q = torch.zeros((1, 2, 128, 64))
    t_off = torch.zeros(1, dtype=torch.int32)
    # No decision: the rule.
    assert ff.fwd_route(128, None, causal=True, q=q, k=q) == "tri"
    assert ff.fwd_route(128, None, causal=False, q=q, k=q) == "lean"
    # A saved "general" wins for a plain call, causal or not.
    autotune.record_fwd((1, 2, 2, 128, 64), "general", dtype=torch.float32, device="cpu")
    autotune.record_fwd((1, 2, 2, 128, 64), "general", causal=False, dtype=torch.float32,
                        device="cpu")
    assert ff.fwd_route(128, None, causal=True, q=q, k=q) == "general"
    assert ff.fwd_route(128, None, causal=False, q=q, k=q) == "general"
    # A saved "tri" is declined for a tensor offset and for a feature.
    autotune.record_fwd((1, 2, 2, 128, 64), "tri", dtype=torch.float32, device="cpu")
    assert ff.fwd_route(128, 3, causal=True, q=q, k=q) == "tri"
    assert ff.fwd_route(128, t_off, causal=True, q=q, k=q) == "general"
    assert ff.fwd_route(128, None, causal=True, featured=True, q=q, k=q) == "general"
    # A saved "lean" past LEAN_MAX_KV is declined (the same key at N_kv 2048
    # is another shape: a decision recorded for it by hand).
    n = 2 * ff.LEAN_MAX_KV
    q2 = torch.zeros((1, 2, n, 64))
    autotune.record_fwd((1, 2, 2, n, 64), "lean", causal=False, dtype=torch.float32, device="cpu")
    assert ff.fwd_route(n, None, causal=False, q=q2, k=q2) == "general"
    # Without q and k the router asks nothing: the rule.
    assert ff.fwd_route(128, None, causal=True) == "tri"
    # The wrapper the router calls follows the decision.
    autotune.record_fwd((1, 2, 2, 128, 64), "general", dtype=torch.float32, device="cpu")
    called = []
    real = ff.flash_fwd_general
    ff.flash_fwd_general = lambda *a, **kw: called.append("general") or real(*a, **kw)
    try:
        ff.flash_attention_fwd(q, q, q, causal=True)
    finally:
        ff.flash_fwd_general = real
    assert called == ["general"]
    with pytest.raises(ValueError, match="unknown forward impl"):
        autotune.record_fwd((1, 2, 2, 128, 64), "grid", device="cpu")


def test_autotune_fwd_on_the_cpu_races_the_candidates(cache):
    logs = []
    impl = autotune.autotune_fwd((1, 2, 2, 128, 64), dtype=torch.float32, device="cpu", iters=1,
                                 log=logs.append)
    entries = json.loads(cache.read_text())
    key = "cpu/fwd/b1h2kv_heads2q128kv128d64/causal1/float32"
    assert entries[key]["impl"] == impl and set(entries[key]["raced_us"]) == {"general", "tri"}
    assert autotune.lookup_fwd_impl(1, 2, 2, 128, 128, 64, True, torch.float32,
                                    device="cpu") == impl
    assert autotune.fwd_candidates(1024, 1024, False) == ["general", "lean"]
    assert autotune.fwd_candidates(2048, 2048, False) == ["general"]
    assert autotune.fwd_candidates(8192, 8192, True) == ["general", "tri"]
    assert autotune.tri_candidates(16384) == ["tri"]


def test_validate_drops_an_entry_that_does_not_beat_the_untuned_route(cache):
    """A paired re-check on an injected clock: the saved causal "general"
    loses to the untuned "tri" and is replaced by it; the non-causal
    "general" beats the untuned "lean" and the backward "fused" the
    untuned split pair, so both stay; a saved "split", the rule itself, is
    not raced."""
    autotune.record_fwd((1, 2, 2, 128, 64), "general", dtype=torch.float32, device="cpu")
    autotune.record_fwd((1, 2, 2, 128, 64), "general", causal=False, dtype=torch.float32,
                        device="cpu")
    autotune.record_bwd((1, 2, 2, 128, 64), "fused", {}, dtype=torch.float32, device="cpu")
    autotune.record_bwd((1, 2, 2, 256, 64), "split", {}, dtype=torch.float32, device="cpu")
    speed = {"flash_fwd_general": 2.0, "flash_fwd_lean": 3.0, "flash_attention_tri": 1.0,
             "flash_attention_bwd": 2.0, "flash_attention_bwd_fused": 1.0}

    def timer(fn, args, iters):
        return speed[getattr(fn, "func", fn).__name__]

    logs = []
    dropped = autotune.validate(str(cache), device="cpu", repeats=1, timer=timer,
                                log=logs.append)
    assert dropped == ["cpu/fwd/b1h2kv_heads2q128kv128d64/causal1/float32"]
    entries = json.loads(cache.read_text())
    assert entries[dropped[0]]["impl"] == "tri" and entries[dropped[0]]["dropped"] == "general"
    assert entries["cpu/fwd/b1h2kv_heads2q128kv128d64/causal0/float32"]["impl"] == "general"
    assert entries["cpu/bwd/b1h2kv_heads2q128kv128d64/causal1/float32"]["impl"] == "fused"
    q = torch.zeros((1, 2, 128, 64))
    assert ff.fwd_route(128, None, causal=True, q=q, k=q) == "tri"
    assert any("untuned route; kept" in line for line in logs)


def test_audit_lists_the_benchmark_shapes_without_an_entry(cache):
    keys = autotune.audit_keys("cpu")
    assert len(keys) == 2 * 8 + 2 * 2 * 2
    assert "cpu/fwd/b512h1kv_heads1q128kv128d64/causal0/bfloat16" in keys
    assert "cpu/bwd/b16h8kv_heads8q2048kv2048d128/causal1/bfloat16" in keys
    cache.write_text(json.dumps({k: {"impl": "general"} for k in keys[:-3]}))
    logs = []
    assert autotune.audit(str(cache), device="cpu", log=logs.append) == keys[-3:]
    assert logs[-1].startswith("audit: 3 ")
    cache.write_text(json.dumps({k: {"impl": "general"} for k in keys}))
    assert autotune.audit(str(cache), device="cpu", log=logs.append) == []


@pytest.mark.parametrize("phase", ["sweep", "sweep-causal", "validate", "audit", "all"])
def test_autotune_phases_refuse_a_missing_card(phase):
    assert autotune.main(["--phase", phase]) == 1
