"""PyTorch port: sharded serving (``runtime/sp_decode.py``,
``DecodeEngine(mesh=)``) on a gloo group of 8 CPU ranks, against the port's
and the JAX package's one-device engines and JAX's own sharded engine.

The model is ``tests/test_sp_decode.py``'s (d 128, 2 layers, 4/2 heads,
fp32), its weights JAX's ``init_params`` carried across by
``params_from_jax``.  Every engine serves four greedy requests at ``max_len``
512, so an sp shard holds 128 positions on mesh ``(dp, sp) = (2, 4)`` and
256 on ``(2, 2, 2)``: a 4- and a 30-token prompt, a 120-token prompt whose
decode crosses position 128, and a 250-token prompt whose prefill spans
two shards of (2, 4) and whose decode crosses position 256 (into the
third shard of (2, 4), the second of (2, 2, 2)).  The
speculative windows of the 120-token request straddle the 128 boundary.
The sharded engines run in one group (``tests/torch_dist_cases.py::
sp_decode_cases``); JAX's engines run its Pallas kernels in interpret mode.
Tolerances: greedy tokens equal; per-token logprobs against JAX's sharded
engine within 1e-4; the masked appends bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from flash_attention_metal_tpu.models import ModelConfig as JaxConfig
from flash_attention_metal_tpu.models import init_params as jax_init
from flash_attention_metal_tpu.runtime import engine as jax_engine
from flash_attention_metal_tpu.runtime import sp_decode as jax_sp
from flash_attention_metal_tpu_torch.models import params_from_jax
from flash_attention_metal_tpu_torch.models.transformer import ModelConfig
from flash_attention_metal_tpu_torch.parallel import spawn
from flash_attention_metal_tpu_torch.parallel.mesh import Mesh
from flash_attention_metal_tpu_torch.runtime import sp_decode
from flash_attention_metal_tpu_torch.runtime.engine import DecodeEngine

import torch_dist_cases

FIELDS = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
              d_ff=256, max_seq_len=512)
DRAFT_FIELDS = dict(FIELDS, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=128)
VARIANTS = {"base": {}, "softcap": dict(attn_softcap=30.0), "alibi": dict(attn_alibi=True)}
WINDOWED = dict(attn_window=64, attn_sinks=4)
_rng = np.random.default_rng(0)
REQUESTS = [([5, 6, 7, 8], 12), (list(range(10, 40)), 12),
            (_rng.integers(1, 256, 120).tolist(), 16), (_rng.integers(1, 256, 250).tolist(), 12)]
LOGPROB_TOL = 1e-4
SP4, DTS = (2, 4), (2, 2, 2)


def _jax_cfg(**extra):
    return JaxConfig(**FIELDS, dtype=jnp.float32, attn_impl="auto", **extra)


def _port_cfg(fields=FIELDS, **extra):
    return ModelConfig(**fields, dtype=torch.float32, **extra)


def _fields(cfg: ModelConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the engines' tensors are small, and idle
    threads of the test workers spin on the shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's weights of each variant (PRNGKey 0 for the base model, 3 for
    the softcap and ALiBi ones, as ``test_sp_decode.py``) and of the draft
    (PRNGKey 1)."""
    out = {name: jax_init(jax.random.PRNGKey(0 if name == "base" else 3), _jax_cfg(**extra))
           for name, extra in VARIANTS.items()}
    draft_cfg = JaxConfig(**DRAFT_FIELDS, dtype=jnp.float32)
    out["draft"] = jax_init(jax.random.PRNGKey(1), draft_cfg)
    return out


@pytest.fixture(scope="module")
def params(jax_params):
    def port(tree, cfg):
        return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")

    out = {name: port(jax_params[name], _port_cfg(**extra)) for name, extra in VARIANTS.items()}
    out["draft"] = port(jax_params["draft"], _port_cfg(DRAFT_FIELDS))
    return out


def _tokens(result):
    return {uid: toks for uid, (toks, _) in result.items()}


# (name, mesh, cfg key, engine options); the cfg key names a variant, or
# "windowed" for the dp-only rolling case.
CASES = [
    ("dense_sp4", SP4, "base", dict(seq_axis="sp")),
    ("int8_sp4", SP4, "base", dict(seq_axis="sp", kv_quant="int8")),
    ("fp8_sp4", SP4, "base", dict(seq_axis="sp", kv_quant="fp8")),
    ("dense_tp2", DTS, "base", dict(head_axis="tp")),
    ("dense_dts", DTS, "base", dict(seq_axis="sp", head_axis="tp")),
    ("int8_dts", DTS, "base", dict(seq_axis="sp", head_axis="tp", kv_quant="int8")),
    ("multi3_dts", DTS, "base", dict(seq_axis="sp", head_axis="tp", multi_step=3)),
    ("multi3_int8_dts", DTS, "base", dict(seq_axis="sp", head_axis="tp", multi_step=3,
                                          kv_quant="int8")),
    ("softcap_dts", DTS, "softcap", dict(seq_axis="sp", head_axis="tp")),
    ("alibi_dts", DTS, "alibi", dict(seq_axis="sp", head_axis="tp")),
    ("softcap_int8_dts", DTS, "softcap", dict(seq_axis="sp", head_axis="tp", kv_quant="int8")),
    ("spec_sp4", SP4, "base", dict(seq_axis="sp", draft="draft", spec_gamma=3)),
    ("spec_dts", DTS, "base", dict(seq_axis="sp", head_axis="tp", draft="draft", spec_gamma=3)),
    ("rolling_dp", DTS, "windowed", dict(rolling=True)),
]
# A snapshot of the sharded int8 engine after 6 steps, restored into a
# fresh engine on the same mesh (every rank its own shards).
SNAPSHOT_CASE = ("snapshot_int8_dts", DTS, "base",
                 dict(seq_axis="sp", head_axis="tp", kv_quant="int8", snapshot_after=6))


def _cfg_of(key):
    return _port_cfg(**WINDOWED) if key == "windowed" else _port_cfg(**VARIANTS[key])


@pytest.fixture(scope="module")
def sharded(params, tmp_path_factory):
    """Every case of ``CASES`` on one group of 8 ranks: ``{name: [rank
    results]}``."""
    cfgs = {key: (_fields(_cfg_of(key)), params["base" if key == "windowed" else key])
            for key in ("base", "softcap", "alibi", "windowed")}
    spec = dict(
        requests=REQUESTS, cfgs=cfgs,
        drafts={"draft": (_fields(_port_cfg(DRAFT_FIELDS)), params["draft"])},
        cases=[dict(name=n, mesh=m, cfg=c, engine=e) for n, m, c, e in CASES + [SNAPSHOT_CASE]])
    got = spawn(torch_dist_cases.sp_decode_cases, 8, (spec,), backend="gloo", device="cpu",
                timeout_s=240, workdir=str(tmp_path_factory.mktemp("sp_decode")))
    return {name: [r[name] for r in got] for name, *_ in CASES + [SNAPSHOT_CASE]}


def _single_options(engine: dict, params) -> dict:
    """A case's engine options without the mesh's axes (its one-device
    counterpart)."""
    kw = {k: v for k, v in engine.items() if k not in ("seq_axis", "head_axis")}
    if "draft" in kw:
        kw["draft"] = (params["draft"], _port_cfg(DRAFT_FIELDS))
    return kw


@pytest.fixture(scope="module")
def single(params):
    """The port's one-device engine of each case."""
    out = {}
    for name, _, key, engine in CASES:
        out[name] = torch_dist_cases._engine_run(
            params["base" if key == "windowed" else key], _cfg_of(key), REQUESTS,
            **_single_options(engine, params))
    return out


def _jax_run(params, cfg, mesh=None, **kw):
    eng = jax_engine.DecodeEngine(params, cfg, max_batch=4, max_len=512, eos_id=-1,
                                  harvest_lag=2, mesh=mesh, **kw)
    reqs = [jax_engine.Request(uid=i, prompt=list(p), max_new_tokens=n, temperature=0.0)
            for i, (p, n) in enumerate(REQUESTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.uid: (list(r.generated), list(r.logprobs)) for r in reqs}


@pytest.fixture(scope="module")
def jax_single(jax_params):
    """JAX's one-device engine in each cache mode."""
    return {kv: _jax_run(jax_params["base"], _jax_cfg(), kv_quant=kv)
            for kv in (None, "int8", "fp8")}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_greedy_tokens_equal_the_ports_one_device_engine(sharded, single, name):
    want = _tokens(single[name])
    for rank in sharded[name]:
        assert _tokens(rank) == want


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_sharded_greedy_tokens_equal_jax_one_device_engine(sharded, single, jax_single, kv):
    """The port's one-device engine equals JAX's, and so does every sharded
    engine of that cache mode."""
    want = _tokens(jax_single[kv])
    assert _tokens(single[{None: "dense_sp4", "int8": "int8_sp4", "fp8": "fp8_sp4"}[kv]]) == want
    for name, _, key, engine in CASES:
        if key == "base" and engine.get("kv_quant") == kv and "draft" not in engine:
            assert _tokens(sharded[name][0]) == want, name


def test_sharded_snapshot_restores_into_a_fresh_engine(sharded, single):
    """``snapshot()`` / ``restore()`` on the (2, 2, 2) int8 engine, as JAX's
    engine snapshots its sharded arrays: each rank restores its shards, and
    the restored engine and the one that went on finish every request with
    the one-device engine's tokens and logprobs."""
    want = single["int8_dts"]
    for rank in sharded["snapshot_int8_dts"]:
        assert rank["went_on"] == rank["restored"]
        assert _tokens(rank["restored"]) == _tokens(want)


def test_requests_cross_shard_boundaries():
    """The requests reach past one shard: a decode across position 128 and
    a prefill over two shards of (2, 4), and past 256 on (2, 2, 2)."""
    ends = [len(p) + n for p, n in REQUESTS]
    assert any(len(p) < 128 < len(p) + n for p, n in REQUESTS)
    assert any(128 < len(p) for p, _ in REQUESTS)
    assert max(ends) > 512 // 2


def test_int8_dts_equals_jax_sharded_engine(sharded, jax_params):
    """JAX's own int8 engine on ``(dp, tp, sp) = (2, 2, 2)``: the same
    tokens, per-token logprobs within 1e-4."""
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(DTS), ("dp", "tp", "sp"))
    want = _jax_run(jax_params["base"], _jax_cfg(), mesh=mesh, seq_axis="sp", head_axis="tp",
                    kv_quant="int8")
    got = sharded["int8_dts"][0]
    assert _tokens(got) == _tokens(want)
    for uid in want:
        np.testing.assert_allclose(got[uid][1], want[uid][1], atol=LOGPROB_TOL, rtol=0)


def _append_inputs(t_new: int, starts, seed: int):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((4, 2, 16, 8)).astype(np.float32)
    new = rng.standard_normal((4, 2, t_new, 8)).astype(np.float32)
    start = np.asarray(starts, np.int32)
    owned = (start >= 0) & (start + t_new <= 16)
    return buf, new, start, owned


@pytest.mark.parametrize("per_row", [False, True], ids=["chunk", "per_row"])
def test_masked_appends_equal_jax(per_row):
    """``_masked_append`` and ``_masked_append_scale`` bit for bit against
    JAX's, chunk-wise (slots before, at, inside and past the shard) and row
    by row with windows that straddle either edge of the shard."""
    t_new = 5 if per_row else 4
    starts = [-3, 13, 0, 20] if per_row else [-4, 0, 9, 16]
    buf, new, start, owned = _append_inputs(t_new, starts, 7)
    want = np.asarray(jax_sp._masked_append(jnp.asarray(buf), jnp.asarray(new),
                                            jnp.asarray(start), jnp.asarray(owned),
                                            per_row=per_row))
    got = torch.from_numpy(buf.copy())
    sp_decode._masked_append(got, torch.from_numpy(new), torch.from_numpy(start),
                             torch.from_numpy(owned), per_row=per_row)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)
    want_s = np.asarray(jax_sp._masked_append_scale(
        jnp.asarray(buf[..., 0]), jnp.asarray(new[..., 0]), jnp.asarray(start),
        jnp.asarray(owned), per_row=per_row))
    got_s = torch.from_numpy(buf[..., 0].copy())
    sp_decode._masked_append_scale(got_s, torch.from_numpy(new[..., 0]),
                                   torch.from_numpy(start), torch.from_numpy(owned),
                                   per_row=per_row)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_masked_append_writes_8bit_bytes():
    """An int8 shard takes its bytes unchanged where owned."""
    buf = torch.zeros((2, 1, 8, 4), dtype=torch.int8)
    new = torch.arange(-8, 8, dtype=torch.int8).reshape(2, 1, 2, 4)
    start = torch.tensor([6, 8], dtype=torch.int32)
    sp_decode._masked_append(buf, new, start, (start >= 0) & (start + 2 <= 8))
    assert torch.equal(buf[0, :, 6:8], new[0]) and not buf[1].any()


def test_specs_equal_jax(jax_params, params):
    """``cache_pspec`` and ``param_pspecs`` give JAX's PartitionSpecs."""
    for shape in ((2, 2, 4, 16, 8), (2, 2, 4, 16), (2,)):
        leaf = np.zeros(shape)
        assert sp_decode.cache_pspec(leaf, "dp", "sp", "tp") == tuple(
            jax_sp.cache_pspec(leaf, "dp", "sp", "tp"))
    want = jax_sp.param_pspecs(jax_params["base"], "tp")
    got = sp_decode.param_pspecs(params["base"], "tp")
    assert got["layers"][1] == {k: tuple(v) for k, v in want["layers"][1].items()}
    assert got["lm_head"] == tuple(want["lm_head"]) and got["embed"] == tuple(want["embed"])


def _fake_mesh(shape, names):
    """A ``Mesh`` with no process group: the engine's checks read only its
    axes' sizes."""
    return Mesh(tuple(names), tuple(shape), 0, "gloo", torch.device("cpu"), {})


@pytest.mark.parametrize("axes", [dict(seq_axis="sp"), dict(head_axis="tp")], ids=["sp", "tp"])
def test_rolling_under_sp_or_tp_raises(params, axes):
    with pytest.raises(ValueError, match="dp-only"):
        DecodeEngine(params["base"], _port_cfg(**WINDOWED), max_batch=4, max_len=512,
                     rolling=True, mesh=_fake_mesh(DTS, ("dp", "tp", "sp")), **axes)


def test_paged_with_a_mesh_raises(params):
    with pytest.raises(ValueError, match="single-device"):
        DecodeEngine(params["base"], _port_cfg(), max_batch=4, max_len=512, paged=True,
                     mesh=_fake_mesh(SP4, ("dp", "sp")), seq_axis="sp")


@pytest.mark.parametrize("bad", ["max_batch", "n_kv_heads", "max_len"])
def test_bad_divisibility_raises(params, bad):
    mesh = _fake_mesh((4, 4, 2), ("dp", "tp", "sp"))
    kw = dict(max_batch=8, max_len=512, mesh=mesh, seq_axis="sp")
    cfg = _port_cfg()
    if bad == "max_batch":
        kw["max_batch"] = 6
    elif bad == "n_kv_heads":
        kw["head_axis"] = "tp"  # 2 KV heads over tp 4
    else:
        kw["max_len"] = 384  # 192-position shards
    with pytest.raises(ValueError, match="divide|128-aligned"):
        DecodeEngine(params["base"], cfg, **kw)


def test_windowed_model_under_sp_raises():
    """A windowed config on the sharded path raises, as JAX's (window
    masking is slot-local)."""
    cfg = _port_cfg(**WINDOWED)
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="sliding-window"):
        sp_decode._sp_attn_with_cache({}, x, cfg, None, 0, None, _fake_mesh(SP4, ("dp", "sp")),
                                      seq_axis="sp")


def test_local_offsets_span_past_and_future_shards():
    lengths = torch.tensor([0, 127, 128, 300], dtype=torch.int32)
    assert sp_decode.local_offsets(lengths, 1, 128).tolist() == [-128, -1, 0, 172]
