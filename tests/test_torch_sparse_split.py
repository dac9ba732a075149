"""PyTorch port: the block-sparse kernels' walks and grids, the backward's
chunk plan and the chunked dK/dV merge.

The bf16 dK/dV kernel (``csrc/flash_bwd_sm90.cuh``, ``SparseWalk``) runs one
block per chunk of a plan: a KV tile's walk over the group's q-heads and its
transposed list, cut into chunks when longer than a cap, the chunks' fp32
partials summed in chunk order by the last of them.  The plan and the cap
are pure functions of the mask's list lengths and static shapes, so they are
checked here on the CPU; the chunked walk's plain version (the kernel's
arithmetic, pair by pair from the tables) against the unsplit plain version
to fp32 rounding, and against JAX's ``flash_attention_block_sparse_bwd`` in
interpret mode within ``tests/test_torch_flash_mask.py``'s 1e-4 of the
largest gradient (equal heads, and GQA against JAX's repeat-and-sum); the C
entries' arguments through a recorder (no card here).  The bf16 forward
(``csrc/flash_fwd_sm90.cuh``, ``SparseFwdWalk``) walks each Q tile's list,
Q tiles issued longest list first like dQ's: its entry's arguments through
the recorder, and the plain forward on masks whose Q lists include empty
ones (the kernel's walk of no step: o = 0, lse = -inf) against JAX's
forward in interpret mode.  The kernels run on the card in
``tests/test_torch_gpu.py``.
"""

import ctypes
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import flash_mask as jfm
from flash_attention_metal_tpu_torch.harness.verify import block_sparse_rung_mask
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import flash_mask as fm
from flash_attention_metal_tpu_torch.kernels.flash_bwd import bwd_delta

N = 512
# tests/test_torch_flash_mask.py's masks, and one whose first KV tile has a
# long transposed list: every row sees the first 64 columns, plus a band.
MASKS = {
    "banded-stripes": lambda r, c: (c <= r) & (((r - c) < 96) | ((c % 192) < 64)),
    "chunked-local": lambda r, c: (r // 160) == (c // 160),
    "dead-rows": lambda r, c: (r >= 64) & (c <= r),
    "rung11": lambda r, c: (c <= r) & (((r - c) < N // 4) | ((c % (3 * N // 8)) < N // 8)),
    "long-list": lambda r, c: (c < 64) | ((c <= r) & (r - c < 64)),
}
H100_SMS = 132
TOL_GRAD = 1e-4  # tests/test_torch_flash_mask.py's, of the largest gradient
# The chunked sums against the unsplit ones, both fp32 on the CPU: only
# the order of the additions differs (reads up to ~8e-7).
TOL_ORDER = 5e-6


def _mask(name, n=N):
    return fm.BlockMask(MASKS[name], n, n, 128, 128)


def _walk(plan: fm.DkvPlan, tile: int):
    """The tile's chunks in chunk order, as (first pair, end pair, chunks,
    first slot, split tile)."""
    rows = sorted((e for e in plan.entries.tolist() if e[0] == tile), key=lambda e: e[3])
    assert [e[3] for e in rows] == list(range(len(rows)))
    return [(e[1], e[2], e[4], e[5], e[6]) for e in rows]


@pytest.mark.parametrize("cap", [1, 3, 7, 1000])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_plan_covers_every_pair_once_in_list_order(name, group, cap):
    """Every (KV tile, q-head of the group, list entry) is walked by exactly
    one chunk, in list order within each head; chunks are at most ``cap``
    pairs, of near-equal length; split tiles own distinct slots and
    tickets."""
    bm = _mask(name)
    plan = fm.dkv_plan(bm.kv_lengths, group, cap)
    t = bm.tables("cpu")
    kv_ptr, kv_list = t.kv_ptr.tolist(), t.kv_list.tolist()
    slots, tickets = set(), set()
    for tile, length in enumerate(bm.kv_lengths.tolist()):
        chunks = _walk(plan, tile)
        assert chunks[0][0] == 0 and chunks[-1][1] == group * length
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))  # no gap, no overlap
        sizes = [end - first for first, end, *_ in chunks]
        assert max(sizes) <= cap and max(sizes) - min(sizes) <= 1
        walked = [(p // length, kv_list[kv_ptr[tile] + p % length][0])
                  for first, end, *_ in chunks for p in range(first, end)]
        want = [(g, q_tile) for g in range(group)
                for q_tile, _ in kv_list[kv_ptr[tile]:kv_ptr[tile + 1]]]
        assert walked == want
        if len(chunks) > 1:
            assert all(c[2] == len(chunks) for c in chunks)
            slot0, split = chunks[0][3], chunks[0][4]
            assert all((c[3], c[4]) == (slot0, split) for c in chunks)
            assert not slots & set(range(slot0, slot0 + len(chunks))) and split not in tickets
            slots |= set(range(slot0, slot0 + len(chunks)))
            tickets.add(split)
    assert slots == set(range(plan.slots)) and tickets == set(range(plan.split_tiles))
    assert plan.chunks == len(plan.entries) and plan.entries.dtype == np.int32
    assert plan.entries.shape[1] == fm.PLAN_INTS


@pytest.mark.parametrize("cap", [2, 5, 16])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_a_tile_whose_walk_fits_the_cap_is_not_split(name, cap):
    bm = _mask(name)
    plan = fm.dkv_plan(bm.kv_lengths, 2, cap)
    for tile, length in enumerate(bm.kv_lengths.tolist()):
        chunks = _walk(plan, tile)
        if 2 * length <= cap:  # one chunk: no slot, no ticket, stored from registers
            assert chunks == [(0, 2 * length, 1, 0, 0)]
        else:
            assert len(chunks) == -(-2 * length // cap) > 1


@pytest.mark.parametrize("name", sorted(MASKS))
def test_chunks_and_q_tiles_issue_longest_first(name):
    bm = _mask(name)
    plan = fm.dkv_plan(bm.kv_lengths, 2, 3)
    sizes = plan.entries[:, 2] - plan.entries[:, 1]
    assert np.all(np.diff(sizes) <= 0)
    keys = [(-int(s), int(e[0]), int(e[3])) for s, e in zip(sizes, plan.entries)]
    assert keys == sorted(keys)  # ties in tile, then chunk order
    order = fm.dq_order(bm.q_lengths)
    assert sorted(order.tolist()) == list(range(len(bm.q_lengths)))
    lengths = bm.q_lengths[order]
    assert np.all(np.diff(lengths) <= 0) and order.dtype == np.int32


def test_the_plan_depends_on_no_tensor_data():
    """The cap and the plan come from the lists' lengths and static shapes:
    two masks whose transposed lists have the same lengths but other
    entries and bits get the same plan; and the cap reads no tensor."""
    one = fm.BlockMask(lambda r, c: c <= r, N, N, 64, 64)
    two = fm.BlockMask(lambda r, c: (c <= r) & ((r + c) % 3 > 0), N, N, 64, 64)
    assert np.array_equal(one.kv_lengths, two.kv_lengths)
    assert not torch.equal(one.tables("cpu").bit_tiles, two.tables("cpu").bit_tiles)
    for shape in [(1, 4, 2, 128), (4, 8, 2, 64), (2, 2, 1, 64)]:
        caps = {fm.dkv_chunk_cap(m.kv_lengths, *shape, H100_SMS) for m in (one, two)}
        assert len(caps) == 1
        cap = caps.pop()
        assert isinstance(cap, int) and cap >= fm.MIN_CHUNK_PAIRS
        plans = [fm.dkv_plan(m.kv_lengths, shape[2], cap) for m in (one, two)]
        assert np.array_equal(plans[0].entries, plans[1].entries)
        assert (plans[0].slots, plans[0].split_tiles) == (plans[1].slots, plans[1].split_tiles)
    # The mask keeps each plan beside its tables: built once per (device, group, cap).
    first = one.dkv_plan("cpu", 2, 5)
    assert one.dkv_plan("cpu", 2, 5) is first
    assert np.array_equal(first[1].numpy(), first[0].entries)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("batch,kv_heads,head_dim", [(1, 4, 128), (4, 8, 64), (1, 1, 64), (16, 8, 128)])
def test_cap_spreads_the_pairs_over_the_block_slots(batch, kv_heads, head_dim, sms):
    bm = fm.BlockMask(block_sparse_rung_mask(2048), 2048, 2048, 128, 128)
    cap = fm.dkv_chunk_cap(bm.kv_lengths, batch, kv_heads, 2, head_dim, sms)
    total = batch * kv_heads * 2 * int(bm.kv_lengths.sum())
    slots = sms * fm.DKV_BLOCKS_PER_SM[head_dim]
    assert cap == max(fm.MIN_CHUNK_PAIRS, int(np.ceil(fm.CHUNK_SLACK * total / slots)))
    plan = fm.dkv_plan(bm.kv_lengths, 2, cap)
    assert int((plan.entries[:, 2] - plan.entries[:, 1]).max()) <= cap


def test_rung11_at_2048_splits_kv_tiles_0_to_3_at_the_d128_shape():
    """Rung 11's mask at N = 2048 (transposed lists 32, 31, 30, 29, ...,
    1 long) at ``onchip.SPARSE_D128_*`` (q [1,8,2048,128] over 4 KV heads)
    on 132 SMs: the four longest walks (64, 62, 60, 58 pairs) are split."""
    bm = fm.BlockMask(block_sparse_rung_mask(2048), 2048, 2048, 128, 128)
    assert bm.kv_lengths[:4].tolist() == [32, 31, 30, 29]
    cap = fm.dkv_chunk_cap(bm.kv_lengths, 1, 4, 2, 128, H100_SMS)
    plan = fm.dkv_plan(bm.kv_lengths, 2, cap)
    for tile in range(4):
        chunks = _walk(plan, tile)
        assert len(chunks) > 1 and chunks[-1][1] == 2 * bm.kv_lengths[tile]
    grid = plan.grid(1, 4)
    assert grid == fm.SparseGrid(cap, plan.chunks, 4 * plan.chunks)
    assert plan.part_numel(1, 4, 128) == plan.slots * 4 * 2 * 64 * 128


def _inputs(seed, b, hq, hkv, n, d=64):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    return u(b, hq, n, d), u(b, hkv, n, d), u(b, hkv, n, d), u(b, hq, n, d)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)))


def _plain_inputs(name, seed, hq, hkv, d=64):
    q, k, v, do = map(_t, _inputs(seed, 1, hq, hkv, N, d))
    bm = _mask(name)
    o, lse = fm.flash_sparse_fwd_plain(q, k, v, bm, sm_scale=d ** -0.5, save_lse=True)
    return q, k, v, do, o, lse, bwd_delta(o, do, None), bm


@pytest.mark.parametrize("cap", [1, 3, "rule"])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_chunked_walk_equals_the_unsplit_plain_version(name, cap):
    """The chunked walk's partials, merged in chunk order, equal the plain
    dK/dV (the dense masked softmax) to fp32 rounding: GQA 2, N = 512."""
    q, k, v, do, _, lse, delta, bm = _plain_inputs(name, 1, 4, 2)
    if cap == "rule":
        cap = fm.dkv_chunk_cap(bm.kv_lengths, 1, 2, 2, 64, H100_SMS)
    plan = fm.dkv_plan(bm.kv_lengths, 2, cap)
    got = fm.flash_sparse_dkv_chunked_plain(q, k, v, do, lse, delta, bm, plan, sm_scale=0.125)
    want = fm.flash_sparse_dkv_plain(q, k, v, do, lse, delta, bm, sm_scale=0.125)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max() / w.abs().max()) < TOL_ORDER


def test_chunked_walk_at_head_dim_128_in_bf16():
    """At head dim 128 with bf16 inputs: the same sums, cast to bf16 as the
    kernel stores them."""
    q, k, v, do, _, lse, delta, bm = _plain_inputs("long-list", 2, 4, 2, d=128)
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    plan = fm.dkv_plan(bm.kv_lengths, 2, 3)
    assert plan.split_tiles > 0
    got = fm.flash_sparse_dkv_chunked_plain(q, k, v, do, lse, delta, bm, plan,
                                            sm_scale=128 ** -0.5)
    want = fm.flash_sparse_dkv_plain(q, k, v, do, lse, delta, bm, sm_scale=128 ** -0.5)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= 2 ** -8


@pytest.mark.parametrize("cap", [2, 5])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_chunked_walk_matches_jax_equal_heads(name, cap):
    """Against JAX's ``flash_attention_block_sparse_bwd`` (its
    ``_dkv_sparse_kernel`` in interpret mode) on JAX's own o and lse."""
    q, k, v, do = _inputs(3, 1, 2, 2, N)
    jbm = jfm.BlockMask(MASKS[name], N, N, 128, 128)
    o, lse = jfm.flash_attention_block_sparse_fwd(*map(jnp.asarray, (q, k, v)), jbm,
                                                  save_lse=True, interpret=True)
    _, dk_j, dv_j = jfm.flash_attention_block_sparse_bwd(
        *map(jnp.asarray, (q, k, v)), o, jnp.asarray(do), lse, jbm, interpret=True)
    bm = _mask(name)
    lse_t = _t(np.asarray(lse)[..., 0])
    delta = bwd_delta(_t(o), _t(do), None)
    plan = fm.dkv_plan(bm.kv_lengths, 1, cap)
    dk, dv = fm.flash_sparse_dkv_chunked_plain(_t(q), _t(k), _t(v), _t(do), lse_t, delta, bm,
                                               plan, sm_scale=0.125)
    assert _err(dk, dk_j) < TOL_GRAD and _err(dv, dv_j) < TOL_GRAD


@pytest.mark.parametrize("cap", [2, 5])
@pytest.mark.parametrize("name", ["banded-stripes", "long-list", "dead-rows"])
def test_chunked_walk_matches_jax_gqa_repeat_and_sum(name, cap):
    """q 4 heads over 2 KV heads: the chunked walk sums each group in fp32;
    JAX's op repeats K/V and sums the group's gradients after."""
    q, k, v, do = _inputs(4, 1, 4, 2, N)
    jbm = jfm.BlockMask(MASKS[name], N, N, 128, 128)

    def loss(q, k, v):
        o = jfm.flash_attention_block_sparse(q, k, v, jbm, None, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    _, dk_j, dv_j = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    bm = _mask(name)
    qt, kt, vt, dot = map(_t, (q, k, v, do))
    o, lse = fm.flash_sparse_fwd_plain(qt, kt, vt, bm, sm_scale=0.125, save_lse=True)
    plan = fm.dkv_plan(bm.kv_lengths, 2, cap)
    dk, dv = fm.flash_sparse_dkv_chunked_plain(qt, kt, vt, dot, lse, bwd_delta(o, dot, None), bm,
                                               plan, sm_scale=0.125)
    assert dk.shape == k.shape
    assert _err(dk, dk_j) < TOL_GRAD and _err(dv, dv_j) < TOL_GRAD


# ---------------------------------------------------------------------------
# The C entries' arguments, through a recorder.
# ---------------------------------------------------------------------------


def _c_params(name: str):
    text = (_build.CSRC / "flash_mask.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", text, re.S).group(1)
    return [" ".join(p.split()) for p in sig.split(",")]


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return ctypes.c_float if param.startswith("float") else ctypes.c_int


@pytest.mark.parametrize("name", ["fam_flash_sparse_fwd", "fam_flash_sparse_dkv",
                                  "fam_flash_sparse_dq"])
def test_bind_declares_each_entrys_c_parameters(name):
    names = ("fam_flash_sparse_fwd", "fam_flash_sparse_dkv", "fam_flash_sparse_dq")
    lib = fm.bind(SimpleNamespace(**{n: SimpleNamespace() for n in names}))
    entry = getattr(lib, name)
    assert entry.argtypes == [_ctype(p) for p in _c_params(name)]
    assert entry.restype is ctypes.c_int
    # The forward and dQ take the Q tiles' issue order right after the bit
    # tiles; dK/dV its plan.
    params = [p.split()[-1].lstrip("*") for p in _c_params(name)]
    after = "plan" if name == "fam_flash_sparse_dkv" else "order"
    assert params[params.index("bits") + 1] == after


@pytest.fixture
def recorder(monkeypatch):
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    names = ("fam_flash_sparse_fwd", "fam_flash_sparse_dkv", "fam_flash_sparse_dq")
    monkeypatch.setattr(fm, "_lib", lambda: SimpleNamespace(**{n: entry(n) for n in names}))
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (7, H100_SMS))
    monkeypatch.setattr(ff, "_TICKETS", {})
    for fn in (fm.flash_sparse_fwd, fm.flash_sparse_dkv, fm.flash_sparse_dq):  # launches nothing
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "grid", fn.grid)
    return calls


def _args(name, args):
    return dict(zip((p.split()[-1].lstrip("*") for p in _c_params(name)), args))


def _rows(b, hq, hkv, n, d, dtype):
    q = torch.zeros((b, hq, n, d), dtype=dtype)
    k = torch.zeros((b, hkv, n, d), dtype=dtype)
    lse = torch.zeros((b, hq, n))
    return q, k, lse


@pytest.mark.parametrize("cap", [None, 3])
def test_dkv_launch_passes_the_plan_workspace_and_tickets(recorder, monkeypatch, cap):
    """bf16: the plan's entries, its chunk count as the grid's second
    dimension, a workspace of ``part_numel`` fp32 elements and the stream's
    zeroed tickets when a tile is split (none otherwise); the wrapper keeps
    the launch's grid."""
    if cap is not None:
        monkeypatch.setattr(fm, "dkv_chunk_cap", lambda *shape: cap)
    bm = _mask("long-list")
    q, k, lse = _rows(2, 4, 2, N, 64, torch.bfloat16)
    dk, dv = fm._launch_dkv(q, k, k, q, lse, lse, bm, 0.125)
    assert dk.shape == k.shape and dv.dtype == torch.bfloat16
    (name, args), = recorder
    a = _args(name, args)
    assert len(args) == len(_c_params(name)) and a["stream"] == 7 and a["dtype"] == 0
    want = cap or fm.dkv_chunk_cap(bm.kv_lengths, 2, 2, 2, 64, H100_SMS)
    plan, entries = bm.dkv_plan("cpu", 2, want)
    assert a["plan"] == entries.data_ptr() and a["n_chunks"] == plan.chunks
    assert fm.flash_sparse_dkv.grid == plan.grid(2, 2)
    if plan.slots:
        held = ff._TICKETS[("cpu", 7)]
        assert a["tickets"] == held.data_ptr() and held.numel() >= plan.split_tiles * 2 * 2
        assert torch.all(held == 0) and a["part"] is not None
    else:
        assert a["part"] is None and a["tickets"] is None
    assert plan.slots > 0  # the first tile's 8-entry list splits at either cap


def test_fp32_dkv_launch_takes_the_template_grid(recorder):
    bm = _mask("rung11")
    q, k, lse = _rows(2, 4, 2, N, 128, torch.float32)
    fm._launch_dkv(q, k, k, q, lse, lse, bm, 0.125)
    (name, args), = recorder
    a = _args(name, args)
    assert a["dtype"] == 1 and a["plan"] is None and a["part"] is None and a["tickets"] is None
    tiles = len(bm.kv_lengths)
    assert fm.flash_sparse_dkv.grid == fm.SparseGrid(2 * int(bm.kv_lengths.max()), tiles,
                                                     tiles * 2 * 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_launch_passes_the_issue_order(recorder, dtype):
    bm = _mask("rung11")
    q, k, lse = _rows(2, 4, 2, N, 64, dtype)
    dq = fm._launch_dq(q, k, k, q, lse, lse, bm, 0.125)
    assert dq.shape == q.shape
    (name, args), = recorder
    a = _args(name, args)
    assert len(args) == len(_c_params(name)) and a["stream"] == 7
    if dtype == torch.bfloat16:
        assert a["order"] == bm.dq_order("cpu").data_ptr()
        assert bm.dq_order("cpu").tolist() == fm.dq_order(bm.q_lengths).tolist()
    else:
        assert a["order"] is None
    tiles = len(bm.q_lengths)
    assert fm.flash_sparse_dq.grid == fm.SparseGrid(int(bm.q_lengths.max()), tiles, tiles * 2 * 4)


@pytest.mark.parametrize("save_lse", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_launch_passes_the_issue_order(recorder, dtype, save_lse):
    """bf16: the mask's issue order, the tensor the dQ launch passes
    (longest Q list first); fp32 (the template) null.  The lse pointer is
    null when it is not saved; the wrapper counts the launch and keeps its
    grid, one block per (Q tile, q-head, batch)."""
    bm = _mask("rung11")
    q, k, _ = _rows(2, 4, 2, N, 64, dtype)
    before = fm.flash_sparse_fwd.launches
    o, lse = fm._launch_fwd(q, k, k, bm, 0.125, save_lse)
    assert o.shape == q.shape and o.dtype == dtype
    (name, args), = recorder
    a = _args(name, args)
    assert len(args) == len(_c_params(name)) and a["stream"] == 7
    assert a["dtype"] == (0 if dtype == torch.bfloat16 else 1) and a["o"] == o.data_ptr()
    assert a["lse"] == (lse.data_ptr() if save_lse else None) and (lse is None) != save_lse
    t = bm.tables("cpu")
    assert (a["q_ptr"], a["q_list"], a["bits"]) == (t.q_ptr.data_ptr(), t.q_list.data_ptr(),
                                                    t.bit_tiles.data_ptr())
    if dtype == torch.bfloat16:
        assert a["order"] == bm.dq_order("cpu").data_ptr()
    else:
        assert a["order"] is None
    tiles = len(bm.q_lengths)
    assert fm.flash_sparse_fwd.launches == before + 1
    assert fm.flash_sparse_fwd.grid == fm.SparseGrid(int(bm.q_lengths.max()), tiles, tiles * 2 * 4)


# Masks whose Q lists at the kernels' 64-row tile include empty ones.
EMPTY_LISTS = {
    # Q tiles 1, 4 and 7 see nothing, between tiles that do
    "empty-middle": lambda r, c: (c <= r) & ((r // 64) % 3 != 1),
    # the last Q tile sees nothing
    "empty-last": lambda r, c: (c <= r) & (r < N - 64),
}


@pytest.mark.parametrize("name", sorted(EMPTY_LISTS))
def test_plain_forward_on_empty_q_lists_matches_jax(name):
    """An empty Q list walks no step: its rows give o = 0 and lse = -inf,
    as JAX's ``flash_attention_block_sparse_fwd`` (interpret mode) gives,
    and the other rows match it within ``test_torch_flash_mask.py``'s fp32
    2e-5 (GQA 2).  The issue order puts the empty lists last."""
    bm = fm.BlockMask(EMPTY_LISTS[name], N, N, 64, 64)
    empty = np.flatnonzero(bm.q_lengths == 0)
    assert len(empty) > 0 and len(empty) < len(bm.q_lengths)
    assert sorted(fm.dq_order(bm.q_lengths)[-len(empty):].tolist()) == empty.tolist()
    q, k, v, _ = _inputs(5, 1, 4, 2, N)
    jbm = jfm.BlockMask(EMPTY_LISTS[name], N, N, 64, 64)
    o_j, lse_j = jfm.flash_attention_block_sparse_fwd(*map(jnp.asarray, (q, k, v)), jbm,
                                                      save_lse=True, interpret=True)
    o_j, lse_j = np.asarray(o_j, np.float32), np.asarray(lse_j)[..., 0]
    o, lse = fm.flash_attention_block_sparse_fwd(_t(q), _t(k), _t(v), bm, save_lse=True)
    rows = np.concatenate([np.arange(i * fm.TILE, (i + 1) * fm.TILE) for i in empty])
    assert torch.all(o[:, :, rows] == 0) and torch.all(torch.isneginf(lse[:, :, rows]))
    assert np.all(o_j[:, :, rows] == 0) and not np.any(np.isfinite(lse_j[:, :, rows]))
    finite = np.isfinite(lse_j)
    assert np.array_equal(finite, torch.isfinite(lse).numpy())
    assert float(np.max(np.abs(o.numpy() - o_j))) < 2e-5
    assert float(np.max(np.abs(lse.numpy()[finite] - lse_j[finite]))) < 2e-5
