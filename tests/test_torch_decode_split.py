"""PyTorch port: the split-KV decode grid of ``csrc/flash_decode.cuh`` on the CPU.

Decode calls (at most ``DECODE_ROWS`` query rows) cut their KV row into
chunks of ``decode_kv_chunk`` columns, one block each, and merge the
chunks' partials (fp32 o, m, l) in split order.  The CUDA kernel cannot run
here; its arithmetic can: ``split_partials_plain`` computes each chunk's
partial and ``merge_splits_plain`` merges them, and the merged result is
held against the JAX package's quant and paged kernels in interpret mode on
the same numpy inputs, at several chunkings.  The split rule is pinned as a
pure function of static shapes, and the wrappers' C arguments are checked
against the C entries through a recorder (no card here).
"""

import ctypes
import functools
import inspect
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_metal_tpu.kernels import paged as jax_paged
from flash_attention_metal_tpu.kernels import quant as jax_quant
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_fwd as ff
from flash_attention_metal_tpu_torch.kernels import paged, quant

# Merged partials (fp32) against the JAX kernels in interpret mode: the
# tolerances of tests/test_torch_quant.py and test_torch_paged.py (fp32 q:
# summation order only; bf16 q: JAX rounds P * s_v and the products' operands
# to bf16, the plain partials stay in fp32).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
FORMATS = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
PS = 128  # page size of the paged cases
# The serving card's SM count (an H100 SXM), and an H100 PCIe's.
H100_SMS = 132
H100_PCIE_SMS = 114


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (the test workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (q shape, kv shape, offsets, pos_div): folded decode of group 2 with a
# slot of length 0, one at the end of the cache and one in the middle; a
# token of 4 q-heads unfolded; folded decode at head dim 128.
DECODE_CASES = {
    "fold2": ((3, 2, 2, 64), (3, 2, 256, 64), [0, 255, 100], 2),
    "one_row_gqa2": ((2, 4, 1, 64), (2, 2, 384, 64), [37, 383], 1),
    "fold2_d128": ((2, 2, 2, 128), (2, 2, 256, 128), [0, 190], 2),
}
# Chunks of each case's row: one tile, two, three (not dividing the row),
# and the whole row (no split).  Chunks past a slot's diagonal are empty.
CHUNKS = (64, 128, 192, 10 ** 4)


def _uniform(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _quant_inputs(case, dtype, fmt):
    """The case's numpy inputs, the port's 8-bit cache, and the JAX
    kernel's ``(o, lse)`` in interpret mode (fp32 numpy)."""
    shape_q, shape_kv, offsets, pos_div = DECODE_CASES[case]
    rng = np.random.default_rng(5)
    q, k, v = _uniform(rng, shape_q), _uniform(rng, shape_kv), _uniform(rng, shape_kv)
    tq = torch.from_numpy(q).to(dtype)
    qkv = quant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), FORMATS[fmt][0])
    jq = jnp.asarray(tq.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    o, lse = jax_quant.flash_attention_quant(
        jq, jax_quant.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=FORMATS[fmt][1]),
        jnp.asarray(offsets, jnp.int32), causal=True, save_lse=True, pos_div=pos_div,
        interpret=True)
    return tq, qkv, np.asarray(o.astype(jnp.float32)), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_merged_quant_partials_match_jax(case, dtype, fmt, chunk):
    tq, qkv, want_o, want_lse = _quant_inputs(case, dtype, fmt)
    offsets, pos_div = DECODE_CASES[case][2:]
    d = tq.shape[-1]
    parts = ff.split_partials_plain(
        tq, qkv.k_q, qkv.v_q, torch.tensor(offsets, dtype=torch.int32), chunk,
        sm_scale=d ** -0.5, causal=True, pos_div=pos_div, k_scale=qkv.k_scale,
        v_scale=qkv.v_scale)
    assert parts[0].shape[0] == ff.kv_splits(qkv.seq_len, chunk)
    o, lse = ff.merge_splits_plain(*parts)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATTN_TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATTN_TOL[dtype], rtol=0)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_merged_partials_equal_the_unsplit_plain_version(case, chunk):
    """Splitting changes the summation order only: the merge of any
    chunking is the dense plain attention to fp32 rounding."""
    shape_q, shape_kv, offsets, pos_div = DECODE_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_uniform(rng, s)) for s in (shape_q, shape_kv, shape_kv))
    q = q * 8.0  # peaked: the running max differs from chunk to chunk
    off = torch.tensor(offsets, dtype=torch.int32)
    kw = dict(sm_scale=shape_q[-1] ** -0.5, causal=True, pos_div=pos_div)
    o, lse = ff.merge_splits_plain(*ff.split_partials_plain(q, k, v, off, chunk, **kw))
    want_o, want_lse = ff.flash_attention_fwd_plain(q, k, v, off, save_lse=True, **kw)
    torch.testing.assert_close(o, want_o, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=0)


def _paged_case(head_dim, seed):
    """Two slots of a 512-column row (lengths 0 and 300, folded group 2)
    over a shuffled table; the entries past each slot's diagonal are 0 and
    page 0 holds a large constant no visible column reads."""
    rng = np.random.default_rng(seed)
    batch, kv_heads, n_kv, group = 2, 2, 512, 2
    k, v = (_uniform(rng, (batch, kv_heads, n_kv, head_dim)) for _ in "kv")
    per = n_kv // PS
    table = (1 + rng.permutation(batch * per)).reshape(batch, per).astype(np.int32)
    n_pages = 1 + batch * per
    lengths = np.asarray([0, 300], np.int32)
    live = (group - 1) // group + lengths
    table = np.where(np.arange(per)[None, :] < (live // PS + 1)[:, None], table, 0).astype(np.int32)

    def pool(x):
        out = np.full((n_pages, kv_heads, PS, head_dim), 7.0, np.float32)
        pages = x.reshape(batch, kv_heads, per, PS, head_dim).swapaxes(1, 2)
        nz = table.reshape(-1) > 0
        out[table.reshape(-1)[nz]] = pages.reshape(-1, kv_heads, PS, head_dim)[nz]
        return out

    q = _uniform(rng, (batch, kv_heads, group, head_dim))  # a KV head's group as rows
    return q, pool(k), pool(v), table, lengths, group


@pytest.mark.parametrize("chunk", (64, 128, 256, 512))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_merged_paged_partials_match_jax(head_dim, chunk):
    q, pool_k, pool_v, table, lengths, pos_div = _paged_case(head_dim, seed=head_dim)
    want = jax_paged.flash_attention_paged(
        *(jnp.asarray(x) for x in (q, pool_k, pool_v, table, lengths)), pos_div=pos_div,
        interpret=True)
    t = [torch.from_numpy(x) for x in (q, pool_k, pool_v, table, lengths)]
    n_live = (q.shape[2] - 1) // pos_div + t[4].long()
    k, v = (paged.gather_pages(x, t[3], n_live // PS + 1) for x in t[1:3])
    o, _ = ff.merge_splits_plain(*ff.split_partials_plain(
        t[0], k, v, t[4], chunk, sm_scale=head_dim ** -0.5, causal=True, pos_div=pos_div))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATTN_TOL[torch.float32], rtol=0)


def test_empty_partials_merge_to_zero_and_minus_inf():
    """A row that no split saw gives o = 0 and lse = -inf; empty splits
    beside a seen one weigh nothing."""
    splits, b, h, n_q, d = 3, 1, 2, 2, 64
    o_s = torch.zeros(splits, b, h, n_q, d)
    m_s = torch.full((splits, b, h, n_q), float("-inf"))
    l_s = torch.zeros(splits, b, h, n_q)
    o, lse = ff.merge_splits_plain(o_s, m_s, l_s, torch.bfloat16)
    assert o.dtype == torch.bfloat16 and torch.all(o == 0)
    assert torch.all(torch.isneginf(lse))
    # Split 1 saw row 0 of head 1: the result is its partial, normalised.
    o_s[1, 0, 1, 0] = torch.arange(d, dtype=torch.float32)
    m_s[1, 0, 1, 0], l_s[1, 0, 1, 0] = 3.0, 4.0
    o, lse = ff.merge_splits_plain(o_s, m_s, l_s)
    torch.testing.assert_close(o[0, 1, 0], torch.arange(d, dtype=torch.float32) / 4.0)
    assert float(lse[0, 1, 0]) == pytest.approx(3.0 + np.log(4.0))
    assert torch.all(o[0, 0] == 0) and torch.all(torch.isneginf(lse[0, 0]))


# ---------------------------------------------------------------------------
# The split rule and the wrappers' arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,heads,n_q,n_kv", [
    (8, 8, 2, 2048), (8, 8, 2, 1920), (1, 1, 1, 64), (1, 1, 1, 100), (32, 8, 2, 2048),
    (3, 2, 4, 256), (2, 16, 16, 4096), (64, 8, 2, 2048), (1, 8, 8, 32768),
])
@pytest.mark.parametrize("sms", [H100_SMS, H100_PCIE_SMS])
def test_chunk_is_whole_tiles_covering_the_row(batch, heads, n_q, n_kv, sms):
    chunk = ff.decode_kv_chunk(batch, heads, n_q, n_kv, sms)
    assert chunk >= ff.KV_TILE and chunk % ff.KV_TILE == 0
    splits = ff.kv_splits(n_kv, chunk)
    assert (splits - 1) * chunk < n_kv <= splits * chunk  # no split is wholly past the row


def test_rule_reads_static_shapes_only():
    """The rule's inputs are shapes, the SM count and whether the call is
    folded (a static property of its shape and type): the slots' lengths,
    a device tensor, never enter it (reading them would sync the host)."""
    assert list(inspect.signature(ff.decode_kv_chunk).parameters) == [
        "batch", "heads", "n_q", "n_kv", "sm_count", "folded"]


def test_serving_decode_fills_the_card(monkeypatch):
    """The serving decode (8 slots, 8 KV heads folded over group 2, a
    2048-column cache): 512 blocks of 256 columns, where the unsplit grid
    had 64 blocks (the fastest chunk measured at head dim 64 and 128).  The
    4-tile floor alone sets that chunk: the blocks-per-SM term asks for a
    finer cut, however many blocks an SM it asks for."""
    chunk = ff.decode_kv_chunk(8, 8, 2, 2048, H100_SMS)
    assert chunk == ff.MIN_CHUNK_TILES * ff.KV_TILE == 256
    assert 8 * 8 * ff.kv_splits(2048, chunk) == 512
    monkeypatch.setattr(ff, "SPLIT_BLOCKS_PER_SM", 10 ** 6)
    assert ff.decode_kv_chunk(8, 8, 2, 2048, H100_SMS) == chunk


@pytest.mark.parametrize("slots,chunk", [(1, 256), (16, 256), (32, 256), (64, 448), (256, 1024), (512, 2048)])
def test_chunk_at_other_batches(slots, chunk):
    """At least 4 tiles a chunk; more slots than 16 blocks per SM fill
    alone take longer chunks, and past SPLIT_BLOCKS_PER_SM * SMs units none
    (8 KV heads a slot)."""
    assert ff.decode_kv_chunk(slots, 8, 2, 2048, H100_SMS) == chunk


@pytest.mark.parametrize("n_q", [17, 64, 512])
def test_no_split_above_the_decode_tile(n_q):
    """Prefill chunks (the 512-row chunk of the KV checks among them) keep
    one block per 64-row q tile: one chunk over the whole row."""
    assert ff.decode_kv_chunk(1, 16, n_q, 2048, H100_SMS) == 2048
    assert ff.decode_kv_chunk(1, 16, n_q, 2000, H100_SMS) == 2048
    assert ff.kv_splits(2000, 2048) == 1


def test_many_slots_split_less():
    """More (q-head, batch) units need fewer splits to fill the card."""
    chunks = [ff.decode_kv_chunk(b, 8, 2, 2048, H100_SMS) for b in (1, 8, 32, 64, 512)]
    assert chunks == sorted(chunks)
    assert chunks[-1] == 2048  # 4096 blocks unsplit
    assert ff.decode_kv_chunk(1, 1, 1, 100, H100_SMS) == 128  # the whole 2-tile row


def _recorder(monkeypatch, module, names):
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(module, "_lib", lambda: SimpleNamespace(**{n: entry(n) for n in names}))
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (0, H100_SMS))
    monkeypatch.setattr(ff, "_TICKETS", {})
    return calls


def _c_params(name: str) -> int:
    text = (_build.CSRC / "flash_fwd.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", text, re.S).group(1)
    return len(sig.split(","))


def test_bind_declares_each_entrys_c_parameters():
    names = ("fam_flash_quant", "fam_flash_paged", "fam_flash_paged_quant")
    lib = quant.bind(SimpleNamespace(**{n: SimpleNamespace() for n in names}))
    lib = ff.bind(SimpleNamespace(fam_flash_fwd=SimpleNamespace(), **vars(lib)))
    for name in ("fam_flash_fwd",) + names:
        entry = getattr(lib, name)
        assert len(entry.argtypes) == _c_params(name)
        assert entry.restype is ctypes.c_int
        # kv_chunk (int), part and tickets (pointers), then the stream.
        assert entry.argtypes[-4:] == [ctypes.c_int] + [ctypes.c_void_p] * 3


def _quant_launch(q, n_kv, lengths):
    qkv = quant.quantize_kv(torch.zeros(q.shape[0], 2, n_kv, q.shape[3]),
                            torch.zeros(q.shape[0], 2, n_kv, q.shape[3]))
    return quant._launch_quant(q, qkv, lengths, sm_scale=0.125, causal=True, pos_div=2,
                               save_lse=True)


def _keep_counts(monkeypatch, *wrappers):
    """The recorder launches nothing: restore each wrapper's count and grid."""
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "grid", fn.grid)


def test_quant_launch_passes_the_split(monkeypatch):
    calls = _recorder(monkeypatch, quant, ["fam_flash_quant"])
    _keep_counts(monkeypatch, quant.flash_attention_quant)
    q = torch.zeros((8, 2, 2, 64))
    for lengths in ([0] * 8, [2047] + [64] * 7, list(range(8))):
        _quant_launch(q, 2048, torch.tensor(lengths, dtype=torch.int32))
    chunk = ff.decode_kv_chunk(8, 2, 2, 2048, H100_SMS)
    for name, args in calls:  # the same split whatever the lengths
        assert name == "fam_flash_quant" and len(args) == _c_params(name)
        assert args[-4] == chunk and args[-1] == 0
        assert args[-3] is not None and args[-2] is not None
    splits = ff.kv_splits(2048, chunk)
    assert splits > 1
    # The wrapper keeps the grid it launched: the split chunk, 16 blocks a slot.
    assert quant.flash_attention_quant.grid == ff.SplitGrid(chunk, splits, 8 * 2 * splits)


def test_paged_launches_pass_the_split(monkeypatch):
    calls = _recorder(monkeypatch, paged, ["fam_flash_paged", "fam_flash_paged_quant"])
    _keep_counts(monkeypatch, paged.flash_attention_paged, paged.flash_attention_paged_quant)
    q = torch.zeros((2, 4, 1, 64))
    pool = torch.zeros((9, 4, 128, 64))
    qpool = quant.quantize_kv(pool, pool)
    table = torch.zeros((2, 4), dtype=torch.int32)
    lengths = torch.tensor([0, 400], dtype=torch.int32)
    paged._launch_paged(q, pool, pool, table, lengths, sm_scale=0.125, pos_div=1)
    rule = ff.decode_kv_chunk(2, 4, 1, 512, H100_SMS)
    monkeypatch.setattr(ff, "decode_kv_chunk", lambda *shape: 128)  # a finer split
    paged._launch_paged_quant(q, qpool.k_q, qpool.v_q, qpool.k_scale, qpool.v_scale, table,
                              lengths, sm_scale=0.125, pos_div=1)
    (n1, a1), (n2, a2) = calls
    assert len(a1) == _c_params(n1) and len(a2) == _c_params(n2)
    assert a1[-4] == rule
    assert a2[-4] == 128 and a2[-3] is not None and a2[-2] is not None
    assert paged.flash_attention_paged.grid.kv_chunk == rule
    assert paged.flash_attention_paged_quant.grid == ff.SplitGrid(128, 4, 4 * 2 * 4)


def test_split_workspace_and_tickets(monkeypatch):
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (7, H100_SMS))
    monkeypatch.setattr(ff, "_TICKETS", {})
    q = torch.zeros((8, 8, 2, 64))
    grid, part, tickets, stream = ff.split_args(q, 2048)
    splits = grid.kv_splits
    assert stream == 7 and splits == ff.kv_splits(2048, grid.kv_chunk) > 1
    assert part.dtype == torch.float32 and part.numel() == 8 * 8 * splits * 2 * (64 + 2)
    assert tickets.dtype == torch.int32 and tickets.numel() >= 64 and torch.all(tickets == 0)
    # The stream's tickets are kept: the merging block leaves them zero.
    assert ff.split_args(q, 2048)[2] is tickets
    # One split: no workspace, no tickets.
    assert ff.split_args(torch.zeros((1, 16, 512, 64)), 2048)[1:3] == (None, None)
    monkeypatch.setattr(ff, "decode_kv_chunk", lambda *shape: 2048)
    assert ff.split_args(q, 2048)[1:3] == (None, None)


@pytest.mark.parametrize("n_q,n_kv,grid", [
    (2, 2048, (256, 8, 2 * 3 * 8)),  # decode: a block per split
    (16, 1000, (256, 4, 2 * 3 * 4)),  # the 16-row tile, a ragged last split
    (17, 2048, (2048, 1, 2 * 3 * 1)),  # above the decode tile: a block per 64-row q tile
    (512, 2000, (2048, 1, 2 * 3 * 8)),
])
def test_split_args_grid_is_the_launched_grid(monkeypatch, n_q, n_kv, grid):
    """The grid the C entry launches (csrc/flash_fwd.cu::launch): (split,
    q-head, batch) for at most DECODE_ROWS rows, else (q tile, q-head,
    batch) over the whole row."""
    monkeypatch.setattr(ff, "_cuda_args", lambda q: (0, H100_SMS))
    monkeypatch.setattr(ff, "_TICKETS", {})
    assert ff.split_args(torch.zeros((2, 3, n_q, 64)), n_kv)[0] == ff.SplitGrid(*grid)
