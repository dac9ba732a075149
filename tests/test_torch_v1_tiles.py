"""PyTorch port: the Q-tile rule of the V1 kernels and their C entries.

``kernels/flash_v1.py::v1_tile_rows`` picks the query rows per block of the
streaming and folded CUDA kernels (``csrc/flash_v1.cu``); the wrappers pass
it to the C entries.  These tests pin the rule at every point of the
benchmark's sweep (the heights ``onchip v1_tiles`` measured fastest on the H100),
the shared-memory model it rests on, and the arguments each wrapper hands
its C entry, with the kernels' library replaced by a recorder (no card
here).
"""

import ctypes
import re
from types import SimpleNamespace

import pytest
import torch

from flash_attention_metal_tpu_torch.harness.benchmark import DEFAULT_SWEEP, amortizing_batch
from flash_attention_metal_tpu_torch.kernels import _build
from flash_attention_metal_tpu_torch.kernels import flash_v1 as fv

# N: (route, rows, blocks) at the sweep's batch, H = 1, D = 64.
SWEEP_TILES = {
    128: ("folded", 64, 1024),
    256: ("folded", 32, 1024),
    512: ("folded", 32, 512),
    1024: ("stream", 32, 256),
    2048: ("stream", 32, 128),
    4096: ("stream", 32, 128),
    8192: ("stream", 32, 256),
    16384: ("stream", 64, 256),
}
# Two blocks of this many bytes fit an H100 SM (228 KB, 1 KB reserved each).
TWO_BLOCKS = 115712


def test_the_table_covers_the_sweep():
    assert tuple(SWEEP_TILES) == DEFAULT_SWEEP


@pytest.mark.parametrize("n", DEFAULT_SWEEP)
def test_tile_rows_at_every_sweep_point(n):
    b = amortizing_batch(n)
    route, _ = fv.v1_route(b, n, n)
    rows = fv.v1_tile_rows(route, b, 1, n, n, 64)
    assert (route, rows, b * -(-n // rows)) == SWEEP_TILES[n]


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("n_kv", [1, 64, 128, 130, 200, 256, 330, 384, 448, 512])
def test_folded_takes_the_tallest_tile_two_blocks_fit(n_kv, head_dim):
    rows = fv.v1_tile_rows("folded", 2, 1, n_kv, n_kv, head_dim)
    assert fv.v1_smem_bytes("folded", rows, n_kv, head_dim) <= TWO_BLOCKS
    if rows < 64:
        assert fv.v1_smem_bytes("folded", 2 * rows, n_kv, head_dim) > TWO_BLOCKS


def test_smem_bytes_match_the_source_header():
    """The per-block bytes ``csrc/flash_v1.cu``'s header lists."""
    header = (_build.CSRC / "flash_v1.cu").read_text()
    cases = [("stream", 64, 1024, 64, 64512), ("stream", 64, 1024, 128, 113664),
             ("stream", 32, 1024, 64, 49664), ("stream", 32, 1024, 128, 90624),
             ("folded", 64, 128, 64, 89088), ("folded", 32, 256, 64, 78336),
             ("folded", 32, 512, 64, 111104), ("folded", 32, 128, 128, 102912),
             ("folded", 16, 256, 128, 93440), ("folded", 16, 512, 128, 109824)]
    for route, rows, n_kv, d, want in cases:
        assert fv.v1_smem_bytes(route, rows, n_kv, d) == want
        assert f"{want:,}" in header


def test_streaming_grids_up_to_one_block_an_sm_take_32_rows():
    assert fv.v1_tile_rows("stream", 1, 1, 132 * 64, 132 * 64, 64) == 32
    assert fv.v1_tile_rows("stream", 1, 1, 133 * 64, 133 * 64, 64) == 64
    assert fv.v1_tile_rows("stream", 3, 2, 1000, 1000, 128) == 32
    assert fv.v1_tile_rows("stream", 16, 8, 1024, 1024, 64) == 64


def _c_params(name: str) -> int:
    """The number of parameters of the C entry ``name`` in csrc/flash_v1.cu."""
    text = (_build.CSRC / "flash_v1.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", text, re.S).group(1)
    return len(sig.split(","))


def test_bind_declares_each_entrys_c_parameters():
    lib = fv.bind(SimpleNamespace(fam_flash_v1=SimpleNamespace(),
                                  fam_flash_v1_folded=SimpleNamespace()))
    for name in ("fam_flash_v1", "fam_flash_v1_folded"):
        entry = getattr(lib, name)
        assert len(entry.argtypes) == _c_params(name)
        assert entry.restype is ctypes.c_int


@pytest.mark.parametrize("shape,route", [((8, 1, 128, 64), "folded"), ((2, 1, 1024, 64), "stream"),
                                         ((2, 1, 330, 128), "folded")])
def test_wrappers_pass_the_tile_rule_to_the_c_entry(monkeypatch, shape, route):
    """The wrapper's arguments line up with ``bind``'s declaration, ``rows``
    is ``v1_tile_rows``'s, and the folded entry no longer takes the fold."""
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = SimpleNamespace(fam_flash_v1=entry("fam_flash_v1"),
                          fam_flash_v1_folded=entry("fam_flash_v1_folded"))
    monkeypatch.setattr(fv, "_lib", lambda: lib)
    monkeypatch.setattr(fv, "_stream_args", lambda q: (1, 0))
    q = torch.zeros(shape)
    b, h, n, d = shape
    kernel = fv.flash_v1_folded if route == "folded" else fv.flash_v1_stream
    before = kernel.launches
    if route == "folded":
        fold = fv.v1_route(b, n, n)[1]
        o = fv.flash_v1_folded(q, q, q, fold, sm_scale=0.125, causal=True)
        name = "fam_flash_v1_folded"
    else:
        o = fv.flash_v1_stream(q, q, q, sm_scale=0.125, causal=True)
        name = "fam_flash_v1"
    assert kernel.launches == before + 1
    kernel.launches = before  # the recorder launched nothing
    (called, args), = calls
    assert called == name and len(args) == _c_params(name)
    assert args[4:10] == (b, h, n, n, d, fv.v1_tile_rows(route, b, h, n, n, d))
    assert args[11:] == (1, 1, 0)  # causal, dtype, stream
    assert o.shape == q.shape


def test_folded_wrapper_checks_the_fold_divides_the_batch():
    q = torch.zeros((6, 1, 128, 64))
    with pytest.raises(ValueError, match="dividing the batch"):
        fv.flash_v1_folded(q, q, q, 4, sm_scale=0.125, causal=False)
