"""The PyTorch port imports no JAX, optax or transformers, and nothing of the
JAX package.

Every ``.py`` file of ``flash_attention_metal_tpu_torch/`` and
``chip_smoke.py`` is parsed with ``ast`` (nothing is imported): any
``import jax...``, ``optax`` or ``transformers`` (the card has none; the
Llama converter reads any object with a ``.config`` and a
``.state_dict()``), any import of ``flash_attention_metal_tpu`` (the JAX
package, not ``_torch``), at module level or inside a function, a relative
import that climbs out of the port, and ``importlib.import_module`` /
``__import__`` of such a name, fail.  Only the tests import both packages.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = "flash_attention_metal_tpu_torch"
FILES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / PORT).rglob("*.py")) + [
    "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "transformers", "flash_attention_metal_tpu")


def banned_imports(source: str, path: str) -> list:
    """``(line, name)`` of every import of JAX or the JAX package in
    ``source``, the file at ``path`` (relative to the repo's root)."""
    package = Path(path).with_suffix("").parts[:-1]
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names = [node.module or ""]
            elif node.level > len(package):
                names = ["<relative import out of the port>"]
            else:
                base = ".".join(package[: len(package) - node.level + 1])
                names = [f"{base}.{node.module}" if node.module else base]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        found += [(node.lineno, n) for n in names if n.startswith("<") or _forbidden(n)]
    return found


def test_the_scan_covers_the_port():
    assert "chip_smoke.py" in FILES
    assert f"{PORT}/kernels/flash_v1.py" in FILES
    assert f"{PORT}/harness/autotune.py" in FILES
    assert f"{PORT}/kernels/flash_mask.py" in FILES
    for module in ("models/moe.py", "models/encoder.py", "models/seq2seq.py", "models/lora.py",
                   "models/muon.py", "models/convert.py", "utils/profiling.py", "utils/debug.py"):
        assert f"{PORT}/{module}" in FILES
    assert len(FILES) > 40


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    assert banned_imports((ROOT / path).read_text(), path) == []


@pytest.mark.parametrize(
    "source,banned",
    [
        ("import jax\n", ["jax"]),
        ("import jax.numpy as jnp\n", ["jax.numpy"]),
        ("def f():\n    from jax import lax\n", ["jax"]),
        ("from flash_attention_metal_tpu.harness import plotting\n",
         ["flash_attention_metal_tpu.harness"]),
        ("def f():\n    import flash_attention_metal_tpu.kernels\n",
         ["flash_attention_metal_tpu.kernels"]),
        ("import importlib\nm = importlib.import_module('jax')\n", ["jax"]),
        ("from ...flash_attention_metal_tpu import config\n",
         ["<relative import out of the port>"]),
        ("import flash_attention_metal_tpu_torch\nfrom ..kernels import flash_v1\n", []),
        ("import torch, numpy\n", []),
        ("import optax\n", ["optax"]),
        ("def f():\n    from transformers import LlamaForCausalLM\n", ["transformers"]),
    ],
    ids=["import", "submodule", "in_function", "jax_package", "jax_package_in_function",
         "import_module", "relative_out", "port_itself", "others", "optax", "transformers"],
)
def test_scan_flags_what_the_rule_forbids(source, banned):
    got = banned_imports(source, f"{PORT}/harness/example.py")
    assert [name for _, name in got] == banned
