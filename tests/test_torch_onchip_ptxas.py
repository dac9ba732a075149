"""PyTorch port: ``harness.onchip ptxas``, the report of each kernel's
registers, spills and stack that ``nvcc -Xptxas -v`` prints.  nvcc runs
only where the CUDA toolkit is; its output's parsing is checked here on a
sample of it."""

import shutil

import pytest

from flash_attention_metal_tpu_torch.harness import onchip

SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4sm9021flash_fwd_sm90_kernelILi128EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN4sm9021flash_fwd_sm90_kernelILi128EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 150 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4sm9021flash_fwd_sm90_kernelILi64EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN4sm9021flash_fwd_sm90_kernelILi64EEEvv
    56 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 56 bytes cumulative stack size
"""


def test_parse_ptxas_reads_each_kernels_registers_spills_and_stack(monkeypatch):
    monkeypatch.setattr(onchip, "_kernel_name", lambda mangled: mangled)
    got = onchip.parse_ptxas("flash_fwd.cu", SAMPLE)
    assert got == [
        {"unit": "flash_fwd.cu", "kernel": "_ZN4sm9021flash_fwd_sm90_kernelILi128EEEvv",
         "registers": 150, "spill_stores": 0, "spill_loads": 0, "stack": 0},
        {"unit": "flash_fwd.cu", "kernel": "_ZN4sm9021flash_fwd_sm90_kernelILi64EEEvv",
         "registers": 255, "spill_stores": 12, "spill_loads": 8, "stack": 56},
    ]


def test_kernel_name_is_demangled_where_cxxfilt_is():
    name = onchip._kernel_name("_ZN4sm9021flash_fwd_sm90_kernelILi64EEEvv")
    if shutil.which("c++filt") is None:
        pytest.skip("no c++filt here: the mangled name is kept")
    assert name == "sm90::flash_fwd_sm90_kernel<64>"
