"""Shared pieces of the emulated-kernel tests (tests/test_torch_*_emulated.py):
the CPU builds of the port's CUDA sources (larvanet_tpu_torch/ops/emulate.py)
and the tolerances that hold them to their plain versions."""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import emulate

# f32: the kernel sums the same f32 products as the plain version in another
# order (chip_smoke.py's F32_ATOL; the JAX tests' 5x for F(4,3))
F32_ATOL = {"conv": 2e-4, 2: 2e-4, 4: 1e-3}
# bf16 conv: the same bf16 operands, f32 sums, one rounding of the output
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
# bf16 wino, normwise: operands rounded to bf16 from f32 transforms summed in
# another order may land on neighbouring bf16 values (chip_smoke.py)
WINO_BF16_RTOL = 2.0 ** -6
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def lib(source, sms=1):
    """The CPU build of csrc/`source` for a stand-in card of `sms` SMs; the
    test skips where there is no host C++ compiler."""
    try:
        emulate.compiler()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return emulate.load(source, sms)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))
