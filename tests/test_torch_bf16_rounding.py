"""The premise of K5's bf16 math mode (csrc/pair_terms.cuh Bf16Math), on the CPU.

The mode's every operation is a bf16 operation of the JAX package: the exact
result rounded once to bf16, nearest even. The kernel computes +, - and x with
Hopper's bf16 instructions, division and sqrt as f32 operations followed by
one rounding; the plain twin (ops/pallas_pair.py) computes each operation in
f32 and rounds it with `_rd`. Both give the same bits because, for +, -, x, /
and sqrt of bf16 operands, rounding the exact result to f32 (24 bits) and then
to bf16 (8 bits) is rounding it to bf16 once (24 >= 2 * 8 + 2). These tests
show that on about 10^6 seeded operand pairs per operation, with exponents
spread so that sums lose bits to rounding: the f32 result (numpy, IEEE) rounded
by `_rd` equals the exact result rounded straight to bf16 by bit arithmetic
(the exact result in f64: +, - and x of bf16 operands are exact there, / and
sqrt are rounded to 53 bits, which the same argument covers). They also show
why the kernel must not fuse: RN(a b + c) differs from RN(RN(a b) + c) on
some inputs. And the twin's `_rd` of the f32 operation equals torch's own CPU
bf16 operation.
"""

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.ops.pallas_pair import _rd

N = 1_000_000
SPREAD = 20  # operand exponents in [-SPREAD, SPREAD]: sums of two differ by up to 40


def _bf16_operands(rng, n, spread, positive=False):
    """n random bf16 values as float32, unbiased exponents in [-spread, spread]
    and every fraction."""
    sign = np.zeros(n, np.uint32) if positive else rng.integers(0, 2, n).astype(np.uint32)
    exp = rng.integers(127 - spread, 127 + spread + 1, n).astype(np.uint32)
    frac = rng.integers(0, 128, n).astype(np.uint32)
    return (((sign << 15) | (exp << 7) | frac) << 16).view(np.float32)


def _bits(x32: np.ndarray) -> np.ndarray:
    """The bf16 bits of float32 values that are bf16 values."""
    bits = x32.view(np.uint32)
    assert not (bits & 0xFFFF).any()
    return (bits >> 16).astype(np.uint16)


def _rd_bits(x32: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 by the twin's `_rd`, as bf16 bits."""
    return _bits(_rd(torch.from_numpy(x32)).numpy())


def _bf16_of_f64(x: np.ndarray) -> np.ndarray:
    """Finite f64 values inside bf16's normal range rounded to nearest-even
    bf16 by bit arithmetic on their encoding, as bf16 bits."""
    b = x.view(np.uint64)
    sign = b >> np.uint64(63)
    mag = b & np.uint64(0x7FFF_FFFF_FFFF_FFFF)
    keep = mag >> np.uint64(45)  # the exponent and 7 fraction bits
    rest = mag & np.uint64((1 << 45) - 1)
    half = np.uint64(1 << 44)
    keep = keep + ((rest > half) | ((rest == half) & ((keep & np.uint64(1)) == 1)))
    exp = (keep >> np.uint64(7)).astype(np.int64) - 1023 + 127  # a carry moves it up
    assert ((exp > 0) & (exp < 255) | (mag == 0)).all(), "outside bf16's normal range"
    out = np.where(mag == 0, 0, (exp << 7) | (keep & np.uint64(0x7F)).astype(np.int64))
    return (out | (sign.astype(np.int64) << 15)).astype(np.uint16)


OPS = {
    "add": (lambda a, b: a + b, False),
    "sub": (lambda a, b: a - b, False),
    "mul": (lambda a, b: a * b, False),
    "div": (lambda a, b: a / b, False),
    "sqrt": (lambda a, b: np.sqrt(a), True),
}


@pytest.mark.parametrize("op", list(OPS))
def test_f32_then_bf16_is_one_bf16_rounding(op):
    """For +, -, x, / and sqrt of bf16 operands the f32 result rounded by the
    twin's `_rd` is the exact result rounded once to bf16."""
    fn, positive = OPS[op]
    rng = np.random.default_rng(list(OPS).index(op))
    a = _bf16_operands(rng, N, SPREAD, positive)
    b = _bf16_operands(rng, N, SPREAD)
    with np.errstate(all="raise"):
        r32 = fn(a, b)  # IEEE float32, nearest even
        r64 = fn(a.astype(np.float64), b.astype(np.float64))
    direct = _bf16_of_f64(r64)
    np.testing.assert_array_equal(_rd_bits(r32), direct)
    # the cases are hard ones: most results round, and for the sums many lose
    # bits in f32 already (operands more than 24 binades apart)
    rounded = direct.astype(np.uint32) << 16
    assert (rounded.view(np.float32).astype(np.float64) != r64).mean() > 0.5
    if op in ("add", "sub"):
        assert (r32.astype(np.float64) != r64).mean() > 0.3


def test_fused_multiply_add_rounds_differently():
    """RN(a b + c), one rounding as an FMA gives it, differs from JAX's
    RN(RN(a b) + c) on some inputs: the kernel's bf16 products and sums must
    stay two instructions (the _rn intrinsics, never contracted)."""
    rng = np.random.default_rng(7)
    a, b, c = (_bf16_operands(rng, N, SPREAD // 2) for _ in range(3))
    fused = _bf16_of_f64(a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64))
    product = _rd(torch.from_numpy(a * b)).numpy()
    unfused = _rd_bits(product + c)
    differ = fused != unfused
    assert differ.sum() > 1000
    assert differ.mean() < 0.5  # mostly the same: the difference is the rounding


TORCH_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "sqrt": lambda a, b: torch.sqrt(a.abs()),
}


@pytest.mark.parametrize("op", list(TORCH_OPS))
def test_twin_rounding_is_torch_bf16(op):
    """The twin's `_rd` of torch's f32 operation equals torch's own bf16
    operation on the CPU (which computes in f32 and rounds to nearest even),
    as the JAX package's bf16 operations do."""
    fn = TORCH_OPS[op]
    rng = np.random.default_rng(100 + list(TORCH_OPS).index(op))
    a = torch.from_numpy(_bf16_operands(rng, N, SPREAD))
    b = torch.from_numpy(_bf16_operands(rng, N, SPREAD))
    twin = _rd(fn(a, b))
    native = fn(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.float32)
    assert torch.equal(twin.view(torch.int32), native.view(torch.int32))
