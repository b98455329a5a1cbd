"""Morton (Z-order) codes for 2D cell coordinates (PyTorch port of
yasph2d_tpu/ops/morton.py; reference: src/sph/morton.rs).

Branch-free bit interleaving on integer tensors (int32, uint32 or int64) or
Python ints, and the reference's LITMAX/BIGMIN range step `find_bigmin` as a
host-side scalar helper. torch has no shifts on uint32, so tensors are widened
to int64 for the bit arithmetic and cast back to their own dtype. No solver
uses these: the neighbour search (ops/neighborhood.py) keys cells row-major,
where range skipping is not needed.
"""

import numpy as np
import torch

MORTON_XBITS = 0x5555_5555  # even bits carry x (reference: morton.rs:1-2)
MORTON_YBITS = 0xAAAA_AAAA  # odd bits carry y


def _bitwise(fn):
    """Run `fn` on int64 copies of tensor arguments and cast an integer
    result to the first tensor argument's dtype; Python ints pass through."""
    def run(*args):
        dtype = next((a.dtype for a in args if isinstance(a, torch.Tensor)), None)
        out = fn(*(a.to(torch.int64) if isinstance(a, torch.Tensor) else a for a in args))
        if dtype is None or out.dtype == torch.bool:
            return out
        return out.to(dtype)
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


def _part_1by1(x):
    """Spread the low 16 bits of x with a zero bit between each
    (reference: morton.rs:38-45)."""
    x = x & 0x0000_FFFF
    x = (x | (x << 8)) & 0x00FF_00FF
    x = (x | (x << 4)) & 0x0F0F_0F0F
    x = (x | (x << 2)) & 0x3333_3333
    x = (x | (x << 1)) & 0x5555_5555
    return x


def _compact_1by1(x):
    """Inverse of _part_1by1 (reference: morton.rs:57-65)."""
    x = x & 0x5555_5555
    x = (x | (x >> 1)) & 0x3333_3333
    x = (x | (x >> 2)) & 0x0F0F_0F0F
    x = (x | (x >> 4)) & 0x00FF_00FF
    x = (x | (x >> 8)) & 0x0000_FFFF
    return x


@_bitwise
def encode(x, y):
    """Interleave 16-bit x (even bits) and y (odd bits) into a 32-bit Morton
    key (reference: morton.rs:25-31, 47-51); inputs in [0, 2^16)."""
    return (_part_1by1(y) << 1) | _part_1by1(x)


@_bitwise
def decode_x(code):
    """x of a Morton key (reference: morton.rs:68-71)."""
    return _compact_1by1(code)


@_bitwise
def decode_y(code):
    """y of a Morton key (reference: morton.rs:73-77)."""
    return _compact_1by1(code >> 1)


@_bitwise
def is_in_rect_presplit(code, min_xbits, min_ybits, max_xbits, max_ybits):
    """Inclusive rect membership on a pre-split rect, bool
    (reference: morton.rs:123-128)."""
    xbits = code & MORTON_XBITS
    ybits = code & MORTON_YBITS
    return (xbits >= min_xbits) & (xbits <= max_xbits) & (ybits >= min_ybits) \
        & (ybits <= max_ybits)


def is_in_rect(code, min_x, min_y, max_x, max_y):
    """Inclusive rect membership for plain coordinates, bool."""
    return is_in_rect_presplit(code, _part_1by1(min_x), _part_1by1(min_y) << 1,
                               _part_1by1(max_x), _part_1by1(max_y) << 1)


def find_bigmin(code_beyond_rect, rect_min_code, rect_max_code):
    """BIGMIN: the smallest Morton code > `code_beyond_rect` inside the rect
    (reference: morton.rs:130-182, Tropf & Herzog 1981). Host-side: Python or
    numpy integer arguments, a numpy uint32 result."""
    code = np.uint32(code_beyond_rect)
    rmin = np.uint32(rect_min_code)
    rmax = np.uint32(rect_max_code)
    bigmin = np.uint32(0)

    # bits from most to least significant, with the case table of morton.rs:151-182
    for bit_pos in range(31, -1, -1):
        bit = np.uint32(1) << np.uint32(bit_pos)
        dim_mask = np.uint32(MORTON_XBITS if bit_pos % 2 == 0 else MORTON_YBITS)
        low_mask = (bit - np.uint32(1)) & dim_mask

        code_bit = bool(code & bit)
        min_bit = bool(rmin & bit)
        max_bit = bool(rmax & bit)

        if not code_bit and not min_bit and not max_bit:
            continue
        if not code_bit and not min_bit and max_bit:
            bigmin = np.uint32((rmin & ~low_mask & ~bit) | bit)
            rmax = np.uint32((rmax & ~bit) | low_mask)
        elif not code_bit and min_bit and max_bit:
            return rmin
        elif code_bit and not min_bit and not max_bit:
            return bigmin
        elif code_bit and not min_bit and max_bit:
            rmin = np.uint32((rmin & ~low_mask & ~bit) | bit)
        elif code_bit and min_bit and max_bit:
            continue
        else:
            raise ValueError("invalid morton rect: min bit set where max bit unset")
    return bigmin


def cell_key_morton(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """int32 Morton sort key of cell coordinates, clamped to [0, 2^15) so
    the key never sets the sign bit."""
    cx = torch.clamp(cx, 0, (1 << 15) - 1).to(torch.int32)
    cy = torch.clamp(cy, 0, (1 << 15) - 1).to(torch.int32)
    return encode(cx, cy)
