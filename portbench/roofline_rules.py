"""The counting rules of the roofline metrics: a frozen copy of the port's
`tools/roofline.py` rules (`pair_bytes`, `rebucket_bytes`, `pair_counts`,
`OPS_PER_PAIR`, `bound`), so that a later change to the program cannot move
the yardstick.

A kernel's bound is the larger of its bytes over the card's memory
bandwidth and its float32 operations over the card's float32 rate (the
H100 SXM data sheet, at the 700 W limit). Bytes: every mask in full, the
positions and values of the live query slots and of the live source slots
in the 3 x 3 cells of a live query (no other slot can change a result),
every output in full (dead slots are written as zeros); a re-bucket moves
its mask in full, the live slots' positions and payload, and every output
in full. Operations: 5 per live candidate (dx, dy, r^2), the term's
operations per valid pair (counted from its functor in
csrc/pair_terms.cuh), 10 per live slot of a re-bucket.
"""

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
OPS_PER_PAIR = {
    "dfsph_ctx": 27, "dfsph_stat": 27, "dfsph_div": 14, "dfsph_corr": 13, "dfsph_visc": 14,
    "wcsph_density": 7, "wcsph_stat": 18, "wcsph_forces": 31,
}
OPS_PER_CANDIDATE = 5
OPS_PER_SLOT_REBUCKET = 10
MIN_DISTANCE_SQ = 1.0e-10


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def slot_bytes(t, need) -> int:
    """Bytes of the slots of `t` that `need` (a slot mask) selects."""
    return nbytes(t) // need.numel() * int(need.sum())


def pair_bytes(q_tensors, s_tensors, masks, output_shapes, q_mask, s_mask) -> int:
    """Bytes a pair pass must move (module docstring); a tensor read as query
    and as source counts each of its slots once."""
    occupied = q_mask.any(-1)[None, None].to(torch.float32)
    near = torch.nn.functional.max_pool2d(occupied, 3, stride=1, padding=1)[0, 0] > 0
    need = {}
    for ts, m in ((q_tensors, q_mask), (s_tensors, s_mask & near[..., None])):
        for t in ts:
            seen = need.get(t.data_ptr())
            need[t.data_ptr()] = (t, m if seen is None else seen[1] | m)
    distinct_masks = {m.data_ptr(): m for m in masks}.values()
    outputs = sum(4 * torch.Size(shape).numel() for shape in output_shapes)
    return (sum(slot_bytes(t, m) for t, m in need.values())
            + sum(nbytes(m) for m in distinct_masks) + outputs)


def rebucket_bytes(pos, mask, payload, output_shapes) -> int:
    """Bytes a re-bucket must move: the mask in full, the live slots'
    positions and payload, every output (positions, mask, payload) in full."""
    mask_out = output_shapes[1]
    outputs = (4 * torch.Size(output_shapes[0]).numel() + torch.Size(mask_out).numel()
               + 4 * torch.Size(output_shapes[2]).numel())
    return nbytes(mask) + slot_bytes(pos, mask) + slot_bytes(payload, mask) + outputs


def pair_counts(q_pos, q_mask, s_pos, s_mask, radius_sq):
    """(live candidates, valid pairs) of a pair pass in the slot layout: query
    live and source live in the 3 x 3 cells, and 1e-10 < r^2 <= h^2."""
    ny, nx, _ = q_mask.shape

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    sp, sm = pad(s_pos.contiguous()), pad(s_mask.contiguous())
    cand = valid = 0
    for dyv in range(3):
        rows = slice(dyv, dyv + ny)
        for dxv in range(3):
            cols = slice(dxv, dxv + nx)
            live = q_mask[..., None] & sm[rows, cols, None, :]
            d = sp[rows, cols, None, :, :] - q_pos[..., None, :]
            r_sq = (d * d).sum(-1)
            cand += int(live.sum())
            valid += int((live & (r_sq <= radius_sq) & (r_sq > MIN_DISTANCE_SQ)).sum())
    return cand, valid


def bound_s(n_bytes: int, n_ops: int) -> float:
    """The least time at the data-sheet rates, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def pair_bound_s(call, radius_sq: float) -> float:
    """The bound of one pair pass (`adapters.PairCall`)."""
    cand, valid = pair_counts(call.q_pos, call.q_mask, call.s_pos, call.s_mask, radius_sq)
    ops = OPS_PER_CANDIDATE * cand + OPS_PER_PAIR[call.form] * valid
    return bound_s(pair_bytes(call.q_tensors, call.s_tensors, call.masks, call.outputs,
                              call.q_mask, call.s_mask), ops)


def rebucket_bound_s(pos, mask, payload, output_shapes) -> float:
    return bound_s(rebucket_bytes(pos, mask, payload, output_shapes),
                   OPS_PER_SLOT_REBUCKET * int(mask.sum()))
