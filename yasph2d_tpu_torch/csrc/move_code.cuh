// The re-bucket's move code of one live slot, shared by K2 (csrc/rebucket.cu)
// and K4 (csrc/sm_rebucket.cu).
//
// Bit for bit the JAX package's move codes (pf_move_codes, and move_codes in
// the slot layout; the port's ops/dense_grid.py move_codes and cell_coords):
// f32(pos - f32(origin)) * f32(1/cell_size), floorf, an int cast (cvt.rzi,
// saturating, as torch's .to(int32) on the card), clamp to the grid, minus
// the slot's own cell, clamp to +-1. The code is (dy + 1) * 3 + (dx + 1) + 1
// in 1..9; 0 is left for a dead slot. The build's -fmad=false keeps the
// subtract and the multiply apart.

#pragma once

#include <stdint.h>

struct MoveGrid {
  int nx, ny;        // the cell coordinates' clamp range
  float inv, ox, oy; // f32(1/cell_size), f32(origin)
};

// the move code of a live slot of cell (gy, gx) whose position is (px, py)
__device__ __forceinline__ uint8_t move_code(float px, float py, int gy, int gx,
                                             const MoveGrid& g) {
  int cx = (int)floorf((px - g.ox) * g.inv);
  int cy = (int)floorf((py - g.oy) * g.inv);
  cx = min(max(cx, 0), g.nx - 1);
  cy = min(max(cy, 0), g.ny - 1);
  const int dx = min(max(cx - gx, -1), 1);
  const int dy = min(max(cy - gy, -1), 1);
  return (uint8_t)((dy + 1) * 3 + (dx + 1) + 1);
}
