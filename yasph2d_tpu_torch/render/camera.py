"""2D camera: world -> screen mapping, uniform scale, y-up world to y-down screen.

A copy of yasph2d_tpu/render/camera.py (host NumPy): the reference camera
(reference: src/camera.rs:14-64) for the headless renderer. Vectorized:
world_to_screen maps whole `(N, 2)` position arrays.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np

Rect = Tuple[float, float, float, float]  # (x, y, w, h)


@dataclass
class Camera:
    """screen: screen rect in pixels; position: world-space camera center
    (reference: camera.rs:14-18)."""

    screen: Rect
    pixel_per_world_unit: float
    position: Tuple[float, float]

    @classmethod
    def center_around_world_rect(cls, screen: Rect, world_rect_to_fit: Rect) -> "Camera":
        """Fit a world rect into the screen, preserving aspect
        (reference: camera.rs:21-35)."""
        sx, sy, sw, sh = screen
        wx, wy, ww, wh = world_rect_to_fit
        ppwu = min(sw / ww, abs(sh) / wh)
        return cls(
            screen=screen,
            pixel_per_world_unit=ppwu,
            position=(wx + ww * 0.5, wy + wh * 0.5),
        )

    def world_to_screen_coords(self, world_pos) -> np.ndarray:
        """Map world positions (..., 2) to screen pixels (y flipped)
        (reference: camera.rs:43-51)."""
        world_pos = np.asarray(world_pos, dtype=np.float32)
        sx, sy, sw, sh = self.screen
        from_camera = world_pos - np.asarray(self.position, dtype=np.float32)
        view_scale = from_camera * self.pixel_per_world_unit
        out = np.empty_like(world_pos)
        out[..., 0] = sx + view_scale[..., 0] + sw * 0.5
        out[..., 1] = sy - view_scale[..., 1] + sh * 0.5
        return out

    def transformation_matrix(self) -> np.ndarray:
        """Column-major 4x4 used by the reference's instanced draw
        (reference: camera.rs:53-64)."""
        sx, sy, sw, sh = self.screen
        scale = np.asarray([self.pixel_per_world_unit, -self.pixel_per_world_unit])
        translation = (
            np.asarray([sx, sy])
            + np.asarray([sw, sh]) * 0.5
            - np.asarray(self.position) * scale
        )
        mat = np.zeros((4, 4), dtype=np.float32)
        mat[0, 0] = scale[0]
        mat[1, 1] = scale[1]
        mat[0, 3] = translation[0]
        mat[1, 3] = translation[1]
        mat[3, 3] = 1.0
        return mat
