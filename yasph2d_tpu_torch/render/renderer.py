"""Headless particle renderer + PNG recording (port of
yasph2d_tpu/render/renderer.py).

Replaces the reference's ggez/wgpu realtime renderer (reference: src/main.rs:239-275,
draw_fluid) with a headless rasterizer: device -> host readback of positions and
velocities once per rendered frame, disk stamping into an RGB buffer, and PNG
recording mode writing `recording/{frame}.png` (reference: main.rs:380-397).

Colors match the reference: background (0.4, 0.4, 0.45), boundary particles dark grey
(0.2), fluid colored by the velocity heatmap `heatmap_color(|v| * 0.1)`
(main.rs:74-81, 255).

The native C++ library (native/render.cpp, native/recorder.cpp) draws the frames
and writes the recording; it is built at first use, and a failed build raises.
`ParticleRenderer(use_native=False)` is the NumPy rasterizer, the plain version
the native one is held against; nothing chooses it unasked.
"""

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..native import load_render
from .camera import Camera

BACKGROUND_COLOR = (0.4, 0.4, 0.45)  # main.rs:371
BOUNDARY_COLOR = (0.2, 0.2, 0.2)  # main.rs:155-160


def heatmap_color(t: np.ndarray) -> np.ndarray:
    """Blue-free heatmap ramp (reference: main.rs:74-81): r,g,b ramp in thirds of t.

    t: (...,) -> (..., 3) float in [0, 1].
    """
    t = np.asarray(t, dtype=np.float32)
    return np.stack(
        [
            np.clip(t * 3.0, 0.0, 1.0),
            np.clip(t * 3.0 - 1.0, 0.0, 1.0),
            np.clip(t * 3.0 - 2.0, 0.0, 1.0),
        ],
        axis=-1,
    )


def _disk_offsets(radius_px: float) -> np.ndarray:
    """Integer pixel offsets covering a filled disk of the given pixel radius."""
    r = max(int(np.ceil(radius_px)), 0)
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    inside = ys * ys + xs * xs <= max(radius_px * radius_px, 0.25)
    return np.stack([ys[inside], xs[inside]], axis=-1)  # (P, 2)


def _stamp(image: np.ndarray, centers_px: np.ndarray, colors: np.ndarray, offsets: np.ndarray):
    """Paint filled disks: centers (N, 2) in (x, y) pixels, colors (N, 3) or (3,)."""
    if centers_px.shape[0] == 0:
        return
    h, w, _ = image.shape
    cx = np.round(centers_px[:, 0]).astype(np.int64)
    cy = np.round(centers_px[:, 1]).astype(np.int64)
    colors = np.broadcast_to(colors, (centers_px.shape[0], 3))
    for dy, dx in offsets:
        x = np.clip(cx + dx, 0, w - 1)
        y = np.clip(cy + dy, 0, h - 1)
        image[y, x] = colors


@dataclass
class ParticleRenderer:
    """Rasterizes one frame of the particle world: through the native C++
    rasterizer (native/render.cpp), or with `use_native=False` through NumPy."""

    camera: Camera
    particle_radius: float  # world units (reference draws circles of particle_radius)
    resolution: Tuple[int, int] = (1920, 1080)  # reference window size (main.rs:22)
    use_native: bool = True

    def __post_init__(self):
        radius_px = self.particle_radius * self.camera.pixel_per_world_unit
        self._radius_px = radius_px
        self._offsets = _disk_offsets(radius_px)
        self._native = load_render() if self.use_native else None

    def _render_native(self, positions, velocities, boundary_positions) -> np.ndarray:
        w, h = self.resolution
        sx, sy, sw, sh = self.camera.screen
        ppwu = self.camera.pixel_per_world_unit
        px, py = self.camera.position
        offset_x = sx + sw * 0.5 - px * ppwu
        offset_y = sy + sh * 0.5 + py * ppwu

        pos = np.ascontiguousarray(positions, dtype=np.float32)
        vel = (
            np.ascontiguousarray(velocities, dtype=np.float32)
            if velocities is not None
            else None
        )
        bnd = (
            np.ascontiguousarray(boundary_positions, dtype=np.float32)
            if boundary_positions is not None and len(boundary_positions)
            else None
        )
        image = np.empty((h, w, 3), dtype=np.uint8)
        self._native.yasph_rasterize(
            pos.ctypes.data, vel.ctypes.data if vel is not None else None,
            pos.shape[0],
            bnd.ctypes.data if bnd is not None else None,
            bnd.shape[0] if bnd is not None else 0,
            image.ctypes.data, w, h,
            offset_x, offset_y, ppwu, self._radius_px,
            *BACKGROUND_COLOR,
        )
        return image

    def render(
        self,
        positions: np.ndarray,
        velocities: Optional[np.ndarray] = None,
        boundary_positions: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Returns an (H, W, 3) uint8 frame."""
        if self._native is not None:
            return self._render_native(
                np.asarray(positions),
                None if velocities is None else np.asarray(velocities),
                boundary_positions,
            )
        w, h = self.resolution
        image = np.empty((h, w, 3), dtype=np.float32)
        image[:] = BACKGROUND_COLOR

        if boundary_positions is not None and len(boundary_positions):
            centers = self.camera.world_to_screen_coords(np.asarray(boundary_positions))
            _stamp(image, centers, np.asarray(BOUNDARY_COLOR, dtype=np.float32), self._offsets)

        positions = np.asarray(positions)
        if len(positions):
            if velocities is None:
                speed = np.zeros(positions.shape[0], dtype=np.float32)
            else:
                velocities = np.asarray(velocities)
                speed = np.sqrt((velocities * velocities).sum(-1))
            colors = heatmap_color(speed * 0.1)  # main.rs:255
            centers = self.camera.world_to_screen_coords(positions)
            _stamp(image, centers, colors, self._offsets)

        return (image * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image: np.ndarray):
    """Synchronous PNG writer on the host: PIL where it is installed, else the
    standard library's zlib (the recorder's workers encode with the native
    library)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        Image.fromarray(image).save(path)
        return
    import struct
    import zlib

    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))

    def chunk(tag, data):
        payload = tag + data
        return (
            struct.pack(">I", len(data))
            + payload
            + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class Recorder:
    """PNG-sequence recording mode (reference: main.rs:380-397): frame n goes to
    `<directory>/<n>.png`.

    With `asynchronous=True` (the default) frames are encoded and written by
    the native library's worker threads behind a bounded queue: a submit copies
    the frame and returns, and blocks while the queue is full
    (native/recorder.cpp). As in the JAX package, a frame whose shape differs
    from the first, or one the recorder refuses because it is stopping, is
    written synchronously by `write_png`. `asynchronous=False` writes every
    frame so. Call `flush()` (or `close()`) before reading the files.
    """

    def __init__(self, directory: str = "recording", asynchronous: bool = True,
                 num_workers: int = 2, queue_capacity: int = 8):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lib = load_render() if asynchronous else None
        self._handle = None
        self._shape = None
        self._async_cfg = (num_workers, queue_capacity)

    def save_frame(self, frame_index: int, image: np.ndarray) -> str:
        path = os.path.join(self.directory, f"{frame_index}.png")
        if self._lib is not None:
            img = np.ascontiguousarray(image, dtype=np.uint8)
            h, w, _ = img.shape
            if self._handle is None:
                self._shape = (h, w)
                self._handle = self._lib.yasph_recorder_create(
                    self.directory.encode(), w, h, *self._async_cfg
                )
            if self._shape == (h, w):
                rc = self._lib.yasph_recorder_submit(
                    self._handle, frame_index, img.ctypes.data
                )
                if rc == 0:
                    return path
        write_png(path, image)
        return path

    def flush(self) -> int:
        """Wait for queued frames; returns the number of failed writes."""
        if self._handle:
            return int(self._lib.yasph_recorder_flush(self._handle))
        return 0

    def close(self) -> int:
        if self._handle:
            errors = int(self._lib.yasph_recorder_destroy(self._handle))
            self._handle = None
            return errors
        return 0

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:  # pragma: no cover
            pass
