"""The port's camera, renderer and recorder (yasph2d_tpu_torch/render,
yasph2d_tpu_torch/native) against the JAX package's, on seeded inputs.

- Camera: `world_to_screen_coords` and `transformation_matrix` array-equal.
- Renderer: the port's native frame equals the JAX package's native frame bit
  for bit (the same C++ built with the same flags), the port's NumPy frame
  equals JAX's NumPy frame bit for bit, and the port's native and NumPy frames
  differ on under 1% of pixels (the JAX bound, tests/test_render.py:99-121:
  pixel-centre rounding on .5 boundaries).
- PNG: the native encoder and `write_png` round-trip exactly; the asynchronous
  recorder writes many frames through a small queue, `flush()` returns 0.
- No fallback: a native build that fails raises with the compiler's output,
  from the renderer and from the asynchronous recorder alike.
"""

import numpy as np
import pytest
from PIL import Image

import yasph2d_tpu.native as j_native
import yasph2d_tpu.render.renderer as j_renderer
import yasph2d_tpu_torch.native as t_native
from yasph2d_tpu_torch.render.camera import Camera
from yasph2d_tpu_torch.render.renderer import (
    BACKGROUND_COLOR,
    ParticleRenderer,
    Recorder,
    heatmap_color,
    write_png,
)

SCREENS = [((0.0, 0.0, 200.0, 150.0), (0.0, 0.0, 1.0, 1.0)),
           ((0.0, 0.0, 1920.0, 1080.0), (-0.1, -0.1, 2.1, 1.6)),
           ((321.0, 123.0, 200.0, 100.0), (10.0, 10.0, 20.0, 40.0))]


def scene(seed, n=500, nb=200):
    rng = np.random.default_rng(seed)
    positions = rng.random((n, 2)).astype(np.float32)
    velocities = (rng.random((n, 2)).astype(np.float32) - 0.5) * 10.0
    boundary = rng.random((nb, 2)).astype(np.float32) * 0.2
    return positions, velocities, boundary


@pytest.mark.parametrize("screen, rect", SCREENS)
def test_camera_matches_jax(screen, rect):
    ours = Camera.center_around_world_rect(screen, rect)
    ref = j_renderer.Camera.center_around_world_rect(screen, rect)
    assert (ours.screen, ours.pixel_per_world_unit, ours.position) == \
        (ref.screen, ref.pixel_per_world_unit, ref.position)
    pts = (np.random.default_rng(1).random((64, 2)) * 4.0 - 1.0).astype(np.float32)
    np.testing.assert_array_equal(ours.world_to_screen_coords(pts),
                                  ref.world_to_screen_coords(pts))
    np.testing.assert_array_equal(ours.transformation_matrix(), ref.transformation_matrix())


def test_heatmap_color_matches_jax():
    t = np.random.default_rng(2).uniform(-0.5, 1.5, 1000).astype(np.float32)
    np.testing.assert_array_equal(heatmap_color(t), j_renderer.heatmap_color(t))
    np.testing.assert_allclose(heatmap_color(1.0 / 3.0), [1.0, 0.0, 0.0], atol=1e-6)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built by its own loader from its own
    sources and flags, into a private path: the tests never write the shared
    library next to the JAX sources, which the JAX package's tests build."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "_SO", str(tmp_path_factory.mktemp("jax_native") / "librender.so"))
    mp.setattr(j_native, "_render_lib", None)
    mp.setattr(j_native, "_render_failed", False)
    lib = j_native.load_render()
    assert lib is not None, "the JAX package's native library did not build"
    yield lib
    mp.undo()


def renderers(mod, screen, rect, resolution, radius=0.01):
    cam = mod.Camera.center_around_world_rect(screen, rect)
    return [mod.ParticleRenderer(camera=cam, particle_radius=radius, resolution=resolution,
                                 use_native=native) for native in (True, False)]


@pytest.mark.parametrize("seed", [3, 5])
def test_frames_match_jax(seed, jax_native):
    import yasph2d_tpu_torch.render.renderer as t_renderer

    positions, velocities, boundary = scene(seed)
    screen, rect = (0, 0, 200, 150), (0.0, 0.0, 1.0, 1.0)
    t_nat, t_np = renderers(t_renderer, screen, rect, (200, 150))
    j_nat, j_np = renderers(j_renderer, screen, rect, (200, 150))
    assert j_nat._native is jax_native
    a = t_nat.render(positions, velocities, boundary)
    np.testing.assert_array_equal(a, j_nat.render(positions, velocities, boundary))
    b = t_np.render(positions, velocities, boundary)
    np.testing.assert_array_equal(b, j_np.render(positions, velocities, boundary))
    assert a.shape == (150, 200, 3) and a.dtype == np.uint8
    mismatched = (a != b).any(axis=-1).mean()
    assert mismatched < 0.01, f"{mismatched:.4%} of pixels differ"


def test_renderer_paints_particles():
    """tests/test_render.py:28-44 on both of the port's rasterizers."""
    camera = Camera.center_around_world_rect((0, 0, 100, 100), (0.0, 0.0, 1.0, 1.0))
    bg = (np.asarray(BACKGROUND_COLOR) * 255 + 0.5).astype(np.uint8)
    for native in (True, False):
        renderer = ParticleRenderer(camera=camera, particle_radius=0.02,
                                    resolution=(100, 100), use_native=native)
        img = renderer.render(
            positions=np.asarray([[0.5, 0.5]], dtype=np.float32),
            velocities=np.asarray([[0.0, 0.0]], dtype=np.float32),
            boundary_positions=np.asarray([[0.1, 0.1]], dtype=np.float32),
        )
        assert (img[50, 50] == [0, 0, 0]).all()
        assert (img[90, 10] == [51, 51, 51]).all()
        assert (img[0, 99] == bg).all()


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (33, 57, 3), dtype=np.uint8)
    lib = t_native.load_render()
    path = str(tmp_path / "native.png")
    assert lib.yasph_write_png(path.encode(), np.ascontiguousarray(img).ctypes.data,
                               57, 33) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    write_png(str(tmp_path / "host.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "host.png")), img)


def test_async_recorder_many_frames(tmp_path):
    """Async C++ recorder: all frames land on disk through a queue of 3,
    `flush()` returns 0, as tests/test_render.py:168-185."""
    rec = Recorder(str(tmp_path / "rec"), asynchronous=True, num_workers=2,
                   queue_capacity=3)
    imgs = np.random.default_rng(7).integers(0, 256, (20, 32, 48, 3), dtype=np.uint8)
    paths = [rec.save_frame(i, imgs[i]) for i in range(20)]
    assert rec.flush() == 0
    for i, path in enumerate(paths):
        assert path.endswith(f"{i}.png")
        np.testing.assert_array_equal(np.asarray(Image.open(path)), imgs[i])
    # a frame of another shape is written synchronously, as in the JAX package
    odd = imgs[0, :16]
    np.testing.assert_array_equal(np.asarray(Image.open(rec.save_frame(99, odd))), odd)
    assert rec.close() == 0


def test_recorder_synchronous(tmp_path):
    rec = Recorder(str(tmp_path / "rec"), asynchronous=False)
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    img[1, 2] = [255, 0, 0]
    path = rec.save_frame(7, img)
    assert rec.flush() == 0 and path.endswith("7.png")
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, from
    `load_render`, the native renderer and the asynchronous recorder; the
    NumPy renderer and the synchronous recorder need no library."""
    bad = tmp_path / "render.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "SOURCES", (bad,))
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    t_native.load_render.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native render build failed"):
            t_native.load_render()
        cam = Camera.center_around_world_rect((0, 0, 10, 10), (0.0, 0.0, 1.0, 1.0))
        with pytest.raises(RuntimeError, match="does not name a type|error"):
            ParticleRenderer(camera=cam, particle_radius=0.1, resolution=(10, 10))
        with pytest.raises(RuntimeError, match="native render build failed"):
            Recorder(str(tmp_path / "rec"))
        ParticleRenderer(camera=cam, particle_radius=0.1, resolution=(10, 10),
                         use_native=False)
        Recorder(str(tmp_path / "rec"), asynchronous=False)
    finally:
        t_native.load_render.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_lives_in_build_tree():
    path = t_native.build()
    assert path.parent == t_native.BUILD_DIR and path.name.startswith("librender_")
    assert path.parent != t_native.SOURCES[0].parent
