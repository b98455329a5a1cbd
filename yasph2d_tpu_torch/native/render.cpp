// Native rasterizer + PNG encoder for the particle renderer (a copy of
// yasph2d_tpu/native/render.cpp; the statements are the same, so both draw the
// same pixels).
//
// Counterpart of the reference's wgpu-backed draw path (reference:
// src/main.rs:239-275 draw_fluid instanced MeshBatch; main.rs:380-397 PNG
// screenshot recording). Device work stays on the GPU; this is the host-side
// presentation layer: positions/velocities are read back once per rendered frame and
// rasterized here. C++ because the Python/numpy stamping loop is the recorder's
// bottleneck at 100k+ particles (the reference's equivalent layer is native too).
//
// Exposed C ABI (ctypes):
//   yasph_rasterize(...)   fill background + stamp boundary & fluid disks
//   yasph_write_png(...)   RGB8 -> PNG file (zlib-compressed, single IDAT)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

inline void heatmap(float t, uint8_t* rgb) {
  // reference heatmap ramp (main.rs:74-81): r,g,b saturate in thirds of t
  const float r = std::clamp(t * 3.0f, 0.0f, 1.0f);
  const float g = std::clamp(t * 3.0f - 1.0f, 0.0f, 1.0f);
  const float b = std::clamp(t * 3.0f - 2.0f, 0.0f, 1.0f);
  rgb[0] = static_cast<uint8_t>(r * 255.0f + 0.5f);
  rgb[1] = static_cast<uint8_t>(g * 255.0f + 0.5f);
  rgb[2] = static_cast<uint8_t>(b * 255.0f + 0.5f);
}

struct DiskOffsets {
  std::vector<int32_t> dx, dy;
};

DiskOffsets disk_offsets(float radius_px) {
  DiskOffsets out;
  const int r = std::max(0, static_cast<int>(std::ceil(radius_px)));
  const float r_sq = std::max(radius_px * radius_px, 0.25f);
  for (int y = -r; y <= r; ++y)
    for (int x = -r; x <= r; ++x)
      if (static_cast<float>(x * x + y * y) <= r_sq) {
        out.dx.push_back(x);
        out.dy.push_back(y);
      }
  return out;
}

inline void stamp(uint8_t* image, int w, int h, float cx, float cy,
                  const DiskOffsets& disk, const uint8_t* rgb) {
  const int px = static_cast<int>(std::lround(cx));
  const int py = static_cast<int>(std::lround(cy));
  for (size_t k = 0; k < disk.dx.size(); ++k) {
    const int x = std::clamp(px + disk.dx[k], 0, w - 1);
    const int y = std::clamp(py + disk.dy[k], 0, h - 1);
    uint8_t* p = image + (static_cast<size_t>(y) * w + x) * 3;
    p[0] = rgb[0];
    p[1] = rgb[1];
    p[2] = rgb[2];
  }
}

}  // namespace

extern "C" {

// positions/velocities: (n, 2) float32, world coords; velocities may be null.
// boundary: (nb, 2) float32 or null. image: (h, w, 3) uint8 out.
// Camera affine (y-up world -> y-down screen, reference: src/camera.rs:43-51):
//   screen_x = wx * scale + offset_x;  screen_y = -wy * scale + offset_y
void yasph_rasterize(const float* positions, const float* velocities, int64_t n,
                     const float* boundary, int64_t nb, uint8_t* image, int32_t w,
                     int32_t h, float offset_x, float offset_y, float scale,
                     float radius_px, float bg_r, float bg_g, float bg_b) {
  const uint8_t bg[3] = {static_cast<uint8_t>(bg_r * 255.0f + 0.5f),
                         static_cast<uint8_t>(bg_g * 255.0f + 0.5f),
                         static_cast<uint8_t>(bg_b * 255.0f + 0.5f)};
  for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i)
    std::memcpy(image + i * 3, bg, 3);

  const DiskOffsets disk = disk_offsets(radius_px);

  const uint8_t boundary_rgb[3] = {51, 51, 51};  // 0.2 grey (main.rs:155-160)
  for (int64_t i = 0; i < nb; ++i) {
    const float sx = boundary[2 * i] * scale + offset_x;
    const float sy = -boundary[2 * i + 1] * scale + offset_y;
    stamp(image, w, h, sx, sy, disk, boundary_rgb);
  }

  for (int64_t i = 0; i < n; ++i) {
    uint8_t rgb[3];
    if (velocities) {
      const float vx = velocities[2 * i], vy = velocities[2 * i + 1];
      heatmap(std::sqrt(vx * vx + vy * vy) * 0.1f, rgb);  // main.rs:255
    } else {
      heatmap(0.0f, rgb);
    }
    const float sx = positions[2 * i] * scale + offset_x;
    const float sy = -positions[2 * i + 1] * scale + offset_y;
    stamp(image, w, h, sx, sy, disk, rgb);
  }
}

// Minimal PNG writer: 8-bit RGB, one zlib stream. Returns 0 on success.
int32_t yasph_write_png(const char* path, const uint8_t* image, int32_t w,
                        int32_t h) {
  // filter byte 0 per scanline
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int32_t y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], image + y * stride, stride);
  }

  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return -1;
  comp.resize(comp_cap);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;

  auto be32 = [](uint32_t v, uint8_t* out) {
    out[0] = v >> 24;
    out[1] = v >> 16;
    out[2] = v >> 8;
    out[3] = v;
  };
  auto chunk = [&](const char tag[4], const uint8_t* data, uint32_t len) {
    uint8_t hdr[8];
    be32(len, hdr);
    std::memcpy(hdr + 4, tag, 4);
    std::fwrite(hdr, 1, 8, f);
    if (len) std::fwrite(data, 1, len, f);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, hdr + 4, 4);
    if (len) crc = crc32(crc, data, len);
    uint8_t crc_be[4];
    be32(crc, crc_be);
    std::fwrite(crc_be, 1, 4, f);
  };

  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::fwrite(sig, 1, 8, f);
  uint8_t ihdr[13];
  be32(static_cast<uint32_t>(w), ihdr);
  be32(static_cast<uint32_t>(h), ihdr + 4);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", comp.data(), static_cast<uint32_t>(comp.size()));
  chunk("IEND", nullptr, 0);
  std::fclose(f);
  return 0;
}

}  // extern "C"
