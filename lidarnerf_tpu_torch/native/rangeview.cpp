// Native range-view projection (host-side data loading): a copy of
// lidarnerf_tpu/native/rangeview.cpp.
//
// C++ counterpart of lidarnerf_tpu_torch/dataset/convert.py's numpy
// projection, for the offline on-ramp at sensor rate: raw LiDAR scans
// (~120k points) -> pano range images via scatter-min, and the inverse
// pano -> compacted point list. Built at first use by native/__init__.py
// (g++ -O3) into lidarnerf_tpu_torch/_build/ and bound with ctypes; the
// callers use convert.py's numpy version when the library cannot be built.
//
// Projection convention (as convert.py's _project_rc):
//   beta  = pi - atan2(y, x);  alpha = atan2(z, sqrt(x^2+y^2)) + fov_down
//   c = round(beta / (2 pi / W));  r = round(H - alpha / (fov / H))

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {
constexpr double kPi = 3.14159265358979323846;
}

extern "C" {

// points: [n, 4] (x, y, z, intensity) float32 -> pano/inten [H, W] float64
void lidar_to_pano_with_intensities(const float* points, int64_t n, int H,
                                    int W, double fov_up, double fov,
                                    double max_depth, double* pano,
                                    double* inten) {
  const double fov_down = fov - fov_up;
  const double col_scale = W / (2.0 * kPi);
  const double row_scale = H / (fov / 180.0 * kPi);
  std::memset(pano, 0, sizeof(double) * H * W);
  std::memset(inten, 0, sizeof(double) * H * W);
  for (int64_t i = 0; i < n; ++i) {
    const double x = points[i * 4 + 0];
    const double y = points[i * 4 + 1];
    const double z = points[i * 4 + 2];
    const double val = points[i * 4 + 3];
    const double dist = std::sqrt(x * x + y * y + z * z);
    if (dist >= max_depth) continue;
    const double beta = kPi - std::atan2(y, x);
    const double alpha =
        std::atan2(z, std::sqrt(x * x + y * y)) + fov_down / 180.0 * kPi;
    const int64_t c = std::llround(beta * col_scale);
    const int64_t r = std::llround(H - alpha * row_scale);
    if (r < 0 || r >= H || c < 0 || c >= W) continue;
    double& cell = pano[r * W + c];
    if (cell == 0.0 || cell > dist) {
      cell = dist;
      inten[r * W + c] = val;
    }
  }
}

// pano/inten: [H, W] float64 -> out [n_valid, 4]; returns n_valid.
// out must have room for H*W rows.
int64_t pano_to_lidar_with_intensities(const double* pano, const double* inten,
                                       int H, int W, double fov_up, double fov,
                                       float* out) {
  int64_t count = 0;
  for (int r = 0; r < H; ++r) {
    const double alpha = (fov_up - (double)r / H * fov) / 180.0 * kPi;
    for (int c = 0; c < W; ++c) {
      const double d = pano[r * W + c];
      if (d == 0.0) continue;
      // match numpy float32 direction math bit-for-bit (convert.py uses
      // float32 dirs): compute beta per-pixel in float32 like pano_dirs
      const float betaf =
          -((float)c - (float)W / 2.0f) / (float)W * 2.0f * (float)kPi;
      const float alphaf = (float)alpha;
      const float dx = std::cos(alphaf) * std::cos(betaf);
      const float dy = std::cos(alphaf) * std::sin(betaf);
      const float dz = std::sin(alphaf);
      out[count * 4 + 0] = dx * (float)d;
      out[count * 4 + 1] = dy * (float)d;
      out[count * 4 + 2] = dz * (float)d;
      out[count * 4 + 3] = (float)inten[r * W + c];
      ++count;
    }
  }
  return count;
}

}  // extern "C"
