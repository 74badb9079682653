// Native host kernels of the data pipeline: the port's copy of
// deformablelka_tpu/native/src/dlka_native.cpp.
//
// Upstream's augmentation (data_augmentation_moreDA.py:37-205, through
// batchgenerators) spends its time in nnUNet's SpatialTransform, in one
// scipy.ndimage.affine_transform order-3 call per channel. This file is a
// multithreaded affine resampler with cubic B-spline prefiltering over a C
// ABI, loaded with ctypes by deformablelka_tpu_torch/native/__init__.py.
//
// Semantics match scipy.ndimage:
//   order 0: nearest, mode 'constant' (cval)
//   order 1: trilinear, mode 'constant' (cval)
//   order 3: cubic B-spline, prefiltered, mode 'mirror'
//            (scipy affine_transform(..., order=3, mode='mirror')).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------
// Cubic B-spline prefilter (order 3), mirror boundary. Matches scipy's
// spline_filter1d(order=3, mode='mirror'): single pole z = sqrt(3)-2.
// ---------------------------------------------------------------------
const double kPole3 = -0.26794919243112270647;  // sqrt(3) - 2

double initial_causal_mirror(const double* c, int n, double z) {
  // sum_{k} z^k c[k] over the mirrored period, truncated at precision
  double z_i = z;
  double sum = c[0];
  int horizon = (int)std::ceil(std::log(1e-15) / std::log(std::fabs(z)));
  if (horizon < n) {
    for (int i = 1; i < horizon; ++i) {
      sum += z_i * c[i];
      z_i *= z;
    }
    return sum;
  }
  // full-period formula
  double z_n_1 = std::pow(z, (double)(n - 1));
  sum = c[0] + z_n_1 * c[n - 1];
  z_n_1 *= z_n_1;  // z^(2n-2)
  for (int i = 1; i < n - 1; ++i) {
    sum += (z_i + z_n_1 / z_i) * c[i];
    z_i *= z;
  }
  return sum / (1.0 - std::pow(z, (double)(2 * n - 2)));
}

void filter_line(double* c, int n, double z) {
  if (n == 1) return;
  double gain = (1.0 - z) * (1.0 - 1.0 / z);
  for (int i = 0; i < n; ++i) c[i] *= gain;
  c[0] = initial_causal_mirror(c, n, z);
  for (int i = 1; i < n; ++i) c[i] += z * c[i - 1];
  c[n - 1] = z / (z * z - 1.0) * (z * c[n - 2] + c[n - 1]);
  for (int i = n - 2; i >= 0; --i) c[i] = z * (c[i + 1] - c[i]);
}

// mirror index into [0, n-1] (period 2n-2, no edge duplication)
inline int mirror_idx(int i, int n) {
  if (n == 1) return 0;
  int period = 2 * n - 2;
  i = std::abs(i) % period;
  return i < n ? i : period - i;
}

// cubic B-spline weights for fraction t in [0,1): taps at -1,0,1,2
inline void bspline3_weights(double t, double w[4]) {
  double t2 = t * t, t3 = t2 * t;
  w[0] = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0;
  w[1] = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0;
  w[2] = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0;
  w[3] = t3 / 6.0;
}

}  // namespace

extern "C" {

// In-place 3D cubic spline prefilter (mirror), double buffer.
void dlka_spline_filter3_3d(double* data, int n0, int n1, int n2) {
  // axis 2 (contiguous)
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int i = 0; i < n0; ++i)
    for (int j = 0; j < n1; ++j)
      filter_line(data + ((size_t)i * n1 + j) * n2, n2, kPole3);
  // axis 1
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int i = 0; i < n0; ++i)
    for (int k = 0; k < n2; ++k) {
      std::vector<double> line(n1);
      for (int j = 0; j < n1; ++j)
        line[j] = data[((size_t)i * n1 + j) * n2 + k];
      filter_line(line.data(), n1, kPole3);
      for (int j = 0; j < n1; ++j)
        data[((size_t)i * n1 + j) * n2 + k] = line[j];
    }
  // axis 0
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int j = 0; j < n1; ++j)
    for (int k = 0; k < n2; ++k) {
      std::vector<double> line(n0);
      for (int i = 0; i < n0; ++i)
        line[i] = data[((size_t)i * n1 + j) * n2 + k];
      filter_line(line.data(), n0, kPole3);
      for (int i = 0; i < n0; ++i)
        data[((size_t)i * n1 + j) * n2 + k] = line[i];
    }
}

// Affine transform, scipy semantics: for each output voxel o,
// input coordinate = M(3x3 row-major) @ o + offset.
//   order 0/1: mode 'constant' with cval; in = float32 input.
//   order 3:   mode 'mirror'; `in` must be the PREFILTERED double
//              coefficient array (dlka_spline_filter3_3d).
void dlka_affine_transform_3d_f32(
    const float* in, int d0, int d1, int d2,
    const double* m, const double* off,
    float* out, int o0, int o1, int o2,
    int order, float cval) {
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int z = 0; z < o0; ++z)
    for (int y = 0; y < o1; ++y) {
      size_t row = ((size_t)z * o1 + y) * o2;
      for (int x = 0; x < o2; ++x) {
        double iz = m[0] * z + m[1] * y + m[2] * x + off[0];
        double iy = m[3] * z + m[4] * y + m[5] * x + off[1];
        double ix = m[6] * z + m[7] * y + m[8] * x + off[2];
        float v;
        // scipy 'constant' mode: hard cutoff on the UNROUNDED coordinate
        // outside [0, n-1] (verified against ndimage.map_coordinates)
        if (iz < 0.0 || iz > d0 - 1 || iy < 0.0 || iy > d1 - 1 ||
            ix < 0.0 || ix > d2 - 1) {
          v = cval;
        } else if (order == 0) {
          int rz = (int)std::floor(iz + 0.5);
          int ry = (int)std::floor(iy + 0.5);
          int rx = (int)std::floor(ix + 0.5);
          v = in[((size_t)rz * d1 + ry) * d2 + rx];
        } else {  // order 1
          int fz = std::min((int)iz, d0 - 2 < 0 ? 0 : d0 - 2);
          int fy = std::min((int)iy, d1 - 2 < 0 ? 0 : d1 - 2);
          int fx = std::min((int)ix, d2 - 2 < 0 ? 0 : d2 - 2);
          double tz = iz - fz, ty = iy - fy, tx = ix - fx;
          double acc = 0.0;
          for (int cz = 0; cz <= 1; ++cz)
            for (int cy = 0; cy <= 1; ++cy)
              for (int cx = 0; cx <= 1; ++cx) {
                int zz = std::min(fz + cz, d0 - 1);
                int yy = std::min(fy + cy, d1 - 1);
                int xx = std::min(fx + cx, d2 - 1);
                double w = (cz ? tz : 1 - tz) * (cy ? ty : 1 - ty) *
                           (cx ? tx : 1 - tx);
                acc += w * in[((size_t)zz * d1 + yy) * d2 + xx];
              }
          v = (float)acc;
        }
        out[row + x] = v;
      }
    }
}

void dlka_affine_transform_3d_spline3(
    const double* coeff, int d0, int d1, int d2,
    const double* m, const double* off,
    float* out, int o0, int o1, int o2) {
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int z = 0; z < o0; ++z)
    for (int y = 0; y < o1; ++y) {
      size_t row = ((size_t)z * o1 + y) * o2;
      for (int x = 0; x < o2; ++x) {
        double iz = m[0] * z + m[1] * y + m[2] * x + off[0];
        double iy = m[3] * z + m[4] * y + m[5] * x + off[1];
        double ix = m[6] * z + m[7] * y + m[8] * x + off[2];
        int fz = (int)std::floor(iz), fy = (int)std::floor(iy),
            fx = (int)std::floor(ix);
        double wz[4], wy[4], wx[4];
        bspline3_weights(iz - fz, wz);
        bspline3_weights(iy - fy, wy);
        bspline3_weights(ix - fx, wx);
        double acc = 0.0;
        for (int cz = 0; cz < 4; ++cz) {
          int zz = mirror_idx(fz - 1 + cz, d0);
          double az = wz[cz];
          for (int cy = 0; cy < 4; ++cy) {
            int yy = mirror_idx(fy - 1 + cy, d1);
            double ay = az * wy[cy];
            const double* base = coeff + ((size_t)zz * d1 + yy) * d2;
            double s = 0.0;
            for (int cx = 0; cx < 4; ++cx)
              s += wx[cx] * base[mirror_idx(fx - 1 + cx, d2)];
            acc += ay * s;
          }
        }
        out[row + x] = (float)acc;
      }
    }
}

int dlka_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
