// Native artifact serializer for grtrace_torch: a copy of
// grtrace/native/csvio.cpp (the port keeps its own), writing the same bytes.
//
// The host-side tail of every render is dumping photon_data.csv
// (H*W rows x 14 columns, reference schema raytracing.py:275-280) and
// sampled_rays.csv (raytracing.py:288-298).  pandas.to_csv costs seconds at
// 400x400; this serializer formats rows straight from the raw arrays with a
// fixed-point/shortest-float grisu-lite formatter and one write(2) per file.
//
// Exposed C ABI (ctypes):
//   grt_write_photon_csv(path, h, w, final_r, final_th, final_ph,
//                        cls, heading, p0, alpha0)        -> 0 on success
//   grt_write_sampled_csv(path, n_rays, n_pts, xyz, heading) -> 0
//
// Built by grtrace_torch/native/__init__.py: g++ -O3 -shared -fPIC, into
// build/grtrace_torch_native/ beside the package.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* kCollisionNames[5] = {
    "bh", "numerical error", "escape_bg", "escape_no_patch", "in_domain"};

// Format a double with 17 significant digits — always round-trips exactly
// (slightly more verbose than repr-shortest, but one snprintf per value).
inline int format_double(char* out, double v) {
  return snprintf(out, 32, "%.17g", v);
}

struct Buffer {
  std::string data;
  explicit Buffer(size_t reserve) { data.reserve(reserve); }
  void append(const char* s, size_t n) { data.append(s, n); }
  void append_cstr(const char* s) { data.append(s); }
  void append_double(double v) {
    char buf[40];
    int n = format_double(buf, v);
    data.append(buf, n);
  }
  void append_int(int64_t v) {
    char buf[24];
    int n = snprintf(buf, 24, "%lld", static_cast<long long>(v));
    data.append(buf, n);
  }
  void push(char c) { data.push_back(c); }
  int write_file(const char* path) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t written = fwrite(data.data(), 1, data.size(), f);
    fclose(f);
    return written == data.size() ? 0 : -2;
  }
};

}  // namespace

extern "C" {

// final_r/final_th/final_ph/alpha0: (h*w,) float64
// cls: (h*w,) int32 in [0, 4]
// heading: (h*w, 3) float64 ;  p0: (h*w, 4) float64
int grt_write_photon_csv(const char* path, int64_t h, int64_t w,
                         const double* final_r, const double* final_th,
                         const double* final_ph, const int32_t* cls,
                         const double* heading, const double* p0,
                         const double* alpha0) {
  const int64_t n = h * w;
  Buffer buf(static_cast<size_t>(n) * 180 + 256);
  buf.append_cstr(
      "i,j,final_r,final_th,final_ph,collision,h_r,h_theta,h_phi,"
      "p0_t,p0_r,p0_th,p0_ph,alpha0\n");
  for (int64_t k = 0; k < n; ++k) {
    const int32_t c = cls[k];
    if (c < 0 || c > 4) return -3;
    buf.append_int(k / w);
    buf.push(',');
    buf.append_int(k % w);
    buf.push(',');
    buf.append_double(final_r[k]);
    buf.push(',');
    buf.append_double(final_th[k]);
    buf.push(',');
    buf.append_double(final_ph[k]);
    buf.push(',');
    buf.append_cstr(kCollisionNames[c]);
    buf.push(',');
    buf.append_double(heading[3 * k]);
    buf.push(',');
    buf.append_double(heading[3 * k + 1]);
    buf.push(',');
    buf.append_double(heading[3 * k + 2]);
    buf.push(',');
    buf.append_double(p0[4 * k]);
    buf.push(',');
    buf.append_double(p0[4 * k + 1]);
    buf.push(',');
    buf.append_double(p0[4 * k + 2]);
    buf.push(',');
    buf.append_double(p0[4 * k + 3]);
    buf.push(',');
    buf.append_double(alpha0[k]);
    buf.push('\n');
  }
  return buf.write_file(path);
}

// xyz: (n_rays, n_pts, 3) float64 ; heading: (n_rays, 3) float64
int grt_write_sampled_csv(const char* path, int64_t n_rays, int64_t n_pts,
                          const double* xyz, const double* heading) {
  Buffer buf(static_cast<size_t>(n_rays) * n_pts * 140 + 128);
  buf.append_cstr("ray_id,point_idx,x,y,z,r,h_r,h_theta,h_phi\n");
  for (int64_t rid = 0; rid < n_rays; ++rid) {
    const double hr = heading[3 * rid];
    const double hth = heading[3 * rid + 1];
    const double hph = heading[3 * rid + 2];
    for (int64_t p = 0; p < n_pts; ++p) {
      const double* pt = xyz + 3 * (rid * n_pts + p);
      const double x = pt[0], y = pt[1], z = pt[2];
      buf.append_int(rid);
      buf.push(',');
      buf.append_int(p);
      buf.push(',');
      buf.append_double(x);
      buf.push(',');
      buf.append_double(y);
      buf.push(',');
      buf.append_double(z);
      buf.push(',');
      buf.append_double(std::sqrt(x * x + y * y + z * z));
      buf.push(',');
      buf.append_double(hr);
      buf.push(',');
      buf.append_double(hth);
      buf.push(',');
      buf.append_double(hph);
      buf.push('\n');
    }
  }
  return buf.write_file(path);
}

}  // extern "C"
