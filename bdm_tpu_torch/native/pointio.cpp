// Native point-cloud IO: fast .npy (float32/float64) and binary .ply
// readers plus a std::thread parallel batch loader.
//
// The reference's native layer is its CUDA op library (which became the
// kernels of bdm_tpu_torch/csrc/); the remaining native-worthy hot path on the host is data
// loading — the R2N2 dataset eagerly reads thousands of 15000x3 .npy
// clouds at startup (`shapenet_r2n2.py:383-503`). This library reads and
// subsamples them off the GIL.
//
// C ABI (ctypes-friendly):
//   pointio_read_npy(path, out*, max_points, seed) -> n_points or -errcode
//   pointio_read_ply(path, out*, max_points, seed) -> n_points or -errcode
//   pointio_read_many_npy(paths, n, out*, stride, max_points, seed, nthreads)
//
// Build: inline in bdm_tpu_torch/native/pointio.py::_build (g++ -O3 -shared
// -fPIC).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrParse = -2;
constexpr int kErrFormat = -3;

// Read a whole file into a buffer.
bool read_file(const char* path, std::vector<char>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

// Uniform-without-replacement-ish subsample (with replacement when
// max_points > n, matching np.random.choice(n, k) semantics which samples
// WITH replacement — `shapenet_r2n2.py:484`).
void subsample(const float* src, int64_t n, float* dst, int64_t k,
               uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> dist(0, n - 1);
  for (int64_t i = 0; i < k; ++i) {
    int64_t j = dist(rng);
    std::memcpy(dst + 3 * i, src + 3 * j, 3 * sizeof(float));
  }
}

// Parse a .npy of shape (N, 3), dtype <f4 or <f8. Returns N or error.
int64_t parse_npy(const std::vector<char>& buf, std::vector<float>& pts) {
  if (buf.size() < 10 || std::memcmp(buf.data(), "\x93NUMPY", 6) != 0)
    return kErrParse;
  uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = *reinterpret_cast<const uint16_t*>(buf.data() + 8);
    header_off = 10;
  } else {
    header_len = *reinterpret_cast<const uint32_t*>(buf.data() + 8);
    header_off = 12;
  }
  std::string header(buf.data() + header_off, header_len);
  bool f8 = header.find("<f8") != std::string::npos;
  bool f4 = header.find("<f4") != std::string::npos;
  if (!f4 && !f8) return kErrFormat;
  if (header.find("'fortran_order': True") != std::string::npos)
    return kErrFormat;
  size_t p = header.find("'shape': (");
  if (p == std::string::npos) return kErrParse;
  int64_t n = 0, d = 0;
  if (std::sscanf(header.c_str() + p, "'shape': (%ld, %ld)", &n, &d) != 2 ||
      d != 3)
    return kErrFormat;
  const char* data = buf.data() + header_off + header_len;
  size_t need = static_cast<size_t>(n) * 3 * (f8 ? 8 : 4);
  if (buf.size() < header_off + header_len + need) return kErrParse;
  pts.resize(static_cast<size_t>(n) * 3);
  if (f4) {
    std::memcpy(pts.data(), data, need);
  } else {
    const double* src = reinterpret_cast<const double*>(data);
    for (int64_t i = 0; i < n * 3; ++i) pts[i] = static_cast<float>(src[i]);
  }
  return n;
}

// Parse vertices from a binary_little_endian or ascii .ply (x,y,z floats
// leading each vertex record). Returns N or error.
int64_t parse_ply(const std::vector<char>& buf, std::vector<float>& pts) {
  const char* p = buf.data();
  const char* end = p + buf.size();
  auto line = [&]() {
    const char* s = p;
    while (p < end && *p != '\n') ++p;
    std::string out(s, p - s);
    if (p < end) ++p;
    if (!out.empty() && out.back() == '\r') out.pop_back();
    return out;
  };
  if (line() != "ply") return kErrParse;
  bool binary = false, ascii = false;
  int64_t n = -1;
  int n_props = 0, per_vertex_bytes = 0;
  bool in_vertex = false;
  while (p < end) {
    std::string l = line();
    if (l.rfind("format ascii", 0) == 0) ascii = true;
    if (l.rfind("format binary_little_endian", 0) == 0) binary = true;
    if (l.rfind("element vertex ", 0) == 0) {
      n = std::strtoll(l.c_str() + 15, nullptr, 10);
      in_vertex = true;
    } else if (l.rfind("element ", 0) == 0) {
      in_vertex = false;
    }
    if (in_vertex && l.rfind("property ", 0) == 0) {
      ++n_props;
      if (l.find("float") != std::string::npos) per_vertex_bytes += 4;
      else if (l.find("double") != std::string::npos) per_vertex_bytes += 8;
      else if (l.find("uchar") != std::string::npos) per_vertex_bytes += 1;
      else per_vertex_bytes += 4;
    }
    if (l == "end_header") break;
  }
  if (n <= 0 || (!binary && !ascii) || n_props < 3) return kErrFormat;
  pts.resize(static_cast<size_t>(n) * 3);
  if (binary) {
    // assume the first three properties are float x, y, z
    for (int64_t i = 0; i < n; ++i) {
      const char* rec = p + i * per_vertex_bytes;
      if (rec + 12 > end) return kErrParse;
      std::memcpy(&pts[3 * i], rec, 12);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      std::string l = line();
      if (std::sscanf(l.c_str(), "%f %f %f", &pts[3 * i], &pts[3 * i + 1],
                      &pts[3 * i + 2]) != 3)
        return kErrParse;
    }
  }
  return n;
}

int64_t read_one(const char* path, float* out, int64_t max_points,
                 uint64_t seed, bool is_ply) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return kErrOpen;
  std::vector<float> pts;
  int64_t n = is_ply ? parse_ply(buf, pts) : parse_npy(buf, pts);
  if (n <= 0) return n;
  if (max_points > 0 && max_points != n) {
    subsample(pts.data(), n, out, max_points, seed);
    return max_points;
  }
  std::memcpy(out, pts.data(), static_cast<size_t>(n) * 3 * sizeof(float));
  return n;
}

}  // namespace

extern "C" {

int64_t pointio_read_npy(const char* path, float* out, int64_t max_points,
                         uint64_t seed) {
  return read_one(path, out, max_points, seed, /*is_ply=*/false);
}

int64_t pointio_read_ply(const char* path, float* out, int64_t max_points,
                         uint64_t seed) {
  return read_one(path, out, max_points, seed, /*is_ply=*/true);
}

// Load many .npy files in parallel. `out` is (n_files, stride, 3) floats;
// every cloud is subsampled (or copied) to exactly `stride` points.
// Returns 0 on success or the first error code encountered.
int64_t pointio_read_many_npy(const char** paths, int64_t n_files, float* out,
                              int64_t stride, uint64_t seed,
                              int64_t n_threads) {
  std::atomic<int64_t> next(0), err(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) break;
      int64_t r = pointio_read_npy(paths[i], out + i * stride * 3, stride,
                                   seed + static_cast<uint64_t>(i));
      if (r < 0) err.store(r);
    }
  };
  int64_t nt = n_threads > 0 ? n_threads
                             : std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  std::vector<std::thread> threads;
  for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
