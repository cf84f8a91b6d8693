// Multithreaded .npy batch loader.
//
// The host-side hot path of the data pipeline is loading hundreds of small
// per-frame optical-flow feature .npy files per sequence
// (reference: per-file np.load loop, egoego/data/ares_headpose_dataset.py:160-170).
// This loader parses the npy header and reads the payload for a whole batch
// of files across a thread pool, converting float64 payloads to float32
// in place (the bundled fixtures store features as <f8).
//
// A copy of egoego_release_tpu/native/npy_loader.cpp for the PyTorch port.
//
// Exposed C ABI (used via ctypes from egoego_release_tpu_torch.data.native_loader):
//   int load_npy_batch(const char** paths, int n_files,
//                      float* out, long floats_per_file, int n_threads);
// Returns 0 on success, or (1 + index) of the first failing file.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  bool ok = false;
  bool is_f8 = false;      // <f8 payload (else <f4)
  long count = 0;          // number of elements
  long data_offset = 0;    // byte offset of payload
};

NpyInfo parse_header(FILE* f) {
  NpyInfo info;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return info;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t hl;
    if (fread(&hl, 2, 1, f) != 1) return info;
    header_len = hl;
    info.data_offset = 10 + header_len;
  } else {
    uint32_t hl;
    if (fread(&hl, 4, 1, f) != 1) return info;
    header_len = hl;
    info.data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return info;

  // dtype
  if (header.find("'<f8'") != std::string::npos ||
      header.find("'float64'") != std::string::npos) {
    info.is_f8 = true;
  } else if (header.find("'<f4'") == std::string::npos &&
             header.find("'float32'") == std::string::npos) {
    return info;  // unsupported dtype
  }
  if (header.find("'fortran_order': True") != std::string::npos) return info;

  // shape tuple -> element count
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return info;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  long count = 1;
  long cur = -1;
  for (char c : shape + ",") {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (c == ',') {
      if (cur >= 0) count *= cur;
      cur = -1;
    }
  }
  info.count = count;
  info.ok = true;
  return info;
}

bool load_one(const char* path, float* out, long floats_per_file) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info = parse_header(f);
  if (!info.ok || info.count != floats_per_file) {
    fclose(f);
    return false;
  }
  bool ok;
  if (info.is_f8) {
    std::vector<double> buf(info.count);
    ok = fread(buf.data(), 8, info.count, f) == static_cast<size_t>(info.count);
    if (ok)
      for (long i = 0; i < info.count; ++i) out[i] = static_cast<float>(buf[i]);
  } else {
    ok = fread(out, 4, info.count, f) == static_cast<size_t>(info.count);
  }
  fclose(f);
  return ok;
}

}  // namespace

extern "C" int load_npy_batch(const char** paths, int n_files, float* out,
                              long floats_per_file, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> first_error(0);  // 0 = none; else 1 + file index

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files || first_error.load() != 0) return;
      if (!load_one(paths[i], out + static_cast<long>(i) * floats_per_file,
                    floats_per_file)) {
        int expected = 0;
        first_error.compare_exchange_strong(expected, 1 + i);
        return;
      }
    }
  };

  std::vector<std::thread> threads;
  int nt = n_threads < n_files ? n_threads : n_files;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return first_error.load();
}
