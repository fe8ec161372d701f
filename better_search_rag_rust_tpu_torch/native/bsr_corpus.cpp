// Native corpus loader: multithreaded recursive walk + capped file reads.
//
// This is the C++ counterpart of the reference's Rust corpus layer
// (reference: src/source.rs:8-49 — walkdir-based discovery and 10 MB-capped
// reads). The Python walker (corpus/walker.py) defines the semantics; this
// library accelerates the ingest hot path (thousands of small file reads)
// with a thread pool, exposed over a plain C ABI consumed via ctypes.
//
// Contract mirrored from the reference:
//   * walk: recursive, filtered by extension set, results sorted (the Python
//     layer re-sorts defensively; sorting here keeps the ABI deterministic);
//   * read: files larger than max_bytes yield "missing" (rc=1), unreadable
//     files likewise (reference: src/source.rs:36-39 returns None).
//
// Build: see native/__init__.py (g++ -O2 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace fs = std::filesystem;

extern "C" {

// Free any buffer returned by this library.
void bsr_free(void* p) { std::free(p); }

// Recursively collect files under `root` whose lowercase extension is in the
// comma-separated `exts_csv` (entries with or without a leading dot).
// Returns a malloc'd newline-separated, sorted path list (caller frees with
// bsr_free), or nullptr when root is missing. Empty ext list matches nothing.
char* bsr_walk(const char* root, const char* exts_csv) {
  std::vector<std::string> exts;
  {
    std::string csv(exts_csv ? exts_csv : "");
    size_t start = 0;
    while (start <= csv.size()) {
      size_t comma = csv.find(',', start);
      std::string e = csv.substr(
          start, comma == std::string::npos ? std::string::npos : comma - start);
      if (!e.empty()) {
        for (auto& c : e) c = (char)tolower((unsigned char)c);
        if (e[0] != '.') e = "." + e;
        exts.push_back(e);
      }
      if (comma == std::string::npos) break;
      start = comma + 1;
    }
  }
  std::error_code ec;
  if (!root || exts.empty() || !fs::exists(root, ec) || ec) {
    char* out = (char*)std::malloc(1);
    if (out) out[0] = '\0';
    return out;
  }
  std::vector<std::string> found;
  for (auto it = fs::recursive_directory_iterator(
           root, fs::directory_options::skip_permission_denied, ec);
       it != fs::recursive_directory_iterator(); it.increment(ec)) {
    if (ec) break;
    if (!it->is_regular_file(ec) || ec) continue;
    std::string ext = it->path().extension().string();
    for (auto& c : ext) c = (char)tolower((unsigned char)c);
    for (const auto& want : exts) {
      if (ext == want) {
        found.push_back(it->path().string());
        break;
      }
    }
  }
  std::sort(found.begin(), found.end());
  size_t total = 1;
  for (const auto& p : found) total += p.size() + 1;
  char* out = (char*)std::malloc(total);
  if (!out) return nullptr;
  char* w = out;
  for (const auto& p : found) {
    std::memcpy(w, p.data(), p.size());
    w += p.size();
    *w++ = '\n';
  }
  *w = '\0';
  return out;
}

// Read `n` files in parallel. For file i: on success outs[i] is a malloc'd
// buffer of lens[i] bytes (caller frees each with bsr_free) and rcs[i] = 0;
// missing/oversized/unreadable files get outs[i] = nullptr, rcs[i] = 1
// (reference: src/source.rs:23-49 -> Option::None).
void bsr_read_files(const char* const* paths, int32_t n, int64_t max_bytes,
                    char** outs, int64_t* lens, int32_t* rcs,
                    int32_t nthreads) {
  if (n <= 0) return;
  if (nthreads <= 0)
    nthreads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  nthreads = std::min(nthreads, n);
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      outs[i] = nullptr;
      lens[i] = 0;
      rcs[i] = 1;
      std::error_code ec;
      auto size = fs::file_size(paths[i], ec);
      if (ec || (int64_t)size > max_bytes) continue;
      std::ifstream f(paths[i], std::ios::binary);
      if (!f) continue;
      char* buf = (char*)std::malloc(size ? size : 1);
      if (!buf) continue;
      f.read(buf, (std::streamsize)size);
      if (!f && size != 0) {
        std::free(buf);
        continue;
      }
      outs[i] = buf;
      lens[i] = (int64_t)size;
      rcs[i] = 0;
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
