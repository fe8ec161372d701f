// Native hermetic hashing tokenizer — bitwise-compatible with
// models/tokenizer.py HashingTokenizer for ASCII inputs.
//
// Python semantics replicated exactly:
//   * text.lower()                      -> ASCII a-z lowering (the Python
//     caller routes any text containing non-ASCII bytes to the pure-Python
//     path, so Unicode lowering never diverges)
//   * re.findall(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")  -> greedy word runs of
//     [a-z0-9_] plus single non-space/non-word chars; the ASCII subset of
//     Python's Unicode \s is {9,10,11,12,13,28,29,30,31,32}
//   * id = 10 + LE64(blake2b(token, digest_size=8)) % (vocab - 10)
//     -- the 8-byte little-endian digest IS state word h[0], so the id is
//     10 + h[0] % span (RFC 7693; verified against hashlib in the tests)
//   * row = [CLS=1, ids[:max_tokens-2], SEP=2], PAD=0, mask over the run
//
// The hot loop runs without the GIL (ctypes releases it) on a thread pool,
// replacing ~45 ms/256-doc Python batches that shadowed the ingest
// pipeline's dispatch thread (scripts/proto_ingest2.py).
//
// Build: compiled into libbsr_native.so with bsr_corpus.cpp
// (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- blake2b

const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

inline void G(uint64_t v[16], int a, int b, int c, int d, uint64_t x,
              uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
              bool last) {
  uint64_t v[16], m[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = IV[i];
  v[12] ^= t;  // low counter word; tokens never exceed 2^64 bytes
  if (last) v[14] = ~v[14];
  std::memcpy(m, block, 128);  // little-endian hosts only (x86/arm64)
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = SIGMA[r];
    G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// blake2b(data, digest_size=8), no key: the 8-byte LE digest == h[0].
uint64_t blake2b8(const uint8_t* data, size_t len) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = IV[i];
  h[0] ^= 0x01010008ULL;  // digest_length=8, fanout=1, depth=1
  uint8_t block[128];
  size_t off = 0;
  // All full blocks except the last (the final block, full or partial,
  // always goes through the last=true compress).
  while (len - off > 128) {
    std::memcpy(block, data + off, 128);
    off += 128;
    compress(h, block, (uint64_t)off, false);
  }
  size_t rem = len - off;
  std::memset(block, 0, 128);
  if (rem) std::memcpy(block, data + off, rem);
  compress(h, block, (uint64_t)len, true);
  return h[0];
}

// ------------------------------------------------------------ tokenizer

// ASCII subset of Python's Unicode \s.
inline bool is_space(uint8_t c) {
  return (c >= 9 && c <= 13) || (c >= 28 && c <= 32);
}
inline bool is_word(uint8_t c) {  // after lowering
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

constexpr int32_t PAD_ID = 0, CLS_ID = 1, SEP_ID = 2, NUM_SPECIAL = 10;

// token -> id memo, mirroring the Python path's MAX_CACHE-bounded memo
// (models/tokenizer.py): code/NL corpora repeat tokens heavily, and one
// blake2b compress (~12x8 G rounds) per OCCURRENCE dominated the loop —
// the memo takes it to once per DISTINCT token (chip-host measured 2.9k
// -> 9k+ files/s at B=256, scripts/proto_r5_tok.py). Caching cannot
// change any id: hits return exactly the digest the miss computed.
using TokenCache = std::unordered_map<std::string, int32_t>;
constexpr size_t MAX_CACHE = 1u << 20;

void tokenize_one(const char* text, int32_t max_tokens, int32_t vocab,
                  int32_t* ids, int32_t* mask, TokenCache* cache) {
  const uint64_t span = (uint64_t)(vocab - NUM_SPECIAL);
  const int32_t body = max_tokens - 2;
  std::fill(ids, ids + max_tokens, PAD_ID);
  std::fill(mask, mask + max_tokens, 0);
  ids[0] = CLS_ID;
  int32_t n = 0;  // word tokens emitted
  std::string tok;
  const uint8_t* p = (const uint8_t*)text;
  while (*p && n < body) {
    uint8_t c = *p;
    if (c >= 'A' && c <= 'Z') c += 32;  // text.lower(), ASCII
    if (is_space(c)) {
      p++;
      continue;
    }
    tok.clear();
    if (is_word(c)) {
      while (*p) {
        uint8_t w = *p;
        if (w >= 'A' && w <= 'Z') w += 32;
        if (!is_word(w)) break;
        tok.push_back((char)w);
        p++;
      }
    } else {
      tok.push_back((char)c);
      p++;
    }
    int32_t id;
    auto it = cache->find(tok);
    if (it != cache->end()) {
      id = it->second;
    } else {
      uint64_t d = blake2b8((const uint8_t*)tok.data(), tok.size());
      id = (int32_t)(NUM_SPECIAL + (d % span));
      if (cache->size() >= MAX_CACHE) cache->clear();
      cache->emplace(tok, id);
    }
    ids[1 + n] = id;
    n++;
  }
  ids[1 + n] = SEP_ID;
  std::fill(mask, mask + n + 2, 1);
}

}  // namespace

extern "C" {

// texts: n NUL-terminated ASCII strings. out_ids/out_mask: [n, max_tokens]
// int32 row-major. Returns 0 on success.
int32_t bsr_tokenize(const char** texts, int32_t n, int32_t max_tokens,
                     int32_t vocab_size, int32_t* out_ids, int32_t* out_mask,
                     int32_t nthreads) {
  if (n < 0 || max_tokens < 2 || vocab_size <= NUM_SPECIAL) return 1;
  if (n == 0) return 0;
  if (nthreads <= 0)
    nthreads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  nthreads = std::min(nthreads, n);
  std::atomic<int32_t> next(0);
  auto work = [&]() {
    TokenCache cache;  // per-thread: no sharing, no locks, batch-scoped
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      tokenize_one(texts[i], max_tokens, vocab_size,
                   out_ids + (size_t)i * max_tokens,
                   out_mask + (size_t)i * max_tokens, &cache);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < nthreads; t++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
