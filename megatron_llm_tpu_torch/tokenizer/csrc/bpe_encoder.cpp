// Native byte-level BPE merge engine (the hot loop of GPT-2 tokenization).
//
// The Python layer keeps the \p{L}/\p{N} pretokenizer (Unicode classes) and
// the byte->unicode mapping; this library runs the merge loop over batches
// of pretokens — the O(n * merges) part that dominates corpus
// preprocessing.  Counterpart of the reference's native-runtime stance
// (megatron/data/helpers.cpp is its data-side C++); built/loaded exactly
// like data/csrc/index_helpers.cpp (g++ -shared + ctypes, through
// utils/native.py; the pure Python loop runs only when asked for).
//
// C ABI:
//   bpe_new()                          -> handle
//   bpe_add_token(h, utf8, len, id)    vocab entry
//   bpe_add_merge(h, l, ll, r, rl)     merge pair, rank = insertion order
//   bpe_encode_batch(h, buf, offs, n, out_ids, out_offs, cap) -> total ids
//     buf: concatenated UTF-8 pretokens; offs[n+1] byte offsets.
//     out_offs[n+1] filled with id offsets.  Returns -1 on overflow or
//     unknown symbol (caller falls back to Python for that batch).
//   bpe_free(h)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Engine {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::string, int32_t> ranks;  // "left\x01right"
};

inline std::string pair_key(const std::string &a, const std::string &b) {
  std::string k;
  k.reserve(a.size() + b.size() + 1);
  k += a;
  k += '\x01';
  k += b;
  return k;
}

// Split a UTF-8 string into code points (as byte strings).  The byte->
// unicode mapping guarantees valid UTF-8 of 1-2 bytes per symbol, but this
// handles the general case.
inline void utf8_symbols(const char *s, int64_t len,
                         std::vector<std::string> *out) {
  int64_t i = 0;
  while (i < len) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    int n = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    if (i + n > len) n = 1;  // malformed tail: take the byte
    out->emplace_back(s + i, n);
    i += n;
  }
}

// The classic merge loop: repeatedly merge the lowest-rank adjacent pair.
inline bool bpe_token(const Engine &e, const char *s, int64_t len,
                      std::vector<int32_t> *out) {
  std::vector<std::string> parts;
  utf8_symbols(s, len, &parts);
  if (parts.empty()) return true;
  while (parts.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      auto it = e.ranks.find(pair_key(parts[i], parts[i + 1]));
      if (it != e.ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every occurrence of the best pair, left to right
    const std::string left = parts[best_i];
    const std::string right = parts[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(parts.size());
    for (size_t i = 0; i < parts.size();) {
      if (i + 1 < parts.size() && parts[i] == left &&
          parts[i + 1] == right) {
        merged.emplace_back(left + right);
        i += 2;
      } else {
        merged.emplace_back(parts[i]);
        i += 1;
      }
    }
    parts.swap(merged);
  }
  for (const auto &p : parts) {
    auto it = e.vocab.find(p);
    if (it == e.vocab.end()) return false;  // unknown symbol
    out->push_back(it->second);
  }
  return true;
}

}  // namespace

extern "C" {

void *bpe_new() { return new Engine(); }

void bpe_free(void *h) { delete static_cast<Engine *>(h); }

void bpe_add_token(void *h, const char *utf8, int64_t len, int32_t id) {
  static_cast<Engine *>(h)->vocab.emplace(std::string(utf8, len), id);
}

void bpe_add_merge(void *h, const char *l, int64_t ll, const char *r,
                   int64_t rl) {
  Engine *e = static_cast<Engine *>(h);
  int32_t rank = static_cast<int32_t>(e->ranks.size());
  e->ranks.emplace(pair_key(std::string(l, ll), std::string(r, rl)), rank);
}

int64_t bpe_encode_batch(void *h, const char *buf, const int64_t *offs,
                         int64_t n_tokens, int32_t *out_ids,
                         int64_t *out_offs, int64_t cap) {
  const Engine *e = static_cast<Engine *>(h);
  std::vector<int32_t> ids;
  int64_t total = 0;
  out_offs[0] = 0;
  for (int64_t t = 0; t < n_tokens; ++t) {
    ids.clear();
    if (!bpe_token(*e, buf + offs[t], offs[t + 1] - offs[t], &ids)) {
      return -1;
    }
    if (total + static_cast<int64_t>(ids.size()) > cap) return -1;
    std::memcpy(out_ids + total, ids.data(), ids.size() * sizeof(int32_t));
    total += static_cast<int64_t>(ids.size());
    out_offs[t + 1] = total;
  }
  return total;
}

}  // extern "C"
