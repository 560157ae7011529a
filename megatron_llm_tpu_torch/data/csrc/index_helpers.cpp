/* Native index-building helpers for the data pipeline.
 *
 * Counterpart of the reference's pybind11 extension
 * (megatron/data/helpers.cpp:696-701: build_sample_idx,
 * build_blending_indices, build_mapping, build_blocks_mapping).  Exposed as
 * a plain C ABI consumed via ctypes (this image has no pybind11); callers
 * allocate the output arrays, so no ownership crosses the boundary.
 *
 * Built by utils/native.py:
 *   g++ -O3 -shared -fPIC -std=c++17 -o build/native/index_helpers-<hash>.so
 */

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

/* Number of (doc, offset) rows build_sample_idx will write: num_samples+1. */
int64_t sample_idx_rows(int32_t seq_length, int32_t num_epochs,
                        int64_t tokens_per_epoch) {
  return (num_epochs * tokens_per_epoch - 1) / seq_length + 1;
}

/* GPT sample index: rows of (index into doc_idx, token offset in that doc)
 * such that row i .. row i+1 spans seq_length+1 tokens; samples may span
 * document boundaries (behavioral spec: megatron/data/helpers.cpp:84-171,
 * consumed by gpt_dataset.py:235-268). */
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int32_t seq_length, int32_t num_epochs,
                      int64_t tokens_per_epoch, int32_t* out) {
  const int64_t num_samples = (num_epochs * tokens_per_epoch - 1) / seq_length;
  int64_t sample_index = 0;
  int64_t doc_idx_index = 0;
  int32_t doc_offset = 0;

  out[0] = static_cast<int32_t>(doc_idx_index);
  out[1] = doc_offset;
  ++sample_index;

  while (sample_index <= num_samples) {
    int32_t remaining = seq_length + 1;
    while (remaining != 0) {
      const int32_t doc_id = doc_idx[doc_idx_index];
      const int32_t doc_length = sizes[doc_id] - doc_offset;
      remaining -= doc_length;
      if (remaining <= 0) {
        /* Sample ends inside this document; next sample re-reads the
         * boundary token (the -1), sharing it as label/input. */
        doc_offset += remaining + doc_length - 1;
        remaining = 0;
      } else {
        ++doc_idx_index;
        doc_offset = 0;
      }
    }
    out[2 * sample_index] = static_cast<int32_t>(doc_idx_index);
    out[2 * sample_index + 1] = doc_offset;
    ++sample_index;
  }
}

/* Multi-corpus weighted interleave by greatest-sampling-error
 * (behavioral spec: megatron/data/helpers.cpp:20-81, consumed by
 * blendable_dataset.py:38-41). */
void build_blending_indices(uint8_t* dataset_index,
                            int64_t* dataset_sample_index,
                            const double* weights, int32_t num_datasets,
                            int64_t size) {
  int64_t* current = new int64_t[num_datasets];
  for (int32_t i = 0; i < num_datasets; ++i) current[i] = 0;

  for (int64_t s = 0; s < size; ++s) {
    const double s_d = std::max(static_cast<double>(s), 1.0);
    int32_t best = 0;
    double max_error = weights[0] * s_d - static_cast<double>(current[0]);
    for (int32_t d = 1; d < num_datasets; ++d) {
      const double err = weights[d] * s_d - static_cast<double>(current[d]);
      if (err > max_error) {
        max_error = err;
        best = d;
      }
    }
    dataset_index[s] = static_cast<uint8_t>(best);
    dataset_sample_index[s] = current[best];
    current[best] += 1;
  }
  delete[] current;
}

/* Epoch-blocked shuffle: permute [0, n_first) and [n_first, n_total)
 * independently with a deterministic PRNG.  Covers the reference's
 * separate-last-epoch shuffle construction (gpt_dataset.py _build_shuffle_idx)
 * in native code; python passes n_first == n_total for the simple case. */
void build_shuffle_idx(uint32_t seed, int64_t n_first, int64_t n_total,
                       int32_t* out) {
  for (int64_t i = 0; i < n_total; ++i) out[i] = static_cast<int32_t>(i);
  std::mt19937 gen(seed);
  std::shuffle(out, out + n_first, gen);
  if (n_total > n_first) std::shuffle(out + n_first, out + n_total, gen);
}

/* BERT sentence-pair sample mapping (behavioral spec:
 * megatron/data/helpers.cpp build_mapping, consumed by bert_dataset.py):
 * greedily pack consecutive sentences of each document into samples of a
 * (randomly shortened) target length, emitting rows of
 * (first_sentence, one_past_last_sentence, target_len); samples need at
 * least two sentences so an A/B split exists.  Rows are shuffled in place.
 *
 * `sent_sizes`: tokens per sentence; `doc_sent_idx`: per-document sentence
 * ranges (len num_docs+1).  `out` must hold max_rows*3 int32 where
 * max_rows = num_epochs * total_sentences.  Returns the row count. */
int64_t build_bert_mapping(const int32_t* sent_sizes,
                           const int64_t* doc_sent_idx, int64_t num_docs,
                           int32_t max_num_tokens, double short_seq_prob,
                           int32_t num_epochs, uint32_t seed, int32_t* out) {
  std::mt19937 gen(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  auto target_len = [&]() -> int32_t {
    if (unif(gen) < short_seq_prob) {
      std::uniform_int_distribution<int32_t> d(2, max_num_tokens);
      return d(gen);
    }
    return max_num_tokens;
  };

  int64_t rows = 0;
  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    for (int64_t doc = 0; doc < num_docs; ++doc) {
      const int64_t first = doc_sent_idx[doc];
      const int64_t last = doc_sent_idx[doc + 1];
      if (last - first < 2) continue; /* need two sentences for A/B */
      int32_t target = target_len();
      int64_t start = first;
      int32_t len = 0;
      int64_t num_sent = 0;
      for (int64_t s = first; s < last; ++s) {
        len += sent_sizes[s];
        ++num_sent;
        const bool is_last = (s == last - 1);
        if (num_sent >= 2 && (len >= target || is_last)) {
          out[rows * 3] = static_cast<int32_t>(start);
          out[rows * 3 + 1] = static_cast<int32_t>(s + 1);
          out[rows * 3 + 2] = target;
          ++rows;
          start = s + 1;
          len = 0;
          num_sent = 0;
          target = target_len();
        }
      }
    }
  }

  /* Fisher-Yates shuffle of the rows (64-bit indices like the reference). */
  std::mt19937_64 gen64(seed + 1);
  for (int64_t i = rows - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(gen64() % (i + 1));
    for (int k = 0; k < 3; ++k) std::swap(out[3 * i + k], out[3 * j + k]);
  }
  return rows;
}

/* ICT/REALM block mapping (behavioral spec: megatron/data/helpers.cpp
 * build_blocks_mapping_impl, :454-694): greedily pack each document's
 * sentences into blocks of target length (max_seq_length - title_size),
 * emitting rows of (first_sentence, one_past_last, doc, block_id).
 * Documents containing any sentence longer than long_sentence_len are
 * skipped entirely; blocks need >= min_num_sent sentences (2, or 1 with
 * use_one_sent_blocks).  Rows are Fisher-Yates-shuffled with
 * mt19937_64(seed+1), matching the reference stream.
 *
 * Two-pass C ABI: pass out == NULL to count rows, then call again with the
 * allocated buffer (rows*4 int32).  Returns the row count. */
int64_t build_blocks_mapping(const int64_t* doc_sent_idx, int64_t num_docs,
                             const int32_t* sent_sizes,
                             const int32_t* title_sizes, int32_t num_epochs,
                             int64_t max_num_samples,
                             int32_t max_seq_length,
                             int32_t long_sentence_len,
                             int32_t use_one_sent_blocks, uint32_t seed,
                             int32_t* out) {
  const int32_t min_num_sent = use_one_sent_blocks ? 1 : 2;
  const bool second = (out != NULL);
  int64_t map_index = 0;

  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    int32_t block_id = 0;
    if (map_index >= max_num_samples) break;
    for (int64_t doc = 0; doc < num_docs; ++doc) {
      const int64_t sent_first = doc_sent_idx[doc];
      const int64_t sent_last = doc_sent_idx[doc + 1];
      const int32_t target_seq_len =
          max_seq_length - title_sizes[doc];
      int64_t prev_start_index = sent_first;
      int64_t num_remain_sent = sent_last - sent_first;

      bool contains_long_sentence = false;
      if (num_remain_sent >= min_num_sent) {
        for (int64_t s = sent_first; s < sent_last; ++s) {
          if (sent_sizes[s] > long_sentence_len) {
            contains_long_sentence = true;
            break;
          }
        }
      }
      if (num_remain_sent < min_num_sent || contains_long_sentence) continue;

      int32_t seq_len = 0;
      int32_t num_sent = 0;
      for (int64_t s = sent_first; s < sent_last; ++s) {
        seq_len += sent_sizes[s];
        ++num_sent;
        --num_remain_sent;
        if (((seq_len >= target_seq_len) &&
             (num_remain_sent >= min_num_sent) &&
             (num_sent >= min_num_sent)) ||
            (num_remain_sent == 0)) {
          if (second) {
            const int64_t o = 4 * map_index;
            out[o] = static_cast<int32_t>(prev_start_index);
            out[o + 1] = static_cast<int32_t>(s + 1);
            out[o + 2] = static_cast<int32_t>(doc);
            out[o + 3] = block_id;
          }
          ++map_index;
          ++block_id;
          prev_start_index = s + 1;
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }

  if (second) {
    std::mt19937_64 gen64(seed + 1);
    for (int64_t i = map_index - 1; i > 0; --i) {
      const int64_t j = static_cast<int64_t>(gen64() % (i + 1));
      for (int k = 0; k < 4; ++k) std::swap(out[4 * i + k], out[4 * j + k]);
    }
  }
  return map_index;
}

}  /* extern "C" */
