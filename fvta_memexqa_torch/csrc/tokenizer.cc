// Native tokenizer for the packer hot loop.
//
// The reference's prepro hot spot is the pure-Python tokenize loop over ~20k QAs +
// 630 albums (SURVEY.md section 3.1). This implements the framework's canonical
// tokenizer spec (fvta_memexqa_tpu/data/tokenize.py) as a byte scanner over
// ASCII-lowercased text:
//   token := [a-z0-9]+ (with internal apostrophes: "don't" is one token)
//          | single non-space, non-alphanumeric char
// The Python wrapper only routes ASCII text here (non-ASCII falls back to the regex
// path so unicode semantics stay bit-identical); a fuzz parity test pins the two
// implementations together (tests/test_native_tokenizer.py).
//
// Batched C ABI to amortize FFI overhead: one call tokenizes many documents.
//
// Build: native/build.sh (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>

namespace {

inline bool is_alnum(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline bool is_space(unsigned char c) {
  // Python re \s over ASCII: \t\n\v\f\r, space, AND the separator control
  // chars 0x1c-0x1f (FS/GS/RS/US) — dropping the latter made the native
  // tokenizer emit extra single-char tokens the regex spec drops.
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

}  // namespace

extern "C" {

// Tokenize `num_docs` documents stored contiguously in `buf` (ASCII, already
// lowercased). doc_offsets has num_docs+1 entries delimiting each document.
//
// Outputs token (start, len) pairs into tok_starts/tok_lens (capacity max_tokens,
// global across all docs) and per-doc token counts into doc_num_tokens.
// Returns the total number of tokens written (saturating at max_tokens).
int64_t fvta_tokenize_batch(const char* buf, const int64_t* doc_offsets,
                            int64_t num_docs, int64_t* tok_starts,
                            int32_t* tok_lens, int32_t* doc_num_tokens,
                            int64_t max_tokens) {
  int64_t n_tok = 0;
  for (int64_t d = 0; d < num_docs; ++d) {
    int64_t i = doc_offsets[d];
    const int64_t end = doc_offsets[d + 1];
    int32_t count = 0;
    while (i < end && n_tok < max_tokens) {
      const unsigned char c = static_cast<unsigned char>(buf[i]);
      if (is_space(c)) {
        ++i;
        continue;
      }
      if (is_alnum(c)) {
        const int64_t start = i;
        while (i < end) {
          const unsigned char cc = static_cast<unsigned char>(buf[i]);
          if (is_alnum(cc)) {
            ++i;
          } else if (cc == '\'' && i + 1 < end &&
                     is_alnum(static_cast<unsigned char>(buf[i + 1]))) {
            // internal apostrophe followed by alphanumeric stays in-token
            i += 2;
            while (i < end && is_alnum(static_cast<unsigned char>(buf[i]))) ++i;
          } else {
            break;
          }
        }
        tok_starts[n_tok] = start;
        tok_lens[n_tok] = static_cast<int32_t>(i - start);
        ++n_tok;
        ++count;
      } else {
        // single non-space, non-alphanumeric character
        tok_starts[n_tok] = i;
        tok_lens[n_tok] = 1;
        ++n_tok;
        ++count;
        ++i;
      }
    }
    doc_num_tokens[d] = count;
  }
  return n_tok;
}

// ---------------------------------------------------------------------------
// Vocab-aware encoding: tokenize AND look up word/char ids in one pass, writing
// the packer's fixed-shape id tensors directly — no Python string ever
// materializes. This is where native wins: the FFI boundary carries only numpy
// buffers (see fvta_memexqa_tpu/data/_native_tokenizer.py NativeEncoder).
// ---------------------------------------------------------------------------

struct FvtaVocab {
  std::string blob;                                   // owns all word bytes
  std::unordered_map<std::string_view, int32_t> map;  // word -> id
};

// words_buf/word_offsets: num_words words concatenated; ids[i] is word i's id.
void* fvta_vocab_create(const char* words_buf, const int64_t* word_offsets,
                        const int32_t* ids, int64_t num_words) {
  auto* v = new FvtaVocab();
  v->blob.assign(words_buf, static_cast<size_t>(word_offsets[num_words]));
  v->map.reserve(static_cast<size_t>(num_words) * 2);
  for (int64_t i = 0; i < num_words; ++i) {
    std::string_view w(v->blob.data() + word_offsets[i],
                       static_cast<size_t>(word_offsets[i + 1] - word_offsets[i]));
    v->map.emplace(w, ids[i]);
  }
  return v;
}

void fvta_vocab_destroy(void* h) { delete static_cast<FvtaVocab*>(h); }

// Tokenize + encode num_docs documents (ASCII, lowercased) into fixed-shape id
// tensors:
//   out_word_ids [num_docs, max_len]            word id (unk_id if OOV)
//   out_char_ids [num_docs, max_len, max_word_len]  via char_table[256]
//   out_mask     [num_docs, max_len]            1 where a token exists
// Buffers must be zero-initialized by the caller (PAD stays 0).
void fvta_encode_batch(void* h, const char* buf, const int64_t* doc_offsets,
                       int64_t num_docs, int32_t max_len, int32_t max_word_len,
                       const int32_t* char_table, int32_t unk_id,
                       int32_t* out_word_ids, int32_t* out_char_ids,
                       uint8_t* out_mask) {
  const auto* vocab = static_cast<FvtaVocab*>(h);
  for (int64_t d = 0; d < num_docs; ++d) {
    int64_t i = doc_offsets[d];
    const int64_t end = doc_offsets[d + 1];
    int32_t t = 0;
    while (i < end && t < max_len) {
      const unsigned char c = static_cast<unsigned char>(buf[i]);
      if (is_space(c)) {
        ++i;
        continue;
      }
      int64_t start = i;
      if (is_alnum(c)) {
        while (i < end) {
          const unsigned char cc = static_cast<unsigned char>(buf[i]);
          if (is_alnum(cc)) {
            ++i;
          } else if (cc == '\'' && i + 1 < end &&
                     is_alnum(static_cast<unsigned char>(buf[i + 1]))) {
            i += 2;
            while (i < end && is_alnum(static_cast<unsigned char>(buf[i]))) ++i;
          } else {
            break;
          }
        }
      } else {
        ++i;
      }
      const std::string_view tok(buf + start, static_cast<size_t>(i - start));
      const auto it = vocab->map.find(tok);
      const int64_t base = (d * max_len + t);
      out_word_ids[base] = (it == vocab->map.end()) ? unk_id : it->second;
      out_mask[base] = 1;
      int32_t* chars = out_char_ids + base * max_word_len;
      const int32_t wl = static_cast<int32_t>(tok.size()) < max_word_len
                             ? static_cast<int32_t>(tok.size())
                             : max_word_len;
      for (int32_t k = 0; k < wl; ++k) {
        chars[k] = char_table[static_cast<unsigned char>(tok[k])];
      }
      ++t;
    }
  }
}

}  // extern "C"
