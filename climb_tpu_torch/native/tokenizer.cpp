// Native WordPiece tokenizer (host-side fast path; the PyTorch port's copy of
// the JAX package's native/tokenizer.cpp).
//
// The counterpart of the Rust `tokenizers` WordPiece the reference
// uses through BertTokenizerFast (src/modeling/vilt.py:49). Implements the
// BERT basic tokenizer (lowercase, whitespace/punct split) + greedy
// longest-match WordPiece for ASCII text; texts containing non-ASCII bytes
// return a sentinel so the caller falls back to the Python implementation
// (which carries full unicode handling) — all CLiMB task text is English,
// so the fast path covers essentially every call.
//
// Build: climb_tpu_torch/native/build.py (g++ -O3 -march=native).
// ABI: plain C, consumed via ctypes (climb_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t cls_id = -1, sep_id = -1, pad_id = -1, unk_id = -1, mask_id = -1;
  int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
         (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Basic tokenization of ASCII text: lowercase, split on space & punctuation.
// Returns false if a non-ASCII byte is found (caller falls back to Python).
bool basic_tokenize(const char* text, std::vector<std::string>& out) {
  std::string cur;
  for (const char* p = text; *p; ++p) {
    unsigned char c = (unsigned char)*p;
    if (c >= 0x80) return false;  // non-ASCII: python fallback
    if (c == 0) break;
    if (is_space(c)) {
      if (!cur.empty()) { out.push_back(cur); cur.clear(); }
    } else if (is_ascii_punct(c)) {
      if (!cur.empty()) { out.push_back(cur); cur.clear(); }
      out.push_back(std::string(1, (char)c));
    } else {
      if (c < 32 || c == 127) continue;  // control chars
      if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
      cur.push_back((char)c);
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return true;
}

// Greedy longest-match WordPiece for one word.
void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int32_t>& out) {
  if ((int)word.size() > tok.max_chars_per_word) {
    out.push_back(tok.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string piece = word.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      auto it = tok.vocab.find(piece);
      if (it != tok.vocab.end()) { cur = it->second; break; }
      --end;
    }
    if (cur < 0) { out.push_back(tok.unk_id); return; }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

// Tokenize with embedded bracketed specials ([SEP] etc) honored.
bool tokenize_to_ids(const Tokenizer& tok, const char* text,
                     std::vector<int32_t>& out) {
  static const char* specials[] = {"[CLS]", "[SEP]", "[PAD]", "[UNK]", "[MASK]"};
  std::string s(text);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t best = std::string::npos;
    int best_i = -1;
    for (int i = 0; i < 5; ++i) {
      size_t f = s.find(specials[i], pos);
      if (f != std::string::npos && (best == std::string::npos || f < best)) {
        best = f;
        best_i = i;
      }
    }
    size_t seg_end = best == std::string::npos ? s.size() : best;
    if (seg_end > pos) {
      std::vector<std::string> words;
      if (!basic_tokenize(s.substr(pos, seg_end - pos).c_str(), words)) return false;
      for (auto& w : words) wordpiece(tok, w, out);
    }
    if (best == std::string::npos) break;
    auto it = tok.vocab.find(specials[best_i]);
    out.push_back(it != tok.vocab.end() ? it->second : tok.unk_id);
    pos = best + std::strlen(specials[best_i]);
  }
  return true;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
  auto* tok = new Tokenizer();
  std::ifstream f(vocab_path);
  if (!f.good()) { delete tok; return nullptr; }
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    tok->vocab[line] = idx++;  // a repeated entry takes its last line, as in HF's vocab
  }
  auto get = [&](const char* k) {
    auto it = tok->vocab.find(k);
    return it == tok->vocab.end() ? -1 : it->second;
  };
  tok->cls_id = get("[CLS]");
  tok->sep_id = get("[SEP]");
  tok->pad_id = get("[PAD]");
  tok->unk_id = get("[UNK]");
  tok->mask_id = get("[MASK]");
  if (tok->cls_id < 0 || tok->sep_id < 0 || tok->pad_id < 0 || tok->unk_id < 0) {
    delete tok;
    return nullptr;
  }
  return tok;
}

void wp_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int32_t wp_pad_id(void* h) { return static_cast<Tokenizer*>(h)->pad_id; }
int32_t wp_sep_id(void* h) { return static_cast<Tokenizer*>(h)->sep_id; }
int32_t wp_cls_id(void* h) { return static_cast<Tokenizer*>(h)->cls_id; }

// Encode text (+ optional pair) into fixed-length buffers.
// Returns 0 on success, -1 if non-ASCII fallback is required.
int wp_encode(void* h, const char* text, const char* text_pair, int max_len,
              int32_t* out_ids, float* out_mask, int32_t* out_types) {
  auto* tok = static_cast<Tokenizer*>(h);
  std::vector<int32_t> a, b;
  if (!tokenize_to_ids(*tok, text, a)) return -1;
  bool has_pair = text_pair != nullptr && text_pair[0] != '\0';
  if (has_pair && !tokenize_to_ids(*tok, text_pair, b)) return -1;

  std::vector<int32_t> ids;
  std::vector<int32_t> types;
  if (has_pair) {
    // HF 'longest_first' pair truncation (analytic form, verified against
    // BertTokenizerFast): the initially-longer sequence keeps
    // max(ceil(budget/2), budget - other); ties favor the pair.
    int budget = max_len - 3;
    int na = (int)a.size(), nb = (int)b.size();
    if (na + nb > budget) {
      int half_c = budget - budget / 2;
      int ka, kb;
      if (na > nb) {
        ka = std::max(half_c, budget - nb);
        kb = budget - ka;
      } else {
        kb = std::max(half_c, budget - na);
        ka = budget - kb;
      }
      a.resize(ka);
      b.resize(kb);
    }
    ids.push_back(tok->cls_id);
    ids.insert(ids.end(), a.begin(), a.end());
    ids.push_back(tok->sep_id);
    types.assign(ids.size(), 0);
    ids.insert(ids.end(), b.begin(), b.end());
    ids.push_back(tok->sep_id);
    types.resize(ids.size(), 1);
  } else {
    if ((int)a.size() > max_len - 2) a.resize(max_len - 2);
    ids.push_back(tok->cls_id);
    ids.insert(ids.end(), a.begin(), a.end());
    ids.push_back(tok->sep_id);
    types.assign(ids.size(), 0);
  }
  int n = (int)ids.size();
  for (int i = 0; i < max_len; ++i) {
    out_ids[i] = i < n ? ids[i] : tok->pad_id;
    out_mask[i] = i < n ? 1.0f : 0.0f;
    out_types[i] = i < n ? types[i] : 0;
  }
  return 0;
}

}  // extern "C"
