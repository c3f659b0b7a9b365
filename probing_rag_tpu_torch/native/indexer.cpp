// Native BM25 index builder: tokenize -> stopword filter -> Porter stem ->
// term dictionary -> CSR postings, in one pass over the corpus buffer.
//
// The port's own copy of probing_rag_tpu/native/indexer.cpp (the C++ is the
// same; only this comment differs). It replaces the index-build hot loop the
// reference delegates to llama-index/rank_bm25 + nltk (Python;
// make_indexer.py:434-444): the per-document tokenize/hash/count work is
// the build-time bottleneck at Wikipedia scale, so it runs in C++ here.
// Scoring/impact math stays vectorized in numpy (retrieval/bm25_index.py);
// this library returns raw (term -> (doc, tf)) postings plus the vocab.
//
// Stemmer: the original Porter algorithm (Porter 1980). The Python analyzer
// mirrors it with stemmer_mode="original" (retrieval/porter.py) so the two
// builders produce identical indexes (see tests/test_torch_native.py).
//
// C ABI (ctypes): bm25_build() mallocs one BuildResult; bm25_free() releases.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------- porter stemmer
// Direct implementation of the original Porter algorithm.
struct Porter {
  std::string b;

  bool cons(int i) const {
    switch (b[i]) {
      case 'a': case 'e': case 'i': case 'o': case 'u': return false;
      case 'y': return (i == 0) ? true : !cons(i - 1);
      default: return true;
    }
  }
  // measure of the word prefix [0, j]
  int m(int j) const {
    int n = 0, i = 0;
    while (true) {
      if (i > j) return n;
      if (!cons(i)) break;
      i++;
    }
    i++;
    while (true) {
      while (true) {
        if (i > j) return n;
        if (cons(i)) break;
        i++;
      }
      i++;
      n++;
      while (true) {
        if (i > j) return n;
        if (!cons(i)) break;
        i++;
      }
      i++;
    }
  }
  bool vowelinstem(int j) const {
    for (int i = 0; i <= j; i++)
      if (!cons(i)) return true;
    return false;
  }
  bool doublec(int j) const {
    if (j < 1) return false;
    if (b[j] != b[j - 1]) return false;
    return cons(j);
  }
  bool cvc(int i) const {
    if (i < 2 || !cons(i) || cons(i - 1) || !cons(i - 2)) return false;
    char ch = b[i];
    return ch != 'w' && ch != 'x' && ch != 'y';
  }
  bool ends(const char* s, int& j) const {
    int len = (int)strlen(s);
    int k = (int)b.size() - 1;
    if (len > k + 1) return false;
    if (b.compare(k - len + 1, len, s) != 0) return false;
    j = k - len;
    return true;
  }
  void setto(const char* s, int j) {
    b.resize(j + 1);
    b += s;
  }
  void r(const char* s, int j) {
    if (m(j) > 0) setto(s, j);
  }

  void step1ab() {
    int j;
    if (b.back() == 's') {
      if (ends("sses", j)) b.resize(b.size() - 2);
      else if (ends("ies", j)) setto("i", j);
      else if (b.size() >= 2 && b[b.size() - 2] != 's') b.pop_back();
    }
    if (ends("eed", j)) {
      if (m(j) > 0) b.pop_back();
    } else if ((ends("ed", j) || ends("ing", j)) && vowelinstem(j)) {
      b.resize(j + 1);
      int k = (int)b.size() - 1;
      if (ends("at", j)) setto("ate", j);
      else if (ends("bl", j)) setto("ble", j);
      else if (ends("iz", j)) setto("ize", j);
      else if (doublec(k)) {
        char ch = b[k];
        if (ch != 'l' && ch != 's' && ch != 'z') b.pop_back();
      } else if (m(k) == 1 && cvc(k)) {
        setto("e", k);
      }
    }
  }
  void step1c() {
    int j;
    if (ends("y", j) && vowelinstem(j)) b.back() = 'i';
  }
  void step2() {
    int j;
    if (b.size() < 2) return;
    switch (b[b.size() - 2]) {
      case 'a':
        if (ends("ational", j)) { r("ate", j); break; }
        if (ends("tional", j)) { r("tion", j); break; }
        break;
      case 'c':
        if (ends("enci", j)) { r("ence", j); break; }
        if (ends("anci", j)) { r("ance", j); break; }
        break;
      case 'e':
        if (ends("izer", j)) { r("ize", j); break; }
        break;
      case 'l':
        if (ends("abli", j)) { r("able", j); break; }
        if (ends("alli", j)) { r("al", j); break; }
        if (ends("entli", j)) { r("ent", j); break; }
        if (ends("eli", j)) { r("e", j); break; }
        if (ends("ousli", j)) { r("ous", j); break; }
        break;
      case 'o':
        if (ends("ization", j)) { r("ize", j); break; }
        if (ends("ation", j)) { r("ate", j); break; }
        if (ends("ator", j)) { r("ate", j); break; }
        break;
      case 's':
        if (ends("alism", j)) { r("al", j); break; }
        if (ends("iveness", j)) { r("ive", j); break; }
        if (ends("fulness", j)) { r("ful", j); break; }
        if (ends("ousness", j)) { r("ous", j); break; }
        break;
      case 't':
        if (ends("aliti", j)) { r("al", j); break; }
        if (ends("iviti", j)) { r("ive", j); break; }
        if (ends("biliti", j)) { r("ble", j); break; }
        break;
    }
  }
  void step3() {
    int j;
    switch (b.back()) {
      case 'e':
        if (ends("icate", j)) { r("ic", j); break; }
        if (ends("ative", j)) { r("", j); break; }
        if (ends("alize", j)) { r("al", j); break; }
        break;
      case 'i':
        if (ends("iciti", j)) { r("ic", j); break; }
        break;
      case 'l':
        if (ends("ical", j)) { r("ic", j); break; }
        if (ends("ful", j)) { r("", j); break; }
        break;
      case 's':
        if (ends("ness", j)) { r("", j); break; }
        break;
    }
  }
  void step4() {
    int j;
    if (b.size() < 2) return;
    switch (b[b.size() - 2]) {
      case 'a': if (ends("al", j)) break; return;
      case 'c': if (ends("ance", j)) break; if (ends("ence", j)) break; return;
      case 'e': if (ends("er", j)) break; return;
      case 'i': if (ends("ic", j)) break; return;
      case 'l': if (ends("able", j)) break; if (ends("ible", j)) break; return;
      case 'n':
        if (ends("ant", j)) break;
        if (ends("ement", j)) break;
        if (ends("ment", j)) break;
        if (ends("ent", j)) break;
        return;
      case 'o':
        if (ends("ion", j) && j >= 0 && (b[j] == 's' || b[j] == 't')) break;
        if (ends("ou", j)) break;
        return;
      case 's': if (ends("ism", j)) break; return;
      case 't': if (ends("ate", j)) break; if (ends("iti", j)) break; return;
      case 'u': if (ends("ous", j)) break; return;
      case 'v': if (ends("ive", j)) break; return;
      case 'z': if (ends("ize", j)) break; return;
      default: return;
    }
    if (m(j) > 1) b.resize(j + 1);
  }
  void step5() {
    int k = (int)b.size() - 1;
    if (b[k] == 'e') {
      int a = m(k - 1 >= 0 ? k - 1 : 0);
      // original: m(j) where j = k-1 after removing 'e'
      int mm = m(k - 1);
      if (mm > 1 || (mm == 1 && !cvc(k - 1))) b.pop_back();
    }
    k = (int)b.size() - 1;
    if (b[k] == 'l' && doublec(k) && m(k - 1) > 1) b.pop_back();
  }

  std::string stem(const std::string& w) {
    if (w.size() <= 2) return w;  // Porter: words of length 1-2 untouched
    b = w;
    step1ab();
    if (!b.empty()) step1c();
    if (!b.empty()) step2();
    if (!b.empty()) step3();
    if (!b.empty()) step4();
    if (!b.empty()) step5();
    return b;
  }
};

const char* kStopwords[] = {
    "a","about","above","after","again","against","ain","all","am","an","and",
    "any","are","aren","aren't","as","at","be","because","been","before",
    "being","below","between","both","but","by","can","couldn","couldn't","d",
    "did","didn","didn't","do","does","doesn","doesn't","doing","don","don't",
    "down","during","each","few","for","from","further","had","hadn","hadn't",
    "has","hasn","hasn't","have","haven","haven't","having","he","her","here",
    "hers","herself","him","himself","his","how","i","if","in","into","is",
    "isn","isn't","it","it's","its","itself","just","ll","m","ma","me",
    "mightn","mightn't","more","most","mustn","mustn't","my","myself","needn",
    "needn't","no","nor","not","now","o","of","off","on","once","only","or",
    "other","our","ours","ourselves","out","over","own","re","s","same","shan",
    "shan't","she","she's","should","should've","shouldn","shouldn't","so",
    "some","such","t","than","that","that'll","the","their","theirs","them",
    "themselves","then","there","these","they","this","those","through","to",
    "too","under","until","up","ve","very","was","wasn","wasn't","we","were",
    "weren","weren't","what","when","where","which","while","who","whom","why",
    "will","with","won","won't","wouldn","wouldn't","y","you","you'd","you'll",
    "you're","you've","your","yours","yourself","yourselves"};

bool is_word_char(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

}  // namespace

extern "C" {

struct BuildResult {
  int64_t n_docs;
  int64_t n_terms;
  int64_t nnz;
  int64_t* term_offsets;   // [n_terms + 1]
  int32_t* postings_doc;   // [nnz], doc-sorted within each term
  float* postings_tf;      // [nnz]
  int32_t* doc_lens;       // [n_docs]
  char* vocab_blob;        // terms joined by '\n', term-id order
  int64_t vocab_blob_len;
};

BuildResult* bm25_build(const char* text, const int64_t* doc_offsets,
                        int64_t n_docs, int lowercase, int remove_stopwords,
                        int stem) {
  std::unordered_set<std::string> stopwords;
  if (remove_stopwords)
    for (const char* s : kStopwords) stopwords.insert(s);

  Porter porter;
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> terms;
  // per-term postings accumulated as parallel (term, doc, tf) triples; docs
  // arrive in order, so a stable counting sort by term yields doc-sorted CSR.
  std::vector<int32_t> tcol, dcol;
  std::vector<float> fcol;
  std::vector<int32_t> doc_lens(n_docs, 0);

  std::unordered_map<int32_t, int32_t> counts;
  std::string tok;
  for (int64_t d = 0; d < n_docs; d++) {
    counts.clear();
    int32_t dl = 0;
    const char* p = text + doc_offsets[d];
    const char* end = text + doc_offsets[d + 1];
    while (p < end) {
      while (p < end && !is_word_char((unsigned char)*p)) p++;
      const char* start = p;
      while (p < end && is_word_char((unsigned char)*p)) p++;
      if (p == start) continue;
      tok.assign(start, p - start);
      if (lowercase)
        for (auto& c : tok)
          if (c >= 'A' && c <= 'Z') c += 32;
      if (remove_stopwords && stopwords.count(tok)) continue;
      if (stem) tok = porter.stem(tok);
      dl++;
      auto it = vocab.find(tok);
      int32_t tid;
      if (it == vocab.end()) {
        tid = (int32_t)terms.size();
        vocab.emplace(tok, tid);
        terms.push_back(tok);
      } else {
        tid = it->second;
      }
      counts[tid]++;
    }
    doc_lens[d] = dl;
    for (auto& kv : counts) {
      tcol.push_back(kv.first);
      dcol.push_back((int32_t)d);
      fcol.push_back((float)kv.second);
    }
  }

  int64_t n_terms = (int64_t)terms.size();
  int64_t nnz = (int64_t)tcol.size();

  // counting sort by term id (stable -> docs stay ascending per term)
  std::vector<int64_t> offsets(n_terms + 1, 0);
  for (int64_t i = 0; i < nnz; i++) offsets[tcol[i] + 1]++;
  for (int64_t t = 0; t < n_terms; t++) offsets[t + 1] += offsets[t];

  auto* out = (BuildResult*)malloc(sizeof(BuildResult));
  out->n_docs = n_docs;
  out->n_terms = n_terms;
  out->nnz = nnz;
  out->term_offsets = (int64_t*)malloc((n_terms + 1) * sizeof(int64_t));
  out->postings_doc = (int32_t*)malloc(nnz * sizeof(int32_t));
  out->postings_tf = (float*)malloc(nnz * sizeof(float));
  out->doc_lens = (int32_t*)malloc(n_docs * sizeof(int32_t));
  memcpy(out->term_offsets, offsets.data(), (n_terms + 1) * sizeof(int64_t));
  memcpy(out->doc_lens, doc_lens.data(), n_docs * sizeof(int32_t));

  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t i = 0; i < nnz; i++) {
    int64_t pos = cursor[tcol[i]]++;
    out->postings_doc[pos] = dcol[i];
    out->postings_tf[pos] = fcol[i];
  }

  int64_t blob_len = 0;
  for (auto& t : terms) blob_len += (int64_t)t.size() + 1;
  out->vocab_blob = (char*)malloc(blob_len > 0 ? blob_len : 1);
  out->vocab_blob_len = blob_len;
  char* w = out->vocab_blob;
  for (auto& t : terms) {
    memcpy(w, t.data(), t.size());
    w += t.size();
    *w++ = '\n';
  }
  return out;
}

void bm25_free(BuildResult* r) {
  if (!r) return;
  free(r->term_offsets);
  free(r->postings_doc);
  free(r->postings_tf);
  free(r->doc_lens);
  free(r->vocab_blob);
  free(r);
}

// standalone stemmer entry for parity tests: writes stemmed token (<=255
// chars) into out, returns its length.
int porter_stem(const char* word, int len, char* out) {
  Porter p;
  std::string s = p.stem(std::string(word, len));
  int n = (int)s.size() < 255 ? (int)s.size() : 255;
  memcpy(out, s.data(), n);
  return n;
}

// ------------------------------------------------------ batch query encoder
// Host-side serving hot path: query text -> analyzed term ids against a
// fixed index vocabulary. At the >=10k q/s device throughput the engines
// sustain, per-query Python tokenize/stem becomes the host bottleneck;
// this runs the same analyzer chain as bm25_build over a whole query batch.

struct QueryEncoder {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_set<std::string> stopwords;
  int lowercase;
  int remove_stopwords;
  int stem;
};

// vocab_blob: terms joined by '\n' in term-id order (BuildResult layout).
QueryEncoder* encoder_create(const char* vocab_blob, int64_t blob_len,
                             int lowercase, int remove_stopwords, int stem) {
  auto* enc = new QueryEncoder();
  enc->lowercase = lowercase;
  enc->remove_stopwords = remove_stopwords;
  enc->stem = stem;
  if (remove_stopwords)
    for (const char* s : kStopwords) enc->stopwords.insert(s);
  int32_t tid = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    enc->vocab.emplace(std::string(p, nl - p), tid++);
    p = nl + 1;
  }
  return enc;
}

void encoder_free(QueryEncoder* enc) { delete enc; }

// Encodes n queries (concatenated text + offsets like bm25_build). Writes
// term ids (OOV dropped, duplicates kept — rank_bm25 scores each
// occurrence) into out_ids and per-query CSR bounds into out_offs
// [n + 1]. Returns total ids written, or -1 if out_cap is too small.
int64_t encode_queries(QueryEncoder* enc, const char* text,
                       const int64_t* doc_offsets, int64_t n,
                       int32_t* out_ids, int64_t* out_offs, int64_t out_cap) {
  Porter porter;
  std::string tok;
  int64_t w = 0;
  out_offs[0] = 0;
  for (int64_t d = 0; d < n; d++) {
    const char* p = text + doc_offsets[d];
    const char* end = text + doc_offsets[d + 1];
    while (p < end) {
      while (p < end && !is_word_char((unsigned char)*p)) p++;
      const char* start = p;
      while (p < end && is_word_char((unsigned char)*p)) p++;
      if (p == start) continue;
      tok.assign(start, p - start);
      if (enc->lowercase)
        for (auto& c : tok)
          if (c >= 'A' && c <= 'Z') c += 32;
      if (enc->remove_stopwords && enc->stopwords.count(tok)) continue;
      if (enc->stem) tok = porter.stem(tok);
      auto it = enc->vocab.find(tok);
      if (it == enc->vocab.end()) continue;  // OOV dropped
      if (w >= out_cap) return -1;
      out_ids[w++] = it->second;
    }
    out_offs[d + 1] = w;
  }
  return w;
}

}  // extern "C"
