// shodh_native — C++ host-runtime kernels for the hot non-device paths.
//
// The reference implements its entire host runtime in Rust; this module is
// the equivalent native layer for this build's host-side hot loops:
//   - Porter stemming + tokenization (called per document AND per query)
//   - an inverted-index BM25 engine (upsert/delete/search) with IC term
//     weights — the lexical leg of hybrid recall (hybrid_search.rs analog)
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11 in the
// image). Strings cross the boundary as UTF-8; result buffers are
// caller-freed via shodh_free.
//
// Build: make -C native   (produces libshodh_native.so)

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <array>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// ---------------------------------------------------------------------------
// Porter stemmer (Porter 1980) — mirrors shodh_tpu/nlp/stemmer.py exactly so
// host and native tokenization agree byte-for-byte.
// ---------------------------------------------------------------------------

namespace porter {

static bool is_cons(const std::string& w, size_t i) {
    char c = w[i];
    if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
    if (c == 'y') return i == 0 ? true : !is_cons(w, i - 1);
    return true;
}

static int measure(const std::string& w) {
    int m = 0;
    bool prev_cons = true, started = false;
    for (size_t i = 0; i < w.size(); i++) {
        bool c = is_cons(w, i);
        if (!c) started = true;
        else if (started && !prev_cons) m++;
        prev_cons = c;
    }
    return m;
}

static bool has_vowel(const std::string& w) {
    for (size_t i = 0; i < w.size(); i++)
        if (!is_cons(w, i)) return true;
    return false;
}

static bool ends_double_cons(const std::string& w) {
    size_t n = w.size();
    return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

static bool cvc(const std::string& w) {
    size_t n = w.size();
    if (n < 3) return false;
    if (!(is_cons(w, n - 3) && !is_cons(w, n - 2) && is_cons(w, n - 1))) return false;
    char last = w[n - 1];
    return last != 'w' && last != 'x' && last != 'y';
}

static bool ends_with(const std::string& w, const char* suf) {
    size_t sl = strlen(suf);
    return w.size() >= sl && w.compare(w.size() - sl, sl, suf) == 0;
}

static std::string stem(std::string w) {
    if (w.size() <= 2) return w;

    // Step 1a
    if (ends_with(w, "sses")) w.resize(w.size() - 2);
    else if (ends_with(w, "ies")) w.resize(w.size() - 2);
    else if (ends_with(w, "ss")) {}
    else if (ends_with(w, "s")) w.resize(w.size() - 1);

    // Step 1b
    if (ends_with(w, "eed")) {
        if (measure(w.substr(0, w.size() - 3)) > 0) w.resize(w.size() - 1);
    } else {
        bool flag = false;
        if (ends_with(w, "ed") && has_vowel(w.substr(0, w.size() - 2))) {
            w.resize(w.size() - 2); flag = true;
        } else if (ends_with(w, "ing") && has_vowel(w.substr(0, w.size() - 3))) {
            w.resize(w.size() - 3); flag = true;
        }
        if (flag) {
            if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) w += 'e';
            else if (ends_double_cons(w) && !ends_with(w, "l") && !ends_with(w, "s") && !ends_with(w, "z"))
                w.resize(w.size() - 1);
            else if (measure(w) == 1 && cvc(w)) w += 'e';
        }
    }

    // Step 1c
    if (ends_with(w, "y") && has_vowel(w.substr(0, w.size() - 1))) w[w.size() - 1] = 'i';

    // Step 2
    static const std::pair<const char*, const char*> step2[] = {
        {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"}, {"anci", "ance"},
        {"izer", "ize"}, {"abli", "able"}, {"alli", "al"}, {"entli", "ent"},
        {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"}, {"ation", "ate"},
        {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"}, {"fulness", "ful"},
        {"ousness", "ous"}, {"aliti", "al"}, {"iviti", "ive"}, {"biliti", "ble"},
    };
    for (auto& [suf, rep] : step2) {
        if (ends_with(w, suf)) {
            std::string base = w.substr(0, w.size() - strlen(suf));
            if (measure(base) > 0) w = base + rep;
            break;
        }
    }

    // Step 3
    static const std::pair<const char*, const char*> step3[] = {
        {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
        {"ical", "ic"}, {"ful", ""}, {"ness", ""},
    };
    for (auto& [suf, rep] : step3) {
        if (ends_with(w, suf)) {
            std::string base = w.substr(0, w.size() - strlen(suf));
            if (measure(base) > 0) w = base + rep;
            break;
        }
    }

    // Step 4
    static const char* step4[] = {
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    };
    bool matched4 = false;
    for (const char* suf : step4) {
        if (ends_with(w, suf)) {
            std::string base = w.substr(0, w.size() - strlen(suf));
            if (measure(base) > 1) w = base;
            matched4 = true;
            break;
        }
    }
    if (!matched4 && ends_with(w, "ion") && w.size() > 3) {
        char before = w[w.size() - 4];
        if ((before == 's' || before == 't') && measure(w.substr(0, w.size() - 3)) > 1)
            w.resize(w.size() - 3);
    }

    // Step 5a
    if (ends_with(w, "e")) {
        std::string base = w.substr(0, w.size() - 1);
        int m = measure(base);
        if (m > 1 || (m == 1 && !cvc(base))) w = base;
    }
    // Step 5b
    if (measure(w) > 1 && ends_double_cons(w) && ends_with(w, "l")) w.resize(w.size() - 1);

    return w;
}

}  // namespace porter

// ---------------------------------------------------------------------------
// Tokenizer: lowercase word chars, stopword filter, Porter stem.
// Stopword list mirrors nlp/stopwords.py.
// ---------------------------------------------------------------------------

static const std::unordered_set<std::string>& stopwords() {
    static const std::unordered_set<std::string> s = {
        "a","about","above","after","again","against","all","am","an","and","any","are",
        "aren't","as","at","be","because","been","before","being","below","between","both",
        "but","by","can","cannot","can't","could","couldn't","did","didn't","do","does",
        "doesn't","doing","don't","down","during","each","few","for","from","further","had",
        "hadn't","has","hasn't","have","haven't","having","he","he'd","he'll","he's","her",
        "here","here's","hers","herself","him","himself","his","how","how's","i","i'd",
        "i'll","i'm","i've","if","in","into","is","isn't","it","it's","its","itself",
        "let's","me","more","most","mustn't","my","myself","no","nor","not","of","off",
        "on","once","only","or","other","ought","our","ours","ourselves","out","over","own",
        "same","shan't","she","she'd","she'll","she's","should","shouldn't","so","some",
        "such","than","that","that's","the","their","theirs","them","themselves","then",
        "there","there's","these","they","they'd","they'll","they're","they've","this",
        "those","through","to","too","under","until","up","very","was","wasn't","we","we'd",
        "we'll","we're","we've","were","weren't","what","what's","when","when's","where",
        "where's","which","while","who","who's","whom","why","why's","with","won't","would",
        "wouldn't","you","you'd","you'll","you're","you've","your","yours","yourself",
        "yourselves","will","just","also","got","get","one","two","via","etc",
    };
    return s;
}

// Irregular-lemma fold table, pushed once at library load from
// nlp/data/lemma_exceptions.tsv.gz (see nlp/lemmas.py — "went" -> "go";
// Porter only folds regular inflection). Load happens before any index
// exists and never again, so no locking is needed on the read path.
static std::unordered_map<std::string, std::string>& lemma_table() {
    static std::unordered_map<std::string, std::string> m;
    return m;
}

// Norm-fold tables, pushed once at library load from
// nlp/data/norm_folds.tsv.gz (see nlp/norms.py): spaCy StringStore hash
// (MurmurHash64A seed 1) -> canonical word, plus contraction surface ->
// norm piece list ("gonna" -> going to). Same load-before-use contract
// as the lemma table.
static std::unordered_map<uint64_t, std::string>& norm_hash_table() {
    static std::unordered_map<uint64_t, std::string> m;
    return m;
}

static std::unordered_map<std::string, std::vector<std::string>>& contraction_table() {
    static std::unordered_map<std::string, std::vector<std::string>> m;
    return m;
}

// MurmurHash64A — spaCy's StringStore hash (nlp/norms.py murmur64a).
static uint64_t murmur64a(const std::string& s, uint64_t seed = 1) {
    const uint64_t mul = 0xc6a4a7935bd1e995ULL;
    const int r = 47;
    const unsigned char* data = (const unsigned char*)s.data();
    size_t len = s.size();
    uint64_t h = seed ^ (len * mul);
    size_t nblocks = len / 8;
    for (size_t i = 0; i < nblocks; i++) {
        uint64_t k;
        memcpy(&k, data + i * 8, 8);  // little-endian host assumed (x86/ARM)
        k *= mul; k ^= k >> r; k *= mul;
        h ^= k; h *= mul;
    }
    const unsigned char* tail = data + nblocks * 8;
    uint64_t k = 0;
    for (size_t i = len & 7; i > 0; i--) k = (k << 8) | tail[i - 1];
    if (len & 7) { h ^= k; h *= mul; }
    h ^= h >> r; h *= mul; h ^= h >> r;
    return h;
}

// Mirrors nlp/stemmer.py stem(): norm fold, lemma fold, then Porter.
static std::string fold_stem(std::string w) {
    for (auto& c : w)
        if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    auto& nm = norm_hash_table();
    if (!nm.empty()) {
        auto it = nm.find(murmur64a(w));
        if (it != nm.end()) w = it->second;
    }
    auto& m = lemma_table();
    auto it = m.find(w);
    return porter::stem(it == m.end() ? w : it->second);
}

static void emit_token(const std::string& w, std::vector<std::string>& out) {
    if (w.size() > 1 && !stopwords().count(w)) out.push_back(fold_stem(w));
}

// Finish one raw word (lowercase, may contain apostrophes): contraction
// expansion first, else the historical apostrophe-splitting behavior.
// Mirrors retrieval/bm25.py tokenize().
static void flush_raw_word(std::string& cur, std::vector<std::string>& out) {
    std::string key = cur;
    while (!key.empty() && key.back() == '\'') key.pop_back();
    auto& ct = contraction_table();
    auto cit = ct.find(key);
    if (cit != ct.end()) {
        for (const auto& piece : cit->second) emit_token(piece, out);
    } else if (cur.find('\'') != std::string::npos) {
        size_t i = 0;
        while (i <= cur.size()) {
            size_t j = cur.find('\'', i);
            if (j == std::string::npos) j = cur.size();
            // trim leading non-alnum (mirrors _WORD_RE's first-char class)
            size_t k = i;
            while (k < j && !((cur[k] >= 'a' && cur[k] <= 'z') ||
                              (cur[k] >= '0' && cur[k] <= '9')))
                k++;
            if (k < j) emit_token(cur.substr(k, j - k), out);
            i = j + 1;
        }
    } else {
        emit_token(cur, out);
    }
    cur.clear();
}

static std::vector<std::string> tokenize(const char* text) {
    std::vector<std::string> out;
    std::string cur;
    bool started = false;
    for (const char* p = text; ; p++) {
        char c = *p;
        // curly apostrophes (U+2019/U+2018, UTF-8 e2 80 99/98) behave as '
        if ((unsigned char)c == 0xe2 && (unsigned char)p[1] == 0x80 &&
            ((unsigned char)p[2] == 0x99 || (unsigned char)p[2] == 0x98)) {
            c = '\'';
            p += 2;
        }
        char lc = (c >= 'A' && c <= 'Z') ? c - 'A' + 'a' : c;
        bool word_char;
        if (!started) {
            word_char = (lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9');
        } else {
            word_char = (lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9') ||
                        lc == '_' || lc == '-' || lc == '.' || lc == '/' || lc == '\'';
        }
        if (c != '\0' && word_char) {
            cur += lc;
            started = true;
        } else if (started) {
            flush_raw_word(cur, out);
            started = false;
        }
        if (c == '\0') break;
    }
    return out;
}

// ---------------------------------------------------------------------------
// BM25 engine (Okapi, k1=1.2 b=0.75) with tag/entity field boosts and
// per-term external weights — hybrid_search.rs semantics.
// ---------------------------------------------------------------------------

struct Bm25Index {
    std::unordered_map<std::string, std::unordered_map<uint64_t, float>> postings;
    std::unordered_map<uint64_t, float> doc_len;
    std::unordered_map<uint64_t, uint8_t> doc_class;  // per-doc param class
    double total_len = 0.0;
    std::mutex mu;
};

// Okapi parameters, per document PARAM CLASS: the k1/b optimum is domain-
// dependent (dialogue turns peak at 0.6/0.3, prose notes at Okapi
// 1.2/0.75 — round-3 scoping of the round-2 global retune), so each doc
// carries a class and scores under its own curve. Class 0 is the default
// for docs never assigned one; shodh_bm25_set_params keeps its original
// meaning (sets class 0) for back-compat with older callers.
static const int MAX_CLASSES = 4;
static float K1C[MAX_CLASSES] = {1.2f, 1.2f, 1.2f, 1.2f};
static float BC[MAX_CLASSES] = {0.75f, 0.75f, 0.75f, 0.75f};

// ---------------------------------------------------------------------------
// Distilled NER tagger (mirrors shodh_tpu/nlp/distilled_ner.py exactly for
// ASCII inputs — the Python binding routes non-ASCII texts to the Python
// path so Unicode case predicates never diverge). Greedy averaged-
// perceptron BIO decode over sparse string features; the per-token feature
// loop was ~2 ms/item of ingest enrichment in Python.
// ---------------------------------------------------------------------------

namespace ner {

constexpr int N_TAGS = 9;  // distilled_ner.py TAGS order

struct Model {
    std::unordered_map<std::string, std::array<double, N_TAGS>> rows;
    // ctypes releases the GIL around calls, so a reload (clear+rehash)
    // can race concurrent taggers without this lock.
    std::mutex mu;
};

inline Model& model() {
    static Model m;
    return m;
}

inline std::string lower_ascii(const std::string& s) {
    std::string out = s;
    for (auto& c : out)
        if (c >= 'A' && c <= 'Z') c += 32;
    return out;
}

// Python str.istitle() semantics restricted to ASCII: uppercase may only
// follow an uncased char, lowercase may only follow a cased char, and at
// least one cased char must appear ("O'Brien" is True).
inline bool istitle_ascii(const std::string& w) {
    bool seen_cased = false, prev_cased = false;
    for (char c : w) {
        if (c >= 'A' && c <= 'Z') {
            if (prev_cased) return false;
            seen_cased = true;
            prev_cased = true;
        } else if (c >= 'a' && c <= 'z') {
            if (!prev_cased) return false;
            prev_cased = true;
        } else {
            prev_cased = false;
        }
    }
    return seen_cased;
}

inline bool isupper_ascii(const std::string& w) {
    bool any = false;
    for (char c : w) {
        if (c >= 'a' && c <= 'z') return false;
        if (c >= 'A' && c <= 'Z') any = true;
    }
    return any;
}

inline std::string shape4(const std::string& w) {
    std::string out;
    for (size_t i = 0; i < w.size() && i < 4; ++i) {
        char c = w[i];
        if (c >= 'A' && c <= 'Z') out += 'X';
        else if (c >= 'a' && c <= 'z') out += 'x';
        else if (c >= '0' && c <= '9') out += '9';
        else out += c;
    }
    return out;
}

inline std::string tail(const std::string& s, size_t n) {  // s[-n:]
    return s.size() <= n ? s : s.substr(s.size() - n);
}

// feature list — ORDER matters (float accumulation must match Python)
inline void features(const std::vector<std::string>& words,
                     const std::vector<std::string>& lowers, size_t i,
                     const char* prev_tag, const char* prev2_tag,
                     std::vector<std::string>& out) {
    out.clear();
    const std::string& w = words[i];
    const std::string& wl = lowers[i];
    static const std::string BOS = "<s>", EOS = "</s>";
    const std::string& prev_w = i > 0 ? lowers[i - 1] : BOS;
    const std::string& prev2_w = i > 1 ? lowers[i - 2] : BOS;
    const std::string& next_w = i + 1 < words.size() ? lowers[i + 1] : EOS;
    const std::string& next2_w = i + 2 < words.size() ? lowers[i + 2] : EOS;
    out.push_back("b");
    out.push_back("w=" + wl);
    out.push_back("sh=" + shape4(w));
    out.push_back("sf3=" + tail(wl, 3));
    out.push_back("sf2=" + tail(wl, 2));
    out.push_back("pf2=" + wl.substr(0, std::min<size_t>(2, wl.size())));
    out.push_back("pw=" + prev_w);
    out.push_back("nw=" + next_w);
    out.push_back("p2w=" + prev2_w);
    out.push_back("n2w=" + next2_w);
    out.push_back(std::string("pt=") + prev_tag);
    out.push_back(std::string("p2t=") + prev2_tag + "|" + prev_tag);
    out.push_back("pw|w=" + prev_w + "|" + wl);
    out.push_back("w|nw=" + wl + "|" + next_w);
    if (istitle_ascii(w)) {
        out.push_back("title");
        if (i == 0) out.push_back("title@0");
        if (prev_w == "<s>" || prev_w == ":" || prev_w == "." ||
            prev_w == "!" || prev_w == "?")
            out.push_back("title@sent");
    }
    if (isupper_ascii(w) && w.size() > 1) out.push_back("upper");
    if (next_w == ":" && i <= 1) out.push_back("speaker");
    if (prev_w == "to" && prev2_w == "according") out.push_back("accto");
}

}  // namespace ner

extern "C" {

// Load the distilled NER weights: "feature\tw0 w1 ... w8\n" lines in
// distilled_ner.py TAGS order. Called once by the binding after dlopen.
void shodh_ner_load(const char* blob) {
    auto& m = ner::model();
    std::lock_guard<std::mutex> lk(m.mu);
    m.rows.clear();
    const char* p = blob;
    while (p && *p) {
        const char* tab = strchr(p, '\t');
        if (!tab) break;
        const char* nl = strchr(tab + 1, '\n');
        if (!nl) nl = tab + 1 + strlen(tab + 1);
        std::array<double, ner::N_TAGS> row{};
        const char* q = tab + 1;
        for (int t = 0; t < ner::N_TAGS && q < nl; ++t) {
            char* end = nullptr;
            row[t] = strtod(q, &end);
            q = end;
        }
        m.rows.emplace(std::string(p, tab - p), row);
        p = (*nl) ? nl + 1 : nl;
    }
}

// Greedy BIO decode. words: "w\n" lines (caller tokenizes — the Python
// regex owns offsets). Writes "tag_index margin\n" per token into out.
// Returns token count, or -1 when out_cap is too small.
int shodh_ner_tag(const char* words_blob, char* out, int out_cap) {
    auto& m = ner::model();
    std::lock_guard<std::mutex> lk(m.mu);
    std::vector<std::string> words;
    const char* p = words_blob;
    while (p && *p) {
        const char* nl = strchr(p, '\n');
        if (!nl) nl = p + strlen(p);
        if (nl > p) words.emplace_back(p, nl - p);
        p = (*nl) ? nl + 1 : nl;
    }
    static const char* TAGS[ner::N_TAGS] = {
        "O", "B-PER", "I-PER", "B-LOC", "I-LOC",
        "B-ORG", "I-ORG", "B-MISC", "I-MISC",
    };
    std::vector<std::string> lowers;
    lowers.reserve(words.size());
    for (auto& w : words) lowers.push_back(ner::lower_ascii(w));
    std::string result;
    const char* prev = "O";
    const char* prev2 = "O";
    std::vector<std::string> feats;
    char line[64];
    for (size_t i = 0; i < words.size(); ++i) {
        ner::features(words, lowers, i, prev, prev2, feats);
        double totals[ner::N_TAGS] = {0.0};
        for (auto& ft : feats) {
            auto it = m.rows.find(ft);
            if (it == m.rows.end()) continue;
            for (int t = 0; t < ner::N_TAGS; ++t) totals[t] += it->second[t];
        }
        int bi = 0;
        double bv = totals[0];
        for (int t = 1; t < ner::N_TAGS; ++t)
            if (totals[t] > bv) { bi = t; bv = totals[t]; }
        double second = -1e300;
        for (int t = 0; t < ner::N_TAGS; ++t)
            if (t != bi && totals[t] > second) second = totals[t];
        snprintf(line, sizeof(line), "%d %.17g\n", bi, bv - second);
        result += line;
        prev2 = prev;
        prev = TAGS[bi];
    }
    if ((int)result.size() + 1 > out_cap) return -1;
    memcpy(out, result.c_str(), result.size() + 1);
    return (int)words.size();
}

void shodh_bm25_set_params(float k1, float b) {
    K1C[0] = k1;
    BC[0] = b;
}

void shodh_bm25_set_class_params(int cls, float k1, float b) {
    if (cls < 0 || cls >= MAX_CLASSES) return;
    K1C[cls] = k1;
    BC[cls] = b;
}

void shodh_bm25_set_doc_class(void* h, uint64_t doc, int cls) {
    auto* idx = static_cast<Bm25Index*>(h);
    std::lock_guard<std::mutex> lk(idx->mu);
    if (cls <= 0) idx->doc_class.erase(doc);
    else idx->doc_class[doc] = (uint8_t)cls;
}

void* shodh_bm25_new() { return new Bm25Index(); }

void shodh_bm25_free(void* h) { delete static_cast<Bm25Index*>(h); }

void shodh_bm25_remove(void* h, uint64_t doc) {
    auto* idx = static_cast<Bm25Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    auto it = idx->doc_len.find(doc);
    if (it == idx->doc_len.end()) return;
    idx->total_len -= it->second;
    idx->doc_len.erase(it);
    for (auto pit = idx->postings.begin(); pit != idx->postings.end();) {
        pit->second.erase(doc);
        if (pit->second.empty()) pit = idx->postings.erase(pit);
        else ++pit;
    }
}

// weighted term list: "term\tweight\n..." (pre-tokenized by caller or via
// shodh_bm25_upsert_text below)
void shodh_bm25_upsert_text(void* h, uint64_t doc, const char* content,
                            const char* tags, const char* entities) {
    auto* idx = static_cast<Bm25Index*>(h);
    shodh_bm25_remove(h, doc);
    std::unordered_map<std::string, float> tf;
    for (auto& t : tokenize(content)) tf[t] += 1.0f;
    if (tags && *tags)
        for (auto& t : tokenize(tags)) tf[t] += 1.5f;  // TAG_BOOST
    if (entities && *entities)
        for (auto& t : tokenize(entities)) tf[t] += 1.3f;  // ENTITY_BOOST
    float len = 0.0f;
    for (auto& [_, f] : tf) len += f;
    std::lock_guard<std::mutex> lock(idx->mu);
    idx->doc_len[doc] = len;
    idx->total_len += len;
    for (auto& [term, f] : tf) idx->postings[term][doc] = f;
}

// Pre-tokenized upsert: terms as "term\tweight\n" lines. Gives the caller
// (the Python index, which owns persistence) byte-exact control of the
// weighted term frequencies in both engines.
void shodh_bm25_upsert_terms(void* h, uint64_t doc, const char* term_lines) {
    auto* idx = static_cast<Bm25Index*>(h);
    shodh_bm25_remove(h, doc);
    std::unordered_map<std::string, float> tf;
    const char* p = term_lines;
    while (p && *p) {
        const char* tab = strchr(p, '\t');
        if (!tab) break;
        const char* nl = strchr(tab + 1, '\n');
        if (!nl) nl = tab + 1 + strlen(tab + 1);
        tf[std::string(p, tab - p)] += strtof(tab + 1, nullptr);
        p = (*nl) ? nl + 1 : nl;
    }
    float len = 0.0f;
    for (auto& [_, f] : tf) len += f;
    std::lock_guard<std::mutex> lock(idx->mu);
    idx->doc_len[doc] = len;
    idx->total_len += len;
    for (auto& [term, f] : tf) idx->postings[term][doc] = f;
}

int shodh_bm25_doc_count(void* h) {
    auto* idx = static_cast<Bm25Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    return (int)idx->doc_len.size();
}

// query: raw text; term_weights: "term\tweight\n" pairs over STEMMED terms
// (may be empty). Writes up to `limit` (doc, score) pairs into out arrays.
// Returns the number written. Deterministic order: score desc, doc asc.
int shodh_bm25_search(void* h, const char* query, const char* term_weights,
                      uint64_t* out_docs, float* out_scores, int limit) {
    auto* idx = static_cast<Bm25Index*>(h);
    std::lock_guard<std::mutex> lock(idx->mu);
    size_t n_docs = idx->doc_len.size();
    if (n_docs == 0 || limit <= 0) return 0;
    double avg_len = idx->total_len / (double)n_docs;

    std::unordered_map<std::string, float> weights;
    if (term_weights && *term_weights) {
        const char* p = term_weights;
        while (*p) {
            const char* tab = strchr(p, '\t');
            if (!tab) break;
            const char* nl = strchr(tab + 1, '\n');
            if (!nl) nl = tab + 1 + strlen(tab + 1);
            weights[std::string(p, tab - p)] = strtof(tab + 1, nullptr);
            p = (*nl) ? nl + 1 : nl;
        }
    }

    std::vector<std::string> q = tokenize(query);
    std::unordered_set<std::string> seen;
    std::unordered_map<uint64_t, float> scores;
    for (auto& term : q) {
        if (!seen.insert(term).second) continue;
        auto pit = idx->postings.find(term);
        if (pit == idx->postings.end()) continue;
        size_t df = pit->second.size();
        float idf = std::log(1.0f + ((float)n_docs - df + 0.5f) / (df + 0.5f));
        float w = 1.0f;
        auto wit = weights.find(term);
        if (wit != weights.end()) w = wit->second;
        for (auto& [doc, tf] : pit->second) {
            float dl = idx->doc_len[doc];
            auto cit = idx->doc_class.find(doc);
            int cls = (cit == idx->doc_class.end()) ? 0 : cit->second;
            float k1 = K1C[cls], b = BC[cls];
            float tf_norm = (tf * (k1 + 1.0f)) / (tf + k1 * (1.0f - b + b * dl / (float)avg_len));
            scores[doc] += w * idf * tf_norm;
        }
    }
    std::vector<std::pair<uint64_t, float>> ranked(scores.begin(), scores.end());
    std::sort(ranked.begin(), ranked.end(), [](auto& a, auto& b) {
        if (a.second != b.second) return a.second > b.second;
        return a.first < b.first;
    });
    int n = std::min((int)ranked.size(), limit);
    for (int i = 0; i < n; i++) {
        out_docs[i] = ranked[i].first;
        out_scores[i] = ranked[i].second;
    }
    return n;
}

// Tokenize text -> newline-joined stemmed tokens (caller frees).
char* shodh_tokenize(const char* text) {
    auto toks = tokenize(text);
    std::string joined;
    for (size_t i = 0; i < toks.size(); i++) {
        if (i) joined += '\n';
        joined += toks[i];
    }
    char* out = (char*)malloc(joined.size() + 1);
    memcpy(out, joined.c_str(), joined.size() + 1);
    return out;
}

// Load the irregular-lemma fold table: "form\tlemma\n" lines. Called by
// the Python binding right after dlopen, before any tokenization.
void shodh_lemma_load(const char* tsv) {
    auto& m = lemma_table();
    m.clear();
    const char* p = tsv;
    while (*p) {
        const char* tab = strchr(p, '\t');
        if (!tab) break;
        const char* nl = strchr(tab + 1, '\n');
        if (!nl) nl = tab + 1 + strlen(tab + 1);
        m.emplace(std::string(p, tab), std::string(tab + 1, nl));
        p = (*nl) ? nl + 1 : nl;
    }
}

// Load the norm-fold tables: "H\t<hash>\t<norm>\n" and
// "C\t<surface>\t<piece piece ...>\n" lines (nlp/data/norm_folds.tsv.gz).
// Called by the Python binding right after dlopen, with shodh_lemma_load.
void shodh_norm_load(const char* tsv) {
    auto& nm = norm_hash_table();
    auto& ct = contraction_table();
    nm.clear();
    ct.clear();
    const char* p = tsv;
    while (*p) {
        const char* nl = strchr(p, '\n');
        if (!nl) nl = p + strlen(p);
        std::string line(p, nl);
        p = (*nl) ? nl + 1 : nl;
        size_t t1 = line.find('\t');
        if (t1 == std::string::npos) continue;
        size_t t2 = line.find('\t', t1 + 1);
        if (t2 == std::string::npos) continue;
        std::string kind = line.substr(0, t1);
        std::string key = line.substr(t1 + 1, t2 - t1 - 1);
        std::string value = line.substr(t2 + 1);
        if (kind == "H") {
            nm.emplace(strtoull(key.c_str(), nullptr, 10), value);
        } else if (kind == "C") {
            std::vector<std::string> pieces;
            size_t i = 0;
            while (i <= value.size()) {
                size_t j = value.find(' ', i);
                if (j == std::string::npos) j = value.size();
                if (j > i) pieces.push_back(value.substr(i, j - i));
                i = j + 1;
            }
            if (!pieces.empty()) ct.emplace(key, std::move(pieces));
        }
    }
}

char* shodh_stem(const char* word) {
    std::string s = fold_stem(std::string(word));
    char* out = (char*)malloc(s.size() + 1);
    memcpy(out, s.c_str(), s.size() + 1);
    return out;
}

void shodh_free(char* p) { free(p); }

}  // extern "C"
