"""BM25 lexical index (the tantivy-equivalent leg).

Reference: ``src/memory/hybrid_search.rs:135-520`` — a BM25 index over
content + tags + entities with IC-term-weighted queries. This is a fresh
in-process implementation: Okapi BM25 (k1=1.2, b=0.75) over a stemmed
inverted index, with per-term external weights (the query parser's IC/POS
weights) scaling each term's contribution, and field boosts for tag and
entity matches.

Persistence: tokenized postings are kept in the host KV store per document
so restarts rebuild the in-memory index without re-tokenizing content.
The in-memory posting lists serve queries; documents are visible to search
immediately on upsert (no commit/reload cycle like tantivy's — that
complexity existed to batch segment writes, which an in-memory index
doesn't need).
"""

from __future__ import annotations

import math
import os
import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.nlp.stopwords import STOPWORDS
from shodh_tpu_torch.retrieval.spellfix import SpellFix
from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.storage.serialization import decode, encode

_WORD_RE = re.compile(r"[a-z0-9][a-z0-9_\-./]*")
# First-pass scan keeps word-internal apostrophes so contraction folding
# ("gonna", "can't", "doin'") sees the intact surface form; unfolded
# words are re-scanned with _WORD_RE, which reproduces the historical
# apostrophe-splitting behavior exactly.
_RAW_WORD_RE = re.compile(r"[a-z0-9][a-z0-9_\-./']*")

# tf saturation swept on locomo-full (1.6/1.2/1.0/0.8/0.6/0.4): short
# conversational turns rarely repeat terms, so a faster-saturating tf
# (k1=0.6) lets idf and field boosts decide — full r@10 .6675->.6772,
# gate .6277->.6423, every aggregate up. (Reference: textbook 1.2.)
# Per-domain Okapi parameters live in constants.py (repo convention:
# every scoring tunable there, with the reference citation). Class 1
# (prose/notes) exists because the dialogue retune was measured on turns
# and cost the notes-domain smoke suite (round-2 weak #5).
from shodh_tpu_torch.constants import (  # noqa: E402
    BM25_B_DIALOGUE,
    BM25_B_NOTES,
    BM25_K1_DIALOGUE,
    BM25_K1_NOTES,
)

K1 = BM25_K1_DIALOGUE
K1_NOTES = BM25_K1_NOTES
B_NOTES = BM25_B_NOTES
CLASS_DIALOGUE = 0
CLASS_NOTES = 1
# Length normalization swept on locomo-full (0.75/.6/.5/.4/.3/.2/0):
# conversational turns are short and similar-length, and the measured
# missed-gold profile was LONGER answer-bearing turns (18.6 vs 14.5 mean
# stems), so Okapi's default b=0.75 over-penalizes exactly the docs that
# matter. b=0.3 peaks p@1/mrr/map (full r@10 .6567->.6675, gate ->.6277);
# the reference keeps the textbook 0.75 (hybrid_search.rs).
B = BM25_B_DIALOGUE
TAG_BOOST = float(os.environ.get("SHODH_BM25_TAG_BOOST", "1.5"))
ENTITY_BOOST = float(os.environ.get("SHODH_BM25_ENTITY_BOOST", "1.3"))


def tokenize(text: str) -> list[str]:
    from shodh_tpu_torch.nlp.normalize import fold_abbreviations
    from shodh_tpu_torch.nlp.norms import expand_contraction

    text = fold_abbreviations(text).lower()
    if "’" in text or "‘" in text:
        text = text.replace("’", "'").replace("‘", "'")
    out: list[str] = []
    for raw in _RAW_WORD_RE.findall(text):
        expansion = expand_contraction(raw.rstrip("'"))
        if expansion is None:
            words = _WORD_RE.findall(raw) if "'" in raw else (raw,)
        else:
            # "gonna" -> ("going", "to"); norm pieces are plain words
            words = expansion
        for w in words:
            if w not in STOPWORDS and len(w) > 1:
                out.append(stem(w))
    return out


def lexical_fingerprint() -> str:
    """Hash of every input that determines a token's indexed identity:
    stemmer backend, lemma/norm fold tables, contraction expansions,
    abbreviation folds, stopwords, plus a tokenizer canary probing the
    composed behavior. The engine stamps this into the store (meta key
    ``lexical_fp``); a mismatch at open means persisted postings and
    hash-embedder vectors were stemmed under DIFFERENT rules than live
    queries will be — every fold-affected term would silently stop
    matching old documents — so the engine re-derives them from content
    (``MemorySystem.migrate_lexical``). The reference never needs this
    (its rust-stemmers build is fixed at compile time,
    query_parser.rs); ours does because fold tables ship in-tree and
    default-on (round-3 lexical campaign), so an upgrade can change
    ``stem()`` over an existing store.
    """
    import hashlib
    import json

    from shodh_tpu_torch.nlp.lemmas import LEMMA_EXCEPTIONS
    from shodh_tpu_torch.nlp.normalize import abbreviation_table
    from shodh_tpu_torch.nlp.norms import CONTRACTIONS, NORM_BY_HASH
    from shodh_tpu_torch.nlp.stemmer import backend_name

    h = hashlib.sha256()
    h.update(f"tok1|{backend_name()}".encode())
    # Doc-CONSTRUCTION schema version: bump when how a doc is assembled
    # changes (not just token identity), so existing stores re-derive
    # through migrate_lexical once at open. v2 = 2-back context inheritance
    # + the deferred-enrichment refresh fix (the old refresh persisted docs
    # with their context terms wiped — replay heals them).
    h.update(b"docschema|2")
    for table in (
        LEMMA_EXCEPTIONS,
        NORM_BY_HASH,
        {k: list(v) for k, v in CONTRACTIONS.items()},
        abbreviation_table(),
    ):
        h.update(json.dumps(table, sort_keys=True).encode())
    h.update(json.dumps(sorted(STOPWORDS)).encode())
    # Canary: catches tokenizer-shape changes the tables can't (regex,
    # apostrophe handling, stopword filtering, length floor).
    canary = (
        "Dr. Smith's children went to the theatre tonite -- gonna watch "
        "their favourite movies; she doesn't mind the u.s. co-op 3.14"
    )
    h.update("|".join(tokenize(canary)).encode())
    return h.hexdigest()


class BM25Index:
    def __init__(self, path: str | Path | None = None, use_native: bool = True):
        self._postings: dict[str, dict[str, float]] = defaultdict(dict)  # term -> {doc: tf}
        self._doc_len: dict[str, float] = {}
        self._doc_class: dict[str, int] = {}  # per-doc Okapi param class
        self._total_len = 0.0
        self.kv: Optional[KvStore] = None
        # Native C++ scorer (retrieval/native.py): same tokenizer + math,
        # ~10x faster scoring loop. Python postings stay authoritative for
        # persistence; the native engine mirrors them. Unlike the JAX
        # package's index, a native scorer that cannot be built or loaded
        # raises here instead of leaving the Python scorer in its place.
        self._native = None
        self._spellfix = SpellFix()
        self._handle_of: dict[str, int] = {}
        self._id_of: dict[int, str] = {}
        self._next_handle = 1
        if use_native:
            from shodh_tpu_torch.retrieval.native import NativeBM25

            # Okapi parameters pass through so host and native scorers
            # always agree (shodh_bm25_set_params).
            self._native = NativeBM25(k1=K1, b=B)
            self._native.set_class_params(CLASS_NOTES, K1_NOTES, B_NOTES)
        if path is not None:
            self.kv = KvStore(Path(path) / "bm25.db")
            self._load()

    # -- persistence ----------------------------------------------------------

    def _load(self) -> None:
        for doc_id, raw in self.kv.scan_prefix("bm25cls", ""):
            cls = raw[0] if raw else CLASS_DIALOGUE
            self._doc_class[doc_id] = cls
            if self._native is not None:
                self._native.set_doc_class(self._handle(doc_id), cls)
        for doc_id, raw in self.kv.scan_prefix("bm25doc", ""):
            tf = decode(raw)
            self._insert(doc_id, tf)

    def _insert(self, doc_id: str, tf: dict[str, float]) -> None:
        length = sum(tf.values())
        self._doc_len[doc_id] = length
        self._total_len += length
        for term, f in tf.items():
            self._postings[term][doc_id] = f
        if self._native is not None:
            self._native.upsert_terms(self._handle(doc_id), tf)

    def _remove(self, doc_id: str) -> None:
        if doc_id not in self._doc_len:
            return
        self._total_len -= self._doc_len.pop(doc_id)
        for term in list(self._postings.keys()):
            if doc_id in self._postings[term]:
                del self._postings[term][doc_id]
                if not self._postings[term]:
                    del self._postings[term]

    # -- write path -----------------------------------------------------------

    def _handle(self, doc_id: str) -> int:
        h = self._handle_of.get(doc_id)
        if h is None:
            h = self._next_handle
            self._next_handle += 1
            self._handle_of[doc_id] = h
            self._id_of[h] = doc_id
        return h

    def upsert(
        self,
        doc_id: str,
        content: str,
        tags: list[str] | None = None,
        entities: list[str] | None = None,
        context_content: str | None = None,
        context_weight: float = 0.0,
        param_class: int = CLASS_DIALOGUE,
    ) -> None:
        """Index a document. ``context_content`` folds a neighboring
        document's terms in at ``context_weight`` x their tf (dialogue
        turns inherit their antecedent's nouns so pronoun-heavy turns
        stay findable — engine-side feature, see memory_system.remember)."""
        self._remove(doc_id)
        tf: Counter[str] = Counter(tokenize(content))
        weighted: dict[str, float] = dict(tf)
        for t in tags or []:
            for tok in tokenize(t):
                weighted[tok] = weighted.get(tok, 0.0) + TAG_BOOST
        for e in entities or []:
            for tok in tokenize(e):
                weighted[tok] = weighted.get(tok, 0.0) + ENTITY_BOOST
        if context_content and context_weight > 0.0:
            for tok, f in Counter(tokenize(context_content)).items():
                weighted[tok] = weighted.get(tok, 0.0) + context_weight * f
        self._set_doc_class(doc_id, param_class)
        self._insert(doc_id, weighted)
        if self.kv is not None:
            self.kv.put("bm25doc", doc_id, encode(weighted))

    def _set_doc_class(self, doc_id: str, param_class: int) -> None:
        if param_class != CLASS_DIALOGUE:
            self._doc_class[doc_id] = param_class
            if self.kv is not None:
                self.kv.put("bm25cls", doc_id, bytes([param_class]))
        elif doc_id in self._doc_class:
            del self._doc_class[doc_id]
            if self.kv is not None:
                self.kv.delete("bm25cls", doc_id)
        if self._native is not None:
            self._native.set_doc_class(self._handle(doc_id), param_class)

    def delete(self, doc_id: str) -> None:
        self._remove(doc_id)
        self._doc_class.pop(doc_id, None)
        if self._native is not None and doc_id in self._handle_of:
            self._native.remove(self._handle_of[doc_id])
        if self.kv is not None:
            self.kv.delete("bm25doc", doc_id)
            self.kv.delete("bm25cls", doc_id)

    # -- search ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._doc_len)

    def search(
        self,
        query: str,
        limit: int = 10,
        term_weights: Optional[dict[str, float]] = None,
        phrase_terms: Optional[list[str]] = None,
    ) -> list[tuple[str, float]]:
        """Ranked (doc_id, score). ``term_weights`` maps *stemmed* terms to
        IC weights; ``phrase_terms`` get an extra boost when all present."""
        n_docs = len(self._doc_len)
        if n_docs == 0:
            return []
        # OOV spell correction (retrieval/spellfix.py): terms with zero
        # postings may map to a Damerau-Levenshtein-1 vocab stem. Gated
        # on emptiness, so clean queries are untouched; when a fix fires
        # (rare) the query runs on the host scorer so both paths score
        # the same corrected term set. Tokenization stays inside the flag
        # check so the native fast path pays no host tokenize cost when
        # spellfix is disabled.
        fixes: dict[str, str] = {}
        q_terms: Optional[list[str]] = None
        if C.SPELLFIX:
            q_terms = tokenize(query)
            for t in dict.fromkeys(q_terms):
                if t not in self._postings:
                    fixed = self._spellfix.fix(t, self._postings)
                    if fixed is not None:
                        fixes[t] = fixed
            if fixes:
                q_terms = [fixes.get(t, t) for t in q_terms]
                if term_weights:
                    # Corrected terms keep their IC weight: the contract is
                    # "typo query ranks like the clean query", which needs
                    # the weight to follow the term through the fix. Two
                    # sources folding onto one stem keep the stronger weight.
                    remapped: dict[str, float] = {}
                    for t, w in term_weights.items():
                        key = fixes.get(t, t)
                        remapped[key] = max(w, remapped.get(key, 0.0))
                    term_weights = remapped
        # Native scorer fast path (identical math; phrase boost needs the
        # Python per-doc term sets, so phrase queries stay on the host impl)
        if self._native is not None and not phrase_terms and not fixes:
            hits = self._native.search(query, limit=limit, term_weights=term_weights)
            out = [(self._id_of[h], s) for h, s in hits if h in self._id_of]
            out.sort(key=lambda kv: (-kv[1], kv[0]))  # doc-id tie-break parity
            return out
        avg_len = self._total_len / n_docs
        if q_terms is None:
            q_terms = tokenize(query)
        if not q_terms:
            return []
        scores: dict[str, float] = defaultdict(float)
        seen_terms: dict[str, set[str]] = defaultdict(set)
        for term in dict.fromkeys(q_terms):  # unique, order-preserving
            plist = self._postings.get(term)
            if not plist:
                continue
            df = len(plist)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            w = term_weights.get(term, 1.0) if term_weights else 1.0
            for doc_id, tf in plist.items():
                dl = self._doc_len[doc_id]
                if self._doc_class.get(doc_id, CLASS_DIALOGUE) == CLASS_NOTES:
                    k1, b = K1_NOTES, B_NOTES
                else:
                    k1, b = K1, B
                tf_norm = (tf * (k1 + 1.0)) / (tf + k1 * (1.0 - b + b * dl / avg_len))
                scores[doc_id] += w * idf * tf_norm
                seen_terms[doc_id].add(term)
        # Phrase boost: docs containing every phrase term
        if phrase_terms:
            pset = {stem(t.lower()) for t in phrase_terms}
            for doc_id in scores:
                if pset <= seen_terms[doc_id]:
                    scores[doc_id] *= 1.25
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:limit]

    def add_context_terms(self, doc_id: str, content: str, weight: float) -> None:
        """Fold a successor document's terms into an EXISTING doc at
        ``weight`` x tf (forward dialogue context: the turn that follows
        often names what this turn only alludes to). No-op for unknown
        docs. O(|old terms| + |new terms|), not O(vocab)."""
        if weight <= 0.0 or doc_id not in self._doc_len:
            return
        extra: dict[str, float] = {}
        for t, f in Counter(tokenize(content)).items():
            extra[t] = weight * f
        if not extra:
            return
        if self.kv is not None:
            raw = self.kv.get("bm25doc", doc_id)
            weighted = decode(raw) if raw is not None else {}
        else:
            weighted = {
                t: docs[doc_id] for t, docs in self._postings.items() if doc_id in docs
            }
        # targeted removal of the old posting entries (not the O(vocab) scan)
        self._total_len -= self._doc_len.pop(doc_id, 0.0)
        for t in weighted:
            docs = self._postings.get(t)
            if docs is not None:
                docs.pop(doc_id, None)
                if not docs:
                    del self._postings[t]
        for t, w in extra.items():
            weighted[t] = weighted.get(t, 0.0) + w
        self._insert(doc_id, weighted)
        if self.kv is not None:
            self.kv.put("bm25doc", doc_id, encode(weighted))

    def has_expansion(self, doc_id: str) -> bool:
        if self.kv is not None:
            return self.kv.get("bm25exp", doc_id) is not None
        return doc_id in getattr(self, "_expansion", {})

    def set_expansion_terms(self, doc_id: str, extra: dict[str, float]) -> None:
        """Attach model-derived terms to an existing doc, REPLACING any
        previous expansion (round-3 document-side semantic expansion: each
        doc inherits its distinctive stems' co-occurrence neighbors, the
        index-time mirror of query expansion). The stored base document is
        reconstructed by subtracting the previous expansion, so semantic-
        model refits are idempotent — expansions never stack."""
        if doc_id not in self._doc_len:
            return
        if self.kv is not None:
            raw = self.kv.get("bm25exp", doc_id)
            old_exp = decode(raw) if raw is not None else {}
            raw = self.kv.get("bm25doc", doc_id)
            effective = decode(raw) if raw is not None else {}
        else:
            old_exp = getattr(self, "_expansion", {}).get(doc_id, {})
            effective = {
                t: docs[doc_id] for t, docs in self._postings.items() if doc_id in docs
            }
        base: dict[str, float] = {}
        for t, w in effective.items():
            rem = w - old_exp.get(t, 0.0)
            if rem > 1e-9:
                base[t] = rem
        new_effective = dict(base)
        for t, w in extra.items():
            if w > 0.0:
                new_effective[t] = new_effective.get(t, 0.0) + w
        # targeted removal of the old posting entries (not the O(vocab) scan)
        self._total_len -= self._doc_len.pop(doc_id, 0.0)
        for t in effective:
            docs = self._postings.get(t)
            if docs is not None:
                docs.pop(doc_id, None)
                if not docs:
                    del self._postings[t]
        self._insert(doc_id, new_effective)
        if self.kv is not None:
            self.kv.put("bm25doc", doc_id, encode(new_effective))
            if extra:
                self.kv.put("bm25exp", doc_id, encode(extra))
            else:
                self.kv.delete("bm25exp", doc_id)
        else:
            if not hasattr(self, "_expansion"):
                self._expansion = {}
            if extra:
                self._expansion[doc_id] = dict(extra)
            else:
                self._expansion.pop(doc_id, None)

    def load_doc(self, doc_id: str) -> bool:
        """(Re)load one doc's persisted postings + param class from kv —
        follower catch-up (engine/follower.py): the writer already
        persisted the exact effective weighted terms (context-augmented,
        expanded), so followers mirror them without recomputation."""
        if self.kv is None:
            return False
        raw = self.kv.get("bm25doc", doc_id)
        if raw is None:
            return False
        if doc_id in self._doc_len:
            # targeted removal of the old posting entries
            old = {
                t: docs[doc_id] for t, docs in self._postings.items() if doc_id in docs
            }
            self._total_len -= self._doc_len.pop(doc_id, 0.0)
            for t in old:
                docs = self._postings.get(t)
                if docs is not None:
                    docs.pop(doc_id, None)
                    if not docs:
                        del self._postings[t]
        cls_raw = self.kv.get("bm25cls", doc_id)
        cls = cls_raw[0] if cls_raw else CLASS_DIALOGUE
        if cls != CLASS_DIALOGUE:
            self._doc_class[doc_id] = cls
        else:
            self._doc_class.pop(doc_id, None)
        if self._native is not None:
            self._native.set_doc_class(self._handle(doc_id), cls)
        self._insert(doc_id, decode(raw))
        return True

    def idf(self, term: str) -> float:
        """BM25 idf of a (stemmed) term; 0 for unseen terms."""
        df = len(self._postings.get(term, {}))
        if df == 0:
            return 0.0
        n_docs = len(self._doc_len)
        return math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))

    def flush(self) -> None:
        if self.kv is not None:
            self.kv.flush()
