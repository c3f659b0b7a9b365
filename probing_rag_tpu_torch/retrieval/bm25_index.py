"""From-scratch BM25 inverted index: CSR term->posting arrays with
precomputed per-posting impact scores, and the two postings layouts the
CUDA search kernels read (the block-alternated store and the aligned CSR).

Port of ``probing_rag_tpu/retrieval/bm25_index.py`` (numpy only, same
on-disk format: an index written by the JAX package's ``index-build`` loads
unchanged).

- The BM25 term-document contribution depends only on (term, doc):
  ``idf(t) * tf * (k1+1) / (tf + k1*(1 - b + b*dl/avgdl))`` — so it is
  precomputed at build time into a flat ``f32`` impact array aligned with the
  postings. Query scoring on the device is then a gather + sort + segment-sum
  + top-k with no per-posting math (``retrieval/bm25.py``).
- Layout: ``term_offsets[T+1] (int64)``, ``postings_doc[NNZ] (int32)``
  (sorted by doc within each term), ``postings_impact[NNZ] (f32)``.
- Scoring variant ``okapi`` reproduces rank_bm25.BM25Okapi exactly (the
  engine inside llama-index's retriever): ``idf = ln((N-n+0.5)/(n+0.5))``
  with negative idfs floored to ``0.25 * mean(idf)``; ``lucene`` uses the
  non-negative ``ln(1 + (N-n+0.5)/(n+0.5))``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from probing_rag_tpu_torch.retrieval.text import Analyzer


@dataclass(frozen=True)
class BM25Config:
    k1: float = 1.5
    b: float = 0.75
    variant: str = "okapi"  # "okapi" (rank_bm25-compatible) | "lucene"
    epsilon: float = 0.25  # okapi negative-idf floor factor
    lowercase: bool = True
    remove_stopwords: bool = True
    stem: bool = True
    stemmer_mode: str = "nltk"  # "nltk" (default extensions) | "original"

    def analyzer(self) -> Analyzer:
        return Analyzer(
            lowercase=self.lowercase,
            remove_stopwords=self.remove_stopwords,
            stem=self.stem,
            stemmer_mode=self.stemmer_mode,
        )


def _compute_idf(n_docs: int, doc_freqs: np.ndarray, config: BM25Config) -> np.ndarray:
    if config.variant == "lucene":
        return np.log(1.0 + (n_docs - doc_freqs + 0.5) / (doc_freqs + 0.5))
    if config.variant != "okapi":
        raise ValueError(f"unknown BM25 variant {config.variant!r}")
    idf = np.log((n_docs - doc_freqs + 0.5) / (doc_freqs + 0.5))
    # okapi floors negative idf at eps * mean(idf) over terms IN the corpus
    # (rank_bm25 semantics): term-id spaces with absent ids (the integer-
    # stream builder) must not let df=0 slots inflate the mean
    present = idf[doc_freqs > 0]
    eps = config.epsilon * present.mean() if present.size else 0.0
    return np.where(idf < 0, eps, idf)



def _impacts(term_of_posting: np.ndarray, postings_doc: np.ndarray, tf: np.ndarray,
             doc_freqs: np.ndarray, doc_lens: np.ndarray, config: BM25Config) -> np.ndarray:
    """Per-posting impact ``idf(t) * tf * (k1+1) / (tf + k1*(1 - b +
    b*dl/avgdl))`` as f32, shared by every builder."""
    n_docs = len(doc_lens)
    idf = _compute_idf(n_docs, doc_freqs.astype(np.float64), config)
    avgdl = float(doc_lens.mean()) if n_docs else 0.0
    dl_norm = config.k1 * (1.0 - config.b + config.b * doc_lens.astype(np.float64) / max(avgdl, 1e-9))
    impact = idf[term_of_posting] * tf * (config.k1 + 1.0) / (tf + dl_norm[postings_doc])
    return impact.astype(np.float32)

@dataclass
class BM25Index:
    config: BM25Config
    vocab: Dict[str, int]  # term -> term id
    term_offsets: np.ndarray  # [T+1] int64, CSR offsets into postings
    postings_doc: np.ndarray  # [NNZ] int32, doc ids (sorted within a term)
    postings_impact: np.ndarray  # [NNZ] f32, precomputed BM25 contribution
    doc_lens: np.ndarray  # [N] int32
    doc_ids: List[str]  # external doc ids (row -> id)

    @property
    def n_docs(self) -> int:
        return len(self.doc_lens)

    @property
    def n_terms(self) -> int:
        return len(self.term_offsets) - 1

    @property
    def nnz(self) -> int:
        return len(self.postings_doc)

    # ---------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        config: Optional[BM25Config] = None,
        doc_ids: Optional[Sequence[str]] = None,
    ) -> "BM25Index":
        config = config or BM25Config()
        analyzer = config.analyzer()
        return cls.build_tokenized([analyzer(t) for t in texts], config, doc_ids)

    @classmethod
    def build_native(
        cls,
        texts: Sequence[str],
        config: Optional[BM25Config] = None,
        doc_ids: Optional[Sequence[str]] = None,
    ) -> "BM25Index":
        """CSR build through the C++ indexer (``probing_rag_tpu_torch.
        native``): the tokenize/stem/count loop runs in C++, the idf and
        impact math in numpy as :meth:`build_tokenized` does it. The native
        Porter stemmer is the original algorithm, so ``config`` defaults to
        ``stemmer_mode='original'`` and a stemming ``'nltk'`` config raises.
        A failed compile raises; there is no fallback to :meth:`build`."""
        from probing_rag_tpu_torch import native

        config = config or BM25Config(stemmer_mode="original")
        if config.stem and config.stemmer_mode != "original":
            raise ValueError("the native builder implements the original Porter "
                             "algorithm; use BM25Config(stemmer_mode='original')")
        vocab, term_offsets, doc_arr, tf_arr, doc_lens = native.build_postings(
            texts, lowercase=config.lowercase, remove_stopwords=config.remove_stopwords,
            stem=config.stem,
        )
        n_docs = len(texts)
        doc_freqs = term_offsets[1:] - term_offsets[:-1]
        term_of_posting = np.repeat(np.arange(len(vocab), dtype=np.int64), doc_freqs)
        return cls(
            config=config,
            vocab=vocab,
            term_offsets=term_offsets,
            postings_doc=doc_arr,
            postings_impact=_impacts(term_of_posting, doc_arr, tf_arr, doc_freqs, doc_lens, config),
            doc_lens=doc_lens,
            doc_ids=list(doc_ids) if doc_ids is not None else [str(i) for i in range(n_docs)],
        )

    @classmethod
    def build_tokenized_ids(
        cls,
        token_ids: np.ndarray,  # [NTOK] int64, flat pre-tokenized stream
        doc_lens: np.ndarray,  # [N] int, tokens per doc (sums to NTOK)
        config: Optional[BM25Config] = None,
        doc_ids: Optional[Sequence[str]] = None,
    ) -> "BM25Index":
        """Fully vectorized CSR build from an integer token stream — the
        web-scale path (the reference's Wikipedia psgs_w100 corpus is 21M
        passages, make_indexer.py:252-293; a Python per-doc dict loop over
        billions of tokens is hours, one np.unique sort is minutes). Term
        id == token id (callers hash strings upstream); ``vocab`` maps
        ``"t{id}"`` for symmetry with ``encode_query``."""
        config = config or BM25Config()
        token_ids = np.asarray(token_ids, dtype=np.int64)
        doc_lens = np.asarray(doc_lens, dtype=np.int64)
        n_docs = len(doc_lens)
        assert doc_lens.sum() == token_ids.size
        n_terms = int(token_ids.max()) + 1 if token_ids.size else 0
        # the id space must be DENSE (term id == token id, and the vocab /
        # doc_freqs / offsets tables are all sized n_terms): raw 32/64-bit
        # hashes would allocate tens of GB of tables and can overflow the
        # pair key below (term * n_docs + doc > 2^63 silently wraps and
        # np.unique then merges unrelated (term, doc) pairs). Callers with
        # hashed tokens must compact them first (np.unique(...,
        # return_inverse=True)).
        if token_ids.size:
            if int(token_ids.min()) < 0:
                raise ValueError("token ids must be non-negative")
            if n_terms > max(8 * token_ids.size, 1 << 22):
                raise ValueError(
                    f"token id space is sparse (max id {n_terms - 1:,} vs "
                    f"{token_ids.size:,} tokens) — compact ids first "
                    "(np.unique(ids, return_inverse=True)); term tables are "
                    "allocated densely at n_terms entries"
                )
            if n_terms > (2**63 - 1) // max(n_docs, 1):
                raise ValueError(
                    "n_terms * n_docs overflows the int64 (term, doc) sort "
                    "key — compact token ids or shard the corpus"
                )
        doc_of_token = np.repeat(np.arange(n_docs, dtype=np.int64), doc_lens)
        # (term, doc) pair counts in one sort: key = term * n_docs + doc
        key = token_ids * n_docs + doc_of_token
        uniq, tf = np.unique(key, return_counts=True)
        term_arr = uniq // n_docs
        doc_arr = (uniq % n_docs).astype(np.int32)
        tf_arr = tf.astype(np.float32)

        doc_freqs = np.bincount(term_arr, minlength=n_terms).astype(np.int64)
        term_offsets = np.zeros(n_terms + 1, dtype=np.int64)
        np.cumsum(doc_freqs, out=term_offsets[1:])
        return cls(
            config=config,
            vocab={f"t{t}": t for t in range(n_terms)},
            term_offsets=term_offsets,
            postings_doc=doc_arr,
            postings_impact=_impacts(term_arr, doc_arr, tf_arr, doc_freqs, doc_lens, config),
            doc_lens=doc_lens.astype(np.int32),
            doc_ids=list(doc_ids) if doc_ids is not None else [str(i) for i in range(n_docs)],
        )

    @classmethod
    def build_tokenized(
        cls,
        docs_tokens: Sequence[List[str]],
        config: Optional[BM25Config] = None,
        doc_ids: Optional[Sequence[str]] = None,
    ) -> "BM25Index":
        config = config or BM25Config()
        n_docs = len(docs_tokens)
        vocab: Dict[str, int] = {}
        # One pass: term-frequency pairs as parallel flat arrays.
        term_col: List[int] = []
        doc_col: List[int] = []
        tf_col: List[int] = []
        doc_lens = np.zeros(n_docs, dtype=np.int32)
        for d, tokens in enumerate(docs_tokens):
            doc_lens[d] = len(tokens)
            counts: Dict[int, int] = {}
            for tok in tokens:
                tid = vocab.setdefault(tok, len(vocab))
                counts[tid] = counts.get(tid, 0) + 1
            term_col.extend(counts.keys())
            doc_col.extend([d] * len(counts))
            tf_col.extend(counts.values())

        term_arr = np.asarray(term_col, dtype=np.int64)
        doc_arr = np.asarray(doc_col, dtype=np.int32)
        tf_arr = np.asarray(tf_col, dtype=np.float32)

        # Segment-sort into CSR: stable sort by term keeps docs ascending
        # within each term (doc_col was appended in doc order).
        order = np.argsort(term_arr, kind="stable")
        term_arr, doc_arr, tf_arr = term_arr[order], doc_arr[order], tf_arr[order]

        n_terms = len(vocab)
        doc_freqs = np.bincount(term_arr, minlength=n_terms).astype(np.int64)
        term_offsets = np.zeros(n_terms + 1, dtype=np.int64)
        np.cumsum(doc_freqs, out=term_offsets[1:])

        return cls(
            config=config,
            vocab=vocab,
            term_offsets=term_offsets,
            postings_doc=doc_arr,
            postings_impact=_impacts(term_arr, doc_arr, tf_arr, doc_freqs, doc_lens, config),
            doc_lens=doc_lens,
            doc_ids=list(doc_ids) if doc_ids is not None else [str(i) for i in range(n_docs)],
        )

    # ------------------------------------------------------------ aligned
    def aligned_csr(self, alignment: int = 1024, guard: int = 4096):
        return align_csr(
            self.term_offsets, self.postings_doc, self.postings_impact,
            sentinel=self.n_docs, alignment=alignment, guard=guard,
        )

    # ------------------------------------------------------------ bitonic
    def bitonic_csr(self, min_len: int = 256, block: int = 1024):
        return build_bitonic_store(
            self.term_offsets, self.postings_doc, self.postings_impact,
            sentinel=self.n_docs, min_len=min_len, block=block,
        )

    # ------------------------------------------------------------ queries
    def encode_query(self, tokens: List[str]) -> np.ndarray:
        """Map analyzed query tokens to term ids, dropping OOV. Duplicate
        tokens are kept — rank_bm25 scores them once per occurrence."""
        return np.asarray([self.vocab[t] for t in tokens if t in self.vocab], dtype=np.int32)

    # ------------------------------------------------------------- oracle
    def score_all(self, term_ids: np.ndarray) -> np.ndarray:
        """Dense scores for one query over every doc — the exact host oracle
        the device engines are tested against."""
        scores = np.zeros(self.n_docs, dtype=np.float64)
        for t in np.asarray(term_ids):
            lo, hi = self.term_offsets[t], self.term_offsets[t + 1]
            np.add.at(scores, self.postings_doc[lo:hi], self.postings_impact[lo:hi])
        return scores.astype(np.float32)

    # ------------------------------------------------------------ persist
    def save(self, path: Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "postings.npz",
            term_offsets=self.term_offsets,
            postings_doc=self.postings_doc,
            postings_impact=self.postings_impact,
            doc_lens=self.doc_lens,
        )
        manifest = {
            "format": "probing-rag-tpu/bm25-csr/v1",
            "config": asdict(self.config),
            "n_docs": self.n_docs,
            "n_terms": self.n_terms,
            "nnz": self.nnz,
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
        (path / "vocab.json").write_text(json.dumps(self.vocab))
        (path / "doc_ids.json").write_text(json.dumps(self.doc_ids))

    @classmethod
    def load(cls, path: Path) -> "BM25Index":
        path = Path(path)
        manifest = json.loads((path / "manifest.json").read_text())
        arrays = np.load(path / "postings.npz")
        return cls(
            config=BM25Config(**manifest["config"]),
            vocab=json.loads((path / "vocab.json").read_text()),
            term_offsets=arrays["term_offsets"],
            postings_doc=arrays["postings_doc"],
            postings_impact=arrays["postings_impact"],
            doc_lens=arrays["doc_lens"],
            doc_ids=json.loads((path / "doc_ids.json").read_text()),
        )


def align_up(lens: np.ndarray, alignment: int) -> np.ndarray:
    """Posting lengths rounded up to whole ``alignment`` blocks."""
    return -(-lens // alignment) * alignment


def bitonic_tables(lens: np.ndarray, min_len: int = 256, block: int = 1024):
    """The long-term tables of :func:`build_bitonic_store` from posting
    lengths ``[..., T]`` (a leading axis gives one row a shard): aligned
    starts (-1 for short terms) and aligned lengths (0 for short), int64."""
    big = lens >= min_len
    alen = np.where(big, align_up(lens, block), 0)
    start = np.zeros_like(alen)
    np.cumsum(alen[..., :-1], axis=-1, out=start[..., 1:])
    return np.where(big, start, -1), alen


def align_csr(
    term_offsets: np.ndarray,
    postings_doc: np.ndarray,
    postings_impact: np.ndarray,
    *,
    sentinel: int,
    alignment: int = 1024,
    guard: int = 4096,
):
    """CSR copy with every posting list padded to an ``alignment`` multiple
    using (sentinel-doc, 0-impact) entries, plus a ``guard`` tail: the
    layout of the "dma" engine mode.

    Aligned starts and aligned per-term lengths let the gather copy whole
    blocks of one term (``ops/sparse.py::postings_gather``). Padding entries
    sort after every real doc and contribute nothing to run totals. The
    arrays equal the JAX package's element for element, guard included (the
    CUDA gather never reads it). Returns (term_offsets int32 [T+1],
    postings_doc, postings_impact).
    """
    n_terms = len(term_offsets) - 1
    nnz = len(postings_doc)
    lens = (term_offsets[1:] - term_offsets[:-1]).astype(np.int64)
    pad_lens = align_up(lens, alignment)
    a_offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(pad_lens, out=a_offsets[1:])
    total = int(a_offsets[-1]) + guard
    if total >= 2**31:
        raise ValueError("aligned postings exceed int32 indexing; shard the index")
    a_doc = np.full(total, sentinel, np.int32)
    a_imp = np.zeros(total, np.float32)
    # vectorized scatter: position of each original posting in the aligned
    # layout = aligned term start + rank within its term
    term_of_posting = np.repeat(np.arange(n_terms), lens)
    rank = np.arange(nnz) - np.repeat(term_offsets[:-1].astype(np.int64), lens)
    pos = a_offsets[term_of_posting] + rank
    a_doc[pos] = postings_doc
    a_imp[pos] = postings_impact
    return a_offsets.astype(np.int32), a_doc, a_imp


@dataclass
class BitonicStore:
    """Postings layout for the bitonic BM25 search
    (``ops/sparse.py::bm25_search_bitonic``).

    Long terms (>= ``min_len`` postings) live in TWO aligned copies whose
    1024-blocks alternate ascending/descending: copy E serves a term copied
    to an even 1024-block of the query row, copy O one copied to an odd
    block — so after the gather every 1024-block of the row is sorted asc
    (even index) or desc (odd index), which is exactly the state after pass
    1024 of a bitonic sorting network. The sort then starts at pass 2048,
    skipping roughly half the stages (``ops/sort.py`` ``k_start``).

    Short terms stay in the compact CSR: the gather reads an even slot's
    postings from the compact copy (ascending, at the slot head) and an odd
    slot's from the reversed-compact copy (descending, at the slot tail), so
    no per-term alignment padding is stored for the short tail. The arrays
    equal the JAX package's element for element, guard tails included.
    """

    block: int
    min_len: int
    sentinel: int
    nnz: int
    # long terms: offset into the E/O arrays (-1 for short), aligned length
    aligned_start: np.ndarray  # [T] int32
    aligned_len: np.ndarray  # [T] int32 (0 for short terms)
    doc_e: np.ndarray  # [A] int32, blocks asc at even local index
    imp_e: np.ndarray
    doc_o: np.ndarray  # [A] int32, blocks asc at odd local index
    imp_o: np.ndarray
    # short terms: guarded compact + guarded reversed-compact copies
    doc_c: np.ndarray  # [nnz + 2*block] int32
    imp_c: np.ndarray
    doc_r: np.ndarray  # reversed: doc_r[i] = doc[nnz-1-i], then guard
    imp_r: np.ndarray


def _reverse_blocks(arr2d: np.ndarray, mask: np.ndarray) -> np.ndarray:
    out = arr2d.copy()
    out[mask] = out[mask, ::-1]
    return out


def build_bitonic_store(
    term_offsets: np.ndarray,
    postings_doc: np.ndarray,
    postings_impact: np.ndarray,
    *,
    sentinel: int,
    min_len: int = 256,
    block: int = 1024,
) -> BitonicStore:
    """See BitonicStore. Extra device memory: 2x the aligned size of long
    terms plus 1x nnz for the reversed compact copy (~2.5-3x nnz total on
    natural corpora with min_len=256)."""
    if min_len > block:
        raise ValueError(f"min_len ({min_len}) must be <= block ({block})")
    nnz = len(postings_doc)
    lens = (term_offsets[1:] - term_offsets[:-1]).astype(np.int64)
    a_start, pad_lens = bitonic_tables(lens, min_len, block)
    is_big = lens >= min_len
    # floor of one block, as in the JAX store (equal arrays on both sides)
    total = max(int(pad_lens.sum()), block)
    if total >= 2**31 or nnz + 2 * block >= 2**31:
        raise ValueError("bitonic store exceeds int32 indexing; shard the index")

    a_doc = np.full(total, sentinel, np.int32)
    a_imp = np.zeros(total, np.float32)
    big_idx = np.nonzero(is_big)[0]
    big_lens = lens[big_idx]
    term_of = np.repeat(big_idx, big_lens)
    rank = (
        np.arange(len(term_of))
        - np.repeat(np.cumsum(big_lens) - big_lens, big_lens)
    )
    src = np.repeat(term_offsets[:-1][big_idx], big_lens) + rank
    pos = np.repeat(a_start[big_idx], big_lens) + rank
    a_doc[pos] = postings_doc[src]
    a_imp[pos] = postings_impact[src]

    # local block parity of every aligned block
    blk2 = total // block
    local = np.arange(blk2, dtype=np.int64)
    term_starts_blk = np.repeat(
        a_start[big_idx] // block, (pad_lens[big_idx] // block)
    )
    if len(term_starts_blk) < blk2:  # sentinel-only floor blocks (see above)
        term_starts_blk = np.concatenate(
            [term_starts_blk, np.arange(len(term_starts_blk), blk2)]
        )
    local = local - term_starts_blk
    odd = (local & 1) == 1
    d2 = a_doc.reshape(blk2, block)
    i2 = a_imp.reshape(blk2, block)
    guard = np.full(2 * block, sentinel, np.int32)
    guardf = np.zeros(2 * block, np.float32)
    # guard tails as in the JAX store; the CUDA gather never reads them
    doc_e = np.concatenate([_reverse_blocks(d2, odd).reshape(-1), guard, guard])
    imp_e = np.concatenate([_reverse_blocks(i2, odd).reshape(-1), guardf, guardf])
    doc_o = np.concatenate([_reverse_blocks(d2, ~odd).reshape(-1), guard, guard])
    imp_o = np.concatenate([_reverse_blocks(i2, ~odd).reshape(-1), guardf, guardf])
    doc_c = np.concatenate([postings_doc.astype(np.int32), guard])
    imp_c = np.concatenate([postings_impact.astype(np.float32), guardf])
    doc_r = np.concatenate([postings_doc[::-1].astype(np.int32), guard])
    imp_r = np.concatenate([postings_impact[::-1].astype(np.float32), guardf])

    return BitonicStore(
        block=block,
        min_len=min_len,
        sentinel=sentinel,
        nnz=nnz,
        aligned_start=a_start.astype(np.int32),
        aligned_len=pad_lens.astype(np.int32),
        doc_e=doc_e,
        imp_e=imp_e,
        doc_o=doc_o,
        imp_o=imp_o,
        doc_c=doc_c,
        imp_c=imp_c,
        doc_r=doc_r,
        imp_r=imp_r,
    )
