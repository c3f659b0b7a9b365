"""ctypes binding for the native C++ index builder (``indexer.cpp``).

Port of ``probing_rag_tpu/native/__init__.py`` over the port's own copy
of ``indexer.cpp``. The library is compiled with ``g++ -O3 -shared -fPIC``
at first use into ``_build/`` beside this file, as
``libindexer_<hash>.so``, and reused while a hash of the source, the flags
and the compiler's version line is unchanged. A compile that fails raises
with the compiler's stderr: nothing falls back to the numpy builder
(:func:`available` reports the failure, for a test's skip mark). The
native builder replaces the tokenize/hash/count hot loop of index
construction (make_indexer.py:434-444 in the reference's stack).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "indexer.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


class _BuildResult(ctypes.Structure):
    _fields_ = [
        ("n_docs", ctypes.c_int64),
        ("n_terms", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("term_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("postings_doc", ctypes.POINTER(ctypes.c_int32)),
        ("postings_tf", ctypes.POINTER(ctypes.c_float)),
        ("doc_lens", ctypes.POINTER(ctypes.c_int32)),
        ("vocab_blob", ctypes.POINTER(ctypes.c_char)),
        ("vocab_blob_len", ctypes.c_int64),
    ]


def build() -> Path:
    """Compile ``indexer.cpp`` into ``_build/libindexer_<hash>.so`` unless
    that file exists; returns its path. Raises ``RuntimeError`` with the
    compiler's output when ``g++`` is missing or fails."""
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                 check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"native indexer: no working g++ ({e})") from e
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(version.encode())
    so = BUILD_DIR / f"libindexer_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native indexer: g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders each write their own tmp
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first if needed), with every entry's
    ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    p64, p32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    lib.bm25_build.restype = ctypes.POINTER(_BuildResult)
    lib.bm25_build.argtypes = [ctypes.c_char_p, p64, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bm25_free.restype = None
    lib.bm25_free.argtypes = [ctypes.POINTER(_BuildResult)]
    lib.porter_stem.restype = ctypes.c_int
    lib.porter_stem.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
    lib.encoder_create.restype = ctypes.c_void_p
    lib.encoder_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.encoder_free.restype = None
    lib.encoder_free.argtypes = [ctypes.c_void_p]
    lib.encode_queries.restype = ctypes.c_int64
    lib.encode_queries.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p64, ctypes.c_int64,
                                   p32, p64, ctypes.c_int64]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (for a test's skip mark;
    the entry points themselves raise when it does not)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _join(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """UTF-8 texts joined by NUL, and the [N + 1] int64 byte offsets of
    each text in the joined buffer (undecodable characters dropped)."""
    raw = [t.encode("utf-8", errors="ignore") for t in texts]
    blob = b"\x00".join(raw)
    offsets = np.zeros(len(raw) + 1, np.int64)
    if raw:
        # text i starts after i separators
        np.cumsum(np.fromiter((len(r) for r in raw), np.int64, len(raw)), out=offsets[1:])
        offsets[1:] += np.arange(len(raw), dtype=np.int64)
    return blob, offsets


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def porter_stem(word: str) -> str:
    """One word through the native (original-algorithm) Porter stemmer."""
    buf = ctypes.create_string_buffer(256)
    raw = word.encode("utf-8")
    n = library().porter_stem(raw, len(raw), buf)
    return buf.raw[:n].decode("utf-8")


class QueryEncoder:
    """Native batch query analyzer and encoder against a fixed index vocab:
    the host side of serving (a Python tokenize/stem per query caps out far
    below the device engines' rate). The same analyzer chain as the native
    builder, so valid for indexes built with matching lowercase/stopword
    settings and ``stemmer_mode='original'`` (or ``stem=False``)."""

    def __init__(self, vocab: dict, lowercase: bool = True, remove_stopwords: bool = True,
                 stem: bool = True):
        self._lib = library()
        terms = sorted(vocab, key=vocab.get)
        blob = ("\n".join(terms) + "\n").encode("utf-8", errors="ignore") if terms else b""
        self._handle = self._lib.encoder_create(
            blob, len(blob), int(lowercase), int(remove_stopwords), int(stem))

    def close(self) -> None:
        if self._handle:
            self._lib.encoder_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

    def encode(self, queries: Sequence[str]) -> List[np.ndarray]:
        """Per-query int32 term-id arrays (OOV dropped, duplicates kept)."""
        blob, offsets = _join(queries)
        cap = max(64, 4 * len(blob))
        out_ids = np.empty(cap, np.int32)
        out_offs = np.empty(len(queries) + 1, np.int64)
        n = self._lib.encode_queries(
            self._handle, blob, _i64(offsets), len(queries),
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _i64(out_offs), cap)
        if n < 0:
            raise RuntimeError("native encoder output capacity exceeded")
        return [out_ids[out_offs[i]:out_offs[i + 1]].copy() for i in range(len(queries))]


def build_postings(
    texts: Sequence[str],
    lowercase: bool = True,
    remove_stopwords: bool = True,
    stem: bool = True,
) -> Tuple[dict, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native CSR build. Returns ``(vocab, term_offsets int64 [T + 1],
    postings_doc int32, postings_tf f32, doc_lens int32)``, the arrays
    ``BM25Index.build_tokenized`` computes on its way."""
    lib = library()
    blob, offsets = _join(texts)
    res = lib.bm25_build(blob, _i64(offsets), len(texts), int(lowercase),
                         int(remove_stopwords), int(stem))
    try:
        r = res.contents
        term_offsets = np.ctypeslib.as_array(r.term_offsets, (r.n_terms + 1,)).copy()
        postings_doc = np.ctypeslib.as_array(r.postings_doc, (max(r.nnz, 1),))[: r.nnz].copy()
        postings_tf = np.ctypeslib.as_array(r.postings_tf, (max(r.nnz, 1),))[: r.nnz].copy()
        doc_lens = (np.ctypeslib.as_array(r.doc_lens, (r.n_docs,)).copy() if r.n_docs
                    else np.zeros(0, np.int32))
        terms = (ctypes.string_at(r.vocab_blob, r.vocab_blob_len).decode("utf-8").split("\n")[:-1]
                 if r.vocab_blob_len else [])
    finally:
        lib.bm25_free(res)
    return {t: i for i, t in enumerate(terms)}, term_offsets, postings_doc, postings_tf, doc_lens
