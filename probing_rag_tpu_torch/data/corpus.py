"""Corpus readers + document store.

Copy of ``probing_rag_tpu/data/corpus.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_data_eval.py``
holds the two equal.

Behavioral spec: the reference's make_indexer.py:32-392 (per-dataset readers,
content hashing, dedup) and the doc-id -> text CSV artifact
(make_indexer.py:459-464). Readers return ``(texts, doc_ids)`` with
deterministic content-hash ids and order-preserving dedup (the reference's
``list(set(texts))`` dedup is order-unstable across runs; stable dedup is the
deliberate fix — flagged per SURVEY.md §7 'parity traps').

Host-side IO only; not on the device hot path.
"""

from __future__ import annotations

import bz2
import csv
import glob
import hashlib
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def _base58(data: bytes) -> str:
    num = int.from_bytes(data, "big")
    out = []
    while num:
        num, rem = divmod(num, 58)
        out.append(_B58_ALPHABET[rem])
    return "".join(reversed(out)) or _B58_ALPHABET[0]


def hash_object(obj) -> str:
    """Deterministic content id: blake2b over the utf-8 repr, base58-encoded
    (the reference hashes dill bytes — make_indexer.py:32-38; repr-based
    hashing avoids the pickle dependency while staying deterministic)."""
    digest = hashlib.blake2b(repr(obj).encode("utf-8"), digest_size=16).digest()
    return _base58(digest)


def _stable_dedup(texts: Sequence[str], ids: Sequence[str]) -> Tuple[List[str], List[str]]:
    seen = set()
    out_t, out_i = [], []
    for t, i in zip(texts, ids):
        if t in seen:
            continue
        seen.add(t)
        out_t.append(t)
        out_i.append(i)
    return out_t, out_i


def _strip_html(text: str) -> str:
    return re.sub(r"<[^>]+>", "", text)


# ----------------------------------------------------------------- readers


def make_hotpotqa_documents(raw_dir: Path) -> Tuple[List[str], List[str]]:
    """HotpotQA wiki abstract dump: bz2 JSONL shards under
    enwiki-20171001-pages-meta-current-withlinks-abstracts/*/ with
    sentence-list 'text' fields (make_indexer.py:41-82)."""
    texts, ids = [], []
    pattern = str(
        Path(raw_dir)
        / "enwiki-20171001-pages-meta-current-withlinks-abstracts"
        / "*"
        / "wiki_*.bz2"
    )
    for shard in sorted(glob.glob(pattern)):
        with bz2.open(shard, "rt", encoding="utf-8") as f:
            for line in f:
                page = json.loads(line)
                text = "".join(page.get("text", []))
                if not text:
                    continue
                texts.append(text)
                ids.append(hash_object(text))
    return _stable_dedup(texts, ids)


def make_iirc_documents(raw_dir: Path) -> Tuple[List[str], List[str]]:
    """IIRC context articles (HTML-ish) keyed by title
    (make_indexer.py:84-129)."""
    path = Path(raw_dir) / "context_articles.json"
    articles = json.loads(path.read_text())
    texts, ids = [], []
    for title, html in articles.items():
        text = _strip_html(html).strip()
        if not text:
            continue
        texts.append(text)
        ids.append(hash_object((title, text)))
    return _stable_dedup(texts, ids)


def make_2wikimultihopqa_documents(raw_dir: Path) -> Tuple[List[str], List[str]]:
    """2WikiMultihopQA: context paragraphs from train/dev
    (make_indexer.py:131-184)."""
    texts, ids = [], []
    for split in ("train.json", "dev.json"):
        path = Path(raw_dir) / split
        if not path.exists():
            continue
        for ex in json.loads(path.read_text()):
            for title, sentences in ex.get("context", []):
                text = " ".join(sentences)
                if not text:
                    continue
                texts.append(text)
                ids.append(hash_object((title, text)))
    return _stable_dedup(texts, ids)


def make_musique_documents(raw_dir: Path) -> Tuple[List[str], List[str]]:
    """MuSiQue paragraphs from the jsonl splits (make_indexer.py:186-250)."""
    texts, ids = [], []
    for split in ("musique_full_v1.0_train.jsonl", "musique_full_v1.0_dev.jsonl"):
        path = Path(raw_dir) / split
        if not path.exists():
            continue
        with path.open() as f:
            for line in f:
                ex = json.loads(line)
                for para in ex.get("paragraphs", []):
                    text = para.get("paragraph_text", "")
                    if not text:
                        continue
                    texts.append(text)
                    ids.append(hash_object((para.get("title", ""), text)))
    return _stable_dedup(texts, ids)


def make_wiki_documents(raw_dir: Path) -> Tuple[List[str], List[str]]:
    """Full Wikipedia passage table psgs_w100.tsv: id, text, title
    (make_indexer.py:252-293)."""
    texts, ids = [], []
    path = Path(raw_dir) / "psgs_w100.tsv"
    with path.open(newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        for row in reader:
            if len(row) < 2:
                continue
            texts.append(row[1].strip('"'))
            ids.append(row[0])
    return texts, ids  # row ids are already unique


def make_dpr_documents(raw_dir: Path, dataset: str) -> Tuple[List[str], List[str]]:
    """DPR biencoder files (nq/trivia/squad): positive + negative +
    hard-negative contexts from train+dev (make_indexer.py:295-392)."""
    texts, ids = [], []
    for split in ("train", "dev"):
        path = Path(raw_dir) / f"biencoder-{dataset}-{split}.json"
        if not path.exists():
            continue
        for ex in json.loads(path.read_text()):
            for key in ("positive_ctxs", "negative_ctxs", "hard_negative_ctxs"):
                for ctx in ex.get(key, []):
                    text = ctx.get("text", "")
                    if not text:
                        continue
                    texts.append(text)
                    ids.append(hash_object(text))
    return _stable_dedup(texts, ids)


READERS = {
    "hotpotqa": make_hotpotqa_documents,
    "iirc": make_iirc_documents,
    "2wikimultihopqa": make_2wikimultihopqa_documents,
    "musique": make_musique_documents,
    "wiki": make_wiki_documents,
}


def make_documents(dataset_name: str, raw_dir: Path) -> Tuple[List[str], List[str]]:
    if dataset_name in ("nq", "trivia", "squad"):
        return make_dpr_documents(Path(raw_dir) / dataset_name, dataset_name)
    if dataset_name in READERS:
        return READERS[dataset_name](Path(raw_dir) / dataset_name)
    raise ValueError(f"unknown corpus {dataset_name!r}")


# ---------------------------------------------------------------- docstore


@dataclass
class DocStore:
    """doc row -> (external id, text); the analogue of the reference's
    ``{dataset}_index_2.csv`` doc table (make_indexer.py:459-464)."""

    _texts: List[str]
    _ids: List[str]

    def __len__(self) -> int:
        return len(self._texts)

    def text(self, row: int) -> str:
        return self._texts[row]

    def texts(self, rows: Iterable[int]) -> List[str]:
        return [self._texts[r] for r in rows]

    def all_texts(self) -> List[str]:
        return list(self._texts)

    def doc_ids(self) -> List[str]:
        return list(self._ids)

    @classmethod
    def from_texts(cls, texts: Sequence[str], ids: Optional[Sequence[str]] = None) -> "DocStore":
        ids = list(ids) if ids is not None else [hash_object(t) for t in texts]
        return cls(list(texts), ids)

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            json.dump({"ids": self._ids, "texts": self._texts}, f)

    @classmethod
    def load(cls, path: Path) -> "DocStore":
        data = json.loads(Path(path).read_text())
        return cls(data["texts"], data["ids"])
