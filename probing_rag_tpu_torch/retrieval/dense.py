"""Dense flat index: build (batched encoder), persist, and search.

Port of ``probing_rag_tpu/retrieval/dense.py``: the reference's
sentence-transformers + faiss flat-L2 index (make_indexer.py:446-457 build;
utils.py:374-380 / exp_rag.py:246-248 search) as a device-resident store
searched by ``ops.dense.dense_topk``. Same on-disk files as the JAX package
(``<path>.npy`` f32 embeddings, ``<path>.json`` metadata). Default metric
``l2`` for faiss ``IndexFlatL2`` parity; ``ip`` available.

``DenseIndex.build`` hands its encoder windows of ``WINDOW_BATCHES``
batches of passages, in passage order. The encoder (``models/encoder.py::
text_encoder``) orders a window by token count before cutting its batches
and writes each embedding back at its passage's place, as the reference's
``SentenceTransformer.encode`` does: the index stores the embeddings in
passage order, and a window's token ids are all the host holds at once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from probing_rag_tpu_torch.ops.dense import dense_topk, dense_topk_rerank, prepare_dense_store
from probing_rag_tpu_torch.utils.profiling import RECORDER

# batches in a window of DenseIndex.build: the host holds one window's token
# ids, and 16 batches of 512 sorted by length leave ~7% of the slots padding
# on passages of log-normal length (median 137 tokens), ~48% unsorted
WINDOW_BATCHES = 16


@dataclass
class DenseSearchResult:
    doc_indices: np.ndarray  # [Q, k] int32, -1 for empty slots
    scores: np.ndarray  # [Q, k] (l2: ascending distances; ip: descending)


class DenseIndex:
    def __init__(self, embeddings: np.ndarray, metric: str = "l2"):
        self.embeddings = np.asarray(embeddings, np.float32)
        self.metric = metric

    @property
    def n_docs(self) -> int:
        return self.embeddings.shape[0]

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        encode_fn: Callable[..., np.ndarray],
        batch_size: int = 512,  # make_indexer.py:446-455 encodes in 512s
        metric: str = "l2",
    ) -> "DenseIndex":
        """The index of ``texts``: ``encode_fn(window, batch_size=batch_size)``
        on each window of ``WINDOW_BATCHES * batch_size`` passages in turn
        (``text_encoder``'s ``encode``, which cuts the window into batches of
        ``batch_size`` ordered by length and returns the window's embeddings
        in its order), concatenated: ``embeddings`` ``[len(texts), D]`` in
        passage order."""
        window = WINDOW_BATCHES * batch_size
        with RECORDER.span("index.build", passages=len(texts)):
            chunks = [
                np.asarray(encode_fn(texts[start : start + window], batch_size=batch_size))
                for start in range(0, len(texts), window)
            ]
            return cls(np.concatenate(chunks, axis=0), metric)

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path.with_suffix(".npy"), self.embeddings)
        path.with_suffix(".json").write_text(
            json.dumps({"metric": self.metric, "n_docs": self.n_docs,
                        "dim": int(self.embeddings.shape[1])})
        )

    @classmethod
    def load(cls, path: Path) -> "DenseIndex":
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        return cls(np.load(path.with_suffix(".npy")), meta["metric"])


class DenseEngine:
    """Device-resident flat search; queries are encoded by ``encode_fn`` or
    passed pre-embedded. An int8 (SQ8) store re-ranks a ``max(32, k)``-deep
    candidate pool against a bf16 copy by default (faiss
    ``IndexRefineFlat``)."""

    def __init__(
        self,
        index: DenseIndex,
        encode_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        device="cuda",
        store_dtype: torch.dtype = torch.bfloat16,
        rerank: Optional[bool] = None,
    ):
        self.index = index
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        int8 = store_dtype == torch.int8
        self._rerank = int8 if rerank is None else (rerank and int8)
        emb = torch.from_numpy(index.embeddings).to(self.device)
        if not int8:
            emb = emb.to(store_dtype)
        # quantization and norms once here, not per search
        self._emb, self._sqn, self._scales, _ = prepare_dense_store(
            emb, metric=index.metric, store_dtype=store_dtype
        )
        self._rerank_emb = emb.to(torch.bfloat16) if self._rerank else None

    def search_embeddings(self, query_emb: np.ndarray, k: int = 5) -> DenseSearchResult:
        q = torch.as_tensor(np.asarray(query_emb, np.float32)).to(self.device)
        kw = dict(k=k, metric=self.index.metric, sq_norms=self._sqn, scales=self._scales,
                  n_total=self.index.n_docs)
        if self._rerank:
            vals, idx = dense_topk_rerank(q, self._emb, self._rerank_emb, k_pad=max(32, k), **kw)
        else:
            vals, idx = dense_topk(q, self._emb, **kw)
        return DenseSearchResult(idx.cpu().numpy(), vals.cpu().numpy())

    def search(self, queries: Sequence[str], k: int = 5) -> DenseSearchResult:
        if self.encode_fn is None:
            raise ValueError("DenseEngine needs encode_fn to search raw text")
        return self.search_embeddings(np.asarray(self.encode_fn(list(queries))), k=k)
