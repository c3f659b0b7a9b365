"""Dataclass config tree and named presets.

Port of ``probing_rag_tpu/config.py``: one typed tree in place of the
reference's per-script argument blocks, with presets reproducing its shell
scripts (rag.sh, train_prober.sh, make_index.sh, make_dataset*.sh), built
on the port's own ``RAGConfig``, ``ProberTrainConfig`` and ``BM25Config``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from probing_rag_tpu_torch.pipeline.rag import RAGConfig
from probing_rag_tpu_torch.prober.train import ProberTrainConfig
from probing_rag_tpu_torch.retrieval.bm25_index import BM25Config


@dataclass(frozen=True)
class ModelSpec:
    family: str = "gemma"  # gemma | mistral
    model_id: str = "google/gemma-2b"
    checkpoint_dir: Optional[str] = None  # HF checkpoint files, if present
    tokenizer_path: Optional[str] = None

    def lm_config(self):
        from probing_rag_tpu_torch.models.gemma import GemmaConfig

        if self.family == "mistral":
            return GemmaConfig.mistral_7b()
        return GemmaConfig.gemma_2b()


@dataclass(frozen=True)
class RetrievalSpec:
    kind: str = "sparse"  # sparse | dense | ivf (probed dense, retrieval/ivf.py)
    index_dir: str = "artifacts/index"
    docstore_path: str = "artifacts/docstore.json"
    bm25: BM25Config = field(default_factory=BM25Config)
    dense_metric: str = "l2"
    ivf_nprobe: int = 32  # cells probed per query (recall knob)
    ivf_nlist: Optional[int] = None  # cell count (None: ~2*sqrt(n), pow2)
    top_k: int = 5


@dataclass(frozen=True)
class EvalSpec:
    dataset_name: str = "nq"
    split: str = "dev"
    raw_dir: str = "raw_data"
    steps_limit: int = 500  # rag.sh: 500-question dev subsets
    is_cot: bool = True
    results_dir: str = "result"


@dataclass(frozen=True)
class RunConfig:
    model: ModelSpec = field(default_factory=ModelSpec)
    retrieval: RetrievalSpec = field(default_factory=RetrievalSpec)
    eval: EvalSpec = field(default_factory=EvalSpec)
    rag: RAGConfig = field(default_factory=RAGConfig)
    prober_train: ProberTrainConfig = field(default_factory=ProberTrainConfig)
    prober_ckpt: str = "artifacts/probers"
    seed: int = 42


def preset(name: str, **overrides) -> RunConfig:
    """Named presets reproducing the reference shell scripts; ``overrides``
    replace top-level fields of the chosen preset."""
    base = RunConfig()
    presets = {
        # rag.sh: --ds 3 --is_cot --is_sparse --steps_limit 500, threshold 0
        "rag-sparse-cot": base,
        "rag-dense-cot": dataclasses.replace(
            base, retrieval=dataclasses.replace(base.retrieval, kind="dense")
        ),
        "rag-ivf-cot": dataclasses.replace(
            base, retrieval=dataclasses.replace(base.retrieval, kind="ivf")
        ),
        # make_dataset.sh: training-split extraction with simple/none methods
        "dataset-simple": dataclasses.replace(
            base,
            rag=dataclasses.replace(base.rag, retr_method="simple"),
            eval=dataclasses.replace(base.eval, split="train", steps_limit=3200),
        ),
        "dataset-none": dataclasses.replace(
            base,
            rag=dataclasses.replace(base.rag, retr_method="none"),
            eval=dataclasses.replace(base.eval, split="train", steps_limit=3200),
        ),
        # train_prober.sh: its layer sweep is one run over every site here
        "prober-train": base,
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    cfg = presets[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
