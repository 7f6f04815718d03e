"""Lineage-aware training-data pipeline.

The corpus-selection stage IS a PredTrace pipeline (paper operators):

    docs --Filter(quality)--> --InnerJoin(metadata)--> --Filter(license)-->
         --FilterScalarSub(doc_id == min(doc_id) over dedup cluster)-->   # dedup
         selected docs

so *row-level lineage is a first-class feature of the data layer*: given any
emitted training example (or a loss spike at (step, row)), ``lineage_of``
pushes the doc's row-selection predicate down to the raw corpus + metadata
tables — including the dedup-cluster mates that caused this doc to be the
cluster representative.  No per-example provenance is stored at training time
(the paper's lazy property), and the pipeline itself is unmodified unless
inference decides an intermediate is needed.

Batches are deterministic functions of (seed, step): resumable after
preemption with no data-order drift (fault-tolerance contract).  They are
the reference's numpy batches bit for bit.  The pipeline's ``PredTrace``
scans on ``device`` (the CUDA card unless the caller passes ``"cpu"``), so
its ``Filter(quality >= ...)`` and ``IsIn(license, ...)`` scans go through
the ``pred_filter_batch`` kernel where the dispatch cutovers send them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import ops as O
from ..core.expr import Col, IsIn, land
from ..core.lineage import LineageAnswer, PredTrace
from ..core.table import Table


def synth_corpus(
    n_docs: int = 2000, vocab: int = 1000, seed: int = 0, dup_rate: float = 0.2
) -> Tuple[Dict[str, Table], np.ndarray]:
    """Synthetic corpus: docs + metadata tables and a flat token store."""
    rng = np.random.default_rng(seed)
    doc_len = rng.integers(32, 128, n_docs)
    offsets = np.concatenate([[0], np.cumsum(doc_len)])
    tokens = rng.integers(0, vocab, int(offsets[-1])).astype(np.int32)
    n_clusters = int(n_docs * (1 - dup_rate))
    docs = Table.from_dict(
        {
            "doc_id": np.arange(n_docs, dtype=np.int64),
            "quality": np.round(rng.uniform(0, 1, n_docs), 3),
            "domain": rng.integers(0, 8, n_docs).astype(np.int32),
            "n_tokens": doc_len.astype(np.int32),
            "tok_offset": offsets[:-1].astype(np.int64),
        },
        name="docs",
    )
    metadata = Table.from_dict(
        {
            "m_doc_id": np.arange(n_docs, dtype=np.int64),
            "license": rng.integers(0, 4, n_docs).astype(np.int32),
            "dedup_cluster": rng.integers(0, n_clusters, n_docs).astype(np.int64),
        },
        name="metadata",
    )
    return {"docs": docs, "metadata": metadata}, tokens


def selection_plan(
    quality_min: float = 0.3, licenses: Tuple[int, ...] = (0, 1, 2)
) -> O.Node:
    """The corpus-selection pipeline in PredTrace operators."""
    docs = O.Filter(O.Source("docs"), Col("quality") >= quality_min)
    joined = O.InnerJoin(docs, O.Source("metadata"), on=[("doc_id", "m_doc_id")])
    licensed = O.Filter(joined, IsIn(Col("license"), licenses))
    # dedup: keep the cluster representative (min doc_id within the cluster)
    inner = O.Filter(
        O.InnerJoin(
            O.Filter(O.Source("docs"), Col("quality") >= quality_min),
            O.Source("metadata"),
            on=[("doc_id", "m_doc_id")],
        ),
        IsIn(Col("license"), licenses),
    )
    dedup = O.FilterScalarSub(
        licensed,
        inner,
        correlate=[("dedup_cluster", "dedup_cluster")],
        agg=O.Agg("min", Col("doc_id")),
        cmp="==",
        outer_expr=Col("doc_id"),
    )
    return dedup


@dataclass
class PipelineState:
    step: int = 0

    def advance(self) -> "PipelineState":
        return PipelineState(self.step + 1)


class LineageDataPipeline:
    def __init__(
        self,
        catalog: Dict[str, Table],
        tokens: np.ndarray,
        seq_len: int = 128,
        batch: int = 8,
        seed: int = 0,
        quality_min: float = 0.3,
        device=None,
    ):
        self.catalog = catalog
        self.tokens = tokens
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.plan = selection_plan(quality_min)
        self.pt = PredTrace(catalog, self.plan, device=device)
        self.pt.infer()
        self.exec_result = self.pt.run()
        self.selected = self.exec_result.output  # selected docs table
        if self.selected.nrows == 0:
            raise ValueError("selection produced no documents")

    # ------------------------------------------------------------------ #
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step``: (tokens, labels, doc_ids)."""
        n = self.selected.nrows
        rng = np.random.default_rng((self.seed, step))
        order = rng.permutation(n)
        toks = np.zeros((self.batch, self.seq_len), np.int32)
        doc_ids = np.zeros((self.batch, 4), np.int64) - 1  # up to 4 packed docs
        di = 0
        for b in range(self.batch):
            fill = 0
            slot = 0
            while fill < self.seq_len:
                row = int(order[di % n])
                di += 1
                off = int(self.selected["tok_offset"][row])
                ln = int(self.selected["n_tokens"][row])
                take = min(ln, self.seq_len - fill)
                toks[b, fill : fill + take] = self.tokens[off : off + take]
                if slot < doc_ids.shape[1]:
                    doc_ids[b, slot] = self.selected["doc_id"][row]
                fill += take
                slot += 1
        return {"tokens": toks, "labels": toks.copy(), "doc_ids": doc_ids}

    # ------------------------------------------------------------------ #
    def lineage_of(self, doc_id: int) -> LineageAnswer:
        """Trace a training doc back to raw corpus + metadata rows
        (PredTrace precise mode over the selection pipeline)."""
        out = self.selected
        idx = np.nonzero(out["doc_id"] == doc_id)[0]
        if not len(idx):
            raise KeyError(f"doc {doc_id} not in the selected set")
        return self.pt.query(int(idx[0]))

    def lineage_of_batch(self, step: int, row: int) -> Dict[int, LineageAnswer]:
        """All docs packed into (step, row) -> their corpus lineage."""
        b = self.batch_at(step)
        out = {}
        for d in b["doc_ids"][row]:
            if d >= 0:
                out[int(d)] = self.lineage_of(int(d))
        return out
