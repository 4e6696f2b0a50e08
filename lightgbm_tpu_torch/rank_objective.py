"""Lambdarank NDCG objective: padded queries, dense pairwise lambdas.

Port of ``lightgbm_tpu/rank_objective.py`` (``LambdarankNDCG``,
`src/objective/rank_objective.hpp:19-228`).  Queries are padded to a common
length Q (the next power of two, at least 8) and the pairwise lambda matrix
of each query is computed densely, a batch of ``2**26 // Q**2`` queries at a
time, so the (batch, Q, Q) float32 intermediates stay near 256 MB.  Each
document's lambda and hessian are scattered into the (N_pad,) gradients with
``index_add_``; every document belongs to one query, so each output element
receives exactly one addition.  The sigmoid lookup table
(`rank_objective.hpp:180-193`) is the exact ``2 / (1 + exp(2·σ·Δ))``.

Semantics kept from the JAX package: rank discounts ``1/log2(2+pos)`` over a
stable sort of the scores in descending order (padding at ``-inf``), per-pair
ΔNDCG with the max-DCG@k normalization (``CalMaxDCGAtK``), the
``0.01 + |Δscore|`` regularization when a query's scores are not all equal,
and ``p_hessian = λ(2 − λ)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .objectives import ObjectiveFunction


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 (`DCGCalculator::DefaultLabelGain`)."""
    return (2.0 ** np.arange(max_label + 1)) - 1.0


def max_dcg_at_k(k: int, labels: np.ndarray, label_gain: np.ndarray) -> float:
    """``DCGCalculator::CalMaxDCGAtK`` (`src/metric/dcg_calculator.cpp`)."""
    srt = np.sort(labels)[::-1][:k]
    disc = 1.0 / np.log2(np.arange(len(srt)) + 2.0)
    return float((label_gain[srt.astype(np.int64)] * disc).sum())


class LambdarankNDCG(ObjectiveFunction):
    name = "lambdarank"
    need_group = True
    #: a document's gradient reads its whole query
    row_local = False

    def __init__(self, cfg: Config, device: torch.device):
        super().__init__(cfg, device)
        if cfg.sigmoid <= 0:
            raise ValueError("Sigmoid param should be greater than zero")
        self.sigmoid = float(cfg.sigmoid)
        lg = cfg.label_gain
        self.label_gain = np.asarray(lg, dtype=np.float64) if lg \
            else default_label_gain()
        self.optimize_pos_at = cfg.max_position

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        qb = metadata.query_boundaries
        if qb is None:
            raise ValueError("Lambdarank tasks require query information")
        self.query_boundaries = qb
        sizes = np.diff(qb)
        nq = self.num_queries = len(sizes)
        qmax = int(sizes.max())
        self.q_pad = max(8, 1 << (qmax - 1).bit_length())
        n = num_data
        qid = np.repeat(np.arange(nq, dtype=np.int64), sizes)
        within = np.arange(n, dtype=np.int64) - qb[qid]
        # (nq, Q) doc index into the padded row axis (-1 = padding)
        doc_idx = np.full((nq, self.q_pad), -1, dtype=np.int64)
        doc_idx[qid, within] = np.arange(n, dtype=np.int64)
        safe = np.clip(doc_idx, 0, n - 1)
        labels = np.where(doc_idx >= 0, metadata.label[safe], -1)
        lab_int = metadata.label.astype(np.int64)
        if lab_int.size and int(lab_int.max()) >= len(self.label_gain):
            raise ValueError(
                f"Label {int(lab_int.max())} exceeds label_gain size "
                f"{len(self.label_gain)}; set label_gain explicitly")
        lab_int = np.clip(lab_int, 0, None)
        # max DCG@k per query: one stable (qid, -label) sort
        ideal = np.lexsort((-lab_int, qid))
        disc = 1.0 / np.log2(within + 2.0)
        gains = self.label_gain[lab_int[ideal]] * disc \
            * (within < self.optimize_pos_at)
        maxdcg = np.bincount(qid, weights=gains, minlength=nq)
        inv = np.where(maxdcg > 0, 1.0 / np.where(maxdcg > 0, maxdcg, 1.0),
                       0.0)
        self.doc_idx = self._dev(doc_idx)
        self.doc_valid = self._dev(doc_idx >= 0)
        self.q_labels = self._dev(labels.astype(np.int64))
        self.inverse_max_dcgs = self._dev(inv.astype(np.float32))
        self.gains_lut = self._dev(self.label_gain.astype(np.float32))
        # queries per batch: the (batch, Q, Q) intermediates near 256 MB
        self.q_batch = max(1, min(nq, int(2 ** 26 // max(self.q_pad ** 2, 1))
                                  or 1))

    def _lambdas(self, s, labels, valid, inv_max_dcg):
        """Pairwise lambdas of a batch of padded queries
        (`rank_objective.hpp:79-164` GetGradientsForOneQuery); scores,
        labels and valid (B, Q), inv_max_dcg (B,).  Returns per-document
        lambdas and hessians (B, Q), zero on padding."""
        f32 = torch.float32
        s = torch.where(valid, s, float("-inf"))
        order = torch.argsort(-s, dim=1, stable=True)          # pos -> doc
        pos = torch.argsort(order, dim=1, stable=True)         # doc -> pos
        discount = 1.0 / torch.log2(pos.to(f32) + 2.0)
        gains = self.gains_lut[torch.clamp(labels, 0,
                                           len(self.label_gain) - 1)]
        best = torch.where(valid, s, float("-inf")).amax(dim=1)
        worst = torch.where(valid, s, float("inf")).amin(dim=1)
        norm = (best != worst)[:, None, None]

        ds = s[:, :, None] - s[:, None, :]                    # high - low
        delta = (gains[:, :, None] - gains[:, None, :]) \
            * torch.abs(discount[:, :, None] - discount[:, None, :]) \
            * inv_max_dcg[:, None, None]
        delta = torch.where(norm, delta / (0.01 + torch.abs(ds)), delta)
        pair = (labels[:, :, None] > labels[:, None, :]) \
            & valid[:, :, None] & valid[:, None, :]
        pf = pair.to(f32)
        sig = 2.0 / (1.0 + torch.exp((2.0 * self.sigmoid) * ds))
        del ds
        p_lambda = -delta * sig * pf
        p_hessian = sig * (2.0 - sig) * 2.0 * delta * pf
        del delta, sig, pf, pair
        vf = valid.to(f32)
        lam = (p_lambda.sum(dim=2) - p_lambda.sum(dim=1)) * vf
        hes = (p_hessian.sum(dim=2) + p_hessian.sum(dim=1)) * vf
        return lam, hes

    def get_gradients(self, score, class_id=0):
        n_pad = score.shape[0]
        g = torch.zeros(n_pad + 1, dtype=torch.float32, device=score.device)
        h = torch.zeros_like(g)
        for q0 in range(0, self.num_queries, self.q_batch):
            q1 = min(q0 + self.q_batch, self.num_queries)
            didx = self.doc_idx[q0:q1]
            val = self.doc_valid[q0:q1]
            s = score[torch.clamp(didx, 0, n_pad - 1)]
            lam, hes = self._lambdas(s, self.q_labels[q0:q1], val,
                                     self.inverse_max_dcgs[q0:q1])
            # padding documents go to the dropped slot n_pad
            dst = torch.where(val, didx, n_pad).reshape(-1)
            g.index_add_(0, dst, lam.reshape(-1))
            h.index_add_(0, dst, hes.reshape(-1))
        return self._w(g[:n_pad], h[:n_pad])
