"""Bi-encoder retrieval model, the ICT / REALM / ORQA lineage (mirror of
``megatron_llm_tpu/models/biencoder.py``).

Reference parity: megatron/model/biencoder_model.py (query and context
BERT towers, optionally shared), the ICT objective (an in-batch softmax
over query · context scores) and megatron/indexer.py's retrieval by inner
product.  Both towers are the BERT trunk of ``models/encdec.py``
(``bert_encode``: a non-causal stack over pad segments, so the flash
kernels where ``attention_impl="flash"``).  Sharing is structural, as in
JAX: a shared model has no ``context`` subtree.  ``DenseIndex``'s corpus ·
query product is one large matrix product, left to ``torch.matmul``.
``biencoder_param_specs`` (JAX ``biencoder.py:209``) lays the towers out
as ``encdec.bert_param_specs`` does; under data parallelism the ICT loss
scores each rank's queries against the contexts of the whole global
batch (``mappings.gather_from_data_region``), as JAX's in-batch softmax
over the global batch does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import dropout as drop
from ..parallel import mappings
from ..parallel.mesh import axis_info
from . import encdec
from .transformer import Params, _normal


def init_biencoder_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                          projection_dim: int = 0, shared: bool = False,
                          tp: int = 1) -> Params:
    """Query and context towers (BERT trunks without the MLM and NSP
    heads), and with ``projection_dim`` > 0 the REALM projection head;
    drawn on ``device`` (default ``cuda``) from ``seed``."""
    gen, device = encdec._generator(seed, device)

    def tower():
        t = encdec._init_bert(cfg, gen, device, tp)
        t.pop("lm_head")
        t.pop("binary_head")
        return t

    params: Params = {"query": tower()}
    if not shared:
        params["context"] = tower()
    if projection_dim:
        shape = (cfg.hidden_size, projection_dim)
        params["projection"] = {
            "q": _normal(shape, cfg.init_method_std, cfg.dtype, gen, device)}
        if not shared:
            params["projection"]["c"] = _normal(
                shape, cfg.init_method_std, cfg.dtype, gen, device)
    return params


def context_tower(params: Params) -> Params:
    return params.get("context", params["query"])


def _context_proj(params: Params):
    proj = params.get("projection")
    if proj is None:
        return None
    return proj.get("c", proj["q"])


def embed_text(cfg: ModelConfig, tower: Params, tokens: torch.Tensor,
               pad_mask: torch.Tensor, proj: Optional[torch.Tensor] = None,
               rng=None, deterministic: bool = True,
               pooling: str = "cls") -> torch.Tensor:
    """→ ``[b, dim]`` embeddings, projected when ``proj`` is given.
    ``pooling="cls"`` takes the pooled [CLS] output (the reference's);
    ``"mean"`` the content-masked mean of the final hidden states."""
    x, pooled = encdec.bert_encode(cfg, tower, tokens, pad_mask,
                                   rng=rng, deterministic=deterministic)
    if pooling == "mean":
        # an fp32 mask promotes the mean to fp32, as in JAX
        w = pad_mask[..., None].float()
        pooled = torch.sum(x * w, dim=1) / torch.clamp(
            torch.sum(w, dim=1), min=1.0)
    if proj is not None:
        pooled = pooled @ proj.to(pooled.dtype)
    return pooled


def biencoder_forward(cfg: ModelConfig, params: Params,
                      query_tokens, query_pad_mask,
                      context_tokens, context_pad_mask,
                      rng=None, deterministic: bool = True,
                      pooling: str = "cls"):
    """→ ``(query_embeds [b, d], context_embeds [b, d])``."""
    qr = cr = None
    if rng is not None:
        qr, cr = drop.split(rng)
    proj = params.get("projection")
    q = embed_text(cfg, params["query"], query_tokens, query_pad_mask,
                   None if proj is None else proj["q"], qr, deterministic,
                   pooling)
    c = embed_text(cfg, context_tower(params), context_tokens,
                   context_pad_mask, _context_proj(params), cr,
                   deterministic, pooling)
    return q, c


def retrieval_scores(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[b, b]`` fp32 query · context scores."""
    return q.float() @ c.float().T


def retrieval_loss(cfg: ModelConfig, params: Params, batch: dict,
                   rng=None, deterministic: bool = True,
                   pooling: str = "cls"):
    """The in-batch-negative softmax loss (the ICT objective): row i's
    query must score its own context above every other in the batch."""
    q, c = biencoder_forward(
        cfg, params, batch["query_tokens"], batch["query_pad_mask"],
        batch["context_tokens"], batch["context_pad_mask"],
        rng, deterministic, pooling)
    group, dp, index = axis_info("dp")
    c = mappings.gather_from_data_region(c, group)
    scores = retrieval_scores(q, c)
    logp = torch.log_softmax(scores, dim=-1)
    return -torch.mean(torch.diagonal(logp, offset=index * q.shape[0]))


def retrieval_accuracy(scores: torch.Tensor) -> torch.Tensor:
    """The share of in-batch queries that rank their own context first."""
    rows = torch.arange(scores.shape[0], device=scores.device)
    return torch.mean((torch.argmax(scores, dim=-1) == rows).float())


# ---------------------------------------------------------------------------
# Dense index (reference: megatron/indexer.py IndexBuilder and the
# exact retrieval of tasks/orqa: a corpus · query product is the index)
# ---------------------------------------------------------------------------


def embed_batches(cfg: ModelConfig, tower: Params, tokens: np.ndarray,
                  pad_mask: np.ndarray, proj, batch_size: int,
                  pooling: str = "cls") -> np.ndarray:
    """Embed host rows in batches of ``batch_size`` on the tower's device
    (no grad) → fp32 numpy ``[n, dim]``."""
    device = tower["embedding"]["word"].device
    out = []
    with torch.no_grad():
        for i in range(0, len(tokens), batch_size):
            t = torch.as_tensor(np.asarray(tokens[i:i + batch_size]),
                                dtype=torch.long, device=device)
            m = torch.as_tensor(np.asarray(pad_mask[i:i + batch_size]),
                                dtype=torch.float32, device=device)
            e = embed_text(cfg, tower, t, m, proj, pooling=pooling)
            out.append(e.float().cpu().numpy())
    return np.concatenate(out)


class DenseIndex:
    """Embed a corpus of blocks once; retrieve by top-k inner product."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 batch_size: int = 64, pooling: str = "cls"):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.pooling = pooling
        self._embeds: Optional[np.ndarray] = None
        proj = params.get("projection")
        self._proj_c = _context_proj(params)
        self._proj_q = None if proj is None else proj["q"]

    def _embed(self, tower, tokens, pad_mask, proj) -> np.ndarray:
        return embed_batches(self.cfg, tower, tokens, pad_mask, proj,
                             self.batch_size, self.pooling)

    def build(self, blocks) -> np.ndarray:
        """``blocks``: a dataset of ``{tokens, pad_mask}`` dicts."""
        tokens = np.stack([blocks[j]["tokens"] for j in range(len(blocks))])
        masks = np.stack([blocks[j]["pad_mask"] for j in range(len(blocks))])
        self._embeds = self._embed(context_tower(self.params), tokens, masks,
                                   self._proj_c)
        return self._embeds

    def retrieve(self, query_tokens: np.ndarray, query_pad_mask: np.ndarray,
                 top_k: int = 5):
        """→ ``(indices [b, k], scores [b, k])`` over the built corpus."""
        assert self._embeds is not None, "call build() first"
        q = self._embed(self.params["query"], np.asarray(query_tokens),
                        np.asarray(query_pad_mask), self._proj_q)
        scores = q @ self._embeds.T  # [b, n]
        k = min(top_k, scores.shape[-1])
        part = np.argpartition(-scores, k - 1, axis=-1)[:, :k]
        part_scores = np.take_along_axis(scores, part, axis=-1)
        order = np.argsort(-part_scores, axis=-1)
        idx = np.take_along_axis(part, order, axis=-1)
        return idx, np.take_along_axis(scores, idx, axis=-1)


def biencoder_param_specs(cfg: ModelConfig, parallel,
                          projection_dim: int = 0,
                          shared: bool = False) -> Params:
    """Specs of ``init_biencoder_params``: each tower a BERT trunk
    (``encdec.bert_param_specs`` without the MLM and NSP heads); the
    projection heads replicated."""
    from .sharding import P

    def tower_specs():
        t = encdec.bert_param_specs(cfg, parallel)
        t.pop("lm_head")
        t.pop("binary_head")
        return t

    specs: Params = {"query": tower_specs()}
    if not shared:
        specs["context"] = tower_specs()
    if projection_dim:
        specs["projection"] = {"q": P(None, None)}
        if not shared:
            specs["projection"]["c"] = P(None, None)
    return specs
