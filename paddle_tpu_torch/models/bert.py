"""BERT (counterpart: ``paddle_tpu/models/bert.py`` ``BertConfig``,
``bert_base``, ``BertEmbeddings``, ``BertModel``, ``BertForPretraining``,
``pack_sequences``, ``bert_pretrain_loss``).

The layers are the port's ``nn`` layers, with the JAX package's parameter
names, so a JAX ``functional_train_graph`` tree loads by name
(``models/convert.py`` ``load_params``). On the card every LayerNorm runs the
LayerNorm kernels and the attention runs the flash kernels, with the packed
rows' segment ids and the attention dropout inside them.

Training, as ``benchmarks/configs_bench.py`` ``bench_bert_packed`` runs it:
``params, _, buffers = functional_train_graph(model)`` (on the card by
default), the >= 2-D parameters cast to bf16, then per step
``functional_call(model, params, buffers, ids, pack_segment_ids=seg,
position_ids=pos)``, ``bert_pretrain_loss``, ``torch.autograd.grad`` and
``AdamW.apply``; ``bench_bert_base``'s padded form passes
``attention_mask=`` the 4-D bool mask ``valid[:, None, None, :] &
valid[:, None, :, None]`` instead of the packing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..enforce import enforce
from .. import nn
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "bert_base", "bert_pretrain_loss", "pack_sequences"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    layer_norm_eps: float = 1e-12


def bert_base(**kw):
    return BertConfig(**kw)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        S = input_ids.shape[1]
        pos = (torch.arange(S, device=input_ids.device)[None, :]
               if position_ids is None else position_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            normalize_before=False)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                pack_segment_ids=None, position_ids=None):
        """``pack_segment_ids``: int [B, S] ids of the sequences packed into
        a row (pads -1); pass ``position_ids`` that restart at each
        sequence. A 2-D padding ``attention_mask`` becomes segment ids
        (valid 0, pad -1), as in the JAX package: valid positions never see
        pads, pad queries see only pads; with ``pack_segment_ids`` it
        becomes an additive ``[B, 1, 1, S]`` mask beside the segments. A
        4-D mask goes to the attention as it is (``bench_bert_base``'s
        padded layout): on the card the flash kernels take it as their
        bias, forward and backward, with the attention dropout inside
        them; a query row it masks whole gives zeros and no gradient."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if (attention_mask is not None and attention_mask.dim() == 2
                and pack_segment_ids is None):
            pack_segment_ids = torch.where(attention_mask > 0, 0, -1).to(
                torch.int32)
            attention_mask = None
        elif attention_mask is not None and attention_mask.dim() == 2:
            attention_mask = torch.where(
                attention_mask[:, None, None, :] > 0, 0.0, -1e30)
        seq = self.encoder(x, src_mask=attention_mask,
                           segment_ids=pack_segment_ids)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps)
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.nsp_head = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                pack_segment_ids=None, position_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                pack_segment_ids=pack_segment_ids,
                                position_ids=position_ids)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq), approximate=True))
        return self.mlm_head(h), self.nsp_head(pooled)


def pack_sequences(seqs, seq_len: int, pad_id: int = 0):
    """Greedy first-fit packing of token sequences into [rows, seq_len]
    (numpy, the JAX package's outputs exactly): (input_ids,
    pack_segment_ids, position_ids, row_of_seq, offset_of_seq); each
    sequence gets an id distinct within its row, pad tails -1, positions
    restarting at 0 per sequence."""
    rows, row_lens = [], []
    row_of_seq, offset_of_seq = [], []
    for s in seqs:
        L = len(s)
        enforce(L <= seq_len, f"sequence of {L} tokens exceeds row {seq_len}",
                op="bert.pack_sequences")
        for r in range(len(rows)):
            if row_lens[r] + L <= seq_len:
                break
        else:
            rows.append([])
            row_lens.append(0)
            r = len(rows) - 1
        row_of_seq.append(r)
        offset_of_seq.append(row_lens[r])
        rows[r].append(np.asarray(s))
        row_lens[r] += L

    B = len(rows)
    ids = np.full((B, seq_len), pad_id, dtype=np.int32)
    seg = np.full((B, seq_len), -1, dtype=np.int32)
    pos = np.zeros((B, seq_len), dtype=np.int32)
    for r, chunks in enumerate(rows):
        off = 0
        for i, c in enumerate(chunks):
            ids[r, off:off + len(c)] = c
            seg[r, off:off + len(c)] = i
            pos[r, off:off + len(c)] = np.arange(len(c))
            off += len(c)
    return ids, seg, pos, row_of_seq, offset_of_seq


def bert_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                       ignore_index: int = -100):
    """Masked-LM cross entropy over the labelled positions plus the
    next-sentence cross entropy."""
    mlm = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=ignore_index,
                          reduction="mean")
    nsp = F.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return mlm + nsp
