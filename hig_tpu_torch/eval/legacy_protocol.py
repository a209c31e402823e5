"""The legacy Guo-et-al co-embedding evaluation protocol of HumanML3D / KIT
(counterpart of ``hig_tpu/eval/legacy_protocol.py``): caption tokens →
GloVe + POS vectors → ``TextEncoderBiGRUCo``; motions →
``MovementConvEncoder`` → ``MotionEncoderBiGRUCo``; then the matching score
and R-precision over the co-embeddings in batches of 32 (``eval/metrics.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.data.word_vectorizer import POS_DIM, WORD_DIM, WordVectorizer
from hig_tpu_torch.eval import metrics as M
from hig_tpu_torch.models.legacy_evaluators import (
    MotionEncoderBiGRUCo,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
)
from hig_tpu_torch.weights import load_legacy_tree

PROTOCOL_BATCH = 32


def vectorize_tokens(tokens: list[str], max_text_len: int, wv: WordVectorizer):
    """'word/POS' tokens → padded word vectors (max_text_len + 2, 300), POS
    one-hots (max_text_len + 2, 15) and the sentence length with its sos and
    eos tokens."""
    if len(tokens) < max_text_len:
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        sent_len = len(tokens)
        tokens = tokens + ["unk/OTHER"] * (max_text_len + 2 - sent_len)
    else:
        tokens = ["sos/OTHER"] + tokens[:max_text_len] + ["eos/OTHER"]
        sent_len = len(tokens)
    word_embs = np.stack([wv[t][0] for t in tokens]).astype(np.float32)
    pos_ohots = np.stack([wv[t][1] for t in tokens]).astype(np.float32)
    return word_embs, pos_ohots, sent_len


class CoEmbeddingEvaluator:
    """The text and motion co-embedding models at the reference's widths
    (movement latent 512, co-embedding hidden 1024, out 512, unit length 4)
    on ``device``, seeded random weights until :meth:`load_params` installs
    trained (flax) trees."""

    def __init__(self, dim_pose: int, dim_movement_latent: int = 512,
                 dim_coemb_hidden: int = 1024, dim_out: int = 512, unit_length: int = 4,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.unit_length = unit_length
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.movement_enc = MovementConvEncoder(dim_pose - 4, dim_movement_latent,
                                                    dim_movement_latent)
            self.motion_enc = MotionEncoderBiGRUCo(dim_movement_latent, dim_coemb_hidden,
                                                   dim_out)
            self.text_enc = TextEncoderBiGRUCo(WORD_DIM, POS_DIM, dim_coemb_hidden, dim_out)
        for m in self.models():
            m.to(self.device).eval()

    def models(self) -> tuple:
        """(movement encoder, motion encoder, text encoder)."""
        return self.movement_enc, self.motion_enc, self.text_enc

    def load_params(self, movement: dict, motion: dict, text: dict) -> None:
        """Install flax parameter trees of the three models."""
        for m, tree in zip(self.models(), (movement, motion, text)):
            load_legacy_tree(m, tree).to(self.device)

    @torch.no_grad()
    def get_co_embeddings(self, motions, m_lens, word_embs, pos_ohots, cap_lens):
        """(text embeddings, motion embeddings), each (B, dim_out), of
        motions (B, T, dim_pose) with lengths m_lens (B,) and captions as
        :func:`vectorize_tokens` gives them. The batched GRUs take the
        ragged lengths directly, with no re-sorting."""
        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   device=self.device).to(dtype)

        motions = dev(motions)
        movements = self.movement_enc(motions[..., :-4])
        motion_emb = self.motion_enc(movements,
                                     dev(m_lens, torch.int64) // self.unit_length)
        text_emb = self.text_enc(dev(word_embs), dev(pos_ohots), dev(cap_lens, torch.int64))
        return text_emb, motion_emb


def evaluate_matching_and_r_precision(text_embs: np.ndarray, motion_embs: np.ndarray,
                                      top_k: int = 3):
    """The protocol's batches of 32 (a ragged tail is left out): (the mean
    matching score, R-precision at 1..top_k)."""
    n = (len(text_embs) // PROTOCOL_BATCH) * PROTOCOL_BATCH
    match_sum, top_k_count = 0.0, np.zeros(top_k)
    for lo in range(0, n, PROTOCOL_BATCH):
        t = text_embs[lo:lo + PROTOCOL_BATCH]
        m = motion_embs[lo:lo + PROTOCOL_BATCH]
        match_sum += M.calculate_matching_score(t, m, sum_all=True)
        top_k_count += M.calculate_R_precision(t, m, top_k, sum_all=True)
    return match_sum / max(n, 1), top_k_count / max(n, 1)
