"""The legacy Guo-et-al text-to-motion evaluator zoo of the HumanML3D / KIT
protocol (counterpart of ``hig_tpu/models/legacy_evaluators.py``): the
BiGRU text and motion co-embedding models behind R-precision and the
matching score, the movement convolution auto-encoder, the VAE text
decoders, the word-attention layer and the motion-length estimator.

The GRUs keep torch's ``pack_padded_sequence`` semantics as the JAX package
writes them, with masked steps: a sequence's hidden state freezes once its
valid length is exhausted, and the backward direction runs over each
sequence's valid region reversed (:func:`_flip_valid`). A cell is flax's
``GRUCell`` in torch's gate layout (r, z, n): ``weight_ih`` (3H, D) and
``bias_ih`` carry flax's ``ir``, ``iz``, ``in``; ``weight_hh`` carries
``hr``, ``hz``, ``hn``, and ``bias_hh`` is (0, 0, ``hn``'s bias), since
flax's ``hr`` and ``hz`` have none (``weights.load_legacy_tree`` maps a
flax tree). No kernel of the port runs here: the input projections are one
product over every step, each step one product and the gate arithmetic.

Module and parameter names follow the flax trees' (``pos_emb``,
``input_emb``, ``gru.fwd``, the head's ``Dense_0``, ``LayerNorm_0``, ...),
so the bridge maps them one to one. Every LayerNorm has flax's epsilon,
1e-6. Draws (:func:`reparameterize`, :class:`TextDecoder`) are taken as
arguments or from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax's LayerNorm default


def contrastive_loss(output1, output2, label, margin: float = 3.0):
    """The co-embedding's contrastive loss."""
    dist = torch.linalg.vector_norm(output1 - output2, dim=-1)
    return ((1 - label) * dist ** 2 + label * torch.clamp(margin - dist, min=0.0) ** 2).mean()


def reparameterize(mu, logvar, noise=None, generator: torch.Generator | None = None):
    """mu + exp(logvar / 2)·noise; ``noise`` like mu, else drawn from
    ``generator``."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * noise


def positional_encoding_table(d_model: int, max_len: int = 300) -> torch.Tensor:
    """The sinusoidal table (max_len, d_model)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def _flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each (B, T, D) sequence within its valid length."""
    t = torch.arange(x.shape[1], device=x.device)
    lengths = lengths.to(x.device)[:, None]
    idx = torch.where(t[None, :] < lengths, lengths - 1 - t[None, :], t[None, :])
    return torch.take_along_dim(x, idx[..., None], dim=1)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


@contextlib.contextmanager
def _float32_convolutions():
    """cuDNN's convolutions without TF32 (torch's default lets cuDNN take
    TF32, ~1e-3 relative), so float32 products stay float32 as the port's
    matrix products do; the caller's setting is restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class GRUCell(nn.Module):
    """flax's GRUCell in torch's layout (module doc)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(3 * hidden_size))
        nn.init.normal_(self.weight_ih, std=input_size ** -0.5)
        nn.init.orthogonal_(self.weight_hh)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input's share of the three gates, (..., 3H)."""
        return F.linear(x, self.weight_ih, self.bias_ih)

    def step(self, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The next hidden state from the input share ``gi`` and ``h``."""
        gh = F.linear(h, self.weight_hh, self.bias_hh)
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1 - z) * n + z * h

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.step(self.project(x), h)


class MaskedGRU(nn.Module):
    """A unidirectional GRU over (B, T, D) whose finished sequences keep
    their last state. Returns (states (B, T, H), last (B, H))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.cell = GRUCell(input_size, hidden_size)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor):
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths.to(x.device)[:, None]).to(x.dtype)
        gi = self.cell.project(x)
        h, seq = h0, []
        for t in range(T):
            m = mask[:, t, None]
            h = m * self.cell.step(gi[:, t], h) + (1 - m) * h
            seq.append(h)
        return torch.stack(seq, dim=1), h


class BiGRU(nn.Module):
    """Bidirectional masked GRU with learned initial states ``hidden`` (2,
    1, H). Returns (states (B, T, 2H), the backward half in forward time
    order, last (B, 2H))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))
        self.fwd = MaskedGRU(input_size, hidden_size)
        self.bwd = MaskedGRU(input_size, hidden_size)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B = x.shape[0]
        fwd_seq, fwd_last = self.fwd(x, lengths, self.hidden[0].expand(B, -1))
        bwd_seq, bwd_last = self.bwd(_flip_valid(x, lengths), lengths,
                                     self.hidden[1].expand(B, -1))
        seq = torch.cat([fwd_seq, _flip_valid(bwd_seq, lengths)], dim=-1)
        return seq, torch.cat([fwd_last, bwd_last], dim=-1)


class _Head(nn.Module):
    """Dense → LayerNorm → leaky ReLU (0.2) per hidden width, then a Dense,
    named as flax names them in the parent's scope (``Dense_i``,
    ``LayerNorm_i``)."""

    def __init__(self, in_features: int, features: list[int]):
        super().__init__()
        self.depth = len(features) - 1
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", nn.Linear(in_features, f))
            if i < self.depth:
                setattr(self, f"LayerNorm_{i}", nn.LayerNorm(f, eps=LN_EPS))
            in_features = f

    def forward(self, x):
        for i in range(self.depth):
            x = _leaky(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.depth}")(x)


class _TextEmbedding(nn.Module):
    """pos_emb(POS one-hot) added to the word vectors, then input_emb."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)

    def embed(self, word_embs, pos_onehot):
        return self.input_emb(word_embs + self.pos_emb(pos_onehot))


class TextEncoderBiGRU(_TextEmbedding):
    """Word vectors and POS one-hots (B, L, ·), lengths (B,) → the BiGRU's
    (states, last)."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int):
        super().__init__(word_size, pos_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)

    def forward(self, word_embs, pos_onehot, cap_lens):
        return self.gru(self.embed(word_embs, pos_onehot), cap_lens)


class TextEncoderBiGRUCo(_TextEmbedding):
    """The text side of the co-embedding: (B, L, ·) → (B, output_size)."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int, output_size: int):
        super().__init__(word_size, pos_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)
        self.head = _Head(2 * hidden_size, [hidden_size, output_size])

    def forward(self, word_embs, pos_onehot, cap_lens):
        _, last = self.gru(self.embed(word_embs, pos_onehot), cap_lens)
        return self.head(last)


class MotionEncoderBiGRUCo(nn.Module):
    """The motion side of the co-embedding: movements (B, T', D), lengths
    (B,) in movement units → (B, output_size)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)
        self.head = _Head(2 * hidden_size, [hidden_size, output_size])

    def forward(self, inputs, m_lens):
        _, last = self.gru(self.input_emb(inputs), m_lens)
        return self.head(last)


class MotionLenEstimatorBiGRU(_TextEmbedding):
    """Text → logits over motion lengths."""

    def __init__(self, word_size: int, pos_size: int, hidden_size: int, output_size: int):
        super().__init__(word_size, pos_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)
        nd = 512
        self.head = _Head(2 * hidden_size, [nd, nd // 2, nd // 4, output_size])

    def forward(self, word_embs, pos_onehot, cap_lens):
        _, last = self.gru(self.embed(word_embs, pos_onehot), cap_lens)
        return self.head(last)


class AttLayer(nn.Module):
    """Word-level attention: query (B, Q), key_mat (B, L, K) → (the
    attended values (B, V), the weights (B, L, 1))."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int):
        super().__init__()
        self.value_dim = value_dim
        self.W_q = nn.Linear(query_dim, value_dim)
        self.W_v = nn.Linear(key_dim, value_dim)
        self.W_k = nn.Linear(key_dim, value_dim, bias=False)

    def forward(self, query, key_mat):
        q = self.W_q(query)[..., None]
        weights = (self.W_k(key_mat) @ q) / math.sqrt(self.value_dim)
        co = torch.softmax(weights, dim=1)
        return (self.W_v(key_mat) * co).sum(dim=1), co


class MovementConvEncoder(nn.Module):
    """Two strided temporal convolutions (kernel 4, stride 2, padding 1)
    and a Dense: (B, T, D) → (B, T // 4, output_size). Its dropout is off,
    as in every JAX call of it."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(input_size, hidden_size, 4, stride=2, padding=1)
        self.Conv_1 = nn.Conv1d(hidden_size, output_size, 4, stride=2, padding=1)
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x):
        with _float32_convolutions():
            x = _leaky(self.Conv_0(x.transpose(1, 2)))
            x = _leaky(self.Conv_1(x))
        return self.out_net(x.transpose(1, 2))


class MovementConvDecoder(nn.Module):
    """Two transposed convolutions, each an exact 2× temporal upsampling
    (flax's "SAME" padding), and a Dense: (B, T, D) → (B, 4T, output_size)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose1d(input_size, hidden_size, 4, stride=2,
                                                  padding=1)
        self.ConvTranspose_1 = nn.ConvTranspose1d(hidden_size, output_size, 4, stride=2,
                                                  padding=1)
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x):
        with _float32_convolutions():
            x = _leaky(self.ConvTranspose_0(x.transpose(1, 2)))
            x = _leaky(self.ConvTranspose_1(x))
        return self.out_net(x.transpose(1, 2))


class _GRUDecoder(nn.Module):
    """The shared trunk of the VAE decoders: emb (Dense, LayerNorm, leaky
    ReLU) plus the position's encoding, through a stack of GRU cells."""

    def __init__(self, text_size: int, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.n_layers = n_layers
        self.emb = nn.Sequential(nn.Linear(input_size, hidden_size),
                                 nn.LayerNorm(hidden_size, eps=LN_EPS), nn.LeakyReLU(0.2))
        self.z2init = nn.Linear(text_size, hidden_size * n_layers)
        self.grus = nn.ModuleList(GRUCell(hidden_size, hidden_size) for _ in range(n_layers))
        self.register_buffer("pe", positional_encoding_table(hidden_size), persistent=False)

    def get_init_hidden(self, latent):
        return list(self.z2init(latent).chunk(self.n_layers, dim=-1))

    def trunk(self, inputs, hidden, p: int):
        h_in = self.emb(inputs) + self.pe[p]
        new_hidden = []
        for cell, h in zip(self.grus, hidden):
            h_in = cell(h, h_in)
            new_hidden.append(h_in)
        return h_in, new_hidden


class TextVAEDecoder(_GRUDecoder):
    """The autoregressive motion decoder: one step (inputs (B, input_size),
    hidden list, position p) → (pose (B, output_size), hidden list)."""

    def __init__(self, text_size: int, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.output = nn.Sequential(nn.Linear(hidden_size, hidden_size),
                                    nn.LayerNorm(hidden_size, eps=LN_EPS), nn.LeakyReLU(0.2),
                                    nn.Linear(hidden_size, output_size))

    def forward(self, inputs, hidden, p: int):
        h, new_hidden = self.trunk(inputs, hidden, p)
        return self.output(h), new_hidden


class TextDecoder(_GRUDecoder):
    """The VAE text decoder head: one step → (z, mu, logvar, hidden list),
    z drawn with ``noise`` or from ``generator``."""

    def __init__(self, text_size: int, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.mu_net = nn.Linear(hidden_size, output_size)
        self.logvar_net = nn.Linear(hidden_size, output_size)

    def forward(self, inputs, hidden, p: int, noise=None, generator=None):
        h, new_hidden = self.trunk(inputs, hidden, p)
        mu, logvar = self.mu_net(h), self.logvar_net(h)
        return reparameterize(mu, logvar, noise, generator), mu, logvar, new_hidden
