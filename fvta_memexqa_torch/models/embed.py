"""Word + char embedding: frozen-GloVe/trainable-OOV word table, char-CNN, highway.

Frozen/trainable split: the full GloVe-initialized table lives in the
device-resident SharedTables (never a parameter); only the small
[1 + num_OOV, D] table is a parameter. Id layout is defined in data/vocab.py.
WordEmbed.full_table joins the whole vocabulary table from contiguous slices
of the two, so only the trainable rows have a gradient path to oov_emb;
WordEmbed.forward looks single tokens up.

Initializers follow the JAX package's distributions (drawn from a
torch.Generator, so the numbers differ); parity runs carry weights across with
convert.py.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fvta_memexqa_torch.data.tokenize import NUM_SPECIAL, UNK_ID


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def dense(in_dim: int, out_dim: int, generator=None) -> nn.Linear:
    """nn.Linear initialized as flax Dense (lecun_normal kernel, zero bias).
    Note the layouts: torch weight is [out, in], flax kernel is [in, out]."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        lecun_normal_(layer.weight, in_dim, generator)
        layer.bias.zero_()
    return layer


class WordEmbed(nn.Module):
    def __init__(self, num_glove: int, vocab_size: int, dim: int, generator=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.boundary = NUM_SPECIAL + num_glove  # frozen rows: [NUM_SPECIAL, boundary)
        self.num_trainable = max(vocab_size - self.boundary + 1, 1)  # UNK + OOV rows
        self.oov_emb = nn.Parameter(
            torch.empty(self.num_trainable, dim).normal_(0.0, 0.1, generator=generator))

    def forward(self, ids: torch.Tensor, frozen_table: torch.Tensor) -> torch.Tensor:
        """ids [...], frozen_table f32 [V, D] (from SharedTables) → [..., D].

        Ids >= vocab_size are EXTENDED ids (eval-time OOV words): their word
        embedding is the UNK row while their chars stay real."""
        ids = ids.long()
        ids = torch.where(ids >= self.vocab_size, UNK_ID, ids)
        is_trainable = (ids == UNK_ID) | (ids >= self.boundary)
        t_id = torch.clamp(torch.where(ids == UNK_ID, 0, ids - self.boundary + 1),
                           0, self.num_trainable - 1)
        f_id = torch.clamp(ids, 0, self.boundary - 1)
        return torch.where(is_trainable[..., None], self.oov_emb[t_id], frozen_table[f_id])

    def full_table(self, frozen_table: torch.Tensor, num_rows: int | None = None) -> torch.Tensor:
        """The complete [num_rows, D] table: forward() of arange(num_rows), bit for
        bit, joined from slices in data/vocab.py's id layout and cut to num_rows:

            frozen_table[:UNK_ID]                   PAD
            oov_emb[:1]                             UNK
            frozen_table[UNK_ID + 1:boundary]       frozen GloVe rows
            oov_emb[1:]                             OOV rows [boundary, vocab_size)
            oov_emb[:1] expanded                    rows >= vocab_size resolve to UNK

        The frozen rows are slices of frozen_table alone, so they have no
        gradient path to oov_emb. The backward is slices of the table's gradient
        and one sum over the extended rows, with no index kernel (forward()'s
        gather maps every frozen row to oov_emb[0], and its backward adds their
        zero gradients into that row one at a time under deterministic
        algorithms)."""
        n = self.vocab_size if num_rows is None else num_rows
        unk, oov = self.oov_emb.split([1, self.num_trainable - 1])
        pieces = [frozen_table[:UNK_ID], unk,
                  frozen_table[UNK_ID + 1:min(self.boundary, self.vocab_size)], oov]
        if n > self.vocab_size:
            pieces.append(unk.expand(n - self.vocab_size, -1))
        table = torch.cat(pieces)
        return table[:n] if n < self.vocab_size else table


class CharCNN(nn.Module):
    """Char embeddings → width-K 1-D conv (VALID) → ReLU → max-pool over word length.

    The conv is im2col + one matmul, so conv_kernel keeps the JAX layout
    [width * emb_dim, num_filters] (window-major) — and stays full float32 on the
    card, where a cuDNN convolution would default to TF32."""

    def __init__(self, char_vocab_size: int, emb_dim: int, num_filters: int, width: int,
                 generator=None):
        super().__init__()
        self.width = width
        self.emb_dim = emb_dim
        self.num_filters = num_filters
        # flax variance_scaling(1.0, "fan_in", "normal", out_axis=0) on [V, E]
        self.char_emb = nn.Parameter(torch.empty(char_vocab_size, emb_dim).normal_(
            0.0, math.sqrt(1.0 / char_vocab_size), generator=generator))
        self.conv_kernel = nn.Parameter(lecun_normal_(
            torch.empty(width * emb_dim, num_filters), width * emb_dim, generator))
        self.conv_bias = nn.Parameter(torch.zeros(num_filters))

    def forward(self, char_ids: torch.Tensor) -> torch.Tensor:
        """char_ids int [..., W] → [..., num_filters]."""
        lead = char_ids.shape[:-1]
        w = char_ids.shape[-1]
        emb = self.char_emb[char_ids.reshape(-1, w).long()]           # [B, W, E]
        n_pos = w - self.width + 1
        wins = torch.cat([emb[:, i : n_pos + i, :] for i in range(self.width)], dim=-1)
        conv = wins.reshape(-1, self.width * self.emb_dim) @ self.conv_kernel
        conv = conv.reshape(-1, n_pos, self.num_filters) + self.conv_bias
        pooled = torch.amax(torch.relu(conv), dim=1)
        return pooled.reshape(*lead, self.num_filters)


class Highway(nn.Module):
    """num_layers of y = g * relu(W_h x) + (1 - g) * x, g = sigmoid(W_t x)."""

    def __init__(self, dim: int, num_layers: int = 2, generator=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"h{i}", dense(dim, dim, generator))
            setattr(self, f"g{i}", dense(dim, dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"h{i}")(x))
            g = torch.sigmoid(getattr(self, f"g{i}")(x))
            x = g * h + (1.0 - g) * x
        return x
