"""Plain bi-LSTM with TF1 `BasicLSTMCell` numerics (the kernel's plain version).

Parity-critical semantics:

- gate layout: one [D+H, 4H] kernel, split as wx [D, 4H] and wh [H, 4H], gates in
  TF1 order (i, j, f, o) where j is the candidate; `forget_bias` is added INSIDE
  the cell, not folded into b
- c' = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j);  h' = tanh(c') * sigmoid(o)
- `sequence_length` behaviour of dynamic_rnn: beyond a row's length, outputs are
  zero and the carried state stops updating
- the backward direction is reverse_sequence → scan → reverse_sequence, as a
  length-aware flip (padding stays at the back, where the no-update rule makes
  it a no-op)

`torch.nn.LSTM` is not this function: its gate order is (i, f, g, o) and it has
no in-cell forget bias.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LSTMParams(NamedTuple):
    wx: torch.Tensor  # [D, 4H] input kernel
    wh: torch.Tensor  # [H, 4H] recurrent kernel
    b: torch.Tensor   # [4H]


def lstm_cell(x_proj_t, h, c, wh, forget_bias: float):
    """x_proj_t [N, 4H] = x_t @ wx + b; h, c [N, H] → (h', c')."""
    gates = x_proj_t + h @ wh
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, new_c


def lstm_scan_ref(params: LSTMParams, x: torch.Tensor, mask: torch.Tensor,
                  forget_bias: float = 1.0, cells: list | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unidirectional scan over x [N, T, D], mask bool [N, T].
    Returns (outputs [N, T, H], final_h [N, H]); appends each step's carried c
    [N, H] to `cells` when one is given."""
    n, t, _ = x.shape
    hdim = params.wh.shape[0]
    x_proj = x @ params.wx + params.b                      # [N, T, 4H]
    m = mask.to(x_proj.dtype)[..., None]                   # [N, T, 1]
    h = x.new_zeros(n, hdim)
    c = x.new_zeros(n, hdim)
    outs = []
    for step in range(t):
        nh, nc = lstm_cell(x_proj[:, step], h, c, params.wh, forget_bias)
        m_t = m[:, step]
        h = m_t * nh + (1.0 - m_t) * h
        c = m_t * nc + (1.0 - m_t) * c
        outs.append(m_t * nh)                              # zero at padded steps
        if cells is not None:
            cells.append(c)
    out = torch.stack(outs, dim=1) if outs else x.new_zeros(n, 0, hdim)
    return out, h


def _flip_to_front(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """reverse_sequence: reverse the first `length` elements of dim 1 per row
    (t → length-1-t for t < length, identity on the padded tail)."""
    n, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)[None, :]
    ln = lengths.to(pos.dtype)[:, None]
    src = torch.where(pos < ln, ln - 1 - pos, pos)         # [N, T]
    idx = src.reshape(n, t, *([1] * (x.ndim - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


def bilstm_ref(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
               mask: torch.Tensor, forget_bias: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional encode. Returns (outputs [N, T, 2H], final_state [N, 2H]):
    final_state = [fw final h; bw final h], TF1's (output_state_fw,
    output_state_bw).h concatenated."""
    lengths = mask.sum(dim=1)
    out_fw, h_fw = lstm_scan_ref(params_fw, x, mask, forget_bias)
    x_rev = _flip_to_front(x, lengths)
    out_bw_rev, h_bw = lstm_scan_ref(params_bw, x_rev, mask, forget_bias)
    out_bw = _flip_to_front(out_bw_rev, lengths)
    return torch.cat([out_fw, out_bw], dim=-1), torch.cat([h_fw, h_bw], dim=-1)


def bilstm_cells_ref(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                     mask: torch.Tensor, forget_bias: float = 1.0) -> torch.Tensor:
    """The carried cell state of every step, [N, T, 2H], in the layout of the
    fused kernel's training output: the backward direction flipped back to the
    original positions (past a row's length: the carried c at position t)."""
    lengths = mask.sum(dim=1)
    c_fw, c_bw = [], []
    lstm_scan_ref(params_fw, x, mask, forget_bias, c_fw)
    lstm_scan_ref(params_bw, _flip_to_front(x, lengths), mask, forget_bias, c_bw)
    return torch.cat([torch.stack(c_fw, dim=1),
                      _flip_to_front(torch.stack(c_bw, dim=1), lengths)], dim=-1)


def bilstm_gates_ref(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                     mask: torch.Tensor, forget_bias: float = 1.0) -> torch.Tensor:
    """The gate pre-activations x_t . wx + b + h_{t-1} . wh of every valid step,
    [N, T, 8H] (forward direction's (i, j, f, o) in [:4H], backward's in [4H:],
    both at the original positions, as the fused recurrence saves them under
    grad); 0 past each row's length. h_{t-1} is the forward output one position
    earlier and the backward output one position later (0 at a row's ends)."""
    out, _ = bilstm_ref(params_fw, params_bw, x, mask, forget_bias)
    h = params_fw.wh.shape[0]
    zero = out.new_zeros(out.shape[0], 1, h)
    h_prev = (torch.cat([zero, out[:, :-1, :h]], dim=1), torch.cat([out[:, 1:, h:], zero], dim=1))
    gates = [x @ p.wx + p.b + hp @ p.wh for p, hp in zip((params_fw, params_bw), h_prev)]
    return torch.cat(gates, dim=-1) * mask[..., None].to(x.dtype)
