"""LSTM stack and stepwise RNN language model (counterpart of
``lasr_tpu/modules/rnn.py``).

  - ``LSTMStack``: batch-first multi-layer LSTM, optionally
    bidirectional (each direction runs over the whole padded sequence
    from a zero carry, as Flax's ``nn.RNN`` does), dropout between layers
    in training.
  - ``RNNCellStack``: the RNN language model over LSTM or GRU cells; its
    one-step ``forward(state, x)`` / ``forward_onehot`` is the ``predict``
    contract the decoders consume (``RNNLM``).

Cells are ``nn.LSTMCell`` / ``nn.GRUCell`` in torch's gate order
(i, f, g, o) / (r, z, n); ``utils.weights.rnnlm_flax_to_state_dict``
carries Flax's per-gate kernels across.  The state of a stack is a tuple
over layers of ``(c, h)`` (LSTM, Flax's carry order) or ``h`` (GRU),
each (N, n_units); ``select_state`` reorders its rows, as the beam
search reorders its KV cache by parent.

Compute dtype (``dtype``: float32 or bfloat16), where ``lasr_tpu``'s Flax
modules round: ``RNNCellStack``'s input layer and output projection are
the casting layers of ``modules.layers`` (``nn.Embed`` / ``nn.Dense``
with ``dtype``), its zero state is in the compute dtype, and its cells,
which Flax builds without a dtype, compute in float32 (the bfloat16
input and state promoted exactly), so the state after a step is float32.
``LSTMStack``'s cells take no dtype in Flax either: it computes in
float32 whatever its ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.models.e2e_ctc_att import check_dtype
from lasr_tpu_torch.modules.dropout import dropout
from lasr_tpu_torch.modules.layers import Embedding, Linear, set_compute_dtype


class LSTMStack(nn.Module):
    """x (B, T, input_size) → (B, T, hidden [×2 if bidirectional])."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 dropout: float = 0.0, bidirectional: bool = False,
                 dtype=None, device=None):
        super().__init__()
        check_dtype(dtype)
        width = 2 * hidden_size if bidirectional else hidden_size
        self.layers = nn.ModuleList([
            nn.LSTM(input_size if i == 0 else width, hidden_size,
                    batch_first=True, bidirectional=bidirectional)
            for i in range(num_layers)])
        self.dropout_rate = dropout
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        h = x.float()
        for i, layer in enumerate(self.layers):
            h = layer(h)[0]
            if i + 1 < len(self.layers):
                h = dropout(h, self.dropout_rate, self.training)
        return h


def select_state(state, idx):
    """The rows ``idx`` of every tensor of a stack's state."""
    if torch.is_tensor(state):
        return state.index_select(0, idx)
    return tuple(select_state(s, idx) for s in state)


class RNNCellStack(nn.Module):
    """Stepwise RNN LM over LSTM/GRU cells.  ``dtype``: the compute dtype
    of the input layer and the output projection (see the module
    docstring).  ``device=None`` means CUDA (raises without a GPU)."""

    def __init__(self, input_dim: int, output_dim: int, n_layers: int,
                 n_units: int, typ: str = "lstm", input_layer: str = "embed",
                 dropout_rate: float = 0.5, dtype=None, device=None):
        super().__init__()
        dtype = check_dtype(dtype)
        if typ not in ("lstm", "gru"):
            raise ValueError(f"unknown RNN type {typ!r}")
        self.typ, self.input_layer = typ, input_layer
        self.n_units, self.dropout_rate = n_units, dropout_rate
        if input_layer == "embed":
            self.embed = Embedding(input_dim, n_units)
        else:
            self.embed = Linear(input_dim, n_units)
        cell = nn.LSTMCell if typ == "lstm" else nn.GRUCell
        self.rnn = nn.ModuleList([cell(n_units, n_units)
                                  for _ in range(n_layers)])
        self.lo = Linear(n_units, output_dim)
        set_compute_dtype(self, dtype)
        self.to(resolve_device(device))
        self.eval()

    def zero_state(self, batch: int):
        h = self.lo.weight.new_zeros(batch, self.n_units, dtype=self.lo.dtype)
        return tuple((h, h) if self.typ == "lstm" else h for _ in self.rnn)

    def _cells(self, state, h):
        new_state = []
        h = h.float()
        for i, cell in enumerate(self.rnn):
            h = dropout(h, self.dropout_rate, self.training)
            if self.typ == "lstm":
                c_prev, h_prev = state[i]
                h, c = cell(h, (h_prev.float(), c_prev.float()))
                new_state.append((c, h))
            else:
                h = cell(h, state[i].float())
                new_state.append(h)
        h = dropout(h, self.dropout_rate, self.training)
        return tuple(new_state), self.lo(h)

    def forward(self, state, x):
        """One step: x (B,) token ids (or (B, input_dim) when
        ``input_layer='linear'``) → (new_state, logits (B, output_dim))."""
        if state is None:
            state = self.zero_state(x.shape[0])
        if self.input_layer == "embed":
            x = x.long()
        return self._cells(state, self.embed(x))

    def forward_onehot(self, state, x):
        """x: (B, V) soft one-hot over the embedding table."""
        if self.input_layer != "embed":
            raise ValueError("forward_onehot needs input_layer='embed'")
        if state is None:
            state = self.zero_state(x.shape[0])
        return self._cells(state, x @ self.embed.weight)

    def score_sequence(self, tokens):
        """Teacher-forced LM logits over a whole (B, L) id sequence →
        (B, L, V)."""
        state = self.zero_state(tokens.shape[0])
        ys = []
        for t in range(tokens.shape[1]):
            state, y = self(state, tokens[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1)


class RNNLM:
    """The decoders' ``predict`` contract over a ``RNNCellStack``:
    ``state, log_probs = lm.predict(tokens, state)``; tokens are ids (a
    tensor or a numpy array), log_probs float32 on the module's device."""

    def __init__(self, module: RNNCellStack):
        self.module = module

    @torch.no_grad()
    def predict(self, tokens, state):
        dev = self.module.lo.weight.device
        if not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.asarray(tokens))
        new_state, logits = self.module(state, tokens.to(dev))
        # in the logits' dtype, as lasr_tpu's predict takes it
        return new_state, torch.log_softmax(logits, dim=-1).float()
