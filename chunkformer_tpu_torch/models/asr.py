"""Hybrid CTC/AED ASR model: encoder, CTC head and, when the config names
one, the attention decoder (counterpart of ``chunkformer_tpu/models/asr.py``).

Parameter names are the reference state-dict names (``encoder.*``,
``ctc.ctc_lo.*``, ``decoder.left_decoder.*``, ``decoder.right_decoder.*``;
``chunkformer_tpu/export.py:51`` lists them), so an exported
``pytorch_model.bin`` loads with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ChunkFormerConfig
from ..nn.attention import RelPositionMultiHeadedAttention
from ..nn.decoder import BiTransformerDecoder
from ..nn.encoder import ChunkFormerEncoder
from ..nn.layers import LSTMWeights
from ..parallel.row_shard import gather_rows


class CTC(nn.Module):
    """Linear projection to the vocabulary (reference: modules/ctc.py:23-49)."""

    def __init__(self, encoder_dim: int, vocab_size: int):
        super().__init__()
        self.ctc_lo = nn.Linear(encoder_dim, vocab_size)

    def argmax(self, encoder_out: torch.Tensor) -> torch.Tensor:
        """Greedy frame tokens (reference: modules/ctc.py:83-91)."""
        return self.ctc_lo(encoder_out).argmax(dim=-1)

    def gathered_argmax(self, encoder_out: torch.Tensor, group) -> torch.Tensor:
        """Greedy frame tokens of this rank's chunk rows encoder_out
        [n_local, c, D], then every rank's [N, c] in global row order, on
        every rank of ``group`` (``parallel/row_shard.py``). The caller trims
        each utterance's frames with ``out_lens``, as after ``argmax`` of
        the whole batch."""
        return gather_rows(self.argmax(encoder_out), group)


class ASRModel(nn.Module):
    def __init__(self, config: ChunkFormerConfig, cmvn: bool = True):
        super().__init__()
        self.encoder = ChunkFormerEncoder(config.encoder_conf, cmvn)
        self.ctc = CTC(config.encoder_conf.output_size, config.vocab_size)
        self.decoder = None
        if config.decoder:
            self.decoder = BiTransformerDecoder(config.decoder_conf, config.vocab_size,
                                                config.encoder_conf.output_size)
        # the data axis's process group under data parallelism
        # (``parallel/data_group.py``): the loss's token counts over it
        self.data_group = None


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight from ``generator`` with PyTorch's default bounds:
    U(+-1/sqrt(fan_in)) for linear and conv layers, U(+-1/sqrt(hidden)) for
    LSTM weights and biases, Xavier-uniform for the positional biases, N(0, 1)
    for token embeddings (as the JAX package); norms and CMVN keep their
    identity values."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, LSTMWeights):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for w in m.parameters():
                w.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)
        elif isinstance(m, RelPositionMultiHeadedAttention):
            bound = math.sqrt(6.0 / (m.heads + m.d_k))
            m.pos_bias_u.uniform_(-bound, bound, generator=generator)
            m.pos_bias_v.uniform_(-bound, bound, generator=generator)
    return model
