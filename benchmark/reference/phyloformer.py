"""The plain reference: a transcription of the published Phyloformer
(``phyloformer/model.py`` and ``phyloformer/attention.py`` of
lucanest/Phyloformer) in plain PyTorch, float32.

As the reference runs it: one alignment at a time (batch 1, no padding and
no masks), one-hot input ``(1, 22, L, n)``, a 1x1 convolution embedding,
the materialised ``(P, n)`` seq2pair product, channel-first ``(1, d, P, L)``
blocks whose LayerNorms and attentions reach the channel axis through
transposes and permutes, 1x1 convolutions for the FFN and the head, and the
mean over sites.  Its parameters are the reference checkpoint's
``state_dict`` itself (``model.`` stripped, the ``seq2pair`` buffer
dropped), loaded with ``strict=True``.

It imports nothing of the program under test.  Products run in IEEE fp32:
:func:`fp32_products` turns TF32 off for cuBLAS and cuDNN.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator

import torch
import torch.nn.functional as F
from torch import nn

ALPHABET_SIZE = 22


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """IEEE fp32 matrix products and convolutions on the card, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class ScaledLinearAttention(nn.Module):
    """Linear attention with one query and one key scalar per head:
    ``phi = elu + 1``, Q divided by its mean and K by its sum over the
    attended axis, ``out = phi(Q) (phi(K)^T V)`` per head, then the output
    projection."""

    def __init__(self, embed_dim: int, nb_heads: int):
        super().__init__()
        self.nb_heads = nb_heads
        self.q_proj = nn.Linear(embed_dim, nb_heads)
        self.k_proj = nn.Linear(embed_dim, nb_heads)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x (B, N, A, d)``: attends over ``A``."""
        b, n, a, d = x.shape
        q = F.elu(self.q_proj(x)) + 1.0  # (B, N, A, H)
        k = F.elu(self.k_proj(x)) + 1.0
        v = self.v_proj(x).view(b, n, a, self.nb_heads, d // self.nb_heads)
        q = q / q.mean(dim=-2, keepdim=True)
        k = k / k.sum(dim=-2, keepdim=True)
        kv = torch.einsum("bnah,bnahe->bnhe", k, v)
        out = torch.einsum("bnah,bnhe->bnahe", q, kv).reshape(b, n, a, d)
        return self.out_proj(out)


class PhyloformerLayer(nn.Module):
    def __init__(self, embed_dim: int, nb_heads: int, ffn_dim: int):
        super().__init__()
        self.row_norm = nn.LayerNorm(embed_dim)
        self.row_attention = ScaledLinearAttention(embed_dim, nb_heads)
        self.col_norm = nn.LayerNorm(embed_dim)
        self.col_attention = ScaledLinearAttention(embed_dim, nb_heads)
        self.ffn_norm = nn.LayerNorm(embed_dim)
        self.ffn = nn.Sequential(nn.Conv2d(embed_dim, ffn_dim, 1), nn.Dropout(0.0), nn.GELU(),
                                 nn.Conv2d(ffn_dim, embed_dim, 1), nn.Dropout(0.0))

    @staticmethod
    def _norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return norm(x.transpose(-1, -3)).transpose(-1, -3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x (B, d, P, L)``."""
        h = self._norm(self.row_norm, x)
        x = x + self.row_attention(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)  # over L
        h = self._norm(self.col_norm, x)
        x = x + self.col_attention(h.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)  # over P
        h = self._norm(self.ffn_norm, x)
        return x + self.ffn(h)


class Phyloformer(nn.Module):
    def __init__(self, n_blocks: int = 6, nb_heads: int = 4, embed_dim: int = 64,
                 ffn_dim: int = 256, in_channels: int = ALPHABET_SIZE):
        super().__init__()
        self.embedding_block = nn.Sequential(nn.Conv2d(in_channels, embed_dim, 1), nn.ReLU())
        self.attention_blocks = nn.ModuleList(
            PhyloformerLayer(embed_dim, nb_heads, ffn_dim) for _ in range(n_blocks))
        self.pwFNN = nn.Sequential(nn.Conv2d(embed_dim, 1, 1), nn.Dropout(0.0), nn.Softplus())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One-hot ``(1, 22, L, n)`` → distances ``(1, P)``."""
        n = x.shape[-1]
        x = self.embedding_block(x)  # (1, d, L, n)
        x = torch.matmul(seq2pair(n, x.device, x.dtype), x.transpose(-1, -2))  # (1, d, P, L)
        for block in self.attention_blocks:
            x = block(x)
        return self.pwFNN(x).squeeze(1).mean(dim=-1)


def seq2pair(n: int, device, dtype) -> torch.Tensor:
    """The ``(C(n, 2), n)`` 0/1 matrix: row ``k`` sums pair ``k``'s two
    sequences, pairs in ``itertools.combinations`` order."""
    pairs = torch.tensor(list(itertools.combinations(range(n), 2)), dtype=torch.long)
    m = torch.zeros(len(pairs), n, dtype=dtype)
    m[torch.arange(len(pairs)), pairs[:, 0]] = 1
    m[torch.arange(len(pairs)), pairs[:, 1]] = 1
    return m.to(device)


def one_hot(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Integer codes ``(n, L)`` → the reference's ``(1, 22, L, n)`` input."""
    return F.one_hot(codes.long(), ALPHABET_SIZE).to(dtype).permute(2, 1, 0)[None]


def from_checkpoint(path, sizes: Dict, device, dtype=torch.float32) -> Phyloformer:
    """The model of ``sizes`` (a configuration file's keys) with a reference
    checkpoint's weights."""
    state = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    state = {k.removeprefix("model."): v for k, v in state.items() if k != "model.seq2pair"}
    model = Phyloformer(sizes["n_blocks"], sizes["n_heads"], sizes["embed_dim"],
                        sizes["ffn_dim"], sizes["in_channels"])
    model.load_state_dict(state, strict=True)
    return model.to(device, dtype).eval()


def predict(model: Phyloformer, codes, device) -> torch.Tensor:
    """One alignment's distances, ``(P,)`` float64 on the host."""
    with torch.no_grad(), fp32_products():
        x = one_hot(torch.as_tensor(codes), next(model.parameters()).dtype).to(device)
        return model(x)[0].double().cpu()
