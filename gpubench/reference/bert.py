"""Plain reference of a BERT sentence encoder with Q4_0 weights, in
PyTorch, written apart from the program under test.

The forward is the published BERT encoder (post-LayerNorm blocks, exact
erf GELU, learned absolute positions, token type 0) followed by a masked
mean pool and L2 normalisation, as sentence-transformers' mean-pooling
models run it. Weights are the harness's own Q4_0 codes and scales
(:mod:`gpubench.weights`), dequantised here as ``(code - 8) · scale``.

``precision="f32"`` computes everything in float32 with TF32 off: the
reference. ``precision="fp8"`` rounds every matmul operand (the four
projections' inputs and weights, q, k, v and the attention weights) to
float8 e4m3 with one scale a row, the step below the program's bfloat16:
the control that the correctness limits are held against.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

E4M3_MAX = 448.0


def dequant_q4_0(nib: torch.Tensor, scale: torch.Tensor,
                 shape) -> torch.Tensor:
    """ggml Q4_0 blocks of a [rows, cols] tensor (blocks of 32 along cols):
    ``nib`` [blocks, 16] uint8, byte j holding element 2j in its low nibble
    and 2j + 1 in its high one; ``scale`` [blocks] → f32 [rows, cols]."""
    lo = (nib & 15).to(torch.float32)
    hi = (nib >> 4).to(torch.float32)
    codes = torch.stack([lo, hi], dim=-1).reshape(nib.shape[0], 32)
    return ((codes - 8.0) * scale.to(torch.float32)[:, None]).reshape(shape)


def _fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s rows."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    """Builds dense f32 weights from the harness's Q4_0 draw and embeds
    token lists."""

    def __init__(self, weights: Dict[str, object], config: dict,
                 device: torch.device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self.d = config["hidden_size"]
        self.h = config["num_attention_heads"]
        self.layers = config["num_hidden_layers"]
        self.eps = config["layer_norm_eps"]
        self.device = device
        self.w = {}
        for name, value in weights.items():
            if isinstance(value, tuple):  # Q4_0: (nib, scale, shape)
                nib, scale, shape = value
                self.w[name] = dequant_q4_0(nib.to(device), scale.to(device),
                                            shape)
            else:
                self.w[name] = value.to(device, torch.float32)

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x @ W.T + b for the linear layer ``name`` (W stored [out, in])."""
        w = self.w[name + ".weight"]
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w.T + self.w[name + ".bias"]

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.nn.functional.layer_norm(
            x, (self.d,), self.w[name + ".weight"], self.w[name + ".bias"],
            self.eps)

    def _attention(self, x: torch.Tensor, mask: torch.Tensor,
                   prefix: str) -> torch.Tensor:
        b, t, _ = x.shape
        dh = self.d // self.h

        def heads(name):
            return self._mm(x, f"{prefix}.self.{name}").reshape(
                b, t, self.h, dh).transpose(1, 2)
        q, k, v = heads("query"), heads("key"), heads("value")
        if self.precision == "fp8":
            q, k, v = _fp8(q), _fp8(k), _fp8(v, dim=-2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        if self.precision == "fp8":
            p = _fp8(p)
        ctx = (p @ v).transpose(1, 2).reshape(b, t, self.d)
        return self._mm(ctx, f"{prefix}.output.dense")

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids [B, T] long, mask [B, T] bool → [B, D] f32, L2-normalised."""
        t = ids.shape[1]
        x = (self.w["embeddings.word_embeddings.weight"][ids]
             + self.w["embeddings.token_type_embeddings.weight"][0]
             + self.w["embeddings.position_embeddings.weight"][:t])
        x = self._ln(x, "embeddings.LayerNorm")
        for i in range(self.layers):
            p = f"encoder.layer.{i}"
            x = self._ln(x + self._attention(x, mask, f"{p}.attention"),
                         f"{p}.attention.output.LayerNorm")
            h = torch.nn.functional.gelu(self._mm(x, f"{p}.intermediate.dense"))
            x = self._ln(x + self._mm(h, f"{p}.output.dense"),
                         f"{p}.output.LayerNorm")
        m = mask.to(torch.float32)[..., None]
        pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
        return torch.nn.functional.normalize(pooled, dim=-1)

    def embed(self, token_lists: Sequence[Sequence[int]],
              block_tokens: int = 1 << 16) -> torch.Tensor:
        """Embed every token list, in blocks of rows of like length whose
        padded size stays under ``block_tokens``; [n, D] f32 in input
        order."""
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            order = sorted(range(len(token_lists)),
                           key=lambda i: len(token_lists[i]))
            out = torch.empty((len(token_lists), self.d),
                              dtype=torch.float32, device=self.device)
            start = 0
            while start < len(order):
                t = len(token_lists[order[start]])
                end = start + 1
                while end < len(order):
                    t_next = len(token_lists[order[end]])
                    if (end - start + 1) * t_next > block_tokens:
                        break
                    t, end = t_next, end + 1
                rows: List[int] = order[start:end]
                ids = torch.zeros((len(rows), t), dtype=torch.long)
                mask = torch.zeros((len(rows), t), dtype=torch.bool)
                for r, i in enumerate(rows):
                    ids[r, :len(token_lists[i])] = torch.tensor(
                        token_lists[i])
                    mask[r, :len(token_lists[i])] = True
                out[torch.tensor(rows, device=self.device)] = self.forward(
                    ids.to(self.device), mask.to(self.device))
                start = end
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
