"""Plain reference of a ModernBERT sentence encoder (answerdotai/
ModernBERT-base's architecture, as Alibaba-NLP/gte-modernbert-base ships
it), in PyTorch, written apart from the program under test: it imports
nothing of it, and has no kernels, cache or batching.

It computes from dense weights under the names ``ModernBertModel`` writes
(``embeddings.tok_embeddings.weight``, ``layers.<l>.attn.Wqkv.weight``,
...), and follows transformers' ``modeling_modernbert.py`` (eager
attention), with these departures:

- everything runs in float32 with TF32 off (``precision="f32"``), or with
  every matmul operand rounded to float8 e4m3 with one scale a row
  (``precision="fp8"``: the four projections' inputs and weights, q, k, v
  and the attention weights), the control a step below bfloat16;
- where ``config["weights"]["ftype"]`` is ``"q4_0"``, the four matrices of
  each layer (``Wqkv``, ``Wo``, ``Wi``, ``mlp.Wo``) go through a plain Q4_0
  round trip first (blocks of 32 along the input, scale amax / 7 in f32,
  codes round-half-away(w / scale) + 8 clipped to 0..15): the codes a
  quantize-on-load makes, so both sides use the same weights; the
  embedding table stays as it is;
- each sequence runs alone, unpadded (no attention mask, no unpadding);
  the local layers' window and the padding masks are -inf, not the
  dtype's minimum;
- cos and sin stay f32 (transformers casts them to the activations' dtype,
  which in float32 is the same);
- no dropout (evaluation), no compiled paths, no MaskedLM head;
- the embedding is the final norm's output at [CLS] (position 0),
  L2-normalised: sentence-transformers' CLS pooling of gte-modernbert-base.

Each part of the layer is a method of its own, so a test can plant a fault
in one and see the comparison fail.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

E4M3_MAX = 448.0
QK = 32


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C's roundf: halves away from zero (torch.round takes them to
    even)."""
    t = torch.trunc(x)
    tie = (x - t).abs() == 0.5
    return torch.where(tie, t + torch.sign(x), torch.round(x))


def q4_0_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """Q4_0 quantize then dequantize a [out, in] f32 tensor, blocks of 32
    along ``in``."""
    out, k = w.shape
    blocks = w.float().reshape(out, k // QK, QK)
    d = blocks.abs().amax(dim=-1) / 7.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                      torch.zeros_like(d))
    codes = torch.clamp(round_half_away(blocks * inv[..., None]) + 8.0, 0,
                        15)
    return ((codes - 8.0) * d[..., None]).reshape(out, k)


def _fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s rows."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    """Embeds token lists from dense weights and an HF-style config dict
    (``hidden_size``, ``num_attention_heads``, ``num_hidden_layers``,
    ``intermediate_size``, ``norm_eps``, ``global_attn_every_n_layers``,
    ``local_attention``, ``global_rope_theta``, ``local_rope_theta``,
    ``max_position_embeddings``; optional ``weights.ftype``)."""

    MATRICES = ("attn.Wqkv", "attn.Wo", "mlp.Wi", "mlp.Wo")

    def __init__(self, weights: Dict[str, torch.Tensor], config: dict,
                 device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.d = config["hidden_size"]
        self.h = config["num_attention_heads"]
        self.dh = self.d // self.h
        self.layers = config["num_hidden_layers"]
        self.f = config["intermediate_size"]
        self.eps = config.get("norm_eps", 1e-5)
        self.every = config.get("global_attn_every_n_layers", 3)
        self.local = config.get("local_attention", 128)
        self.theta_global = config.get("global_rope_theta", 160000.0)
        local = config.get("local_rope_theta")
        self.theta_local = self.theta_global if local is None else local
        self.n_pos = config["max_position_embeddings"]
        q4 = config.get("weights", {}).get("ftype") == "q4_0"
        self.w = {}
        for name, value in weights.items():
            value = value.to(self.device, torch.float32)
            if q4 and name.endswith(".weight") and any(
                    f".{m}." in name for m in self.MATRICES):
                value = q4_0_roundtrip(value)
            self.w[name] = value

    # -- the parts of a layer (a test may plant a fault in one) -------------
    def is_global(self, layer: int) -> bool:
        return layer % self.every == 0

    def theta(self, layer: int) -> float:
        return self.theta_global if self.is_global(layer) else \
            self.theta_local

    def window(self, layer: int) -> int:
        """The band's half-width; -1: every key."""
        return -1 if self.is_global(layer) else self.local // 2

    def rotate(self, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
        """transformers' rotate-half: x·cos + rotate_half(x)·sin."""
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos + rot * sin

    def attn_norm(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        if layer == 0:
            return x  # Identity in layer 0
        return self._ln(x, f"layers.{layer}.attn_norm.weight")

    def geglu(self, ug: torch.Tensor) -> torch.Tensor:
        u, g = ug.chunk(2, dim=-1)
        return torch.nn.functional.gelu(u) * g

    # -----------------------------------------------------------------------
    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.nn.functional.layer_norm(x, (self.d,), self.w[name],
                                              None, self.eps)

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.w[name]
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w.T

    def _rope(self, layer: int, t: int):
        inv_freq = 1.0 / (self.theta(layer) ** (torch.arange(
            0, self.dh, 2, dtype=torch.int64, device=self.device).float()
            / self.dh))
        freqs = torch.arange(t, device=self.device).float()[:, None] \
            * inv_freq[None]
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos(), emb.sin()

    def _attention(self, a: torch.Tensor, layer: int) -> torch.Tensor:
        t = a.shape[0]
        qkv = self._mm(a, f"layers.{layer}.attn.Wqkv.weight")
        q, k, v = qkv.reshape(t, 3, self.h, self.dh).permute(1, 2, 0, 3)
        cos, sin = self._rope(layer, t)
        q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
        if self.precision == "fp8":
            q, k, v = _fp8(q), _fp8(k), _fp8(v, dim=-2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(self.dh)
        w = self.window(layer)
        if w >= 0:
            i = torch.arange(t, device=self.device)
            far = (i[:, None] - i[None, :]).abs() > w
            s = s.masked_fill(far, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if self.precision == "fp8":
            p = _fp8(p)
        ctx = (p @ v).transpose(0, 1).reshape(t, self.d)
        return self._mm(ctx, f"layers.{layer}.attn.Wo.weight")

    @torch.no_grad()
    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [T] → the final norm's output [T, D], f32."""
        x = self._ln(self.w["embeddings.tok_embeddings.weight"][ids],
                     "embeddings.norm.weight")
        for layer in range(self.layers):
            x = x + self._attention(self.attn_norm(x, layer), layer)
            h = self._ln(x, f"layers.{layer}.mlp_norm.weight")
            ug = self._mm(h, f"layers.{layer}.mlp.Wi.weight")
            x = x + self._mm(self.geglu(ug), f"layers.{layer}.mlp.Wo.weight")
        return self._ln(x, "final_norm.weight")

    def embed(self, token_lists: Sequence[Sequence[int]]) -> torch.Tensor:
        """Each token list alone; [n, D] f32 on the device, in input order:
        the [CLS] row, L2-normalised."""
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = torch.empty((len(token_lists), self.d),
                              dtype=torch.float32, device=self.device)
            for i, toks in enumerate(token_lists):
                ids = torch.tensor(list(toks), dtype=torch.long,
                                   device=self.device)
                out[i] = torch.nn.functional.normalize(self.hidden(ids)[0],
                                                       dim=-1)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
