"""Plain reference of DeepSeek-V2 (deepseek-ai/DeepSeek-V2-Lite's
architecture) used as an embedding backbone, in PyTorch, written apart from
the program under test: it imports nothing of it, and has no kernels, cache
or batching.

It computes from the weights under the names ``DeepseekV2Model`` writes
(``embed_tokens.weight``, ``layers.<l>.self_attn.q_proj.weight``, ...) and
an HF-style config dict, and follows the published ``modeling_deepseek.py``
of the checkpoint (transformers 4.57's ``modeling_deepseek_v2.py`` is its
copy, eager attention), with these departures:

- everything runs in float32 with TF32 off (``precision="f32"``), or with
  every product's operands rounded to float8 e4m3 with one scale a row
  (``precision="fp8"``: the router's, the projections', the experts', q,
  k, v and the attention weights), the control a step below bfloat16;
- a weight may be given dense (an f32 tensor) or as Q4_0 blocks, a tuple
  (nibbles [blocks, 16] uint8, scales [blocks] f32, (N, K)) with ggml's
  nibble order (byte j of a block holds elements 2j and 2j+1): it is
  dequantized, (code - 8) · scale, one layer at a time, when that layer
  runs;
- each sequence runs alone, unpadded: causal attention over its own
  tokens, no attention mask; the positions are 0..T-1;
- the softmax scale is the published code's, qk_head_dim^-½ · m² under
  YaRN with ``mscale_all_dim`` (transformers 4.57's native class leaves m²
  out: the two agree where ``rope_scaling`` is null); cos and sin are the
  published code's YaRN tables, scaled by m(factor, mscale) /
  m(factor, mscale_all_dim), and stay f32;
- RoPE rotates the checkpoint's interleaved pairs (2i, 2i+1), as the
  published code does (de-interleave, then rotate-half);
- the MoE is a loop over the experts, each computing the tokens routed to
  it; each token's choices are summed weighted in f32, then the shared
  experts' output is added (the published order); no auxiliary loss, no
  expert parallelism, no dropout;
- the model stops at its final norm (no ``lm_head``); the embedding is
  the final norm's output at the last token, L2-normalised:
  sentence-transformers' last-token pooling of an LLM-backbone embedder.

Each part of the layer is a method of its own, so a test can plant a fault
in one and see the comparison fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s rows."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def q4_0_dense(nib: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """Q4_0 blocks → the dense [N, K] f32 matrix: byte j of a block holds
    element 2j in its low nibble and 2j + 1 in its high one."""
    codes = torch.stack([nib & 0xF, nib >> 4], dim=-1).reshape(
        nib.shape[0], 32).float()
    return ((codes - 8.0) * scale.float()[:, None]).reshape(shape)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


class Reference:
    """Embeds token lists from DeepSeek-V2 weights and an HF config dict
    (``hidden_size``, ``num_attention_heads``, ``qk_nope_head_dim``,
    ``qk_rope_head_dim``, ``v_head_dim``, ``kv_lora_rank``,
    ``num_hidden_layers``, ``first_k_dense_replace``, ``n_routed_experts``,
    ``num_experts_per_tok``, ``n_shared_experts``, ``rms_norm_eps``,
    ``rope_theta``, ``rope_scaling``, ``routed_scaling_factor``)."""

    def __init__(self, weights: Dict[str, object], config: dict, device,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.weights = {(k[6:] if k.startswith("model.") else k): v
                        for k, v in weights.items()}
        c = config
        self.d = c["hidden_size"]
        self.h = c["num_attention_heads"]
        self.nope = c["qk_nope_head_dim"]
        self.rope_dim = c["qk_rope_head_dim"]
        self.dv = c["v_head_dim"]
        self.rank = c["kv_lora_rank"]
        self.layers = c["num_hidden_layers"]
        self.first_dense = c.get("first_k_dense_replace", 0)
        self.n_experts = c["n_routed_experts"]
        self.top_k = c["num_experts_per_tok"]
        self.n_shared = c.get("n_shared_experts") or 0
        self.eps = c.get("rms_norm_eps", 1e-6)
        self.scaling = c.get("routed_scaling_factor", 1.0)
        self.theta = c.get("rope_theta", 10000.0)
        self.rope_scaling = c.get("rope_scaling")
        self.q_head = self.nope + self.rope_dim
        self.softmax_scale = self.q_head ** -0.5
        rs = self.rope_scaling
        if rs is not None and rs.get("mscale_all_dim"):
            m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
            self.softmax_scale *= m * m

    # -- weights -------------------------------------------------------------
    def w(self, name: str) -> torch.Tensor:
        """The weight ``name`` dense, f32, on the device."""
        v = self.weights[name]
        if isinstance(v, tuple):
            nib, scale, shape = v
            return q4_0_dense(nib.to(self.device), scale.to(self.device),
                              shape)
        return v.to(self.device, torch.float32)

    # -- the parts of a layer (a test may plant a fault in one) -------------
    def rms(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return weight * (x * torch.rsqrt(var + self.eps))

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w.T

    def rope_tables(self, t: int):
        """The published DeepseekV2YarnRotaryEmbedding's (or plain RoPE's)
        cos and sin [t, rope_dim]."""
        dim, base = self.rope_dim, self.theta
        freq_extra = 1.0 / (base ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=self.device) / dim))
        rs = self.rope_scaling
        mscale = 1.0
        if rs is None:
            inv_freq = freq_extra
        else:
            factor = rs["factor"]
            freq_inter = 1.0 / (factor * base ** (torch.arange(
                0, dim, 2, dtype=torch.float32, device=self.device) / dim))

            def corr_dim(rot):
                return (dim * math.log(rs["original_max_position_embeddings"]
                                       / (rot * 2 * math.pi))
                        ) / (2 * math.log(base))

            low = max(math.floor(corr_dim(rs.get("beta_fast", 32))), 0)
            high = min(math.ceil(corr_dim(rs.get("beta_slow", 1))), dim - 1)
            if low == high:
                high += 0.001
            ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                             device=self.device) - low)
                               / (high - low), 0, 1)
            mask = 1.0 - ramp
            inv_freq = freq_inter * (1 - mask) + freq_extra * mask
            mscale = (yarn_get_mscale(factor, rs.get("mscale", 1))
                      / yarn_get_mscale(factor, rs.get("mscale_all_dim", 0)))
        pos = torch.arange(t, dtype=torch.float32, device=self.device)
        freqs = torch.outer(pos, inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * mscale, emb.sin() * mscale

    def rope(self, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> torch.Tensor:
        """The published apply_rotary_pos_emb on x [..., t, rope_dim] in the
        checkpoint's interleaved order: de-interleave, then rotate-half."""
        *lead, t, d = x.shape
        x = x.reshape(*lead, t, d // 2, 2).transpose(-1, -2).reshape(
            *lead, t, d)
        rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
        return x * cos + rot * sin

    def attention(self, a: torch.Tensor, lw: dict) -> torch.Tensor:
        t = a.shape[0]
        q = self.mm(a, lw["q"]).reshape(t, self.h, self.q_head).transpose(
            0, 1)
        q_nope, q_pe = q[..., :self.nope], q[..., self.nope:]
        ckv = self.mm(a, lw["kv_a"])
        c, k_pe = ckv[:, :self.rank], ckv[:, self.rank:]
        kv = self.mm(self.rms(c, lw["kv_norm"]), lw["kv_b"]).reshape(
            t, self.h, self.nope + self.dv).transpose(0, 1)
        k_nope, v = kv[..., :self.nope], kv[..., self.nope:]
        cos, sin = self.rope_tables(t)
        q_pe = self.rope(q_pe, cos, sin)
        k_pe = self.rope(k_pe[None], cos, sin).expand(self.h, t,
                                                      self.rope_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        if self.precision == "fp8":
            q, k, v = _fp8(q), _fp8(k), _fp8(v, dim=-2)
        s = (q @ k.transpose(-1, -2)) * self.softmax_scale
        i = torch.arange(t, device=self.device)
        s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        if self.precision == "fp8":
            p = _fp8(p)
        ctx = (p @ v).transpose(0, 1).reshape(t, self.h * self.dv)
        return self.mm(ctx, lw["o"])

    def mlp(self, x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
        return self.mm(torch.nn.functional.silu(self.mm(x, gate))
                       * self.mm(x, up), down)

    def route(self, h: torch.Tensor, router: torch.Tensor):
        """(weights, experts) [t, k]: the greedy top-k of the softmax over
        the f32 logits, not renormalised, times the routed scale."""
        scores = torch.softmax(self.mm(h, router), dim=-1)
        w, idx = torch.topk(scores, self.top_k, dim=-1)
        return w * self.scaling, idx

    def moe(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        w, idx = self.route(h, lw["router"])
        t = h.shape[0]
        out = torch.zeros((t, self.top_k, self.d), device=self.device)
        for e in range(self.n_experts):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                out[tok, slot] = self.mlp(h[tok], *lw["experts"][e])
        y = (out * w[..., None]).sum(dim=1)
        if self.n_shared:
            y = y + self.mlp(h, *lw["shared"])
        return y

    # -----------------------------------------------------------------------
    def layer_weights(self, layer: int) -> dict:
        """Layer ``layer``'s weights, dense f32 on the device."""
        p = f"layers.{layer}."
        a = p + "self_attn."
        lw = {"attn_norm": self.w(p + "input_layernorm.weight"),
              "ffn_norm": self.w(p + "post_attention_layernorm.weight"),
              "q": self.w(a + "q_proj.weight"),
              "kv_a": self.w(a + "kv_a_proj_with_mqa.weight"),
              "kv_norm": self.w(a + "kv_a_layernorm.weight"),
              "kv_b": self.w(a + "kv_b_proj.weight"),
              "o": self.w(a + "o_proj.weight")}

        def mlp(q):
            return tuple(self.w(f"{q}{n}_proj.weight")
                         for n in ("gate", "up", "down"))

        if layer < self.first_dense:
            lw["dense"] = mlp(p + "mlp.")
        else:
            lw["router"] = self.w(p + "mlp.gate.weight")
            lw["experts"] = [mlp(f"{p}mlp.experts.{e}.")
                             for e in range(self.n_experts)]
            if self.n_shared:
                lw["shared"] = mlp(p + "mlp.shared_experts.")
        return lw

    def block(self, x: torch.Tensor, layer: int, lw: dict) -> torch.Tensor:
        x = x + self.attention(self.rms(x, lw["attn_norm"]), lw)
        h = self.rms(x, lw["ffn_norm"])
        if layer < self.first_dense:
            return x + self.mlp(h, *lw["dense"])
        return x + self.moe(h, lw)

    @torch.no_grad()
    def hidden_all(self, token_lists: Sequence[Sequence[int]]
                   ) -> List[torch.Tensor]:
        """Each token list's final norm output [T, D], f32. Each sequence
        runs alone; the layers run in turn over all of them, so each
        layer's weights are dequantized once."""
        table = self.w("embed_tokens.weight")
        xs = [table[torch.tensor(list(toks), dtype=torch.long,
                                 device=self.device)]
              for toks in token_lists]
        del table
        for layer in range(self.layers):
            lw = self.layer_weights(layer)
            xs = [self.block(x, layer, lw) for x in xs]
            del lw
        norm = self.w("norm.weight")
        return [self.rms(x, norm) for x in xs]

    def embed(self, token_lists: Sequence[Sequence[int]]) -> torch.Tensor:
        """Each token list alone; [n, D] f32 on the device, in input order:
        the last token's row, L2-normalised."""
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            hs = self.hidden_all(token_lists)
            return torch.stack([torch.nn.functional.normalize(h[-1], dim=-1)
                                for h in hs])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
