"""Decoder-only transformer (Llama-style), the port of
``torchft_tpu/models/transformer.py``.

Same recipe and numerics as the flax model:
- bfloat16 activations and matmuls, float32 parameters, RMSNorm and
  softmax statistics in float32. The casts are written out where flax
  places them: ``Dense(dtype=bf16)`` casts input and weight to bf16,
  ``Embed(dtype=bf16)`` casts the table before the gather, and the LM head
  runs in float32;
- rotary positions in the split-halves layout (not interleaved);
- SwiGLU MLP;
- a pluggable ``attention_fn(q, k, v, causal)`` on ``[B, S, H, D]``; one
  that sets ``supports_gqa`` shares kv heads by index, others get the kv
  heads repeated.

:func:`params_from_jax` maps a flax parameter tree onto this module's
state dict, so the same weights can be run through both, and
:func:`diloco_state_from_jax` a JAX DiLoCo trainer's whole state onto the
port's trainers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 4
    embed_dim: int = 512
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    hidden_dim: Optional[int] = None    # None -> ~8/3 * embed, rounded to 128
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    # None -> plain softmax attention; else a callable (q, k, v, causal).
    attention_fn: Optional[Callable] = None
    # Per-layer recomputation in the backward (torch.utils.checkpoint).
    remat: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        if self.hidden_dim is not None:
            return self.hidden_dim
        h = int(self.embed_dim * 8 / 3)
        return (h + 127) // 128 * 128


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default Dense init: truncated normal (2 std) with variance
    1/fan_in after truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Dense(nn.Module):
    """Bias-free projection with flax ``Dense(dtype=...)`` numerics: input
    and float32 weight are cast to ``dtype`` before the matmul. The weight
    is ``[out, in]``, as in ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        with torch.no_grad():
            _lecun_normal_(self.weight, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 device: Any = None) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            (x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """Rotary position embedding, split-halves layout. x: [B, S, H, D]."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    angles = positions[..., None].float() * freqs        # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Reference softmax attention; q: [B, S, H, D], k/v may carry fewer
    (GQA) heads — repeated here. Logits and softmax in float32."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


plain_attention.supports_gqa = True


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        e, d = cfg.embed_dim, cfg.head_dim
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        self.q = Dense(e, cfg.num_heads * d, **kw)
        self.k = Dense(e, cfg.kv_heads * d, **kw)
        self.v = Dense(e, cfg.kv_heads * d, **kw)
        self.o = Dense(cfg.num_heads * d, e, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.v(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
        attn = cfg.attention_fn or plain_attention
        if (cfg.kv_heads != cfg.num_heads
                and not getattr(attn, "supports_gqa", False)):
            rep = cfg.num_heads // cfg.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = attn(q, k, v, True)
        return self.o(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        self.gate = Dense(cfg.embed_dim, cfg.mlp_dim, **kw)
        self.up = Dense(cfg.embed_dim, cfg.mlp_dim, **kw)
        self.down = Dense(cfg.mlp_dim, cfg.embed_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.embed_dim, device=device)
        self.attn = Attention(cfg, device=device, generator=generator)
        self.mlp_norm = RMSNorm(cfg.embed_dim, device=device)
        self.mlp = MLPBlock(cfg, device=device, generator=generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """The decoder. ``device`` defaults to ``"cuda"``; ``generator`` (on
    that device) makes the initialization reproducible."""

    def __init__(self, cfg: TransformerConfig, device: Any = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Transformer: no CUDA device; pass "
                               "device='cpu' to build on the CPU")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.embed_dim,
                                              device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, device=device)
        # The LM head's kernel, [E, V] like the flax Dense kernel: the
        # chunked loss reads it directly.
        self.lm_head = nn.Parameter(torch.empty(cfg.embed_dim,
                                                cfg.vocab_size,
                                                device=device))
        with torch.no_grad():
            self.embed.normal_(0.0, cfg.embed_dim ** -0.5,
                               generator=generator)
            _lecun_normal_(self.lm_head, cfg.embed_dim, generator)

    def lm_head_kernel(self) -> torch.Tensor:
        return self.lm_head

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``return_hidden=True`` skips the LM head and returns the
        final-norm hidden states [B, S, E]: pair it with
        :func:`chunked_causal_lm_loss` so [B, S, vocab] logits never
        materialize. ``positions`` ([B, S], default ``arange(S)``) are the
        tokens' rotary positions: a sequence shard passes its global ones
        (:func:`~torchft_tpu_torch.parallel.sharding.shard_sequence`)."""
        cfg = self.cfg
        x = F.embedding(tokens, self.embed.to(cfg.dtype))
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return x.float() @ self.lm_head  # float32 head for a stable loss


# --------------------------------------------------------------- presets


def tiny_config(**overrides: Any) -> TransformerConfig:
    """Test-scale model: full architecture, trivial size."""
    cfg = dict(vocab_size=256, num_layers=2, embed_dim=128, num_heads=4,
               max_seq_len=256)
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def llama2_7b_config(**overrides: Any) -> TransformerConfig:
    """Llama-2 7B: 32 layers, 4096 embed, 32 heads, 11008 hidden, 4k
    context."""
    cfg = dict(vocab_size=32_000, num_layers=32, embed_dim=4096,
               num_heads=32, hidden_dim=11_008, max_seq_len=4096)
    cfg.update(overrides)
    return TransformerConfig(**cfg)


# ------------------------------------------------------------------ loss


def _chunk_nll(h: torch.Tensor, kernel: torch.Tensor, t: torch.Tensor,
               mm: torch.dtype) -> torch.Tensor:
    logits = (h.to(mm) @ kernel.to(mm)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t[..., None]).sum()


def chunked_nll_sum(hidden: torch.Tensor, head_kernel: torch.Tensor,
                    targets: torch.Tensor, chunk_size: int = 256,
                    matmul_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Sum over positions of -log p(targets | hidden), hidden [B, T, E]
    and targets [B, T], WITHOUT materializing [B, T, vocab]: the head
    matmul and log-softmax run per sequence chunk under
    ``torch.utils.checkpoint``, so both passes peak at one [B, chunk, V]
    tile. ``matmul_dtype=None`` keeps the head matmul in float32; the
    log-softmax always runs on float32 logits."""
    t = targets.long()
    mm = torch.float32 if matmul_dtype is None else matmul_dtype
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, t.shape[1], chunk_size):
        total = total + checkpoint(
            _chunk_nll, hidden[:, start:start + chunk_size], head_kernel,
            t[:, start:start + chunk_size], mm, use_reentrant=False)
    return total


def chunked_causal_lm_loss(hidden: torch.Tensor, head_kernel: torch.Tensor,
                           tokens: torch.Tensor, chunk_size: int = 256,
                           matmul_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Next-token cross-entropy, mean over positions, through
    :func:`chunked_nll_sum`."""
    b, s, _ = hidden.shape
    return chunked_nll_sum(hidden[:, :-1], head_kernel, tokens[:, 1:],
                           chunk_size, matmul_dtype) / (b * (s - 1))


# --------------------------------------------------------- flax weights


def params_from_jax(flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree (numpy leaves; with or without the outer
    ``"params"`` key) onto :class:`Transformer`'s ``state_dict`` names:
    DenseGeneral q/k/v ``[E, H, D]`` -> ``[H*D, E]``; o ``[H*D, E]`` (or
    ``[H, D, E]``) -> ``[E, H*D]``; Dense ``[in, out]`` -> ``[out, in]``;
    the embedding ``[V, E]`` and the LM head kernel ``[E, V]`` as they
    are."""
    p = flax_params.get("params", flax_params)

    def t(a: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32))

    out = {"embed": t(p["embed"]["embedding"]),
           "final_norm.scale": t(p["final_norm"]["scale"]),
           "lm_head": t(p["lm_head"]["kernel"])}
    i = 0
    while f"layer_{i}" in p:
        lp = p[f"layer_{i}"]
        pre = f"layers.{i}."
        attn = lp["attn"]
        for name in ("q", "k", "v"):
            kern = np.asarray(attn[name]["kernel"])
            out[pre + f"attn.{name}.weight"] = t(
                kern.reshape(kern.shape[0], -1).T)
        o = np.asarray(attn["o"]["kernel"])
        out[pre + "attn.o.weight"] = t(o.reshape(-1, o.shape[-1]).T)
        for name in ("gate", "up", "down"):
            out[pre + f"mlp.{name}.weight"] = t(
                np.asarray(lp["mlp"][name]["kernel"]).T)
        out[pre + "attn_norm.scale"] = t(lp["attn_norm"]["scale"])
        out[pre + "mlp_norm.scale"] = t(lp["mlp_norm"]["scale"])
        i += 1
    return out


def _field(state: Any, name: str) -> Any:
    """The first element of an optax state tuple (a chain's states, each
    a NamedTuple) that has the field ``name``; ``None`` if none has."""
    if hasattr(state, name):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _field(s, name)
            if found is not None:
                return found
    return None


def _momentum(trace: Any, convert: Callable[[Any], Dict[str, Any]]
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A params-shaped optax trace as SGD's ``momentum_buffer`` per
    parameter name."""
    return {n: {"momentum_buffer": t} for n, t in convert(trace).items()}


def diloco_state_from_jax(state: Dict[str, Any],
                          convert: Callable[[Any], Dict[str, torch.Tensor]]
                          = params_from_jax,
                          fragments: Optional[List[List[str]]] = None
                          ) -> Dict[str, Any]:
    """A JAX ``DiLoCoTrainer`` / ``StreamingDiLoCoTrainer`` state (its
    ``state_dict()`` with numpy leaves) in the layout of the port's
    trainers' ``state_dict``, for their ``load_state_dict``:

    - ``params`` and ``anchor`` through ``convert``, which maps a tree
      shaped like the JAX params onto ``{name: tensor}`` (default
      :func:`params_from_jax`, the flax Transformer's tree);
    - the optax inner state: Adam's ``mu`` / ``nu`` / ``count`` into
      ``exp_avg`` / ``exp_avg_sq`` / ``step`` (a float32 scalar, as torch
      keeps it), a ``trace`` into ``momentum_buffer``, nothing for plain
      SGD;
    - the outer ``trace`` into the outer SGD's ``momentum_buffer``; for a
      streaming state, the per-fragment traces (each over its fragment's
      leaves, in the JAX params' flatten order) regrouped by the port
      trainer's ``fragments`` (its ``_frag_names``), with ``local_steps``.
    """
    from torchft_tpu_torch.local_sgd import _fragment_leaves
    from torchft_tpu_torch.utils import tree_flatten, tree_unflatten

    out: Dict[str, Any] = {"params": convert(state["params"]),
                           "anchor": convert(state["anchor"])}
    names = list(out["params"])
    adam = _field(state["inner_state"], "mu")
    if adam is not None:
        step = torch.tensor(float(np.asarray(adam.count)),
                            dtype=torch.float32)
        mu, nu = convert(adam.mu), convert(adam.nu)
        out["inner_state"] = {n: {"step": step.clone(), "exp_avg": mu[n],
                                  "exp_avg_sq": nu[n]} for n in names}
    else:
        tr = _field(state["inner_state"], "trace")
        mom = _momentum(tr.trace, convert) if tr is not None else {}
        out["inner_state"] = {n: mom.get(n, {}) for n in names}
    if "outer_states" not in state:
        out["outer_state"] = _momentum(
            _field(state["outer_state"], "trace").trace, convert)
        return out
    if fragments is None:
        raise ValueError("a streaming state needs the port trainer's "
                         "fragments")
    leaves, treedef = tree_flatten(state["params"])
    full: list = [None] * len(leaves)
    for idx, ost in zip(_fragment_leaves(leaves, len(fragments)),
                        state["outer_states"]):
        for i, t in zip(idx, _field(ost, "trace").trace):
            full[i] = t
    mom = _momentum(tree_unflatten(treedef, full), convert)
    out["outer_states"] = [{n: mom[n] for n in frag} for frag in fragments]
    out["local_steps"] = int(state["local_steps"])
    return out
