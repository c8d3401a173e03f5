"""Configuration dataclasses — counterpart of ``repro.configs.base``,
copied field for field (the file imports nothing of JAX).

Everything is a frozen dataclass so configs are hashable and safely
shareable. ``ModelConfig`` describes every assigned LM family and the
paper's ViT; ``ShapeConfig`` / ``SHAPES``, ``MeshConfig``,
``TrainConfig``, ``ServeConfig`` and ``RunConfig`` are the launchers'
settings, and ``reduced`` the tiny same-family config of the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering every assigned family.

    Families:
      dense   — GQA transformer (granite, nemotron, internlm2, llama3)
      vlm     — dense backbone, embedding-input frontend stub (llava-next)
      audio   — dense backbone over codec tokens, frontend stub (musicgen)
      moe     — mixture-of-experts MLPs (llama4-maverick, qwen3-moe)
      ssm     — attention-free SSD blocks (mamba2)
      hybrid  — RG-LRU + periodic local attention (recurrentgemma)
    """

    name: str
    family: str  # dense | vlm | audio | moe | ssm | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    # --- MLP ---
    d_ff: int = 0
    mlp_activation: str = "silu"   # silu | gelu | relu2
    mlp_gated: bool = True          # False -> classic 2-matmul MLP
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_period: int = 1             # every `period`-th layer is MoE (1 = all)
    moe_capacity_factor: float = 1.25   # per-expert buckets = ceil(T*k/E * cf)
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    attn_period: int = 0            # every `period`-th layer is attention
    local_window: int = 0           # sliding-window size for local attention
    lru_width: int = 0              # RG-LRU recurrent width (0 -> d_model)
    # --- frontend ---
    input_mode: str = "tokens"      # tokens | embeddings (vlm/audio stubs)
    tie_embeddings: bool = False
    pos_embed: str = "rope"         # rope | sinusoidal (musicgen)
    scale_embed: bool = False       # gemma-style sqrt(d) embedding scale
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # --- provenance ---
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (TPU lane alignment + even
        vocab sharding). Logits above vocab_size are masked in the loss."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return self.attn_period > 0 and (i % self.attn_period == self.attn_period - 1)
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_period == self.moe_period - 1

    # ------------------------------------------------------------------
    # layer kinds and the repeating scan pattern
    # ------------------------------------------------------------------
    def layer_kind(self, i: int) -> str:
        """One of: AD (attn+dense mlp), AM (attn+moe), AL (local attn+mlp),
        S (SSD block), R (RG-LRU recurrent block + mlp)."""
        if self.family == "ssm":
            return "S"
        if self.family == "hybrid":
            return "AL" if self.is_attn_layer(i) else "R"
        if self.is_moe_layer(i):
            return "AM"
        return "AD"

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.num_layers))

    def scan_pattern(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(pattern, num_blocks, tail): layers = pattern * num_blocks + tail.

        The layer stack is lowered as ``lax.scan`` over ``num_blocks`` with
        the pattern's layers unrolled inside the body; ``tail`` layers are
        appended unscanned. Keeps the HLO O(pattern) instead of O(layers).
        """
        kinds = self.layer_kinds()
        n = len(kinds)
        # find the shortest repeating prefix that tiles the stack
        for plen in range(1, n + 1):
            pat = kinds[:plen]
            blocks = n // plen
            if blocks >= 1 and pat * blocks == kinds[: plen * blocks]:
                tail = kinds[plen * blocks:]
                if all(t == pat[i % plen] for i, t in enumerate(tail)):
                    return pat, blocks, tail
        return kinds, 1, ()

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches init_params within rounding)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for i in range(self.num_layers):
            if self.family == "ssm":
                n += self._ssm_layer_params()
                continue
            if self.family == "hybrid" and not self.is_attn_layer(i):
                n += self._rglru_layer_params()
                n += self._mlp_params(self.d_ff)
                n += 2 * d  # norms
                continue
            # attention layer
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += 2 * d  # attn norm + mlp norm
            if self.is_moe_layer(i):
                e = self.num_experts + self.num_shared_experts
                n += e * self._mlp_params(self.d_ff)
                n += d * self.num_experts  # router
            else:
                n += self._mlp_params(self.d_ff)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed experts count)."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        n = self.param_count()
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                inactive = self.num_experts - self.experts_per_token
                n -= inactive * self._mlp_params(self.d_ff)
        return n

    def _mlp_params(self, d_ff: int) -> int:
        mats = 3 if self.mlp_gated else 2
        return mats * self.d_model * d_ff

    def _ssm_layer_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        n = d * (2 * di + 2 * ns + nh)          # in_proj -> x, z, B, C, dt
        n += self.ssm_conv_width * (di + 2 * ns)  # depthwise conv
        n += 2 * nh                               # A_log, D
        n += di                                   # group norm
        n += di * d                               # out_proj
        n += 2 * d                                # layer norms
        return n

    def _rglru_layer_params(self) -> int:
        d = self.d_model
        w = self.lru_width or d
        n = 2 * d * w          # input + gate branch projections
        n += 2 * w             # RG-LRU a-gate, input-gate params (diag)
        n += 2 * w * w // 1    # recurrence input/ gate projections (per-channel + mixing)
        n += w * d             # out proj
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered for an arch."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shape cells.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"     # bfloat16 for the >=200B archs
    microbatches: int = 1                 # gradient-accumulation chunks
    remat: str = "full"                   # none | full | dots
    sequence_parallel: bool = False       # Megatron-SP activation sharding
    loss_chunk: int = 0                   # 0 = unchunked vocab loss
    label_smoothing: float = 0.0
    z_loss: float = 1e-4
    grad_compression: str = "none"        # none | int8_ef
    grad_acc_dtype: str = "float32"       # bfloat16 for the >=200B archs
    sharding_mode: str = "fsdp_tp"        # fsdp_tp | zero3 (launch/sharding.py)
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    decode_seq_parallel: bool = True      # shard KV cache seq over `model`
    seq_parallel: bool = False            # context-parallel prefill: shard
    #                                       activations along seq over `model`
    prefill_chunk: int = 512              # query-block size for chunked attention
    cache_dtype: str = "bfloat16"


@dataclass(frozen=True)
class RunConfig:
    """Everything a launcher needs."""

    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family in ("hybrid", "moe") else 2),
        d_model=128,
        vocab_size=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        num_experts=4 if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=32,
        lru_width=128 if cfg.lru_width else 0,
        local_window=32 if cfg.local_window else 0,
        param_dtype="float32",
        compute_dtype="float32",
        name=cfg.name + "-reduced",
    )
    if cfg.family == "hybrid":
        # keep one attention layer in the reduced stack
        small["num_layers"] = max(cfg.attn_period + 1, 4) if cfg.attn_period else 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
