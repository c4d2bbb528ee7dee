"""Configuration of the port: model architectures, input shapes, and the
ReCXL replication-engine knobs.

Copies of the JAX package's ``config.py``: :class:`ModelConfig`,
:class:`ShapeConfig` with the four ``SHAPES``, ``shape_applicable``,
:class:`MeshConfig` with ``SINGLE_POD`` / ``MULTI_POD``, ``VARIANTS``
and :class:`ReplicationConfig`, :class:`TrainConfig`, :class:`RunConfig`
(whose ``fingerprint`` of a run equals the JAX package's), the model
registry (configs register themselves when :mod:`repro_torch.configs`
is imported, which the getters do lazily) and ``make_run_config``. On
one card a mesh names logical nodes (``distributed/context.py``), not
devices. Configs are plain frozen dataclasses, so they hash, print and
compare cleanly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    The fields cover every family in the assigned pool: dense GQA
    transformers, MoE transformers, Mamba-2 SSD stacks, hybrid
    attention+SSM, encoder-decoder audio backbones, and VLM backbones with
    a stubbed patch-embedding frontend.
    """

    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp: str = "swiglu"              # swiglu (3 mats) | gelu (2 mats)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0               # 0 => dense FFN
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 => d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0               # 0 => no SSM branch
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # --- encoder-decoder (audio) --------------------------------------------
    encoder_layers: int = 0          # >0 => enc-dec model
    n_frames: int = 1500             # stubbed audio-frame count (Whisper: 1500)

    # --- VLM ------------------------------------------------------------------
    n_patches: int = 0               # >0 => patch-embedding stub prepended

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads > 0:
            if self.n_heads % max(self.n_kv_heads, 1) != 0:
                raise ValueError(
                    f"{self.name}: n_heads={self.n_heads} not divisible by "
                    f"n_kv_heads={self.n_kv_heads}")

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """True iff the arch has a sub-quadratic sequence-mixing path and can
        therefore run the ``long_500k`` shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode_path(self) -> bool:
        """All assigned archs have a decoder; encoder-only archs would not."""
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count (used for 6*N*D model-FLOPs and memory
        budgeting; cross-checked against HLO byte counts in tests)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        out_head = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer = 0
        if self.family == "ssm":
            di = self.d_inner
            nh = self.ssm_n_heads
            # in_proj produces [z, x, B, C, dt]
            zxbcdt = 2 * di + 2 * self.ssm_state + nh
            per_layer += d * zxbcdt                       # in_proj
            per_layer += self.ssm_conv * (di + 2 * self.ssm_state)  # conv1d
            per_layer += nh * 2                           # A_log, D
            per_layer += nh                               # dt_bias
            per_layer += di * d                           # out_proj
            per_layer += d                                # norm
            per_layer += di                               # gated norm
            body = per_layer * self.n_layers
            return emb + out_head + body + d              # final norm
        # attention block (dense / moe / hybrid / audio / vlm)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qk_norm:
            attn += 2 * hd
        per_layer += attn + 2 * d                         # + 2 norms
        if self.family == "hybrid":
            di = self.d_inner
            nh = self.ssm_n_heads
            zxbcdt = 2 * di + 2 * self.ssm_state + nh
            per_layer += d * zxbcdt + self.ssm_conv * (di + 2 * self.ssm_state)
            per_layer += nh * 3 + di * d + di
        n_ffn_mats = 3 if self.mlp == "swiglu" else 2
        if self.is_moe:
            e_ff = self.expert_d_ff
            per_layer += self.n_experts * n_ffn_mats * d * e_ff
            per_layer += d * self.n_experts               # router
            per_layer += self.n_shared_experts * n_ffn_mats * d * e_ff
        else:
            per_layer += n_ffn_mats * d * self.d_ff
        body = per_layer * self.n_layers
        if self.is_encdec:
            # encoder layers: self-attn + FFN; decoder adds cross-attn
            enc_layer = attn + n_ffn_mats * d * self.d_ff + 2 * d
            cross = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + d
            body = (enc_layer * self.encoder_layers
                    + (per_layer + cross) * self.n_layers)
        return emb + out_head + body + d

    def active_param_count(self) -> int:
        """Active (per-token) parameters -- differs from total only for MoE."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        e_ff = self.expert_d_ff
        n_ffn_mats = 3 if self.mlp == "swiglu" else 2
        inactive = (self.n_experts - self.top_k) * n_ffn_mats * d * e_ff * self.n_layers
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Shape configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell.

    ``kind``:
      * ``train``   -- lowers ``train_step`` (fwd+bwd+opt+replication).
      * ``prefill`` -- lowers ``prefill_step`` (forward, fills KV cache).
      * ``decode``  -- lowers ``serve_step`` (one new token against a KV
        cache of ``seq_len``).
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __post_init__(self) -> None:
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"bad shape kind {self.kind}")

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; returns (ok, reason)."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, ("full quadratic attention at 524288-token context; "
                       "sub-quadratic path required (DESIGN.md S4)")
    if shape.kind == "decode" and not model.has_decode_path:
        return False, "encoder-only architecture has no decode step"
    return True, ""



# ---------------------------------------------------------------------------
# Mesh configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_parallel(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("data", "pod"):
                n *= s
        return n

    @property
    def model_parallel(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax == "model":
                n *= s
        return n


SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Replication (ReCXL) configuration
# ---------------------------------------------------------------------------

VARIANTS = ("none", "writethrough", "baseline", "parallel", "proactive")


@dataclass(frozen=True)
class ReplicationConfig:
    """ReCXL fault-tolerance engine knobs (paper SS III-IV).

    ``variant``:
      * ``none``        -- WB in the paper: fast, no fault tolerance.
      * ``writethrough``-- WT: persist every update synchronously to the MN
                            tier (the paper's 7.6x strawman).
      * ``baseline``    -- replication strictly after the coherence
                            transaction (serialized dependency chain).
      * ``parallel``    -- replication overlapped with the coherence
                            transaction; commit waits on both.
      * ``proactive``   -- per-bucket replication issued as each bucket's
                            update becomes available (SB-overlap analogue).
    """

    variant: str = "proactive"
    n_replicas: int = 3              # N_r (paper default 3)
    n_buckets: int = 8               # update coalescing granularity
    coalescing: bool = True
    log_capacity: int = 8            # ring-buffer entries (steps) per node
    dump_interval: int = 50          # steps between MN dumps (2.5ms analogue)
    compression: str = "int8"        # raw | int8 | int4 (MN dump wire format)
    cross_pod_replicas: bool = False
    log_dtype: str = "bfloat16"      # in-HBM log precision (raw = exact)
    # beyond-paper: "copy" = the paper's N_r full copies; "parity" =
    # erasure-coded logs (one parity shard per group of ``parity_group``
    # nodes, stored outside the group): G x N_r less log memory,
    # tolerating one failure per group instead of N_r - 1 anywhere.
    mode: str = "copy"               # copy | parity
    parity_group: int = 4

    def __post_init__(self) -> None:
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant}")
        if self.compression not in ("raw", "int8", "int4"):
            raise ValueError(f"unknown compression {self.compression}")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.mode not in ("copy", "parity"):
            raise ValueError(f"unknown mode {self.mode}")
        if self.mode == "parity" and self.parity_group < 2:
            raise ValueError("parity_group must be >= 2")

    @property
    def is_replicating(self) -> bool:
        return self.variant in ("baseline", "parallel", "proactive")


# ---------------------------------------------------------------------------
# Optimizer / training configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"         # adamw | adafactor | sgd
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"         # cosine | linear | constant
    remat: str = "full"              # full | selective | none
    master_dtype: str = "float32"    # optimizer accumulator dtype
    param_dtype: str = "bfloat16"
    microbatch: int = 0              # 0 => no gradient accumulation
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig = TRAIN_4K
    mesh: MeshConfig = SINGLE_POD
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def cell_id(self) -> str:
        return (f"{self.model.name}::{self.shape.name}::"
                f"{'x'.join(map(str, self.mesh.shape))}")

    def fingerprint(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_MODEL_REGISTRY: Dict[str, ModelConfig] = {}
_REDUCED_REGISTRY: Dict[str, ModelConfig] = {}


def register_model(cfg: ModelConfig, reduced: Optional[ModelConfig] = None) -> ModelConfig:
    if cfg.name in _MODEL_REGISTRY:
        raise ValueError(f"duplicate model registration {cfg.name}")
    _MODEL_REGISTRY[cfg.name] = cfg
    if reduced is not None:
        _REDUCED_REGISTRY[cfg.name] = reduced
    return cfg


def get_model_config(name: str) -> ModelConfig:
    _ensure_configs_imported()
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name]


def get_reduced_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    _ensure_configs_imported()
    if name in _REDUCED_REGISTRY:
        return _REDUCED_REGISTRY[name]
    raise KeyError(f"no reduced config registered for {name!r}")


def list_models() -> Tuple[str, ...]:
    _ensure_configs_imported()
    return tuple(sorted(_MODEL_REGISTRY))


def _ensure_configs_imported() -> None:
    # configs self-register on import; import lazily to avoid cycles.
    import repro_torch.configs  # noqa: F401


def make_run_config(arch: str, shape: str = "train_4k",
                    multi_pod: bool = False,
                    replication: Optional[ReplicationConfig] = None,
                    **train_overrides: Any) -> RunConfig:
    model = get_model_config(arch)
    mesh = MULTI_POD if multi_pod else SINGLE_POD
    rep = replication or ReplicationConfig()
    train = TrainConfig(**train_overrides) if train_overrides else TrainConfig()
    return RunConfig(model=model, shape=SHAPES[shape], mesh=mesh,
                     replication=rep, train=train)
