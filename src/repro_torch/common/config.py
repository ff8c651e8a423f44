"""Configuration dataclasses for the PyTorch port of Chameleon.

A copy of the reference package's ``repro/common/config.py`` with every
field and default kept, so one architecture name resolves to the same
shapes in both packages.  One change: ``ModelConfig.attn_impl`` takes
``flash`` (the hand-written CUDA kernel in
``repro_torch.kernels.flash_attention``) where the reference takes
``pallas``.  The host-tier, autotune, policy-store, adaptation and
resilience sections are the reference's, read by the port's modules of
the same names.  The H100's figures below are the port's own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


ATTN_IMPLS: Tuple[str, ...] = ("dense", "chunked", "flash")

# The card's figures, read by ChameleonConfig and by the autotuner's
# ``h100_sxm`` DeviceSpec (kernels/autotune/device.py).  Dense bf16
# tensor-core peak and HBM3 bandwidth: NVIDIA's H100 SXM data sheet.
H100_PEAK_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12
# Eq 3 bandwidth B (GB/s): chip_smoke.py's calibrate phase on an NVIDIA H100
# 80GB HBM3 (700 W) moved 512 MiB device to host in 14.2 ms and host to
# device in 12.5 ms (PERF.md §5); 512 MiB over their mean time is 40.2 GB/s
HOST_LINK_GBPS = 40.2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encdec | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0          # 0 -> = num_heads (MHA)
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    glu: bool = True               # gated MLP (silu(x@Wg) * (x@Wu)) @ Wd
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"    # rope | learned | none
    max_position: int = 1 << 20
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attention block every k ssm layers ---
    hybrid_attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500        # precomputed frame embeddings (stub frontend)

    # --- VLM (llama-3.2-vision): cross-attention image layers ---
    cross_attn_every: int = 0      # every k-th layer is a cross-attn layer
    image_tokens: int = 0          # precomputed patch embeddings (stub frontend)

    # --- numerics / implementation ---
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "bfloat16"
    attn_impl: str = "chunked"     # dense | chunked | flash
    attn_chunk: int = 1024
    scan_layers: bool = True       # scan over stacked layer params
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in {ATTN_IMPLS}")
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived sizes -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell? (SSM / hybrid decode)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count, exact against the model zoo's init
        (validated by tests/test_models_smoke.py)."""
        d, v = self.d_model, self.vocab_size
        norm = 2 * d if self.norm == "layernorm" else d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.pos_embedding == "learned":
            emb += self.max_position * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        mlp_mult = 3 if self.glu else 2
        dense_mlp = mlp_mult * d * self.d_ff
        dense_block = attn + dense_mlp + 2 * norm
        cross_block = dense_block + attn + norm + 1  # xattn + lnx + xgate

        def ssm_block():
            di, ds, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            ch = di + 2 * ds
            return (norm                              # ln
                    + d * (2 * di + 2 * ds + nh)      # in_proj
                    + self.ssm_conv_width * ch + ch   # conv w + b
                    + 3 * nh                          # A_log, dt_bias, D
                    + di                              # norm_scale
                    + di * d)                         # out_proj

        if self.family == "dense":
            return emb + norm + self.num_layers * dense_block
        if self.family == "vlm":
            n_cross = (self.num_layers // self.cross_attn_every
                       if self.cross_attn_every else 0)
            n_self = self.num_layers - n_cross
            return (emb + norm + n_self * dense_block
                    + n_cross * cross_block)
        if self.family == "moe":
            moe_mlp = (self.num_experts * mlp_mult * d * self.moe_d_ff
                       + d * self.num_experts)
            return emb + norm + self.num_layers * (attn + moe_mlp + 2 * norm)
        if self.family == "ssm":
            return emb + norm + self.num_layers * ssm_block()
        if self.family == "hybrid":
            return (emb + norm + self.num_layers * ssm_block()
                    + dense_block)
        if self.family == "encdec":
            enc = self.encoder_layers * dense_block + self.encoder_seq * d
            dec = self.num_layers * cross_block
            return emb + 2 * norm + enc + dec
        return emb + self.num_layers * dense_block

    def active_param_count(self) -> int:
        """Activated params per token (MoE uses top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mlp_mult = 3 if self.glu else 2
        total = self.param_count()
        all_experts = self.num_experts * mlp_mult * d * self.moe_d_ff
        active = self.experts_per_token * mlp_mult * d * self.moe_d_ff
        return total - self.num_layers * (all_experts - active)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


# The four assigned LM shapes (identical across all ten archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
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
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# host-link calibration sweep: 64 KiB .. 64 MiB (single source of truth —
# HostMemConfig default, bwmodel default, and the benchmark all use this)
HOSTMEM_CALIBRATION_SIZES: Tuple[int, ...] = tuple(
    1 << p for p in range(16, 27, 2))


@dataclass(frozen=True)
class HostMemConfig:
    """Host-memory tier (repro.hostmem): pinned pool + transfer engine +
    measured bandwidth model.  Disabled -> the simulator prices transfers
    with the constant ``host_link_gbps`` exactly as the paper does."""
    enabled: bool = True
    pool_bytes: int = 0                          # 0 -> uncapped host pool
    min_class_bytes: int = 1 << 12               # smallest slab size class
    engine_depth: int = 2                        # in-flight copies (double buffer)
    # KV-spill payload compression across the host link: "none" keeps the
    # bit-exact raw path; "int8" routes float decode-state rows through the
    # quant_offload kernels (row-wise symmetric int8 + f32 scales), 2-4x
    # fewer staged bytes at <=0.4% per-row error; "auto" prices raw vs
    # int8 per row from the tuned kernel rates + measured link curve
    # (repro_torch.kernels.autotune.advisor) and picks the cheaper one
    spill_compression: str = "none"              # none | int8 | auto
    spill_compress_min_bytes: int = 1 << 12      # rows below stay raw
    # per-traffic-class depth overrides, e.g. (("checkpoint", 16),) lets a
    # whole checkpoint drain queue without forcing early retires
    class_depths: Tuple[Tuple[str, int], ...] = ()
    # per-iteration byte cap on mirroring the applied policy's swap
    # schedule through the engine (real policy_swap-class copies retired
    # at each entry's promised release op); 0 disables the mirror
    mirror_swap_bytes: int = 64 << 20
    calibrate: bool = False                      # measure the link at startup
    calibration_sizes: Tuple[int, ...] = HOSTMEM_CALIBRATION_SIZES
    calibration_iters: int = 3


@dataclass(frozen=True)
class AutotuneConfig:
    """Roofline-driven kernel autotuning for the swap path
    (repro.kernels.autotune).  When enabled, startup measures each
    configured Pallas kernel's block-config variants, keeps the one with
    the highest achieved fraction of the memory-bandwidth roofline, and
    persists winners in a schema-versioned cache keyed by
    ``(kernel, shape-bucket, dtype, device_kind)`` — a warm cache means
    restart reuses tuned configs with zero re-measurement.  The measured
    link efficiency also derates the simulator's Eq-3 constant.  Port of
    the reference's section (repro_torch.kernels.autotune); the variants
    are the CUDA kernels' own launch knobs."""
    enabled: bool = False
    cache_dir: str = ""                          # "" -> in-memory only
    iters: int = 3                               # timing reps per variant
    # autotune.device registry key; "" -> the tier's own device
    # (``h100_sxm`` on an H100, ``cpu`` on the CPU).  The reference
    # defaults to its paper target, "tpu_v5e"
    device_kind: str = ""
    # kernels to tune at startup; flash_attention / ssd_scan can be added
    # where their tuning cost is worth it
    kernels: Tuple[str, ...] = ("quantize", "dequantize")


@dataclass(frozen=True)
class PolicyStoreConfig:
    """Persistent policy cache (repro.policystore): fingerprint-keyed
    store of generated SwapPolicies with a three-tier drift response
    (reuse / warm-start / regen).  ``dir=""`` keeps the store in-memory
    only; a directory makes policies survive process restarts."""
    enabled: bool = True
    dir: str = ""                                # "" -> memory-only store
    max_records: int = 64                        # LRU capacity (memory + disk)
    # calibrated-similarity tier thresholds (see policystore.drift)
    reuse_threshold: float = 0.90
    warm_threshold: float = 0.55
    # length-ratio gates: layer-count/model changes rescale the stream but
    # keep its shingle set, so tiers also require a length match
    reuse_len_ratio: float = 0.95
    warm_len_ratio: float = 0.60
    # REUSE only applies if fuzzy matching re-associates at least this
    # fraction of the cached entries onto the new program
    min_reuse_hit_rate: float = 0.60
    # REUSE is capped at WARM_START when the live bandwidth curve drifted
    # beyond this factor from the record's snapshot at any measured size
    # (only enforced once the live model is calibrated; loose enough that
    # online-EMA jitter does not trip it)
    bw_drift_limit: float = 4.0
    # fingerprint sketch parameters
    minhash_perms: int = 64
    shingle: int = 4
    # LSH band-bucket index over MinHash signatures: ``nearest`` probes
    # bucket collisions first (sublinear past ~1k records) and falls back
    # to a vectorized upper-bound-pruned scan only when the probe finds no
    # reuse-grade match.  rows per band = minhash_perms // lsh_bands.
    lsh_bands: int = 16


@dataclass(frozen=True)
class AdaptConfig:
    """Adaptation-pipeline placement (repro.adapt).

    ``mode`` decides where the §5 adaptation cycle (Detailed profiling →
    GenPolicy variant search → policy application) runs:

      * ``inline`` — the reference mode: adaptation runs on the training
        thread exactly as the paper describes (one measured variant per
        GenPolicy iteration); every async result can be asserted
        equivalent to what this mode produces for the same snapshot;
      * ``async`` — drift enqueues an :class:`~repro.adapt.AdaptJob`
        carrying an immutable snapshot; a background worker runs the
        variant search against it and publishes the winner to a
        single-slot mailbox, installed at the next iteration boundary
        while the old policy keeps serving;
      * ``speculative`` — ``async`` plus pre-generation: when the
        service predicts a recurring fingerprint (train→eval interleaves
        are periodic) it pre-builds that policy in idle background time
        so the phase switch costs 0 inline GenPolicy steps even on a
        cold mailbox.
    """
    mode: str = "inline"                 # inline | async | speculative
    # bounded service memory: parked speculative results and retained
    # snapshots (keyed by iteration fingerprint) are LRU-capped
    max_parked: int = 8
    max_snapshots: int = 16
    # fingerprint-transition history window the recurrence predictor sees
    history: int = 64
    # GIL-cooperative worker pacing: the background worker sleeps between
    # variant simulations (at least ``pace_s``, at least one snapshot
    # t_iter, capped at ``pace_cap_s``) so an overlapped training step
    # contends with at most one variant's worth of host-side work instead
    # of the whole bank.  Costs background latency only — the job still
    # lands within the drift window.  0 disables pacing.  The cap is 1 s
    # where the reference's is 0.25 s: an eager step on the card takes
    # 0.26-0.39 s (llama2-paper, 8 layers, 2 x 2048-3072 tokens), and a
    # cap under t_iter let two variants' host work land in one step.
    pace_s: float = 0.02
    pace_cap_s: float = 1.0


@dataclass(frozen=True)
class ResilienceConfig:
    """Swap-path fault recovery (repro.faults): engine retry/timeout
    parameters, link-health thresholds, and the degradation ladder.

    The engine retries a failed transfer ``max_retries`` times with
    exponential backoff; a copy slower than
    ``max(timeout_floor_s, timeout_factor * predicted)`` counts as a
    timeout.  Errors/timeouts/retries feed a per-traffic-class health
    score; crossing ``degrade_score``/``fail_score`` drives the
    degradation ladder in ``core/runtime.py`` (full → trimmed →
    conservative → no_swap), which climbs back up after
    ``recover_successes`` clean transfers (probe bursts generate them
    when the reduced rung is otherwise silent)."""
    enabled: bool = True
    # ---- engine retry / timeout ----
    max_retries: int = 3
    retry_backoff_s: float = 0.002               # first retry delay
    backoff_cap_s: float = 0.1                   # exponential backoff cap
    timeout_floor_s: float = 0.05                # below this is never "slow"
    timeout_factor: float = 8.0                  # x bwmodel-predicted time
    # ---- health state machine ----
    degrade_score: float = 2.0
    fail_score: float = 6.0
    recover_successes: int = 8
    residual_limit: float = 8.0                  # measured/predicted ratio
    health_decay: float = 0.7                    # score decay per clean copy
    # first copies pay jax dispatch init + slab allocation and the
    # bandwidth curve is still cold — no slow/timeout penalties until
    # this many transfers have completed
    health_warmup_transfers: int = 16
    # ---- degradation ladder ----
    ladder_hold_iterations: int = 2              # min iterations between moves
    probe_interval: int = 8                      # iterations between probes
    probe_burst: int = 4                         # round-trips per probe
    probe_bytes: int = 1 << 20
    trim_drop_fraction: float = 0.5              # max schedule cut at trimmed
    # ---- memory-ledger headroom feedback (repro_torch.obs.memledger) ----
    # when the realized peak overshoots the executed policy's projection
    # AND the remaining budget headroom falls under this fraction, the
    # ledger notes mild pressure on the "memory" health class (severe
    # when the realized peak exceeds the budget outright) — so the
    # ladder degrades on shrinking margin before an OOM
    headroom_degrade_frac: float = 0.05
    # ---- adaptation-worker watchdog (hung worker un-wedges ADAPTING) ----
    adapt_timeout_s: float = 30.0                # 0 disables


@dataclass(frozen=True)
class ChameleonConfig:
    """Paper hyperparameters (§4, §5, §7.1)."""
    enabled: bool = True
    # The card's figures: NVIDIA H100 80GB HBM3, 700 W.
    # torch.cuda.get_device_properties(0).total_memory on that card
    # (chip_smoke.py phase chameleon prints it)
    hbm_budget_bytes: int = 85_017_493_504
    host_link_gbps: float = HOST_LINK_GBPS       # Eq 3 bandwidth B (GB/s)
    m_warmup_stable: int = 2                     # Algo 1 `m`
    n_genpolicy_steps: int = 5                   # Algo 1 `n`
    len_change_threshold: float = 0.05           # 5% length diff
    cos_sim_threshold: float = 0.95              # 95% cosine similarity
    score_coef_c: float = 1.0                    # Eq 2 `C`
    groups_per_phase: int = 0                    # 0 -> num_layers (Fig 4 insight)
    offload_mode: str = "exact"                  # exact | compressed (int8, beyond-paper)
    allow_remat_fallback: bool = True            # beyond-paper: 3-way save/offload/remat
    peak_flops: float = H100_PEAK_FLOPS          # dense bf16, H100 data sheet
    hbm_gbps: float = H100_HBM_BYTES_S / 1e9     # HBM3, H100 SXM data sheet
    hostmem: HostMemConfig = HostMemConfig()     # host-memory tier (repro.hostmem)
    autotune: AutotuneConfig = AutotuneConfig()  # kernel autotuner (repro.kernels.autotune)
    policystore: PolicyStoreConfig = PolicyStoreConfig()  # repro.policystore
    adapt: AdaptConfig = AdaptConfig()           # adaptation placement (repro.adapt)
    resilience: ResilienceConfig = ResilienceConfig()  # fault recovery (repro.faults)


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    loss_scale: float = 2.0 ** 15                # dynamic loss scaling (op-seq change source)
    loss_scale_dynamic: bool = True
    eval_every: int = 0                          # on-the-fly validation (op-seq change source)
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    zero_stage: int = 2                          # 0,1,2,3
    grad_compression: str = "none"               # none | int8_ef (cross-pod)
    seed: int = 0
