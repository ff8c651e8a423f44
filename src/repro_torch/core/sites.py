"""Activation-site names.

The reference tags every offloadable activation with a site name
(``repro/core/sites.py``); the policy generator selects sites and the
executor offloads them.  In this slice ``tag`` only checks the name and
returns the tensor unchanged: the saved-tensor-hook labelling that lets
the executor see a tensor's site comes with the executor slice.
"""
from __future__ import annotations

from typing import Tuple

# The canonical site vocabulary.  Order matters: it is also the one-hot bit
# assignment used by the integer fuzzy matcher (Appendix A adaptation).
OFFLOAD_SITES: Tuple[str, ...] = (
    "embed_out",      # token embedding output
    "ln_in",          # pre-norm input (residual stream snapshot)
    "qkv_proj",       # fused qkv projection output
    "attn_ctx",       # attention context (pre out-proj)
    "attn_out",       # attention block output
    "cross_kv",       # encoder / image KV (enc-dec + VLM)
    "cross_ctx",      # cross-attention context
    "ffn_pre",        # gate/up projection output
    "ffn_act",        # post-activation
    "ffn_out",        # down projection output
    "resid_mid",      # residual after attention
    "resid_post",     # residual after mlp (layer output)
    "router_logits",  # MoE router scores
    "moe_dispatch",   # gathered expert inputs
    "moe_act",        # expert hidden activations
    "moe_out",        # combined expert outputs
    "ssm_in",         # mamba in-projection output
    "ssm_conv",       # post-conv activation
    "ssm_gate",       # gate branch
    "ssm_state",      # SSD chunk states
    "ssm_out",        # mamba block output
    "final_norm",
)
SITE_INDEX = {s: i for i, s in enumerate(OFFLOAD_SITES)}


def tag(x, site: str):
    """Check ``site`` against the vocabulary; return ``x`` unchanged."""
    if site not in SITE_INDEX:
        raise ValueError(f"unknown site {site!r}")
    return x
