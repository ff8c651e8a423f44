"""Mamba-2 (SSD, state-space duality) block.

Port of ``repro/models/ssm.py``.  The full-sequence block runs the chunked
SSD scan through ``repro_torch.kernels.ssd_scan.ops.ssd_scan``: the
hand-written CUDA kernel on the card, its plain version (``ssd_chunked``
ported) on the CPU.  The scan returns the final state with y, so a prefill
takes its decode state from the same pass (``apply_ssm(return_state=
True)``); the reference runs the scan a second time for it.  Decode is the
one-token recurrence over the persistent (conv, ssd) state, in plain
PyTorch as in the reference, which has no kernel for it.

Under a plan that splits the SSM heads over the model dim (``ssm``, the
reference's ``ssm_heads`` / ``ssm_inner`` on ``model``), each rank holds
its heads' z, x and dt columns of ``in_proj``, their conv channels,
``A_log`` / ``dt_bias`` / ``D``, ``norm_scale`` and rows of ``out_proj``.
Where the model dim divides 2 x ``ssm_state`` (``ssm_bc``) each rank also
holds its slice of the B / C columns and their conv channels, convolves
them (the conv is depthwise) and all-gathers the result over the model
group before the scan, every head reading all of B and C
(``sharding.tp_gather``; the backward reduce-scatters their partial
gradients); elsewhere B / C are whole on every rank.  ``_dims`` /
``_bc_width`` give the rank's sizes; the scan runs on its heads, the gated
norm sums its squares over the model group (``tp_sum``) and the
out-projection ends in ``tp_exit``.  The decode state holds the rank's x
and B / C channels as it holds their columns, and its heads' SSD state; the
one-token step gathers B / C after its conv as the full sequence does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.core.sites import tag
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import _const, _normal, dense_init, torch_dtype


class Ssm(nn.Module):
    """Parameters of one Mamba-2 block, named as the reference's dict keys.
    The fused in-projection is [z (di), x (di), B (ds), C (ds), dt (nh)];
    ``A_log``, ``dt_bias`` and ``D`` stay f32 whatever the parameter dtype."""
    AXES = {"in_proj": ("embed", "ssm_inner"),
            "conv_w": ("conv", "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "D": ("ssm_heads",), "norm_scale": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, di, ds, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        kw = dict(generator=generator, device=device)
        ch = di + 2 * ds
        self.in_proj = dense_init(d, 2 * di + 2 * ds + nh, cfg, **kw)
        self.conv_w = _normal((cfg.ssm_conv_width, ch), 0.1, cfg, **kw)
        self.conv_b = _const((ch,), 0.0, cfg, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, nh + 1, **f32)))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.norm_scale = _const((di,), 1.0, cfg, device)
        self.out_proj = dense_init(di, d, cfg, **kw)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, state, heads, head dim) of this rank's share: the heads
    and their channels divided over the model group under an ``ssm``
    plan, whole otherwise."""
    n = shd.tp_size("ssm")
    return (cfg.ssm_d_inner // n, cfg.ssm_state, cfg.ssm_heads // n,
            cfg.ssm_head_dim)


def _bc_width(cfg: ModelConfig) -> int:
    """The B / C channels this rank holds: its slice under an ``ssm_bc``
    plan, all 2 x ``ssm_state`` otherwise."""
    return 2 * cfg.ssm_state // shd.tp_size("ssm_bc")


def _split_proj(cfg: ModelConfig, proj):
    di = _dims(cfg)[0]
    ch = di + _bc_width(cfg)
    return proj[..., :di], proj[..., di:di + ch], proj[..., di + ch:]


def _whole_bc(cfg: ModelConfig, conv_out):
    """(x channels, B, C) of a conv output (..., di + this rank's B / C),
    B and C gathered whole over the model group under an ``ssm_bc``
    plan."""
    di, ds = _dims(cfg)[:2]
    bc = shd.tp_gather(conv_out[..., di:], -1, "ssm_bc")
    return conv_out[..., :di], bc[..., :ds], bc[..., ds:]


def _causal_conv(cfg: ModelConfig, p: Ssm, xbc):
    """Depthwise causal conv over (B, S, channels), in xbc's dtype."""
    W, S = cfg.ssm_conv_width, xbc.shape[1]
    pads = F.pad(xbc, (0, 0, W - 1, 0))
    out = pads[:, 0:S] * p.conv_w[0]
    for i in range(1, W):
        out = out + pads[:, i:i + S] * p.conv_w[i]
    return F.silu(out + p.conv_b.to(out.dtype))


def _gated_norm(cfg: ModelConfig, p: Ssm, y, z, dtype):
    """y * silu(z), then RMSNorm over d_inner scaled by ``norm_scale``
    (the squares of every rank's channels under an ``ssm`` plan)."""
    y = y * F.silu(tag(z, "ssm_gate"))
    yf = y.float()
    if shd.tp_group("ssm") is None:
        ms = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        ms = shd.tp_sum(torch.sum(yf * yf, dim=-1, keepdim=True),
                        "ssm") / cfg.ssm_d_inner
    y = (yf * torch.rsqrt(ms + 1e-6)).to(dtype)
    return y * p.norm_scale.to(dtype)


class SSMState(NamedTuple):
    conv: torch.Tensor   # (L, B, W-1, di + B / C channels), activation dtype
    ssd: torch.Tensor    # (L, B, H, P, N) f32


def init_ssm_state(cfg: ModelConfig, batch: int, *,
                   device: torch.device) -> SSMState:
    di, ds, nh, hp = _dims(cfg)
    L = cfg.num_layers
    return SSMState(
        torch.zeros((L, batch, cfg.ssm_conv_width - 1, di + _bc_width(cfg)),
                    dtype=torch_dtype(cfg.dtype), device=device),
        torch.zeros((L, batch, nh, hp, ds),
                    dtype=torch.float32, device=device))


def apply_ssm(cfg: ModelConfig, p: Ssm, x, *, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x (B,S,d) -> (B,S,d); with
    ``return_state`` also the (conv (B,W-1,ch), ssd (B,H,P,N) f32) state
    after the last token, which is what ``prefill`` stores."""
    B, S, _ = x.shape
    di, _, nh, hp = _dims(cfg)
    proj = tag(shd.tp_enter(x, "ssm") @ p.in_proj, "ssm_in")
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = tag(_causal_conv(cfg, p, xbc_raw), "ssm_conv")
    xs, Bm, Cm = _whole_bc(cfg, xbc)    # views: the kernel takes strides
    xs = xs.reshape(B, S, nh, hp)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xs = shd.constrain(xs, ("batch", "seq", "ssm_heads", None))
    y, ssd_state = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y.to(x.dtype) + xs * p.D.to(x.dtype)[None, None, :, None]
    y = _gated_norm(cfg, p, y.reshape(B, S, di), z, x.dtype)
    out = shd.tp_exit(y @ p.out_proj, "ssm")
    out = shd.constrain(out, ("batch", "seq", "act_embed"))
    out = tag(out, "ssm_out")
    if not return_state:
        return out
    W = cfg.ssm_conv_width
    conv_state = (xbc_raw[:, S - (W - 1):] if S >= W - 1
                  else F.pad(xbc_raw, (0, 0, W - 1 - S, 0)))
    return out, (conv_state, ssd_state)


def decode_ssm(cfg: ModelConfig, p: Ssm, x, state: Tuple[torch.Tensor,
                                                          torch.Tensor]):
    """One-token decode.  x (B,1,d); state (conv (B,W-1,ch), ssd (B,H,P,N)).
    Returns (out (B,1,d), (new conv, new ssd)); the state is not modified."""
    B = x.shape[0]
    di, _, nh, hp = _dims(cfg)
    conv_state, ssd_state = state
    proj = shd.tp_enter(x, "ssm") @ p.in_proj
    z, xbc, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([conv_state, xbc[:, 0][:, None].to(conv_state.dtype)],
                       dim=1)                                   # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p.conv_w.float())
    conv_out = F.silu(conv_out + p.conv_b.float())
    new_conv = window[:, 1:]
    xs, Bm, Cm = _whole_bc(cfg, conv_out)
    xs = xs.reshape(B, nh, hp)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)           # (B, nh)
    dA = torch.exp(dt * -torch.exp(p.A_log)[None, :])
    new_ssd = (ssd_state * dA[:, :, None, None]
               + torch.einsum("bhp,bn->bhpn", xs * dt[..., None], Bm))
    y = torch.einsum("bhpn,bn->bhp", new_ssd, Cm)
    y = y + xs * p.D[None, :, None]
    y = _gated_norm(cfg, p, y.reshape(B, 1, di).to(x.dtype), z, x.dtype)
    return shd.tp_exit(y @ p.out_proj, "ssm"), (new_conv, new_ssd)
