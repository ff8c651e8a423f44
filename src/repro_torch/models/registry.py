"""Family dispatch: one uniform API over the model zoo.

Port of ``repro/models/registry.py`` for the decoder-only families (dense,
moe, ssm, hybrid); vlm and encdec raise until their slice
(``transformer.check_family``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer


class ModelApi(NamedTuple):
    init: Callable              # (cfg, *, seed, device) -> Model
    forward: Callable           # (cfg, model, tokens, **kw) -> (logits, aux)
    decode_step: Callable       # (cfg, model, tokens, state) -> (logits, state)
    init_decode_state: Callable
    prefill: Callable           # (cfg, model, tokens, max_len) -> (logits, state)
    loss_fn: Callable           # (cfg, model, batch) -> (loss, metrics)


def get_api(cfg: ModelConfig) -> ModelApi:
    transformer.check_family(cfg)
    return ModelApi(transformer.init_model, transformer.forward,
                    transformer.decode_step, transformer.init_decode_state,
                    transformer.prefill, transformer.loss_fn)
