"""Family dispatch: one uniform API over the model zoo.

Port of ``repro/models/registry.py``: the encdec family (whisper) is
``models.whisper``, every other family ``models.transformer``.  The port's
API also has ``prefill``, which the reference's server takes from
``transformer`` directly; for encdec it feeds the prompt through
``decode_step``, as the reference serves that family.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer, whisper


class ModelApi(NamedTuple):
    init: Callable              # (cfg, *, seed, device) -> Model
    forward: Callable           # (cfg, model, tokens, **kw) -> (logits, aux)
    decode_step: Callable       # (cfg, model, tokens, state) -> (logits, state)
    init_decode_state: Callable
    prefill: Callable           # (cfg, model, tokens, max_len, *, memory)
    loss_fn: Callable           # (cfg, model, batch) -> (loss, metrics)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "encdec":
        mod = whisper
    else:
        transformer.check_family(cfg)
        mod = transformer
    return ModelApi(mod.init_model, mod.forward, mod.decode_step,
                    mod.init_decode_state, mod.prefill, mod.loss_fn)
