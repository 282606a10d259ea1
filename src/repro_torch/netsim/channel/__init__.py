"""Registry-backed channel models: stochastic and replayed long-haul
impairments (the torch twin of the JAX package's ``netsim/channel``).

    from repro_torch.netsim.channel import get_channel_model, register_channel_model

Six models ship registered: ``ideal`` (the default), ``bernoulli_loss``,
``jitter``, ``otn_flap``, ``impaired`` (their composite) and
``trace_replay`` (a recorded per-edge schedule). ``CHANNEL_MODELS`` is the
builtin tuple; the registry may grow beyond it. ``base.py`` documents the
hook contract.
"""
from repro_torch.netsim.channel.base import (
    ChannelEffects, ChannelInputs, ChannelLike, ChannelModel,
    available_channel_models, get_channel_model, per_link,
    register_channel_model, unregister_channel_model,
)
from repro_torch.netsim.channel.models import (
    FLAP_DUTY, IdealChannel, ImpairState, ImpairedChannel, scenario_key,
)
from repro_torch.netsim.channel.replay import (
    ReplayState, TraceReplayChannel, load_schedule_json, save_schedule_json,
    schedule_from_arrays,
)

CHANNEL_MODELS = ("ideal", "bernoulli_loss", "jitter", "otn_flap",
                  "impaired", "trace_replay")

__all__ = [
    "CHANNEL_MODELS", "ChannelEffects", "ChannelInputs", "ChannelLike",
    "ChannelModel", "FLAP_DUTY", "IdealChannel", "ImpairState",
    "ImpairedChannel", "ReplayState", "TraceReplayChannel",
    "available_channel_models", "get_channel_model", "load_schedule_json",
    "per_link", "register_channel_model", "save_schedule_json",
    "scenario_key", "schedule_from_arrays", "unregister_channel_model",
]
