"""Policy models, resolved by the reference's model names."""

from .core import Model  # noqa: F401
from .batchnorm import VirtualBNDQN  # noqa: F401

REGISTRY = {
    "ModelVirtualBN": VirtualBNDQN,  # gpu_implementation es_atari_config.json
    "VirtualBNDQN": VirtualBNDQN,
}


def get_model(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet; ported: {sorted(REGISTRY)}")
    return REGISTRY[name]
