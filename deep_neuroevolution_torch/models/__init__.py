"""Policy models, resolved by the reference's model names
(gpu_implementation/es.py:144 looks models up by the config's "model")."""

from .core import Model  # noqa: F401
from .batchnorm import VirtualBNDQN  # noqa: F401
from .dqn import LargeDQN, LargeDQNXavier, SmallDQN, SmallDQNXavier  # noqa: F401

REGISTRY = {
    # GPU stack names (the reference's models/__init__.py)
    "Model": SmallDQN,
    "LargeModel": LargeDQN,
    "SmallDQN": SmallDQNXavier,
    "LargeDQN": LargeDQNXavier,
    "ModelVirtualBN": VirtualBNDQN,  # gpu_implementation es_atari_config.json
    # class names
    "VirtualBNDQN": VirtualBNDQN,
    "SmallDQNXavier": SmallDQNXavier,
    "LargeDQNXavier": LargeDQNXavier,
}


def get_model(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet; ported: {sorted(REGISTRY)}")
    return REGISTRY[name]
