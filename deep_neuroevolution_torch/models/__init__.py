"""Policy models, resolved by the reference's model names
(gpu_implementation/es.py:144 looks models up by the config's "model"; the
CPU stack by its "policy" type, es_distributed/es.py:136)."""

from .core import NONLINS, Model, dense  # noqa: F401
from .batchnorm import BNDQN, VirtualBNDQN  # noqa: F401
from .dqn import LargeDQN, LargeDQNXavier, SmallDQN, SmallDQNXavier  # noqa: F401
from .mlp import MLPContext, MujocoMLP, default_context  # noqa: F401
from .simple import ContinuousMLP, LinearClassifier, SimpleClassifier  # noqa: F401

REGISTRY = {
    # GPU stack names (the reference's models/__init__.py)
    "Model": SmallDQN,
    "LargeModel": LargeDQN,
    "SmallDQN": SmallDQNXavier,
    "LargeDQN": LargeDQNXavier,
    "ModelVirtualBN": VirtualBNDQN,  # gpu_implementation es_atari_config.json
    "ModelBN": BNDQN,  # gpu neuroevolution/models/batchnorm.py:24-49
    "LinearClassifier": LinearClassifier,
    "SimpleClassifier": SimpleClassifier,
    "ContinuousMLP": ContinuousMLP,
    # CPU stack policy names (es_distributed/policies.py)
    "MujocoPolicy": MujocoMLP,
    "ESAtariPolicy": VirtualBNDQN,
    "GAAtariPolicy": SmallDQN,
    # class names
    "VirtualBNDQN": VirtualBNDQN,
    "BNDQN": BNDQN,
    "SmallDQNXavier": SmallDQNXavier,
    "LargeDQNXavier": LargeDQNXavier,
}


def get_model(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet; ported: {sorted(REGISTRY)}")
    return REGISTRY[name]
