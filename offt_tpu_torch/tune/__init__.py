"""Auto-tuning: search space, strategies, tuning loop (the Active Harmony
re-expression; SURVEY.md §2b). Port of ``offt_tpu/tune``: the search
space, the strategies and layers, ``tune()`` on the port's plans (CUDA
events on a card), the tuning service, its client, the ``tuna``-style
CLI (``python -m offt_tpu_torch.tune.cli``) and the native C++ engine
(``engine_cpp``)."""

from .layers import (
    FilterLayer,
    Layer,
    PenaltyLayer,
    TransformLayer,
)
from .space import Dimension, SearchSpace, build_space
from .strategies import (
    STRATEGIES,
    BruteStrategy,
    NelderMead,
    PROStrategy,
    RandomStrategy,
    make_strategy,
)
from .tuner import Tuner, TuneResult, tune

__all__ = [
    "STRATEGIES", "BruteStrategy", "Dimension", "FilterLayer", "Layer",
    "NelderMead", "PROStrategy", "PenaltyLayer", "RandomStrategy",
    "SearchSpace", "TransformLayer", "Tuner", "TuneResult", "build_space",
    "make_strategy", "tune",
]
