"""Hyperparameter space: the KerasTuner-compatible subset the reference used
(the port's copy of ``cloud_tpu/tuner/hyperparameters.py``).

Reference analogue: the KerasTuner ``HyperParameters`` surface consumed by
``tuner/utils.py`` converters (Choice/Int/Float/Boolean/Fixed, linear/log
sampling — utils.py:220-282).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Choice:
    name: str
    values: Sequence[Any]
    default: Any = None

    def sample(self, rng: random.Random):
        return rng.choice(list(self.values))

    def default_value(self):
        return self.default if self.default is not None else self.values[0]


@dataclasses.dataclass(frozen=True)
class Int:
    name: str
    min_value: int
    max_value: int
    step: int = 1
    sampling: str = "linear"

    def sample(self, rng: random.Random):
        if self.sampling == "log":
            lo, hi = math.log(self.min_value), math.log(self.max_value)
            return int(round(math.exp(rng.uniform(lo, hi))))
        n_steps = (self.max_value - self.min_value) // self.step
        return self.min_value + self.step * rng.randint(0, n_steps)

    def default_value(self):
        return self.min_value


@dataclasses.dataclass(frozen=True)
class Float:
    name: str
    min_value: float
    max_value: float
    sampling: str = "linear"

    def sample(self, rng: random.Random):
        if self.sampling == "log":
            lo, hi = math.log(self.min_value), math.log(self.max_value)
            return math.exp(rng.uniform(lo, hi))
        return rng.uniform(self.min_value, self.max_value)

    def default_value(self):
        return self.min_value


@dataclasses.dataclass(frozen=True)
class Boolean:
    name: str
    default: bool = False

    def sample(self, rng: random.Random):
        return rng.choice([False, True])

    def default_value(self):
        return self.default


@dataclasses.dataclass(frozen=True)
class Fixed:
    name: str
    value: Any

    def sample(self, rng: random.Random):
        return self.value

    def default_value(self):
        return self.value


class HyperParameters:
    """Declarative search space + concrete values for one trial.

    In a hypermodel, ``hp.Float("lr", 1e-5, 1e-2, sampling="log")`` both
    *registers* the dimension and *returns* the current trial's value.
    """

    def __init__(self):
        self.space: List[Any] = []
        self.values: Dict[str, Any] = {}

    def _register(self, spec) -> Any:
        existing = {s.name: s for s in self.space}
        if spec.name not in existing:
            self.space.append(spec)
        if spec.name not in self.values:
            self.values[spec.name] = spec.default_value()
        return self.values[spec.name]

    def Choice(self, name, values, default=None):
        return self._register(Choice(name, tuple(values), default))

    def Int(self, name, min_value, max_value, step=1, sampling="linear"):
        return self._register(Int(name, min_value, max_value, step, sampling))

    def Float(self, name, min_value, max_value, sampling="linear"):
        return self._register(Float(name, min_value, max_value, sampling))

    def Boolean(self, name, default=False):
        return self._register(Boolean(name, default))

    def Fixed(self, name, value):
        return self._register(Fixed(name, value))

    def get(self, name: str) -> Any:
        return self.values[name]

    def copy_with_values(self, values: Dict[str, Any]) -> "HyperParameters":
        hp = HyperParameters()
        hp.space = list(self.space)
        hp.values = dict(self.values)
        hp.values.update(values)
        return hp

    def sample(self, rng: Optional[random.Random] = None) -> Dict[str, Any]:
        rng = rng or random.Random()
        return {spec.name: spec.sample(rng) for spec in self.space}
