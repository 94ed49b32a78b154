"""HyperMgr: per-model hyperparameters + PBT perturbation (§3.2).

Each model theta_i in the pool carries its own Hyperparam (learning rate,
gamma, Elo-matching sigma, z-statistics-like extras...). PBT [Jaderberg et
al. 2019] exploit/explore: a poorly-performing learner copies a stronger
population member's hypers and perturbs them multiplicatively.

Counterpart of `repro.core.hyper_mgr`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterable

from repro_torch.core.types import Hyperparam, ModelKey

PERTURBABLE = ("learning_rate", "entropy_coef", "clip_eps")


class HyperMgr:
    def __init__(self, default: Hyperparam | None = None, seed: int = 0,
                 perturb_factor: float = 1.2):
        self.default = default or Hyperparam()
        self._hypers: Dict[ModelKey, Hyperparam] = {}
        self._rng = random.Random(seed)
        self.perturb_factor = perturb_factor

    def register(self, key: ModelKey, hyper: Hyperparam | None = None) -> Hyperparam:
        h = hyper or dataclasses.replace(self.default)
        self._hypers[key] = h
        return h

    def get(self, key: ModelKey) -> Hyperparam:
        if key not in self._hypers:
            return self.register(key)
        return self._hypers[key]

    def inherit(self, child: ModelKey, parent: ModelKey) -> Hyperparam:
        h = dataclasses.replace(self.get(parent))
        self._hypers[child] = h
        return h

    # -- PBT -----------------------------------------------------------------
    def explore(self, key: ModelKey) -> Hyperparam:
        """Multiplicative perturbation of the perturbable fields."""
        h = self.get(key)
        updates = {}
        for f in PERTURBABLE:
            v = getattr(h, f)
            factor = self.perturb_factor if self._rng.random() < 0.5 else 1.0 / self.perturb_factor
            updates[f] = v * factor
        h2 = dataclasses.replace(h, **updates)
        self._hypers[key] = h2
        return h2

    def exploit_explore(self, weak: ModelKey, strong: ModelKey) -> Hyperparam:
        self.inherit(weak, strong)
        return self.explore(weak)
