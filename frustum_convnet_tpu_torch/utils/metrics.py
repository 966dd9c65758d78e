"""Training observability: running averages and lazily-keyed metric states.

Equivalent surface to the reference's `utils/utils.py:51-67` (AverageMeter)
and `utils/training_states.py:5-51` (TrainingStates): accumulate loss/metric
dicts every step, emit one formatted line every ``disp`` steps.
"""

from __future__ import annotations

from collections import OrderedDict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class TrainingStates:
    """Ordered dict of AverageMeters keyed on first use."""

    def __init__(self):
        self.states: "OrderedDict[str, AverageMeter]" = OrderedDict()

    def update_states(self, values: dict, n: int = 1):
        for k, v in values.items():
            if k not in self.states:
                self.states[k] = AverageMeter()
            self.states[k].update(float(v), n)

    def get_states(self, avg: bool = True) -> dict:
        return {k: (m.avg if avg else m.val) for k, m in self.states.items()}

    def format_states(self, avg: bool = True) -> str:
        return " ".join(f"{k}:{v:.4f}" for k, v in self.get_states(avg).items())

    def reset(self):
        self.states.clear()
