"""Learning-rate schedules as step -> lr functions.

Port of simplenerf_tpu/training/lr_decay.py.
NeRF exponential decay: lr = lr_init * 0.1^(step / (lr_decay * 1000))
(reference NeRFLearningRateDecayer01). MipNeRF log-lerp with sine warmup
(reference MipNeRFLearningRateDecayer01).
"""

from __future__ import annotations

import math


def nerf_exponential(lr_init: float, lr_decay_thousands: float):
    decay_steps = lr_decay_thousands * 1000.0

    def schedule(step) -> float:
        return lr_init * (0.1 ** (step / decay_steps))

    return schedule


def mipnerf_loglerp(lr_init: float, lr_final: float, max_steps: int, lr_delay_steps: int = 0,
                    lr_delay_mult: float = 1.0):
    def schedule(step) -> float:
        if lr_delay_steps > 0:
            frac = min(max(step / lr_delay_steps, 0.0), 1.0)
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(0.5 * math.pi * frac)
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay_rate * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return schedule


def make_lr_schedule(optimizer_configs: dict, num_iterations: int = 0):
    name = optimizer_configs.get("lr_decayer_name", "NeRFLearningRateDecayer01")
    if name.startswith("NeRF"):
        return nerf_exponential(optimizer_configs["lr_initial"], optimizer_configs["lr_decay"])
    if name.startswith("MipNeRF"):
        return mipnerf_loglerp(
            optimizer_configs["lr_initial"],
            optimizer_configs.get("lr_final", optimizer_configs["lr_initial"] * 0.01),
            optimizer_configs.get("max_steps", num_iterations or 1),
            optimizer_configs.get("lr_delay_steps", 0),
            optimizer_configs.get("lr_delay_mult", 1.0),
        )
    raise ValueError(f"Unknown lr decayer: {name}")
