"""Learning-rate schedules as plain functions of the update count that return
a float (counterpart of gdrnet_tpu/solver/schedulers.py).

flat_and_anneal is the reference's flat_and_anneal_lr_scheduler: an optional
warmup, flat at the base LR until anneal_point * total_iters, then a
cosine / linear / poly / exp / step anneal to target_lr_factor. A schedule is
called with the number of optimizer updates made so far, so the first update
uses schedule(0) (optax.scale_by_schedule's convention).
"""

from __future__ import annotations

import math


def _warmup_factor(x: float, warmup_iters: int, warmup_factor: float,
                   warmup_method: str) -> float:
    if warmup_method == "linear" and warmup_iters > 0:
        alpha = x / warmup_iters
        return warmup_factor * (1 - alpha) + alpha
    return warmup_factor


def flat_and_anneal_schedule(
    base_lr: float,
    total_iters: int,
    warmup_iters: int = 0,
    warmup_factor: float = 0.1,
    warmup_method: str = "linear",
    anneal_point: float = 0.72,
    anneal_method: str = "cosine",
    target_lr_factor: float = 0.0,
    poly_power: float = 1.0,
    step_gamma: float = 0.1,
    steps=(2 / 3.0, 8 / 9.0),
):
    """Returns schedule(step) -> lr."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"bad warmup_method {warmup_method}")
    if anneal_method not in ("cosine", "linear", "poly", "exp", "step", "none"):
        raise ValueError(f"bad anneal_method {anneal_method}")
    if anneal_method == "step":
        if any(s < warmup_iters / max(total_iters, 1) or s > 1 for s in steps):
            raise ValueError(f"steps {steps} out of range")
        if list(steps) != sorted(steps):
            raise ValueError(f"steps {steps} not ascending")
        anneal_start = steps[0] * total_iters
        milestones = [s * total_iters for s in steps]
    else:
        if not 0 <= anneal_point <= 1:
            raise ValueError(f"anneal_point {anneal_point} not in [0,1]")
        anneal_start = anneal_point * total_iters
    denom = max(total_iters - anneal_start, 1e-8)

    def schedule(step) -> float:
        x = float(step)
        if x < warmup_iters:
            return base_lr * _warmup_factor(x, warmup_iters, warmup_factor, warmup_method)
        if x < anneal_start:
            return base_lr
        frac = (x - anneal_start) / denom
        if anneal_method == "cosine":
            af = target_lr_factor + 0.5 * (1 - target_lr_factor) * (1 + math.cos(math.pi * frac))
        elif anneal_method == "linear":
            af = target_lr_factor + (1 - target_lr_factor) * (1 - frac)
        elif anneal_method == "poly":
            af = target_lr_factor + (1 - target_lr_factor) * max(1 - frac, 0.0) ** poly_power
        elif anneal_method == "exp":
            af = max(target_lr_factor, 5e-3) ** frac
        elif anneal_method == "step":
            af = step_gamma ** sum(x >= m for m in milestones)
        else:
            af = 1.0
        return base_lr * af

    return schedule


def warmup_multistep_schedule(base_lr: float, milestones, gamma: float = 0.1,
                              warmup_iters: int = 1000, warmup_factor: float = 1e-3,
                              warmup_method: str = "linear"):
    """detectron2 WarmupMultiStepLR semantics."""
    ms = sorted(milestones)

    def schedule(step) -> float:
        x = float(step)
        factor = gamma ** sum(x >= m for m in ms)
        if x < warmup_iters:
            factor *= _warmup_factor(x, warmup_iters, warmup_factor, warmup_method)
        return base_lr * factor

    return schedule


def warmup_cosine_schedule(base_lr: float, total_iters: int, warmup_iters: int = 1000,
                           warmup_factor: float = 1e-3):
    def schedule(step) -> float:
        x = float(step)
        if x < warmup_iters:
            alpha = x / max(warmup_iters, 1)
            return base_lr * (warmup_factor * (1 - alpha) + alpha)
        return base_lr * 0.5 * (1 + math.cos(math.pi * x / max(total_iters, 1)))

    return schedule


def build_lr_schedule(cfg, base_lr: float, total_iters: int, steps_per_update: int = 1):
    """SOLVER config -> schedule. `steps_per_update` is the gradient
    accumulation factor: the schedule counts optimizer updates, one per k
    train steps, so total_iters and the iteration-counted WARMUP_ITERS are
    divided by k; the relative knobs (REL_STEPS, ANNEAL_POINT) are not."""
    k = max(int(steps_per_update), 1)
    total_iters = -(-total_iters // k)
    warmup = max(1, cfg.SOLVER.WARMUP_ITERS // k) if cfg.SOLVER.WARMUP_ITERS else 0

    name = cfg.SOLVER.LR_SCHEDULER_NAME
    if name == "flat_and_anneal":
        return flat_and_anneal_schedule(
            base_lr, total_iters,
            warmup_iters=warmup,
            warmup_factor=cfg.SOLVER.WARMUP_FACTOR,
            warmup_method=cfg.SOLVER.WARMUP_METHOD,
            anneal_point=cfg.SOLVER.ANNEAL_POINT,
            anneal_method=cfg.SOLVER.ANNEAL_METHOD,
            # the reference misspells this key "TARTGET_LR_FACTOR": accept both
            target_lr_factor=cfg.SOLVER.get(
                "TARGET_LR_FACTOR", cfg.SOLVER.get("TARTGET_LR_FACTOR", 0.0)),
            poly_power=cfg.SOLVER.POLY_POWER,
            step_gamma=cfg.SOLVER.GAMMA,
            steps=tuple(cfg.SOLVER.REL_STEPS),
        )
    if name == "WarmupMultiStepLR":
        return warmup_multistep_schedule(
            base_lr, [s * total_iters for s in cfg.SOLVER.REL_STEPS], gamma=cfg.SOLVER.GAMMA,
            warmup_iters=warmup, warmup_factor=cfg.SOLVER.WARMUP_FACTOR,
            warmup_method=cfg.SOLVER.WARMUP_METHOD)
    if name == "WarmupCosineLR":
        return warmup_cosine_schedule(base_lr, total_iters, warmup_iters=warmup,
                                      warmup_factor=cfg.SOLVER.WARMUP_FACTOR)
    raise ValueError(f"Unknown LR scheduler: {name}")
