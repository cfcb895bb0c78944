"""Training loop with checkpoint/restart, failure injection and
deterministic data sharding: the port of ``repro/train/trainer.py``.

- Restart: ``run()`` resumes from the latest committed checkpoint (the
  port's ``checkpoint.save``/``restore``, in the reference's format: the
  tree is ``(params, opt_state)`` as the reference's trainer saves it,
  float32 parameters (the masters where the working copies are bf16),
  so either package reads the other's checkpoint); the data pipeline is
  stateless (step -> docs is arithmetic), so resume is exact.
- Node failure: ``FailureInjector`` raises at a chosen step in tests; a
  restart loses nothing past the last commit and skips or repeats no
  batch.
- Stragglers: ``data.pipeline.reassign_straggler`` re-splits a dead
  shard's documents among the survivors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint.checkpoint import latest_step, restore, save
from ..convert import (
    load_lm_params,
    lm_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from ..core.layout import resolve_device
from ..data.pipeline import DataConfig, ShardInfo, get_batch
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig
from .train_step import make_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    accum: int = 1
    log_every: int = 10
    seed: int = 0


class FailureInjector:
    """Raises at a chosen step — restart-path testing hook."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


def _state_tree(lm, opt_state) -> tuple:
    """``(params, opt_state)`` as the reference's trainer holds them: the
    float32 parameters (the masters where the state has them) and the
    moments and step."""
    return (lm_params_to_numpy(lm, opt_state.get("master")),
            opt_state_to_numpy(lm, opt_state))


def _load_state(lm, opt_state, tree) -> dict:
    """A restored ``(params, opt_state)`` tree into ``lm`` (working copies
    cast from the float32 parameters) and a new optimizer state, with
    masters from those parameters where ``opt_state`` kept them."""
    params, opt = tree
    load_lm_params(lm, params)
    if "master" in opt_state:
        opt = {**opt, "master": params}
    return opt_state_from_numpy(lm, opt)


def run(model_cfg: ModelConfig, data_cfg: DataConfig, opt_cfg: AdamWConfig,
        tcfg: TrainerConfig, *, shard: ShardInfo = ShardInfo(),
        failure: Optional[FailureInjector] = None,
        log: Callable[[str], None] = print, device=None):
    """Returns ``(lm, opt_state, history)``.  Weights come from a
    ``torch.Generator`` seeded with ``tcfg.seed`` on the device (the card
    unless ``device`` names another)."""
    dev = resolve_device(device)
    step_fn = make_train_step(model_cfg, opt_cfg, accum=tcfg.accum)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    lm, opt_state = make_train_state(model_cfg, gen, device=dev)

    start = 0
    if tcfg.checkpoint_dir and latest_step(tcfg.checkpoint_dir) is not None:
        start, tree = restore(tcfg.checkpoint_dir, _state_tree(lm, opt_state),
                              device=dev)
        opt_state = _load_state(lm, opt_state, tree)
        log(f"[trainer] resumed from step {start}")

    history = []
    t0 = time.perf_counter()
    for step in range(start, tcfg.total_steps):
        if failure is not None:
            failure.maybe_fail(step)
        raw = get_batch(data_cfg, step, shard)
        batch = {"tokens": torch.from_numpy(raw["tokens"]),
                 "labels": torch.from_numpy(raw["labels"])}
        lm, opt_state, metrics = step_fn(lm, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss})
            dt = time.perf_counter() - t0
            log(f"[trainer] step {step:5d} loss {loss:.4f} "
                f"({dt / max(step - start + 1, 1) * 1e3:.0f} ms/step)")
        if (tcfg.checkpoint_dir
                and (step + 1) % tcfg.checkpoint_every == 0):
            save(tcfg.checkpoint_dir, step + 1, _state_tree(lm, opt_state))
    return lm, opt_state, history
