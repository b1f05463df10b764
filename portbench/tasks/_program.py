"""What the training tasks share: the program's run built through its own
entry point, the benchmark's weights and image pool put into it, the
readings of its first steps (the gradient as its optimizer got it, the
change of each parameter), and the reference's readings of the same steps."""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from cross_scale_mae_torch.train.state import tree_items
from portbench import inputs
from portbench.reference import common

RECIPE = ("blr", "warmup_epochs", "epochs", "min_lr", "weight_decay")


def parse(parser: argparse.ArgumentParser, flags: dict) -> argparse.Namespace:
    """The entry point's namespace from ``flags`` (flag -> value)."""
    argv = []
    for flag, value in flags.items():
        argv += [flag, str(value)]
    return argparse.ArgumentParser(parents=[parser]).parse_args(argv)


def check(what: str, pairs: dict[str, tuple]) -> None:
    """Raise where the program was built otherwise than the configuration states."""
    for name, (program, stated) in pairs.items():
        same = (abs(program - stated) <= 1e-9 * max(1.0, abs(stated))
                if isinstance(stated, float) else program == stated)
        if not same:
            raise ValueError(f"{what} {name}: the program runs {program!r}, "
                             f"the configuration states {stated!r}")


class Program:
    """A task's program side, ``rank`` of ``world`` processes (one a card,
    joined at ``coordinator``, host:port, in the mix's ``ddp_mode`` when
    ``world`` > 1). ``cli`` is the entry point's module, ``flags`` its
    flags beyond the recipe's and the runtime's, ``specs`` the reference's
    parameters (path, shape, kind)."""

    def __init__(self, cell, seed: int, device: torch.device, cli, flags: dict, specs: list,
                 rank: int = 0, world: int = 1, coordinator: str | None = None):
        self.cfg, self.mix, self.seed, self.device = cell.config, cell.mix, seed, device
        self.rank, self.world, self.specs = rank, world, specs
        self.batch, self.pool_size = self.mix["batch"], self.mix["pool"]
        flags = {**self.cfg["program"], **flags,
                 "--input_size": self.cfg["input_size"], "--patch_size": self.cfg["patch_size"],
                 "--batch_size": self.batch, "--synthetic_len": self.pool_size,
                 **{f"--{k}": self.mix[k] for k in RECIPE},
                 "--seed": seed % 2 ** 31, "--device": device.type, "--num_workers": 1}
        if world > 1:
            flags.update({"--coordinator_address": coordinator, "--num_processes": world,
                          "--process_id": rank, "--ddp_mode": self.mix["ddp_mode"]})
        t0 = time.time()
        self.run = cli.build_run(parse(cli.get_args_parser(), flags))
        self.build_s = time.time() - t0
        self.load_weights(inputs.weights(specs, seed, device))
        self.pool = inputs.image_pool(seed, self.pool_size, self.cfg["input_size"],
                                      self.cfg["in_chans"], device)
        self.images_per_step = self.batch

    def recipe(self, tcfg) -> tuple:
        """The program's recipe beside the mix's, for :func:`check`."""
        return tuple(getattr(tcfg, k) for k in RECIPE), tuple(self.mix[k] for k in RECIPE)

    def rows(self, k: int) -> torch.Tensor:
        """The pool rows of step ``k``, all of the global batch."""
        return inputs.step_rows(self.seed, k, self.pool_size, self.batch, self.device)

    def leaves(self) -> dict[tuple, torch.Tensor]:
        return dict(tree_items(self.run.state.params))

    @torch.no_grad()
    def load_weights(self, made: dict[tuple, torch.Tensor]) -> None:
        """Copy the benchmark's weights into the program's parameters, in
        place; the two must hold the same leaves at the same shapes."""
        mine = self.leaves()
        if set(mine) != set(made):
            diff = sorted(map(str, set(mine) ^ set(made)))[:4]
            raise ValueError(f"the program's parameters differ from the configuration's: {diff}")
        for path, leaf in mine.items():
            if tuple(leaf.shape) != tuple(made[path].shape):
                raise ValueError(f"{path}: {tuple(leaf.shape)} in the program, "
                                 f"{tuple(made[path].shape)} in the configuration")
            leaf.copy_(made[path])

    @torch.no_grad()
    def first_grads(self) -> dict[tuple, torch.Tensor]:
        """Each leaf's gradient as the optimizer got it at its first update,
        from Adam's first moment after it, m = (1 - b1) g, on the host
        (nought where the step left the optimizer's state as it was)."""
        state = self.run.state
        if state.opt_state.count > 1:
            raise RuntimeError("the first gradient is read before the second update")
        return {p: (m.float() / (1 - state.tx.b1)).cpu()
                for p, m in zip(self.leaves(), state.opt_state.mu)}

    @torch.no_grad()
    def deltas(self) -> dict[tuple, torch.Tensor]:
        """Each leaf's change from the benchmark's weights, on the host."""
        made = inputs.weights(self.specs, self.seed, self.device)
        return {k: (v.float() - made[k]).cpu() for k, v in self.leaves().items()}

    def release(self) -> None:
        """Free the program's run, and leave its process group."""
        self.run = None
        if self.world > 1:
            from cross_scale_mae_torch.parallel.dist import shutdown

            shutdown()

    def readings(self, loss_fn: Callable, decay: list[bool], scales: list[float],
                 steps: int) -> dict:
        """The reference's readings of the first ``steps`` steps from the
        benchmark's weights, ``loss_fn(tree, k)`` giving step k's loss."""
        common.ieee_fp32()
        opt = {"b1": self.cfg["adam_b1"], "b2": self.cfg["adam_b2"], "eps": self.cfg["adam_eps"],
               "batch": self.batch, **{k: self.mix[k] for k in RECIPE}}
        return common.train_readings(
            loss_fn, inputs.weights(self.specs, self.seed, self.device), opt,
            common.schedule(opt, self.pool_size // self.batch), decay, scales, steps)
