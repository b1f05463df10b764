"""ViT finetuning as users run it after pretraining: the run that
``cli/finetune.build_run`` builds from the configuration's and the mix's
flags (the recipe's drop-path, layer decay, label smoothing and
Mixup/CutMix), driven step by step through its ``step_fn(state, imgs,
labels, draws)`` with a fresh batch of the benchmark's pool and labels and
the benchmark's draws each step; the plain reference is ``reference/vit.py``."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.counts.flops import vit_train_flops
from portbench.reference import common, vit
from portbench.tasks._program import Program, check


class Task(Program):
    def __init__(self, cell, seed: int, device: torch.device):
        from cross_scale_mae_torch.cli import finetune as cli

        cfg, mix = cell.config, cell.mix
        flags = {"--embed_dim": cfg["embed_dim"], "--depth": cfg["depth"],
                 "--num_heads": cfg["num_heads"], "--nb_classes": cfg["num_classes"],
                 "--drop_path": cfg["drop_path_rate"], "--layer_decay": mix["layer_decay"],
                 "--smoothing": mix["smoothing"], "--mixup": mix["mixup"],
                 "--cutmix": mix["cutmix"], "--mixup_prob": mix["mixup_prob"],
                 "--mixup_switch_prob": mix["mixup_switch_prob"]}
        super().__init__(cell, seed, device, cli, flags, vit.param_specs(cfg))
        self._check()
        self.labels = inputs.labels(seed, self.pool_size, cfg["num_classes"], device)
        self.flops_per_image = vit_train_flops(cfg)
        grid = cfg["input_size"] // cfg["patch_size"]
        self.attention = {cfg["attention_kernel"]: [
            {"seqs": self.batch, "tokens": grid * grid + 1, "heads": cfg["num_heads"],
             "head_dim": cfg["embed_dim"] // cfg["num_heads"], "itemsize": 2,
             "layers": cfg["depth"]}]}

    def _check(self) -> None:
        from cross_scale_mae_torch.data.datasets import DATASET_STATS

        c, t, cfg, mix = self.run.cfg, self.run.tcfg, self.cfg, self.mix
        tx, m = self.run.state.tx, self.run.mixup
        mean, std = DATASET_STATS["synthetic"]
        check("finetune", {
            "embed_dim": (c.embed_dim, cfg["embed_dim"]), "depth": (c.depth, cfg["depth"]),
            "num_heads": (c.num_heads, cfg["num_heads"]),
            "mlp_ratio": (c.mlp_ratio, cfg["mlp_ratio"]),
            "num_classes": (c.num_classes, cfg["num_classes"]),
            "in_chans": (c.input_channels, cfg["in_chans"]),
            "drop_path_rate": (c.drop_path_rate, cfg["drop_path_rate"]),
            "head": ((c.global_pool, c.use_bn_head, c.gelu), (True, False, "tanh")),
            "compute_dtype": (c.compute_dtype, cfg["compute_dtype"]),
            "adam": ((tx.b1, tx.b2, tx.eps), (cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"])),
            "recipe": self.recipe(t),
            "layer_decay": (t.layer_decay, mix["layer_decay"]),
            "smoothing": (t.label_smoothing, mix["smoothing"]),
            "mixup": ((m.mixup_alpha, m.cutmix_alpha, m.prob, m.switch_prob, m.mode,
                       m.cutmix_minmax),
                      (mix["mixup"], mix["cutmix"], mix["mixup_prob"],
                       mix["mixup_switch_prob"], "batch", None)),
            "mean": (tuple(mean), tuple(mix["mean"])), "std": (tuple(std), tuple(mix["std"])),
            "steps_per_epoch": (self.run.steps_per_epoch, mix["pool"] // mix["batch"])})

    def draws(self, k: int) -> dict:
        return inputs.finetune_draws(self.seed, k, self.batch, self.cfg, self.mix, self.device)

    def step(self, k: int) -> torch.Tensor:
        """Step ``k`` of the program on its rows of the pool; its loss (0-d)."""
        from cross_scale_mae_torch.train.classify import FinetuneDraws
        from cross_scale_mae_torch.train.mixup import MixupDraws

        rows, d = self.rows(k), self.draws(k)
        draws = FinetuneDraws(d["hflip"], d["vflip"], d["crop_boxes"], d["drop_masks"],
                              mixup=MixupDraws(**d["mixup"]))
        _, metrics = self.run.step_fn(self.run.state, self.pool[rows], self.labels[rows], draws)
        return metrics["loss"]

    def reference(self, arith: common.Arith, rows: int | None = None, steps: int = 3) -> dict:
        """The reference's readings of the first ``steps`` steps, from the
        same weights and inputs; ``rows`` keeps that many rows of each batch."""

        def loss_fn(tree, k):
            idx = self.rows(k)
            imgs, labels, d = self.pool[idx], self.labels[idx], self.draws(k)
            if rows is not None:
                imgs, labels, d = imgs[:rows], labels[:rows], vit.keep_rows(d, rows)
            return vit.loss(arith, tree, self.cfg, self.mix, imgs, labels, d)

        return self.readings(loss_fn, vit.decay_mask(self.specs),
                             vit.layer_scales(self.specs, self.mix["layer_decay"],
                                              self.cfg["depth"]), steps)
