"""Cross-Scale MAE pretraining as users run it: the run that
``cli/pretrain.build_run`` builds from the configuration's and the mix's
flags, driven step by step through its ``step_fn(state, batch, draws)``
with a fresh batch of the benchmark's image pool and the benchmark's draws
each step; the plain reference is ``reference/mae.py``. On several cards
each rank is fed its rows (rank::world) of every global batch and of its
draws, as the program's own data path shards them."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.counts.flops import mae_train_flops
from portbench.reference import common, mae
from portbench.tasks._program import Program, check


class Task(Program):
    def __init__(self, cell, seed: int, device: torch.device, rank: int = 0, world: int = 1,
                 coordinator: str | None = None):
        from cross_scale_mae_torch.cli import pretrain as cli

        cfg = cell.config
        super().__init__(cell, seed, device, cli, {"--mask_ratio": cfg["mask_ratio"]},
                         mae.param_specs(cfg), rank, world, coordinator)
        self._check()
        self.flops_per_image = mae_train_flops(cfg)
        grid = cfg["input_size"] // cfg["patch_size"]
        keep = int(grid * grid * (1 - cfg["mask_ratio"]))
        seqs = 2 * self.batch // world
        self.attention = {cfg["attention_kernel"]: [
            {"seqs": seqs, "tokens": keep + 1, "heads": cfg["num_heads"],
             "head_dim": cfg["embed_dim"] // cfg["num_heads"], "itemsize": 2,
             "layers": cfg["depth"]},
            {"seqs": seqs, "tokens": grid * grid + 1, "heads": cfg["decoder_num_heads"],
             "head_dim": cfg["decoder_embed_dim"] // cfg["decoder_num_heads"], "itemsize": 2,
             "layers": cfg["decoder_depth"]}]}

    def _check(self) -> None:
        c, t, cfg, mix = self.run.cfg, self.run.tcfg, self.cfg, self.mix
        check("pretrain", {
            "embed_dim": (c.dim_model, cfg["embed_dim"]),
            "depth": (c.encoder_num_layers, cfg["depth"]),
            "num_heads": (c.encoder_num_heads, cfg["num_heads"]),
            "decoder_embed_dim": (c.decoder_embed_dim, cfg["decoder_embed_dim"]),
            "decoder_depth": (c.decoder_num_layers, cfg["decoder_depth"]),
            "decoder_num_heads": (c.decoder_num_heads, cfg["decoder_num_heads"]),
            "mlp_ratio": (c.ffn_ratio, cfg["mlp_ratio"]),
            "in_chans": (c.input_channels, cfg["in_chans"]),
            "predictor_hidden_size": (c.predictor_hidden_size, cfg["predictor_hidden_size"]),
            "ntxent_tau": (c.ntxent_tau, cfg["ntxent_tau"]),
            "ms_range": (tuple(c.ms_range), tuple(cfg["ms_range"])),
            "ms_aspect_ratio": (tuple(c.ms_aspect_ratio), tuple(cfg["ms_aspect_ratio"])),
            "terms": ((c.multi_scale, c.use_cd_pred, c.use_ce_ntxent, c.use_ce_pred, c.use_le,
                       c.use_perceptual, c.apply_encoder_norm, c.norm_pix_loss, c.loss,
                       c.ms_decoder_loss_reduction, c.ms_per_sample_crop, c.gelu,
                       c.residual_norm_style),
                      (True, True, True, False, False, False, False, False, "mse", "sum", True,
                       "tanh", "pre")),
            "compute_dtype": (c.compute_dtype, cfg["compute_dtype"]),
            "adam": ((t.adam_b1, t.adam_b2, self.run.state.tx.eps),
                     (cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"])),
            "recipe": self.recipe(t),
            "mean": (tuple(self.run.mean), tuple(mix["mean"])),
            "std": (tuple(self.run.std), tuple(mix["std"])),
            "steps_per_epoch": (self.run.steps_per_epoch, mix["pool"] // mix["batch"])})

    def draws(self, k: int) -> dict:
        return inputs.pretrain_draws(self.seed, k, self.batch, self.cfg, self.mix, self.device)

    def step(self, k: int) -> torch.Tensor:
        """Step ``k`` of the program on its rows of the pool; its loss (0-d)."""
        from cross_scale_mae_torch.train.pretrain import PretrainDraws

        draws = PretrainDraws(**self.draws(k)).shard(self.rank, self.world)
        _, metrics = self.run.step_fn(self.run.state,
                                      self.pool[self.rows(k)[self.rank::self.world]], draws)
        return metrics["loss"]

    def reference(self, arith: common.Arith, rows: int | None = None, steps: int = 3) -> dict:
        """The reference's readings of the first ``steps`` steps, from the
        same weights and inputs; ``rows`` keeps that many rows of each batch."""

        def loss_fn(tree, k):
            imgs, d = self.pool[self.rows(k)], self.draws(k)
            if rows is not None:
                imgs, d = imgs[:rows], mae.keep_rows(d, rows)
            return mae.loss(arith, tree, self.cfg, self.mix, imgs, d)

        return self.readings(loss_fn, mae.decay_mask(self.specs), [1.0] * len(self.specs), steps)
