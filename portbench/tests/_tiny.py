"""A copy of the benchmark at test size: the two configurations cut to
widths a CPU holds (the tiny MAE preset, a 4-block ViT), each mix at 8
images from a pool of 32, and limits set from these sizes' own readings on
the CPU (seeds 5-7: the program's gaps below 5e-3 and grad_err below 1.7e-2, the
float8 control's grad_gap above 1.3e-2 and grad_err above 8e-2, half a batch above 5e-2)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 7
LIMITS = {"loss_gap": 6e-3, "grad_gap": 8e-3, "change_gap": 6e-3, "grad_err": 4e-2}
CELLS = {"tiny_pre": ("tiny_mae", "tiny_pretrain"), "tiny_ft": ("tiny_vit", "tiny_finetune")}
GANG = {"tiny_dp": ("tiny_mae", "tiny_pretrain_dp", 4)}   # four gloo ranks


def make(dest: Path) -> Path:
    """``dest`` with ``BENCHMARK.json`` and ``portbench/`` as in the repo,
    plus the two test-size cells; returns ``dest``."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    mae = json.loads((pb / "configs/mae_vit_base_MsLdCeCd_in128.json").read_text())
    mae.update(program={"--model": "mae_vit_tiny_MsLdCeCd", "--attention_impl": "pallas_v3",
                        "--compute_dtype": "bfloat16"},
               input_size=32, patch_size=8, embed_dim=128, depth=4, num_heads=8,
               decoder_embed_dim=256, decoder_depth=4, decoder_num_heads=8)
    vit = json.loads((pb / "configs/vit_large_in64_p8_c62.json").read_text())
    vit.update(program={"--model": "vit_base_patch16", "--attention_impl": "pallas",
                        "--compute_dtype": "bfloat16"},
               input_size=32, patch_size=8, embed_dim=128, depth=4, num_heads=8, num_classes=5)
    for name, conf in (("tiny_mae", mae), ("tiny_vit", vit)):
        (pb / f"configs/{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test", "why": "test",
                                 "file": f"portbench/configs/{name}.json", "reduced": []})
    for name, mix in (("tiny_pretrain", "pretrain_b512_pool4096"),
                      ("tiny_finetune", "finetune_b512_mix_pool4096"),
                      ("tiny_pretrain_dp", "pretrain_b2048_dp4_pool16384")):
        m = json.loads((pb / f"mixes/{mix}.json").read_text())
        m.update(batch=8, pool=32, trace_steps=2)
        (pb / f"mixes/{name}.json").write_text(json.dumps(m))
    for cell, (conf, mix, chips) in {**{k: (*v, 1) for k, v in CELLS.items()},
                                     **GANG}.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": mix,
                                   "chips": chips, "why": "test"})
        (pb / f"limits/{cell}.json").write_text(json.dumps(LIMITS))
    for metric in bench["per_layer"]:
        metric["workloads"] += [*CELLS, *GANG]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
