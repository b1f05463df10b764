#!/usr/bin/env python3
"""``chip_smoke.py``'s [mesh] phase on every card of one host: with two or
more cards its multi-card branch runs --zero1, --fsdp and --num_slices 1
(and, at an even count, --model_parallel 2 with and without
--sequence_parallel, and with the Nystrom, orthoformer and Fourier-mix
attentions) through ``cli/pretrain.main`` at the flagship's width, one
process per card, each held to the one-card run of the same draws and
attention, and the tp 2 controls, two of which must miss the gate. The
kernels are built first, as the script builds them.

    python3 tools/mesh_cards.py          # a host with 2 or more GPUs
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    cards = chip_smoke.torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"tools/mesh_cards.py needs two or more GPUs, found {cards}")
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    fwd, bwd = chip_smoke.phase_mesh(card)
    print(json.dumps({"mesh_k1_launches": [fwd, bwd], "cards": cards}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
