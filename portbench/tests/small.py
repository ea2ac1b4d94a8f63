"""Small configurations and mixes for the benchmark's CPU tests: the
benchmarked configurations' kinds of layers at widths a test can hold."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def config_doc(name: str = "conformer_m") -> dict:
    doc = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    doc = copy.deepcopy(doc)
    doc["config"]["model"].update(
        encoder_layers=2, encoder_dim=64, encoder_ffn_dim=128,
        subsample_channels=16, decoder_layers=1, decoder_dim=64,
        vocab_size=32)
    return doc


SERVE_MIX = {"mode": "serve", "batch": 3, "seconds": [1.0, 2.0],
             "grid_seconds": 2.0, "pool": 3, "judged_requests": 2}
TRAIN_MIX = {"mode": "train", "batch": 4, "seconds": [1.0, 2.0],
             "grid_seconds": 2.0, "tokens": [4, 8], "pool": 4,
             "spec_augment": True, "compared_steps": 3}


def bench() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())
