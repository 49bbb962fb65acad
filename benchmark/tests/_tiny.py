"""A copy of the benchmark tree with tiny cells, for the CPU tests.

``make(root)`` copies ``BENCHMARK.json`` and ``benchmark/`` under ``root`` and
adds a tiny configuration (the real one's keys at test widths, float32) and
tiny traffic of both kinds, each cell listed where its real twin is.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"tiny-video": "vface-512-video", "tiny-image": "reface-1024-image"}


def make(root: Path) -> Path:
    shutil.copytree(REPO / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/sd1-inpaint-512.json").read_text())
    cfg["image_size"] = 32
    cfg["unet"].update(model_channels=32, num_res_blocks=1, channel_mult=[1, 2], num_heads=4, context_dim=64,
                       dtype="float32")
    cfg["vae"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, dtype="float32")
    cfg["cond"]["clip"].update(image_size=32, patch_size=8, width=64, layers=2, heads=4, projection_dim=64)
    cfg["cond"].update(context_dim=64, arcface_stages=[[16, 1], [32, 1]])
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    video = json.loads((REPO / "benchmark/traffic/video-clip-12.json").read_text())
    video.update(frames=4, height=48, width=64, window=2, ddim_steps=2, inversion_steps=3, raft_iters=2,
                 parser_size=64)
    (root / "benchmark/traffic/tiny-video.json").write_text(json.dumps(video))
    image = json.loads((REPO / "benchmark/traffic/image-pairs-4.json").read_text())
    image.update(ddim_steps=2)
    (root / "benchmark/traffic/tiny-image.json").write_text(json.dumps(image))
    bench["configs"].append({"name": "tiny", "source": "tests", "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    for name, twin in TINY.items():
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1, "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
