"""A copy of the benchmark at a tiny size, for the CPU tests: the same files
with the configurations' widths, depths and frames cut so that a run takes
seconds on the CPU, and the cells held out under ``pending/`` put back into
its ``BENCHMARK.json``.  The limits stay those of the full size."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

UNET = dict(in_channels=8, out_channels=4, block_out_channels=[32, 64, 64, 64],
            num_attention_heads=[2, 2, 2, 4], cross_attention_dim=48, addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24, layers_per_block=2)
MODELS = dict(
    unet=UNET,
    gesturenet=dict(UNET, num_attention_heads=[2, 2, 4, 4]),
    vae=dict(block_out_channels=[32, 32, 64, 64], layers_per_block=2, latent_channels=4,
             scaling_factor=0.18215),
    image_encoder=dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
                       patch_size=56, image_size=224, projection_dim=48, layer_norm_eps=1e-5),
    text_encoder=dict(vocab_size=49408, hidden_size=48, num_layers=1, num_heads=4,
                      intermediate_size=64, max_positions=77, layer_norm_eps=1e-5))
FRAMES, HEIGHT, WIDTH = 4, 128, 192


def tiny_root(tmp: Path) -> Path:
    """A checkout holding ``BENCHMARK.json`` (with the pending cells) and
    ``benchmark/`` at the tiny size."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "benchmark" / "pending").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["models"] = {k: v for k, v in MODELS.items() if k in cfg["models"]}
        if "sampling" in cfg:
            cfg["sampling"].update(height=HEIGHT, width=WIDTH, num_frames=FRAMES,
                                   num_inference_steps=2, decode_chunk_size=3)
        if "batch" in cfg:
            cfg["batch"].update(num_frames=FRAMES, height=HEIGHT, width=WIDTH)
            cfg["train"].update(video_seq_length=FRAMES, height=HEIGHT, width=WIDTH)
        path.write_text(json.dumps(cfg))
    return root
