"""Full-chain weights rehearsal (counterpart of
``this_and_that_vdm_tpu/cli/rehearsal.py``): every step that the published
checkpoints will take, on weights made here.

1. **synthesize** an HF-layout weight repo: seeded random weights at the
   real file and subfolder naming (``unet/``, ``gesturenet/``, ``vae/``,
   ``image_encoder/``, ``text_encoder/``, ``tokenizer/``, the training
   YAMLs; fp16 variant naming by default);
2. **render** the instances under ``--validation-path`` from it through
   ``cli.inference --pretrained`` (safetensors -> modules -> pipeline ->
   PNG / GIF tree), twice;
3. **gate** the second render against the first with ``cli.eval`` (PSNR
   >= 35), then perturb the UNet's weights, render again, and require that
   render to FAIL the gate (the negative control).

    python -m this_and_that_vdm_tpu_torch.cli.rehearsal --out OUT \\
        --validation-path INSTANCES [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

import torch

from ..weights import loader
from ..weights.export import save_hf_layout
from ..weights.safetensors_io import load_file, save_file
from .tokenizer import bytes_to_unicode

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "config")


def _write_tokenizer(out_dir: str):
    """A loadable CLIP BPE tokenizer folder (byte-level base vocab, no
    merges)."""
    d = os.path.join(out_dir, "tokenizer")
    os.makedirs(d, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in chars:
        vocab.setdefault(c, len(vocab))
    for c in chars:
        vocab.setdefault(c + "</w>", len(vocab))
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "model_max_length": 77}, f)
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}, f)


def synthesize_hf_repo(out_dir: str, scale: str = "tiny", seed: int = 0, variant: str = "",
                       device="cuda") -> str:
    """Seeded random weights (made on ``device``) in the published repos'
    layout (see the module docstring); ``variant="fp16"`` stores half
    precision under the ``.fp16`` file names."""
    os.makedirs(out_dir, exist_ok=True)
    for name, module in loader.random_models(scale, device, seed).items():
        save_hf_layout(module, out_dir, name, variant)
    _write_tokenizer(out_dir)
    # the YAMLs travel with the weights (reference inference.py:296-307)
    for name in ("train_image2video.yaml", "train_image2video_gesturenet.yaml"):
        src = os.path.join(CONFIG_DIR, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))
    return out_dir


def _perturb_unet(repo: str):
    """Add N(0, 0.5^2) noise to every float tensor of the unet shards (the
    negative control)."""
    gen = torch.Generator().manual_seed(99)
    for path in glob.glob(os.path.join(repo, "unet", "*.safetensors")):
        state = load_file(path)
        save_file({k: ((v.float() + 0.5 * torch.randn(v.shape, generator=gen)).to(v.dtype)
                       if v.is_floating_point() else v) for k, v in state.items()}, path)


def main(argv=None):
    from . import eval as eval_cli
    from . import inference as inf

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="ttv_rehearsal")
    p.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--variant", default="fp16",
                   help="safetensors variant naming ('' for unsuffixed)")
    p.add_argument("--validation-path", default=os.path.join("__assets__", "Bridge_example"))
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    p.add_argument("--keep", action="store_true", help="keep outputs")
    args = p.parse_args(argv)

    repo = synthesize_hf_repo(os.path.join(args.out, "weights"), args.scale,
                              variant=args.variant, device=args.device)
    print(f"synthesized HF-layout repo at {repo}")

    common = ["--model-type", "GestureNet", "--pretrained", repo,
              "--model-scale", args.scale, "--device", args.device, "--no-bake",
              "--validation-path", args.validation_path,
              "--height", str(args.height), "--width", str(args.width),
              "--num-frames", str(args.frames),
              "--num-inference-steps", str(args.steps), "--seed", "42"]
    a_dir, b_dir, c_dir = (os.path.join(args.out, f"render_{x}") for x in "abc")
    if not inf.main(common + ["--store-dir", a_dir]):
        raise SystemExit("no instances rendered: check --validation-path")
    inf.main(common + ["--store-dir", b_dir])
    report_ab = eval_cli.evaluate_trees(a_dir, b_dir, psnr_gate=35.0)
    ok_ab = report_ab.get("gate_pass", False)

    _perturb_unet(repo)
    inf.main(common + ["--store-dir", c_dir])
    report_ac = eval_cli.evaluate_trees(a_dir, c_dir, psnr_gate=35.0)
    # the negative control must FAIL the gate: a gate that cannot fail
    # proves nothing
    neg_fails = not report_ac.get("gate_pass", True)

    summary = dict(repo=repo, scale=args.scale, instances=report_ab.get("n_instances"),
                   identical_psnr_min=report_ab.get("psnr_min"), gate_pass=ok_ab,
                   perturbed_psnr_min=report_ac.get("psnr_min"),
                   negative_control_fails_gate=neg_fails,
                   rehearsal_ok=bool(ok_ab and neg_fails))
    print(json.dumps(summary))
    if not args.keep:
        for d in (a_dir, b_dir, c_dir):
            shutil.rmtree(d, ignore_errors=True)
    return 0 if summary["rehearsal_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
