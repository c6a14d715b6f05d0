"""Where XMem's frame-1 probabilities part between the card and the CPU.

Phase 11 of ``chip_smoke.py`` holds XMem-s012's frame-1 probabilities on the
card against the port on the CPU (fp32, TF32 off on the card).  This script
reruns that reading on the phase's scene (a frame pair and the gripper's box
as the first mask), with frames stored as PNG (exact pixels) and as JPEG (the
port's encoder, as ``cv2.imwrite`` writes them), for several weight seeds,
each twice on the card, and says where the error sits:

- the probability error (max abs over max abs CPU value), its pixel, and the
  two sides' values there; the logits' error at the same pixel (the largest
  over the objects);
- the memory similarity's error, and the query tokens whose top-k memory set
  (``top_k`` 30) differs between the two sides, with the CPU's gap between the
  k-th and (k+1)-th similarity there (a near-tie when it is small);
- the readout's error over the tokens whose top-k sets agree, and over all;
- the same probabilities with the top-k cut switched off (a softmax over all
  of memory): what is left of the error without the discrete selection.

Run from the repo root on a machine with a card::

    python3 xmem_divergence.py [--seeds 91 92 93] [--starts 0 5] [--hw 480 640]

It prints one JSON line a case and writes them all to
``chiprun_out/xmem_divergence.json``.  ``--device cpu`` runs both sides on
the CPU (a dry run at a small ``--hw``).
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch


def scene(hw, start, seed=77):
    """Frames ``start`` and ``start + 1`` of phase 10's first instance and
    the paint's box in the first (the gripper, which phase 11 clicks)."""
    import chip_smoke as cs

    bg = cs.instance_image(seed, hw)
    frames = [cs.curation_frame(bg, i) for i in (start, start + 1)]
    (x0, y0), (dx, dy), (bw, bh) = cs.CURATION["start"], cs.CURATION["step"], cs.CURATION["box"]
    x0, y0 = x0 + dx * start, y0 + dy * start
    mask = np.zeros(hw, bool)
    mask[y0:y0 + bh, x0:x0 + bw] = True
    return frames, mask


def stored(frames, fmt, root):
    """The frames as written to ``im_N.jpg`` in ``fmt`` and read back."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    out = []
    for i, f in enumerate(frames):
        path = os.path.join(root, f"{fmt}_{i}.jpg")
        (video_io.write_jpeg if fmt == "jpeg" else video_io.write_png)(path, f)
        out.append(video_io.read_image(path))
    return out


def readings(model, frames, mask, top_k):
    """Frame 1's probabilities and logits, and what its memory read saw:
    similarity, top-k indices, readout."""
    from this_and_that_vdm_tpu_torch.curation import xmem_tracker as xt

    seen = {}
    topk_softmax, match = xt.topk_softmax, xt.MemoryManager.match_memory
    segment = model.segment

    def rec_topk(sim, k=None, **kw):
        seen["sim"] = sim.detach().cpu()
        return topk_softmax(sim, k, **kw)

    def rec_match(self, *a):
        out = match(self, *a)
        seen["readout"] = out.detach().cpu()
        return out

    def rec_segment(*a, **kw):
        out = segment(*a, **kw)
        seen["logits"] = out[1].detach().cpu()
        return out

    cfg = dict(xt.DEFAULT_CONFIG, top_k=top_k)
    core = xt.XMemInferenceCore(model, cfg)
    core.set_all_labels([1])
    xt.topk_softmax, xt.MemoryManager.match_memory, model.segment = (rec_topk, rec_match,
                                                                     rec_segment)
    try:
        with torch.no_grad():
            core.step(frames[0].astype(np.float32) / 255.0, mask[None].astype(np.float32))
            seen.clear()
            seen["prob"] = core.step(frames[1].astype(np.float32) / 255.0).cpu()
    finally:
        xt.topk_softmax, xt.MemoryManager.match_memory = topk_softmax, match
        del model.segment
    return seen


def compare(got, want, k, tok_hw):
    """The error of ``got`` against ``want`` and where it sits."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    d = (got["prob"] - want["prob"]).abs()
    at = np.unravel_index(int(d.argmax()), tuple(d.shape))
    out = dict(prob=rel(got["prob"], want["prob"]), prob_at=[int(i) for i in at],
               prob_card=float(got["prob"][at]), prob_cpu=float(want["prob"][at]),
               logits=rel(got["logits"], want["logits"]),
               logit_err_at=float((got["logits"] - want["logits"]).abs()[0, :, at[-2],
                                                                        at[-1]].max()),
               sim=rel(got["sim"], want["sim"]))
    sim_c, sim_g = want["sim"][0], got["sim"][0]  # [P, N]
    if k < sim_c.shape[-1]:
        ic = torch.topk(sim_c, k, -1).indices.sort(-1).values
        ig = torch.topk(sim_g, k, -1).indices.sort(-1).values
        differ = (ic != ig).any(-1)  # [P]
        top = torch.topk(sim_c, k + 1, -1).values
        gap = top[:, k - 1] - top[:, k]
        ty, tx = at[-2] * tok_hw[0] // d.shape[-2], at[-1] * tok_hw[1] // d.shape[-1]
        near = differ.view(tok_hw)[max(ty - 1, 0):ty + 2, max(tx - 1, 0):tx + 2]
        ro_g, ro_c = got["readout"], want["readout"]  # [1, obj, CV, h, w]
        agree = ~differ.view(tok_hw)
        out.update(tokens=int(differ.numel()), topk_differ=int(differ.sum()),
                   differ_at=[[int(i) // tok_hw[1], int(i) % tok_hw[1]]
                              for i in differ.nonzero().flatten()[:8]],
                   gap_where_differ=(float(gap[differ].max()) if differ.any() else None),
                   gap_min=float(gap.min()), sim_abs_err=float((sim_g - sim_c).abs().max()),
                   max_err_token=[int(ty), int(tx)], differ_near_max_err=bool(near.any()),
                   readout=rel(ro_g, ro_c),
                   readout_where_agree=rel(ro_g[..., agree], ro_c[..., agree]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[91, 92, 93])
    ap.add_argument("--starts", type=int, nargs="+", default=[0, 5],
                    help="first frame of each pair")
    ap.add_argument("--hw", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no card: pass --device cpu for a dry run")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from this_and_that_vdm_tpu_torch.curation import tracking, xmem_tracker

    k = xmem_tracker.DEFAULT_CONFIG["top_k"]
    hw = tuple(args.hw)
    tok_hw = (-(-hw[0] // 16), -(-hw[1] // 16))
    rows = []
    with tempfile.TemporaryDirectory() as root:
        cases = []
        for start in args.starts:
            raw, mask = scene(hw, start)
            cases += [(start, fmt, stored(raw, fmt, root), mask) for fmt in ("png", "jpeg")]
        for seed in args.seeds:
            ckpt = os.path.join(root, f"xmem_{seed}.pth")
            cs.xmem_checkpoint(ckpt, seed)
            cpu = tracking.load_xmem(ckpt, "cpu")
            card = tracking.load_xmem(ckpt, args.device)
            for start, fmt, fr, mask in cases:
                for top_k in (k, 10 ** 6):
                    want = readings(cpu, fr, mask, top_k)
                    for run in (1, 2):
                        row = dict(seed=seed, start=start, frames=fmt,
                                   top_k=top_k if top_k == k else "off", run=run,
                                   **compare(readings(card, fr, mask, top_k), want, k, tok_hw))
                        rows.append(row)
                        print(json.dumps(row), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "xmem_divergence.json"), "w") as f:
        json.dump(dict(hw=hw, top_k=k, rows=rows), f, indent=1)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
