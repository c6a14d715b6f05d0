"""Time the fp32 K1 and K3 cases of chip_smoke.py on one CUDA card against
another tree's kernels, in turns (other, this, this, other).

    git archive <commit> this_and_that_vdm_tpu_torch | tar -x -C build/other
    python3 compare_kernels.py build/other

The other tree's ``ops`` package is loaded under another module name; its
kernels build into ``build/other/build``.  Both trees get the same inputs,
and each result is held to chip_smoke's bound against the plain version.
Prints one line per case, then all of them as one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch


def load_ops(root: str, name: str = "other_ops"):
    """``<root>/this_and_that_vdm_tpu_torch/ops`` as the package ``name``."""
    path = os.path.join(root, "this_and_that_vdm_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(trees):
    """(label, {tree: call}, plain call) for every fp32 K1 and K3 case."""
    import chip_smoke as cs

    f32 = torch.float32
    for shape, views in cs.K1_SHAPES[f32]:
        b, s, h, d = shape
        if views:
            qkv = cs._randn((b, s, 3 * h * d), f32, 0)
            q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
        else:
            q, k, v = (cs._randn(shape, f32, i) for i in range(3))
        calls = {n: (lambda m=m, q=q, k=k, v=v: m.flash_attention.flash_attention(q, k, v, 0.125))
                 for n, m in trees.items()}
        plain = lambda q=q, k=k, v=v: trees["this"].flash_attention._plain(q, k, v, 0.125)  # noqa: E731
        yield f"K1 {list(shape)}{' qkv views' if views else ''}", calls, plain
    for r, c, n, bias in cs.K3_SHAPES[f32]:
        x = cs._randn((r, c), f32, 7)
        sc, bi = cs._randn((c,), f32, 8, 0.1, 1.0), cs._randn((c,), f32, 9, 0.1)
        w = cs._randn((n, c), f32, 10, c ** -0.5)
        wb = cs._randn((n,), f32, 11, 0.1) if bias else None
        calls = {t: (lambda m=m, x=x, s=sc, b=bi, w=w, wb=wb: m.ln_matmul.ln_matmul(x, s, b, w, wb))
                 for t, m in trees.items()}
        plain = lambda x=x, s=sc, b=bi, w=w, wb=wb: trees["this"].ln_matmul._reference(  # noqa: E731
            x, s, b, w, wb, 1e-5)
        yield f"K3 R={r} C={c} N={n} bias={bias}", calls, plain


def main(other_root: str):
    import chip_smoke as cs
    from this_and_that_vdm_tpu_torch import ops

    smi = cs.phase_device()
    cs.phase_build()
    trees = {"other": load_ops(other_root), "this": ops}
    rows = []
    for label, calls, plain in cases(trees):
        want = plain()
        errs = {}
        for t, call in calls.items():
            got = call()
            cs.sync()
            errs[t] = cs.rel_err(got, want)[1]
            if not (torch.isfinite(got).all() and errs[t] < cs.BOUND[torch.float32]):
                raise RuntimeError(f"{label} ({t}): relative error {errs[t]:.3e}")
            del got
        del want
        turns = [("other", cs.cuda_ms(calls["other"])), ("this", cs.cuda_ms(calls["this"])),
                 ("this", cs.cuda_ms(calls["this"])), ("other", cs.cuda_ms(calls["other"]))]
        row = dict(case=label, other_ms=[ms for t, ms in turns if t == "other"],
                   this_ms=[ms for t, ms in turns if t == "this"], rel_err=errs)
        rows.append(row)
        cs.log(f"[compare] {label:38s} other {row['other_ms'][0]:.4f} / {row['other_ms'][1]:.4f} ms"
               f"  this {row['this_ms'][0]:.4f} / {row['this_ms'][1]:.4f} ms  rel err "
               f"other {errs['other']:.2e} this {errs['this']:.2e}")
        torch.cuda.empty_cache()
    cs.log(json.dumps(dict(card=smi, other=other_root, cases=rows)))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
