"""Time kernels of chip_smoke.py on one CUDA card against another tree's,
in turns (other, this, this, other).

    git archive <commit> this_and_that_vdm_tpu_torch | tar -x -C build/other
    python3 compare_kernels.py build/other [k1k3 | k2k4]

``k1k3`` (the default): the fp32 K1 and K3 cases.  ``k2k4``: K2 at every
GroupNorm site of the denoise step and at the batch-1 fp32 train sites, K4
at its NB = 51,200 leaf, and the 8-bit Adam update of the GestureNet's 655
leaves through each tree's ``training.optimizers.scale_by_adam8bit`` (host
ms of the call, its synchronised wall ms, and device ms).  K2 and K4 also
get the device time a call (torch.profiler, every device activity of the
call summed), since their event times at small shapes are host time.

The other tree's package is loaded under another module name; its kernels
build into ``build/other/build``.  Both trees get the same inputs, and each
result is held to chip_smoke's bound against this tree's plain version.
Prints one line per case, then all of them as one JSON object.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch


def load_pkg(root: str, name: str = "other_pkg"):
    """``<root>/this_and_that_vdm_tpu_torch`` as the package ``name`` (its
    relative imports resolve inside it)."""
    path = os.path.join(root, "this_and_that_vdm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def other_ops(root: str):
    """The other tree's ``ops`` package (its kernels build into
    ``<root>/build``)."""
    load_pkg(root)
    return importlib.import_module("other_pkg.ops")


def device_ms(fn, iters: int = 10) -> float:
    """Device ms a call: every device activity of ``iters`` calls under
    torch.profiler, summed, over ``iters``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


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


def main_k1k3(other_root: str):
    import chip_smoke as cs
    from this_and_that_vdm_tpu_torch import ops

    smi = cs.phase_device()
    cs.phase_build()
    trees = {"other": other_ops(other_root), "this": ops}
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


def k2k4_cases(trees):
    """(label, {tree: call}, plain call, kind) of K2 at every denoise-step
    site (bf16) and the fp32 train sites, and K4 at NB = 51,200, t = 1000."""
    import chip_smoke as cs

    this = trees["this"]
    sites = ([(sh, e, sl, torch.bfloat16) for sh, e, sl in cs.K2_DENOISE]
             + [(sh, e, sl, torch.float32) for sh, e, sl in cs.K2_OTHER[torch.float32][:9]])
    for shape, eps, silu, dtype in sites:
        c = shape[-1]
        x = cs._randn(shape, dtype, 4, 2.0, 0.5)
        w, b = cs._randn((c,), torch.float32, 5, 0.1, 1.0), cs._randn((c,), torch.float32, 6, 0.1)
        calls = {t: (lambda m=m, x=x, w=w, b=b, e=eps, s=silu: m.groupnorm.group_norm(
            x, w, b, 32, e, s)) for t, m in trees.items()}
        plain = lambda x=x, w=w, b=b, e=eps, s=silu: this.groupnorm._plain(  # noqa: E731
            x, w, b, 32, e, s)
        dn = "bf16" if dtype == torch.bfloat16 else "fp32"
        yield f"K2 {list(shape)} eps={eps} silu={silu} {dn}", calls, plain, "groupnorm"
    ins = cs.k4_inputs(51200, 12)
    bc = this.adam8bit.bias_corrections(1000, 0.9, 0.999)
    calls = {t: (lambda m=m: m.adam8bit.adam8bit_update(*ins, bc)) for t, m in trees.items()}
    yield ("K4 NB=51200 t=1000", calls,
           lambda: this.adam8bit._plain(*ins, bc, 0.9, 0.999, 1e-8), "adam8bit")


def optimizer_turns(pkgs, turns=("other", "this", "this", "other"), reps=5):
    """The 8-bit Adam update (``scale_by_adam8bit``, t = 1000) of the
    GestureNet's 655 leaves through each tree's optimizer module, in turns:
    host ms of the call (launches enqueued, no synchronisation), wall ms to
    the end of its device work, device ms (profiler), medians of ``reps``."""
    import chip_smoke as cs

    numels = cs.gesturenet_numels()
    (gs, mqs, mss, nqs, nss), _ = cs.k4_tree_inputs(numels, 13)
    keys = [f"leaf{i}" for i in range(len(numels))]
    run = {}
    for t, pkg in pkgs.items():
        opt = importlib.import_module(f"{pkg.__name__}.training.optimizers")
        state = opt.Adam8bitState(
            999, {k: opt.Q(q, sc) for k, q, sc in zip(keys, mqs, mss)},
            {k: opt.Q(q, sc) for k, q, sc in zip(keys, nqs, nss)})
        tx = opt.scale_by_adam8bit()
        run[t] = lambda tx=tx, state=state: tx.update(dict(zip(keys, gs)), state)
    # both trees' steps agree with the plain version, leaf by leaf
    plain = pkgs["this"].ops.adam8bit._plain_leaves(
        gs, mqs, mss, nqs, nss, pkgs["this"].ops.adam8bit.bias_corrections(1000, 0.9, 0.999),
        0.9, 0.999, 1e-8)
    for t, call in run.items():
        upd, st = call()
        got = ([upd[k].reshape(-1) for k in keys], [st.mu[k].q for k in keys],
               [st.mu[k].scale for k in keys], [st.nu[k].q for k in keys],
               [st.nu[k].scale for k in keys])
        cs.k4_tree_compare(got, plain, numels)
        del upd, st, got
    del plain
    torch.cuda.empty_cache()
    rows = []
    for t in turns:
        host, wall = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run[t]()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
            del out
        rows.append(dict(tree=t, host_ms=statistics.median(host[1:]),
                         wall_ms=statistics.median(wall[1:]), device_ms=device_ms(run[t], 3)))
        cs.log(f"[compare] optimizer 655 leaves ({t}): host {rows[-1]['host_ms']:.3f} ms, wall "
               f"{rows[-1]['wall_ms']:.3f} ms, device {rows[-1]['device_ms']:.3f} ms")
    return rows


def main_k2k4(other_root: str):
    import chip_smoke as cs
    from this_and_that_vdm_tpu_torch import ops

    smi = cs.phase_device()
    cs.phase_build()
    trees = {"other": other_ops(other_root), "this": ops}
    order = ("other", "this", "this", "other")
    rows = []
    for label, calls, plain, kind in k2k4_cases(trees):
        want = plain()
        errs = {}
        for t, call in calls.items():
            got = call()
            cs.sync()
            if kind == "adam8bit":
                errs[t] = cs.k4_compare(got, want)[1]
            else:
                errs[t] = cs.rel_err(got, want)[1]
                if not (torch.isfinite(got.float()).all() and errs[t] < cs.BOUND[got.dtype]):
                    raise RuntimeError(f"{label} ({t}): relative error {errs[t]:.3e}")
            del got
        del want
        ev = [(t, cs.cuda_ms(calls[t])) for t in order]
        dev = [(t, device_ms(calls[t])) for t in order]
        row = dict(case=label, other_ms=[m for t, m in ev if t == "other"],
                   this_ms=[m for t, m in ev if t == "this"],
                   other_device_ms=[m for t, m in dev if t == "other"],
                   this_device_ms=[m for t, m in dev if t == "this"], rel_err=errs)
        rows.append(row)
        cs.log(f"[compare] {label:42s} device other {row['other_device_ms'][0]:.4f} / "
               f"{row['other_device_ms'][1]:.4f} this {row['this_device_ms'][0]:.4f} / "
               f"{row['this_device_ms'][1]:.4f} ms; events other {row['other_ms'][0]:.4f} / "
               f"{row['other_ms'][1]:.4f} this {row['this_ms'][0]:.4f} / {row['this_ms'][1]:.4f}"
               f" ms; rel err other {errs['other']:.2e} this {errs['this']:.2e}")
        torch.cuda.empty_cache()
    opt = optimizer_turns({"other": sys.modules["other_pkg"],
                           "this": importlib.import_module("this_and_that_vdm_tpu_torch")})
    cs.log(json.dumps(dict(card=smi, other=other_root, cases=rows, optimizer=opt)))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["k1k3"], ["k2k4"]):
        raise SystemExit(__doc__)
    (main_k2k4 if sys.argv[2:] == ["k2k4"] else main_k1k3)(sys.argv[1])
