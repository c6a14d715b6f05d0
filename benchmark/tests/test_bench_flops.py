"""The reference's operation counts, against the program's own models
counted the same way (on the meta device, the program's kernels replaced
by their plain versions for the count)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import peaks, work
from benchmark.tests.tiny import ROOT

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "vgl-svd-gesturenet.json").read_text())


def _port_step_flops(monkeypatch) -> float:
    import this_and_that_vdm_tpu_torch.models.layers as layers
    import this_and_that_vdm_tpu_torch.models.transformer as transformer
    from this_and_that_vdm_tpu_torch.ops import attention, groupnorm, ln_matmul
    from this_and_that_vdm_tpu_torch.weights import loader

    def lnm(x, s, b, w, wb=None, eps=1e-5):
        c = x.shape[-1]
        out = ln_matmul._reference(x.reshape(-1, c), s, b, w, wb, eps)
        return out.reshape(*x.shape[:-1], w.shape[0])

    monkeypatch.setattr(layers, "ln_matmul", lnm)
    monkeypatch.setattr(transformer, "ln_matmul", lnm)
    monkeypatch.setattr(layers, "group_norm", lambda x, w, b, g, eps, silu=False:
                        groupnorm._plain(x, w, b, g, eps, silu))
    monkeypatch.setattr(layers, "dot_product_attention", lambda q, k, v, scale=None:
                        attention._xla_attention(q, k, v, q.shape[-1] ** -0.5))
    unet = loader.build_module("unet", "full", "meta")
    cn = loader.build_module("gesturenet", "full", "meta")
    with torch.device("meta"):
        x, t = torch.empty(2, 14, 32, 48, 8), torch.empty(())
        states, ids = torch.empty(2, 78, 1024), torch.empty(2, 3)
        cond = torch.empty(2, 14, 32, 48, 4)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            res, mid = cn(x, t, states, ids, cond)
            unet(x, t, states, ids, down_block_additional_residuals=res,
                 mid_block_additional_residual=mid)
    return float(fc.get_total_flops())


def test_denoise_step_flops_match_the_program(monkeypatch):
    ref, calls = work.denoise_step(CONFIG, 1)
    port = _port_step_flops(monkeypatch)
    assert ref == pytest.approx(port, rel=0.01)
    assert 17.0e12 < ref < 17.5e12  # 17.27 TFLOP at [2, 14, 32, 48]
    assert sum(c[0] == "groupnorm" for c in calls) == 152
    assert sum(c[0] == "ln_matmul" for c in calls) == 161


def test_kernel_bounds_of_a_step():
    # K2: one read and one write of each GroupNorm input in bf16; K3: the
    # LayerNorm -> projection sites in bf16 (PERF.md: 1.166 ms for K2)
    assert work.step_bound_s(CONFIG, 1, "groupnorm") * 1e3 == pytest.approx(1.166, rel=0.01)
    assert 5e-3 < work.step_bound_s(CONFIG, 1, "ln_matmul") < 8e-3


def test_adam8bit_bound():
    # 12 bytes a parameter and 16 a block (PERF.md: 5.490 ms for the VL UNet)
    assert peaks.adam8bit_bound_s([256, 300]) == pytest.approx((12 * 556 + 16 * 3) / 3.35e12)
