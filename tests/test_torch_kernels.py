"""The four Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  Run on a machine with an H100:
``python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest``.
Bounds: fp32 1e-4 relative (max abs error over max abs reference); bf16
2e-2 relative (bf16 rounding of the normalised / probability tensor).  K4:
step error over max |step| below 1e-5; codes off by at most 1 on under 0.1%
of entries (a log2 at a codebook midpoint may round either way); scales
within 1e-6 relative.  Backward of K1-K3: gradients through the wrapper
against autograd of the plain version, with the forward bounds.
"""

import pytest
import torch

from this_and_that_vdm_tpu_torch import ops
from this_and_that_vdm_tpu_torch.ops import adam8bit, flash_attention, groupnorm, ln_matmul

pytestmark = pytest.mark.cuda

BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1536, 5, 64), (2, 384, 10, 64), (1, 1000, 2, 64),
                                   (1, 300, 2, 128)])
def test_flash_attention_kernel(dev, dtype, shape):
    q, k, v = (_randn(shape, dtype, dev, s) for s in range(3))
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, shape[-1] ** -0.5)
    want = flash_attention._plain(q, k, v, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert _rel(got, want) < BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1536, 5, 64), (2, 384, 10, 64), (1, 1000, 2, 64),
                                   (1, 300, 2, 128)])
def test_flash_attention_kernel_reads_qkv_views(dev, dtype, shape):
    """q, k, v as the transformers make them, .chunk(3) of a fused [B, S, 3C]
    qkv product: read in place through their strides, no copy."""
    b, s, h, d = shape
    qkv = _randn((b, s, 3 * h * d), dtype, dev, 0)
    q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, d ** -0.5)
    want = flash_attention._plain(q.contiguous(), k.contiguous(), v.contiguous(), d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and got.is_contiguous()
    assert _rel(got, want) < BOUND[dtype]


@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "qkv_views"])
@pytest.mark.parametrize("shape", [(14, 1536, 5, 64), (14, 384, 10, 64), (3, 1000, 5, 64),
                                   (2, 333, 3, 128), (1, 77, 2, 128)])
def test_flash_attention_fp32_train_shapes(dev, shape, views):
    """The fp32 path (3xTF32 on mma.sync) at the batch-1 train step's shapes,
    ragged S (a partial last key tile and query block) and D = 128, both as
    contiguous tensors and as the .chunk(3) views of a fused qkv product."""
    b, s, h, d = shape
    if views:
        qkv = _randn((b, s, 3 * h * d), torch.float32, dev, 0)
        q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (_randn(shape, torch.float32, dev, i) for i in range(3))
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, d ** -0.5)
    want = flash_attention._plain(q.contiguous(), k.contiguous(), v.contiguous(), d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and got.is_contiguous()
    assert _rel(got, want) < BOUND[torch.float32]


def test_flash_attention_refuses_views_it_cannot_read(dev):
    x = torch.zeros((2, 10, 384, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head stride"):
        flash_attention.flash_attention(*(x.transpose(1, 2),) * 3, 0.125)  # [B, H, S, D] storage
    y = torch.zeros((2, 384, 652), device=dev, dtype=torch.bfloat16)[..., :640]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention.flash_attention(*(y.reshape(2, 384, 10, 64),) * 3, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps,silu", [((4, 1536, 320), 1e-6, True),
                                            ((2, 3, 24, 32, 640), 1e-5, False),
                                            ((1, 4096, 2560), 1e-6, True),
                                            ((2, 1000, 96), 1e-6, False),
                                            ((1, 14 * 32 * 48, 128), 1e-6, True)])
def test_groupnorm_kernel(dev, dtype, shape, eps, silu):
    x = _randn(shape, dtype, dev, 0) * 3 + 1
    c = shape[-1]
    w, b = _randn((c,), torch.float32, dev, 1), _randn((c,), torch.float32, dev, 2)
    ops.reset_launch_counts()
    got = groupnorm.group_norm(x, w, b, 32, eps, silu)
    want = groupnorm._plain(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert groupnorm.launches == 1
    assert _rel(got, want) < BOUND[dtype]


def test_groupnorm_kernel_constant_input_is_finite(dev):
    x = torch.full((2, 512, 320), 7.0, device=dev, dtype=torch.bfloat16)
    w = torch.ones(320, device=dev)
    b = torch.linspace(-1, 1, 320, device=dev)
    got = groupnorm.group_norm(x, w, b, 32, 1e-6, False)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - b).abs().max().item() < 2e-2


def _gn_route(x):
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    return groupnorm.plan(n, s, c, 32, x.element_size(),
                          torch.cuda.get_device_properties(x.device).multi_processor_count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps,silu", [((28, 1536, 320), 1e-6, True),
                                            ((2, 14, 32, 48, 320), 1e-6, True),
                                            ((28, 24, 1280), 1e-5, True),
                                            ((28, 1536, 640), 1e-6, True),
                                            ((8, 98304, 128), 1e-6, False),
                                            ((3, 7, 2560), 1e-6, False)])
def test_groupnorm_kernel_both_routes(dev, dtype, shape, eps, silu):
    """The resident route (the tensor held in shared memory across the grid
    barrier) and the streamed one, at denoise-step and VAE decoder shapes;
    the route is the plan's, one launch either way."""
    x = _randn(shape, dtype, dev, 0) * 2 + 0.5
    c = shape[-1]
    w, b = _randn((c,), torch.float32, dev, 1), _randn((c,), torch.float32, dev, 2)
    resident = x.numel() * x.element_size() <= 27_600_000
    assert _gn_route(x).resident == resident
    ops.reset_launch_counts()
    got = groupnorm.group_norm(x, w, b, 32, eps, silu)
    want = groupnorm._plain(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert groupnorm.launches == 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < BOUND[dtype]


@pytest.mark.parametrize("shape", [(2, 512, 320), (28, 1536, 640)], ids=["resident", "streamed"])
def test_groupnorm_kernel_constant_input_both_routes(dev, shape):
    x = torch.full(shape, 7.0, device=dev, dtype=torch.bfloat16)
    assert _gn_route(x).resident == (shape[1] == 512)
    c = shape[-1]
    w = torch.ones(c, device=dev)
    b = torch.linspace(-1, 1, c, device=dev)
    got = groupnorm.group_norm(x, w, b, 32, 1e-6, False)
    want = groupnorm._plain(x, w, b, 32, 1e-6, False)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - b).abs().max().item() < 2e-2
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,n,bias", [(3000, 320, 960, False), (1000, 320, 2560, True),
                                        (384, 1280, 10240, True), (77, 64, 40, True),
                                        (3000, 320, 320, False), (1000, 640, 1920, False),
                                        (672, 1280, 1280, False), (672, 1280, 3840, True)])
def test_ln_matmul_kernel(dev, dtype, r, c, n, bias):
    x = _randn((r, c), dtype, dev, 0)
    s, b = 1 + 0.1 * _randn((c,), torch.float32, dev, 1), 0.1 * _randn((c,), torch.float32, dev, 2)
    w = _randn((n, c), dtype, dev, 3) / c ** 0.5
    wb = _randn((n,), torch.float32, dev, 4) if bias else None
    ops.reset_launch_counts()
    got = ln_matmul.ln_matmul(x, s, b, w, wb)
    want = ln_matmul._reference(x, s, b, w, wb, 1e-5)
    torch.cuda.synchronize()
    assert ln_matmul.launches == 1
    assert _rel(got, want) < BOUND[dtype]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("r,c,n", [(21504, 320, 960), (21504, 320, 2560), (5376, 640, 1920),
                                   (1344, 1280, 10240), (336, 1280, 3840), (1000, 2048, 96),
                                   (77, 72, 41)])
def test_ln_matmul_fp32_train_shapes(dev, r, c, n, bias):
    """The fp32 path (3xTF32 on mma.sync) at the batch-1 train step's sites:
    rows resident in shared memory (C <= 320) and streamed (C = 640, 1280,
    2048), a C that is not a multiple of 32 and an odd N."""
    x = _randn((r, c), torch.float32, dev, 0) * 2 + 0.5
    s, b = 1 + 0.1 * _randn((c,), torch.float32, dev, 1), 0.1 * _randn((c,), torch.float32, dev, 2)
    w = _randn((n, c), torch.float32, dev, 3) / c ** 0.5
    wb = _randn((n,), torch.float32, dev, 4) if bias else None
    ops.reset_launch_counts()
    got = ln_matmul.ln_matmul(x, s, b, w, wb)
    want = ln_matmul._reference(x, s, b, w, wb, 1e-5)
    torch.cuda.synchronize()
    assert ln_matmul.launches == 1
    assert _rel(got, want) < BOUND[torch.float32]


def _geglu_fp32(x, s, b, w, wb, eps=1e-5):
    """The GEGLU epilogue's arithmetic in fp32 from the same bf16 normalised
    rows and weights: fp32 product and biases, exact GELU, fp32 product, no
    rounding."""
    y = ln_matmul.layer_norm_fp32(x, s, b, eps).float() @ w.float().T + wb.float()
    h, gate = y.chunk(2, dim=-1)
    return h * torch.nn.functional.gelu(gate)


# (R, C, I) of the feed-forwards' GEGLU sites of the VGL denoise step at CFG
# 2 (levels 1-3, the level-4 mid block), at four clips' rows, a ragged R
# and a ragged R and I
_GEGLU_SHAPES = [(43008, 320, 1280), (10752, 640, 2560), (2688, 1280, 5120), (672, 1280, 5120),
                 (172032, 320, 1280), (43008, 640, 2560), (10752, 1280, 5120),
                 (1000, 320, 1280), (77, 64, 40)]


@pytest.mark.parametrize("r,c,i", _GEGLU_SHAPES)
def test_ln_matmul_geglu_kernel(dev, r, c, i):
    """One launch, counted under both of K3's names, against the plain
    composition; against the same arithmetic in fp32 its error is no larger
    than that of the unfused composition (K3's bf16 projection, then torch's
    GELU and product, each rounding to bf16), at the largest and on mean."""
    x = _randn((r, c), torch.bfloat16, dev, 0)
    s, b = 1 + 0.1 * _randn((c,), torch.float32, dev, 1), 0.1 * _randn((c,), torch.float32, dev, 2)
    w = _randn((2 * i, c), torch.bfloat16, dev, 3) / c ** 0.5
    wb = 0.1 * _randn((2 * i,), torch.float32, dev, 4)
    ops.reset_launch_counts()
    got = ln_matmul.ln_matmul_geglu(x, s, b, w, wb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ln_matmul"] == ops.launch_counts()["ln_matmul_geglu"] == 1
    assert got.shape == (r, i) and got.dtype == torch.bfloat16
    assert _rel(got, ln_matmul._reference_geglu(x, s, b, w, wb, 1e-5)) < BOUND[torch.bfloat16]
    h, gate = ln_matmul.ln_matmul(x, s, b, w, wb).chunk(2, dim=-1)
    unfused = h * torch.nn.functional.gelu(gate)
    exact = _geglu_fp32(x, s, b, w, wb)
    err, err_unfused = (got.float() - exact).abs(), (unfused.float() - exact).abs()
    assert err.max() <= err_unfused.max() and err.mean() <= err_unfused.mean()


def test_vgl_denoise_step_counts_geglu_launches(dev):
    """One eager VGL denoise step at full width (the GestureNet, then the
    UNet with its residuals; CFG 2, 14 frames of 32 x 48 latents, bf16):
    161 launches of K3, of which 69 with the GEGLU epilogue (3 feed-forwards
    in each of the 16 + 7 transformer models); the UNet alone, as the VL
    step runs it, 112 and 48."""
    from this_and_that_vdm_tpu_torch.models import cast_compute_dtype, init_weights
    from this_and_that_vdm_tpu_torch.weights import loader

    gen = torch.Generator(device=dev).manual_seed(0)
    unet, cn = (cast_compute_dtype(init_weights(loader.build_module(name, "full", dev), gen),
                                   torch.bfloat16).eval().requires_grad_(False)
                for name in ("unet", "gesturenet"))
    x = _randn((2, 14, 32, 48, 8), torch.float32, dev, 0)
    cond = _randn((2, 14, 32, 48, 4), torch.float32, dev, 1)
    states = _randn((2, 78, 1024), torch.float32, dev, 2)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
    t = torch.tensor(1.6, device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        res, mid = cn(x, t, states, ids, cond, conditioning_scale=1.0)
        gesture = ops.launch_counts()
        out = unet(x, t, states, ids, down_block_additional_residuals=res,
                   mid_block_additional_residual=mid)
        torch.cuda.synchronize()
    step = ops.launch_counts()
    assert torch.isfinite(out.float()).all()
    assert (step["ln_matmul"], step["ln_matmul_geglu"]) == (161, 69)
    assert (step["ln_matmul"] - gesture["ln_matmul"],
            step["ln_matmul_geglu"] - gesture["ln_matmul_geglu"]) == (112, 48)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 128, 2, 80), device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, 0.1)  # D=80
    with pytest.raises(ValueError):
        groupnorm.group_norm(torch.zeros((1, 8, 100), device=dev), torch.ones(100),
                             torch.zeros(100), 32, 1e-5)  # C % G
    with pytest.raises(ValueError):
        groupnorm.group_norm(torch.zeros((1, 8, 68), device=dev), torch.ones(68),
                             torch.zeros(68), 4, 1e-5)  # C % 8
    with pytest.raises(ValueError):
        ln_matmul.ln_matmul(torch.zeros((16, 4096), device=dev), torch.ones(4096),
                            torch.zeros(4096), torch.zeros((8, 4096), device=dev))  # C > 2048
    with pytest.raises(ValueError):
        x = torch.zeros((16, 64), device=dev, dtype=torch.float16)
        ln_matmul.ln_matmul(x, torch.ones(64), torch.zeros(64), torch.zeros((8, 64)))
    with pytest.raises(ValueError):  # bf16 keeps normalised rows of at most 1280 in shared memory
        x = torch.zeros((16, 2048), device=dev, dtype=torch.bfloat16)
        ln_matmul.ln_matmul(x, torch.ones(2048), torch.zeros(2048),
                            torch.zeros((8, 2048), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):  # the GEGLU epilogue is bf16's alone
        ln_matmul.ln_matmul_geglu(torch.zeros((16, 64), device=dev), torch.ones(64),
                                  torch.zeros(64), torch.zeros((16, 64), device=dev))
    with pytest.raises(ValueError, match="2I"):  # an odd number of weight rows
        x = torch.zeros((16, 64), device=dev, dtype=torch.bfloat16)
        ln_matmul.ln_matmul_geglu(x, torch.ones(64), torch.zeros(64),
                                  torch.zeros((17, 64), device=dev, dtype=torch.bfloat16))


def _k4_inputs(dev, nb, seed, valid=None):
    """Gradient blocks and a moment state; entries past ``valid`` are the
    zero-padded tail of a ragged leaf (zero gradient, zero codes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    grad = torch.randn((nb, 256), generator=g, device=dev) * 1e-3
    mq = torch.randint(0, 255, (nb, 256), generator=g, device=dev).to(torch.uint8)
    nq = torch.randint(0, 256, (nb, 256), generator=g, device=dev).to(torch.uint8)
    ms = torch.rand((nb,), generator=g, device=dev) * 1e-3
    ns = torch.rand((nb,), generator=g, device=dev) * 1e-6
    if valid is not None:
        grad.view(-1)[valid:] = 0
        mq.view(-1)[valid:] = 127
        nq.view(-1)[valid:] = 0
    return grad, mq, ms, nq, ns


def check_k4(got, want):
    """The K4 bounds; returns (step relative error, share of codes off by 1)."""
    step, *state = got
    wstep, *wstate = want
    rel = ((step - wstep).abs().max() / wstep.abs().max()).item()
    assert rel < 1e-5, rel
    off = 0.0
    for a, b in ((state[0], wstate[0]), (state[2], wstate[2])):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1
        off = max(off, d.float().mean().item())
    assert off < 1e-3, off
    for a, b in ((state[1], wstate[1]), (state[3], wstate[3])):
        assert ((a - b).abs() <= 1e-6 * b.abs()).all()
    return rel, off


@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("nb,valid", [(51200, None), (90, None), (3, 513)])
def test_adam8bit_kernel(dev, nb, valid, t):
    ins = _k4_inputs(dev, nb, 5, valid)
    bc = adam8bit.bias_corrections(t, 0.9, 0.999)
    ops.reset_launch_counts()
    got = adam8bit.adam8bit_update(*ins, bc)
    want = adam8bit._plain(*ins, bc, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert adam8bit.launches == 1
    check_k4(got, want)
    if valid is not None:  # the padded tail keeps the zero codes
        assert (got[1].view(-1)[valid:] == 127).all() and (got[3].view(-1)[valid:] == 0).all()


@pytest.mark.parametrize("t", [1, 1000])
def test_adam8bit_tree_one_launch(dev, t):
    """Every leaf of a ragged tree (a 1-block leaf, a 513-element leaf, a
    41-block leaf, empty leaves, a 51,200-block leaf) in one launch, held
    leaf by leaf against the per-leaf plain version."""
    numels = [200, 513, 0, 40 * 256 + 17, 256, 1, 51200 * 256, 3000, 0]
    gs, mqs, mss, nqs, nss = [], [], [], [], []
    for i, n in enumerate(numels):
        nb = -(-n // 256)
        g, mq, ms, nq, ns = _k4_inputs(dev, max(nb, 1), 20 + i, n)
        gs.append(g.view(-1)[:n].clone())
        for lst, v in zip((mqs, mss, nqs, nss), (mq.view(-1)[:nb * 256], ms[:nb],
                                                 nq.view(-1)[:nb * 256], ns[:nb])):
            lst.append(v.clone())
    bc = adam8bit.bias_corrections(t, 0.9, 0.999)
    ops.reset_launch_counts()
    got = adam8bit.adam8bit_leaves(gs, mqs, mss, nqs, nss, bc)
    want = adam8bit._plain_leaves(gs, mqs, mss, nqs, nss, bc, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert adam8bit.launches == 1
    for i, n in enumerate(numels):
        assert got[0][i].shape == (n,) and got[2][i].shape == (-(-n // 256),)
    # the K4 bounds over the tree: codes off on under 0.1% of all its codes
    # (one code of a one-block leaf is 0.2% of that leaf), the rest leaf by leaf
    full = [i for i, n in enumerate(numels) if n]
    check_k4([torch.cat([o[i] for i in full]) for o in got],
             [torch.cat([o[i] for i in full]) for o in want])
    for i in full:
        rel = ((got[0][i] - want[0][i]).abs().max() / want[0][i].abs().max()).item()
        assert rel < 1e-5, (i, rel)
        # the padded tail keeps the zero codes
        assert (got[1][i][numels[i]:] == 127).all() and (got[3][i][numels[i]:] == 0).all()
    # the steps written over the gradients themselves, as the optimizer does
    inplace = [g.clone() for g in gs]
    again = adam8bit.adam8bit_leaves(inplace, mqs, mss, nqs, nss, bc, out=inplace)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(again[0], inplace))
    for a, b in zip(again, got):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_adam8bit_wrapper_raises(dev):
    g = torch.zeros((4, 128), device=dev)
    q = torch.zeros((4, 128), dtype=torch.uint8, device=dev)
    s = torch.zeros((4,), device=dev)
    with pytest.raises(ValueError):
        adam8bit.adam8bit_update(g, q, s, q, s, (0.1, 0.001))  # not [NB, 256]


def _backward_cases(dev, dtype):
    t = lambda shape, seed, scale=1.0: (_randn(shape, dtype, dev, seed) * scale)  # noqa: E731
    f32 = lambda shape, seed, scale=1.0, shift=0.0: (  # noqa: E731
        _randn(shape, torch.float32, dev, seed) * scale + shift)
    return [
        ("flash_attention", lambda q, k, v: flash_attention.flash_attention(q, k, v, 0.125),
         lambda q, k, v: flash_attention._plain(q, k, v, 0.125),
         [t((2, 1536, 5, 64), s) for s in range(3)]),
        ("groupnorm", lambda x, w, b: groupnorm.group_norm(x, w, b, 32, 1e-6, True),
         lambda x, w, b: groupnorm._plain(x, w, b, 32, 1e-6, True),
         [t((4, 1536, 320), 3), f32((320,), 4, 0.1, 1.0), f32((320,), 5, 0.1)]),
        ("ln_matmul", lambda x, s, b, w, wb: ln_matmul.ln_matmul(x, s, b, w, wb),
         lambda x, s, b, w, wb: ln_matmul._reference(x, s, b, w, wb, 1e-5),
         [t((3072, 320), 6), f32((320,), 7, 0.1, 1.0), f32((320,), 8, 0.1),
          t((960, 320), 9, 320 ** -0.5), f32((960,), 10, 0.1)]),
        ("ln_matmul_geglu", lambda x, s, b, w, wb: ln_matmul.ln_matmul_geglu(x, s, b, w, wb),
         lambda x, s, b, w, wb: ln_matmul._reference_geglu(x, s, b, w, wb, 1e-5),
         [t((3072, 320), 6), f32((320,), 7, 0.1, 1.0), f32((320,), 8, 0.1),
          t((2560, 320), 9, 320 ** -0.5), f32((2560,), 10, 0.1)]),
    ]


# (dtype, case): every kernel in both dtypes but the GEGLU epilogue, bf16's alone
_BACKWARD = [pytest.param(dtype, case, id=f"{name}-dtype{d}")
             for case, name in enumerate(["flash_attention", "groupnorm", "ln_matmul",
                                          "ln_matmul_geglu"])
             for d, dtype in enumerate([torch.float32, torch.bfloat16])
             if name != "ln_matmul_geglu" or dtype == torch.bfloat16]


@pytest.mark.parametrize("dtype,case", _BACKWARD)
def test_kernel_backward_matches_plain_autograd(dev, dtype, case):
    name, kern, plain, inputs = _backward_cases(dev, dtype)[case]
    xs = [x.detach().requires_grad_(True) for x in inputs]
    ys = [x.detach().requires_grad_(True) for x in inputs]
    ops.reset_launch_counts()
    out = kern(*xs)
    assert out.grad_fn is not None and ops.launch_counts()[name] == 1
    r = _randn(out.shape, out.dtype, dev, 11)
    got = torch.autograd.grad((out.float() * r.float()).sum(), xs)
    want = torch.autograd.grad((plain(*ys).float() * r.float()).sum(), ys)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _rel(a, b) < BOUND[dtype]
    with torch.no_grad():  # inference saves nothing and records no graph
        assert kern(*xs).grad_fn is None
