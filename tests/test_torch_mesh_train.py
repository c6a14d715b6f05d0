"""The port's multi-rank training (``parallel/mesh.py`` over gloo on the
CPU) against one process at the same global batch.

Two worker processes (``tests/torch_mesh_worker.py``, port only) train the
nano VL UNet and VGL GestureNet of ``tests/torch_train_harness.py`` for two
steps at fsdp 2 and at dp 2, one clip a rank (VGL also with
``partial_finetune`` and two accumulated steps); the one-process step runs here
on the global batch of two clips with the draws of the JAX key that
``test_torch_training*.py`` inject (where the one-process port step is held
to the JAX step).  Bounds: loss and global gradient norm 5e-3 relative (the
JAX multichip oracle's, ``__graft_entry__.py``), parameters 1e-5 relative
(their L2 distance to the reference over its norm, a leaf at a time);
``frozen_sharding: fsdp`` against replicated towers 1e-4 relative, as JAX's
``tests/test_training.py``.  Under fsdp each rank holds at most its share of
the trainable parameters between steps (ZeRO-3, JAX's "params stayed
sharded"), and a validation render from the sharded models equals the
one-process render of the same parameters.  A checkpoint written at world 2
resumes at world 1.  Four processes on (dcn 2, dp 1, fsdp 2) train through
``train_loop`` and resume from their checkpoint after a full restart.

Every process has its own timeout; a hang fails the test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from torch_train_harness import F, H, W, batch, build_towers, draws
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = [["vl", 2, "replicated", "adam8bit"], ["vl", 1, "replicated", "adam8bit"],
             ["vgl", 2, "replicated", "adam8bit"], ["vgl", 1, "replicated", "adam8bit"],
             ["vgl", 2, "fsdp", "adam8bit"], ["vgl", 2, "replicated", "pf_acc"]]
TIMEOUT = 240  # seconds, each process


def _port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def _communicate(procs, timeout=TIMEOUT):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not finish in {timeout} s")
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two-rank runs of every scenario, and the one-process references."""
    root = tmp_path_factory.mktemp("mesh")
    towers = build_towers()
    states = {k: m.state_dict() for k, m in towers["tm"].items()}
    states["unet"] = _port_state(towers, "unet")
    states["controlnet"] = _port_state(towers, "controlnet")
    torch.save(states, root / "models.pt")
    data = {}
    for i in range(worker.STEPS):
        for k, v in batch(i, True).items():
            data[f"batch{i}_{k}"] = v
        for k, v in draws(jax.random.PRNGKey(100 + i)).items():
            data[f"draws{i}_{k}"] = v
    np.savez(root / "data.npz", **data)
    _instance(root / "val" / "v0")
    (root / "scenarios.json").write_text(json.dumps(SCENARIOS))
    port = _port()
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
                               str(r), "2", port, str(root)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(), cwd=REPO)
             for r in range(2)]
    refs = {(mode, optim): worker.run_steps(states, data, mode, optim=optim)
            for mode, optim in (("vl", "adam8bit"), ("vgl", "adam8bit"), ("vgl", "pf_acc"))}
    outs = _communicate(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"MESH_WORKER_OK rank={r}" in out, out[-4000:]
    return root, states, data, refs


def _instance(d):
    """A VGL validation instance at the batch's size (``shape.json``)."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    d.mkdir(parents=True)
    img = (np.random.RandomState(3).rand(H, W, 3) * 255).astype(np.uint8)
    video_io.write_png(str(d / "im_0.jpg"), img)
    (d / "lang.txt").write_text("push the cup to the plate\n")
    (d / "data.txt").write_text("0 30.0 40.0\n2 90.0 70.0\n")
    (d.parent / "shape.json").write_text(json.dumps([F, H, W]))


def _port_state(towers, name):
    from test_torch_models import port
    from this_and_that_vdm_tpu_torch.models import controlnet, unet

    module = (unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.nano()) if name == "unet"
              else controlnet.ControlNetModel(controlnet.ControlNetConfig.nano()))
    return port(module, towers["params"][name]).state_dict()


def _load(root, mode, fsdp, frozen, optim="adam8bit", resident=False):
    z = np.load(root / f"{worker.scenario_name(mode, fsdp, frozen, optim)}.npz")
    if resident:
        return list(z["resident"]), int(z["whole"]), int(z["leaves"])
    return list(z["losses"]), list(z["norms"]), {k[2:]: z[k] for k in z.files
                                                 if k.startswith("p.")}


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("mode,fsdp,optim", [("vl", 2, "adam8bit"), ("vl", 1, "adam8bit"),
                                            ("vgl", 2, "adam8bit"), ("vgl", 1, "adam8bit"),
                                            ("vgl", 2, "pf_acc")],
                         ids=["vl-fsdp2", "vl-dp2", "vgl-fsdp2", "vgl-dp2",
                              "vgl-fsdp2-partial-accumulated"])
def test_two_ranks_match_one_process_at_the_global_batch(run, mode, fsdp, optim):
    root, _, _, refs = run
    losses, norms, params = _load(root, mode, fsdp, "replicated", optim)
    ref_losses, ref_norms, ref_params = refs[(mode, optim)][:3]
    assert len(losses) == worker.STEPS == len(ref_losses)
    for got, want in zip(losses + norms, ref_losses + ref_norms):
        assert np.isfinite(got) and _rel(got, want) <= 5e-3, (got, want)
    assert set(params) == set(ref_params)
    for k, want in ref_params.items():
        err = np.linalg.norm(params[k] - want)
        assert err <= 1e-5 * max(np.linalg.norm(want), 1e-12), (k, err)


def test_frozen_towers_split_over_fsdp_match_replicated(run):
    root = run[0]
    losses, norms, _ = _load(root, "vgl", 2, "fsdp")
    ref_losses, ref_norms, _ = _load(root, "vgl", 2, "replicated")
    for got, want in zip(losses + norms, ref_losses + ref_norms):
        assert _rel(got, want) <= 1e-4, (got, want)


@pytest.mark.parametrize("mode,fsdp,frozen,optim", [s for s in SCENARIOS],
                         ids=[worker.scenario_name(*s) for s in SCENARIOS])
def test_ranks_hold_their_share_of_the_trainable_parameters_between_steps(run, mode, fsdp,
                                                                          frozen, optim):
    """ZeRO-3: a rank's parameter storage between steps is at most 1/fsdp
    of the whole model plus one padding block a leaf (under dp alone, every
    rank holds the whole model)."""
    resident, whole, leaves = _load(run[0], mode, fsdp, frozen, optim, resident=True)
    assert len(resident) == 2
    for got in resident:
        assert whole / fsdp <= got <= whole / fsdp + leaves * 256 * 4, (got, whole, leaves)


def test_validation_render_from_sharded_models_equals_one_process(run):
    """Rank 0's render inside the collective whole-parameters context at
    fsdp 2 equals the one-process render of the same parameters."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    root, states, _, _ = run
    name = worker.scenario_name("vgl", 2, "replicated", "adam8bit")
    params = _load(root, "vgl", 2, "replicated")[2]
    model, u, towers = worker.build(states, "vgl")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[k]))
    want = worker.validate(model, u, towers, "vgl", str(root / "val"), str(root / "one"))
    got_dir = root / f"{name}_render" / "step_1" / "v0"
    assert [os.path.basename(w) for w in want] == ["v0"]
    got = video_io.load_frames_dir(str(got_dir))
    ref = video_io.load_frames_dir(want[0])
    assert len(got) == F and got[0].shape == (H, W, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optim", ["adam8bit", "pf_acc"],
                         ids=["adam8bit", "partial-accumulated"])
def test_checkpoint_written_at_world_two_resumes_at_world_one(run, optim):
    root, states, data, _ = run
    name = worker.scenario_name("vgl", 2, "replicated", optim)
    path = os.path.join(root, f"{name}_ckpt", "checkpoint-1")
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=False)
    assert saved["step"] == 1
    if optim == "adam8bit":  # the one-rank file: every leaf whole in the 8-bit state
        adam = saved["opt_state"][1][0]
        for k, p in saved["params"].items():
            assert adam.mu[k].q.numel() == -(-p.numel() // 256) * 256, k
    else:  # the accumulator holds every leaf whole
        acc = saved["opt_state"].acc_grads
        assert all(acc[k].shape == p.shape for k, p in saved["params"].items())
    losses, norms, params, state, _ = worker.run_steps(states, data, "vgl", resume=path,
                                                       first=1, optim=optim)
    assert state.step == 2
    want_losses, want_norms, want = _load(root, "vgl", 2, "replicated", optim)
    assert _rel(losses[0], want_losses[1]) <= 5e-3 and _rel(norms[0], want_norms[1]) <= 5e-3
    for k, w in want.items():
        assert np.linalg.norm(params[k] - w) <= 1e-5 * max(np.linalg.norm(w), 1e-12), k


def _train_cfg(tmp_path):
    import yaml

    cfg = dict(video_seq_length=2, height=64, width=128, train_batch_size=1,
               num_train_iters=4, checkpointing_steps=2, checkpoints_total_limit=2,
               learning_rate=1e-4, lr_warmup_steps=0, seed=42, use_8bit_adam=True,
               output_dir=str(tmp_path / "run4"), use_text=True, motion_bucket_id=200,
               dataloader_num_workers=1, resume_from_checkpoint="latest")
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def _train_loop(cfg, steps, n=4, launcher=True):
    """``train_loop`` over ``n`` ranks on (dcn 2, dp 1, fsdp 2): one process
    a rank with the launcher's environment, or (``launcher`` False) rank 0
    starting the others with ``--devices``."""
    argv = [sys.executable, "-m", "this_and_that_vdm_tpu_torch.training.train_loop",
            "--config", cfg, "--mode", "vgl", "--nano", "--synthetic", "8", "--device", "cpu",
            "--dcn", "2", "--fsdp", "2", "--max-steps", str(steps)]
    port = _port()
    if launcher:
        envs = [_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(n), RANK=str(r),
                     LOCAL_RANK=str(r % 2), LOCAL_WORLD_SIZE="2") for r in range(n)]
    else:
        argv, envs = argv + ["--devices", str(n)], [_env()]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=e, cwd=REPO) for e in envs]
    outs = _communicate(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs[0]


def test_four_ranks_dcn_fsdp_train_checkpoint_and_resume(tmp_path):
    """Mirror of tests/test_multihost.py::test_four_process_dcn_fsdp_resume:
    train 0 -> 2 with a collective checkpoint, then a full restart of every
    rank resumes at 2 and ends at 4 (the second run through ``--devices``)."""
    cfg = _train_cfg(tmp_path)
    out = _train_loop(cfg, 2)
    assert "mesh {'dcn': 2, 'dp': 1, 'fsdp': 2}" in out and "done at step 2" in out, out[-3000:]
    out = _train_loop(cfg, 4, launcher=False)
    assert "resumed from" in out and "at step 2" in out, out[-3000:]
    assert "done at step 4" in out, out[-3000:]
    ckpts = sorted(os.listdir(tmp_path / "run4"))
    assert [c for c in ckpts if c.startswith("checkpoint")] == ["checkpoint-2", "checkpoint-4"]
