"""Whole runs of the cells at the tiny size on the CPU (the harness's look
for a card skipped): the result line, a cell added as new files only, and
``correct`` coming out false for each fault a cell can have."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import ROOT, tiny_root

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny_root(tmp_path_factory.mktemp("bench"))


# long enough for a call of four tiny clips on a busy CPU to end inside the window
SECONDS = {"vgl-serve-c4": 30.0}


def run(root, cell, **kw):
    return harness.run_cell(cell, SEED, SECONDS.get(cell, 10.0), False, root, device=CPU, **kw)


def test_result_line(root):
    res = run(root, "vgl-serve-c1")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "notes",
                         "compared"]  # ``main`` prints the notes apart, then the line
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"clips_per_min", "latency_p90_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in res["compared"].values())


def test_same_seed_same_inputs(root):
    gen = harness.load_module(root / "benchmark" / "generators" / "closed_loop_serve.py")
    cell = harness.Cell("vgl-serve-c1", root)
    a = gen.request(SEED, 0, 3, cell.config["sampling"], cell.traffic)
    b = gen.request(SEED, 0, 3, cell.config["sampling"], cell.traffic)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", [SEED, 11])
def test_checked_clips_span_the_halves_of_one_call(root, seed):
    """The clips checked in a batched cell come from one call, one from each
    half, though the starts read off the host jitter by the time submit()
    takes."""
    gen = harness.load_module(root / "benchmark" / "generators" / "closed_loop_serve.py")
    rng = np.random.default_rng(seed)
    records = [dict(call=c, slot=i, t_submit=10.0 * c + 0.001 * i,
                    timing=dict(queue_s=0.5 - 0.001 * i + rng.uniform(0, 2e-3), batch=4))
               for c in range(3) for i in range(4)]
    picked = gen.pick_checked(records, 2, seed)
    assert len({r["call"] for r in picked}) == 1
    assert [r["slot"] // 2 for r in picked] == [0, 1]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "vgl-serve-c1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_new_cell_as_new_files_only(root, tmp_path):
    """A traffic mix, a cell and a per-layer metric added as new files and
    entries in BENCHMARK.json, with no existing file edited."""
    import shutil

    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    (new / "benchmark" / "traffic" / "closed-c2.json").write_text(json.dumps(dict(
        kind="closed_loop_serve", clients=2, max_batch=2, max_delay_s=0.05,
        two_point_share=1.0, check_clips=1)))
    (new / "benchmark" / "metrics" / "server.requests.py").write_text(
        "def read(r):\n    return float(r['attempted'])\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="vgl-serve-c2", config="vgl-svd-gesturenet",
                                   traffic="closed-c2", chips=1, why="two clients"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "vgl-serve-c1" in m["workloads"]:
            m["workloads"].append("vgl-serve-c2")
    bench["per_layer"].append(dict(name="server.requests", unit="requests", better="higher",
                                   source="program_counter", layer="server (serving/server.py)",
                                   moves="clips_per_min", workloads=["vgl-serve-c2"]))
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell("vgl-serve-c2", new)
    assert [m["name"] for m in cell.per_layer][-1] == "server.requests"
    res = harness.run_cell("vgl-serve-c2", SEED, 8.0, False, new, device=CPU)
    assert res["attempted"] >= 2 and "clips_per_min" in res["metrics"]
    assert res["compared"]["frame_rmse"]["value"] < float("inf")
    assert cell.reader("server.requests").read({"attempted": 3}) == 3.0


# ------------------------------------------------------------------- faults

def _serve_unchanged(monkeypatch):
    from this_and_that_vdm_tpu_torch.pipelines import svd
    monkeypatch.setattr(svd, "denoise_step", lambda unet, cn, x, row, inputs, **kw: x)


def _serve_altered(monkeypatch):
    from this_and_that_vdm_tpu_torch.pipelines import common
    orig = common.postprocess_frames_uint8

    def altered(frames):
        out = orig(frames)
        out[:, -1] = 255 - out[:, -1]  # the last frame of each clip, inverted
        return out

    monkeypatch.setattr(common, "postprocess_frames_uint8", altered)


def _serve_half_batch(monkeypatch):
    from this_and_that_vdm_tpu_torch.serving import server
    orig = server.VideoGenServer._execute

    def half(self, batch):
        keep = batch[:max(1, len(batch) // 2)]
        orig(self, keep)
        for r, src in zip(batch[len(keep):], keep * 2):
            if r.future.set_running_or_notify_cancel():
                r.future.timing = src.future.timing
                r.future.set_result(src.future.result())

    monkeypatch.setattr(server.VideoGenServer, "_execute", half)


def _train_unchanged(monkeypatch):
    from this_and_that_vdm_tpu_torch.training import optimizers
    monkeypatch.setattr(optimizers, "apply_updates", lambda params, updates: None)


def _train_altered(monkeypatch):
    from this_and_that_vdm_tpu_torch.training import edm
    orig = edm.edm_loss
    monkeypatch.setattr(edm, "edm_loss", lambda *a: 1.5 * orig(*a))


@pytest.mark.parametrize("cell, fault", [
    ("vgl-serve-c1", _serve_unchanged), ("vgl-serve-c1", _serve_altered),
    ("vgl-serve-c4", _serve_half_batch),
    ("vl-train-b1", _train_unchanged), ("vl-train-b1", _train_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(root, cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values()), res["compared"]


@pytest.mark.parametrize("cell", ["vgl-serve-c4"])
def test_sound_run_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"] is True, res["compared"]
