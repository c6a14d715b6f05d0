"""The port's micro-batching server (serving/server.py), mirroring
tests/test_serving_server.py: three requests with different gestures and
seeds in one batch, each within 1e-4 of the same request served alone, in
one pipeline call; a request served alone equal, bit for bit, to a direct
pipeline call with ``generator=Generator.manual_seed(seed)``; mixed buckets
split; an error reaches every future of its batch; a cancelled future is
dropped; ``close`` drains the queue and refuses new submits."""

import threading

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu_torch.cli.tokenizer import hash_tokenizer
from this_and_that_vdm_tpu_torch.serving import VideoGenServer
from this_and_that_vdm_tpu_torch.weights import loader

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

FR, H, W = 2, 64, 128
# noise aug on: the determinism covers both draws (image noise and latents)
SAMPLING = dict(num_frames=FR, num_inference_steps=1, noise_aug_strength=0.1,
                decode_chunk_size=FR)


@pytest.fixture(scope="module")
def pipe():
    return loader.make_pipeline(loader.random_models("tiny", "cpu", seed=3), "vgl")


def _req(i):
    rng = np.random.RandomState(i)
    image = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    cond = rng.uniform(0, 1, (FR, H, W, 3)).astype(np.float32)
    ids = hash_tokenizer()(["pick up", "push the cup left", "open it"][i % 3])[0]
    return image, cond, ids


class Counting:
    """A pipeline stand-in that records each call's batch size."""

    def __init__(self, pipe, gate=None):
        self.pipe, self.calls, self.gate = pipe, [], gate

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, images, *args, **kw):
        self.calls.append(len(images))
        if self.gate is not None:
            self.gate.wait(timeout=60)
        return self.pipe(images, *args, **kw)


def test_batched_results_match_single_requests(pipe):
    reqs = [_req(i) for i in range(3)]
    singles = [pipe(img[None], cond, prompt_ids=ids[None],
                    generator=torch.Generator().manual_seed(10 + i), **SAMPLING)[0]
               for i, (img, cond, ids) in enumerate(reqs)]
    counting = Counting(pipe)
    server = VideoGenServer(counting, max_batch=3, max_delay_s=2.0, **SAMPLING)
    futs = [server.submit(img, condition=cond, prompt_ids=ids, seed=10 + i)
            for i, (img, cond, ids) in enumerate(reqs)]
    outs = [f.result(timeout=600) for f in futs]
    server.close()
    assert counting.calls == [3]  # one batched pipeline invocation
    assert [f.timing["batch"] for f in futs] == [3, 3, 3]
    assert all(f.timing["queue_s"] >= 0 for f in futs)
    for got, want in zip(outs, singles):
        assert got.shape == (FR, H, W, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_served_alone_equals_direct_call(pipe):
    img, cond, ids = _req(4)
    want = pipe(img[None], cond, prompt_ids=ids[None],
                generator=torch.Generator().manual_seed(7), output_type="uint8", **SAMPLING)[0]
    with VideoGenServer(pipe, output_type="uint8", **SAMPLING) as server:
        assert server.max_batch == 1
        got = server.submit(img, condition=cond, prompt_ids=ids, seed=7).result(timeout=600)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_mixed_buckets_split_and_errors_propagate(pipe):
    img, cond, _ = _req(0)
    counting = Counting(pipe)
    server = VideoGenServer(counting, max_batch=4, max_delay_s=0.2, **SAMPLING)
    ok = server.submit(img, condition=cond, seed=1)
    # different steps -> different bucket -> a separate (working) call
    other = server.submit(img, condition=cond, seed=1, num_inference_steps=2)
    assert ok.result(timeout=600).shape == other.result(timeout=600).shape == (FR, H, W, 3)
    assert counting.calls == [1, 1]
    # two malformed requests of one bucket: the error reaches both futures
    bad = [server.submit(np.zeros((8, 8, 3), np.float32), condition=cond, seed=s)
           for s in (1, 2)]
    for f in bad:
        with pytest.raises(Exception):
            f.result(timeout=600)
    assert counting.calls[2:] == [2]
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(img, condition=cond)


def test_cancelled_future_is_dropped(pipe):
    img, cond, _ = _req(1)
    gate = threading.Event()
    counting = Counting(pipe, gate)
    server = VideoGenServer(counting, max_batch=1, max_delay_s=0.0, **SAMPLING)
    first = server.submit(img, condition=cond, seed=1)
    second = server.submit(img, condition=cond, seed=2)
    third = server.submit(img, condition=cond, seed=3)
    assert second.cancel()  # still queued behind the held first call
    gate.set()
    assert first.result(timeout=600).shape == third.result(timeout=600).shape
    server.close()
    assert second.cancelled() and counting.calls == [1, 1]


def test_close_drains_the_queue_and_refuses_new_submits(pipe):
    img, cond, _ = _req(2)
    server = VideoGenServer(pipe, max_batch=2, max_delay_s=0.0, **SAMPLING)
    futs = [server.submit(img, condition=cond, seed=s, num_inference_steps=1 + s % 2)
            for s in range(3)]
    server.close(timeout=600)
    assert not server._worker.is_alive()
    assert all(f.done() and f.result().shape == (FR, H, W, 3) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(img, condition=cond)
    server.close()  # a second close is a no-op
