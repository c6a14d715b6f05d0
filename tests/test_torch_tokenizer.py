"""The port's CLIP BPE tokenizer against ``transformers.CLIPTokenizer`` (no
``ftfy``, as here and on the card), ids equal: over the tokenizer folder the
JAX rehearsal writes (no merges) and over the same folder with a dozen
merges, so the merge loop runs.  The ``--random-weights`` hash tokenizer
equals the JAX CLI's bit for bit."""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
from transformers import CLIPTokenizer as HFTokenizer

from this_and_that_vdm_tpu.cli import inference as jinference
from this_and_that_vdm_tpu.cli.rehearsal import _write_tokenizer

from this_and_that_vdm_tpu_torch.cli.tokenizer import CLIPTokenizer, hash_tokenizer

PROMPTS = {
    "lower": "pick the red block up and put it on the plate",
    "upper": "Put The Cup ON the Plate!",
    "punctuation": "robot, and the pin-pick thing?! (yes) -- [ok]; 'quoted'",
    "digits": "move it 12 cm, then 3.5 more... 2024",
    "apostrophes": "don't it's we'll they've I'm you'd she's",
    "accents": "café naïve résumé Ångström",
    "underscore": "snake_case __init__ a_b _",
    "empty": "",
    "blank": "   \t\n ",
    "long": "pick up " * 60,
    "numerics": "²³ ½ Ⅻ 一二 ㆒",
    "special_token": "hello<|endoftext|>world",
    "cyrillic_emoji_cjk": "ЖЁЛТЫЙ кот 👍 的中文",
}
MERGES = ["t h", "th e</w>", "i n", "p i", "c k</w>", "u p</w>", "a n", "an d</w>", "r o",
          "ro b", "e </w>", "o n</w>", "t o</w>", "1 2"]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tok") / "plain")
    _write_tokenizer(base)
    merged = str(tmp_path_factory.mktemp("tok") / "merged")
    shutil.copytree(os.path.join(base, "tokenizer"), os.path.join(merged, "tokenizer"))
    with open(os.path.join(merged, "tokenizer", "vocab.json")) as f:
        vocab = json.load(f)
    for m in MERGES:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    with open(os.path.join(merged, "tokenizer", "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(merged, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return {"plain": base, "merged": merged}


@pytest.fixture(scope="module")
def pairs(folders):
    return {k: (HFTokenizer.from_pretrained(v, subfolder="tokenizer"),
                CLIPTokenizer.from_pretrained(v)) for k, v in folders.items()}


@pytest.mark.parametrize("folder", ["plain", "merged"])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_ids_equal_transformers(pairs, folder, prompt):
    hf, ours = pairs[folder]
    text = PROMPTS[prompt]
    want = hf([text], max_length=hf.model_max_length, padding="max_length", truncation=True,
              return_tensors="np").input_ids
    got = ours([text])
    assert got.shape == want.shape == (1, 77)
    np.testing.assert_array_equal(got, want)


def test_merges_change_the_ids(pairs):
    text = PROMPTS["lower"]
    plain, merged = pairs["plain"][1]([text]), pairs["merged"][1]([text])
    assert (plain != merged).any()
    assert pairs["merged"][1].bpe("the") == "the</w>"


def test_hash_tokenizer_equals_jax():
    jax_tok = jinference._tokenizer(argparse.Namespace(random_weights=True))
    ours = hash_tokenizer()
    for text in list(PROMPTS.values()):
        got, want = ours(text), jax_tok(text)
        assert got.dtype == want.dtype and got.shape == want.shape == (1, 77)
        np.testing.assert_array_equal(got, want)
