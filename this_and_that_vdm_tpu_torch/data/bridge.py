"""Prompt rewriting of the Bridge data (the port's copy of
``ambiguous_prompt`` in ``this_and_that_vdm_tpu/data/bridge.py``)."""

from __future__ import annotations


def ambiguous_prompt(prompt: str) -> str:
    """Inference-time full rewrite: "<verb> this to there" (reference
    test_code/inference.py:100-102)."""
    words = prompt.split()  # split() (not split(" ")) so "" -> [] -> default
    return (words[0] if words else "move") + " this to there"
