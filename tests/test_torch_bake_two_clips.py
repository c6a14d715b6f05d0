"""The port's baked pipelines against the baked JAX pipelines at two clips
(``tests/torch_bake_parity.py``)."""

import pytest

from test_torch_pipeline import pipes  # noqa: F401  (fixture)
from torch_bake_parity import (VGL_IDS, VGL_MODES, baked_jax,  # noqa: F401  (fixture)
                               check_baked_vgl, check_baked_vl)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("clips", [2])
@pytest.mark.parametrize("mode", VGL_MODES, ids=VGL_IDS)
def test_baked_vgl_matches_baked_jax(pipes, baked_jax, mode, clips):  # noqa: F811
    check_baked_vgl(pipes, baked_jax, mode, clips)


@pytest.mark.parametrize("clips", [2])
def test_baked_vl_matches_baked_jax(pipes, baked_jax, clips):  # noqa: F811
    check_baked_vl(pipes, baked_jax, clips)
