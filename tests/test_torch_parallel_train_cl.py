"""climb_tpu_torch's data, tensor and fully-sharded parallel CL train steps
against the JAX package's single-device trajectory, on the CPU: houlsby
adapters, LoRA and the EWC-penalized step of
``tests/test_mesh_training_equivalence.py``, in the layouts and at the
tolerances of ``tests/test_torch_parallel_train.py``.
"""

import pytest

from tests.torch_parallel_common import LAYOUTS, assert_matches, start_runs

CASES = ("adapter_houlsby", "lora", "ewc_penalized")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(CASES, tmp_path_factory)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cl_trajectory_matches_jax_single_device(layout, runs):
    world, refs = runs[layout]
    assert_matches(world.result(), refs, CASES, LAYOUTS[layout])
