"""climb_tpu_torch's data and tensor parallel training through the fused
attention sublayer (``--attn_impl fused_block``) against the JAX package's
single-device trajectory, on the CPU.

Under tensor parallelism each rank runs the sublayer on its heads with the
residual and the out-projection's bias on the first rank only
(``residual=False`` elsewhere), and LN1's gradient, which each rank computes
from its heads, is summed over 'model'. On the CPU the sublayer's op runs its
plain version, so this holds the path's arithmetic and collectives; the
kernel at the local shapes is held on the card by ``chip_smoke.py``. The
cases of ``tests/test_mesh_training_equivalence.py`` that take the fused
sublayer (no attention adapter, no LoRA): the task folds, ViLT-BERT and the
EWC-penalized step, at the layouts' and tolerances of
``tests/test_torch_parallel_train.py``; each world also shows that the
fused sublayer ran and that each rank held only its slices.
"""

import pytest

from tests.torch_parallel_common import FUSED_LAYOUTS, assert_matches, start_runs

CASES = ("vqa_bce", "nlvr2_pair_fold", "vcr_mc_fold", "viltbert", "ewc_penalized")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(CASES, tmp_path_factory, FUSED_LAYOUTS)


@pytest.mark.parametrize("layout", list(FUSED_LAYOUTS))
def test_fused_trajectory_matches_jax_single_device(layout, runs):
    world, refs = runs[layout]
    assert_matches(world.result(), refs, CASES, FUSED_LAYOUTS[layout])
