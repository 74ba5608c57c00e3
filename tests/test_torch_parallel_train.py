"""climb_tpu_torch's data, tensor and fully-sharded parallel training against
the JAX package's single-device trajectory, on the CPU.

The cases of ``tests/test_mesh_training_equivalence.py`` take JAX's
``run_trajectory``: three steps of
AdamW (lr 1e-3, no warmup) on its synthetic batches of 8 with mixed patch
grids. The port starts from the same weights (``state_dict_from_jax``) and
runs the same steps in one spawned ``gloo`` world per layout
(``tests/torch_parallel_worker.py``, ``tests/torch_parallel_common.py``):
DP 2, TP 2, DP x TP 2 x 2 and FSDP 2 x 2 (FSDP over 'data' with TP over
'model'). This file holds the task losses and folds (vqa, nlvr2's image-pair
fold, vcr's multiple-choice fold); ``tests/test_torch_parallel_train_viltbert.py``
ViLT-BERT, and ``tests/test_torch_parallel_train_cl.py`` the CL steps
(houlsby adapters, LoRA, the EWC-penalized step). Each world also shows
that every rank held only its slices of the parameters. The multiple-choice head runs
without dropout in both packages (its dropout draws from each package's own
generator).

Tolerances: the losses at rtol 2e-4, the bound at which
``tests/test_mesh_training_equivalence.py`` holds JAX's own sharded
trajectories to its single device (ViLT-BERT's third loss moves by 1e-5
relative with the rounding of its initial weights alone); every parameter at its PARAM_RTOL and at PARAM_ATOL_PARALLEL =
5e-5, five times its PARAM_ATOL: the ranks' gradient sums run in another
order, and AdamW divides each step by sqrt(v) + eps, so an element whose
gradient is near the rounding noise (VQA's 3,129-way head: a few of its
400,512 weights) may move by a few percent of a step (lr 1e-3) more or less
than in JAX; except the parameters whose exact gradient is 0 (the key bias of every block, and VCR's
one-logit head bias, which shifts every choice's score alike): the softmax
cancels them, so both packages step them on rounding noise, and AdamW moves
each such element by up to lr a step whatever the noise's size, in either
direction in each package; they are held to twice the steps' sum, as in
``tests/test_torch_train_step.py`` (``torch_parallel_common.assert_matches``). ViLT-BERT's patch projection is held to
the same bound: JAX's own 4 x 2 mesh run moves one of its elements 4.3e-4
from JAX's single-device run after these three steps (an element whose
gradient is rounding noise), and the port's ranks land within that spread.
"""

import pytest

from tests.torch_parallel_common import LAYOUTS, assert_matches, start_runs

CASES = ("vqa_bce", "nlvr2_pair_fold", "vcr_mc_fold")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_runs(CASES, tmp_path_factory)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_trajectory_matches_jax_single_device(layout, runs):
    world, refs = runs[layout]
    assert_matches(world.result(), refs, CASES, LAYOUTS[layout])
