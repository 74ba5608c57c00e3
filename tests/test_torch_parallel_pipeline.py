"""climb_tpu_torch's pipeline-parallel training against the JAX package's
single-device trajectory, on the CPU.

Two pipeline stages (a 2-rank gloo world, ``--pp_stages 2``) with 4
microbatches of a batch of 8: the GPipe schedule (V = 1) on the tiny
learner's 2 layers, and the circular schedule (V = 2) on a 4-layer tiny
learner, against ``tests/test_mesh_training_equivalence.py``'s
``run_trajectory`` on one device from the same weights and batches (vqa and
nlvr2's image-pair fold; the EWC-penalized step at V = 1, LoRA at V = 2). The
tolerances are ``tests/test_torch_parallel_train.py``'s.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from climb_tpu.configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create
from tests import test_mesh_training_equivalence as mesh_eq
from tests import torch_parallel_worker as worker
from tests.test_torch_data_common import jit_flax_init
from tests.torch_parallel_common import assert_matches, port_case

torch.set_num_threads(1)

SCHEDULES = {  # name: (layers, V, cases)
    "gpipe_v1": (2, 1, ("vqa_bce", "ewc_penalized")),
    "circular_v2": (4, 2, ("nlvr2_pair_fold", "lora")),
}


def _jax_model(task, adapter, layers):
    args = SimpleNamespace(batch_size=8, seed=0, ordered_cl_tasks=[task], encoder_name="vilt",
                           pretrained_model_name="scratch", tiny=True, synthetic=True,
                           image_height=64, image_width=96, num_layers=layers)
    handler = None
    if adapter is not None:
        from climb_tpu.cl.adapters import AdapterHandler

        args.adapter_config = adapter
        args.adapter_reduction_factor = 2
        args.lora_rank = 2 if adapter == "lora" else 0
        args.lora_alpha = 4.0 if adapter == "lora" else 0.0
        args.lora_targets = ""
        handler = AdapterHandler("vanilla", args)
    model = jax_create(args, jax_task_configs, adapter_handler=handler)
    if handler is not None:
        model = handler.activate_adapter_for_training(task, model)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    by_id = {c[0]: c for c in mesh_eq.CASES}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jit_flax_init(mp)
        made = {}
        for name, (layers, virtual, ids) in SCHEDULES.items():
            made[name] = []
            for case_id in ids:
                _, task, _, adapter, with_ewc = by_id[case_id]
                model = _jax_model(task, adapter, layers)
                batches = mesh_eq.synthetic_batches(task)
                ewc_ref = mesh_eq.make_ewc_ref(model) if with_ewc else None
                made[name].append((task, model, batches, ewc_ref, adapter))
            cases = [port_case(task, "vilt", adapter, model, batches, ewc_ref,
                               num_layers=layers)
                     for task, model, batches, ewc_ref, adapter in made[name]]
            layout = dict(pp_stages=2, pp_virtual=virtual, pp_microbatches=4)
            out[name] = [worker.World("trajectory", 2, str(tmp_path_factory.mktemp(name)),
                                      dict(layout=layout, cases=cases), timeout=180), []]
        for name in SCHEDULES:
            for task, model, batches, ewc_ref, _ in made[name]:
                losses, state = mesh_eq.run_trajectory(model, task, batches, None,
                                                       ewc_ref=ewc_ref)
                out[name][1].append((losses, _state_dict(state.params)))
    return out


def _state_dict(params):
    import jax

    from climb_tpu_torch.ckpt.convert import state_dict_from_jax

    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pipeline_trajectory_matches_jax_single_device(schedule, runs):
    world, refs = runs[schedule]
    layers, virtual, ids = SCHEDULES[schedule]
    layout = (2, dict(pp_stages=2, pp_virtual=virtual, pp_microbatches=4))
    assert_matches(world.result(), refs, list(ids), layout)
