"""The parent side of the port's parallel trajectory tests (no test in here):
JAX's single-device trajectories of ``tests/test_mesh_training_equivalence.py``'s
cases, the port's worlds (``tests/torch_parallel_worker.py``) started beside
them, and the comparison with its tolerances (see
``tests/test_torch_parallel_train.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from climb_tpu.models import vilt as jax_vilt
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from tests import test_mesh_training_equivalence as mesh_eq
from tests import torch_parallel_worker as worker
from tests.test_torch_data_common import jit_flax_init
from tests.test_torch_train_step import LOSS_ATOL, PARAM_ATOL, PARAM_RTOL

torch.set_num_threads(1)

STEPS, LR = 3, 1e-3
PARAM_ATOL_PARALLEL = 5 * PARAM_ATOL
LOSS_RTOL_PARALLEL = 2e-4
LAYOUTS = {  # name: (ranks, mesh layout)
    "dp2": (2, dict(n_model=1)),
    "tp2": (2, dict(n_model=2)),
    "dp2_tp2": (4, dict(n_model=2)),
    "fsdp2_tp2": (4, dict(n_model=2, fsdp=True)),
}
# the fused attention sublayer (--attn_impl fused_block): its residual=False
# backward and LN1's gradient summed over 'model' under TP
FUSED_LAYOUTS = {
    "dp2_fused": (2, dict(n_model=1, attn_impl="fused_block")),
    "tp2_fused": (2, dict(n_model=2, attn_impl="fused_block")),
}
SHIFT_INVARIANT = (".k.bias", "head_vcr.fc.bias")
NOISE_DOMINATED = ("viltbert.vilt.patch_projection.weight",)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_case(task, encoder, adapter, model, batches, ewc_ref=None, **extra):
    """The worker's description of one case, from the JAX model's weights."""
    case = dict(task=task, encoder=encoder, adapter=adapter,
                state_dict=state_dict_from_jax(_np_tree(model.params)),
                batches=[{k: np.asarray(v) for k, v in b.items()} for b in batches], **extra)
    if ewc_ref is not None:
        key = model.encoder_key
        named = lambda t: {f"{key}.{n}": v for n, v in state_dict_from_jax(_np_tree(t)).items()}
        case["ewc"] = dict(fisher=named(ewc_ref.fisher), anchor=named(ewc_ref.anchor),
                           weight=float(ewc_ref.weight))
    return case


def start_runs(case_ids, tmp_path_factory, layouts=None):
    """{layout: (the port's world, JAX's single-device (losses, final
    parameters) per case)} for the cases named ``case_ids``: the worlds start
    as soon as the cases are made and run while JAX computes its
    trajectories."""
    with pytest.MonkeyPatch.context() as mp:
        jit_flax_init(mp)
        head_for = jax_vilt._head_for
        mp.setattr(jax_vilt, "_head_for", lambda spec, d, dtype: head_for(
            dataclasses.replace(spec, dropout_rate=0.0), d, dtype))
        made = []
        chosen = [c for c in mesh_eq.CASES if c[0] in case_ids]
        for _, task, encoder, adapter, with_ewc in chosen:
            model = mesh_eq.make_model(task, encoder, adapter)
            batches = mesh_eq.synthetic_batches(task)
            ewc_ref = mesh_eq.make_ewc_ref(model) if with_ewc else None
            made.append((task, model, batches, ewc_ref))
        cases = [port_case(task, enc, adapter, model, batches, ewc_ref)
                 for (task, model, batches, ewc_ref), (_, _, enc, adapter, _) in
                 zip(made, chosen)]
        worlds = {name: worker.World("trajectory", world, str(tmp_path_factory.mktemp(name)),
                                     dict(layout=spec, cases=cases), timeout=240)
                  for name, (world, spec) in (layouts or LAYOUTS).items()}
        refs = []
        for task, model, batches, ewc_ref in made:
            losses, state = mesh_eq.run_trajectory(model, task, batches, None, ewc_ref=ewc_ref)
            refs.append((losses, state_dict_from_jax(_np_tree(state.params))))
    return {name: (w, refs) for name, w in worlds.items()}


def assert_held(got, layout, case_id):
    """Each rank held only its slices: q's rows over 'model', and under FSDP
    the word embeddings' rows over 'data'."""
    spec = layout[1]
    n_model, n_data = spec.get("n_model", 1), layout[0] // spec.get("n_model", 1)
    for n, whole in got["params"].items():
        held = got["held"][n]
        if n.endswith(".q.weight") and ".encoder." in n and "bert.encoder" not in n \
                and not spec.get("pp_stages"):
            assert held == (whole.shape[0] // n_model, whole.shape[1]), (case_id, n, held)
        if spec.get("fsdp") and n.endswith("vilt.word_embeddings.weight"):
            assert held == (whole.shape[0] // n_data, whole.shape[1]), (case_id, n, held)
    if spec.get("pp_stages", 0) > 1:  # rank 0, stage 0: the first stage's layers only
        layers = {n.split(".")[2] for n in got["params"] if n.startswith("vilt.encoder.")}
        empty = {n.split(".")[2] for n in got["params"] if n.startswith("vilt.encoder.")
                 and got["held"][n] == (0,)}
        assert len(empty) == len(layers) // 2, (case_id, sorted(empty))
    if spec.get("attn_impl") == "fused_block":
        assert got["fused_calls"] > 0, case_id


def assert_matches(results, refs, ids, layout=None):
    for got, (losses, params), case_id in zip(results, refs, ids):
        if layout is not None:
            assert_held(got, layout, case_id)
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL_PARALLEL,
                                   atol=LOSS_ATOL, err_msg=case_id)
        assert set(got["params"]) == set(params), case_id
        for n, want in params.items():
            atol = (2 * STEPS * LR if n.endswith(SHIFT_INVARIANT) or n in NOISE_DOMINATED
                    else PARAM_ATOL_PARALLEL)
            np.testing.assert_allclose(got["params"][n].numpy(), want.numpy(), atol=atol,
                                       rtol=PARAM_RTOL, err_msg=f"{case_id}: {n}")
