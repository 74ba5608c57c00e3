"""The JAX package's elastic train states for the port's resume tests (no
test in here; see ``tests/test_torch_msgpack.py`` and
``tests/test_torch_preemption.py``).

``jax_train_states`` runs the JAX Phase I driver (``--tiny --synthetic``
singletask_ft on snli-ve, 24 examples in batches of 8: three steps an
epoch, three epochs, ``--save_state_epochs 1``) and preempts it at its
fifth step, as its SIGTERM handler would (epoch 2, two steps in), so the
driver writes its train state at the end of epoch 1 and again mid-epoch 2,
then exits 143. Each time the driver saves, the same state and metadata are
also written, by the JAX package's own ``save_train_state``, in both of its
layouts (a msgpack file and the ``--sharded_checkpoints`` directory) beside
the run: four states from one run.
"""

import shutil

import pytest

ARGV = ["--encoder_name", "vilt", "--pretrained_model_name", "scratch", "--synthetic",
        "--tiny", "--synthetic_train_size", "24", "--batch_size", "8", "--seed", "5",
        "--task_config_overrides", "snli-ve.num_epochs=3,snli-ve.lr=2e-3",
        "--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft", "--do_train",
        "--save_state_epochs", "1"]
EXPERIMENT = "vilt-singletask_ft-task0_snli-ve"
PREEMPT_AT = 5
KINDS = ("end", "mid")  # after epoch 1; mid-epoch 2
LAYOUTS = ("msgpack", "sharded")


def argv(out_dir, *extra):
    return ARGV + ["--climb_data_dir", str(out_dir), "--output_dir", str(out_dir), *extra]


def state_path(out_dir):
    """Where a run in ``out_dir`` keeps its task's elastic train state."""
    return out_dir / EXPERIMENT / "checkpoints" / "task0_snli-ve" / "train_state"


def jax_train_states(out_dir, *extra):
    """Run and preempt the JAX driver in ``out_dir`` (``extra`` appended to
    its argv); returns {(kind, layout): path} of the four states."""
    import climb_tpu.ckpt.checkpoint as jax_checkpoint
    from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
    from climb_tpu.train import trainers as jax_trainers
    from climb_tpu.utils import preemption as jax_preemption
    from test_torch_data_common import jit_flax_init, share_jax_eval_steps

    saved = out_dir / "states"
    real_save, real_next = jax_checkpoint.save_train_state, jax_trainers.VLTaskTrainer._next_rng
    calls = [0]

    def save_both(state, meta, path, async_writer=None, sharded=False):
        real_save(state, meta, path, async_writer=async_writer, sharded=sharded)
        kind = "mid" if "steps_into_epoch" in meta else "end"
        for layout in LAYOUTS:
            real_save(state, meta, str(saved / f"{kind}-{layout}"), sharded=layout == "sharded")

    def preempting(self):
        calls[0] += 1
        if calls[0] == PREEMPT_AT:
            jax_preemption.request_preemption()
        return real_next(self)

    with pytest.MonkeyPatch.context() as mp:
        jit_flax_init(mp)
        share_jax_eval_steps(mp)
        mp.setattr(jax_checkpoint, "save_train_state", save_both)
        mp.setattr(jax_trainers.VLTaskTrainer, "_next_rng", preempting)
        with pytest.raises(SystemExit) as e:
            jax_main(argv(out_dir, *extra))
    assert e.value.code == 143
    return {(kind, layout): saved / f"{kind}-{layout}" for kind in KINDS for layout in LAYOUTS}


def install(state, out_dir, src_dir):
    """A copy of the preempted run ``src_dir`` in ``out_dir``, its train state
    replaced by ``state`` (a file or a sharded directory)."""
    shutil.copytree(src_dir / EXPERIMENT, out_dir / EXPERIMENT)
    dest = state_path(out_dir)
    shutil.rmtree(dest) if dest.is_dir() else dest.unlink()
    (shutil.copytree if state.is_dir() else shutil.copy)(state, dest)
