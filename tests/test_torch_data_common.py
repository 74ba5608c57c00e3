"""Shared set-up of the ``test_torch_data_*.py``, ``test_torch_phase2_*.py``
and ``test_torch_real_data_driver.py`` files, and ``jit_flax_init`` for every
port test file that runs a JAX driver (no tests here).

The JAX package's native libraries are compiled from its sources, with its
flags (``climb_tpu/native/build.py``), into a private directory and put in
place of ``climb_tpu.native``'s functions for one test module, so that both
packages take the same route (libjpeg decode and the C++ resample, which is
within 2 levels of PIL's resize, not bit-equal to it) and their canvases can
be held bit for bit. Nothing is written into the JAX package, whose own
tests build there.
"""

import importlib.util
import shutil
import subprocess
from pathlib import Path

import pytest


def jax_native(mp: pytest.MonkeyPatch, build_dir) -> None:
    """Build the JAX package's native libraries under ``build_dir`` and make
    ``climb_tpu.native`` serve them until ``mp`` is undone."""
    import climb_tpu.native as jax_native_mod
    from climb_tpu.native import build as jax_build

    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(jax_build.HERE) / "__init__.py", build_dir / "__init__.py")
    procs = [subprocess.Popen(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                               "-o", str(build_dir / out), str(Path(jax_build.HERE) / src), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for src, out, extra in jax_build.TARGETS]
    for proc in procs:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out.decode()[-2000:]
    spec = importlib.util.spec_from_file_location("jax_native_private", build_dir / "__init__.py")
    private = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(private)
    assert all(private.native_available().values())
    for name in ("NativeWordPieceTokenizer", "resize_into_canvas", "decode_jpeg", "jpeg_dims",
                 "native_available"):
        mp.setattr(jax_native_mod, name, getattr(private, name))


@pytest.fixture(scope="module")
def jax_native_route(tmp_path_factory):
    """The JAX package on its native route for the test module."""
    mp = pytest.MonkeyPatch()
    jax_native(mp, tmp_path_factory.mktemp("jax_native"))
    yield
    mp.undo()


_JITTED_INIT = {}


def jit_flax_init(mp: pytest.MonkeyPatch) -> None:
    """Jit the JAX drivers' ``module.init`` until ``mp`` is undone (it runs op
    by op otherwise, most of a tiny JAX driver run's time). The jitted init
    takes the module (hashed by its configuration) and the keyword arguments
    as static arguments and is kept for the process, so a later driver run
    with a module of the same configuration and inputs of the same shapes
    reuses the compiled init. The port's side of a driver test loads the
    parameters the JAX driver made, so both still start from the same ones."""
    import flax.linen
    import jax

    if not _JITTED_INIT:
        real_init = flax.linen.Module.init

        def init(module, kw_items, rngs, *batch):
            return real_init(module, rngs, *batch, **dict(kw_items))

        _JITTED_INIT["init"] = jax.jit(init, static_argnums=(0, 1))
    jitted = _JITTED_INIT["init"]
    mp.setattr(flax.linen.Module, "init", lambda self, rngs, *a, **kw: jitted(
        self, tuple(sorted(kw.items())), rngs, *a))


def shape_only_flax_init(mp: pytest.MonkeyPatch) -> None:
    """Until ``mp`` is undone, ``module.init`` gives the parameters' shapes
    and dtypes (``jax.eval_shape``) without drawing them, for a test that
    replaces every leaf with numpy draws anyway."""
    import flax.linen
    import jax

    real_init = flax.linen.Module.init
    mp.setattr(flax.linen.Module, "init", lambda self, rngs, *a, **kw: jax.eval_shape(
        lambda: real_init(self, rngs, *a, **kw)))


_EVAL_STEPS = {}


def share_jax_eval_steps(mp: pytest.MonkeyPatch) -> None:
    """Until ``mp`` is undone, the JAX package's ``make_eval_step`` hands back
    one jitted eval step per (module, task, loss, dtype) for the process: its
    trainers build a new one for every eval (each epoch's, the forgetting
    eval's, predict's), which traces and compiles the same function again."""
    import climb_tpu.train.downstream as jax_downstream
    import climb_tpu.train.train_step as jax_train_step
    import climb_tpu.train.trainers as jax_trainers

    make = _EVAL_STEPS.setdefault("make", jax_train_step.make_eval_step)

    def shared(model, task_key, loss_type, compute_dtype=None, extra_vars=None):
        args = (model, task_key, loss_type) + (() if compute_dtype is None else (compute_dtype,))
        if extra_vars is not None:
            return make(*args, extra_vars=extra_vars)
        if args not in _EVAL_STEPS:
            _EVAL_STEPS[args] = make(*args)
        return _EVAL_STEPS[args]

    for module in (jax_train_step, jax_trainers, jax_downstream):
        mp.setattr(module, "make_eval_step", shared)


def copy_root(src, dst) -> str:
    """A copy of a data root without its parse caches (``cached_*``)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("cached_*"))
    return str(dst)
