"""Multi-process worlds for the port's scale-out tests (no test in here).

``spawn(job, world, workdir, payload)`` starts ``world`` copies of this file
as ``gloo`` ranks on the CPU, rendezvousing through a ``file://`` path under
``workdir`` (no TCP port: pytest workers run side by side), hands each the
``payload`` (a ``torch.save`` file) and returns rank 0's result. A world that
has not finished within ``timeout`` seconds is killed, and so is every rank
when one fails; either fails the calling test. ``World`` starts one without
waiting (``result()`` waits), so that worlds run beside other work. The children import torch and
``climb_tpu_torch`` only, never JAX; each runs one thread.

Jobs:
- ``trajectory``: the cases' train steps (the JAX package's
  ``run_trajectory``: lr 1e-3 over 10 steps, no warmup) on a mesh layout;
- ``mesh``: each rank's mesh coordinates and its axes' sums;
- ``sp_attention``: ring and Ulysses attention over the world;
- ``save_sharded``: a sharded task checkpoint and a sharded train state
  (bf16 first moments) written by every rank;
- ``load_sharded``: a sharded checkpoint read back whole on every rank;
- ``driver``: the Phase I driver's ``main`` with the payload's argv;
- ``int8_eval``: the int8 eval forwards of a learner under TP over the whole
  world and on one rank, with the port's calibration and with given scales;
- ``predict``: the ``predict`` CLI with the payload's argv (rank 0 returns
  its output JSON).
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class World:
    """A started world of ranks; ``result()`` waits for it (see ``spawn``)."""

    def __init__(self, job: str, world: int, workdir: str, payload, timeout: float):
        import torch

        self.job, self.world, self.workdir = job, world, workdir
        os.makedirs(workdir, exist_ok=True)
        torch.save(payload, os.path.join(workdir, "payload.pt"))
        rdzv = os.path.join(workdir, "rendezvous")
        if os.path.exists(rdzv):
            os.remove(rdzv)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        env.pop("JAX_PLATFORMS", None)
        self.logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                                        str(world), workdir], env=env, stdout=self.logs[r],
                                       stderr=subprocess.STDOUT, cwd=workdir)
                      for r in range(world)]
        self.timeout = timeout
        self.deadline = time.time() + timeout

    def result(self):
        import torch

        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if time.time() > self.deadline or any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
        rcs = [p.returncode for p in procs]
        if any(rc != 0 for rc in rcs):
            tails = []
            for r in range(self.world):
                with open(os.path.join(self.workdir, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} (rc {rcs[r]}) ---\n" + f.read()[-3000:])
            raise AssertionError(f"{self.job} world of {self.world} failed or timed out after "
                                 f"{self.timeout} s:\n" + "\n".join(tails))
        return torch.load(os.path.join(self.workdir, "result.pt"), weights_only=False)


def spawn(job: str, world: int, workdir: str, payload, timeout: float = 150.0):
    """Run ``job`` in a world of ``world`` ranks and return rank 0's result."""
    return World(job, world, workdir, payload, timeout).result()


# -- jobs (run in the children) ------------------------------------------------

def _port_model(case, layout, mesh):
    from types import SimpleNamespace

    import torch

    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.model_factory import create_cl_model

    args = SimpleNamespace(
        batch_size=8, seed=0, ordered_cl_tasks=case.get("tasks", [case["task"]]),
        encoder_name=case["encoder"],
        pretrained_model_name="scratch", tiny=True, synthetic=True, image_height=64,
        image_width=96, compute_dtype=case.get("dtype", "float32"),
        attn_impl=layout.get("attn_impl", "pallas"), mlp_impl="pallas",
        n_model=layout.get("n_model", 1), fsdp=layout.get("fsdp", False),
        pp_stages=layout.get("pp_stages", 0), pp_virtual=layout.get("pp_virtual", 1),
        pp_microbatches=layout.get("pp_microbatches", 0), num_layers=case.get("num_layers", 2))
    handler = None
    if case.get("adapter"):
        from climb_tpu_torch.cl.adapters import AdapterHandler

        args.adapter_config = case["adapter"]
        args.adapter_reduction_factor = 2
        args.lora_rank = 2 if case["adapter"] == "lora" else 0
        args.lora_alpha = 4.0 if case["adapter"] == "lora" else 0.0
        args.lora_targets = ""
        handler = AdapterHandler("vanilla", args)
    model = create_cl_model(args, task_configs, torch.device("cpu"), adapter_handler=handler,
                            mesh=mesh)
    model.load_state_dict(case["state_dict"])
    if handler is not None:
        model = handler.activate_adapter_for_training(case["task"], model)
    return model


def _layout_mesh(layout):
    from climb_tpu_torch.parallel import mesh as meshes

    if layout.get("pp_stages", 0) > 1:
        return meshes.make_dp_pp_mesh(layout["pp_stages"])
    return meshes.make_mesh(n_model=layout.get("n_model", 1))


def job_trajectory(payload):
    import torch

    from climb_tpu_torch.train.eval_step import LOSS_TYPES
    from climb_tpu_torch.train.optimizer import make_optimizer
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import EwcRef, make_train_step

    from climb_tpu_torch.models.vilt import MultiChoiceHead

    from climb_tpu_torch.ops import block

    MultiChoiceHead.dropout_rate = 0.0  # the JAX side's head runs without dropout too
    calls = [0]  # the fused sublayer's calls, which a fused_block layout must make
    sublayer = block.attention_sublayer

    def counted(*a, **kw):
        calls[0] += 1
        return sublayer(*a, **kw)

    block.attention_sublayer = counted
    layout = payload["layout"]
    mesh = _layout_mesh(layout)
    out = []
    for case in payload["cases"]:
        model = _port_model(case, layout, mesh)
        tx = make_optimizer([n for n, _ in model.named_parameters()], lr=1e-3,
                            total_steps=10, warmup_ratio=0.0,
                            trainable_mask=model.trainable_mask)
        state = TrainState.create(model, tx)
        step = make_train_step(model, case["task"], LOSS_TYPES[case["task"]],
                               model.cfg.compute_dtype)
        ewc = case.get("ewc")
        # a Phase I run's Fisher and anchor are each rank's slices, as its parameters
        ref = (EwcRef(model.parallel.localize(ewc["fisher"]),
                      model.parallel.localize(ewc["anchor"]), ewc["weight"]) if ewc else None)
        losses = []
        for batch in case["batches"]:
            rows = model.parallel.shard_rows({k: torch.as_tensor(v) for k, v in batch.items()})
            losses.append(float(step(state, rows, ref)["loss"]))
        whole = model.state_dict()  # every rank's slices, gathered
        out.append({"losses": losses,
                    "params": {n: whole[n].clone() for n, _ in model.named_parameters()},
                    "held": {n: tuple(p.shape) for n, p in model.named_parameters()},
                    "fused_calls": calls[0]})
    return out


def job_mesh(payload):
    import torch
    import torch.distributed as dist

    from climb_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh

    mesh = make_mesh(n_model=2)
    rank = dist.get_rank()
    coords = torch.tensor([mesh.coord("data"), mesh.coord("model")])
    sums = {}
    for axis in ("data", "model"):
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t, group=mesh.group(axis))
        sums[axis] = t
    gathered = {k: [torch.empty_like(v) for _ in range(4)] for k, v in
                (("coords", coords), ("data", sums["data"]), ("model", sums["model"]))}
    dist.all_gather(gathered["coords"], coords)
    dist.all_gather(gathered["data"], sums["data"])
    dist.all_gather(gathered["model"], sums["model"])
    return {"coords": [c.tolist() for c in gathered["coords"]],
            "data_sums": [float(t) for t in gathered["data"]],
            "model_sums": [float(t) for t in gathered["model"]],
            "multislice": dict(make_multislice_mesh(slice_count=2).shape)}


def job_sp_attention(payload):
    import torch
    import torch.distributed as dist

    from climb_tpu_torch.ops.sp_attention import sequence_parallel_attention

    out = {}
    for impl in ("ring", "ulysses"):
        q, k, v, mask = (torch.as_tensor(payload[n]) for n in ("q", "k", "v", "mask"))
        out[impl] = sequence_parallel_attention(q, k, v, mask, dist.group.WORLD, impl=impl)
    return out


def job_save_sharded(payload):
    """The task checkpoint of the payload's model, then one train step with
    bf16 first moments and the sharded train state; returns the moments."""
    import torch

    from climb_tpu_torch.ckpt.checkpoint import save_task_checkpoint, save_train_state
    from climb_tpu_torch.train.optimizer import make_optimizer
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    layout, case = payload["layout"], payload["case"]
    mesh = _layout_mesh(layout)
    model = _port_model(case, layout, mesh)
    save_task_checkpoint(payload["out_dir"], 0, case["task"], model.state_dict(),
                         model.encoder_key, sharded=True, parallel=model.parallel)
    tx = make_optimizer([n for n, _ in model.named_parameters()], lr=1e-3, total_steps=10,
                        warmup_ratio=0.0, moments_dtype="bfloat16")
    state = TrainState.create(model, tx)
    batch = {k: torch.as_tensor(v) for k, v in case["batches"][0].items()}
    make_train_step(model, case["task"], "ce")(state, model.parallel.shard_rows(batch))
    save_train_state(state, {"epoch": 1}, payload["state_dir"], sharded=True)
    mu, nu = state.moments()
    return {"mu": mu, "nu": nu, "step": state.step}


def job_load_sharded(payload):
    from climb_tpu_torch.ckpt.checkpoint import load_model_file

    return load_model_file(payload["path"])


def job_driver(payload):
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver

    driver.main(payload["argv"])
    return {"ok": True}


def job_int8_eval(payload):
    """For each case (``dense_impl``, ``mlp_impl``, ``dtype``, and optionally
    ``lora``, the projections given LoRA deltas of random weights, the task's
    active): the learner of ``payload['config']`` with the payload's weights,
    on a ('data', 'model')
    mesh of one data rank (TP over the world) and alone on each rank (no
    mesh). Each gives its eval logits on ``payload['batch']``; under
    int8_static each first calibrates on ``payload['calibration']`` (its
    scales, and the scales of every rank) and then also evaluates with each
    of ``payload['scales']`` installed (the JAX package's, carried across)."""
    import torch
    import torch.distributed as dist

    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.models.model_config import (
        AdapterSpec,
        ViltConfig,
        head_specs_from_task_configs,
    )
    from climb_tpu_torch.models.vilt import ViltContinualLearner
    from climb_tpu_torch.ops import quant
    from climb_tpu_torch.parallel.mesh import make_mesh
    from climb_tpu_torch.parallel.sharding import shard_model
    from climb_tpu_torch.train.eval_step import calibrate_quant_scales, make_eval_step

    mesh = make_mesh(n_model=dist.get_world_size())
    task, tensors = payload["task"], lambda b: {k: torch.as_tensor(v) for k, v in b.items()}
    out = []
    for case in payload["cases"]:
        case = dict(case)
        spec = case.pop("lora", None)  # LoRA targets: random deltas on those projections
        cfg = ViltConfig(**payload["config"], **case)
        kw = {} if spec is None else {"adapter_spec": AdapterSpec(
            lora=True, lora_rank=4, lora_targets=tuple(spec)), "adapter_tasks": payload["tasks"]}
        weights = payload["state_dict"]
        if spec is not None:
            weights = dict(weights)
            g = torch.Generator().manual_seed(7)
            probe = ViltContinualLearner(cfg, head_specs_from_task_configs(payload["tasks"],
                                                                           task_configs), **kw)
            weights.update({n: torch.randn(p.shape, generator=g) * 0.1
                            for n, p in probe.named_parameters() if "lora" in n})
        got = {}
        for name, where in (("tp", mesh), ("one", None)):
            model = ViltContinualLearner(cfg, head_specs_from_task_configs(payload["tasks"],
                                                                          task_configs), **kw)
            model = shard_model(model.eval(), where)
            model.load_state_dict(weights)
            model.active_adapter = task if spec is not None else None
            step = make_eval_step(model, task, "ce", cfg.compute_dtype)
            if cfg.dense_impl == "int8_static":
                own = calibrate_quant_scales(model, task, map(tensors, payload["calibration"]),
                                             cfg.compute_dtype)
                own = {n: v.clone() for n, v in own.items()}
                ranks = [None] * dist.get_world_size()
                dist.all_gather_object(ranks, own)
                got[name + "_scales"], got[name + "_rank_scales"] = own, ranks
                got[name + "_given"] = []
                for scales in payload["scales"][case["mlp_impl"], case["dtype"]]:
                    quant.load_quant_buffers(model, scales)
                    got[name + "_given"].append(step(tensors(payload["batch"]))[0].float())
                quant.load_quant_buffers(model, own)
            got[name] = step(tensors(payload["batch"]))[0].float()
        out.append(got)
    return out


def job_predict(payload):
    from climb_tpu_torch.cli import predict

    return predict.main(payload["argv"])


def _child(job, rank, world, workdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from climb_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed("cpu", init_method="file://" + os.path.join(workdir, "rendezvous"),
                           world_size=world, rank=rank)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    result = globals()[f"job_{job}"](payload)
    if rank == 0:
        torch.save(result, os.path.join(workdir, "result.pt.tmp"))
        os.replace(os.path.join(workdir, "result.pt.tmp"), os.path.join(workdir, "result.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
