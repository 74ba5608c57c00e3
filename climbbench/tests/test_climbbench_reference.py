"""The plain reference (``climbbench/reference``) against the port's plain
PyTorch path at a tiny size on the CPU, on weights and batches drawn from a
seed: logits, the loss and every gradient, and AdamW's updates. The test
imports both; the reference imports nothing of the port."""

import math

import pytest
import torch

from climbbench import program
from climbbench.common import HARNESS, load_json
from climbbench.reference import model as ref
from climbbench.reference import train as ref_train
from climbbench.reference.params import decays, param_spec
from climbbench.tests.tiny import overrides
from climbbench.traffic import make_pool
from climbbench.weights import make_weights

CELLS = ("vilt-b32.train-snlive-b64", "viltbert.train-snlive-b64")


def tiny_cell(cell):
    over = overrides(cell, "float32")
    name = "viltbert" if cell.startswith("viltbert") else "vilt-b32"
    config = {**load_json(HARNESS / "configs" / f"{name}.json"), **over["config"]}
    traffic = {**load_json(HARNESS / "traffic" / "train-snlive-b64.json"), **over["traffic"]}
    return config, traffic


def port_learner(config, traffic, seed):
    model = program.learner(config, traffic, torch.device("cpu"))
    weights = make_weights(param_spec(config, traffic["task"], traffic["labels"]), seed, "cpu")
    program.load_weights(model, weights)
    return model, weights


@pytest.mark.parametrize("cell", CELLS)
def test_logits_loss_and_gradients_match_the_port(cell):
    config, traffic = tiny_cell(cell)
    model, weights = port_learner(config, traffic, seed=2**31 + 7)
    batch = make_pool(traffic, config, 2**31 + 7, "cpu")[0]
    model.train()
    from climb_tpu_torch.train.eval_step import prepare_batch

    got = model("snli-ve", prepare_batch(batch))
    want_p = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    want = ref.logits(ref.F32, want_p, config, "snli-ve", batch)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)

    torch.nn.functional.cross_entropy(got, batch["labels"].long()).backward()
    loss = ref.loss(ref.F32, want_p, config, "snli-ve", batch)
    loss.backward()
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        r = want_p[name].grad if want_p[name].grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-4, msg=name)


def test_adamw_matches_the_port():
    from climb_tpu_torch.train.optimizer import make_optimizer

    opt = {"lr": 1e-2, "total_steps": 10, "warmup_ratio": 0.1, "weight_decay": 0.01,
           "adam_epsilon": 1e-8}
    g = torch.Generator().manual_seed(3)
    names = ["vilt.encoder.0.fc1.weight", "vilt.encoder.0.fc1.bias",
             "vilt.text_layernorm.weight"]
    params = {n: torch.randn(8, 4, generator=g) for n in names}
    tx = make_optimizer(names, lr=opt["lr"], total_steps=opt["total_steps"],
                        warmup_ratio=opt["warmup_ratio"], weight_decay=opt["weight_decay"],
                        adam_epsilon=opt["adam_epsilon"])
    mu, nu = tx.init(params)
    port = {n: p.clone() for n, p in params.items()}
    mine = {n: p.clone() for n, p in params.items()}
    ref_mu = {n: torch.zeros_like(p) for n, p in params.items()}
    ref_nu = {n: torch.zeros_like(p) for n, p in params.items()}
    for step in range(4):
        grads = {n: torch.randn(8, 4, generator=g) for n in names}
        tx.step(port, grads, mu, nu, step)
        for n in names:
            mine[n] = ref_train.adamw(mine[n], grads[n], ref_mu[n], ref_nu[n], step, opt,
                                      decays(n))
        for n in names:
            torch.testing.assert_close(port[n], mine[n], atol=1e-7, rtol=1e-6)
    assert not all(torch.equal(port[n], params[n]) for n in names)


def test_learning_rate_is_the_published_schedule():
    opt = {"lr": 5e-5, "total_steps": 41370, "warmup_ratio": 0.1}
    assert ref_train.learning_rate(opt, 0) == 0.0
    assert math.isclose(ref_train.learning_rate(opt, 4137), 5e-5)
    assert math.isclose(ref_train.learning_rate(opt, 2068), 5e-5 * 2068 / 4137)
    assert ref_train.learning_rate(opt, 41370) == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_parameter_tree_is_the_ports(cell):
    """The tree the benchmark draws names every parameter of the port's
    learner with its shape, at the published widths too (meta tensors)."""
    name = "viltbert" if cell.startswith("viltbert") else "vilt-b32"
    config = load_json(HARNESS / "configs" / f"{name}.json")
    traffic = load_json(HARNESS / "traffic" / "train-snlive-b64.json")
    with torch.device("meta"):
        from climb_tpu_torch.configs.task_configs import task_configs
        from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
        from climb_tpu_torch.train.model_factory import LEARNERS

        model = LEARNERS[config["port"]["encoder_name"]](
            ViltConfig(), head_specs_from_task_configs(["snli-ve"], task_configs))
    spec = {n: tuple(shape) for n, shape, _, _ in param_spec(config, "snli-ve", 3)}
    assert spec == {n: tuple(p.shape) for n, p in model.named_parameters()}


def test_float8_control_rounds_every_product():
    a = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(1), requires_grad=True)
    b = torch.randn(7, 4, generator=torch.Generator().manual_seed(2), requires_grad=True)
    got = ref.FP8.matmul(a, b)
    exact = a @ b
    assert not torch.equal(got, exact)
    torch.testing.assert_close(got, exact, atol=0.5, rtol=0.2)
    got.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_images_are_normalized_as_the_port_does(dtype):
    """Every uint8 value, rounded as the compute dtype rounds it, bit for bit
    as the port's plain normalization (JAX's ``normalize_images``)."""
    from climb_tpu_torch.ops.image_ops import normalize_images_plain

    u = torch.arange(256, dtype=torch.uint8)
    want = normalize_images_plain(u, getattr(torch, dtype)).float()
    assert torch.equal(ref.normalize(u, dtype), want)
