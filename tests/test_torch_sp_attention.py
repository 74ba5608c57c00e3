"""climb_tpu_torch's sequence-parallel attention against the JAX package's,
on the CPU: ``ops.sp_attention.sequence_parallel_attention`` with 'ring' and
'ulysses' over 2- and 4-rank gloo worlds against
``climb_tpu.ops.sp_attention.sequence_parallel_attention`` on a mesh whose
'model' axis has as many devices, on the same inputs drawn with numpy:
(B, S, H, D) = (2, 48, 4, 16) with ragged text masks and one row whose keys
are all masked. Both compute in float32 with the same online-softmax
arithmetic (ring) or one full softmax per head (Ulysses); the tolerance is
float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ops.sp_attention import sequence_parallel_attention as jax_sp_attention
from climb_tpu.parallel.mesh import make_mesh
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)

B, S, H, D = 2, 48, 4, 16
ATOL, RTOL = 2e-6, 1e-5


def _inputs():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[0, 30:] = 0.0  # ragged keys
    mask[1, 5:17] = 0.0
    return q, k, v, mask


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    n = request.param
    q, k, v, mask = _inputs()
    world = worker.World("sp_attention", n, str(tmp_path_factory.mktemp(f"sp{n}")),
                         dict(q=q, k=k, v=v, mask=mask), timeout=120)
    mesh = make_mesh(n_data=8 // n, n_model=n)
    want = {impl: np.asarray(jax_sp_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), mesh,
                                              impl=impl))
            for impl in ("ring", "ulysses")}
    return n, world.result(), want


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(ranks, impl):
    n, got, want = ranks
    np.testing.assert_allclose(got[impl].numpy(), want[impl], atol=ATOL, rtol=RTOL,
                               err_msg=f"{impl} over {n} ranks")


def test_ulysses_needs_heads_divisible():
    import torch.distributed as dist

    from climb_tpu_torch.ops import sp_attention

    class _Group:  # a stand-in three-rank group: the check precedes any exchange
        pass

    q = torch.zeros((1, 6, 4, 8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "get_world_size", lambda group=None: 3)
        with pytest.raises(ValueError, match="heads % ranks"):
            sp_attention.ulysses_attention(q, q, q, torch.zeros((1, 6)), _Group())
    with pytest.raises(ValueError, match="impl"):
        sp_attention.sequence_parallel_attention(q, q, q, torch.ones((1, 6)), None, "other")
