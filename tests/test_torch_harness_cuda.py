"""The invariance transforms' batches on the card: the segsum kernel on
plans built from a transformed batch against its plain version.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_harness_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch.data.generators import SAT3Instances
from diffusionsat_torch.evaluation import harness
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train.loop import build_plans

# the kernel and the plain version sum each segment in other fixed orders
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["permute", "invert"])
def test_transformed_batch_kernel_equals_plain(cuda, transform):
    items = list(SAT3Instances(min_vars=10, max_vars=30, train_size=40,
                               seed=3).train_generator())
    batch = build_batch([(n, c) for n, c, _ in items],
                        BucketSpec.for_node_budget(20000),
                        solutions=[s for _, _, s in items])
    new = harness.permute_batch_variables(batch, seed=1) \
        if transform == "permute" else harness.invert_batch_polarity(batch)
    plans = build_plans(new, pad=True).to(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    segsum.reset_launch_counts()
    for plan, n_in in ((plans.lit_to_clause, 2 * new.V),
                       (plans.clause_to_lit, new.C)):
        x = torch.randn((n_in, 128), generator=gen, device=cuda)
        torch.testing.assert_close(segsum.gather_segsum(x, plan),
                                   segsum.segsum_plain(x, plan), **TOL)
    assert segsum.LAUNCHES == {"lit_to_clause": 1, "clause_to_lit": 1}
    # the plans sum the transformed edges, not the original ones
    old = build_plans(batch, pad=True).to(cuda)
    x = torch.randn((2 * new.V, 128), generator=gen, device=cuda)
    assert not torch.allclose(segsum.segsum_plain(x, plans.lit_to_clause),
                              segsum.segsum_plain(x, old.lit_to_clause))
    assert np.isfinite(segsum.segsum_plain(x, plans.lit_to_clause)
                       .cpu().numpy()).all()
