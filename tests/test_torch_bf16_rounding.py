"""Block-bf16 rounding against the TPU package, on the CPU.

The TPU package's Python constants are weak-typed: `0.1 * x` on a bf16 `x`
multiplies by bf16(0.1) and the blend `stop_gradient(x) * 0.2 + x * 0.8`
by bf16(0.2) and bf16(0.8); and its compiler keeps the product of the
state update `c(new + 0.1 * x)` in f32 before the one rounding.
`ops/lowp.weak` gives the port the same constants, and with them the blend
and the state updates equal the TPU package's bit for bit.

One rounding site is left: the f32 accumulation of bf16 products. XLA's
CPU dot of bf16 operands with an f32 result sums in another order than the
f32 GEMM of the upcast operands (which equals the TPU package's own f32
dot), so its f32 results differ in the last bits for about a fifth of the
entries, and a bf16 rounding of an MLP's hidden layer can then differ by
one ulp. On this batch it shows in one variable entry after one round (one
ulp); the states after three rounds are equal bit for bit. The TPU's MXU
sums in an order of its own again.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, random_formulas, torch_params
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as japply,
)
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tapply,
)
from diffusionsat_torch.ops.lowp import weak


def _bf16_pair(seed, n=200_000):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    return jx, tx


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) \
        else t.float().numpy()


def test_blend_and_state_update_equal_the_tpu_packages_bit_for_bit():
    jx, tx = _bf16_pair(0)
    jy, ty = _bf16_pair(1)
    jblend = jax.jit(lambda x: jax.lax.stop_gradient(x) * 0.2 + x * 0.8)(jx)
    np.testing.assert_array_equal(_np(tqs._blend(tx)), _np(jblend))
    # the state update, `c(new + 0.1 * state)`: the compiler keeps the
    # product in f32 (excess precision) and rounds once
    jupd = jax.jit(lambda x, y: (y.astype(jnp.float32) * 0.25 + 0.1 * x)
                   .astype(jnp.bfloat16))(jx, jy)
    tupd = (ty.float() * 0.25 + weak(0.1, tx) * tx.float()).to(
        torch.bfloat16)
    np.testing.assert_array_equal(_np(tupd), _np(jupd))
    # the f32 value of the constant rounds otherwise in about a tenth
    plain = tx.detach() * 0.2 + tx * 0.8
    assert np.mean(_np(plain) != _np(jblend)) > 0.05
    # on f32 tensors the constants are the f32 ones
    assert weak(0.1, torch.zeros(1)) == float(np.float32(0.1))


def _ulps(a, b):
    ia = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).int()
    ib = torch.from_numpy(b).to(torch.bfloat16).view(torch.int16).int()
    # a monotone integer line through the signed bf16 values
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs().numpy()


@pytest.mark.parametrize("rounds,key,max_frac", [
    (1, "clause_state", 0.0), (1, "variables_state", 0.002),
    (3, "clause_state", 0.0), (3, "variables_state", 0.0)])
def test_block_bf16_round_states_against_the_tpu_packages(rounds, key,
                                                          max_frac):
    kw = dict(feature_maps=16, query_maps=8, logit_maps=4,
              debug_zero_noise=True, block_bf16=True)
    jcfg, tcfg = jqs.QuerySATConfig(**kw), tqs.QuerySATConfig(**kw)
    jparams = jqs.query_sat_init(jax.random.key(1), jcfg)
    jb, tb = batch_pair(*random_formulas(1, n_formulas=5))
    dims = jdb.dense_dims_for([jb])
    jd, td = jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, size=(jd.G, jd.Vg)).astype(np.int32)
    noisy = np.eye(2, dtype=np.float32)[rng.integers(0, 2,
                                                     size=(jd.G, jd.Vg))]
    jout = jax.jit(lambda p: japply(
        p, jcfg, jd, jax.random.key(0), training=False,
        labels=jnp.asarray(labels), noise_scale=jnp.float32(0.37),
        noisy_num=jnp.asarray(noisy), rounds=rounds))(jparams)
    tout = tapply(torch_params(jparams), tcfg, td, None,
                  labels=torch.from_numpy(labels), noise_scale=0.37,
                  noisy_num=torch.from_numpy(noisy), rounds=rounds,
                  device="cpu")
    assert tout[3][key].dtype == torch.bfloat16
    u = _ulps(_np(jout[3][key]), _np(tout[3][key]))
    assert np.mean(u > 0) <= max_frac and u.max() <= 1
